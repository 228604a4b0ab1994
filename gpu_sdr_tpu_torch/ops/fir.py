"""DIRECT-mode decimator taps (port of ``fir_taps_direct`` from
gpu_sdr_tpu/ops/fir.py, which imports JAX and so cannot be shared).

The streaming FIR itself is not a separate op here: the DIRECT
demodulator folds it into the mix-down (ops/ddc.py), as the JAX package
does.
"""

from __future__ import annotations

import numpy as np

from .. import golden


def fir_taps_direct(decim: int, pf_average: int,
                    dtype=np.float32) -> np.ndarray:
    """Sinc window of length decim*pf_average with fc = 0.75/(2*decim)
    (reference cpp/USRP_demodulator.cpp:99)."""
    return golden.make_sinc_window(decim * pf_average,
                                   0.75 / (2.0 * decim)).astype(dtype)
