"""Filter windows: built once per measurement in float64 numpy by the
port's copy of the reference window functions (``golden.py``), then
cast."""

from __future__ import annotations

import numpy as np

from .. import golden


def pfb_window(nfft: int, avg: int, dtype=np.float32) -> np.ndarray:
    """The PFB prototype of TONES/NOISE modes: Hamming-windowed sinc of
    length nfft*avg with fc = 1/(2*nfft), unit sum
    (cpp/USRP_demodulator.cpp:131-134 in the reference)."""
    return golden.make_sinc_window(nfft * avg,
                                   1.0 / (2.0 * nfft)).astype(dtype)
