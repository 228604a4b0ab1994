"""Small data-analysis helpers (a copy of gpu_sdr_tpu/client/data_analysis.py,
which mirrors pyUSRP/USRP_data_analysis.py)."""

from __future__ import annotations

import numpy as np
from scipy import signal


def linear_phase(phase):
    """Unwrap and detrend a phase trace (reference linear_phase,
    pyUSRP/USRP_data_analysis.py:49-60)."""
    phase = np.unwrap(np.asarray(phase))
    return signal.detrend(phase)
