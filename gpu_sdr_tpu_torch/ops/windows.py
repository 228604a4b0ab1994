"""Filter windows: built once per measurement in float64 numpy by the
port's copy of the reference window functions (``golden.py``), then
cast to the requested dtype."""

from __future__ import annotations

import numpy as np

from .. import golden


def sinc_window(length: int, fc: float, dtype=np.float32) -> np.ndarray:
    """Hamming-windowed sinc prototype, unit sum (cpp/kernels.cu:256-310
    in the reference)."""
    return golden.make_sinc_window(length, fc).astype(dtype)


def hamming_window(length: int, side: int = 0,
                   dtype=np.float32) -> np.ndarray:
    """Zero-padded Hamming window, unit sum (cpp/kernels.cu:107-206)."""
    return golden.make_hamming_window(length, side).astype(dtype)


def flat_window(length: int, side: int, dtype=np.float32) -> np.ndarray:
    """Flat window with `side` leading zeros, unit sum
    (cpp/kernels.cu:208-253)."""
    return golden.make_flat_window(length, side).astype(dtype)


def pfb_window(nfft: int, avg: int, dtype=np.float32) -> np.ndarray:
    """The PFB prototype of TONES/NOISE modes: Hamming-windowed sinc of
    length nfft*avg with fc = 1/(2*nfft), unit sum
    (cpp/USRP_demodulator.cpp:131-134 in the reference)."""
    return sinc_window(nfft * avg, 1.0 / (2.0 * nfft), dtype=dtype)
