"""The float64 numpy helpers the port's runtime builds its constants
with: its copy of the functions it needs from gpu_sdr_tpu/golden.py
(window functions, the tone-to-bin map, the quantized chirp descriptor),
each the exact arithmetic of one reference routine.  The float64
oracles the port is tested against stay in the JAX package."""

from __future__ import annotations

import numpy as np

TWO_31_5 = 2147483647.5  # reference _31_BIT_VALUE (headers/kernels.cuh:36)


def make_flat_window(length: int, side: int) -> np.ndarray:
    """Zeros on the first `side` samples, constant after, unit sum
    (reference make_flat_window, cpp/kernels.cu:208-253, which zeroes
    both ends and then overwrites [side, length) with ones)."""
    win = np.zeros(length, dtype=np.float64)
    win[side:] = 1.0
    return win / win.sum()


def make_sinc_window(length: int, fc: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass prototype, unit sum (reference
    make_sinc_window, cpp/kernels.cu:256-310); length 1 is a unit tap."""
    if length == 1:
        return np.ones(1, dtype=np.float64)
    i = np.arange(length, dtype=np.float64)
    k = i - (length - 1) // 2          # integer center, as in the reference
    x = 2.0 * np.pi * fc * k
    sinc = np.where(k != 0, (2.0 * fc) * np.sin(x) / np.where(x == 0, 1, x),
                    2.0 * fc)
    win = sinc * (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (length - 1)))
    return win / win.sum()


def tone_bins(freqs, rate: int, nfft: int) -> np.ndarray:
    """Tone frequencies -> FFT bins, bit-identical to the reference
    (upload_multitone_parameters, cpp/USRP_demodulator.cpp:702-768): the
    last bin of the axis i*bs - bs*(nfft//2) within bs of the tone,
    wrapped by nfft//2."""
    bs = float(rate) / float(nfft)
    axis = np.arange(nfft, dtype=np.float64) * bs - bs * (nfft // 2)
    f = np.asarray(freqs, dtype=np.float64).reshape(-1, 1)
    hit = (f < axis + bs) & (f > axis - bs)                   # (tones, nfft)
    last = nfft - 1 - np.argmax(hit[:, ::-1], axis=1)
    return np.where(hit.any(axis=1), (last + nfft // 2) % nfft,
                    0).astype(np.int64)


class ChirpParameter:
    """Quantized chirp descriptor, the constructor math of the reference
    demodulator (cpp/USRP_demodulator.cpp:192-221):

        num_steps = swipe_s  (or chirp_t*rate if unset)
        length    = chirp_t * rate / num_steps      [samples/step, int]
        chirpness = trunc((2^32-1) * (f1-f0)/((num_steps-1)*rate))  [uint32]
        f0        = trunc((2^32-1) * f_start/rate)                  [int32]

    stored in a C 'unsigned int' and 'int' (headers/kernels.cuh:58-64),
    so both are truncated and wrapped; the VNA frequency axis depends on
    that exact rounding (pyUSRP/USRP_VNA.py:740)."""

    def __init__(self, f_start: int, f_end: int, rate: int, num_steps: int,
                 chirp_t: float):
        if num_steps < 1:
            num_steps = int(chirp_t * rate)
        length = int(chirp_t * rate / num_steps)
        if length < 1:
            length = 1
        self.num_steps = int(num_steps)
        self.length = int(length)
        two32m1 = float(2 ** 32 - 1)
        if num_steps > 1:
            # a negative double assigned to 'unsigned int': truncate
            # toward zero, then wrap mod 2^32 (down-chirps rely on it)
            raw = int(two32m1 * (f_end - f_start) / ((num_steps - 1.0) * rate))
            self.chirpness = np.uint32(raw % (2 ** 32))
        else:
            self.chirpness = np.uint32(0)
        raw_f0 = int(two32m1 * (float(f_start) / float(rate))) % (2 ** 32)
        self.f0 = np.int32(raw_f0 - 2 ** 32 if raw_f0 >= 2 ** 31 else raw_f0)

    def period(self) -> int:
        return self.num_steps * self.length
