"""Channel models for loopback measurements (a copy of
gpu_sdr_tpu/engine/channel.py).

The reference's --sw_loop is an ideal wire (TX buffer copied to RX,
cpp/USRP_hardware_manager.cpp:1331-1395).  For meaningful end-to-end tests
of the analysis stack (VNA fitting, line-delay calibration, noise PSDs) we
extend it with physical channel models applied host-side to the TX stream:

  * DelayChannel      — integer-sample line delay (what USRP_delay measures)
  * ResonatorChannel  — applies the S21 of simulated superconducting
                        resonators (the nonlinear model of
                        pyUSRP/USRP_fitting.py:76-125) via overlap-save
                        frequency-domain filtering
  * composable gain/attenuation and additive white noise

A channel acts on the host stream, block by block, before the host feed
stages it onto the device: numpy in both packages, with the same seeded
generators, so the two give the same samples.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


class Channel:
    """Stateful stream transformation applied block-by-block."""

    def __call__(self, block: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class IdealChannel(Channel):
    def __call__(self, block):
        return block


@dataclasses.dataclass
class DelayChannel(Channel):
    """Integer-sample delay with carried tail (line-delay simulation)."""

    delay_samples: int

    def __post_init__(self):
        self._hist = np.zeros(self.delay_samples, dtype=np.complex64)

    def __call__(self, block):
        if self.delay_samples == 0:
            return block
        # works for any delay, including delay > block length: the
        # history holds the last `delay` samples of the combined stream
        both = np.concatenate([self._hist, block])
        out = both[:len(block)]
        self._hist = both[len(block):].copy()
        return out.astype(np.complex64)


def resonator_s21(f: np.ndarray, f0: float, Qr: float, Qe_re: float,
                  Qe_im: float = 0.0, a: float = 0.0) -> np.ndarray:
    """Linear (a=0) or nonlinear resonator S21 at frequencies f [Hz].

    Same physics as the reference fit model (nonlinear_model,
    pyUSRP/USRP_fitting.py:76-125): S21 = 1 - (Qr/Qe) / (1 + 2j*y) with
    y = Qr*(f-f0)/f0 the (bifurcation-corrected) scaled detuning.
    """
    Qe = Qe_re + 1j * Qe_im
    y0 = (f - f0) / f0 * Qr
    if a == 0.0:
        y = y0
    else:
        # solve y = y0 + a/(1+4y^2) per point (fixed-point iteration)
        y = y0.copy()
        for _ in range(20):
            y = y0 + a / (1.0 + 4.0 * y * y)
    return 1.0 - (Qr / Qe) / (1.0 + 2.0j * y)


@dataclasses.dataclass
class FrequencyResponseChannel(Channel):
    """Apply an arbitrary baseband frequency response H(f) by streaming
    overlap-add FIR filtering (host-side numpy; the channel simulator is not
    a hot path).  `response(f)` receives baseband frequencies in Hz.

    The impulse response of H is truncated to fft_len//4 taps around t=0
    and made causal by an fft_len//8-sample shift, so the channel adds a
    known group delay of ntap//2 samples (report via `extra_delay`).
    """

    rate: float
    response: callable
    fft_len: int = 1 << 16

    def __post_init__(self):
        from scipy.signal import fftconvolve
        self._fftconvolve = fftconvolve
        N = self.fft_len
        f = np.fft.fftfreq(N, d=1.0 / self.rate)
        H = np.asarray(self.response(f), dtype=np.complex128)
        h = np.fft.ifft(H)
        ntap = N // 4
        half = ntap // 2
        # causal FIR: [negative-time tail, positive-time head]
        self._h = np.concatenate([h[-half:], h[:half]])
        self._carry = np.zeros(ntap - 1, dtype=np.complex128)

    @property
    def extra_delay(self) -> int:
        """Group delay added by the causal shift, in samples."""
        return len(self._h) // 2

    def __call__(self, block):
        x = np.asarray(block, np.complex128)
        L = len(x)
        # overlap-add valid for ANY block length (including L < ntap-1):
        # accumulate the carry into the full convolution, emit L samples,
        # carry the rest
        y_full = self._fftconvolve(x, self._h)
        nc = len(self._carry)
        if nc > len(y_full):
            y_full = np.concatenate(
                [y_full, np.zeros(nc - len(y_full), np.complex128)])
        y_full[:nc] += self._carry
        self._carry = y_full[L:].copy()
        return y_full[:L].astype(np.complex64)


def make_resonator_channel(rate: float, resonators: Sequence[dict],
                           fft_len: int = 1 << 16) -> FrequencyResponseChannel:
    """Channel with a product of resonator dips.  Each resonator dict:
    {f0 (baseband Hz), Qr, Qe_re[, Qe_im, a]}."""

    def H(f):
        out = np.ones_like(f, dtype=np.complex128)
        for r in resonators:
            out *= resonator_s21(f, r["f0"], r["Qr"], r["Qe_re"],
                                 r.get("Qe_im", 0.0), r.get("a", 0.0))
        return out

    return FrequencyResponseChannel(rate=rate, response=H, fft_len=fft_len)


@dataclasses.dataclass
class DropoutChannel(Channel):
    """Fault injection: zero out random spans of samples, reporting how
    many events hit each block via `take_errors()`.

    The reference counts UHD stream errors (overflow/alignment/...) per
    packet and rides them through RX_wrapper.errors into the H5 errors
    dataset (cpp/USRP_server_diagnostic.cpp:14-106); this channel lets
    tests exercise that path without hardware.
    """

    rate: float
    events_per_second: float = 1.0
    dropout_len: int = 1000
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._pending_errors = 0

    def __call__(self, block):
        block = np.array(block, dtype=np.complex64)
        p = self.events_per_second * len(block) / self.rate
        n_events = self._rng.poisson(p)
        for _ in range(n_events):
            start = self._rng.integers(0, max(1, len(block) -
                                              self.dropout_len))
            block[start:start + self.dropout_len] = 0
        self._pending_errors += int(n_events)
        return block

    def take_errors(self) -> int:
        n = self._pending_errors
        self._pending_errors = 0
        return n


@dataclasses.dataclass
class ChainChannel(Channel):
    """Compose channels left-to-right, with optional additive noise."""

    channels: List[Channel]
    noise_rms: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, block):
        for c in self.channels:
            block = c(block)
        if self.noise_rms > 0.0:
            n = self._rng.standard_normal(2 * len(block)) * \
                (self.noise_rms / np.sqrt(2.0))
            block = block + (n[::2] + 1j * n[1::2])
        return np.asarray(block, dtype=np.complex64)

    def take_errors(self) -> int:
        return sum(int(c.take_errors())
                   for c in self.channels if hasattr(c, "take_errors"))
