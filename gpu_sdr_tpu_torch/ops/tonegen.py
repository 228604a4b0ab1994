"""Multi-tone TX comb synthesis (port of gpu_sdr_tpu/ops/tonegen.py).

A bin-quantized comb is periodic with a period dividing nfft, so one
period tiled across the block is the whole signal (the reference's
wavetable pointer rotation, cpp/USRP_buffer_generator.cpp:226-229).  An
aperiodic comb is synthesized per block from the exact factorization of
the integer-phase oscillator over a tile decomposition n = u*S + v:

    x[base + u*S + v] = sum_c A_c * osc_c[base] * osc_c[u*S] * osc_c[v]
                      = (P * rot)[u, :] @ Q[:, v]

with an integer per-channel phase carried across blocks (int64 here; the
JAX package's int32 values convert exactly, see convert.tone_phase).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .cplx import advance_phase, phase_rotation


def _tile_split(L: int) -> Tuple[int, int]:
    """The divisor pair (U, S) of L with S closest to sqrt(L)."""
    s = 1
    for d in range(1, int(np.sqrt(L)) + 1):
        if L % d == 0:
            s = d
    return L // s, s


@dataclasses.dataclass(frozen=True)
class ToneCombConfig:
    rate: int
    freqs: Tuple[int, ...]
    ampls: Tuple[float, ...]
    block_len: int
    scale: float = 1.0

    def factors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(P, Q): P (U, C), Q (C, S) complex64, from exact integer
        phases computed in float64 on the host."""
        W = self.rate
        U, S = _tile_split(self.block_len)
        fr = np.asarray(self.freqs, dtype=np.int64) % W
        u = np.arange(U, dtype=np.int64)
        v = np.arange(S, dtype=np.int64)
        ph_p = (fr[None, :] * ((u[:, None] * S) % W)) % W
        ph_q = (fr[:, None] * (v[None, :] % W)) % W
        P = np.exp(2j * np.pi * (ph_p / float(W)))
        Q = (np.asarray(self.ampls, dtype=np.float64)[:, None] *
             np.exp(2j * np.pi * (ph_q / float(W)))) * self.scale
        return (torch.from_numpy(P.astype(np.complex64)).to(device),
                torch.from_numpy(Q.astype(np.complex64)).to(device))

    def phase_init(self, device) -> torch.Tensor:
        return torch.zeros(len(self.freqs), dtype=torch.int64, device=device)

    def phase_step(self, device) -> torch.Tensor:
        fr = np.asarray(self.freqs, dtype=np.int64)
        return torch.from_numpy((fr * self.block_len) % self.rate).to(device)


def comb_period(freqs, rate: int) -> int:
    """Fundamental period of the comb in samples: rate / gcd(rate, f...)."""
    g = int(rate)
    for f in freqs:
        g = math.gcd(g, abs(int(f)))
        if g == 1:
            break
    return int(rate) // max(g, 1)


def tone_comb_wavetable_block(freqs, ampls, rate: int, block_len: int,
                              scale: float = 1.0) -> np.ndarray:
    """One block of a periodic comb (block_len % comb_period == 0), built
    in float64 from exact integer phases, as numpy complex64."""
    period = comb_period(freqs, rate)
    assert block_len % period == 0
    n = np.arange(period, dtype=np.int64)
    x = np.zeros(period, dtype=np.complex128)
    W = int(rate)
    for f, a in zip(freqs, ampls):
        ph = ((int(f) % W) * (n % W)) % W
        x += a * np.exp(2j * np.pi * ph / W)
    return np.tile((x * scale).astype(np.complex64), block_len // period)


def tone_comb_block(P: torch.Tensor, Q: torch.Tensor, step: torch.Tensor,
                    W: int, phase: torch.Tensor):
    """One block of an aperiodic comb: (new_phase, x) with x (U*S,).

    The rotation angle is formed in float32 as in the JAX package."""
    x = (P * phase_rotation(phase, W)[None, :]) @ Q
    return advance_phase(phase, step, W), x.reshape(-1)


def tone_comb_wavetable(freqs, ampls, rate: int,
                        scale: float = 1.0) -> np.ndarray:
    """Reference-style full-period wavetable via iFFT (host-side; for tests
    and small rates only).  x[n] = scale * sum_c A_c exp(2j*pi*f_c*n/rate)
    (reference tone_gen, cpp/kernels.cu:589-684)."""
    spec = np.zeros(rate, dtype=np.complex128)
    for f, a in zip(freqs, ampls):
        spec[int(f) % rate] += a
    return (np.fft.ifft(spec) * rate * scale).astype(np.complex64)
