"""Shift-fold TONES->DIRECT loopback: the CUDA kernel (csrc/fold.cu) and
its plain PyTorch version.

Port of gpu_sdr_tpu/ops/fold_chain.py (the algebra) and
gpu_sdr_tpu/ops/pallas_chain.TonesDirectFoldKernel (the
``invoke_factored`` route).  A loopback of a TX comb into a DIRECT
receiver has no input: the comb is P[n, t] * Q[t, m] with P the comb's
integer-phase Vandermonde (P[n, t] = exp(2j*pi*f_t*n*M/W)), so the shifted
rows of the FIR factor exactly and the whole f-tap loop folds into one
(Ct, Cp) constant, built host-side in float64:

    G[j, t, c] = sum_m Q[t, m] * Hmod[j*M + m, c]
    G2[t, c]   = sum_j exp(2j*pi*f_t*j*M/W) * G[j, t, c]
    y[n, c]    = ((P[n] * srot) @ G2)[c] * ramp[n, c] * drot_c

Per tile b of R rows, P[b*R + r] = P1[r] * PB[b] and ramp[b*R + r] =
ramp1[r] * RB[b], so the kernel reads only the (R, Ct) / (R, Cp) tables
and per-tile rotation rows crot = srot * PB[b], qrot = drot * RB[b]
(block_rotations_factored).  The stream's first f-1 rows miss the taps
that reach before the stream (zero history); ``startup_correction``
restores that transient with partial folds G2p, in plain PyTorch on f-1
rows, as the JAX package does it outside its kernel.

Not ported: the self-ramp special case (conj(P1) in place of ramp1: on
the TPU it saved an HBM stream; here ramp1 is a table served by L2, and
RB equals conj(PB) then anyway), the bf16 hi/lo constants, the 8-row
rotation units, lane padding and the divisor-of-nb tile rule (the CUDA
kernel masks its last tile).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..kernels import build
from . import ddc as ddc_ops
from .cplx import advance_phase, from_np, phase_rotation
from .ddc import DirectDDCConfig

FOLD_TILE = 64          # rows per tile (csrc/fold.cu kTile)


def _expi(ph: np.ndarray, W: int, sign: float = 1.0) -> np.ndarray:
    """exp(sign * 2j*pi*ph/W) for exact integer phases, float64."""
    return np.exp(sign * 2j * np.pi * (np.asarray(ph, np.float64) / W))


def fold_plain(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
               qrot: torch.Tensor, ramp1: torch.Tensor,
               nb: int) -> torch.Tensor:
    """Plain PyTorch fold of one block, the kernel's algebra:
    (P * srot) @ G2 * ramp * drot with P * srot = P1 * crot[b] and
    ramp * drot = ramp1 * qrot[b] row by row.  (nb, Cp) complex64."""
    R, Ct = P1.shape
    n_tiles = crot.shape[0]
    A = (P1[None] * crot[:, None, :]).reshape(n_tiles * R, Ct)[:nb]
    acc = A @ G2
    ramp = ramp1.repeat(n_tiles, 1)[:nb]
    q = qrot.repeat_interleave(R, dim=0)[:nb]
    return acc * ramp * q


def _check(P1, G2, crot, qrot, ramp1, nb):
    if any(t.dtype != torch.complex64 for t in (P1, G2, crot, qrot, ramp1)):
        raise TypeError("fold wants complex64 operands")
    R, Ct = P1.shape
    Cp = G2.shape[1]
    n_tiles = -(-nb // R) if R else 0
    if R != FOLD_TILE or tuple(G2.shape) != (Ct, Cp) or \
            tuple(crot.shape) != (n_tiles, Ct) or \
            tuple(qrot.shape) != (n_tiles, Cp) or \
            tuple(ramp1.shape) != (R, Cp):
        raise ValueError(
            f"fold shapes: P1 {tuple(P1.shape)}, G2 {tuple(G2.shape)}, crot "
            f"{tuple(crot.shape)}, qrot {tuple(qrot.shape)}, ramp1 "
            f"{tuple(ramp1.shape)} for nb {nb}, tile {FOLD_TILE}")
    if len({t.device for t in (P1, G2, crot, qrot, ramp1)}) != 1:
        raise ValueError("fold operands on different devices")


@functools.cache
def _library():
    """The kernel library, its tile checked once against FOLD_TILE."""
    lib = build.load()
    if lib.sdr_fold_tile() != FOLD_TILE:
        raise RuntimeError("csrc/fold.cu kTile differs from FOLD_TILE")
    return lib


def fold(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
         qrot: torch.Tensor, ramp1: torch.Tensor, nb: int) -> torch.Tensor:
    """One block of the fold: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  P1 (R, Ct), G2 (Ct, Cp), crot (tiles, Ct),
    qrot (tiles, Cp), ramp1 (R, Cp) -> (nb, Cp).  Counts its kernel
    launches in ``fold.launches``."""
    _check(P1, G2, crot, qrot, ramp1, nb)
    if P1.device.type == "cpu":
        return fold_plain(P1, G2, crot, qrot, ramp1, nb)
    if P1.device.type != "cuda":
        raise ValueError(f"fold: unsupported device {P1.device}")
    P1, G2, crot, qrot, ramp1 = (t.contiguous()
                                 for t in (P1, G2, crot, qrot, ramp1))
    Ct, Cp = G2.shape
    out = torch.empty((nb, Cp), dtype=torch.complex64, device=P1.device)
    rc = _library().sdr_fold(
        P1.data_ptr(), G2.data_ptr(), crot.data_ptr(), qrot.data_ptr(),
        ramp1.data_ptr(), out.data_ptr(), nb, Ct, Cp, crot.shape[0],
        torch.cuda.current_stream(P1.device).cuda_stream)
    build.check(rc, "sdr_fold")
    fold.launches += 1
    return out


fold.launches = 0


class TonesDirectFold:
    """The fused TONES->DIRECT loopback of any comb: one fold per block.

    Stream state: (synthesis phases (Ct,), DDC phases (Cp,), prev_valid),
    int64 / int64 / float, the JAX package's (sph, dph, pv)
    (convert.fold_state).  ``step(state)`` emits one (nb, Cp) block."""

    path_name = "fold_kernel"

    def __init__(self, rate: int, tx_freqs: Tuple[int, ...],
                 tx_ampls: Tuple[float, ...], cfg: DirectDDCConfig,
                 block_len: int, device):
        W, L, M, f = int(rate), int(block_len), cfg.M, cfg.f
        if cfg.decim <= 0 or L % M or not tx_freqs:
            raise ValueError("the fold needs a decimating receiver, whole "
                             "rows per block and at least one TX tone")
        self.rate, self.cfg, self.device = W, cfg, device
        nb = L // M
        Ct, Cp = len(tx_freqs), cfg.n_channels
        self.nb, self.Ct, self.Cp = nb, Ct, Cp
        fr = np.asarray(tx_freqs, dtype=np.int64) % W
        m = np.arange(M, dtype=np.int64)
        j = np.arange(f, dtype=np.int64)
        Q = (np.asarray(tx_ampls, dtype=np.float64)[:, None] *
             _expi((fr[:, None] * m[None, :]) % W, W))
        hmod = cfg.modulated_taps_np()                      # (f*M, Cp)
        G = np.einsum("tm,jmc->jtc", Q, hmod.reshape(f, M, Cp))
        shift = _expi((fr[:, None] * ((j[None, :] * M) % W)) % W, W)
        G2 = np.einsum("tj,jtc->tc", shift, G)
        # startup partial folds: output row r of the stream's first block
        # misses taps j < f-1-r (zero history, GoldenFIR semantics)
        G2p = np.stack([
            np.einsum("tj,jtc->tc", shift[:, :f - 1 - r], G[:f - 1 - r])
            for r in range(f - 1)]) if f > 1 else np.zeros((0, Ct, Cp))
        R = FOLD_TILE
        n_tiles = -(-nb // R)
        rows = np.arange(max(R, f - 1), dtype=np.int64)
        P = _expi((fr[None, :] * ((rows[:, None] * M) % W)) % W, W)
        ramp = cfg.carrier_ramp_np(len(rows))
        b = np.arange(n_tiles, dtype=np.int64)
        frx = np.asarray(cfg.freqs, dtype=np.int64) % W
        PB = _expi((fr[None, :] * ((b[:, None] * R * M) % W)) % W, W)
        RB = _expi((frx[None, :] * ((b[:, None] * R * M) % W)) % W, W, -1.0)
        self.P1 = from_np(P[:R], device)
        self.ramp1 = from_np(ramp[:R], device)
        self.PB, self.RB = from_np(PB, device), from_np(RB, device)
        self.G2, self.G2p = from_np(G2, device), from_np(G2p, device)
        self._P0 = from_np(P[:f - 1], device)
        self._ramp0 = from_np(ramp[:f - 1], device)
        self._sstep = torch.from_numpy((fr * L) % W).to(device)
        self._dstep = ddc_ops.ddc_carrier_step(cfg, L, device)
        self._sph0 = torch.from_numpy((fr * -((f - 1) * M)) % W).to(device)

    def init_state(self):
        return (self._sph0.clone(),
                ddc_ops.ddc_carrier_init(self.cfg, self.device), 0.0)

    def block_rotations_factored(self, state):
        """Per-tile rotation rows: crot = srot * PB[b] (synthesis) and
        qrot = drot * RB[b] (mix-down), (tiles, Ct) and (tiles, Cp)."""
        sph, dph, _ = state
        srot = phase_rotation(sph, self.rate, 1.0)
        drot = phase_rotation(dph, self.rate, -1.0)
        return self.PB * srot[None, :], self.RB * drot[None, :]

    def startup_correction(self, state, y: torch.Tensor) -> torch.Tensor:
        """Restore the zero-history startup transient on the stream's first
        block (prev_valid 0): remove the missing taps' contribution from
        its first f-1 rows, in place."""
        sph, dph, pv = state
        k = min(self.cfg.f - 1, y.shape[0])
        if pv or k == 0:
            return y
        srot0 = phase_rotation(sph, self.rate, 1.0)
        drot0 = phase_rotation(dph, self.rate, -1.0)
        h = self._P0[:k] * srot0[None, :]
        corr = torch.einsum("rt,rtc->rc", h, self.G2p[:k])
        y[:k] -= corr * self._ramp0[:k] * drot0[None, :]
        return y

    def advance(self, state):
        sph, dph, _ = state
        return (advance_phase(sph, self._sstep, self.rate),
                advance_phase(dph, self._dstep, self.rate), 1.0)

    def step(self, state):
        """One block: (state', y (nb, Cp))."""
        crot, qrot = self.block_rotations_factored(state)
        y = fold(self.P1, self.G2, crot, qrot, self.ramp1, self.nb)
        return self.advance(state), self.startup_correction(state, y)
