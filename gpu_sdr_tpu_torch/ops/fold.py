"""Shift-fold TONES->DIRECT loopback: the CUDA kernels (csrc/fold.cu) and
their plain PyTorch versions.

Port of gpu_sdr_tpu/ops/fold_chain.py (the algebra) and
gpu_sdr_tpu/ops/pallas_chain.TonesDirectFoldKernel with all three of its
routes (``invoke_factored`` #11 ``fold``, ``invoke`` #12
``fold_streamed``, ``invoke_factored_rotg`` #13 ``fold_rotg``) and
TonesDirectFoldT (``invoke_t`` #14 ``fold_t``).  A loopback of a TX
comb into a DIRECT receiver has no input: the comb is P[n, t] * Q[t, m]
with P the comb's integer-phase Vandermonde (P[n, t] =
exp(2j*pi*f_t*n*M/W)), so the shifted rows of the FIR factor exactly and
the whole f-tap loop folds into one (Ct, Cp) constant, built host-side in
float64:

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

All four run one kernel template of csrc/fold.cu on the tensor cores:
the complex product in TF32 with a three-pass split (csrc/tc.cuh;
``cplx.tf32_cmatmul`` emulates it), the plain versions in exact FP32.

The engine's fused path runs #11 (``step``); #12, #13 and #14 sit
behind the same ops-level entry points as in the JAX package
(``multi_step`` with ``time_shards`` > 1 or ``rotg``; TonesDirectFoldT),
which no engine path takes.

Not ported: the self-ramp special case (conj(P1) in place of ramp1: on
the TPU it saved an HBM stream; here ramp1 is a table served by L2, and
RB equals conj(PB) then anyway), the bf16 hi/lo constants, the 8-row
rotation units, lane padding, the identity-matrix diagonal extraction
and host-split P1 of the rotated-G2 form, and the divisor-of-nb tile
rules (the CUDA kernels mask their last tile).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def _tiles(nb: int) -> int:
    """Tiles of one block of nb rows, the last one partial."""
    return -(-nb // FOLD_TILE)


def _blocks(y: torch.Tensor, K: int, nb: int) -> torch.Tensor:
    """(tiles of K blocks, R, Cp) -> (K*nb, Cp): each block's rows, its
    last tile cut to nb."""
    Cp = y.shape[-1]
    return y.reshape(K, -1, Cp)[:, :nb].reshape(K * nb, Cp)


def fold_plain(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
               qrot: torch.Tensor, ramp1: torch.Tensor, nb: int,
               K: int = 1) -> torch.Tensor:
    """Plain PyTorch fold of K blocks, the kernel's algebra:
    (P * srot) @ G2 * ramp * drot with P * srot = P1 * crot[b] and
    ramp * drot = ramp1 * qrot[b] tile by tile.  (K*nb, Cp) complex64."""
    tiles, R = crot.shape[0], P1.shape[0]
    A = _blocks(P1[None] * crot[:, None, :], K, nb)
    ramp = _blocks(ramp1[None].expand(tiles, -1, -1), K, nb)
    q = _blocks(qrot[:, None, :].expand(-1, R, -1), K, nb)
    return (A @ G2) * ramp * q


def fold_rotg_plain(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
                    qrot: torch.Tensor, ramp1: torch.Tensor, nb: int,
                    K: int = 1) -> torch.Tensor:
    """Plain version of the rotated-G2 fold (#13), in that order: rotate
    G2 by each tile's crot, the product P1 @ (diag(crot) G2), then the
    ramp and qrot.  (K*nb, Cp) complex64."""
    Gr = crot[:, :, None] * G2[None]                    # (tiles, Ct, Cp)
    y = torch.matmul(P1[None], Gr)                      # (tiles, R, Cp)
    return _blocks(y * ramp1[None] * qrot[:, None, :], K, nb)


def fold_streamed_plain(P: torch.Tensor, G2: torch.Tensor,
                        srot: torch.Tensor, drot: torch.Tensor,
                        ramp: torch.Tensor, nb: int,
                        K: int = 1) -> torch.Tensor:
    """Plain version of the streamed fold (#12), row by row:
    (P * srot[b]) @ G2 * ramp * drot[b] for each block b of K.  P (nb,
    Ct), ramp (nb, Cp), srot (K, Ct), drot (K, Cp) -> (K*nb, Cp)."""
    Ct, Cp = G2.shape
    A = (P[None] * srot[:, None, :]).reshape(K * nb, Ct)
    y = (A @ G2).reshape(K, nb, Cp) * ramp[None] * drot[:, None, :]
    return y.reshape(K * nb, Cp)


def fold_t_plain(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
                 qrot: torch.Tensor, ramp1T: torch.Tensor, nb: int,
                 K: int = 1) -> torch.Tensor:
    """Plain version of the channel-major fold (#14), the transposed
    algebra: per tile yT = (diag(crot) G2)^T @ P1^T * ramp1^T * qrot as a
    column.  ramp1T (Cp, R) -> (Cp, K*nb)."""
    R = P1.shape[0]
    Cp = G2.shape[1]
    GrT = (crot[:, :, None] * G2[None]).transpose(1, 2)  # (tiles, Cp, Ct)
    yT = torch.matmul(GrT, P1.T[None]) * ramp1T[None] * qrot[:, :, None]
    yT = yT.reshape(K, -1, Cp, R).permute(2, 0, 1, 3).reshape(Cp, K, -1)
    return yT[:, :, :nb].reshape(Cp, K * nb)


def _check_factored(P1, G2, crot, qrot, ramp1, nb, K, name,
                    ramp_t: bool = False):
    if any(t.dtype != torch.complex64 for t in (P1, G2, crot, qrot, ramp1)):
        raise TypeError(f"{name} wants complex64 operands")
    R, Ct = P1.shape
    Cp = G2.shape[1]
    n_tiles = K * _tiles(nb) if nb > 0 and K > 0 else -1
    if R != FOLD_TILE or tuple(G2.shape) != (Ct, Cp) or \
            tuple(crot.shape) != (n_tiles, Ct) or \
            tuple(qrot.shape) != (n_tiles, Cp) or \
            tuple(ramp1.shape) != ((Cp, R) if ramp_t else (R, Cp)):
        raise ValueError(
            f"{name} shapes: P1 {tuple(P1.shape)}, G2 {tuple(G2.shape)}, "
            f"crot {tuple(crot.shape)}, qrot {tuple(qrot.shape)}, ramp1 "
            f"{tuple(ramp1.shape)} for {K} blocks of nb {nb}, tile "
            f"{FOLD_TILE}")
    if len({t.device for t in (P1, G2, crot, qrot, ramp1)}) != 1:
        raise ValueError(f"{name} operands on different devices")


def _launch(name: str, out: torch.Tensor, ops, nb: int, K: int):
    """Launch csrc/fold.cu's entry `name` on CUDA operands `ops` (the
    kernel's five inputs, made contiguous) into `out`."""
    if ops[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ops[0].device}")
    ops = [t.contiguous() for t in ops]
    Ct, Cp = ops[1].shape
    _library()
    build.launch(name, out.device, *(t.data_ptr() for t in ops),
                 out.data_ptr(), nb, K, Ct, Cp)
    return out


@functools.cache
def _library():
    """The kernel library, its tile checked once against FOLD_TILE."""
    lib = build.load()
    if lib.sdr_fold_tile() != FOLD_TILE:
        raise RuntimeError("csrc/fold.cu kTile differs from FOLD_TILE")
    return lib


def fold(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
         qrot: torch.Tensor, ramp1: torch.Tensor, nb: int,
         K: int = 1) -> torch.Tensor:
    """K blocks of the fold (#11): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  P1 (R, Ct), G2 (Ct, Cp), crot (K *
    tiles, Ct), qrot (K * tiles, Cp), ramp1 (R, Cp) -> (K*nb, Cp).
    Counts its kernel launches in ``fold.launches``."""
    _check_factored(P1, G2, crot, qrot, ramp1, nb, K, "fold")
    if P1.device.type == "cpu":
        return fold_plain(P1, G2, crot, qrot, ramp1, nb, K)
    out = torch.empty((K * nb, G2.shape[1]), dtype=torch.complex64,
                      device=P1.device)
    _launch("sdr_fold", out, (P1, G2, crot, qrot, ramp1), nb, K)
    fold.launches += 1
    return out


fold.launches = 0


def fold_rotg(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
              qrot: torch.Tensor, ramp1: torch.Tensor, nb: int,
              K: int = 1) -> torch.Tensor:
    """K blocks of the fold with the rotation on G2 (#13, gpu_sdr_tpu/
    ops/pallas_chain.TonesDirectFoldKernel.invoke_factored_rotg): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Operands and result as ``fold``; counts its kernel launches in
    ``fold_rotg.launches``."""
    _check_factored(P1, G2, crot, qrot, ramp1, nb, K, "fold_rotg")
    if P1.device.type == "cpu":
        return fold_rotg_plain(P1, G2, crot, qrot, ramp1, nb, K)
    out = torch.empty((K * nb, G2.shape[1]), dtype=torch.complex64,
                      device=P1.device)
    _launch("sdr_fold_rotg", out, (P1, G2, crot, qrot, ramp1), nb, K)
    fold_rotg.launches += 1
    return out


fold_rotg.launches = 0


def fold_t(P1: torch.Tensor, G2: torch.Tensor, crot: torch.Tensor,
           qrot: torch.Tensor, ramp1T: torch.Tensor, nb: int,
           K: int = 1) -> torch.Tensor:
    """K blocks of the fold written channel-major (#14, gpu_sdr_tpu/ops/
    pallas_chain.TonesDirectFoldT.invoke_t): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  As ``fold`` with the
    ramp transposed, ramp1T (Cp, R) -> (Cp, K*nb); counts its kernel
    launches in ``fold_t.launches``."""
    _check_factored(P1, G2, crot, qrot, ramp1T, nb, K, "fold_t",
                    ramp_t=True)
    if P1.device.type == "cpu":
        return fold_t_plain(P1, G2, crot, qrot, ramp1T, nb, K)
    out = torch.empty((G2.shape[1], K * nb), dtype=torch.complex64,
                      device=P1.device)
    _launch("sdr_fold_t", out, (P1, G2, crot, qrot, ramp1T), nb, K)
    fold_t.launches += 1
    return out


fold_t.launches = 0


def fold_streamed(P: torch.Tensor, G2: torch.Tensor, srot: torch.Tensor,
                  drot: torch.Tensor, ramp: torch.Tensor, nb: int,
                  K: int = 1) -> torch.Tensor:
    """K blocks of the fold with P and the ramp read per tile from the
    block's full tables (#12, gpu_sdr_tpu/ops/pallas_chain.
    TonesDirectFoldKernel.invoke): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  P (nb, Ct), G2 (Ct, Cp), srot (K,
    Ct), drot (K, Cp), ramp (nb, Cp) -> (K*nb, Cp); counts its kernel
    launches in ``fold_streamed.launches``."""
    ops = (P, G2, srot, drot, ramp)
    if any(t.dtype != torch.complex64 for t in ops):
        raise TypeError("fold_streamed wants complex64 operands")
    Ct, Cp = G2.shape
    if nb <= 0 or K <= 0 or tuple(P.shape) != (nb, Ct) or \
            tuple(srot.shape) != (K, Ct) or tuple(drot.shape) != (K, Cp) or \
            tuple(ramp.shape) != (nb, Cp):
        raise ValueError(
            f"fold_streamed shapes: P {tuple(P.shape)}, G2 {tuple(G2.shape)}, "
            f"srot {tuple(srot.shape)}, drot {tuple(drot.shape)}, ramp "
            f"{tuple(ramp.shape)} for {K} blocks of nb {nb}")
    if len({t.device for t in ops}) != 1:
        raise ValueError("fold_streamed operands on different devices")
    if P.device.type == "cpu":
        return fold_streamed_plain(P, G2, srot, drot, ramp, nb, K)
    out = torch.empty((K * nb, Cp), dtype=torch.complex64, device=P.device)
    _launch("sdr_fold_streamed", out, ops, nb, K)
    fold_streamed.launches += 1
    return out


fold_streamed.launches = 0


class TonesDirectFold:
    """The fused TONES->DIRECT loopback of any comb: one fold per block.

    Stream state: (synthesis phases (Ct,), DDC phases (Cp,), prev_valid),
    int64 / int64 / float, the JAX package's (sph, dph, pv)
    (convert.fold_state).  ``multi_step(state, K)`` emits K blocks,
    (K*nb, Cp), in one launch, selecting the kernel as the JAX package's
    multi_step does: with ``time_shards`` > 1 the streamed fold (#12,
    ``invoke``: P and the ramp read per tile from their full tables),
    else the factored fold (#11) or, with ``rotg``, its rotated-G2 form
    (#13).  ``step(state)`` is ``multi_step(state, 1)``.  The engine's
    fused path takes the defaults, so #11, as in the JAX package.
    ``time_shards`` and ``rotg`` keep the JAX package's option names so
    that its callers carry over; here they only select the kernel (#12
    shards nothing: its tiles are masked, so no shard's row count needs
    a divisor; ROADMAP Queue 3, divergences 5 and 20)."""

    path_name = "fold_kernel"

    def __init__(self, rate: int, tx_freqs: Tuple[int, ...],
                 tx_ampls: Tuple[float, ...], cfg: DirectDDCConfig,
                 block_len: int, device,
                 rows: Optional[Tuple[int, int]] = None,
                 time_shards: int = 1, rotg: bool = False):
        """`rows` = (row0, nb): only the block's rows [row0, row0 + nb),
        one time shard's (parallel/fused_sharded.ShardedFusedDirect);
        P and the ramp are exponentials in the row, so the shard's tables
        are the block's rows from row0 and the tile factors are the
        same.  The startup correction belongs to the rows from 0."""
        W, L, M, f = int(rate), int(block_len), cfg.M, cfg.f
        if cfg.decim <= 0 or L % M or not tx_freqs or int(time_shards) < 1:
            raise ValueError("the fold needs a decimating receiver, whole "
                             "rows per block, at least one TX tone and "
                             "time_shards >= 1")
        self.rate, self.cfg, self.device = W, cfg, device
        self.time_shards, self.rotg = int(time_shards), bool(rotg)
        row0, nb = rows if rows is not None else (0, L // M)
        self.row0 = row0
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
        n_tiles = _tiles(nb)
        # the streamed fold (#12) reads the block's full tables
        n_rows = nb if self.time_shards > 1 else R
        rows = np.arange(row0, row0 + max(n_rows, f - 1), dtype=np.int64)
        P = _expi((fr[None, :] * ((rows[:, None] * M) % W)) % W, W)
        frx = np.asarray(cfg.freqs, dtype=np.int64) % W
        ramp = _expi((frx[None, :] * ((rows[:, None] * M) % W)) % W, W, -1.0)
        b = np.arange(n_tiles, dtype=np.int64)
        PB = _expi((fr[None, :] * ((b[:, None] * R * M) % W)) % W, W)
        RB = _expi((frx[None, :] * ((b[:, None] * R * M) % W)) % W, W, -1.0)
        self.P1 = from_np(P[:R], device)
        self.ramp1 = from_np(ramp[:R], device)
        if self.time_shards > 1:
            self.P = from_np(P[:nb], device)
            self.ramp = from_np(ramp[:nb], device)
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

    def rotations(self, state, K: int):
        """(state', srots (K, Ct), drots (K, Cp)): the synthesis and DDC
        output rotations of K consecutive blocks from `state`, formed in
        float32 from the exact integer phases."""
        sph, dph, _ = state
        srots, drots = [], []
        for _ in range(K):
            srots.append(phase_rotation(sph, self.rate, 1.0))
            drots.append(phase_rotation(dph, self.rate, -1.0))
            sph, dph, _ = self.advance((sph, dph, 1.0))
        return (sph, dph, 1.0), torch.stack(srots), torch.stack(drots)

    def block_rotations_factored(self, state):
        """Per-tile rotation rows of `state`'s block: crot = srot * PB[b]
        (synthesis) and qrot = drot * RB[b] (mix-down), (tiles, Ct) and
        (tiles, Cp)."""
        return self.tile_rotations(*self.rotations(state, 1)[1:])

    def tile_rotations(self, srot: torch.Tensor, drot: torch.Tensor):
        """(crot, qrot) from the rotations srot (Ct,) and drot (Cp,) of a
        block, or (K, Ct) and (K, Cp) of K blocks: (K * tiles, Ct) and
        (K * tiles, Cp), block after block."""
        return ((self.PB[None] * srot.reshape(-1, 1, self.Ct)).reshape(
                    -1, self.Ct),
                (self.RB[None] * drot.reshape(-1, 1, self.Cp)).reshape(
                    -1, self.Cp))

    def startup_correction(self, state, y: torch.Tensor,
                           transposed: bool = False) -> torch.Tensor:
        """Restore the zero-history startup transient on the stream's first
        block (prev_valid 0): remove the missing taps' contribution from
        its first f-1 rows, in place.  `y` is (rows, Cp), or (Cp, rows)
        when `transposed` (the channel-major fold)."""
        sph, dph, pv = state
        k = min(self.cfg.f - 1, y.shape[1] if transposed else y.shape[0])
        if pv or k == 0 or self.row0:
            return y
        srot0 = phase_rotation(sph, self.rate, 1.0)
        drot0 = phase_rotation(dph, self.rate, -1.0)
        h = self._P0[:k] * srot0[None, :]
        corr = torch.einsum("rt,rtc->rc", h, self.G2p[:k])
        corr = corr * self._ramp0[:k] * drot0[None, :]
        if transposed:
            y[:, :k] -= corr.T
        else:
            y[:k] -= corr
        return y

    def advance(self, state):
        sph, dph, _ = state
        return (advance_phase(sph, self._sstep, self.rate),
                advance_phase(dph, self._dstep, self.rate), 1.0)

    def invoke(self, P: torch.Tensor, G2: torch.Tensor, ramp: torch.Tensor,
               srots: torch.Tensor, drots: torch.Tensor,
               K: int) -> torch.Tensor:
        """The streamed fold (#12) over K blocks: (K*nb, Cp)."""
        return fold_streamed(P, G2, srots, drots, ramp, self.nb, K)

    def multi_step(self, state, K: int):
        """K consecutive blocks in one launch: (state', y (K*nb, Cp)),
        the kernel chosen as gpu_sdr_tpu/ops/pallas_chain.py:791-808
        chooses it."""
        new_state, srots, drots = self.rotations(state, K)
        if self.time_shards > 1:
            y = self.invoke(self.P, self.G2, self.ramp, srots, drots, K)
        else:
            crot, qrot = self.tile_rotations(srots, drots)
            y = (fold_rotg if self.rotg else fold)(
                self.P1, self.G2, crot, qrot, self.ramp1, self.nb, K)
        # y rows already carry ramp and DDC rotation, so the startup
        # correction does too
        return new_state, self.startup_correction(state, y)

    def step(self, state):
        """One block: (state', y (nb, Cp))."""
        return self.multi_step(state, 1)


class TonesDirectFoldT:
    """The fold written channel-major, (Cp, K*nb) (kernel #14,
    gpu_sdr_tpu/ops/pallas_chain.TonesDirectFoldT): a TonesDirectFold
    for the constants, the rotations and the transposed startup
    correction, and ``fold_t`` for the blocks.  The same state as the
    row-major fold (convert.fold_state).  The JAX class needs a 128-
    multiple tile dividing nb (``ok`` False otherwise); the port's last
    tile is masked, so any nb runs (ROADMAP Queue 3, divergence 20).
    No engine path builds it, as in the JAX package."""

    path_name = "fold_kernel_t"

    def __init__(self, rate: int, tx_freqs: Tuple[int, ...],
                 tx_ampls: Tuple[float, ...], cfg: DirectDDCConfig,
                 block_len: int, device):
        self.base = TonesDirectFold(rate, tx_freqs, tx_ampls, cfg,
                                    block_len, device)
        self.nb, self.Ct, self.Cp = self.base.nb, self.base.Ct, self.base.Cp
        self.ramp1T = self.base.ramp1.T.contiguous()         # (Cp, R)

    def init_state(self):
        return self.base.init_state()

    def multi_step(self, state, K: int):
        """K blocks in one launch: (state', y (Cp, K*nb))."""
        base = self.base
        new_state, srots, drots = base.rotations(state, K)
        crot, qrot = base.tile_rotations(srots, drots)
        y = fold_t(base.P1, base.G2, crot, qrot, self.ramp1T, self.nb, K)
        return new_state, base.startup_correction(state, y, transposed=True)

    def step(self, state):
        return self.multi_step(state, 1)
