"""G-fused TONES->DIRECT loopback chain: the CUDA kernel (csrc/chain.cu,
TPU kernel #15) and its plain PyTorch version.

Port of gpu_sdr_tpu/ops/pallas_chain.TonesDirectChain.  A loopback of a
TX comb into a DIRECT receiver never needs the block x: with the comb's
phase table P[n, t] = exp(2j*pi*f_t*n*M/W) and Q[t, m] its in-row
factor, the synthesis and the tap matmuls contract through x,

    G[j, t, c] = sum_m Q[t, m] * Hmod[j*M + m, c]            (float64)
    y[r, c]    = ramp[r, c] * drot_c * sum_j sum_t E[r + j, t] * G[j, t, c]

with E the rotated rows of P, led by f-1 halo rows.  There is no carried
FIR history: a block's halo rows are re-synthesised from P's rows under
the rotation of the block they belong to, so the stream state is three
phases, (synthesis phases (Ct,), DDC phases (Cp,), prev_valid), int64 /
int64 / float here (the JAX package's int32 / int32 / float32,
convert.fold_state).  The sharded chain (parallel/fused_sharded
.ShardedFusedDirect, sub-path ``g_chain``) runs one kernel per shard:
shard t's rows of P and of the ramp, its halo the f-1 rows before them
(``halo_rows``), and the halo's rotation the previous block's on shard 0
(zero ahead of the stream's first block), the current block's on the
others (``block_rotations`` gives both).

The kernel runs the product on the tensor cores (TF32, a three-pass
split: csrc/tc.cuh, ``cplx.tf32_cmatmul`` emulates it), stages a tile's
extended rows once per pass of taps, double-buffered, and streams G
through a two-slot ring of items (a tap's chunk of tones each), so its
shared memory is bounded for any f (``plan`` mirrors it).  Not ported:
the bf16 hi/lo split of G, the lP halo units padded to 8 rows, the rep8
rotation rows, the tile rule (tiles dividing the shard's rows) and the K
blocks per launch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import build
from . import ddc as ddc_ops
from .cplx import advance_phase, from_np, phase_rotation
from .ddc import DirectDDCConfig

# csrc/tc.cuh and csrc/chain.cu: rows per tile, channels per block (more
# go to further blocks), fewest taps a pass is cut to, and a block's
# shared memory with the opt-in (the H100's 227 KB)
CHAIN_TILE, CHAIN_MAX_CHANNELS, CHAIN_MIN_TAPS = 64, 112, 8
SMEM_MAX = 232_448


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(f: int, Ct: int, Cp: int) -> dict:
    """The chain kernel's staging plan, csrc/chain.cu ``plan``: channel
    chunks (CN channels, pitch CNs = 4 mod 16, nc of them) of at most
    CHAIN_MAX_CHANNELS; then the fewest chunks of tones of the staged rows
    (nke of KE, pitch AS floats) and, for them, the fewest G items a chunk
    (nsub of KG tones) that leave room, beside the ring's two items, for
    two buffers of the rows of ``taps`` = J taps (at least min(f,
    CHAIN_MIN_TAPS)), J the most that fit.  ``smem`` is the block's
    bytes."""
    nc = -(-Cp // CHAIN_MAX_CHANNELS)
    CN = _round_up(-(-Cp // nc), 4)
    CNs = CN + (4 - CN) % 16
    avail = SMEM_MAX // 4
    nke = 0
    while True:
        nke += 1
        KE = _round_up(-(-(_round_up(Ct, 4) // 4) // nke) * 4, 4)
        AS = 2 * KE + 4
        for d in range(1, KE // 4 + 1):
            KG = -(-(KE // 4) // d) * 4
            ring = 2 * KG * CNs * 2
            # C's division truncates: a negative room fails either way
            J = min(f, int((avail - ring) / (2 * AS)) - CHAIN_TILE + 1)
            if J >= min(f, CHAIN_MIN_TAPS):
                return dict(CN=CN, CNs=CNs, nc=nc, KE=KE, nke=nke, AS=AS,
                            KG=KG, nsub=-(-KE // KG), taps=J,
                            smem=(ring + 2 * (CHAIN_TILE + J - 1) * AS) * 4)


def smem_bytes(f: int, Ct: int = 100, Cp: int = 100) -> int:
    """The chain kernel's shared memory for f taps at Ct tones and Cp
    channels (csrc/chain.cu sdr_chain_smem_bytes), within SMEM_MAX and
    flat once the taps run in passes."""
    return plan(f, Ct, Cp)["smem"]


def _expi(ph: np.ndarray, W: int, sign: float = 1.0) -> np.ndarray:
    """exp(sign * 2j*pi*ph/W) for exact integer phases, float64."""
    return np.exp(sign * 2j * np.pi * (np.asarray(ph, np.float64) / W))


def chain_plain(P: torch.Tensor, hP: torch.Tensor, G: torch.Tensor,
                ramp: torch.Tensor, srot: torch.Tensor, hrot: torch.Tensor,
                drot: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch chain over one shard's rows, the kernel's algebra:
    E = concat(hP * hrot, P * srot), then f complex matmuls of shifted
    rows of E against G[j], ramp and rotation.  (nbt, Cp) complex64."""
    f = G.shape[0]
    nbt = P.shape[0]
    E = torch.cat([hP * hrot[None, :], P * srot[None, :]])
    acc = E[0:nbt] @ G[0]
    for j in range(1, f):
        acc = acc + E[j:j + nbt] @ G[j]
    return acc * ramp * drot[None, :]


def _check(P, hP, G, ramp, srot, hrot, drot):
    ops = (P, hP, G, ramp, srot, hrot, drot)
    if any(t.dtype != torch.complex64 for t in ops):
        raise TypeError("chain wants complex64 operands")
    f, Ct, Cp = G.shape if G.ndim == 3 else (0, -1, -1)
    nbt = P.shape[0] if P.ndim == 2 else -1
    if f < 2 or tuple(P.shape) != (nbt, Ct) or \
            tuple(hP.shape) != (f - 1, Ct) or \
            tuple(ramp.shape) != (nbt, Cp) or tuple(srot.shape) != (Ct,) or \
            tuple(hrot.shape) != (Ct,) or tuple(drot.shape) != (Cp,) or \
            f - 1 > nbt:
        raise ValueError(
            f"chain shapes: P {tuple(P.shape)}, hP {tuple(hP.shape)}, G "
            f"{tuple(G.shape)}, ramp {tuple(ramp.shape)}, srot "
            f"{tuple(srot.shape)}, hrot {tuple(hrot.shape)}, drot "
            f"{tuple(drot.shape)}")
    if len({t.device for t in ops}) != 1:
        raise ValueError("chain operands on different devices")


def chain(P: torch.Tensor, hP: torch.Tensor, G: torch.Tensor,
          ramp: torch.Tensor, srot: torch.Tensor, hrot: torch.Tensor,
          drot: torch.Tensor) -> torch.Tensor:
    """One shard's block of the G-fused chain: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  P (nbt, Ct), hP (f-1,
    Ct), G (f, Ct, Cp), ramp (nbt, Cp), srot / hrot (Ct,), drot (Cp,) ->
    (nbt, Cp).  Counts its kernel launches in ``chain.launches``."""
    _check(P, hP, G, ramp, srot, hrot, drot)
    if P.device.type == "cpu":
        return chain_plain(P, hP, G, ramp, srot, hrot, drot)
    if P.device.type != "cuda":
        raise ValueError(f"chain: unsupported device {P.device}")
    P, hP, G, ramp, srot, hrot, drot = (
        t.contiguous() for t in (P, hP, G, ramp, srot, hrot, drot))
    f, Ct, Cp = G.shape
    out = torch.empty((P.shape[0], Cp), dtype=torch.complex64,
                      device=P.device)
    build.launch("sdr_chain", P.device, P.data_ptr(), hP.data_ptr(),
                 G.data_ptr(), ramp.data_ptr(), srot.data_ptr(),
                 hrot.data_ptr(), drot.data_ptr(), out.data_ptr(), P.shape[0],
                 Ct, Cp, f)
    chain.launches += 1
    return out


chain.launches = 0


class TonesDirectChain:
    """The G-fused TONES->DIRECT loopback's constants and stream state
    for a block of L samples split over `time_shards` shards.

    ``ok`` is False where the chain does not apply: a FIR of one tap
    (f < 2), rows that do not split over the shards, or a halo longer
    than a shard's rows."""

    path_name = "g_chain"

    def __init__(self, rate: int, tx_freqs: Tuple[int, ...],
                 tx_ampls: Tuple[float, ...], cfg: DirectDDCConfig,
                 block_len: int, time_shards: int = 1):
        W, L, M, f = int(rate), int(block_len), cfg.M, cfg.f
        self.rate, self.cfg, self.L = W, cfg, L
        self.Ct, self.Cp = len(tx_freqs), cfg.n_channels
        self.nb = L // M if cfg.decim > 0 and L % M == 0 else 0
        T = int(time_shards)
        self.lead = f - 1
        self.ok = bool(self.nb and tx_freqs and f >= 2 and
                       self.nb % T == 0 and self.lead <= self.nb // T)
        if not self.ok:
            return
        nb = self.nb
        fr = np.asarray(tx_freqs, dtype=np.int64) % W
        n = np.arange(nb, dtype=np.int64)
        m = np.arange(M, dtype=np.int64)
        P = _expi((fr[None, :] * ((n[:, None] * M) % W)) % W, W)
        Q = (np.asarray(tx_ampls, dtype=np.float64)[:, None] *
             _expi((fr[:, None] * m[None, :]) % W, W))
        hmod = cfg.modulated_taps_np()                  # (f*M, Cp)
        G = np.einsum("tm,jmc->jtc", Q, hmod.reshape(f, M, self.Cp))
        cpu = torch.device("cpu")
        self.P = from_np(P, cpu)
        self.G = from_np(G, cpu)
        self.ramp = cfg.carrier_ramp(nb, cpu)
        self._sstep = torch.from_numpy((fr * L) % W)
        self._dstep = ddc_ops.ddc_carrier_step(cfg, L, cpu)

    def halo_rows(self, row0: int) -> torch.Tensor:
        """The f-1 rows of P before row `row0`, wrapped mod nb: (f-1, Ct)."""
        idx = torch.arange(row0 - self.lead, row0) % self.nb
        return self.P.index_select(0, idx)

    def init_state(self, device="cpu"):
        return (torch.zeros(self.Ct, dtype=torch.int64, device=device),
                ddc_ops.ddc_carrier_init(self.cfg, device), 0.0)

    def block_rotations(self, state):
        """(state', srot (Ct,), hrot0 (Ct,), drot (Cp,)): the block's
        synthesis rotation, shard 0's halo rotation (the previous
        block's, zero ahead of the stream's first block: prev_valid 0)
        and the DDC output rotation, from the carried integer phases in
        float32 as the JAX package forms them."""
        sph, dph, pv = state
        W = self.rate
        sstep = self._sstep.to(sph.device)
        srot = phase_rotation(sph, W, 1.0)
        prev = sph - sstep
        prev = torch.where(prev < 0, prev + W, prev)
        hrot0 = phase_rotation(prev, W, 1.0) * float(pv)
        drot = phase_rotation(dph, W, -1.0)
        new = (advance_phase(sph, sstep, W),
               advance_phase(dph, self._dstep.to(dph.device), W), 1.0)
        return new, srot, hrot0, drot
