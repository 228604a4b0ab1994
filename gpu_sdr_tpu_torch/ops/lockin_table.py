"""Table-oscillator chirp lock-in: the CUDA kernel (csrc/lockin.cu) in
its two modes and their plain PyTorch versions.

Port of gpu_sdr_tpu/ops/pallas_lockin.py: ``pallas_chirp_lockin_table``
(table mode) and ``pallas_chirp_lockin_table_self`` (self mode).  The
integer-phase chirp repeats exactly every period, so one period of the
oscillator, generated once as segment rows (ops/chirp.
chirp_period_table), serves the whole stream; each block's lock-in
points are profile-weighted segment sums of the mix against it:

    table: y[s] = sum_k w[k] * conj(c[o*nseg + s, k]) * x[i*nseg + s, k]
    self:  y[s] = sum_k w[k] * |c[o*nseg + s, k]|^2,  imag exactly 0

Self mode is the loopback, where the signal is the table itself: each
row is read once.  The block indices o (oscillator) and i (signal) are
Python ints the caller carries in its state; the wrapper hands the
kernel row offsets, so no index lives on the device and nothing waits
for the host.  JAX's scalar prefetch and its 8-segment row tile were
TPU mechanisms and have no counterpart (any nseg is taken).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import build


def _rows(t: torch.Tensor, blk: int, nseg: int) -> torch.Tensor:
    return t[blk * nseg:(blk + 1) * nseg]


def lockin_table_plain(profile: torch.Tensor, table: torch.Tensor,
                       x: torch.Tensor, o: int, i: int,
                       nseg: int) -> torch.Tensor:
    """Plain table mode: conj(c) * x row by row, then the weighted sum
    (the JAX kernel's products, pallas_lockin.py:174-180).  (nseg,)."""
    c, s = _rows(table, o, nseg), _rows(x, i, nseg)
    cr, ci, xr, xi = c.real, c.imag, s.real, s.imag
    zr = cr * xr + ci * xi
    zi = cr * xi - ci * xr
    return torch.complex(zr @ profile, zi @ profile)


def lockin_self_plain(profile: torch.Tensor, table: torch.Tensor, o: int,
                      nseg: int) -> torch.Tensor:
    """Plain self mode: the same product set with x = c, so the
    imaginary half cr*ci - ci*cr is exactly 0.  (nseg,)."""
    c = _rows(table, o, nseg)
    cr, ci = c.real, c.imag
    zr = cr * cr + ci * ci
    zi = cr * ci - ci * cr
    return torch.complex(zr @ profile, zi @ profile)


def _check(profile, table, x, o, i, nseg):
    ppt = profile.shape[0] if profile.ndim == 1 else -1
    ops = (table,) if x is None else (table, x)
    if profile.dtype != torch.float32 or \
            any(t.dtype != torch.complex64 for t in ops):
        raise TypeError("lock-in wants a float32 profile and complex64 rows")
    if any(t.ndim != 2 or t.shape[1] != ppt for t in ops):
        raise ValueError(f"lock-in rows must be (rows, {ppt}), got "
                         f"{[tuple(t.shape) for t in ops]}")
    if nseg <= 0 or o < 0 or (o + 1) * nseg > table.shape[0] or \
            (x is not None and (i < 0 or (i + 1) * nseg > x.shape[0])):
        raise ValueError(f"lock-in block indices o={o}, i={i} of {nseg} "
                         f"rows outside the table ({table.shape[0]} rows)"
                         + ("" if x is None else
                            f" or the signal ({x.shape[0]} rows)"))
    if any(t.device != profile.device for t in ops):
        raise ValueError("lock-in operands on different devices")


def _launch(profile, table, x: Optional[torch.Tensor], o, i, nseg):
    if profile.device.type != "cuda":
        raise ValueError(f"lock-in kernel: unsupported device "
                         f"{profile.device}")
    ops = (profile, table) if x is None else (profile, table, x)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("lock-in kernel: operands must be contiguous")
    ppt = profile.shape[0]
    out = torch.empty(nseg, dtype=torch.complex64, device=profile.device)
    rc = build.load().sdr_lockin(
        table.data_ptr(), None if x is None else x.data_ptr(),
        profile.data_ptr(), out.data_ptr(), o * nseg, i * nseg, nseg, ppt,
        torch.cuda.current_stream(profile.device).cuda_stream)
    build.check(rc, "sdr_lockin")
    return out


def lockin_table(profile: torch.Tensor, table: torch.Tensor,
                 x: torch.Tensor, o: int, i: int, nseg: int) -> torch.Tensor:
    """Table mode (TPU kernel #17): oscillator rows of block `o` of
    `table`, signal rows of block `i` of `x`, both (rows, ppt).  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    counts kernel launches in ``lockin_table.launches``."""
    _check(profile, table, x, o, i, nseg)
    if profile.device.type == "cpu":
        return lockin_table_plain(profile, table, x, o, i, nseg)
    out = _launch(profile, table, x, o, i, nseg)
    lockin_table.launches += 1
    return out


lockin_table.launches = 0


def lockin_self(profile: torch.Tensor, table: torch.Tensor, o: int,
                nseg: int) -> torch.Tensor:
    """Self mode (TPU kernel #16): y[s] = sum_k w[k] |c|^2 over the rows
    of block `o` of `table`, imaginary half exactly 0.  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors; counts kernel
    launches in ``lockin_self.launches``."""
    _check(profile, table, None, o, 0, nseg)
    if profile.device.type == "cpu":
        return lockin_self_plain(profile, table, o, nseg)
    out = _launch(profile, table, None, o, 0, nseg)
    lockin_self.launches += 1
    return out


lockin_self.launches = 0
