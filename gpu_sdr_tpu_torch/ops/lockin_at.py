"""Chirp lock-in with the oscillator formed in the kernel: the CUDA kernel
(csrc/lockin.cu, chirp mode) and its plain PyTorch version.

Port of gpu_sdr_tpu/ops/pallas_lockin.py ``pallas_chirp_lockin_at``:
for each segment s of block `idx` of a resident (total_nseg, ppt)
recording X, the chirp at the stream positions last + s*ppt + k (the
uint32 phase of ops/chirp), mixed down and summed against the lock-in
profile:

    y[s] = sum_k w[k] * conj(c(last + s*ppt + k)) * x[idx*nseg + s, k]

with conj(c) * x formed as the JAX kernel forms it (zr = cr*xr + ci*xi,
zi = cr*xi - ci*xr).  This serves the replay of a chirp whose one-period
table does not fit (ops/chirp.chirp_table_fits), where ``lockin_table``
(kernel #17) reads the oscillator instead.  The stream position `last`
is a Python int the caller carries; the block index becomes a row
offset, so nothing waits for the host.

``fused_chirp_lockin`` (``pallas_chirp_lockin`` is the same function, the
name of kernel #19, gpu_sdr_tpu/ops/pallas_lockin.pallas_chirp_lockin)
is the streamed form: a block x of nseg*ppt samples, the same kernel on
x viewed as (nseg, ppt) rows at row offset 0.  Its plain version is the
JAX package's XLA route, chirp_demod_block then lockin_decimate.  No
engine path takes it, as in the JAX package; the JAX kernel's 8-segment
tile has no counterpart (ROADMAP Queue 3, divergence 20).

The kernel gives each segment one block, a thread walking its columns
with the phase as an exact uint32 recurrence, two samples a 16-byte
load where ppt is even and the pointers aligned (``chirp_plan`` mirrors
its launch plan; ``walk_phases`` reads the integer phases its walk
gives).
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import chirp as chirp_ops
from .chirp import M32, ChirpConfig
from .lockin import lockin_decimate, profile_sum

# csrc/lockin.cu's chirp-mode constants: threads a block, column vectors
# whose loads a thread issues at once
CHIRP_TILES = dict(threads=256, unroll=4)


def chirp_plan(nseg: int, ppt: int, aligned: bool) -> dict:
    """Chirp mode's launch plan (csrc/lockin.cu make_chirp_plan): vec,
    samples a column vector (2, the 16-byte body, where ppt is even and
    the pointers aligned, ``pointers_aligned``; else 1); threads a
    block; blocks, the grid, one a segment.  A thread takes its
    segment's column vectors j, j + threads, ... of the row's ppt //
    vec."""
    vec = 2 if aligned and ppt % 2 == 0 else 1
    return dict(vec=vec, threads=CHIRP_TILES["threads"], blocks=nseg)


def pointers_aligned(x: int, w: int) -> bool:
    """Whether the 16-byte body may run (csrc/lockin.cu sdr_lockin_at):
    the block's first row 16-byte and the profile 8-byte aligned."""
    return x % 16 == 0 and w % 8 == 0


def lockin_at_plain(cfg: ChirpConfig, profile: torch.Tensor, last: int,
                    X: torch.Tensor, idx: int, nseg: int) -> torch.Tensor:
    """Plain version: the block's chirp (ops/chirp, bit-exact phase), the
    mix and the weighted segment sums.  (nseg,) complex64."""
    ppt = profile.shape[0]
    c = chirp_ops.chirp_block(cfg, last, nseg * ppt,
                              device=X.device)[1].reshape(nseg, ppt)
    x = X[idx * nseg:(idx + 1) * nseg]
    cr, ci, xr, xi = c.real, c.imag, x.real, x.imag
    zr = cr * xr + ci * xi
    zi = cr * xi - ci * xr
    return torch.complex(profile_sum(zr, profile), profile_sum(zi, profile))


def lockin_at(cfg: ChirpConfig, profile: torch.Tensor, last: int,
              X: torch.Tensor, idx: int, nseg: int):
    """(new_last, y (nseg,)) for block `idx` of X (rows, ppt) at stream
    position `last`: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Counts its kernel launches in
    ``lockin_at.launches``."""
    ppt = profile.shape[0] if profile.ndim == 1 else -1
    if profile.dtype != torch.float32 or X.dtype != torch.complex64:
        raise TypeError("lockin_at wants a float32 profile and a complex64 "
                        "recording")
    if X.ndim != 2 or X.shape[1] != ppt or nseg <= 0 or idx < 0 or \
            (idx + 1) * nseg > X.shape[0]:
        raise ValueError(f"lockin_at: block {idx} of {nseg} segments of "
                         f"{ppt} outside the recording {tuple(X.shape)}")
    if X.device != profile.device:
        raise ValueError("lockin_at operands on different devices")
    new_last = chirp_ops.advance(cfg, last, nseg * ppt)
    if X.device.type == "cpu":
        return new_last, lockin_at_plain(cfg, profile, last, X, idx, nseg)
    if X.device.type != "cuda":
        raise ValueError(f"lockin_at: unsupported device {X.device}")
    X, profile = X.contiguous(), profile.contiguous()
    out = torch.empty(nseg, dtype=torch.complex64, device=X.device)
    build.launch("sdr_lockin_at", X.device, X.data_ptr(), profile.data_ptr(),
                 out.data_ptr(), idx * nseg, nseg, ppt, cfg.period, cfg.length,
                 cfg.chirpness & M32, cfg.f0 & M32, int(last) % cfg.period,
                 chirp_ops.PI_F32, chirp_ops.INV_2_31_5)
    lockin_at.launches += 1
    return new_last, out


lockin_at.launches = 0


def fused_chirp_lockin_plain(cfg: ChirpConfig, profile: torch.Tensor,
                             last: int, x: torch.Tensor):
    """Plain version of kernel #19, the JAX package's XLA route
    (gpu_sdr_tpu/ops/pallas_lockin.py:115-118): the block mixed down
    against the chirp (ops/chirp, bit-exact phase), then the lock-in.
    (new_last, y (nseg,))."""
    new_last, z = chirp_ops.chirp_demod_block(cfg, last, x)
    return new_last, lockin_decimate(profile, z)


def fused_chirp_lockin(cfg: ChirpConfig, profile: torch.Tensor, last: int,
                       x: torch.Tensor):
    """Chirp demodulation and lock-in of a streamed block x (nseg*ppt,)
    at stream position `last` (kernel #19): (new_last, y (nseg,)), the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Counts its kernel launches in ``fused_chirp_lockin.launches``."""
    ppt = profile.shape[0] if profile.ndim == 1 else -1
    if profile.dtype != torch.float32 or x.dtype != torch.complex64:
        raise TypeError("fused_chirp_lockin wants a float32 profile and a "
                        "complex64 block")
    if x.ndim != 1 or ppt <= 0 or x.shape[0] % ppt or x.shape[0] == 0:
        raise ValueError(f"fused_chirp_lockin: block {tuple(x.shape)} is "
                         f"not whole segments of {ppt}")
    if x.device != profile.device:
        raise ValueError("fused_chirp_lockin operands on different devices")
    if x.device.type == "cpu":
        return fused_chirp_lockin_plain(cfg, profile, last, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_chirp_lockin: unsupported device {x.device}")
    nseg = x.shape[0] // ppt
    x, profile = x.contiguous(), profile.contiguous()
    out = torch.empty(nseg, dtype=torch.complex64, device=x.device)
    build.launch("sdr_lockin_at", x.device, x.data_ptr(), profile.data_ptr(),
                 out.data_ptr(), 0, nseg, ppt, cfg.period, cfg.length,
                 cfg.chirpness & M32, cfg.f0 & M32, int(last) % cfg.period,
                 chirp_ops.PI_F32, chirp_ops.INV_2_31_5)
    fused_chirp_lockin.launches += 1
    return chirp_ops.advance(cfg, last, x.shape[0]), out


fused_chirp_lockin.launches = 0
pallas_chirp_lockin = fused_chirp_lockin


def walk_phases(cfg: ChirpConfig, last: int, nseg: int, ppt: int, vec: int,
                device) -> torch.Tensor:
    """The int32 phases (as int64, (nseg * ppt,)) that chirp mode's walk
    gives nseg segments of ppt from stream position `last` on the body
    `vec` (2: the 16-byte body, where ppt is even): the kernel's walk
    (csrc/lockin.cu sdr_lockin_chirp_phases), for checking it against
    ``chirp_phase_index`` exactly.  It runs only on a CUDA device: any
    other raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"walk_phases: the kernel's walk runs on a CUDA "
                         f"device, not {device}")
    out = torch.empty(nseg * ppt, dtype=torch.int32, device=device)
    build.launch("sdr_lockin_chirp_phases", device, out.data_ptr(), nseg,
                 ppt, vec, cfg.period, cfg.length, cfg.chirpness & M32,
                 cfg.f0 & M32, int(last) % cfg.period)
    return out.to(torch.int64)
