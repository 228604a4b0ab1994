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
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import chirp as chirp_ops
from .chirp import M32, ChirpConfig
from .lockin import profile_sum


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
