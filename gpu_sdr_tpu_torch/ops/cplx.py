"""numpy complex <-> torch.complex64 at the host boundary, the
integer-phase oscillator's rotation, and the tensor-core kernels' TF32
split and three-pass complex product emulated in plain PyTorch.

The JAX package carries complex data as float32 (re, im) pairs because
its TPU backend has no complex dtype; PyTorch has one, so the port uses
``torch.complex64`` throughout and needs only the two conversions."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def from_np(x, device) -> torch.Tensor:
    """numpy (or array-like) complex -> complex64 tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(x), dtype=np.complex64)
    return torch.from_numpy(a).to(device)


def to_np(x: torch.Tensor) -> np.ndarray:
    """complex tensor -> numpy complex64 on the host.  A CUDA tensor is
    copied through pinned memory: a 48 MB block takes ~1 ms that way and
    ~20-30 ms through pageable memory (H100 host link)."""
    x = x.detach().to(dtype=torch.complex64)
    if x.device.type == "cpu":
        return x.numpy()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host.numpy()


def phase_rotation(phase: torch.Tensor, W: int,
                   sign: float = 1.0) -> torch.Tensor:
    """exp(sign * 2j*pi*phase/W) of an exact integer phase, the angle
    formed in float32 as the JAX package forms it (cplx.expi/expi_neg)."""
    theta = phase.to(torch.float32) * np.float32(2.0 * np.pi / W)
    return torch.polar(torch.ones_like(theta), theta * sign)


def advance_phase(phase: torch.Tensor, step: torch.Tensor,
                  W: int) -> torch.Tensor:
    """(phase + step) mod W for integer phases and steps in [0, W)."""
    new = phase + step
    return torch.where(new >= W, new - W, new)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding a TF32 value, bit for bit as the card's
    ``cvt.rna.tf32.f32``: round to nearest, ties away from zero, the low
    13 of the 23 mantissa bits cleared (finite inputs)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    r = ((u & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000 | (u & 0x80000000)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = big + small, both TF32 (float32 tensors), as the tensor-core
    kernels split an operand (csrc/tc.cuh): big = rna(x), small = rna(x
    - big), the difference formed from the rounded big."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _real_embedding(b: torch.Tensor) -> torch.Tensor:
    """complex (K, N) -> real (2K, 2N), 2x2 blocks [[re, im], [-im, re]]:
    an interleaved complex row times it is the interleaved product."""
    re, im = b.real, b.imag
    top = torch.stack([re, im], dim=-1)             # row 2t: (re, im)
    bot = torch.stack([-im, re], dim=-1)            # row 2t+1: (-im, re)
    return torch.stack([top, bot], dim=1).reshape(2 * b.shape[0],
                                                  2 * b.shape[1])


def tf32_cmatmul(a: torch.Tensor, b: torch.Tensor,
                 passes: int = 3) -> torch.Tensor:
    """The tensor-core kernels' complex product a @ b (complex64, a (...,
    K), b (K, N)) emulated in plain PyTorch: the real embedding, both
    operands split into TF32 parts, and `passes` products summed in
    float32 (1: big*big; 3: small*big + big*small + big*big).  Products
    of TF32 parts are exact in float32, so only the sums' order differs
    from the card's."""
    if passes not in (1, 3):
        raise ValueError(f"passes {passes}: 1 or 3")
    ar = torch.view_as_real(a.to(torch.complex64).contiguous()).reshape(
        *a.shape[:-1], 2 * a.shape[-1])
    ab, as_ = tf32_split(ar)
    bb, bs = tf32_split(_real_embedding(b.to(torch.complex64)))
    y = ab @ bb if passes == 1 else as_ @ bb + ab @ bs + ab @ bb
    return torch.view_as_complex(y.reshape(*y.shape[:-1], -1, 2).contiguous())
