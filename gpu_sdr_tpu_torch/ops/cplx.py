"""numpy complex <-> torch.complex64 at the host boundary, and the
integer-phase oscillator's rotation.

The JAX package carries complex data as float32 (re, im) pairs because
its TPU backend has no complex dtype; PyTorch has one, so the port uses
``torch.complex64`` throughout and needs only the two conversions."""

from __future__ import annotations

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
