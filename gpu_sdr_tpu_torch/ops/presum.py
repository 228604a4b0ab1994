"""PFB windowed pre-sum: the CUDA kernel (csrc/presum.cu) and its plain
PyTorch version.

Port of gpu_sdr_tpu/ops/pallas_pfb.py (pallas_presum, pfb_frames_fused):

    pre[t, b] = sum_{i<avg} W[i, b] * ext[t+i, b],  ext = concat(spare, X)

computed without materializing ext.  The DFT after it stays torch
(``torch.fft.fft``), as the JAX package left it to XLA.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .pfb import PFBConfig


def presum_plain(window2d: torch.Tensor, spare: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pre-sum.  window2d (avg, nfft) float32; spare
    (avg-1, nfft) and X (T, nfft) complex64 -> (T, nfft) complex64."""
    avg = window2d.shape[0]
    T = X.shape[0]
    ext = torch.cat([spare, X]) if spare.shape[0] else X
    pre = ext[0:T] * window2d[0]
    for i in range(1, avg):
        pre = pre + ext[i:i + T] * window2d[i]
    return pre


def _check(window2d, spare, X):
    avg, nfft = window2d.shape
    if X.dtype != torch.complex64 or spare.dtype != torch.complex64 or \
            window2d.dtype != torch.float32:
        raise TypeError("presum wants complex64 X/spare, float32 window")
    if X.ndim != 2 or X.shape[1] != nfft or \
            tuple(spare.shape) != (avg - 1, nfft):
        raise ValueError(f"presum shapes: window {tuple(window2d.shape)}, "
                         f"spare {tuple(spare.shape)}, X {tuple(X.shape)}")
    if not (X.device == spare.device == window2d.device):
        raise ValueError("presum operands on different devices")


def presum(window2d: torch.Tensor, spare: torch.Tensor,
           X: torch.Tensor) -> torch.Tensor:
    """The pre-sum: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Counts its kernel launches in ``presum.launches``."""
    _check(window2d, spare, X)
    if X.device.type == "cpu":
        return presum_plain(window2d, spare, X)
    if X.device.type != "cuda":
        raise ValueError(f"presum: unsupported device {X.device}")
    X, spare, window2d = (X.contiguous(), spare.contiguous(),
                          window2d.contiguous())
    out = torch.empty_like(X)
    if X.shape[0] == 0:
        return out
    lib = build.load()
    rc = lib.sdr_presum(X.data_ptr(), spare.data_ptr(), window2d.data_ptr(),
                        out.data_ptr(), X.shape[0], X.shape[1],
                        window2d.shape[0],
                        torch.cuda.current_stream(X.device).cuda_stream)
    build.check(rc, "sdr_presum")
    presum.launches += 1
    return out


presum.launches = 0


def pfb_frames_fused(cfg: PFBConfig, window: torch.Tensor,
                     spare: torch.Tensor, x: torch.Tensor):
    """ops/pfb.pfb_frames with the pre-sum kernel: (new_spare, frames).

    spare: ((avg-1)*nfft,) carried samples; x: (L,) block."""
    nfft, avg = cfg.nfft, cfg.avg
    L = x.shape[0]
    H = (avg - 1) * nfft
    X = x.reshape(L // nfft, nfft)
    pre = presum(window.reshape(avg, nfft), spare.reshape(avg - 1, nfft), X)
    frames = torch.fft.fft(pre, dim=-1)
    new_spare = x[L - H:] if H <= L else torch.cat([spare, x])[L:]
    return new_spare, frames
