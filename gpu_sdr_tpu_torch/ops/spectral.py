"""Batched Welch PSD on the device (port of gpu_sdr_tpu/ops/spectral.py).

The reference computes per-channel Welch PSDs on the host with
joblib-parallel scipy (calculate_noise, pyUSRP/USRP_noise.py:779-784).
Here the same estimate (periodic Hann window, 50% overlap, per-segment
linear detrend, density scaling) runs over every channel in one batched
call: the segments are a strided view of the rows (``Tensor.unfold``)
and the transform is ``torch.fft.rfft``, where the JAX package runs a
DFT matmul (the TPU has no FFT).  The arithmetic is float32, as in JAX.

`welch_psd` matches scipy.signal.welch(x, fs, nperseg=..., detrend=
'linear', scaling='density') for real inputs (tests/test_torch_spectral.py).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def _detrend_linear(seg: torch.Tensor) -> torch.Tensor:
    """Remove the least-squares line from each row of (..., n)."""
    n = seg.shape[-1]
    tc = torch.arange(n, dtype=seg.dtype, device=seg.device) - (n - 1) / 2.0
    denom = torch.sum(tc * tc)
    x_mean = torch.mean(seg, dim=-1, keepdim=True)
    slope = torch.sum(seg * tc, dim=-1, keepdim=True) / denom
    return seg - x_mean - slope * tc


def welch_psd(x: torch.Tensor, fs: float, nperseg: int):
    """Batched one-sided Welch PSD of real input, each segment linearly
    detrended.

    Args:
      x: (..., N) real float32 samples.
      fs: sampling rate.
      nperseg: segment length (noverlap = nperseg//2, like scipy's
        default); clamped to N, with a warning, as scipy does.

    Returns (freqs (nf,) numpy, psd (..., nf) tensor), nf = nperseg//2+1.
    """
    N = x.shape[-1]
    if nperseg > N:
        warnings.warn(f"nperseg={nperseg} > data length {N}; "
                      f"using nperseg={N}")
        nperseg = N
    step = max(1, nperseg // 2)
    segs = x.unfold(-1, nperseg, step)          # (..., nseg, nperseg)
    segs = _detrend_linear(segs)
    win = hann_periodic(nperseg)
    spec = torch.fft.rfft(segs * torch.from_numpy(win).to(x.device))
    power = spec.real * spec.real + spec.imag * spec.imag
    w64 = win.astype(np.float64)
    scale = 1.0 / (fs * float(np.sum(w64 * w64)))
    psd = power.mean(dim=-2) * scale
    # double everything except DC (and Nyquist when nperseg is even)
    nf = nperseg // 2 + 1
    mult = np.full(nf, 2.0, dtype=np.float32)
    mult[0] = 1.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    psd = psd * torch.from_numpy(mult).to(x.device)
    return np.fft.rfftfreq(nperseg, d=1.0 / fs), psd


def batched_welch(data: np.ndarray, fs: float, nperseg: int,
                  device="cuda"):
    """Host convenience: (C, N) real numpy -> (freqs, (C, nf) numpy),
    computed on `device`."""
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(device)
    f, p = welch_psd(x, fs, nperseg)
    return f, p.cpu().numpy()
