"""Polyphase filter bank channelizer (TONES / NOISE modes), plain PyTorch.

Frame t (hop nfft, support avg*nfft) of a contiguous stream x:

    pre[t, b] = sum_{i<avg} x[t*nfft + b + i*nfft] * w[b + i*nfft]
    out[t]    = FFT_nfft(pre[t])

Blocks are commensurate with nfft (engine/planner.py), so every block
yields L/nfft frames and the carry is a fixed (avg-1)*nfft-sample spare.
The spare starts at zero: the first avg-1 frames of a stream carry the
startup transient, as in the JAX package (gpu_sdr_tpu/ops/pfb.py).

The hand-written kernels live in ops/presum.py (the pre-sum alone) and
ops/channelizer.py (pre-sum + two-stage DFT); this module is the plain
reference they are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import golden
from .windows import pfb_window


def tone_bins(freqs, rate: int, nfft: int) -> np.ndarray:
    """Tone-frequency -> FFT-bin mapping, bit-identical to the reference
    (upload_multitone_parameters, cpp/USRP_demodulator.cpp:702-768)."""
    return golden.tone_bins(freqs, rate, nfft)


@dataclasses.dataclass(frozen=True)
class PFBConfig:
    """Static PFB configuration for one antenna."""

    nfft: int                       # FFT length / number of bins
    avg: int                        # pf_average: taps per bin
    rate: int                       # input sample rate
    bins: Optional[Tuple[int, ...]] = None  # selected bins (None = full)
    decim: int = 0                  # extra frame averaging factor

    def window(self, device) -> torch.Tensor:
        """(nfft*avg,) float32 prototype window."""
        return torch.from_numpy(pfb_window(self.nfft, self.avg)).to(device)

    def bins_tensor(self, device) -> Optional[torch.Tensor]:
        if self.bins is None:
            return None
        return torch.as_tensor(np.asarray(self.bins, dtype=np.int64),
                               device=device)


def pfb_spare_init(cfg: PFBConfig, device) -> torch.Tensor:
    """Initial raw-sample carry: (avg-1)*nfft complex zeros."""
    return torch.zeros((cfg.avg - 1) * cfg.nfft, dtype=torch.complex64,
                       device=device)


def pfb_frames(cfg: PFBConfig, window: torch.Tensor, spare: torch.Tensor,
               x: torch.Tensor):
    """One block of the PFB channelizer.

    window: (nfft*avg,) float32; spare: ((avg-1)*nfft,) carried samples;
    x: (L,) block, L % nfft == 0.  Returns (new_spare, frames) with
    frames (L//nfft, nfft) complex64 in natural bin order."""
    nfft, avg = cfg.nfft, cfg.avg
    L = x.shape[0]
    nframes = L // nfft
    ze = torch.cat([spare, x]) if spare.shape[0] else x
    X = ze.reshape(nframes + avg - 1, nfft)
    W = window.reshape(avg, nfft)
    pre = X[0:nframes] * W[0]
    for i in range(1, avg):
        pre = pre + X[i:i + nframes] * W[i]
    frames = torch.fft.fft(pre, dim=-1)
    new_spare = ze[L:] if spare.shape[0] else spare
    return new_spare, frames


def select_tones(frames: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Gather selected bins: (T, nfft) -> (T, n_tones)
    (reference tone_select, cpp/kernels.cu:531-554)."""
    return torch.index_select(frames, -1, bins)


def average_frames(frames: torch.Tensor, decim: int) -> torch.Tensor:
    """Average groups of `decim` consecutive frames (reference
    decimate_spectra, cpp/kernels.cu:726-749); T % decim == 0."""
    T, n = frames.shape
    return frames.reshape(T // decim, decim, n).mean(dim=1)
