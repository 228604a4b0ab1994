"""The plain reference of a PFB (TONES) readout, and the input it is fed.

TONES mode (the reference's ``process_pfb``) cuts the stream into
frames of nfft samples, sums avg of them under a polyphase window and
takes each frame's DFT; each tone reads its bin.  The window is a
Hamming-windowed sinc of nfft * avg taps cut off at 1 / (2 * nfft) of
the rate, unit sum (cpp/USRP_demodulator.cpp:131-134).  Frame t of
block k is

    pre[t, s] = sum_{i<avg} w[i*nfft + s] * ext[(t+i)*nfft + s]
    out[t, c] = sum_s pre[t, s] * exp(-2j*pi*s*b_c/nfft)

with ext block k after the (avg-1)*nfft samples before it (zeros before
the stream starts, the recording's last block at the loop seam) and b_c
tone c's bin (the reference's upload_multitone_parameters,
cpp/USRP_demodulator.cpp:702-768).  Here that is float64 throughout.
The control is the same computation with the window and the input
rounded to float16, then summed and transformed in float32: the step
below the float32 the configuration states.

Plain PyTorch and NumPy only: nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pfb_window(nfft: int, avg: int) -> np.ndarray:
    """The reference's PFB prototype (make_sinc_window(nfft * avg,
    1 / (2 * nfft)), Hamming-windowed sinc, unit sum), float64."""
    n = nfft * avg
    if n == 1:
        return np.ones(1)
    fc = 1.0 / (2.0 * nfft)
    i = np.arange(n, dtype=np.float64)
    k = i - (n - 1) // 2
    x = 2.0 * np.pi * fc * k
    sinc = np.where(k != 0, 2.0 * fc * np.sin(x) / np.where(k != 0, x, 1.0),
                    2.0 * fc)
    win = sinc * (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1)))
    return win / win.sum()


def tone_bins(freqs, rate: int, nfft: int) -> np.ndarray:
    """Each tone's bin as the reference maps it: of the axis i*bs -
    bs*(nfft//2) (bs = rate / nfft), the last point within bs of the
    tone, its index shifted by nfft//2 mod nfft; bin 0 where none is."""
    bs = float(rate) / float(nfft)
    axis = np.arange(nfft, dtype=np.float64) * bs - bs * (nfft // 2)
    f = np.asarray(freqs, dtype=np.float64)[:, None]
    near = (axis - bs < f) & (f < axis + bs)                  # (tones, nfft)
    last = nfft - 1 - np.argmax(near[:, ::-1], axis=1)
    return np.where(near.any(axis=1), (last + nfft // 2) % nfft,
                    0).astype(np.int64)


def _turns(freqs: torch.Tensor, a: torch.Tensor, W: int) -> torch.Tensor:
    """((f mod W) * (a mod W)) mod W / W as float64, (len(a), len(f)):
    the exact phase of each tone at each absolute sample index."""
    ph = (torch.remainder(a, W)[:, None] * torch.remainder(freqs, W)[None])
    return torch.remainder(ph, W).to(torch.float64) / W


def make_recording(cfg: dict, seed: int, n_blocks: int,
                   device) -> torch.Tensor:
    """`n_blocks` blocks of the input, (n_blocks * L,) complex64 on
    `device`: each tone at a seeded amplitude and phase, plus seeded
    complex noise.  Made as one matmul of per-chunk tone phasors by each
    tone's phasor within a chunk (a chunk of about sqrt(n) samples), so
    every seed costs the same."""
    rx, inp = cfg["rx"], cfg["input"]
    W, L = int(rx["rate"]), int(rx["buffer_len"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    freqs = torch.tensor(rx["freq"], dtype=torch.int64, device=device)
    lo, hi = inp["tone_amplitude"]
    amp = lo + (hi - lo) * torch.rand(len(freqs), generator=g,
                                      dtype=torch.float64, device=device)
    phi = 2.0 * np.pi * torch.rand(len(freqs), generator=g,
                                   dtype=torch.float64, device=device)
    n = n_blocks * L
    chunk = 1 << math.ceil(math.log2(max(math.sqrt(n), 1.0)))
    m = torch.arange(chunk, dtype=torch.int64, device=device)
    inner = torch.exp(2j * np.pi * _turns(freqs, m, W))          # (chunk, C)
    starts = torch.arange(0, n, chunk, dtype=torch.int64, device=device)
    outer = amp * torch.exp(1j * phi + 2j * np.pi * _turns(freqs, starts, W))
    x = (outer.to(torch.complex64) @ inner.T.to(torch.complex64)).reshape(-1)
    x = x[:n]
    x += torch.randn(n, generator=g, dtype=torch.complex64,
                     device=device) * float(inp["noise_rms"])
    return x


class Reference:
    """The TONES output of packet k, block k of a stream that loops
    `recording` (numpy complex64, whole blocks), from its samples."""

    def __init__(self, cfg: dict, recording: np.ndarray, device):
        rx = cfg["rx"]
        self.L, self.nfft = int(rx["buffer_len"]), int(rx["fft_tones"])
        self.avg = int(rx["pf_average"])
        if self.L % self.nfft or int(rx.get("decim", 0)):
            raise ValueError("the reference takes blocks of whole frames "
                             "and no frame averaging (decim 0)")
        self.H = (self.avg - 1) * self.nfft
        self.rec = recording
        self.nrec = len(recording) // self.L
        self.device = device
        self.w = torch.from_numpy(pfb_window(self.nfft, self.avg)).to(
            device).reshape(self.avg, self.nfft)
        self.bins = torch.from_numpy(
            tone_bins(rx["freq"], int(rx["rate"]), self.nfft)).to(device)

    def _extended(self, k: int) -> np.ndarray:
        """Block k's samples, after the H samples before it (zeros
        before the stream's start)."""
        b = k % self.nrec
        blk = self.rec[b * self.L:(b + 1) * self.L]
        if k == 0:
            prev = np.zeros(self.H, np.complex64)
        else:
            p = (k - 1) % self.nrec
            prev = self.rec[(p + 1) * self.L - self.H:(p + 1) * self.L]
        return np.concatenate([prev, blk])

    def output(self, k: int, control: bool = False) -> torch.Tensor:
        """(L // nfft, tones) on the device: complex128, or with
        `control` complex64 from float16 window and input."""
        ext = torch.from_numpy(self._extended(k)).to(self.device)
        w = self.w
        if control:
            ext = torch.complex(ext.real.half().float(),
                                ext.imag.half().float())
            w = w.half().float()
        else:
            ext = ext.to(torch.complex128)
        T = self.L // self.nfft
        X = ext.reshape(T + self.avg - 1, self.nfft)
        pre = X[0:T] * w[0]
        for i in range(1, self.avg):
            pre = pre + X[i:i + T] * w[i]
        return torch.fft.fft(pre, dim=-1).index_select(-1, self.bins)
