"""The plain reference of a DIRECT readout, and the input it is fed.

DIRECT mode (the reference's ``process_direct``) mixes each tone down
with an exact integer-phase oscillator and filters it with a decimating
FIR: a Hamming-windowed sinc of decim * pf_average taps, cut off at
0.75 / (2 * decim) of the rate, unit sum.  Output row n of tone c is

    y[n, c] = sum_i h[i] * x[a] * exp(-2j*pi*((f_c * a) mod W)/W),
    a = n*M - (f-1)*M + i,  i in [0, f*M)

with a the stream's absolute sample index (zero before the stream
starts), W the rate, M the decimation and f the taps per phase.  Here
that is a float64 matmul of a block's window rows by the modulated
taps, the carrier of each row applied after.  The control is the same
computation in float32 with the matmul on TF32 tensor cores: the step
below the float32 the configuration states.

Plain PyTorch and NumPy only: nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 10_000                  # samples a row of the comb's generator matmul


def fir_taps(decim: int, pf_average: int) -> np.ndarray:
    """The reference's DIRECT FIR (make_sinc_window(decim * pf_average,
    0.75 / (2 * decim)), Hamming-windowed sinc, unit sum), float64."""
    n = decim * pf_average
    if n == 1:
        return np.ones(1)
    fc = 0.75 / (2.0 * decim)
    i = np.arange(n, dtype=np.float64)
    k = i - (n - 1) // 2
    x = 2.0 * np.pi * fc * k
    sinc = np.where(k != 0, 2.0 * fc * np.sin(x) / np.where(k != 0, x, 1.0),
                    2.0 * fc)
    win = sinc * (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1)))
    return win / win.sum()


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
    tone's phasor within a chunk, so every seed costs the same."""
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
    m = torch.arange(CHUNK, dtype=torch.int64, device=device)
    inner = torch.exp(2j * np.pi * _turns(freqs, m, W))          # (CHUNK, C)
    starts = torch.arange(0, n, CHUNK, dtype=torch.int64, device=device)
    outer = amp * torch.exp(1j * phi + 2j * np.pi * _turns(freqs, starts, W))
    x = (outer.to(torch.complex64) @ inner.T.to(torch.complex64)).reshape(-1)
    x = x[:n]
    x += torch.randn(n, generator=g, dtype=torch.complex64,
                     device=device) * float(inp["noise_rms"])
    return x


class Reference:
    """The DIRECT output of packet k, block k of a stream that loops
    `recording` (numpy complex64, whole blocks), from its samples."""

    def __init__(self, cfg: dict, recording: np.ndarray, device):
        rx = cfg["rx"]
        self.W, self.L = int(rx["rate"]), int(rx["buffer_len"])
        self.M, self.f = int(rx["decim"]), int(rx["pf_average"])
        self.H = (self.f - 1) * self.M
        self.rec = recording
        self.nrec = len(recording) // self.L
        self.device = device
        self.freqs = torch.tensor(rx["freq"], dtype=torch.int64,
                                  device=device)
        h = torch.from_numpy(fir_taps(self.M, self.f)).to(device)
        i = torch.arange(self.f * self.M, dtype=torch.int64, device=device)
        self.hmod = h[:, None] * torch.exp(
            -2j * np.pi * _turns(self.freqs, i, self.W))        # (f*M, C)

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
        """(L // M, C) on the device: complex128, or with `control`
        complex64 from TF32 matmuls."""
        dt = torch.complex64 if control else torch.complex128
        ext = torch.from_numpy(self._extended(k)).to(self.device, dt)
        rows = ext.unfold(0, self.f * self.M, self.M)           # (nb, f*M)
        nb = rows.shape[0]
        a = k * self.L - self.H + self.M * torch.arange(
            nb, dtype=torch.int64, device=self.device)
        carrier = torch.exp(-2j * np.pi * _turns(self.freqs, a, self.W))
        if not control:
            return (rows @ self.hmod) * carrier
        return tf32_matmul(rows, self.hmod.to(dt)) * carrier.to(dt)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A complex64 product from four float32 matmuls on TF32 tensor
    cores."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ar, ai = a.real.contiguous(), a.imag.contiguous()
        br, bi = b.real.contiguous(), b.imag.contiguous()
        return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
