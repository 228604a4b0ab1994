"""The plain reference of a VNA chirp lock-in, and the input it is fed.

The reference's CHIRP mode sweeps an integer-phase chirp (its
``chirp_parameter``, cpp/USRP_demodulator.cpp:192-221, and the phase
accumulator of chirp_gen / chirp_demodulator, cpp/kernels.cu:335-441)
and averages the mixed-down stream over each ppt-sample lock-in
segment with a flat profile that zeroes the first ppt // 10 samples:

    y[s] = sum_k w[k] * conj(c[s*ppt + k]) * x[s*ppt + k]
    c[n] = sin(th) - 1j*cos(th),  th = pi * idx[n] / (2^31 - 0.5)

with idx the int32 phase index at the stream position n mod the
period.  Here the index is integer arithmetic mod 2^32, the angle and
the sum float64.  The control is the same sum with the chirp, the
input, their products and the profile in bfloat16: the step below the
float32 the configuration states.

Plain PyTorch and NumPy only: nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
HALF_TURN = 2147483647.5        # the reference's _31_BIT_VALUE
CHUNK = 10_000_000              # samples a pass of the input's generator


def quantize(rx: dict) -> dict:
    """The reference's chirp descriptor: steps, samples a step, the
    uint32 chirpness and the int32 start increment, truncated and
    wrapped as its C types store them."""
    rate, t = int(rx["rate"]), float(rx["chirp_t"][0])
    f_start, f_end = int(rx["freq"][0]), int(rx["chirp_f"][0])
    steps = int(rx["swipe_s"][0]) if rx.get("swipe_s") else 0
    if steps < 1:
        steps = int(t * rate)
    length = max(int(t * rate / steps), 1)
    full = float(2 ** 32 - 1)
    chirpness = (int(full * (f_end - f_start) / ((steps - 1.0) * rate))
                 % 2 ** 32) if steps > 1 else 0
    f0 = int(full * (float(f_start) / float(rate))) % 2 ** 32
    return dict(steps=steps, length=length, chirpness=chirpness, f0=f0,
                period=steps * length)


def _mulmod32(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k mod 2^32 for a, k in [0, 2^32), in int64 without overflow:
    k in 16-bit halves."""
    lo, hi = k & 0xFFFF, k >> 16
    return ((((a * hi) & 0xFFFF) << 16) + a * lo) & M32


def phase_index(q: dict, pos: torch.Tensor) -> torch.Tensor:
    """The signed int32 phase index at stream positions `pos` (int64 in
    [0, period)): step fi = pos // length,
    idx = pos * (fi * chirpness + f0) - chirpness * length * fi(fi+1)/2."""
    fi = torch.div(pos, q["length"], rounding_mode="floor")
    tri = (fi * (fi + 1) // 2) & M32
    pc = _mulmod32(tri, (q["length"] * q["chirpness"]) & M32)
    base = (fi * q["chirpness"] + q["f0"]) & M32
    idx = (pos * base - pc) & M32
    return torch.where(idx >= 2 ** 31, idx - 2 ** 32, idx)


def chirp(q: dict, pos: torch.Tensor) -> torch.Tensor:
    """The unit chirp at stream positions `pos`, complex128."""
    th = phase_index(q, pos).to(torch.float64) * (np.pi / HALF_TURN)
    return torch.complex(torch.sin(th), -torch.cos(th))


def profile(ppt: int, device) -> torch.Tensor:
    """The lock-in's flat profile: the first ppt // 10 samples zero,
    unit sum, float64."""
    w = torch.zeros(ppt, dtype=torch.float64, device=device)
    w[ppt // 10:] = 1.0
    return w / w.sum()


def make_recording(cfg: dict, seed: int, n_blocks: int,
                   device) -> torch.Tensor:
    """`n_blocks` blocks of the input, (n_blocks * L,) complex64 on
    `device`: the chirp from stream position 0 through a seeded S21,
    constant over each chirp step (a few resonator dips, an amplitude and
    a cable delay), plus seeded complex noise.  Every seed has the same
    number of dips, so every seed costs the same."""
    rx, inp = cfg["rx"], cfg["input"]
    q = quantize(rx)
    rate, L = int(rx["rate"]), int(rx["buffer_len"])
    g = torch.Generator(device=device).manual_seed(int(seed))

    def draw(lo_hi, n=None):
        lo, hi = lo_hi
        u = torch.rand(n or 1, generator=g, dtype=torch.float64,
                       device=device)
        return lo + (hi - lo) * u

    nres = int(inp["resonators"])
    fr, depth = draw(inp["resonator_hz"], nres), draw(inp["depth"], nres)
    width = draw(inp["linewidth_hz"], nres)
    amp, delay = draw(inp["amplitude"]), draw(inp["delay_s"])
    f_start, f_end = float(rx["freq"][0]), float(rx["chirp_f"][0])
    step_f = f_start + (f_end - f_start) * torch.arange(
        q["steps"], dtype=torch.float64, device=device) / max(
            q["steps"] - 1, 1)
    dips = depth / (1 + 2j * (step_f[:, None] - fr) / width)
    s21 = amp * torch.exp(-2j * np.pi * step_f * delay) * (1 - dips.sum(1))
    n = n_blocks * L
    x = torch.empty(n, dtype=torch.complex64, device=device)
    for a in range(0, n, CHUNK):
        pos = torch.remainder(torch.arange(a, min(a + CHUNK, n),
                                           dtype=torch.int64, device=device),
                              q["period"])
        x[a:a + len(pos)] = chirp(q, pos) * s21[pos // q["length"]]
    x += torch.randn(n, generator=g, dtype=torch.complex64,
                     device=device) * float(inp["noise_rms"])
    return x


class Reference:
    """The lock-in points of packet k, block k of a stream that loops
    `recording` (numpy complex64, whole blocks), from its samples."""

    def __init__(self, cfg: dict, recording: np.ndarray, device):
        rx = cfg["rx"]
        self.q = quantize(rx)
        self.L = int(rx["buffer_len"])
        self.ppt = self.q["length"] * int(rx["decim"])
        self.nseg = self.L // self.ppt
        self.rec = recording
        self.nrec = len(recording) // self.L
        self.device = device
        self.w = profile(self.ppt, device)

    def output(self, k: int, control: bool = False) -> torch.Tensor:
        """(nseg, 1) on the device: complex128, or with `control`
        complex64 from bfloat16 products and sums."""
        b = k % self.nrec
        x = torch.from_numpy(self.rec[b * self.L:(b + 1) * self.L]).to(
            self.device)
        pos = torch.remainder(k * self.L + torch.arange(
            self.L, dtype=torch.int64, device=self.device), self.q["period"])
        c = chirp(self.q, pos)
        if not control:
            z = (c.conj() * x.to(torch.complex128)).reshape(self.nseg,
                                                            self.ppt)
            return (z @ self.w.to(torch.complex128))[:, None]
        bf = torch.bfloat16
        cr, ci = c.real.to(bf), c.imag.to(bf)
        xr, xi = x.real.to(bf), x.imag.to(bf)
        zr = (cr * xr + ci * xi).reshape(self.nseg, self.ppt)
        zi = (cr * xi - ci * xr).reshape(self.nseg, self.ppt)
        w = self.w.to(bf)
        return torch.complex((zr @ w).float(), (zi @ w).float())[:, None]
