"""Chirp generation and demodulation (CHIRP / VNA mode), plain PyTorch.

Port of gpu_sdr_tpu/ops/chirp.py: the reference's integer phase
accumulator (chirp_gen / chirp_demodulator, cpp/kernels.cu:335-441) in
wrapping uint32 arithmetic, congruent mod 2^32 to the reference's
uint64 computation, so the phase index is bit-exact.  PyTorch has no
general uint32 arithmetic: values in [0, 2^32) are held in int64 and
masked to 32 bits after each sum of products.  A product with a factor
under 2^31 (a stream position, a step index) stays below 2^63; the one
product of two full 32-bit values, chirpness * (length * q_phase), is
formed from 16-bit halves (``_mul32_by``), so no intermediate leaves
int64's range (a down-chirp's chirpness wraps to >= 2^31, and the
plain product would pass 2^63).

The sin/cos is float32 in the JAX package's order, th = float32(pi) *
(float32(idx) * float32(1/2^31.5)): the phase error stays near 2^-23
turns (~-127 dBc), under the 90 dB bar.  The stream position (the
reference's last_index) is a Python int carried by the caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import golden
from ..params import AntennaParams, chirp_steps_and_length

M32 = 0xFFFFFFFF
# the one-period oscillator table's size limit: the JAX package's
# device-resident budget (gpu_sdr_tpu/engine/replay.py:35)
CHIRP_TABLE_MAX_BYTES = 2 << 30
# the float32 constants of th = pi * (idx * (1 / 2147483647.5))
INV_2_31_5 = float(np.float32(1.0 / golden.TWO_31_5))
PI_F32 = float(np.float32(np.pi))


@dataclasses.dataclass(frozen=True)
class ChirpConfig:
    """Quantized chirp descriptor (reference chirp_parameter,
    headers/kernels.cuh:58-64, built in cpp/USRP_demodulator.cpp:192-221)."""

    num_steps: int      # frequency steps in the sweep
    length: int         # samples per step
    chirpness: int      # uint32 quadratic-phase coefficient
    f0: int             # int32 start-frequency phase increment

    @classmethod
    def from_params(cls, f_start: int, f_end: int, rate: int,
                    num_steps: int, chirp_t: float) -> "ChirpConfig":
        cp = golden.ChirpParameter(f_start, f_end, rate, num_steps, chirp_t)
        return cls(num_steps=cp.num_steps, length=cp.length,
                   chirpness=int(cp.chirpness), f0=int(cp.f0))

    @property
    def period(self) -> int:
        """Samples after which the integer-phase chirp repeats exactly."""
        p = self.num_steps * self.length
        assert p < 2 ** 31, "chirp period must fit in int31 for uint32 math"
        return p


def chirp_config(p: AntennaParams) -> ChirpConfig:
    """An antenna's quantized chirp, from its first channel's
    descriptors (reference cpp/USRP_demodulator.cpp:192-221)."""
    steps, _ = chirp_steps_and_length(p)
    return ChirpConfig.from_params(p.freq[0], p.chirp_f[0], int(p.rate),
                                   steps, p.chirp_t[0])


def chirp_table_fits(cfg: ChirpConfig, block_len: int, ppt: int) -> bool:
    """Whether a one-period table (chirp_period_table) serves blocks of
    block_len samples: whole segments per block, whole blocks per
    period, and the table within CHIRP_TABLE_MAX_BYTES."""
    period = cfg.period
    return (ppt > 0 and block_len % ppt == 0 and period % block_len == 0
            and period * 8 <= CHIRP_TABLE_MAX_BYTES)


def _mul32_by(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k mod 2^32 for a in [0, 2^32) and a constant k in [0, 2^32):
    k split in 16-bit halves, so each partial product stays below 2^48
    where a * k itself could pass 2^63."""
    k_lo, k_hi = k & 0xFFFF, k >> 16
    return ((((a * k_hi) & 0xFFFF) << 16) + a * k_lo) & M32


def _phase_index_at(cfg: ChirpConfig, eff: torch.Tensor) -> torch.Tensor:
    """The int32 phase index (as int64) at stream positions eff in
    [0, period) (an int32 tensor): cpp/kernels.cu:344-366 mod 2^32.
    Every product below has a factor under 2^31 (eff, fi) or is split
    (pc), so no int64 product passes 2^63."""
    chirpness, f0 = cfg.chirpness & M32, cfg.f0 & M32
    fi = torch.div(eff, cfg.length, rounding_mode="floor").to(torch.int64)
    e = eff.to(torch.int64)
    q_phase = ((fi >> 1) * (fi + 1) + (fi & 1) * ((fi + 1) >> 1)) & M32
    pc = _mul32_by(q_phase, (cfg.length * chirpness) & M32)
    base = (fi * chirpness + f0) & M32
    idx = (e * base - pc) & M32
    return torch.where(idx >= 2 ** 31, idx - 2 ** 32, idx)


def _positions(cfg: ChirpConfig, last_index: int,
               r: torch.Tensor) -> torch.Tensor:
    """The stream positions (last_index + r) mod period, int32, at
    offsets r (int64) already in [0, period): both terms are below the
    period, so one wrap suffices."""
    period = cfg.period
    eff = r + int(last_index) % period
    return torch.where(eff >= period, eff - period, eff).to(torch.int32)


def chirp_phase_index(cfg: ChirpConfig, last_index: int,
                      n: torch.Tensor) -> torch.Tensor:
    """int32 phase-accumulator values (as int64) at sample offsets `n`
    (int64, >= 0) of a stream at position `last_index`: the wrapping
    uint32 arithmetic of ops/chirp.chirp_phase_index (cpp/kernels.cu:
    344-366), bit for bit."""
    return _phase_index_at(cfg, _positions(cfg, last_index, n % cfg.period))


def _chirp_wave(cfg: ChirpConfig, last_index: int, block_len: int,
                device) -> torch.Tensor:
    """The unit chirp sin(th) - 1j*cos(th), complex64 (block_len,):
    chirp_phase_index at offsets arange(block_len), reduced by a
    division only where the block is longer than the period."""
    r = torch.arange(block_len, dtype=torch.int64, device=device)
    if block_len > cfg.period:
        r = torch.remainder(r, cfg.period)
    idx = _phase_index_at(cfg, _positions(cfg, last_index, r))
    th = (idx.to(torch.float32) * INV_2_31_5) * PI_F32
    return torch.complex(torch.sin(th), -torch.cos(th))


def advance(cfg: ChirpConfig, last_index: int, block_len: int) -> int:
    """The stream position `block_len` samples later, mod the period."""
    return (int(last_index) + block_len % cfg.period) % cfg.period


def chirp_block(cfg: ChirpConfig, last_index: int, block_len: int,
                scale: float = 1.0, *, device):
    """One TX chirp block: (new_last_index, x) with
    x[n] = scale * (sin(th) - 1j*cos(th)), th = pi*idx/2^31.5
    (reference chirp_gen, cpp/kernels.cu:367-368)."""
    c = _chirp_wave(cfg, last_index, block_len, device)
    s = float(np.float32(scale))
    x = torch.complex(c.real * s, c.imag * s)
    return advance(cfg, last_index, block_len), x


def chirp_demod_block(cfg: ChirpConfig, last_index: int, x: torch.Tensor):
    """One RX block mixed down: (new_last_index, z = conj(chirp) * x)
    (reference chirp_demodulator, cpp/kernels.cu:389-427)."""
    L = x.shape[0]
    c = _chirp_wave(cfg, last_index, L, x.device)
    return advance(cfg, last_index, L), c.conj() * x


def chirp_period_table(cfg: ChirpConfig, block_len: int, ppt: int,
                       scale: float = 1.0, *, device) -> torch.Tensor:
    """One period of the chirp from stream position 0, (period // ppt,
    ppt) complex64: segment-aligned rows for the table lock-in kernels
    (ops/lockin_table.py).  Generated block by block (period //
    block_len chirp_block calls) into one tensor, so the int64 phase
    temporaries stay one block long; block_len divides the period."""
    period = cfg.period
    if period % block_len or block_len % ppt:
        raise ValueError(f"chirp table: block {block_len} must divide the "
                         f"period {period} and be whole segments of {ppt}")
    table = torch.empty(period, dtype=torch.complex64, device=device)
    last = 0
    for b in range(period // block_len):
        last, table[b * block_len:(b + 1) * block_len] = chirp_block(
            cfg, last, block_len, scale=scale, device=device)
    return table.reshape(period // ppt, ppt)
