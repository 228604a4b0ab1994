"""Commensurate block planning (a copy of gpu_sdr_tpu/engine/planner.py,
which has no JAX in it but is reachable only through the JAX engine
package), and the two facts of an antenna every path's choice starts
from: whether it mixes wave types (_is_mixed) and which TX drives it
(_pair_tx).

The reference streams fixed 1 Msample blocks and absorbs the incommensurate
remainders (FFT windows, ppt segments, decimation groups straddling block
edges) with on-device move_buffer shuffles and variable per-block output
lengths (buffer_helper / VNA_decimator_helper / pfb_decimator_helper,
cpp/USRP_server_memory_management.cpp:30-156).  XLA wants static shapes, so
we instead *choose the block length* to be commensurate with every stride in
the chain — then every block emits exactly the same output shape and the
only carried state is fixed-size overlap history.

For a requested buffer_len B (default 1e6, bounds [5e4, 6e6] like the
reference) and a stride requirement q (nfft, decim, ppt, nfft*decim, ...),
the planned block is the multiple of q nearest B, clamped to the bounds
(always >= q).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..params import (AntennaParams, AntMode, DEFAULT_BUFFER_LEN,
                      MAX_USEFULL_BUFFER, MIN_USEFULL_BUFFER, UsrpParams,
                      WaveType, chirp_steps_and_length)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Resolved streaming geometry for one antenna."""

    block_len: int          # raw input samples per block
    stride: int             # input samples consumed per output row
    out_rows: int           # output rows per block (= block_len // stride)
    n_blocks: int           # blocks for the full acquisition
    total_samples: int      # raw samples actually processed (n_blocks*block)

    @property
    def total_out_rows(self) -> int:
        return self.out_rows * self.n_blocks


def _commensurate(requested: int, q: int) -> int:
    """Multiple of q nearest `requested`, >= q, clamped to buffer bounds."""
    if requested <= 0:
        requested = DEFAULT_BUFFER_LEN
    k = max(1, round(requested / q))
    b = k * q
    while b > MAX_USEFULL_BUFFER and k > 1:
        k -= 1
        b = k * q
    if b < MIN_USEFULL_BUFFER:
        k = math.ceil(MIN_USEFULL_BUFFER / q)
        b = k * q
    return b


def mode_stride(p: AntennaParams) -> int:
    """Input samples consumed per output row of the demodulated stream."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    if w == WaveType.DIRECT:
        return max(int(p.decim), 1)
    if w in (WaveType.TONES, WaveType.NOISE):
        q = int(p.fft_tones)
        if p.decim > 0:
            q *= int(p.decim)
        return q
    if w == WaveType.CHIRP:
        if p.decim > 0:
            _, length = chirp_steps_and_length(p)
            return length * int(p.decim)       # ppt
        return 1
    return 1


def plan_blocks(p: AntennaParams, samples: int | None = None) -> BlockPlan:
    """Choose block geometry for one antenna's acquisition."""
    q = mode_stride(p)
    block_len = _commensurate(p.buffer_len or DEFAULT_BUFFER_LEN, q)
    total = int(samples if samples is not None else p.samples)
    if total <= 0:
        total = block_len
    n_blocks = max(1, math.ceil(total / block_len))
    return BlockPlan(
        block_len=block_len,
        stride=q,
        out_rows=block_len // q,
        n_blocks=n_blocks,
        total_samples=n_blocks * block_len,
    )


def _is_mixed(rx: AntennaParams) -> bool:
    """Antenna with more than one wave type."""
    return bool(rx.wave_type) and any(w != rx.wave_type[0]
                                      for w in rx.wave_type)


def _pair_tx(params: UsrpParams, rx_name: str) -> Optional[str]:
    """The TX antenna driving a given RX: same front end letter first
    (the reference's A_TXRX -> A_RX2 pairing), else any TX."""
    letter = rx_name[0]
    for name, p in params.active_antennas(AntMode.TX):
        if name.startswith(letter):
            return name
    for name, p in params.active_antennas(AntMode.TX):
        return name
    return None
