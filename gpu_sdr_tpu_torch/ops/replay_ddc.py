"""DDC+FIR over a resident recording, block by block: the replay
wrappers of the DDC kernel (csrc/ddc.cu, resident-recording mode).

Port of gpu_sdr_tpu/ops/pallas_replay.py (``ReplayDDC``, ``ReplayDDCT``,
``make_replay_ddc``, ``replay_ddc_kind``).  The recording stays on the
device as (nblk*nbr, M) rows; each step demodulates the block at the
carried block index, reading its rows in place.  The FIR history of a
block is the recording rows before it, wrapped mod the recording at the
loop seam, and zero on the stream's very first block: the JAX kernels'
``val`` flag.  A fused loopback of a periodic comb is such a replay of a
one-block recording (engine/fused.py).

Stream state: (block index, int64 phase (C,), started flag), the JAX
package's (idx, phase, started) with the int32 phase widened
(convert.replay_state).  The port runs one block per launch where the
JAX kernels take K; the two classes keep the JAX sub-path names and each
counts its own launches.  ``ReplayDDCT`` (at most 8 channels, config 1)
runs the kernel with one thread per output row; the TPU form's
pre-tiled transposed recording with baked halo columns, its rep8
rotation rows and its ramp applied after the kernel are MXU / lane
artifacts and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ddc as ddc_ops
from .cplx import advance_phase
from .ddc import DirectDDCConfig
from .presum import recording_rows


class ReplayDDC:
    """DDC+FIR of a looped recording, one block per step, lanes over
    channels (the JAX row-major kernel, C > 8).  ``step`` is the wrapper:
    the kernel for a recording on a CUDA device, the plain version for
    one on the CPU."""

    path_name = "replay_kernel"
    row_mode = False
    launches = 0

    @classmethod
    def plan_tiles(cls, cfg: DirectDDCConfig, n: int, L: int):
        """(nbr, nblk) when the kernel takes this recording of n samples
        in blocks of L, else None: a decimating FIR (f >= 2), whole rows
        and blocks.  The JAX kernel also needs f-1 <= 8 and an 8-aligned
        row tile dividing nbr; this kernel masks its last tile."""
        M, f = cfg.M, cfg.f
        if not (f >= 2 and L % M == 0 and n % L == 0 and n > 0):
            return None
        return L // M, n // L

    def __init__(self, cfg: DirectDDCConfig, data, block_len: int, device):
        """data: the recording, numpy or a complex64 tensor (an uploaded
        tensor on `device` is used as it is)."""
        plan = self.plan_tiles(cfg, len(data), int(block_len))
        if plan is None:
            raise ValueError(f"{type(self).__name__}: recording of "
                             f"{len(data)} samples, block {block_len} does "
                             "not tile")
        self.cfg, self.L, self.device = cfg, int(block_len), device
        self.nbr, self.nblk = plan
        rec = data if isinstance(data, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(data, dtype=np.complex64))
        self.X = rec.reshape(self.nblk * self.nbr, cfg.M).to(device)
        self._hmod = cfg.modulated_taps(device)
        self._ramp = cfg.carrier_ramp(self.nbr, device)
        self._dstep = ddc_ops.ddc_carrier_step(cfg, self.L, device)

    def init_state(self):
        return (0, ddc_ops.ddc_carrier_init(self.cfg, self.device), 0)

    def _block_rots_and_advance(self, state):
        """The block to demodulate, its history flag (valid except on the
        stream's very first block), the phase of its output rotation,
        and the advanced state: (idx, val, phase, state')."""
        idx, dph, started = state
        new_dph = advance_phase(dph, self._dstep, self.cfg.rate)
        return (idx, int(bool(started)), dph,
                ((idx + 1) % self.nblk, new_dph, 1))

    def _plain(self, idx: int, val: int, dph: torch.Tensor):
        cfg = self.cfg
        E = recording_rows(self.X, idx, self.nbr, cfg.f - 1, val)
        return ddc_ops.ddc_rows_plain(self._hmod, self._ramp, dph, cfg.rate,
                                      cfg.M, cfg.f, E)

    def block_plain(self, state) -> torch.Tensor:
        """The plain PyTorch version of `state`'s block: (nbr, C)."""
        return self._plain(*self._block_rots_and_advance(state)[:3])

    def step(self, state):
        """One block: (state', y (nbr, C)).  Counts kernel launches in
        the class's ``launches``."""
        idx, val, dph, new_state = self._block_rots_and_advance(state)
        if self.X.device.type == "cpu":
            return new_state, self._plain(idx, val, dph)
        cfg = self.cfg
        y = ddc_ops.launch_ddc(self.X, None, self._hmod, self._ramp, dph,
                               cfg.rate, cfg.M, cfg.f, self.nbr,
                               self.row_mode, base=idx * self.nbr, valid=val)
        type(self).launches += 1
        return new_state, y


class ReplayDDCT(ReplayDDC):
    """The few-channel (C <= 8) form: the same function and state, one
    kernel thread per output row (the JAX channel-major kernel)."""

    path_name = "replay_kernel_t"
    row_mode = True
    launches = 0

    @classmethod
    def plan_tiles(cls, cfg: DirectDDCConfig, n: int, L: int):
        if not ddc_ops.few_channels(cfg.n_channels):
            return None
        return super().plan_tiles(cfg, n, L)


def make_replay_ddc(cfg: DirectDDCConfig, data, block_len: int, device):
    """The replay for this recording, as replay_ddc_kind names it, or
    None when no kernel takes it."""
    kind = replay_ddc_kind(cfg, len(data), block_len)
    if kind is None:
        return None
    cls = ReplayDDCT if kind == ReplayDDCT.path_name else ReplayDDC
    return cls(cfg, data, block_len, device)


def replay_ddc_kind(cfg: DirectDDCConfig, n: int, L: int):
    """'replay_kernel_t' (C <= 8), 'replay_kernel', or None."""
    if ReplayDDCT.plan_tiles(cfg, n, L):
        return ReplayDDCT.path_name
    if ReplayDDC.plan_tiles(cfg, n, L):
        return ReplayDDC.path_name
    return None
