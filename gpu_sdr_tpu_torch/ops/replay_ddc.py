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
runs the kernel in row mode (ops/ddc.row_plan); the TPU form's
pre-tiled transposed recording with baked halo columns, its rep8
rotation rows and its ramp applied after the kernel are MXU / lane
artifacts and are not ported.  ``ShardedReplayDDC`` (kernel #10) is the
time-sharded form: each shard's span in place after a staged history
(csrc/ddc.cu ``sdr_ddc_staged``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from . import ddc as ddc_ops
from .cplx import advance_phase
from .ddc import DirectDDCConfig
from .presum import recording_rows, shard_spans, staged_halos


class ReplayDDC:
    """DDC+FIR of a looped recording, one block per step, lanes over
    channels (the JAX row-major kernel, C > 8).  ``step`` is the wrapper:
    the kernel for a recording on a CUDA device, the plain version for
    one on the CPU."""

    path_name = "replay_kernel"
    row_mode = False
    graph_groups = True     # engine/replay._GraphGroups may replay K steps
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
    """The few-channel (C <= 8) form: the same function and state, the
    kernel in row mode (the JAX channel-major kernel)."""

    path_name = "replay_kernel_t"
    row_mode = True
    launches = 0

    @classmethod
    def plan_tiles(cls, cfg: DirectDDCConfig, n: int, L: int):
        if not ddc_ops.few_channels(cfg.n_channels):
            return None
        return super().plan_tiles(cfg, n, L)


class ShardedReplayDDC:
    """The replay DDC's time-sharded form (kernel #10, gpu_sdr_tpu/ops/
    pallas_replay.ShardedReplayDDC): the recording is laid out per time
    shard (shard t's span of every block, ops/presum.shard_spans); each
    shard's block reads its nbr/T rows in place and its f-1 history rows
    from a staged per-(shard, block) array (ops/presum.staged_halos:
    the recording is static, so the rows that lie on the previous shard
    or in the previous block are copied once at upload, and no
    collective runs per block).  The stream state is the single-device
    ReplayDDC's (block index, int64 phase, started flag): the phase
    advances per global block.  ``val`` is honoured on shard 0 only, the
    shard that owns the stream's first row; the others' history is
    always the stream's.

    ``local(state, t)`` is one shard's block: the kernel for a span on a
    CUDA device, the plain version (``local_plain``) for one on the CPU;
    the class counts kernel launches in ``launches``."""

    path_name = "replay_kernel"
    launches = 0

    @classmethod
    def plan_tiles(cls, cfg: DirectDDCConfig, n: int, L: int, T: int):
        """(nbr, nbr_t, nblk) when the kernel takes this recording of n
        samples in blocks of L over T time shards: a decimating FIR
        (f >= 2), whole rows, blocks, and rows per shard.  The JAX gate's
        f-1 <= 8, 8-row halo units and row tile have no counterpart."""
        M, f = cfg.M, cfg.f
        if not (f >= 2 and L % M == 0 and n % L == 0 and n > 0):
            return None
        nbr, nblk = L // M, n // L
        if nbr % T:
            return None
        return nbr, nbr // T, nblk

    def __init__(self, cfg: DirectDDCConfig, X: torch.Tensor, block_len: int,
                 devices):
        """X: the recording as a complex64 tensor (n,); devices: each
        time shard's device, None for a shard of another process (its
        span is not uploaded and its block not computed here)."""
        T = len(devices)
        plan = self.plan_tiles(cfg, len(X), int(block_len), T)
        if plan is None:
            raise ValueError(f"ShardedReplayDDC: recording of {len(X)} "
                             f"samples, block {block_len}, {T} shards does "
                             "not tile")
        self.cfg, self.L, self.T = cfg, int(block_len), T
        self.nbr, self.nbr_t, self.nblk = plan
        rows = X.reshape(-1, cfg.M)
        spans = shard_spans(rows, self.nblk, T)
        halos = staged_halos(rows, self.nblk, T, cfg.f - 1)
        cpu = torch.device("cpu")
        ramp = cfg.carrier_ramp(self.nbr, cpu)
        hmod = cfg.modulated_taps(cpu)
        nt = self.nbr_t
        self.devices = list(devices)

        def put(parts):
            return [None if d is None else p.to(d)
                    for p, d in zip(parts, devices)]

        self.X, self.H = put(spans), put(halos)
        self._ramp = put([ramp[t * nt:(t + 1) * nt] for t in range(T)])
        self._hmod = put([hmod] * T)
        self.device = next(d for d in self.devices if d is not None)
        self._dstep = ddc_ops.ddc_carrier_step(cfg, self.L, self.device)

    def init_state(self):
        return (0, ddc_ops.ddc_carrier_init(self.cfg, self.device), 0)

    def advance(self, state):
        """The state one block on: the next block, its phase, started."""
        idx, dph, _ = state
        return ((idx + 1) % self.nblk,
                advance_phase(dph, self._dstep, self.cfg.rate), 1)

    @staticmethod
    def _val(t: int, started) -> int:
        """Shard t's history flag: the stream's start is shard 0's."""
        return int(bool(started)) if t == 0 else 1

    def local_plain(self, state, t: int) -> torch.Tensor:
        """The plain PyTorch version of shard t's block: (nbr/T, C)."""
        idx, dph, started = state
        cfg, nt = self.cfg, self.nbr_t
        halo = self.H[t][idx] if self._val(t, started) else \
            torch.zeros_like(self.H[t][idx])
        E = torch.cat([halo, self.X[t][idx * nt:(idx + 1) * nt]])
        return ddc_ops.ddc_rows_plain(self._hmod[t], self._ramp[t],
                                      dph.to(self.devices[t]), cfg.rate,
                                      cfg.M, cfg.f, E)

    def local(self, state, t: int) -> torch.Tensor:
        """Shard t's block of `state`'s block index: (nbr/T, C)."""
        if self.X[t].device.type == "cpu":
            return self.local_plain(state, t)
        idx, dph, started = state
        cfg = self.cfg
        hmod, ramp = self._hmod[t], self._ramp[t]
        dph = dph.to(self.devices[t])
        ddc_ops._check(hmod, ramp, dph, cfg.M, cfg.f, self.nbr_t)
        X, Hs = self.X[t], self.H[t]
        if X.device.type != "cuda":
            raise ValueError(f"sharded replay DDC: unsupported device "
                             f"{X.device}")
        C = hmod.shape[1]
        out = torch.empty((self.nbr_t, C), dtype=torch.complex64,
                          device=X.device)
        build.launch("sdr_ddc_staged", X.device, X.data_ptr(), Hs.data_ptr(),
                     hmod.data_ptr(), ramp.data_ptr(), dph.data_ptr(),
                     out.data_ptr(), X.shape[0], idx, self.nbr_t, cfg.M, cfg.f,
                     C, self._val(t, started),
                     float(np.float32(2.0 * np.pi / cfg.rate)),
                     int(ddc_ops.few_channels(C)))
        type(self).launches += 1
        return out

    def step(self, state):
        """One block: (state', [shard t's (nbr/T, C)] per time shard,
        None for another process's)."""
        ys = [None if self.devices[t] is None else self.local(state, t)
              for t in range(self.T)]
        return self.advance(state), ys


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
