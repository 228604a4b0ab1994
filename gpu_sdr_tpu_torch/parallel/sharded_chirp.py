"""Sharded chirp demodulation + lock-in over a time mesh (port of
gpu_sdr_tpu/parallel/sharded_chirp.py).

The mix-down is elementwise and the lock-in segment-local, so time
sharding needs no halo: shard t demodulates its segment from the stream
position advanced by t*Lt (exact mod-period integer arithmetic) and
reduces its own whole lock-in segments (the plan keeps Lt a multiple of
ppt).  The channel axis is unused: one chirp channel, as the reference
(cpp/USRP_demodulator.cpp:31-34).
"""

from __future__ import annotations

import torch

from ..ops import chirp as chirp_ops
from ..ops.chirp import ChirpConfig
from ..ops.lockin import lockin_decimate, lockin_profile
from .mesh import Mesh, Sharded, shard_input


class ShardedChirpLockin:
    """Time-sharded chirp demodulation + lock-in.  State: the stream
    position, a Python int (the JAX package's uint32 (1,) `last`)."""

    def __init__(self, cfg: ChirpConfig, mesh: Mesh, block_len: int,
                 ppt: int):
        self.cfg, self.mesh = cfg, mesh
        self.block_len, self.ppt = int(block_len), int(ppt)
        self.T = mesh.T
        if self.block_len % (self.T * self.ppt):
            raise ValueError("sharded chirp: the block must split into "
                             "whole lock-in segments per time shard")
        self.Lt = self.block_len // self.T
        self.nseg_t = self.Lt // self.ppt
        # shard t starts at sample t*Lt of the block
        self.shard_off = [(t * self.Lt) % cfg.period for t in range(self.T)]
        prof = torch.from_numpy(lockin_profile(self.ppt))
        self._profile = [prof.to(mesh.device(t, 0)) for t in range(self.T)]

    def init_state(self):
        return 0

    def step(self, last, x):
        """One block: (last', Sharded (L/ppt, 1))."""
        xs = shard_input(self.mesh, x)
        ys = []
        for t in range(self.T):
            base = chirp_ops.advance(self.cfg, last, self.shard_off[t])
            _, z = chirp_ops.chirp_demod_block(self.cfg, base, xs[t][0])
            ys.append([lockin_decimate(self._profile[t], z)[:, None]])
        return chirp_ops.advance(self.cfg, last, self.block_len), Sharded(ys)
