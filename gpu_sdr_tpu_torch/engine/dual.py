"""Concurrent, time-aligned dual-frontend execution (port of
gpu_sdr_tpu/engine/dual.py).

The reference runs the A and B frontends as simultaneous thread chains on
one device timebase (TXRX::start spawns both workers against the same
set_time_unknown_pps clock, cpp/USRP_server_link_threads.cpp:249-397), so
dual measurements (correlated noise, Dual_VNA, beam mapping) sample the
same instants on both channels.

Here every frontend's fused chain advances by one block per step, the
chains' launches queued back to back on the device's current stream:
packet k of A and packet k of B cover exactly the same sample index
range [k*L, (k+1)*L) by construction.  Under a mesh the same holds for
the sharded chains (DualShardedFused).  The JAX package runs K blocks of
every chain inside one jitted program per execution (``blocks_per_exec``);
PyTorch runs eagerly, so that has no counterpart (ROADMAP Queue 3).  The
sequential path (one frontend after the other) is taken where the
frontends cannot run in lock-step, and plan_dual WARNS that the
reference's lock-step timing semantics are degraded.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

from ..config import resolve_device
from ..params import AntennaParams, AntMode
from .fused import FusedLoopback, can_fuse
from .pipeline import PipelineResult, _loop
from .planner import _is_mixed, _pair_tx, plan_blocks
from .sinks import Sink

log = logging.getLogger("gpu_sdr_tpu_torch.dual")


class _LockStep:
    """Chains advanced in lock-step, one block each per step, through
    the pipeline's one loop (pipeline._loop at depth 1, one output a
    front end, coded with its full antenna name).  The states are built
    before the sinks start: they are set-up."""

    def init_state(self) -> list:
        """One state per chain (engine/checkpoint saves it as it is)."""
        return [ch.init_state() for ch in self.chains]

    def step(self, states):
        """(states) -> (states', outputs): every chain one block, in
        order."""
        new_states, outs = [], []
        for ch, st in zip(self.chains, states):
            st, y = ch.step(st)
            new_states.append(st)
            outs.append(y)
        return new_states, outs

    def run(self, sinks_per_fe: Sequence[Sequence[Sink]],
            usrp_number: int = 0) -> List[PipelineResult]:
        """Stream every acquisition; sinks_per_fe[i] receives front end
        i's packets."""
        return _loop(lambda states, _x: self.step(states), self.init_state,
                     self.device,
                     list(zip(sinks_per_fe, self.front_ends, self.starts)),
                     self.n_blocks, self.block_len, usrp_number)


class DualFused(_LockStep):
    """Two (or more) fused loopback chains advanced in lock-step, one
    block each per step, on one device."""

    def __init__(self, pairs: Sequence[Tuple[str, AntennaParams,
                                             AntennaParams]],
                 device="cuda"):
        assert len(pairs) >= 2
        self.rx_names = [name for name, _tx, _rx in pairs]
        # wire code = the FULL antenna name (A_TXRX/A_RX2/B_TXRX/B_RX2):
        # collapsing to the frontend letter would make e.g. a dual
        # measurement on A_TXRX + A_RX2 indistinguishable on the wire
        self.front_ends = list(self.rx_names)
        self.device = resolve_device(device)
        self.chains = [FusedLoopback(tx, rx, device=self.device)
                       for _fe, tx, rx in pairs]
        p0 = self.chains[0].demod.plan
        for ch in self.chains[1:]:
            p = ch.demod.plan
            assert (p.block_len == p0.block_len and
                    p.n_blocks == p0.n_blocks), \
                "lock-step chains need a common block plan"
        self.block_len, self.n_blocks = p0.block_len, p0.n_blocks
        self.starts = [(ch.demod.n_channels, ch.demod.plan.total_out_rows)
                       for ch in self.chains]


class DualShardedFused(_LockStep):
    """Two (or more) SHARDED fused chains advanced in lock-step over the
    mesh, one block each per step — the multi-device form of DualFused;
    each step's Sharded outputs are gathered onto the mesh's first
    device by the fetch.  ``.ok`` is False when the frontends cannot
    share a mesh block plan, or a chain does not tile: the caller
    streams sequentially."""

    def __init__(self, pairs: Sequence[Tuple[str, AntennaParams,
                                             AntennaParams]], mesh):
        from ..parallel.fused_sharded import (make_sharded_fused,
                                              plan_sharded_block)
        assert len(pairs) >= 2
        self.mesh, self.device = mesh, mesh.first
        self.rx_names = [name for name, _tx, _rx in pairs]
        self.front_ends = list(self.rx_names)
        plans = [plan_sharded_block(rx, mesh) for _n, _tx, rx in pairs]
        self.ok = all(p == plans[0] for p in plans[1:])
        if not self.ok:
            return
        self.block_len, self.n_blocks = plans[0]
        self.chains = []
        for _n, tx, rx in pairs:
            ch = make_sharded_fused(tx, rx, mesh, block_len=self.block_len)
            if ch is None:         # untileable geometry
                self.ok = False
                return
            self.chains.append(ch)
        self.starts = [(ch.n_tones, ch.T * ch.ft * self.n_blocks)
                       for ch in self.chains]


def _sequential(reason: str, warn: bool = True):
    """The dual plan falls back to one-frontend-after-the-other: warn
    that the reference's lock-step timing semantics are degraded
    (reference runs A/B simultaneously,
    cpp/USRP_server_link_threads.cpp:249-397)."""
    if warn:
        log.warning(
            "dual frontends will stream SEQUENTIALLY (%s): packets of A "
            "and B no longer cover the same sample instants", reason)
    return None


def plan_dual(params, mesh=None, warn: bool = True
              ) -> Optional[List[Tuple[str, AntennaParams, AntennaParams]]]:
    """If the measurement is a multi-frontend fused loopback (>= 2 active
    RX, each with a fusable paired TX, common block plan), return the
    lock-step (rx_name, tx, rx) pairs; else None (sequential path, with a
    warning unless `warn` is False).  With a mesh, fusability is judged
    against the sharded chains (can_fuse_sharded) and the mesh block
    planner."""
    rxs = list(params.active_antennas(AntMode.RX))
    if len(rxs) < 2:
        return None
    if mesh is not None:
        from ..parallel.fused_sharded import (can_fuse_sharded,
                                              plan_sharded_block)
    pairs = []
    plan0 = None
    for rx_name, rx in rxs:
        if _is_mixed(rx):
            return _sequential(f"{rx_name} is mixed-mode", warn)
        tx_name = _pair_tx(params, rx_name)
        tx = params.antenna(tx_name) if tx_name else None
        if tx is None:
            return _sequential(f"{rx_name} has no paired TX", warn)
        fusable = (can_fuse_sharded(tx, rx, mesh) if mesh is not None
                   else can_fuse(tx, rx))
        if not fusable:
            return _sequential(f"{rx_name} mode pair is not fusable", warn)
        if rx.delay > tx.delay:
            return _sequential(f"{rx_name} rx.delay > tx.delay", warn)
        p = (plan_sharded_block(rx, mesh) if mesh is not None
             else (plan_blocks(rx).block_len, plan_blocks(rx).n_blocks))
        if plan0 is None:
            plan0 = p
        elif p != plan0:
            return _sequential("unmatched block plans across frontends", warn)
        pairs.append((rx_name, tx, rx))
    return pairs
