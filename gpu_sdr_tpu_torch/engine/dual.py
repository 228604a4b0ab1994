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
import time
from typing import List, Optional, Sequence, Tuple

from ..config import resolve_device
from ..params import AntennaParams, AntMode
from .fused import FusedLoopback, can_fuse
from .pipeline import PipelineResult, _finish, _HostFetch, _start
from .planner import plan_blocks
from .sinks import PacketMeta, Sink

log = logging.getLogger("gpu_sdr_tpu_torch.dual")


def _run_lockstep(step_all, init_states, n_blocks: int, block_len: int,
                  channels_per_fe: Sequence[int],
                  rows_total_per_fe: Sequence[int],
                  front_ends: Sequence[str],
                  sinks_per_fe: Sequence[Sequence[Sink]],
                  usrp_number: int, device) -> List[PipelineResult]:
    """Shared lock-step acquisition loop: each step advances ALL
    frontends by one block, then the previous step's outputs drain to
    the sinks (the one-in-flight overlap of pipeline.run_chunked, through
    the same _HostFetch).  The states are built before the sinks start:
    they are set-up."""
    n_fe = len(front_ends)
    states = _start(init_states, device, sinks_per_fe,
                    list(zip(channels_per_fe, rows_total_per_fe)))
    fetch = _HostFetch(device)
    pkts = [0] * n_fe
    rows = [0] * n_fe
    t0 = time.perf_counter()

    def drain(pending):
        for i, p in enumerate(pending):
            d = fetch.result(p)
            meta = PacketMeta(usrp_number=usrp_number,
                              front_end_code=front_ends[i],
                              packet_number=pkts[i], length=int(d.size),
                              errors=0, channels=int(d.shape[1]))
            for s in sinks_per_fe[i]:
                s.on_packet(meta, d)
            rows[i] += d.shape[0]
            pkts[i] += 1

    pending = None
    for _ in range(n_blocks):
        states, outs = step_all(states)
        nxt = [fetch.start(y) for y in outs]
        if pending is not None:
            drain(pending)
        pending = nxt
    if pending is not None:
        drain(pending)
    elapsed = time.perf_counter() - t0
    _finish(sinks_per_fe, device)
    return [PipelineResult(n_blocks=pkts[i], rows=rows[i],
                           channels=channels_per_fe[i], elapsed_s=elapsed,
                           samples_in=pkts[i] * block_len)
            for i in range(n_fe)]


def _step_all(chains):
    """(states) -> (states', outputs): every chain one block, in order."""
    def step_all(states):
        new_states, outs = [], []
        for ch, st in zip(chains, states):
            st, y = ch.step(st)
            new_states.append(st)
            outs.append(y)
        return new_states, outs
    return step_all


class DualFused:
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
        self.step = _step_all(self.chains)

    def init_state(self) -> list:
        """One state per chain (engine/checkpoint saves it as it is)."""
        return [ch.init_state() for ch in self.chains]

    def run(self, sinks_per_fe: Sequence[Sequence[Sink]],
            usrp_number: int = 0) -> List[PipelineResult]:
        """Stream every acquisition; sinks_per_fe[i] receives frontend
        i's packets."""
        plan = self.chains[0].demod.plan
        return _run_lockstep(
            self.step, self.init_state, plan.n_blocks, plan.block_len,
            [ch.demod.n_channels for ch in self.chains],
            [ch.demod.plan.total_out_rows for ch in self.chains],
            self.front_ends, sinks_per_fe, usrp_number, self.device)


class DualShardedFused:
    """Two (or more) SHARDED fused chains advanced in lock-step over the
    mesh, one block each per step — the multi-device form of DualFused.
    ``.ok`` is False when the frontends cannot share a mesh block plan,
    or a chain does not tile: the caller streams sequentially."""

    def __init__(self, pairs: Sequence[Tuple[str, AntennaParams,
                                             AntennaParams]], mesh):
        from ..parallel.fused_sharded import (make_sharded_fused,
                                              plan_sharded_block)
        assert len(pairs) >= 2
        self.mesh = mesh
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
        self.step = _step_all(self.chains)

    def init_state(self) -> list:
        return [ch.init_state() for ch in self.chains]

    def run(self, sinks_per_fe: Sequence[Sequence[Sink]],
            usrp_number: int = 0) -> List[PipelineResult]:
        """As DualFused.run; each step's Sharded outputs are gathered
        onto the mesh's first device by the fetch."""
        nb = self.n_blocks
        return _run_lockstep(
            self.step, self.init_state, nb, self.block_len,
            [ch.n_tones for ch in self.chains],
            [ch.T * ch.ft * nb for ch in self.chains],
            self.front_ends, sinks_per_fe, usrp_number, self.mesh.first)


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
    from ..measure import _pair_tx
    rxs = list(params.active_antennas(AntMode.RX))
    if len(rxs) < 2:
        return None
    if mesh is not None:
        from ..parallel.fused_sharded import (can_fuse_sharded,
                                              plan_sharded_block)
    pairs = []
    plan0 = None
    for rx_name, rx in rxs:
        if rx.wave_type and any(w != rx.wave_type[0]
                                for w in rx.wave_type):
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
