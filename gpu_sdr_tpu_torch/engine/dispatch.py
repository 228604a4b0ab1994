"""The measurement dispatch table, as code (port of
gpu_sdr_tpu/engine/dispatch.py).

``plan_dispatch(params, ...)`` returns one :class:`Decision` per active
RX antenna naming the top-level path ``run_measurement`` takes, the
chain or kernel sub-path inside it and the deciding predicate, without
running anything.  Every sub-path comes from the builders' own plan
helpers, the functions their constructors call:
engine/fused.plan_fused_path (FusedLoopback), engine/replay.replay_path
(DeviceReplay), parallel/fused_sharded.plan_sharded_channelizer_loopback,
plan_sharded_chirp_table and plan_sharded_fold (the sharded chains) and
parallel/sharded_replay.sharded_replay_path (ShardedDeviceReplay).  No
ladder is written twice, so the plan cannot drift from the code;
tests/test_torch_dispatch.py holds it against ``measure.LAST_DISPATCH``
across a battery that reaches every (path, sub-path) of ``PATHS``.

The JAX package's ladders test its Pallas switch, its TF32 gate, lane
padding and TPU row tiles; the port's builders have none of those
(ROADMAP Queue 3), so where the two plans differ, each follows its own
builders.  Sub-paths the port cannot reach (``fold_chain``, and
``g_chain``, which only ``ShardedFusedDirect(use_fold=False)`` builds)
have no entry here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..measure import _is_mixed, _pair_tx, _replays_whole_blocks
from ..params import AntMode, UsrpParams, WaveType
from .demodulator import _mesh_plan
from .dual import plan_dual
from .fused import can_fuse, plan_fused_path
from .planner import plan_blocks
from .replay import can_device_replay, can_segmented_replay, replay_path

# top-level paths
DUAL_FUSED = "dual_fused"
DUAL_SHARDED = "dual_sharded_fused"
FUSED_LOOPBACK = "fused_loopback"
SHARDED_FUSED = "sharded_fused"
SHARDED_REPLAY = "sharded_replay"
SHARDED_SEGMENTED = "sharded_segmented_replay"
DEVICE_REPLAY = "device_replay"
SEGMENTED_REPLAY = "segmented_replay"
HOST_PIPELINE = "host_pipeline"
HOST_MIXED = "host_pipeline_mixed"

# the sub-paths the port's builders can take under each path
FUSED_SUBPATHS = ("replay_kernel_t", "replay_kernel", "fold_kernel",
                  "chirp_wavetable", "channelizer_wavetable", "generic_scan")
SHARDED_FUSED_SUBPATHS = ("channelizer_wavetable", "pfb_scan",
                          "fold_kernel", "chirp_table", "chirp_lockin")
DEVICE_REPLAY_SUBPATHS = ("replay_kernel_t", "replay_kernel",
                          "channelizer_at", "pfb_at", "chirp_table",
                          "chirp_at", "scan")
SHARDED_REPLAY_SUBPATHS = ("replay_kernel", "channelizer_at", "scan")
PATHS = {
    DUAL_FUSED: FUSED_SUBPATHS,
    DUAL_SHARDED: SHARDED_FUSED_SUBPATHS,
    FUSED_LOOPBACK: FUSED_SUBPATHS,
    SHARDED_FUSED: SHARDED_FUSED_SUBPATHS,
    SHARDED_REPLAY: SHARDED_REPLAY_SUBPATHS,
    SHARDED_SEGMENTED: (None,),
    DEVICE_REPLAY: DEVICE_REPLAY_SUBPATHS,
    SEGMENTED_REPLAY: (None,),
    HOST_PIPELINE: (None,),
    HOST_MIXED: (None,),
}

_FUSED_WHY = {
    "replay_kernel_t": "periodic comb == looped one-block recording, "
                       "few-channel replay kernel",
    "replay_kernel": "periodic comb == looped one-block recording",
    "fold_kernel": "shift-fold algebra, fold kernel",
    "chirp_wavetable": "one-period chirp table fits the device",
    "channelizer_wavetable": "bin-quantized comb, fused channelizer",
    "generic_scan": "no fused chain for this pair: generator + "
                    "demodulator",
}
_SHARDED_WHY = {
    "channelizer_wavetable": "bin-quantized comb on a time-only mesh, the "
                             "channelizer kernel per shard",
    "pfb_scan": "TX comb per shard, ShardedPFB step",
    "fold_kernel": "shift-fold kernel per shard",
    "chirp_table": "one-period table per shard's device, self-mode "
                   "lock-in",
    "chirp_lockin": "chirp synthesised and mixed per shard",
}


@dataclasses.dataclass
class Decision:
    rx_name: str
    path: str                      # top-level execution path
    subpath: Optional[str] = None  # chain / kernel variant inside it
    reason: str = ""               # the deciding predicate, for humans

    def key(self):
        return (self.rx_name, self.path, self.subpath)


def declared() -> set:
    """Every (path, sub-path) run_measurement can take."""
    return {(p, s) for p, subs in PATHS.items() for s in subs}


def classify_loopback_chain(tx, rx):
    """(sub-path, why) of the chain FusedLoopback runs for this pair:
    engine/fused.plan_fused_path, the function FusedLoopback calls."""
    sub = plan_fused_path(tx, rx, plan_blocks(rx).block_len)
    return sub, _FUSED_WHY[sub]


def classify_sharded_fused(tx, rx, mesh):
    """(sub-path, why) of the chain make_sharded_fused builds for a pair
    can_fuse_sharded takes, through the builders' gates; (None, why)
    where it builds none (the host pipeline runs)."""
    from ..parallel.fused_sharded import (plan_sharded_block,
                                          plan_sharded_channelizer_loopback,
                                          plan_sharded_chirp_table,
                                          plan_sharded_fold)
    L, _nb = plan_sharded_block(rx, mesh)
    w = rx.wave_type[0]
    if w == WaveType.CHIRP:
        sub = ("chirp_table" if plan_sharded_chirp_table(tx, rx, mesh, L)
               else "chirp_lockin")
    elif w == WaveType.DIRECT:
        if not plan_sharded_fold(tx, rx, mesh, L):
            return None, "fold untileable on this mesh"
        sub = "fold_kernel"
    else:
        sub = ("channelizer_wavetable"
               if plan_sharded_channelizer_loopback(tx, rx, mesh, L)
               else "pfb_scan")
    return sub, _SHARDED_WHY[sub]


def classify_device_replay(rx, n: int, loop: bool):
    """(sub-path, why) of the form DeviceReplay runs for an n-sample
    recording: engine/replay.replay_path, the function it calls."""
    sub = replay_path(rx, n, plan_blocks(rx).block_len, loop)
    return sub, ("generic scan over the resident recording" if sub == "scan"
                 else "looped recording of whole blocks, in-place kernel")


def classify_sharded_replay(rx, n: int, loop: bool, mesh):
    """(sub-path, why) of ShardedDeviceReplay: parallel/sharded_replay.
    sharded_replay_path, the function it calls."""
    from ..parallel.sharded_replay import sharded_replay_path
    L = _mesh_plan(plan_blocks(rx), mesh).block_len
    sub = sharded_replay_path(rx, n, L, loop, mesh)
    return sub, ("sharded demodulator over the resident spans"
                 if sub == "scan" else "kernel per time shard, staged halo")


def _plan_dual(params, mesh, warn) -> List[Decision]:
    """The lock-step decisions, or [] where run_measurement streams the
    front ends in turn."""
    pairs = plan_dual(params, mesh=mesh, warn=warn)
    if pairs is None:
        return []
    why = ">=2 fusable frontends, common block plan"
    if mesh is None:
        return [Decision(name, DUAL_FUSED, classify_loopback_chain(tx, rx)[0],
                         why) for name, tx, rx in pairs]
    subs = [classify_sharded_fused(tx, rx, mesh)[0] for _n, tx, rx in pairs]
    if None in subs:                 # DualShardedFused.ok is False
        return []
    return [Decision(name, DUAL_SHARDED, sub, why)
            for (name, _tx, _rx), sub in zip(pairs, subs)]


def _plan_source(rx_name, rx, source, mesh) -> Optional[Decision]:
    """A recording replayed from device memory, or None."""
    if not _replays_whole_blocks(source, rx, mesh):
        return None
    loop = bool(getattr(source, "loop", False))
    n = len(source.data)
    if can_device_replay(source):
        if mesh is None:
            sub, why = classify_device_replay(rx, n, loop)
            return Decision(rx_name, DEVICE_REPLAY, sub, why)
        sub, why = classify_sharded_replay(rx, n, loop, mesh)
        return Decision(rx_name, SHARDED_REPLAY, sub, why)
    assert can_segmented_replay(source)
    if mesh is None:
        return Decision(rx_name, SEGMENTED_REPLAY, None,
                        "recording exceeds the device budget: "
                        "double-buffered segment refill")
    return Decision(rx_name, SHARDED_SEGMENTED, None,
                    "recording exceeds the device budget, mesh given: "
                    "sharded segment refill")


def plan_dispatch(params: UsrpParams, source=None, channel=None,
                  mesh=None, warn: bool = True) -> List[Decision]:
    """Predict run_measurement's routing without running anything, in
    its decision order; with `warn` False, without plan_dual's warning
    of front ends streamed in turn."""
    if source is None and channel is None:
        decisions = _plan_dual(params, mesh, warn)
        if decisions:
            return decisions
    decisions = []
    for rx_name, rx in params.active_antennas(AntMode.RX):
        if _is_mixed(rx):
            decisions.append(Decision(rx_name, HOST_MIXED, None,
                                      "mixed wave types on one antenna"))
            continue
        tx_name = _pair_tx(params, rx_name)
        tx = params.antenna(tx_name) if tx_name else None
        if source is None and channel is None and tx is not None and \
                rx.delay <= tx.delay:
            if mesh is None and can_fuse(tx, rx):
                sub, why = classify_loopback_chain(tx, rx)
                decisions.append(Decision(rx_name, FUSED_LOOPBACK, sub, why))
                continue
            if mesh is not None:
                from ..parallel.fused_sharded import can_fuse_sharded
                if can_fuse_sharded(tx, rx, mesh):
                    sub, why = classify_sharded_fused(tx, rx, mesh)
                    if sub is not None:
                        decisions.append(Decision(rx_name, SHARDED_FUSED,
                                                  sub, why))
                        continue
        if source is not None and channel is None:
            d = _plan_source(rx_name, rx, source, mesh)
            if d is not None:
                decisions.append(d)
                continue
        decisions.append(Decision(rx_name, HOST_PIPELINE, None,
                                  "no fused or replay path applies"))
    return decisions
