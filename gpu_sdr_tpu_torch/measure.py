"""In-process measurement execution (port of gpu_sdr_tpu/measure.py).

Given a validated UsrpParams, build TX generators and RX demodulators
and route TX -> channel -> RX on one device.  First, with no source and
no channel model, two or more RX front ends whose loopbacks fuse with
one block plan run in lock-step (``dual_fused``, engine/dual.DualFused;
``dual_sharded_fused`` under a mesh).  Otherwise each RX takes its own
branch in turn, in the JAX package's order:

* ``fused_loopback``: ideal loopback with no channel model, the whole
  chain on the device (engine/fused.py);
* ``device_replay``: a recording (``source=ReplaySource / ArraySource``)
  within the device budget, with no channel model: uploaded once and
  demodulated from device memory (engine/replay.DeviceReplay; the
  dispatch's subpath names its sub-path);
* ``segmented_replay``: such a recording over the budget, staged to the
  device segment by segment (engine/replay.SegmentedDeviceReplay);
* ``host_pipeline``: a generator (or white noise) on the host through a
  channel model, or any other source (a looped recording that is not
  whole blocks among them), fed block by block to the demodulator;
* ``host_pipeline_mixed``: an antenna of mixed wave types, always, one
  demodulator a wave type over the same host-fed stream
  (engine/pipeline.run_pipeline_mixed).

With ``mesh`` (parallel.mesh.Mesh, one process driving every shard) the
mesh branches replace the first three, in the JAX package's order:
``sharded_fused`` (parallel/fused_sharded.py), ``sharded_replay``
(parallel/sharded_replay.ShardedDeviceReplay), ``sharded_segmented_
replay`` (ShardedSegmentedReplay), else ``host_pipeline`` with the
sharded demodulator.  The mesh names the devices; `device` is not read.

Every branch also writes the HDF5 file (client/files.H5Sink) when given
a file name, as the JAX package does.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Optional, Sequence

import numpy as np

from .config import maybe_profile, resolve_device
from .engine import (FusedLoopback, can_fuse, make_demodulator,
                     make_generator, run_pipeline)
from .engine.channel import Channel, IdealChannel
from .engine.demodulator import _mesh_plan
from .engine.dual import DualFused, DualShardedFused, plan_dual
from .engine.pipeline import run_pipeline_mixed
from .engine.planner import plan_blocks
from .engine.replay import (DeviceReplay, SegmentedDeviceReplay,
                            can_device_replay, can_segmented_replay)
from .engine.sinks import Sink
from .engine.sources import Source, WhiteNoiseSource
from .params import AntMode, UsrpParams

# the execution paths the last run_measurement call took, one
# (rx_name, path, subpath) per RX antenna, with the JAX package's key
# strings (docs/07_dispatch.md); snapshot with last_dispatch()
LAST_DISPATCH: list = []


# one record a run_measurement call, oldest first (a script's run
# report, scripts/_cli.py, writes them): ``plan``, the paths
# engine/dispatch.plan_dispatch planned, ``dispatch``, the ones taken,
# ``blocks`` and ``samples``, its RX blocks and samples (plan.block_len
# times the blocks), and on the host clock ``seconds``, the call's, and
# ``stream_seconds``, the first sink's start to the last sink's end
RUNS: collections.deque = collections.deque(maxlen=4096)


def last_dispatch() -> tuple:
    """Immutable snapshot of the paths the most recent run_measurement
    call took (one (rx_name, path, subpath) per RX)."""
    return tuple(LAST_DISPATCH)


def _record_dispatch(rx_name: str, path: str, subpath=None) -> None:
    LAST_DISPATCH.append((rx_name, path, subpath))
    logging.getLogger("gpu_sdr_tpu_torch.dispatch").info(
        "dispatch %s -> %s%s", rx_name, path,
        f":{subpath}" if subpath else "")


class ChannelSource(Source):
    """TX generator -> channel model -> RX blocks.

    `skip_samples` emulates the reference's timed RX start: the RX
    stream begins `delay` seconds after TX
    (cpp/USRP_hardware_manager.cpp:1178-1291)."""

    def __init__(self, generator, channel: Channel, skip_samples: int = 0):
        self.generator = generator
        self.channel = channel
        self.skip = int(skip_samples)

    def take_errors(self) -> int:
        """Error events injected by the channel since the last call."""
        fn = getattr(self.channel, "take_errors", None)
        return int(fn()) if fn else 0

    def blocks(self, block_len: int, n_blocks: int):
        assert block_len == self.generator.block_len
        buf = np.zeros(0, dtype=np.complex64)
        to_skip = self.skip
        extra = -(-self.skip // block_len)  # ceil: extra TX blocks needed
        emitted = 0
        for x in self.generator.blocks(n_blocks + extra):
            y = np.asarray(self.channel(x), dtype=np.complex64)
            if to_skip:
                drop = min(to_skip, len(y))
                y = y[drop:]
                to_skip -= drop
            buf = np.concatenate([buf, y]) if len(buf) else y
            while len(buf) >= block_len and emitted < n_blocks:
                yield buf[:block_len]
                buf = buf[block_len:]
                emitted += 1
            if emitted >= n_blocks:
                return
        while emitted < n_blocks:           # generator ran dry: zero-pad
            pad = np.zeros(block_len, dtype=np.complex64)
            pad[:len(buf)] = buf
            yield pad
            buf = np.zeros(0, dtype=np.complex64)
            emitted += 1


def _is_mixed(rx) -> bool:
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


def _replays_whole_blocks(source, rx, mesh=None) -> bool:
    """A recording that one of the replays takes: within the device
    budget or over it, and, when looped, a whole number of blocks (the
    host-fed source's loop semantics need it) of the plan, or of the
    mesh's plan."""
    if not (can_device_replay(source) or can_segmented_replay(source)):
        return False
    plan = plan_blocks(rx)
    if mesh is not None:
        plan = _mesh_plan(plan, mesh)
    loop = bool(getattr(source, "loop", False))
    return not (loop and len(source.data) % plan.block_len)


def run_measurement(params: UsrpParams, filename: Optional[str] = None,
                    channel: Optional[Channel] = None,
                    source: Optional[Source] = None,
                    extra_sinks: Sequence[Sink] = (),
                    trigger=None, mesh=None, device="cuda",
                    **tags) -> Optional[str]:
    """Execute a measurement described by `params` on `device`.

    With an active TX, TX drives RX through `channel`; with no channel
    model the ideal loopback runs fused on the device: every front end
    in lock-step where two or more can (engine/dual.py, packets coded
    with the full antenna name), else one after the other (coded with
    the front end's letter).  A `source` feeds RX instead: a recording
    of whole blocks (or one that is not looped) with no channel model is
    replayed from device memory.  With neither, RX consumes white noise.
    An antenna of mixed wave types streams through the host pipeline,
    one demodulator a wave type.  With `mesh` (parallel.make_mesh) the
    front ends run sharded over the mesh's devices, which replace
    `device`.

    Data goes to `extra_sinks` and, with `filename`, to an HDF5 file in
    the reference layout (client/files.H5Sink: `tags` become attributes
    of its raw_data group, `trigger` filters what is written); returns
    the file's name, else None.  A source that ends short stamps the
    antenna's group `aborted`.  With GPU_SDR_TPU_PROFILE set, the run
    is traced into that directory (config.maybe_profile).  Each call
    appends its record to RUNS."""
    from .engine.dispatch import plan_dispatch
    dev = mesh.first if mesh is not None else resolve_device(device)
    params.validate()
    plan = [list(d.key()) for d in plan_dispatch(
        params, source=source, channel=channel, mesh=mesh, warn=False)]
    plans = [plan_blocks(rx) for _, rx in params.active_antennas(AntMode.RX)]
    stamps = _Stamps()
    t0 = time.perf_counter()
    with maybe_profile("measurement", dev):
        out = _measure(params, filename, channel, source,
                       [*extra_sinks, stamps], trigger, mesh, dev, tags)
    RUNS.append(dict(
        plan=plan, dispatch=[list(k) for k in LAST_DISPATCH],
        blocks=sum(p.n_blocks for p in plans),
        samples=sum(p.total_samples for p in plans),
        seconds=time.perf_counter() - t0,
        stream_seconds=stamps.t[-1] - stamps.t[0] if stamps.t else 0.0))
    return out


class _Stamps(Sink):
    """The host clock at each sink start and end."""

    def __init__(self):
        self.t = []

    def on_start(self, n_channels, expected_rows):
        self.t.append(time.perf_counter())

    def on_packet(self, meta, data):
        pass

    def on_end(self):
        self.t.append(time.perf_counter())


def _measure(params, filename, channel, source, extra_sinks, trigger, mesh,
             dev, tags) -> Optional[str]:
    LAST_DISPATCH.clear()
    run = _Run(params, filename, trigger, tags, extra_sinks)
    # concurrent A/B front ends: >= 2 fusable RX chains advance in
    # lock-step on a shared sample timebase (engine/dual.py)
    if source is None and channel is None and _run_dual(run, mesh, dev):
        return run.out_name
    for rx_name, rx in params.active_antennas(AntMode.RX):
        tx_name = _pair_tx(params, rx_name)
        tx = params.antenna(tx_name) if tx_name else None
        mixed = _is_mixed(rx)
        run_kw = dict(usrp_number=params.usrp_number, front_end=rx_name[0])
        if mesh is None and source is None and channel is None and \
                not mixed and tx is not None and can_fuse(tx, rx) and \
                rx.delay <= tx.delay:
            fused = FusedLoopback(tx, rx, device=dev)
            _record_dispatch(rx_name, "fused_loopback", fused.path)
            fused.run(run.sinks(rx_name), **run_kw)
            continue
        if mesh is not None and not mixed and \
                _run_on_mesh(run, rx_name, tx, rx, mesh, source, channel,
                             run_kw):
            continue
        if mesh is None and source is not None and channel is None and \
                not mixed and _replays_whole_blocks(source, rx):
            loop = bool(getattr(source, "loop", False))
            if can_device_replay(source):
                replay = DeviceReplay(rx, source.data, loop=loop, device=dev)
                _record_dispatch(rx_name, "device_replay", replay.path)
            else:
                replay = SegmentedDeviceReplay(rx, source.data, loop=loop,
                                               device=dev)
                _record_dispatch(rx_name, "segmented_replay")
            replay.run(run.sinks(rx_name), **run_kw)
            continue
        demod = make_demodulator(rx, dev, mesh=mesh)
        if source is not None:
            src = source
        elif tx is not None:
            gen = make_generator(tx, demod.plan.block_len, dev)
            # timed RX start: honor the delay parameter difference
            skip = int(round(max(rx.delay - tx.delay, 0.0) * rx.rate))
            src = ChannelSource(gen, channel or IdealChannel(),
                                skip_samples=skip)
        else:
            src = WhiteNoiseSource()
        if mixed:
            # one demodulator a wave type over the same stream; group 0
            # fills `data` and takes the trigger, group k a `mixed_<k>`
            _record_dispatch(rx_name, "host_pipeline_mixed")
            run_pipeline_mixed(demod, src, [
                run.sinks(rx_name, k, g) for k, g in enumerate(demod.groups)],
                **run_kw)
        else:
            _record_dispatch(rx_name, "host_pipeline")
            run_pipeline(demod, src, run.sinks(rx_name), **run_kw)
        if run.out_name is not None and getattr(src, "aborted", False):
            _flag_aborted(run.out_name, params.usrp_number, rx_name, src)
    return run.out_name


class _Run:
    """The sinks of one run_measurement call: `extra_sinks`, and with a
    file name an H5Sink an antenna (or a mixed antenna's group) into the
    one file, in the JAX package's arguments."""

    def __init__(self, params, filename, trigger, tags, extra_sinks):
        self.params, self.filename = params, filename
        self.trigger, self.tags = trigger, tags
        self.extra = list(extra_sinks)
        self.out_name = None

    def sinks(self, rx_name: str, k: int = 0, group=None) -> list:
        """The sinks of antenna `rx_name`, or of group `k` (a
        demodulator.MixedGroup) of its mixed demodulator: the extra
        sinks take the antenna's (group 0's) packets."""
        sinks = list(self.extra) if k == 0 else []
        if self.filename is None:
            return sinks
        from .client.files import H5Sink
        kw = {} if group is None else dict(
            dataset="data" if k == 0 else f"mixed_{k}",
            sub_params=group.params, channel_index=group.channel_idx)
        sink = H5Sink(self.filename, self.params, ant_name=rx_name,
                    trigger=self.trigger if k == 0 else None, **kw,
                    **self.tags)
        self.out_name = sink.filename
        return sinks + [sink]


def _flag_aborted(filename, usrp_number, rx_name, src) -> None:
    """Stamp an aborted (under-delivered) acquisition on its H5 group so
    analysis can tell a short file from a complete one: the reference
    declares "USRP is not streaming" and aborts instead of fabricating
    samples (cpp/USRP_hardware_manager.cpp:1546-1560)."""
    from .client import h5
    with h5.File(filename, "a") as f:
        g = f[f"raw_data{int(usrp_number)}"][rx_name]
        g.attrs["aborted"] = True
        g.attrs["shortfall_blocks"] = int(
            getattr(src, "shortfall_blocks", 0))


def _run_dual(run, mesh, dev) -> bool:
    """The lock-step branch, first in the JAX package's order
    (gpu_sdr_tpu/measure.py:154-185): DualFused, or DualShardedFused
    under a mesh, when plan_dual gives the pairs and the sharded chains
    share a plan; each front end has its own sinks (one H5Sink each,
    into the one file).  Whether it ran; if not, the caller streams each
    RX in turn."""
    pairs = plan_dual(run.params, mesh=mesh)
    if pairs is None:
        return False
    dual = (DualFused(pairs, device=dev) if mesh is None
            else DualShardedFused(pairs, mesh))
    if not getattr(dual, "ok", True):
        return False                   # untileable: the sequential path
    path = "dual_fused" if mesh is None else "dual_sharded_fused"
    for (rx_name, _tx, _rx), ch in zip(pairs, dual.chains):
        _record_dispatch(rx_name, path, ch.path)
    dual.run([run.sinks(rx_name) for rx_name, _tx, _rx in pairs],
             usrp_number=run.params.usrp_number)
    return True


def _run_on_mesh(run, rx_name, tx, rx, mesh, source, channel,
                 run_kw) -> bool:
    """The mesh branches, in the JAX package's order: the sharded fused
    chain (an ideal loopback, no channel model), then a recording
    replayed from the mesh's devices (within the device budget:
    ShardedDeviceReplay; over it: ShardedSegmentedReplay), when looped
    in whole blocks of the sharded plan.  Whether a branch ran; if none
    did, the caller takes the host pipeline with the sharded
    demodulator."""
    from .parallel.fused_sharded import (can_fuse_sharded,
                                         make_sharded_fused,
                                         plan_sharded_block)
    from .parallel.sharded_replay import (ShardedDeviceReplay,
                                          ShardedSegmentedReplay)
    if source is None and channel is None:
        if tx is None or not can_fuse_sharded(tx, rx, mesh) or \
                rx.delay > tx.delay:
            return False
        L, nb = plan_sharded_block(rx, mesh)
        sf = make_sharded_fused(tx, rx, mesh, block_len=L)
        if sf is None:                 # untileable: the host pipeline
            return False
        _record_dispatch(rx_name, "sharded_fused", sf.path)
        sf.run(run.sinks(rx_name), n_blocks=nb, **run_kw)
        return True
    if source is None or channel is not None or \
            not _replays_whole_blocks(source, rx, mesh):
        return False
    loop = bool(getattr(source, "loop", False))
    if can_device_replay(source):
        replay = ShardedDeviceReplay(rx, source.data, mesh, loop=loop)
        _record_dispatch(rx_name, "sharded_replay", replay.path)
    else:
        replay = ShardedSegmentedReplay(rx, source.data, mesh, loop=loop)
        _record_dispatch(rx_name, "sharded_segmented_replay")
    replay.run(run.sinks(rx_name), **run_kw)
    return True
