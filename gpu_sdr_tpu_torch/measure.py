"""In-process measurement execution (port of gpu_sdr_tpu/measure.py).

Given a validated UsrpParams, build TX generators and RX demodulators
and route TX -> channel -> RX on one device.  engine/dispatch.
plan_dispatch chooses every path, once a call; this module carries its
decisions out, a runner a path.  First, with no source and no channel
model, two or more RX front ends whose loopbacks fuse with one block
plan run in lock-step (``dual_fused``, engine/dual.DualFused;
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

from . import spans
from .config import maybe_profile, resolve_device
from .engine import (FusedLoopback, make_demodulator, make_generator,
                     run_pipeline)
from .engine.channel import Channel, IdealChannel
from .engine.dispatch import (DEVICE_REPLAY, DUAL_FUSED, DUAL_SHARDED,
                              FUSED_LOOPBACK, HOST_MIXED, HOST_PIPELINE,
                              SEGMENTED_REPLAY, SHARDED_FUSED,
                              SHARDED_REPLAY, SHARDED_SEGMENTED,
                              plan_dispatch)
from .engine.dual import DualFused, DualShardedFused
from .engine.pipeline import run_pipeline_mixed
from .engine.planner import _pair_tx, plan_blocks
from .engine.replay import DeviceReplay, SegmentedDeviceReplay
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
# (``sdr.stream``); while the recorder was on (spans.py), ``spans`` and
# ``counters`` (spans.Recorder.record)
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
    dev = mesh.first if mesh is not None else resolve_device(device)
    profile = maybe_profile("measurement", dev)
    with spans.call(trace=bool(profile.dir)) as rec:
        with spans.once("sdr.setup.plan"):
            params.validate()
            decisions = plan_dispatch(params, source=source,
                                      channel=channel, mesh=mesh)
            plans = [plan_blocks(rx)
                     for _, rx in params.active_antennas(AntMode.RX)]
        t0 = time.perf_counter()
        with profile:
            run = _Run(params, filename, trigger, tags, extra_sinks,
                       source, channel, mesh, dev)
            out = _measure(run, decisions)
        seconds = time.perf_counter() - t0
    RUNS.append(dict(
        plan=[list(d.key()) for d in decisions],
        dispatch=[list(k) for k in LAST_DISPATCH],
        blocks=sum(p.n_blocks for p in plans),
        samples=sum(p.total_samples for p in plans),
        seconds=seconds, stream_seconds=rec.stream_seconds(),
        **rec.record()))
    return out


def _measure(run, decisions) -> Optional[str]:
    """Carry out plan_dispatch's decisions: the front ends in lock-step
    as one group, else each RX's own path in turn."""
    LAST_DISPATCH.clear()
    if decisions and decisions[0].path in (DUAL_FUSED, DUAL_SHARDED):
        _lockstep(run, decisions)
    else:
        for d in decisions:
            _RUNNERS[d.path](run, d)
    return run.out_name


class _Run:
    """One run_measurement call: its inputs, and its sinks:
    `extra_sinks`, and with a file name an H5Sink an antenna (or a mixed
    antenna's group) into the one file, in the JAX package's
    arguments."""

    def __init__(self, params, filename, trigger, tags, extra_sinks,
                 source, channel, mesh, dev):
        self.params, self.filename = params, filename
        self.trigger, self.tags = trigger, tags
        self.extra = list(extra_sinks)
        self.source, self.channel = source, channel
        self.mesh, self.dev = mesh, dev
        self.out_name = None

    def antennas(self, rx_name: str) -> tuple:
        """(tx, rx): antenna `rx_name` and the TX driving it, or None."""
        tx_name = _pair_tx(self.params, rx_name)
        tx = self.params.antenna(tx_name) if tx_name else None
        return tx, self.params.antenna(rx_name)

    def kw(self, rx_name: str) -> dict:
        """A single front end's packet stamps: coded with its letter."""
        return dict(usrp_number=self.params.usrp_number,
                    front_end=rx_name[0])

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


def _lockstep(run, decisions) -> None:
    """``dual_fused``, or ``dual_sharded_fused`` under a mesh: every RX
    in lock-step, each front end with its own sinks (one H5Sink each,
    into the one file)."""
    pairs = [(d.rx_name, *run.antennas(d.rx_name)) for d in decisions]
    with spans.once("sdr.setup.build"):
        dual = (DualFused(pairs, device=run.dev) if run.mesh is None
                else DualShardedFused(pairs, run.mesh))
    for d, ch in zip(decisions, dual.chains):
        _record_dispatch(d.rx_name, d.path, ch.path)
    dual.run([run.sinks(d.rx_name) for d in decisions],
             usrp_number=run.params.usrp_number)


def _fused_loopback(run, d) -> None:
    """The ideal loopback's whole chain on the device (engine/fused.py)."""
    tx, rx = run.antennas(d.rx_name)
    with spans.once("sdr.setup.build"):
        fused = FusedLoopback(tx, rx, device=run.dev)
    _record_dispatch(d.rx_name, d.path, fused.path)
    fused.run(run.sinks(d.rx_name), **run.kw(d.rx_name))


def _sharded_fused(run, d) -> None:
    """The ideal loopback's chain sharded over the mesh
    (parallel/fused_sharded.py), on the mesh's block plan."""
    from .parallel.fused_sharded import (make_sharded_fused,
                                         plan_sharded_block)
    tx, rx = run.antennas(d.rx_name)
    L, nb = plan_sharded_block(rx, run.mesh)
    with spans.once("sdr.setup.build"):
        sf = make_sharded_fused(tx, rx, run.mesh, block_len=L)
    _record_dispatch(d.rx_name, d.path, sf.path)
    sf.run(run.sinks(d.rx_name), n_blocks=nb, **run.kw(d.rx_name))


def _replay(run, d) -> None:
    """A recording demodulated from device memory: resident
    (DeviceReplay, ShardedDeviceReplay) or staged segment by segment
    (SegmentedDeviceReplay, ShardedSegmentedReplay)."""
    rx = run.params.antenna(d.rx_name)
    data, loop = run.source.data, bool(getattr(run.source, "loop", False))
    with spans.once("sdr.setup.build"):
        if d.path == DEVICE_REPLAY:
            replay = DeviceReplay(rx, data, loop=loop, device=run.dev)
        elif d.path == SEGMENTED_REPLAY:
            replay = SegmentedDeviceReplay(rx, data, loop=loop,
                                           device=run.dev)
        else:
            from .parallel.sharded_replay import (ShardedDeviceReplay,
                                                  ShardedSegmentedReplay)
            cls = (ShardedDeviceReplay if d.path == SHARDED_REPLAY
                   else ShardedSegmentedReplay)
            replay = cls(rx, data, run.mesh, loop=loop)
    _record_dispatch(d.rx_name, d.path, getattr(replay, "path", None))
    replay.run(run.sinks(d.rx_name), **run.kw(d.rx_name))


def _host(run, d) -> None:
    """The host-fed demodulator (sharded under a mesh), fed by the given
    source, else by the paired TX's generator through the channel model,
    else by white noise; a mixed antenna's one demodulator a wave type
    over the same stream, group 0 filling `data` and taking the trigger,
    group k a `mixed_<k>`."""
    tx, rx = run.antennas(d.rx_name)
    with spans.once("sdr.setup.build"):
        demod = make_demodulator(rx, run.dev, mesh=run.mesh)
    if run.source is not None:
        src = run.source
    elif tx is not None:
        with spans.once("sdr.setup.build"):
            gen = make_generator(tx, demod.plan.block_len, run.dev)
        # timed RX start: honor the delay parameter difference
        skip = int(round(max(rx.delay - tx.delay, 0.0) * rx.rate))
        src = ChannelSource(gen, run.channel or IdealChannel(),
                            skip_samples=skip)
    else:
        src = WhiteNoiseSource()
    _record_dispatch(d.rx_name, d.path)
    if d.path == HOST_MIXED:
        run_pipeline_mixed(demod, src, [
            run.sinks(d.rx_name, k, g) for k, g in enumerate(demod.groups)],
            **run.kw(d.rx_name))
    else:
        run_pipeline(demod, src, run.sinks(d.rx_name), **run.kw(d.rx_name))
    if run.out_name is not None and getattr(src, "aborted", False):
        _flag_aborted(run.out_name, run.params.usrp_number, d.rx_name, src)


# the runner of each path but the lock-step ones
_RUNNERS = {
    FUSED_LOOPBACK: _fused_loopback,
    SHARDED_FUSED: _sharded_fused,
    DEVICE_REPLAY: _replay,
    SEGMENTED_REPLAY: _replay,
    SHARDED_REPLAY: _replay,
    SHARDED_SEGMENTED: _replay,
    HOST_PIPELINE: _host,
    HOST_MIXED: _host,
}


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
