"""In-process measurement execution (port of gpu_sdr_tpu/measure.py).

Given a validated UsrpParams, build TX generators and RX demodulators
and route TX -> channel -> RX on one device.  Ported branches, for one
front end, in the JAX package's order:

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
  whole blocks among them), fed block by block to the demodulator.

Every other branch raises NotImplementedError naming the ROADMAP item
that will port it; none falls back to another path.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from .config import resolve_device
from .engine import (FusedLoopback, can_fuse, make_demodulator,
                     make_generator, run_pipeline)
from .engine.channel import Channel, IdealChannel
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


def _replays_whole_blocks(source, rx) -> bool:
    """A recording that one of the replays takes: within the device
    budget or over it, and, when looped, a whole number of blocks (the
    host-fed source's loop semantics need it)."""
    if not (can_device_replay(source) or can_segmented_replay(source)):
        return False
    loop = bool(getattr(source, "loop", False))
    return not (loop and len(source.data) % plan_blocks(rx).block_len)


def run_measurement(params: UsrpParams, filename: Optional[str] = None,
                    channel: Optional[Channel] = None,
                    source: Optional[Source] = None,
                    extra_sinks: Sequence[Sink] = (),
                    trigger=None, mesh=None, device="cuda",
                    **tags) -> None:
    """Execute a measurement described by `params` on `device`.

    With an active TX, TX drives RX through `channel`; with no channel
    model the ideal loopback runs fused on the device.  A `source` feeds
    RX instead: a recording of whole blocks (or one that is not looped)
    with no channel model is replayed from device memory.  With neither,
    RX consumes white noise.  Data goes to `extra_sinks`."""
    if filename is not None or trigger is not None:
        raise NotImplementedError(
            "HDF5 output is not ported yet (ROADMAP Queue 1 item 3: "
            "client/files.H5Sink imports the JAX engine)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh measurements are not ported yet (ROADMAP Queue 1 item 9)")
    dev = resolve_device(device)
    params.validate()
    rx_list = list(params.active_antennas(AntMode.RX))
    if len(rx_list) > 1:
        raise NotImplementedError(
            "more than one RX front end (dual / sequential) is not ported "
            "yet (ROADMAP Queue 1 item 7)")
    LAST_DISPATCH.clear()
    for rx_name, rx in rx_list:
        if _is_mixed(rx):
            raise NotImplementedError(
                "mixed wave types on one antenna are not ported yet "
                "(ROADMAP Queue 1 item 3)")
        tx_name = _pair_tx(params, rx_name)
        tx = params.antenna(tx_name) if tx_name else None
        if source is None and channel is None and tx is not None and \
                can_fuse(tx, rx) and rx.delay <= tx.delay:
            fused = FusedLoopback(tx, rx, device=dev)
            _record_dispatch(rx_name, "fused_loopback", fused.path)
            fused.run(list(extra_sinks), usrp_number=params.usrp_number,
                      front_end=rx_name[0])
            continue
        if source is not None and channel is None and \
                _replays_whole_blocks(source, rx):
            loop = bool(getattr(source, "loop", False))
            if can_device_replay(source):
                replay = DeviceReplay(rx, source.data, loop=loop, device=dev)
                _record_dispatch(rx_name, "device_replay", replay.path)
            else:
                replay = SegmentedDeviceReplay(rx, source.data, loop=loop,
                                               device=dev)
                _record_dispatch(rx_name, "segmented_replay")
            replay.run(list(extra_sinks), usrp_number=params.usrp_number,
                       front_end=rx_name[0])
            continue
        demod = make_demodulator(rx, dev)
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
        _record_dispatch(rx_name, "host_pipeline")
        run_pipeline(demod, src, list(extra_sinks),
                     usrp_number=params.usrp_number, front_end=rx_name[0])
    return None
