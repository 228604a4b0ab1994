"""Measurement orchestrator: the TXRX of the port (a copy of
gpu_sdr_tpu/server/txrx.py on the port's engine).

Replaces the reference thread graph (TXRX,
cpp/USRP_server_link_threads.cpp): `set()` stages a measurement's
parameters, `start()` runs it in a worker thread through
``measure.run_measurement`` on the server's device, feeding the data
plane (and/or a server-side HDF5 file, the reference H5_file_writer),
`stop()` reports or forces completion.  The reference's per-frontend
worker threads, pinned cores and lock-free queues collapse into the
engine's block loop and the data plane's queue.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..engine.channel import Channel
from ..engine.sinks import PacketMeta, Sink
from ..engine.sources import Source
from ..measure import run_measurement
from ..params import ServerSettings, UsrpParams
from ..utils.log import get_logger

log = get_logger("txrx")


class _StreamSink(Sink):
    """Forwards packets to the data plane's queue (the reference
    stream_queue -> tcp_streamer chain)."""

    def __init__(self, server):
        self.server = server

    def on_packet(self, meta: PacketMeta, data: np.ndarray) -> None:
        self.server.push(meta, data)


def server_device(settings: ServerSettings, device="cuda") -> torch.device:
    """The device a server measures on: `device` as its caller named it,
    a CUDA device without an index taking ``settings.device_index`` as
    its ordinal; the resolved ordinal is written back to the settings.
    A CUDA device on a host with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(settings.device_index))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        settings.device_index = dev.index
    return dev


class TXRX:
    """set/start/stop lifecycle (reference TXRX,
    headers/USRP_server_link_threads.hpp:35-46) on `device`."""

    def __init__(self, settings: ServerSettings,
                 sync_server=None,
                 channel: Optional[Channel] = None,
                 source: Optional[Source] = None,
                 file_writing: Optional[bool] = None,
                 ingest_port: Optional[int] = None,
                 device="cuda"):
        self.settings = settings
        self.device = server_device(settings, device)
        self.sync_server = sync_server
        # keep None as None: run_measurement's fast paths (the lock-step
        # front ends, the fused loopback, the device replay) all gate on
        # `channel is None`
        self.channel = channel
        self.source = source
        self.file_writing = (settings.file_writing if file_writing is None
                             else file_writing)
        # host-fed ingest: when set, each measurement binds a native TCP
        # receiver on this port (0 = ephemeral) and RX consumes the raw
        # complex64 stream an external producer sends
        self.ingest_port = ingest_port
        self.active_ingest_port: Optional[int] = None
        self._ingest_ready = threading.Event()
        self._params: Optional[UsrpParams] = None
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._error: Optional[Exception] = None
        self.last_filename: Optional[str] = None

    # ------------------------------------------------------------------
    def set(self, params: UsrpParams) -> None:
        """Validate and stage a measurement (reference TXRX::set)."""
        params.validate()
        self._params = params
        self._done.clear()
        self._ingest_ready.clear()
        self._error = None

    def wait_ingest_port(self, timeout: float = 10.0) -> Optional[int]:
        """Port the running measurement's ingest receiver listens on
        (None when ingest is not enabled)."""
        self._ingest_ready.wait(timeout)
        return self.active_ingest_port

    def start(self) -> None:
        """Launch the staged measurement asynchronously
        (reference TXRX::start)."""
        if self._params is None:
            raise RuntimeError("TXRX.start() called before set()")
        self._thread = threading.Thread(target=self._run, name="txrx_worker",
                                        daemon=True)
        self._thread.start()

    def _make_ingest_source(self):
        """Bind the native ingest receiver for this measurement (block
        size from the RX plan, as the reference sizes its pinned pools
        per measurement in TXRX::set)."""
        from ..engine.ingest import SocketIngestSource
        from ..engine.planner import plan_blocks
        from ..params import AntMode
        for _name, rx in self._params.active_antennas(AntMode.RX):
            blk = plan_blocks(rx).block_len
            src = SocketIngestSource(block_len=blk, port=self.ingest_port)
            log.info("ingest listening on port %d (block %d)",
                     src.port, blk)
            return src
        return None

    def _run(self) -> None:
        ingest = None
        try:
            extra = []
            if self.sync_server is not None and \
                    self.settings.tcp_streaming:
                extra.append(_StreamSink(self.sync_server))
            filename = None
            if self.file_writing:
                import datetime
                stamp = datetime.datetime.now().strftime("%d%m%Y_%H%M%S")
                filename = f"USRP_{stamp}"
            source = self.source
            try:
                if source is None and self.ingest_port is not None:
                    source = ingest = self._make_ingest_source()
                self.active_ingest_port = ingest.port if ingest else None
            finally:
                # always release waiters: if ingest setup raises,
                # serve_one would otherwise block the whole
                # wait_ingest_port timeout before nacking
                self._ingest_ready.set()
            self.last_filename = run_measurement(
                self._params, filename, channel=self.channel,
                source=source, extra_sinks=extra, device=self.device)
        except Exception as e:   # surfaced through stop()/nack
            log.exception("measurement failed")
            self._error = e
        finally:
            if ingest is not None:
                ingest.close()
                self.active_ingest_port = None
            self._done.set()

    def stop(self, force: bool = False) -> bool:
        """True when the measurement has completed (reference TXRX::stop
        polling contract, cpp/usrp_server.cpp:92-101)."""
        if force:
            self._done.set()
            return True
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def error(self) -> Optional[Exception]:
        return self._error
