"""Client runtime: TCP connection to the server (mirrors
pyUSRP/USRP_connections.py; the port's copy of
gpu_sdr_tpu/client/connections.py, its files written through
client/files.H5Sink by client/h5.py).

A :class:`Connection` owns the command (async) socket and a data (sync)
receiver thread pushing (metadata, samples) into a queue;
:func:`Packets_to_file` consumes the queue into a reference-layout HDF5
file (the role of the reference's Packets_to_file,
pyUSRP/USRP_connections.py:89-347).  Module-level wrappers mirror the
pyUSRP global API (Connect/Disconnect/Async_send).
"""

from __future__ import annotations

import json
import queue
import socket
import threading
from typing import Optional

import numpy as np

from ..params import UsrpParams
from ..server import wire
from ..utils.log import get_logger
from . import files as Ufiles

log = get_logger("client")


class Connection:
    def __init__(self, host: str = "127.0.0.1",
                 async_port: int = wire.ASYNC_PORT,
                 sync_port: int = wire.SYNC_PORT, timeout: float = 10.0):
        self.host = host
        self.async_sock = socket.create_connection((host, async_port),
                                                   timeout=timeout)
        self.sync_sock = socket.create_connection((host, sync_port),
                                                  timeout=timeout)
        self.sync_sock.settimeout(0.5)
        self.async_sock.settimeout(0.5)
        self.data_queue: "queue.Queue" = queue.Queue()
        self.end_of_measure = threading.Event()
        self.error_status = threading.Event()
        self.remote_filename: Optional[str] = None
        self.ingest_port: Optional[int] = None
        self._stop = threading.Event()
        self._sync_thread = threading.Thread(target=self._sync_rx,
                                             name="Sync_RX", daemon=True)
        self._async_thread = threading.Thread(target=self._async_rx,
                                              name="Async_RX", daemon=True)
        self._sync_thread.start()
        self._async_thread.start()

    # ------------------------------------------------------------------
    def async_send(self, payload: str) -> None:
        """Send a JSON command (reference Async_send,
        pyUSRP/USRP_connections.py:501-535)."""
        self.async_sock.sendall(wire.encode_async_message(payload))

    def send_params(self, params: UsrpParams) -> None:
        self.end_of_measure.clear()
        self.error_status.clear()
        self.async_send(params.to_json())

    # ------------------------------------------------------------------
    def _recv_mid(self, sock, n: int):
        """recv_exact that never abandons a message whose header is
        already consumed: a zero-byte timeout here would desync the
        framing (the next read would parse payload bytes as a header)."""
        while not self._stop.is_set():
            try:
                return wire.recv_exact(sock, n, stop=self._stop.is_set)
            except socket.timeout:
                continue
        return None

    def _async_rx(self):
        """Receive framed JSON replies; EOM/nack set the end flags
        (reference Async_thread + Decode_Async_payload,
        pyUSRP/USRP_connections.py:446-481)."""
        try:
            while not self._stop.is_set():
                try:
                    raw = wire.recv_exact(self.async_sock, 8)
                    if raw is None:
                        break
                    length = wire.decode_async_header(raw)
                    if length <= 0:
                        continue
                    payload = self._recv_mid(self.async_sock, length)
                    if payload is None:
                        break
                    self._handle_async(payload.decode())
                except socket.timeout:
                    continue
                except OSError:
                    break
        finally:
            if not self._stop.is_set():
                # server vanished: release any waiter (Packets_to_file
                # would otherwise spin forever).  Only an EOF arriving
                # BEFORE the EOM is an error — a one-shot server exiting
                # right after its EOM ack is a clean shutdown.
                if not self.end_of_measure.is_set():
                    self.error_status.set()
                self.end_of_measure.set()

    def _handle_async(self, message: str):
        try:
            res = json.loads(message)
        except ValueError:
            log.warning("cannot decode server response")
            return
        if res.get("type") == "ack":
            payload = res.get("payload", "")
            if "EOM" in payload:
                self.end_of_measure.set()
            elif "filename" in payload:
                try:
                    self.remote_filename = payload.split('"')[1]
                except IndexError:
                    pass
            elif payload.startswith("ingest port "):
                # host-fed mode: the server announces where to stream raw
                # complex64 IQ for this measurement
                try:
                    self.ingest_port = int(payload.rsplit(" ", 1)[1])
                except ValueError:
                    pass
        elif res.get("type") == "nack":
            self.error_status.set()
            self.end_of_measure.set()

    # ------------------------------------------------------------------
    def _sync_rx(self):
        """Receive data packets into the queue (reference Sync_RX process,
        pyUSRP/USRP_connections.py:814-1013)."""
        try:
            while not self._stop.is_set():
                try:
                    raw = wire.recv_exact(self.sync_sock, wire.HEADER_SIZE)
                    if raw is None:
                        break
                    meta = wire.decode_sync_header(raw)
                    n = meta["length"]
                    payload = self._recv_mid(self.sync_sock, 8 * n)
                    if payload is None:
                        break
                    data = np.frombuffer(payload, dtype=np.complex64,
                                         count=n)
                    self.data_queue.put((meta, data))
                except socket.timeout:
                    continue
                except OSError:
                    break
        finally:
            if not self._stop.is_set():
                # data-socket EOF races the EOM ack on the async socket:
                # a one-shot server sends its EOM and exits, closing both
                # sockets — under load this thread can observe the EOF
                # before the async thread has parsed the EOM.  Give the
                # in-flight ack a grace window before declaring an error.
                if not self.end_of_measure.wait(timeout=1.0):
                    self.error_status.set()
                self.end_of_measure.set()

    def close(self):
        self._stop.set()
        for s in (self.async_sock, self.sync_sock):
            try:
                s.close()
            except OSError:
                pass


# ----------------------------------------------------------------------
# Packets_to_file
# ----------------------------------------------------------------------

def Packets_to_file(conn: Connection, parameters: UsrpParams,
                    filename: str, timeout: Optional[float] = None,
                    trigger=None, push_queue=None, meas_type: str = "data",
                    dpc_expected: Optional[int] = None, progress: bool = True,
                    **tags) -> str:
    """Consume the data queue into a reference-layout H5 file until the
    server's EOM (reference Packets_to_file,
    pyUSRP/USRP_connections.py:89-347).  With `dpc_expected` (expected
    data points per channel) a percent progress line is printed, the role
    of the reference's progressbar (USRP_connections.py:266-273)."""
    import sys as _sys

    from ..params import AntMode
    from .files import H5Sink, expected_data_len
    from ..engine.sinks import PacketMeta

    rx_names = [n for n, _ in parameters.active_antennas(AntMode.RX)]
    sinks = {}
    for rx in rx_names:
        sinks[rx] = H5Sink(filename, parameters, ant_name=rx,
                           trigger=trigger, meas_type=meas_type, **tags)
    if dpc_expected is None and rx_names:
        try:
            # rows accumulate over ALL RX antennas below, so the 100%
            # mark is the sum of their expected lengths
            dpc_expected = sum(
                expected_data_len(parameters.antenna(r))
                for r in rx_names)
        except (IndexError, ZeroDivisionError):
            dpc_expected = None

    import time as _time
    received_rows = 0
    last_pct = -10
    last_data_t = _time.monotonic()
    eom_grace = 0.5
    try:
        while True:
            if (conn.end_of_measure.is_set() and dpc_expected and
                    received_rows >= dpc_expected):
                break                  # everything expected has arrived
            try:
                meta, data = conn.data_queue.get(timeout=0.2)
            except queue.Empty:
                now = _time.monotonic()
                if conn.end_of_measure.is_set():
                    # EOM rides the async connection, which has no
                    # ordering vs in-flight data packets: keep draining
                    # for a grace window so tail packets are not dropped
                    # (and cannot pollute the next measurement); the
                    # received_rows check above skips the wait whenever
                    # the expected count is known and met
                    if now - last_data_t > eom_grace:
                        break
                elif timeout is not None and now - last_data_t > timeout:
                    # sinks flush in the finally below
                    raise TimeoutError(f"no data or EOM for {timeout} s")
                continue
            last_data_t = _time.monotonic()
            received_rows += meta["length"] // max(1, meta["channels"])
            if progress and dpc_expected:
                pct = min(100, int(100 * received_rows / dpc_expected))
                if pct >= last_pct + 10:
                    _sys.stdout.write(f"\racquisition {pct:3d}%")
                    _sys.stdout.flush()
                    last_pct = pct
            ant = meta["front_end_code"]
            sink = sinks.get(ant)
            if sink is None:
                log.warning("packet from unconfigured front end %r "
                            "dropped", ant)
                continue
            channels = max(1, meta["channels"])
            rows = len(data) // channels
            shaped = data[:rows * channels].reshape(rows, channels)
            pm = PacketMeta(usrp_number=meta["usrp_number"],
                            front_end_code=ant,
                            packet_number=meta["packet_number"],
                            length=meta["length"], errors=meta["errors"],
                            channels=channels)
            sink.on_packet(pm, shaped)
            if push_queue is not None:
                push_queue.put((meta, data))
    finally:
        if progress and dpc_expected and last_pct >= 0:
            import sys as _sys2
            _sys2.stdout.write("\n")
        for s in sinks.values():
            s.on_end()
    if conn.error_status.is_set():
        raise RuntimeError("server reported an error during the measure")
    return Ufiles.format_filename(filename)


# ----------------------------------------------------------------------
# pyUSRP-style module-level API
# ----------------------------------------------------------------------

_global_connection: Optional[Connection] = None


def Connect(timeout: float = 10.0, host: str = "127.0.0.1",
            async_port: int = wire.ASYNC_PORT,
            sync_port: int = wire.SYNC_PORT) -> bool:
    """Open the global connection (reference Connect,
    pyUSRP/USRP_connections.py:771-793)."""
    global _global_connection
    if _global_connection is not None:
        return True
    _global_connection = Connection(host=host, async_port=async_port,
                                    sync_port=sync_port, timeout=timeout)
    return True


def Disconnect(blocking: bool = True) -> bool:
    global _global_connection
    if _global_connection is not None:
        _global_connection.close()
        _global_connection = None
    return True


def get_connection() -> Connection:
    if _global_connection is None:
        raise RuntimeError("not connected: call Connect() first")
    return _global_connection


def Async_send(payload: str) -> bool:
    get_connection().async_send(payload)
    return True
