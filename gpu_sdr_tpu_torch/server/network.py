"""TCP servers: command (async) and data (sync) planes.

Python equivalent of the reference boost::asio servers
(cpp/USRP_server_network.cpp): ``SyncServer`` accepts one client on the data
port and streams RX_wrapper packets from a queue; ``AsyncServer`` accepts
one client on the command port, queues incoming JSON commands and drains a
response queue.  Both survive client disconnect/reconnect (the reference's
reconnect_data/reconnect_async atomics + virtual_pinger watchdog,
cpp/USRP_server_network.cpp:3-4,135-161).

The port's copy of gpu_sdr_tpu/server/network.py.  The server streams
through the native C++ data plane (server/native.NativeSyncServer) unless
its caller asks for this Python streamer, the behavioural reference.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Optional

import numpy as np

from ..utils.log import get_logger
from . import wire

log = get_logger("network")


class _SingleClientServer:
    """Listener that serves one client at a time with reconnect support."""

    def __init__(self, port: int, host: str = "0.0.0.0", name: str = "srv"):
        self.port = port
        self.name = name
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self._listener.settimeout(0.5)
        self.port = self._listener.getsockname()[1]
        self._client: Optional[socket.socket] = None
        self._client_lock = threading.Lock()
        self._stop = threading.Event()
        # invoked (outside the lock) when a connected client goes away —
        # the reference couples the two planes this way: a command-socket
        # drop flags the data socket for reconnect (reconnect_data +
        # virtual_pinger, cpp/USRP_server_network.cpp:3-4,135-161)
        self.on_disconnect = None

    def _accept_loop_once(self) -> Optional[socket.socket]:
        try:
            c, addr = self._listener.accept()
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            log.info("%s: client connected from %s", self.name, addr)
            return c
        except socket.timeout:
            return None
        except OSError:
            if self._stop.is_set():      # close() shut the listener
                return None
            raise

    def wait_client(self, timeout: Optional[float] = None) -> bool:
        """Block until a client is connected (or stop/timeout)."""
        import time
        t0 = time.monotonic()
        while not self._stop.is_set():
            with self._client_lock:
                if self._client is not None:
                    return True
            c = self._accept_loop_once()
            if c is not None:
                with self._client_lock:
                    self._client = c
                return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
        return False

    def drop_client(self):
        had = False
        with self._client_lock:
            if self._client is not None:
                try:
                    self._client.close()
                except OSError:
                    pass
                self._client = None
                had = True
        cb = self.on_disconnect          # read once: close() may detach
        if had and cb is not None:
            cb()

    def close(self):
        self._stop.set()
        self.drop_client()
        try:
            self._listener.close()
        except OSError:
            pass


class SyncServer(_SingleClientServer):
    """Data-plane streamer (reference Sync_server,
    cpp/USRP_server_network.cpp:195-308): pops packets from an internal
    queue and writes header+payload to the connected client.  A packet
    taken while its client goes away is kept for the next client, as the
    native streamer keeps it in its ring (the JAX package's drops it:
    ROADMAP Queue 3 #35)."""

    def __init__(self, port: int = wire.SYNC_PORT, host: str = "0.0.0.0",
                 queue_len: int = 1000):
        super().__init__(port, host, name="sync")
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_len)
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._stream_loop,
                                        name="tcp_streamer", daemon=True)
        self._thread.start()

    def push(self, meta, data: np.ndarray, timeout: float = 5.0) -> bool:
        """Enqueue a packet; meta is an engine PacketMeta."""
        try:
            self.queue.put((meta, data), timeout=timeout)
            return True
        except queue.Full:
            log.warning("sync stream queue saturated, dropping packet")
            return False

    def _stream_loop(self):
        buf = None          # the packet in hand, kept until it is sent
        while not self._stop.is_set():
            if not self.wait_client(timeout=0.5):
                continue
            if buf is None:
                try:
                    meta, data = self.queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                fe = meta.front_end_code
                if len(fe) == 1:   # engine uses the front-end letter; data
                    fe = {"A": "A_RX2", "B": "B_RX2"}[fe]  # flows from RX2
                code = wire.FRONT_END_CODES.get(fe, b"B")
                buf = wire.encode_sync_packet(
                    meta.usrp_number, code, meta.packet_number,
                    meta.errors, meta.channels, data)
            with self._client_lock:
                c = self._client
            if c is None:
                # the client went away while the packet was taken: it
                # goes to the next one, as in the native streamer
                continue
            try:
                c.sendall(buf)
                buf = None
            except OSError:
                log.warning("sync client disconnected mid-stream")
                self.drop_client()

    def flush(self, timeout: float = 10.0):
        import time
        t0 = time.monotonic()
        while not self.queue.empty():
            if time.monotonic() - t0 > timeout:
                break
            time.sleep(0.01)


class AsyncServer(_SingleClientServer):
    """Command-plane server (reference Async_server,
    cpp/USRP_server_network.cpp:373-649): receives framed JSON commands into
    `commands`, sends responses from `send()`."""

    def __init__(self, port: int = wire.ASYNC_PORT, host: str = "0.0.0.0"):
        super().__init__(port, host, name="async")
        self.commands: "queue.Queue[str]" = queue.Queue()
        self._rx_thread: Optional[threading.Thread] = None

    def start(self):
        self._rx_thread = threading.Thread(target=self._rx_loop,
                                           name="rx_async", daemon=True)
        self._rx_thread.start()

    def _rx_loop(self):
        while not self._stop.is_set():
            if not self.wait_client(timeout=0.5):
                continue
            with self._client_lock:
                c = self._client
            if c is None:
                continue
            c.settimeout(0.5)
            try:
                raw = wire.recv_exact(c, 8, stop=self._stop.is_set)
                if raw is None:
                    self.drop_client()
                    continue
                length = wire.decode_async_header(raw)
                if length <= 0:
                    continue
                payload = wire.recv_exact(c, length,
                                          stop=self._stop.is_set)
                if payload is None:
                    self.drop_client()
                    continue
                self.commands.put(payload.decode())
            except socket.timeout:
                continue
            except OSError:
                self.drop_client()

    def recv_command(self, timeout: Optional[float] = None) -> Optional[str]:
        try:
            return self.commands.get(timeout=timeout)
        except queue.Empty:
            return None

    def send(self, payload: str) -> bool:
        with self._client_lock:
            c = self._client
        if c is None:
            return False
        try:
            c.sendall(wire.encode_async_message(payload))
            return True
        except OSError:
            self.drop_client()
            return False


def server_ack(payload: str) -> str:
    """JSON ack reply (reference server_ack,
    cpp/USRP_JSON_interpreter.cpp:441-448)."""
    import json
    return json.dumps({"type": "ack", "payload": payload})


def server_nack(payload: str) -> str:
    import json
    return json.dumps({"type": "nack", "payload": payload})
