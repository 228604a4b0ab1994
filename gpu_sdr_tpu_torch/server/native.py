"""ctypes bindings to the native TCP data planes, the port's copy of
gpu_sdr_tpu/server/native.py: the streamer (native/stream_server.cpp,
``NativeSyncServer``) and the ingest receiver (native/stream_ingest.cpp,
``NativeIngest``), each over the lock-free ring of native/spsc_ring.hpp.

The port builds its own copy of each library from the checkout's sources
at first use: ``g++ -O3 -shared -fPIC -pthread -Inative`` into
``gpu_sdr_tpu_torch/_build/``, under a name hashed from the sources and
the flags, so an unchanged checkout reuses its build.  The compiler
writes a temporary name that ``os.replace`` then moves into place, so
processes that build at once (test workers) never load a half-written
file.  A failed build raises; there is no fallback to the Python
streamer, and the JAX package's CMake build (native/build/) is never
read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from . import wire

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# library -> its sources, the compiled one first
LIBRARIES = {"ingest": ("stream_ingest.cpp", "spsc_ring.hpp"),
             "stream": ("stream_server.cpp", "spsc_ring.hpp")}
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}
# the kinds of library this process compiled (the others it loaded from
# an earlier build of the same sources)
built_here: set = set()


def library_path(kind: str) -> Path:
    """The library of this checkout's sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in LIBRARIES[kind]:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libsdr_{kind}_{h.hexdigest()[:16]}.so"


def build(kind: str) -> Path:
    """Compile the library's source unless a library of the same hash
    exists; raise if g++ fails."""
    out = library_path(kind)
    if out.is_file():
        return out
    source = LIBRARIES[kind][0]
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {kind} library is "
                           f"built from native/{source}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(
        [cxx, *CXX_FLAGS, f"-I{NATIVE_DIR}", "-o", str(tmp),
         str(NATIVE_DIR / source)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{source} (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    built_here.add(kind)
    return out


def _bind_ingest(lib) -> None:
    vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.sdr_ingest_create.restype = vp
    lib.sdr_ingest_create.argtypes = [ci, sz, sz]
    lib.sdr_ingest_port.restype = ci
    lib.sdr_ingest_port.argtypes = [vp]
    lib.sdr_ingest_pop.restype = ci
    lib.sdr_ingest_pop.argtypes = [vp, vp]
    for name in ("pending", "connected", "eof"):
        fn = getattr(lib, f"sdr_ingest_{name}")
        fn.restype = ci
        fn.argtypes = [vp]
    for name in ("blocks_received", "overflows", "fragments", "padded"):
        fn = getattr(lib, f"sdr_ingest_{name}")
        fn.restype = ctypes.c_ulonglong
        fn.argtypes = [vp]
    lib.sdr_ingest_destroy.restype = None
    lib.sdr_ingest_destroy.argtypes = [vp]


def _bind_stream(lib) -> None:
    vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.sdr_stream_server_create.restype = vp
    lib.sdr_stream_server_create.argtypes = [ci, sz, sz]
    lib.sdr_stream_server_port.restype = ci
    lib.sdr_stream_server_port.argtypes = [vp]
    lib.sdr_stream_server_push.restype = ci
    lib.sdr_stream_server_push.argtypes = [vp, ctypes.c_char_p, sz]
    for name in ("pending", "connected"):
        fn = getattr(lib, f"sdr_stream_server_{name}")
        fn.restype = ci
        fn.argtypes = [vp]
    for name in ("packets_sent", "bytes_sent"):
        fn = getattr(lib, f"sdr_stream_server_{name}")
        fn.restype = ctypes.c_ulonglong
        fn.argtypes = [vp]
    for name in ("drop_client", "destroy"):
        fn = getattr(lib, f"sdr_stream_server_{name}")
        fn.restype = None
        fn.argtypes = [vp]


def load_library(kind: str) -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    with _lock:
        if kind not in _libs:
            lib = ctypes.CDLL(str(build(kind)))
            (_bind_ingest if kind == "ingest" else _bind_stream)(lib)
            _libs[kind] = lib
        return _libs[kind]


def _buildable(kind: str) -> bool:
    return library_path(kind).is_file() or shutil.which("g++") is not None


def available() -> bool:
    """Whether this host can provide the native streamer: its library of
    this checkout is built, or g++ is there to build it (a build that
    then fails raises at first use).  Kept, with `ingest_available`, for
    the JAX package's names: there they choose the fallback, which the
    port does not have."""
    return _buildable("stream")


def ingest_available() -> bool:
    """The same for the ingest receiver."""
    return _buildable("ingest")


class NativeIngest:
    """ctypes handle to the C++ TCP ingest receiver: a producer connects
    and streams raw complex64 bytes; a native thread reassembles
    fixed-size blocks into an SPSC ring popped here.

    The native counterpart of the reference's UHD RX thread + rx_queue
    (single_rx_thread, cpp/USRP_hardware_manager.cpp:1398-1611)."""

    def __init__(self, block_len: int, port: int = 0, queue_len: int = 16):
        lib = load_library("ingest")
        self._lib = lib
        self.block_len = int(block_len)
        self.block_bytes = 8 * self.block_len     # complex64
        self._h_lock = threading.Lock()   # close() vs feeder-thread race
        self._h = lib.sdr_ingest_create(port, self.block_bytes, queue_len)
        if not self._h:
            raise RuntimeError(f"cannot bind native ingest to port {port}")
        self.port = lib.sdr_ingest_port(self._h)

    def pop_block(self, timeout: float = 10.0) -> Optional[np.ndarray]:
        """Blocking pop of one complex64 block; None on EOF with an empty
        ring (or after close()), raises TimeoutError if no producer
        delivers in time.  Every native call takes the handle lock so a
        concurrent close() cannot free the handle mid-call."""
        out = np.empty(self.block_len, dtype=np.complex64)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        t0 = time.monotonic()
        while True:
            with self._h_lock:
                if not self._h:
                    return None
                if self._lib.sdr_ingest_pop(self._h, ptr):
                    return out
                done = (self._lib.sdr_ingest_eof(self._h) and
                        self._lib.sdr_ingest_pending(self._h) == 0)
            if done:
                return None
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("ingest: no data from producer")
            time.sleep(0.0005)

    def drained(self) -> bool:
        """Whether the producer hung up and every block it sent has been
        popped (what makes pop_block return None)."""
        with self._h_lock:
            return bool(not self._h or (
                self._lib.sdr_ingest_eof(self._h) and
                self._lib.sdr_ingest_pending(self._h) == 0))

    def pending(self) -> int:
        """Blocks in the ring, not yet popped."""
        with self._h_lock:
            return int(self._lib.sdr_ingest_pending(self._h)) \
                if self._h else 0

    @property
    def stats(self) -> dict:
        with self._h_lock:
            if not self._h:
                return {"blocks_received": 0, "overflows": 0,
                        "fragments": 0, "padded": 0}
            return {name: int(getattr(self._lib, f"sdr_ingest_{name}")(
                self._h)) for name in ("blocks_received", "overflows",
                                       "fragments", "padded")}

    def connected(self) -> bool:
        with self._h_lock:
            return bool(self._h and self._lib.sdr_ingest_connected(self._h))

    def close(self) -> None:
        with self._h_lock:
            if self._h:
                self._lib.sdr_ingest_destroy(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeSyncServer:
    """The data plane backed by the C++ streamer: a native thread drains
    a lock-free ring of framed packets to the one connected client.

    Same surface as network.SyncServer: start()/push()/flush()/close(),
    `port`; `stats` counts the packets and bytes sent.  The ring's slots
    start at `slot_bytes` and grow on a larger push
    (native/spsc_ring.hpp)."""

    def __init__(self, port: int = wire.SYNC_PORT,
                 slot_bytes: int = 8 * 2_000_000 + wire.HEADER_SIZE,
                 queue_len: int = 64):
        lib = load_library("stream")
        self._lib = lib
        self._h_lock = threading.Lock()   # close() vs drop_client() race
        self._h = lib.sdr_stream_server_create(port, slot_bytes, queue_len)
        if not self._h:
            raise RuntimeError(f"cannot bind native streamer to port {port}")
        self.port = lib.sdr_stream_server_port(self._h)

    def start(self) -> None:
        pass  # the native worker thread starts at create time

    def push(self, meta, data: np.ndarray, timeout: float = 5.0) -> bool:
        fe = meta.front_end_code
        if len(fe) == 1:
            fe = {"A": "A_RX2", "B": "B_RX2"}[fe]
        code = wire.FRONT_END_CODES.get(fe, b"B")
        buf = wire.encode_sync_packet(meta.usrp_number, code,
                                      meta.packet_number, meta.errors,
                                      meta.channels, data)
        t0 = time.monotonic()
        while True:
            # per-iteration handle lock: a force-stop can close() while a
            # worker thread is mid-push
            with self._h_lock:
                if not self._h:
                    return False
                if self._lib.sdr_stream_server_push(self._h, buf,
                                                    len(buf)):
                    return True
            if time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.001)

    def drop_client(self) -> None:
        """Close the current client so a reconnecting one is accepted
        (wired to the command plane's disconnect, like the reference's
        reconnect_data flag).  Tolerates a call after close(): the
        handle is read and used under a lock shared with close()."""
        with self._h_lock:
            if self._h:
                self._lib.sdr_stream_server_drop_client(self._h)

    def wait_client(self, timeout: Optional[float] = None) -> bool:
        t0 = time.monotonic()
        while True:
            with self._h_lock:
                if self._h and \
                        self._lib.sdr_stream_server_connected(self._h):
                    return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.01)

    def flush(self, timeout: float = 10.0) -> None:
        t0 = time.monotonic()
        while True:
            with self._h_lock:
                if not self._h or \
                        self._lib.sdr_stream_server_pending(self._h) <= 0:
                    return
            if time.monotonic() - t0 > timeout:
                return
            time.sleep(0.005)

    @property
    def stats(self) -> dict:
        with self._h_lock:
            if not self._h:
                return {"packets_sent": 0, "bytes_sent": 0}
            return {
                "packets_sent": int(
                    self._lib.sdr_stream_server_packets_sent(self._h)),
                "bytes_sent": int(
                    self._lib.sdr_stream_server_bytes_sent(self._h)),
            }

    def close(self) -> None:
        with self._h_lock:
            if self._h:
                self._lib.sdr_stream_server_destroy(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
