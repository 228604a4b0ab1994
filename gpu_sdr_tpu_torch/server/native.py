"""ctypes binding to the native TCP ingest receiver
(native/stream_ingest.cpp), the ingest half of
gpu_sdr_tpu/server/native.py.

The port builds its own copy of the library from the checkout's sources
at first use: ``g++ -O3 -shared -fPIC -pthread -Inative`` into
``gpu_sdr_tpu_torch/_build/``, under a name hashed from the sources and
the flags, so an unchanged checkout reuses its build.  The compiler
writes a temporary name that ``os.replace`` then moves into place, so
processes that build at once (test workers) never load a half-written
file.  A failed build raises; there is no fallback, and the JAX
package's CMake build (native/build/) is never read.
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

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("stream_ingest.cpp", "spsc_ring.hpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib = None
# whether this process compiled the library (False: an earlier build of
# the same sources was loaded)
built_here = False


def library_path() -> Path:
    """The library of this checkout's sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libsdr_ingest_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/stream_ingest.cpp unless a library of the same
    hash exists; raise if g++ fails."""
    global built_here
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native ingest receiver is "
                           "built from native/stream_ingest.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(
        [cxx, *CXX_FLAGS, f"-I{NATIVE_DIR}", "-o", str(tmp),
         str(NATIVE_DIR / SOURCES[0])], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{SOURCES[0]} (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    built_here = True
    return out


def _bind(lib) -> None:
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


def load_library() -> ctypes.CDLL:
    """The loaded ingest library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


class NativeIngest:
    """ctypes handle to the C++ TCP ingest receiver: a producer connects
    and streams raw complex64 bytes; a native thread reassembles
    fixed-size blocks into an SPSC ring popped here.

    The native counterpart of the reference's UHD RX thread + rx_queue
    (single_rx_thread, cpp/USRP_hardware_manager.cpp:1398-1611)."""

    def __init__(self, block_len: int, port: int = 0, queue_len: int = 16):
        lib = load_library()
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
