"""Build ``csrc/*.cu`` with nvcc into one shared library and load it
with ctypes.

The sources are compiled at first use, for ``sm_90a`` (Hopper), into
``gpu_sdr_tpu_torch/_build/``: one ``nvcc -c`` per source, all started
together, then one link, so the build takes about as long as its
slowest source (3.1-3.7 s for the first four on an H100 host, against
8.3-9.0 s for one nvcc call over them).  The library's file name
carries a hash of the sources and the flags, so an unchanged checkout
reuses its build and an edited source rebuilds.  Each C entry point
takes device pointers and PyTorch's current stream as ``void*``,
launches, and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.  Nothing here synchronizes.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("presum.cu", "channelizer.cu", "ddc.cu", "fold.cu",
           "lockin.cu")
HEADERS = ("rows.cuh",)               # included by the sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# what the last build in this process took and printed (None: the
# library came from an earlier build of the same sources)
build_seconds = None
build_log = ""


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            p = Path(root) / "bin" / "nvcc"
            if p.is_file():
                return str(p)
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return p


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsdr_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_seconds, build_log
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{Path(s).stem}.o") for s in SOURCES]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(CSRC_DIR / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        rcs.append(link.returncode)
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if any(rcs):
        raise RuntimeError(f"nvcc failed (exit codes {rcs} for {SOURCES} "
                           f"and the link):\n{build_log}")
    os.replace(tmp, out)
    return out


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, fl, cu = ctypes.c_longlong, ctypes.c_float, ctypes.c_uint
    # row offsets and row counts of a recording are 64-bit (c_longlong)
    lib.sdr_presum.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.sdr_presum.restype = ci
    lib.sdr_presum_at.argtypes = [vp, vp, vp, ll, ll, ci, ci, ci, ci, vp]
    lib.sdr_presum_at.restype = ci
    lib.sdr_channelizer.argtypes = [vp, vp, vp, vp, vp, vp,
                                    ci, ci, ci, ci, ci, vp]
    lib.sdr_channelizer.restype = ci
    lib.sdr_channelizer_at.argtypes = [vp, vp, vp, vp, vp, ll, ll,
                                       ci, ci, ci, ci, ci, vp]
    lib.sdr_channelizer_at.restype = ci
    lib.sdr_channelizer_frame_tile.argtypes = []
    lib.sdr_channelizer_frame_tile.restype = ci
    lib.sdr_ddc.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ci, ci, ci, ci,
                            ci, fl, ci, vp]
    lib.sdr_ddc.restype = ci
    lib.sdr_fold.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sdr_fold.restype = ci
    lib.sdr_fold_tile.argtypes = []
    lib.sdr_fold_tile.restype = ci
    lib.sdr_lockin.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, vp]
    lib.sdr_lockin.restype = ci
    lib.sdr_lockin_at.argtypes = [vp, vp, vp, ll, ci, ci, cu, cu, cu, cu, cu,
                                  fl, fl, vp]
    lib.sdr_lockin_at.restype = ci
    lib.sdr_error_string.argtypes = [ci]
    lib.sdr_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = _lib.sdr_error_string(rc).decode() if _lib else "?"
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
