"""The pre-sum kernel (csrc/presum.cu: #2, #6) against variants of itself
on one CUDA card: each variant is this checkout's presum.cu with named
text edits, built side by side (one nvcc each, all at once) into its own
library, held against the float64 pre-sum at <= 1e-6 relative error on
a block of the TONES receiver (nfft 1000, avg 4, 6000 frames), and timed
as kernel_times times the kernels (calls queued behind a device sleep,
over the blocks of an 8-block recording in turn, so that each call reads
its rows from HBM): #2 streamed at nfft 1000 and #6 at the NOISE replay's
shape (nfft 1018, 5893 frames), in the order given, then reversed, beside
a ``copy_`` of the same bytes.

    python -m gpu_sdr_tpu_torch.bench.presum_variants [--base TREE]
        [NAME[+NAME...] ...]

With --base, TREE's own presum.cu (the same C interface) is built and
timed first as ``base``.  The variants (no names: all of them):

    kernel          the kernel as built
    rows_8 .. _64   8, 16, 24, 48 or 64 output rows a tile, not 32
    threads_128     128 threads a block (a strip of 128 columns), not 256
    threads_512     512
    flight_1        one row's loads issued at a time, not two
    flight_4        four rows' loads at a time
    stream_store    the output stored with the streaming hint (st.global
                    .cs), not a plain store
    unroll_2        the walk's steps unrolled twice
    l2_256          the wide body's loads not allocated in L1, with a
                    256-byte L2 prefetch (ld.global.nc.L1::no_allocate
                    .L2::256B), not __ldg

Names joined by "+" make one variant of all their edits (rows_32+flight_4).

Parts knocked out, their output not the pre-sum's (timed only):

    no_loads        no row is read (the stores of zeros alone)
    no_stores       no output is stored (the loads and sums alone)
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .chain_variants import variant_source

LOAD = "return row != nullptr ? B::load(row, c) : B::zero();"
STORE = "            if (t + k < nt)\n"
STEPS = "    for (int t = 0; t < nt; t += kInFlight) {"
WIDE_LOAD = "return __ldg(reinterpret_cast<const float4*>(row) + c);"
EDITS = {
    "kernel": [],
    "rows_8": [("kRows = 32;", "kRows = 8;")],
    "rows_16": [("kRows = 32;", "kRows = 16;")],
    "rows_24": [("kRows = 32;", "kRows = 24;")],
    "rows_48": [("kRows = 32;", "kRows = 48;")],
    "rows_64": [("kRows = 32;", "kRows = 64;")],
    "threads_128": [("kThreads = 256;", "kThreads = 128;")],
    "threads_512": [("kThreads = 256;", "kThreads = 512;")],
    "flight_1": [("kInFlight = 2;", "kInFlight = 1;")],
    "flight_4": [("kInFlight = 2;", "kInFlight = 4;")],
    "stream_store": [("reinterpret_cast<float4*>(row)[c] = v;",
                      "__stcs(reinterpret_cast<float4*>(row) + c, v);")],
    "unroll_2": [(STEPS, "#pragma unroll 2\n" + STEPS)],
    "l2_256": [(WIDE_LOAD, "float4 v;\n        asm(\"ld.global.nc."
                "L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\" "
                ": \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), \"=f\"(v.w) : "
                "\"l\"(reinterpret_cast<const float4*>(row) + c));\n"
                "        return v;")],
    "no_loads": [(LOAD, "return B::zero();")],
    "no_stores": [(STORE, "            if (t + k < nt && acc.x == 1e30f)\n")],
}
KNOCKED_OUT = ("no_loads", "no_stores")
R_BLOCKS = 8
NOISE_NFFT, NOISE_FRAMES = 1018, 5893


def build_all(sources: dict, out_dir: Path) -> dict:
    """{name: presum.cu text} -> {name: ctypes library}, built in
    parallel; prints ptxas's register and spill lines of each."""
    from gpu_sdr_tpu_torch.kernels import build
    csrc = Path(build.__file__).resolve().parent.parent / "csrc"
    out_dir.mkdir(parents=True, exist_ok=True)

    def nvcc(item):
        name, text = item
        src = out_dir / f"presum_{name}.cu"
        lib = src.with_suffix(".so")
        src.write_text(text)
        p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                            "-I", str(csrc), "-o", str(lib), str(src)],
                           capture_output=True, text=True, timeout=600)
        return name, lib, p
    libs = {}
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    with ThreadPoolExecutor(len(sources)) as ex:
        for name, lib, p in ex.map(nvcc, sources.items()):
            lines = [ln.split("info    :")[-1].strip()
                     for ln in p.stderr.splitlines()
                     if "Function properties" in ln or "Used" in ln or
                     ("spill" in ln and " 0 bytes spill" not in ln)]
            print(f"{name}: nvcc rc {p.returncode}; {lines}", flush=True)
            if p.returncode:
                raise RuntimeError(f"{name}: {p.stderr[-2000:]}")
            cdll = ctypes.CDLL(str(lib))
            cdll.sdr_presum.argtypes = [vp] * 4 + [ci] * 3 + [vp]
            cdll.sdr_presum.restype = ci
            cdll.sdr_presum_at.argtypes = [vp] * 3 + [ll, ll] + [ci] * 4 + \
                [vp]
            cdll.sdr_presum_at.restype = ci
            libs[name] = cdll
    return libs


def main(argv) -> int:
    import torch
    from gpu_sdr_tpu_torch.kernel_times import card, time_ms
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.probe import AVG, FRAMES, NFFT, RATE
    base = None
    if argv[:1] == ["--base"]:
        base, argv = argv[1], argv[2:]
    names = argv or list(EDITS)
    own = (Path(build.__file__).resolve().parent.parent / "csrc" /
           "presum.cu").read_text()
    sources = {n: variant_source(own, [e for part in n.split("+")
                                       for e in EDITS[part]])
               for n in names}
    if base:
        sources = {"base": (Path(base) / "gpu_sdr_tpu_torch" / "csrc" /
                            "presum.cu").read_text(), **sources}
    print(card(), flush=True)
    libs = build_all(sources, build.BUILD_DIR / "presum_variants")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    w2 = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE).window(dev).reshape(
        AVG, NFFT)
    wn = PFBConfig(nfft=NOISE_NFFT, avg=AVG, rate=RATE).window(
        dev).reshape(AVG, NOISE_NFFT)
    X = torch.randn((R_BLOCKS * FRAMES, NFFT), dtype=torch.complex64,
                    device=dev)
    XN = torch.randn((R_BLOCKS * NOISE_FRAMES, NOISE_NFFT),
                     dtype=torch.complex64, device=dev)
    out = torch.empty((FRAMES, NFFT), dtype=torch.complex64, device=dev)
    outn = torch.empty((NOISE_FRAMES, NOISE_NFFT), dtype=torch.complex64,
                       device=dev)
    rot = itertools.count()

    def streamed(name, i):
        rc = libs[name].sdr_presum(
            X[i * FRAMES:].data_ptr(), X.data_ptr(), w2.data_ptr(),
            out.data_ptr(), FRAMES, NFFT, AVG, stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def recorded(name, i):
        rc = libs[name].sdr_presum_at(
            XN.data_ptr(), wn.data_ptr(), outn.data_ptr(), XN.shape[0],
            i * NOISE_FRAMES, NOISE_FRAMES, NOISE_NFFT, AVG, 1, stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    w64 = w2.to(torch.float64)
    ext = torch.cat([X[:AVG - 1], X[FRAMES:2 * FRAMES]]).to(torch.complex128)
    ref = sum(w64[i] * ext[i:i + FRAMES] for i in range(AVG))
    ok = True
    for name in libs:
        streamed(name, 1)
        rel = float(torch.linalg.vector_norm(out - ref) /
                    torch.linalg.vector_norm(ref))
        exact = name not in KNOCKED_OUT
        ok &= rel <= 1e-6 or not exact
        print(f"{name}: relative error {rel:.3e} against float64"
              + ("" if exact else " (its output is not the pre-sum's)"),
              flush=True)
    dst, dstn = torch.empty_like(out), torch.empty_like(outn)
    times = {"copy": [], "copy_1018": []}
    for name in list(libs) + list(libs)[::-1]:
        a = time_ms(lambda: streamed(name, next(rot) % R_BLOCKS))
        b = time_ms(lambda: recorded(name, next(rot) % R_BLOCKS))
        times.setdefault(name, []).append(
            (float(np.median(a)), float(np.median(b))))
        print(f"{name}: presum median {np.median(a):.4f} ms, presum_at "
              f"1018 median {np.median(b):.4f} ms", flush=True)
        c = time_ms(lambda: dst.copy_(
            X[(next(rot) % R_BLOCKS) * FRAMES:][:FRAMES]))
        cn = time_ms(lambda: dstn.copy_(
            XN[(next(rot) % R_BLOCKS) * NOISE_FRAMES:][:NOISE_FRAMES]))
        times["copy"].append(float(np.median(c)))
        times["copy_1018"].append(float(np.median(cn)))
    print("copy_ of the same bytes: " + ", ".join(
        f"{a:.4f} / {b:.4f}" for a, b in zip(times.pop("copy"),
                                              times.pop("copy_1018"))))
    print(" ".join(f"{k} " + " / ".join(f"{a:.4f}, {b:.4f}" for a, b in vs)
                   for k, vs in times.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
