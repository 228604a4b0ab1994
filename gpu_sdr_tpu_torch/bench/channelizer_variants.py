"""The channelizer kernel (csrc/channelizer.cu: #1, #3, #4, #5) against
variants of itself on one CUDA card: each variant is this checkout's
channelizer.cu with named text edits, or its own radix plan, built side
by side (one nvcc each, all at once) into its own library, held against
the float64 PFB (the pre-sum and torch.fft in complex128) on a block of
the TONES receiver (nfft 1000, avg 4, 6000 frames), and timed in const
and stream mode (#1) as kernel_times times the kernels (calls queued
behind a device sleep, stream mode over the blocks of an 8-block
recording in turn), in the order given, then reversed.

    python -m gpu_sdr_tpu_torch.bench.channelizer_variants [--base TREE]
        [NAME ...]

With --base, TREE's own channelizer.cu (the same C interface and table
layout) is built and timed first as ``base``.  The variants (no names:
all of them):

    kernel          the kernel as built, ops/channelizer.fft_radices' plan
    plan_5558       the plan (5, 5, 5, 8) at nfft 1000, not (10, 10, 10)
    m_major         each pass's twiddles laid out [m][r], not [r][m]: a
                    warp's loads of one r strided by R-1 entries
    unrolled_avg    the folded pre-sum's loop over avg unrolled 4 times
    unfolded        the pre-sum a phase of its own, the first pass not
                    folded into it
    via_smem        the last pass into shared memory, then the store,
                    not straight to the output
    tile_2          two frames a block at nfft 1000 (32 KB), not four
    tile_3          three frames a block (48 KB)
    blocks_3        registers capped for three blocks an SM (85)
    no_16           no radix-16 butterfly (its registers set the kernel's)
    carveout_max    the most shared memory and the least L1 (28 KB), not
                    the default split

Parts knocked out, their output not the channelizer's (timed only):

    no_loads        the pre-sum reads nothing (its avg loop left out)
    presum_only     the folded pre-sum and first pass, then the store
    no_middle       the middle passes left out
    store_only      no pre-sum and no pass: the store of a tile
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .chain_variants import snr_db, variant_source

AVG_LOOP = ("        for (int i = 0; i < avg; ++i) {\n"
            "            const float2* row")
PASSES = "for (; p < plan.passes; ++p) {"
SMEM_ATTR = "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);"
EDITS = {
    "kernel": [],
    "plan_5558": [],
    "m_major": [("__ldg(tw + (r - 1) * ns + m)",
                 "__ldg(tw + m * (R - 1) + r - 1)"),
                ("__ldg(tw + (q - 1) * ns + m)",
                 "__ldg(tw + m * (R - 1) + q - 1)")],
    "unrolled_avg": [(AVG_LOOP, "#pragma unroll 4\n" + AVG_LOOP)],
    "unfolded": [("switch (plan.passes ? plan.radix[0] : 0) {",
                  "switch (0) {")],
    "via_smem": [("const bool last = !kScrambled && p == plan.passes - 1;",
                  "const bool last = false;")],
    "tile_2": [("SMEM_TILE = 73728;", "SMEM_TILE = 32768;")],
    "tile_3": [("SMEM_TILE = 73728;", "SMEM_TILE = 49152;")],
    "blocks_3": [("__launch_bounds__(NTHREADS)",
                  "__launch_bounds__(NTHREADS, 3)")],
    "no_16": [("        case 16: pass_r<16>(a, b, tw, nf, n, ns); break;\n",
               ""), ("SDR_PRESUM_PASS(16) ", "")],
    "carveout_max": [(SMEM_ATTR, SMEM_ATTR + "\n    if (e == cudaSuccess) "
                      "cudaFuncSetAttribute(channelizer_kernel<Src, "
                      "kScrambled>, cudaFuncAttributePreferredSharedMemory"
                      "Carveout, (int)cudaSharedmemCarveoutMaxShared);")],
    "no_loads": [(AVG_LOOP, AVG_LOOP.replace("i < avg", "i < 0"))],
    "presum_only": [(PASSES, "for (p = plan.passes; p < plan.passes; ++p) {")],
    "no_middle": [(PASSES,
                   "for (p = plan.passes - 1; p < plan.passes; ++p) {")],
    "store_only": [("int p = presum(src, w, t0, nf, n, avg, plan, table, "
                    "buf0);", "int p = plan.passes;")],
}
PLANS = {"plan_5558": (5, 5, 5, 8)}      # at nfft 1000; else the kernel's


def table_m_major(radices) -> np.ndarray:
    """ops/channelizer.fft_table with each pass's twiddles [m][r]."""
    parts, ns = [], 1
    for R in radices:
        m = np.arange(ns, dtype=np.float64)[:, None]
        r = np.arange(1, R, dtype=np.float64)[None, :]
        parts += [np.exp(-2j * np.pi * m * r / (ns * R)).ravel(),
                  np.exp(-2j * np.pi * np.arange(R) / R)]
        ns *= R
    return np.concatenate(parts).astype(np.complex64)


TABLES = {"m_major": table_m_major}
KNOCKED_OUT = ("no_loads", "presum_only", "no_middle", "store_only")


def build_all(sources: dict, out_dir: Path) -> dict:
    """{name: channelizer.cu text} -> {name: ctypes library}, built in
    parallel; prints ptxas's register and spill lines of each."""
    from gpu_sdr_tpu_torch.kernels import build
    csrc = Path(build.__file__).resolve().parent.parent / "csrc"
    out_dir.mkdir(parents=True, exist_ok=True)

    def nvcc(item):
        name, text = item
        src = out_dir / f"channelizer_{name}.cu"
        lib = out_dir / f"channelizer_{name}.so"
        src.write_text(text)
        p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                            "-I", str(csrc), "-o", str(lib), str(src)],
                           capture_output=True, text=True, timeout=600)
        return name, lib, p
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with ThreadPoolExecutor(len(sources)) as ex:
        for name, lib, p in ex.map(nvcc, sources.items()):
            lines = sorted({ln.split("info    :")[-1].strip()
                            for ln in p.stderr.splitlines()
                            if "Used" in ln or "spill" in ln})
            print(f"{name}: nvcc rc {p.returncode}; {lines}", flush=True)
            if p.returncode:
                raise RuntimeError(f"{name}: {p.stderr[-2000:]}")
            cdll = ctypes.CDLL(str(lib))
            cdll.sdr_channelizer.argtypes = [vp] * 4 + [
                ctypes.POINTER(ci), ci, vp, vp] + [ci] * 6 + [vp]
            cdll.sdr_channelizer.restype = ci
            libs[name] = cdll
    return libs


def main(argv) -> int:
    import torch
    from gpu_sdr_tpu_torch.kernel_times import card, time_ms
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops import channelizer as ch
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.probe import AVG, FRAMES, NFFT, RATE
    base = None
    if argv[:1] == ["--base"]:
        base, argv = argv[1], argv[2:]
    names = argv or list(EDITS)
    own = (Path(build.__file__).resolve().parent.parent / "csrc" /
           "channelizer.cu").read_text()
    sources = {n: variant_source(own, EDITS[n]) for n in names}
    if base:
        sources = {"base": (Path(base) / "gpu_sdr_tpu_torch" / "csrc" /
                            "channelizer.cu").read_text(), **sources}
    print(card(), flush=True)
    libs = build_all(sources, build.BUILD_DIR / "channelizer_variants")
    dev = torch.device("cuda", 0)
    w2, _, G = ch.channelizer_consts(PFBConfig(nfft=NFFT, avg=AVG,
                                               rate=RATE), dev)
    n1, n2 = G.shape[0], G.shape[1]
    X = torch.randn((8 * FRAMES, NFFT), dtype=torch.complex64, device=dev)
    out = torch.empty((FRAMES, NFFT), dtype=torch.complex64, device=dev)
    rot, stream = itertools.count(), torch.cuda.current_stream(dev)

    plans = {}
    for name in libs:
        radices = PLANS.get(name, ch.fft_radices(NFFT))
        table = TABLES.get(name, ch.fft_table)(radices)
        plans[name] = (torch.from_numpy(table).to(dev),
                       (ctypes.c_int * len(radices))(*radices), len(radices))

    def run(name, x, const):
        """One launch of `name` on x (a tensor, or a function giving one)."""
        table, c_radices, passes = plans[name]
        rc = libs[name].sdr_channelizer(
            (x() if callable(x) else x).data_ptr(), X.data_ptr(),
            w2.data_ptr(), table.data_ptr(), c_radices, passes,
            out.data_ptr(), None, 0, FRAMES, n1, n2, AVG, int(const),
            stream.cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    ext = torch.cat([X[:AVG - 1], X[AVG - 1:AVG - 1 + FRAMES]])
    w = w2.to(torch.float64)
    pre = sum(w[i] * ext[i:i + FRAMES].to(torch.complex128)
              for i in range(AVG))
    ref = torch.fft.fft(pre, dim=-1).cpu().numpy()
    ok = True
    for name in libs:
        run(name, X[AVG - 1:], False)
        s = snr_db(ref, out.cpu().numpy().astype(np.complex128))
        exact = name not in KNOCKED_OUT
        ok &= s >= 90 or not exact
        print(f"{name}: {s:.1f} dB against float64"
              + ("" if exact else " (its output is not the channelizer's)"),
              flush=True)

    def block():
        i = next(rot) % 8
        return X[i * FRAMES:]
    times = {}
    for name in list(libs) + list(libs)[::-1]:
        c = time_ms(lambda: run(name, X[:1], True))
        st = time_ms(lambda: run(name, block, False))
        times.setdefault(name, []).append(
            (float(np.median(c)), float(np.median(st))))
        print(f"{name}: const median {np.median(c):.4f} ms, stream median "
              f"{np.median(st):.4f} ms", flush=True)
    print(" ".join(f"{k} " + " / ".join(f"{a:.4f}, {b:.4f}" for a, b in vs)
                   for k, vs in times.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
