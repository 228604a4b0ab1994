"""The chain kernel (csrc/chain.cu, #15) against variants of itself on
one CUDA card: each variant is this checkout's chain.cu with named text
edits, built side by side (one nvcc each, all at once) into its own
library, held against the plain version in float64 at config 3's shard
(20,000 rows of shard 1 of 2, f 4) where it computes the same function,
and timed as kernel_times times the kernels (calls queued behind a device
sleep), in the order given, then reversed.

    python -m gpu_sdr_tpu_torch.bench.chain_variants [--base TREE] [NAME ...]

With --base, TREE's own chain.cu is built and timed first as ``base``.
The variants (no names: all of them):

    kernel          the chain as built
    no_unroll       the k-loop not unrolled
    late_loads      the epilogue's ramp and rotation loads beside their
                    stores, not all issued first
    8_warps         8 warps of up to 13 column fragments, not 16 of 7
    even_shares     each block an even share of the rows in tiles of 64
                    (a shorter last tile), each sub-partition one warp of
                    each row group and channel group
    no_g_stream     G's first item only, never streamed (wrong results)
    no_row_stream   the rows staged for the first tile only (wrong)
    no_product      the tensor-core product left out (wrong)
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

MAINLOOP = "tc::mainloop<false, false, kNF, 2>("
EDITS = {
    "kernel": [],
    "no_unroll": [(MAINLOOP, "tc::mainloop<false, false, kNF, 1>(")],
    "late_loads": [("rp[q][h]), d[q]);", "ramp[(long long)r * Cp + c0 + ch]),"
                    " drot[c0 + ch]);")],
    "8_warps": [("kWarpsN = 4;", "kWarpsN = 2;"), ("kNF = 7;", "kNF = 13;")],
    "even_shares": [
        ("    int tile, p, kc, j, s;", "    int n0, p, kc, j, s;"),
        ("    const int npass = kDeep ? (f + J - 1) / J : 1;\n"
         "    const int nt = (nbt + kTile - 1) / kTile;\n",
         "    const int npass = kDeep ? (f + J - 1) / J : 1;\n"
         "    const int lo = (int)((long long)blockIdx.x * nbt / gridDim.x);\n"
         "    const int nt = (int)((long long)(blockIdx.x + 1) * nbt /"
         " gridDim.x);\n"),
        ("    const int wm = warp & 3, wn = warp >> 2;\n",
         "    const int wn = warp >> 2, wm = (warp & 3) ^ wn;\n"),
        ("    const int nfh = (pl.CN / 4 + kWarpsN - 1) / kWarpsN;"
         "   // at most kNF\n"
         "    const int jn0 = wn * nfh;\n"
         "    const int nfw = min(nfh, pl.CN / 4 - jn0);\n",
         "    const int nf = pl.CN / 4, rem = nf % kWarpsN;\n"
         "    const int nfw = nf / kWarpsN + (wn < rem);\n"
         "    const int jn0 = wn * (nf / kWarpsN) + min(wn, rem);\n"),
        ("        c.tile += gridDim.x;", "        c.n0 += kTile;"),
        ("        const int r0 = c.tile * kTile - lead + c.p * J;\n",
         "        const int r0 = c.n0 - lead + c.p * J;\n", 2),
        ("    Cursor c{(int)blockIdx.x, 0, 0, 0, 0};\n"
         "    if (c.tile >= nt) return;",
         "    Cursor c{lo, 0, 0, 0, 0};\n    if (lo >= nt) return;"),
        ("if (n.tile < nt) issue_g", "if (n.n0 < nt) issue_g"),
        ("if (r.tile < nt) stage_rows", "if (r.n0 < nt) stage_rows"),
        ("        if (nfw > 0) {\n",
         "        if (nfw > 0 && c.n0 + wm * 16 < nt) {\n"),
        ("if (n.tile != c.tile) {", "if (n.n0 != c.n0) {"),
        ("const int n0 = c.tile * kTile + wm * 16 + g;",
         "const int n0 = c.n0 + wm * 16 + g;"),
        ("rp[q][h] = live && r < nbt", "rp[q][h] = live && r < nt"),
        ("                        if (r < nbt)\n",
         "                        if (r < nt)\n"),
        ("if (n.tile >= nt) break;", "if (n.n0 >= nt) break;")],
    "no_g_stream": [
        ("        if (n.tile < nt) issue_g(ring + (gb ^ 1) * gfl, n);\n", ""),
        ("    issue_g(ring, c);\n",
         "    issue_g(ring, c);\n    issue_g(ring + gfl, c);\n")],
    "no_row_stream": [
        ("            if (r.tile < nt) stage_rows(rows + (eb ^ 1) * efl, r);\n",
         ""),
        ("        if (first) rotate_rows(e, c);",
         "        if (first && c.tile == (int)blockIdx.x) rotate_rows(e, c);"),
        ("    stage_rows(rows, c);\n",
         "    stage_rows(rows, c);\n    stage_rows(rows + efl, c);\n")],
    "no_product": [(MAINLOOP, "if (c.tile < 0) " + MAINLOOP)],
}
# the variants whose output is the chain's and is held to the bar
EXACT = ("kernel", "no_unroll", "late_loads", "8_warps", "even_shares")


def variant_source(text: str, edits) -> str:
    """`text` with each (old, new[, times]) edit made; `old` must occur
    exactly `times` (default 1) times."""
    for old, new, *times in edits:
        if text.count(old) != (times or [1])[0]:
            raise ValueError(f"edit anchor found {text.count(old)} times: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def snr_db(ref, test) -> float:
    err = np.linalg.norm(ref - test)
    return float("inf") if err == 0 else \
        float(20 * np.log10(np.linalg.norm(ref) / err))


def build_all(sources: dict, out_dir: Path) -> dict:
    """{name: chain.cu text} -> {name: ctypes library}, built in parallel;
    prints ptxas's register and spill lines of each."""
    from gpu_sdr_tpu_torch.kernels import build
    csrc = Path(build.__file__).resolve().parent.parent / "csrc"
    out_dir.mkdir(parents=True, exist_ok=True)

    def nvcc(item):
        name, text = item
        src, lib = out_dir / f"chain_{name}.cu", out_dir / f"chain_{name}.so"
        src.write_text(text)
        p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                            "-I", str(csrc), "-o", str(lib), str(src)],
                           capture_output=True, text=True, timeout=600)
        return name, lib, p
    libs = {}
    with ThreadPoolExecutor(len(sources)) as ex:
        for name, lib, p in ex.map(nvcc, sources.items()):
            lines = [ln.split("info    :")[-1].strip()
                     for ln in p.stderr.splitlines()
                     if "Used" in ln or "spill" in ln]
            print(f"{name}: nvcc rc {p.returncode}; {lines}", flush=True)
            if p.returncode:
                raise RuntimeError(f"{name}: {p.stderr[-2000:]}")
            cdll = ctypes.CDLL(str(lib))
            cdll.sdr_chain.argtypes = [ctypes.c_void_p] * 8 + \
                [ctypes.c_int] * 4 + [ctypes.c_void_p]
            cdll.sdr_chain.restype = ctypes.c_int
            libs[name] = cdll
    return libs


def main(argv) -> int:
    import torch
    from gpu_sdr_tpu_torch.kernel_times import card, time_ms
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain, chain_plain
    from gpu_sdr_tpu_torch.probe import (CONFIG3, D_AVG, D_BLOCK, D_DECIM,
                                         D_RATE)
    base = None
    if argv[:1] == ["--base"]:
        base, argv = argv[1], argv[2:]
    names = argv or list(EDITS)
    own = (Path(build.__file__).resolve().parent.parent / "csrc" /
           "chain.cu").read_text()
    sources = {n: variant_source(own, EDITS[n]) for n in names}
    if base:
        sources = {"base": (Path(base) / "gpu_sdr_tpu_torch" / "csrc" /
                            "chain.cu").read_text(), **sources}
    print(card(), flush=True)
    libs = build_all(sources, build.BUILD_DIR / "chain_variants")
    dev = torch.device("cuda", 0)
    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * len(CONFIG3))
    ch = TonesDirectChain(D_RATE, tuple(CONFIG3), (0.01,) * 100, cfg,
                          D_BLOCK, time_shards=2)
    nbt = ch.nb // 2
    _, srot, _, drot = ch.block_rotations(ch.init_state(dev))
    args = (ch.P[nbt:].to(dev), ch.halo_rows(nbt).to(dev), ch.G.to(dev),
            ch.ramp[nbt:].to(dev), srot, srot, drot)
    f, Ct, Cp = ch.G.shape
    out = torch.empty((nbt, Cp), dtype=torch.complex64, device=dev)

    def run(lib):
        rc = lib.sdr_chain(*(t.data_ptr() for t in args), out.data_ptr(),
                           nbt, Ct, Cp, f,
                           torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"sdr_chain: CUDA error {rc}")
    ref = chain_plain(*(t.to(torch.complex128) for t in args)).cpu().numpy()
    ok = True
    for name, lib in libs.items():
        run(lib)
        s = snr_db(ref, out.cpu().numpy().astype(np.complex128))
        exact = name == "base" or name in EXACT
        ok &= s >= 90 or not exact
        print(f"{name}: {s:.1f} dB against float64"
              + ("" if exact else " (its output is not the chain's)"),
              flush=True)
    times = {}
    for name in list(libs) + list(libs)[::-1]:
        t = time_ms(lambda: run(libs[name]))
        times.setdefault(name, []).append(float(np.median(t)))
        print(f"{name}: median {np.median(t):.4f} ms (min {min(t):.4f}, "
              f"max {max(t):.4f})", flush=True)
    print(" ".join(f"{k} {' / '.join(f'{v:.4f}' for v in vs)}"
                   for k, vs in times.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
