"""Chirp mode of the lock-in kernel (csrc/lockin.cu: #18 ``lockin_at``,
#19 ``fused_chirp_lockin``) against variants of itself on one CUDA card:
each variant is this checkout's lockin.cu with named text edits, built
side by side (one nvcc each, all at once) into its own library, held to
the bars below, and timed as kernel_times times the kernels (calls queued
behind a device sleep): #18 at config 2's 6,000,000-sample blocks (300
segments of 20,000) over the blocks of an 8-block recording in turn, at
rotating stream positions, and #19 at its 4,000,000-sample blocks (200
segments) over the same memory, in the order given, then reversed,
beside ``read``, a torch.sum over the rows of one 6M-sample block (the
same 48 MB read).

    python -m gpu_sdr_tpu_torch.bench.lockin_variants [--base TREE]
        [--sass] [NAME[+NAME...] ...]

With --base, TREE's own lockin.cu (the same C interface) is built and
timed first as ``base``.  With --sass, each library's chirp-mode loops
are read from its SASS (cuobjdump): every backward branch's span, its
instruction count and its opcodes, and the fast path of the widest (the
main loop): the instructions one iteration issues where no step's end
is reached and every column is live.  The bars, for each variant whose
output is the lock-in's: the oscillator read straight (ppt 1, a unit
profile and a signal of ones give y = conj(c)) at 2,000,000 positions
across the period's seam, >= 90 dB against float64, with its SNR
printed (the oscillator's choice is made by it); #18's points at three
positions >= 90 dB against float64; the chirp itself locked in within
1e-5 of 1; two launches the same bits.  The variants (no names: all):

    kernel            the kernel as built
    sincos_accurate   the oscillator by sincosf of the float32 th, not
                      __sincosf (MUFU)
    sincos_poly       the oscillator from the integer phase: its top bits
                      pick the nearest quarter turn, Cephes' minimax
                      polynomials for sinf / cosf give the rest
    threads_128       128 threads a block, not 256
    threads_512       512
    unroll_2          two column vectors' loads a thread at once, not four
    unroll_8          eight

Names joined by "+" make one variant of all their edits.

Parts knocked out, their output not the lock-in's (timed only):

    no_osc            the oscillator a constant (the loads alone)
    no_x              the signal taken from a register, not loaded (the
                      arithmetic alone; the profile still loaded)
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .chain_variants import snr_db, variant_source

OSC_MUFU = """\
__device__ __forceinline__ float2 osc(const Chirp& ch, unsigned idx) {
    const float th = ch.pi * __fmul_rn((float)(int)idx, ch.inv);
    float s, c;
    __sincosf(th, &s, &c);
    return make_float2(s, -c);
}"""
# the nearest quarter turn qd and the rest r, |r| <= 2^29 (1/8 turn); sin
# and cos of x = r*pi/2^31 (|x| <= pi/4), signs and roles from qd
OSC_POLY = """\
__device__ __forceinline__ float2 osc(const Chirp&, unsigned idx) {
    const unsigned qd = (idx + 0x20000000u) >> 30;
    const int r = (int)(idx - (qd << 30));
    const float x = (float)r * 1.46291807926715968e-9f;
    const float x2 = x * x;
    const float sp = fmaf(fmaf(fmaf(-1.9515295891e-4f, x2, 8.3321608736e-3f),
                               x2, -1.6666654611e-1f), x2 * x, x);
    const float cp = fmaf(fmaf(fmaf(2.443315711809948e-5f, x2,
                                    -1.388731625493765e-3f), x2,
                               4.166664568298827e-2f), x2 * x2,
                          fmaf(-0.5f, x2, 1.f));
    const float sn = (qd & 1u) ? cp : sp;
    const float cs = (qd & 1u) ? sp : cp;
    return make_float2((qd & 2u) ? -sn : sn, ((qd + 1u) & 2u) ? cs : -cs);
}"""
OSC = ("                const float2 ca = osc(ch, a);\n"
       "                B::mix(ca, V == 2 ? osc(ch, b) : ca,")
LOAD = "xv[u] = c < cols ? B::load(x, c) : B::zero();"
EDITS = {
    "kernel": [],
    "sincos_accurate": [("    __sincosf(th, &s, &c);",
                         "    sincosf(th, &s, &c);")],
    "sincos_poly": [(OSC_MUFU, OSC_POLY)],
    "threads_128": [("kChirpThreads = 256;", "kChirpThreads = 128;")],
    "threads_512": [("kChirpThreads = 256;", "kChirpThreads = 512;")],
    "unroll_2": [("kChirpUnroll = 4;", "kChirpUnroll = 2;")],
    "unroll_8": [("kChirpUnroll = 4;", "kChirpUnroll = 8;")],
    "no_osc": [(OSC, "                const float2 ca = make_float2(1.f, "
                "0.f);\n                B::mix(ca, ca,")],
    "no_x": [(LOAD, "xv[u] = B::zero(); xv[u].x = __int_as_float(c);")],
}
KNOCKED_OUT = ("no_osc", "no_x")
R_BLOCKS = 8
AT_NSEG, CL_NSEG = 300, 200               # #18's and #19's segments
OSC_N = 2_000_000                         # oscillator samples read straight
POSITIONS = (0, 12_345, 98_000_000)       # #18's checked stream positions


def build_all(sources: dict, out_dir: Path) -> dict:
    """{name: lockin.cu text} -> {name: (ctypes library, its path)},
    built in parallel; prints ptxas's register and spill lines of each."""
    from gpu_sdr_tpu_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)

    def nvcc(item):
        name, text = item
        src = out_dir / f"lockin_{name}.cu"
        lib = src.with_suffix(".so")
        src.write_text(text)
        p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                            "-o", str(lib), str(src)],
                           capture_output=True, text=True, timeout=600)
        return name, lib, p
    libs = {}
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cu, fl = ctypes.c_uint, ctypes.c_float
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
            cdll.sdr_lockin_at.argtypes = [vp] * 3 + [ll, ci, ci] + \
                [cu] * 5 + [fl, fl, vp]
            cdll.sdr_lockin_at.restype = ci
            libs[name] = (cdll, lib)
    return libs


def fast_path(code: list, lo: int, hi: int) -> tuple:
    """(instructions, opcodes) of one iteration of the loop [lo, hi]
    (its backward branch at hi) on its fast path: a forward ``@!P BRA``
    (the walk's or the parent's range reduction's "nothing to resolve"
    test) and an unconditional BRA taken, a forward ``@P BRA`` (a column
    guard) not taken."""
    at = {a: i for i, (a, _) in enumerate(code)}
    i, ops = at[lo], collections.Counter()
    while True:
        addr, ins = code[i]
        ops[opcode(ins)] += 1
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if addr == hi:
            return sum(ops.values()), dict(ops.most_common())
        if m and (not ins.startswith("@") or ins.startswith("@!P")):
            target = int(m.group(1), 16)
            if target < addr:
                raise ValueError(f"backward branch at {addr:#x} inside the "
                                 "loop's fast path")
            i = at[target]
        else:
            i += 1


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]


def sass_loops(lib: Path) -> dict:
    """{function: ([(first, last, instructions, opcodes), ...], the main
    loop's fast path)}: each backward branch of the library's chirp-mode
    kernels (the parent's lockin_kernel<kChirp>, chirp_kernel) and the
    span it closes, from cuobjdump's SASS (written whole beside the
    library, .sass)."""
    from gpu_sdr_tpu_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    out, name, code = {}, None, []
    lib.with_suffix(".sass").write_text(text)

    def close():
        if name and ("chirp_kernel" in name or "ModeE2E" in name):
            loops = []
            for addr, ins in code:
                m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
                if m and int(m.group(1), 16) < addr:
                    lo = int(m.group(1), 16)
                    body = [i for a, i in code if lo <= a <= addr]
                    ops = collections.Counter(opcode(i) for i in body)
                    loops.append((hex(lo), hex(addr), len(body),
                                  dict(ops.most_common())))
            main = max(loops, key=lambda lp: lp[2])
            out[name] = (loops, fast_path(code, int(main[0], 16),
                                          int(main[1], 16)))
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, code = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def main(argv) -> int:
    import torch
    from gpu_sdr_tpu_torch.kernel_times import card, time_ms
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops import chirp as chirp_ops
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.probe import C_RATE, CONFIG2
    base, sass = None, False
    while argv[:1] in (["--base"], ["--sass"]):
        if argv[0] == "--base":
            base, argv = argv[1], argv[2:]
        else:
            sass, argv = True, argv[1:]
    names = argv or list(EDITS)
    own = (Path(build.__file__).resolve().parent.parent / "csrc" /
           "lockin.cu").read_text()
    sources = {n: variant_source(own, [e for part in n.split("+")
                                       for e in EDITS[part]])
               for n in names}
    if base:
        sources = {"base": (Path(base) / "gpu_sdr_tpu_torch" / "csrc" /
                            "lockin.cu").read_text(), **sources}
    print(card(), flush=True)
    libs = build_all(sources, build.BUILD_DIR / "lockin_variants")
    if sass:
        for name, (_, path) in libs.items():
            for fn, (loops, (n, ops)) in sass_loops(path).items():
                print(f"{name}: SASS {fn}: loops (first, last, "
                      f"instructions, opcodes) {loops}; the main loop's "
                      f"fast path {n} instructions an iteration {ops}",
                      flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cfg = chirp_ops.ChirpConfig.from_params(
        CONFIG2["freq"][0], CONFIG2["chirp_f"][0], C_RATE,
        CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0])
    ppt = cfg.length
    wp = torch.from_numpy(lockin_profile(ppt)).to(dev)
    X = torch.randn((R_BLOCKS * AT_NSEG, ppt), dtype=torch.complex64,
                    device=dev)
    out = torch.empty(AT_NSEG, dtype=torch.complex64, device=dev)

    def run(name, x, w, nseg, row0, last, o=out):
        rc = libs[name][0].sdr_lockin_at(
            x.data_ptr(), w.data_ptr(), o.data_ptr(), row0, nseg,
            w.shape[0], cfg.period, cfg.length, cfg.chirpness & chirp_ops.M32,
            cfg.f0 & chirp_ops.M32, last % cfg.period, chirp_ops.PI_F32,
            chirp_ops.INV_2_31_5, stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def chirp64(last, n):
        idx = chirp_ops.chirp_phase_index(cfg, last, torch.arange(
            n, dtype=torch.int64, device=dev)).double()
        th = np.pi * idx / 2147483647.5
        return torch.complex(torch.sin(th), -torch.cos(th))
    # the oscillator read straight, across the seam
    o_last = cfg.period - OSC_N // 2
    ones = torch.ones((OSC_N, 1), dtype=torch.complex64, device=dev)
    unit = torch.ones(1, dtype=torch.float32, device=dev)
    osc_out = torch.empty(OSC_N, dtype=torch.complex64, device=dev)
    osc_ref = chirp64(o_last, OSC_N).conj().cpu().numpy()
    w64 = wp.double()
    ok = True
    for name in libs:
        exact = not set(name.split("+")) & set(KNOCKED_OUT)
        run(name, ones, unit, OSC_N, 0, o_last, osc_out)
        s_osc = snr_db(osc_ref, osc_out.cpu().numpy().astype(np.complex128))
        s_pts = []
        for i, pos in enumerate(POSITIONS):
            run(name, X, wp, AT_NSEG, i * AT_NSEG, pos)
            y = out.clone()
            run(name, X, wp, AT_NSEG, i * AT_NSEG, pos)
            same = torch.equal(y, out)
            rows = X[i * AT_NSEG:(i + 1) * AT_NSEG].to(torch.complex128)
            ref = (chirp64(pos, AT_NSEG * ppt).reshape(AT_NSEG, ppt).conj()
                   * rows) @ w64.to(torch.complex128)
            s_pts.append(snr_db(ref.cpu().numpy(),
                                y.cpu().numpy().astype(np.complex128)))
            ok &= same or not exact
        c = chirp_ops.chirp_block(cfg, POSITIONS[-1], AT_NSEG * ppt,
                                  device=dev)[1].reshape(AT_NSEG, ppt)
        run(name, c, wp, AT_NSEG, 0, POSITIONS[-1])
        off = float((out - 1).abs().max())
        good = s_osc >= 90 and min(s_pts) >= 90 and off <= 1e-5
        ok &= good or not exact
        print(f"{name}: oscillator {s_osc:.1f} dB against float64 over "
              f"{OSC_N} samples; #18 points {', '.join(f'{s:.1f}' for s in s_pts)}"
              f" dB; |y - 1| on the chirp {off:.2e}"
              + ("" if exact else " (its output is not the lock-in's)"),
              flush=True)
        del c
    rot = itertools.count()
    Y = X.view(R_BLOCKS, AT_NSEG * ppt)[:, :CL_NSEG * ppt]

    def at18(name):
        i = next(rot)
        run(name, X, wp, AT_NSEG, (i % R_BLOCKS) * AT_NSEG,
            (i * AT_NSEG * ppt) % cfg.period)

    def at19(name):
        i = next(rot)
        run(name, Y[i % R_BLOCKS], wp, CL_NSEG, 0,
            (i * CL_NSEG * ppt) % cfg.period)
    times = {"read": []}
    for name in list(libs) + list(libs)[::-1]:
        a = time_ms(lambda: at18(name))
        b = time_ms(lambda: at19(name))
        times.setdefault(name, []).append(
            (float(np.median(a)), float(np.median(b))))
        print(f"{name}: lockin_at median {np.median(a):.4f} ms, "
              f"chirp_lockin median {np.median(b):.4f} ms", flush=True)
        r = time_ms(lambda: torch.sum(X[(next(rot) % R_BLOCKS) * AT_NSEG:][
            :AT_NSEG].view(torch.float32), dim=1))
        times["read"].append(float(np.median(r)))
    print("read (torch.sum over the rows of a 6M-sample block): " + ", ".join(
        f"{v:.4f}" for v in times.pop("read")))
    print(" ".join(f"{k} " + " / ".join(f"{a:.4f}, {b:.4f}" for a, b in vs)
                   for k, vs in times.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
