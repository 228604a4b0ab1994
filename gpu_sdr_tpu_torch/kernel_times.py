"""Device times of the channelizer (#1 const and stream, #3, #4, #5),
pre-sum (#2, #6), DDC (#7 in channel mode at config 3 and at a deep FIR,
#7 in row mode at config 1 and at a deep FIR, #8, #10), fold (#11-#14),
chain (#15) and lock-in (#16-#19) kernels at the main path's shapes,
and of the yardsticks beside them, for comparing two checkouts of the
port on one card.

    python -m gpu_sdr_tpu_torch.kernel_times
        one JSON line: the card, ptxas's register and spill lines for the
        kernels, and each kernel's device ms per call (median, min and
        max over 7 runs of 20 calls queued behind a device sleep)
    python -m gpu_sdr_tpu_torch.kernel_times --trees A B
        the line above from checkout A, then B, B and A, each in its own
        process with that checkout first on PYTHONPATH (each builds its
        own sources), then each kernel's times side by side
    python -m gpu_sdr_tpu_torch.kernel_times --cells A B [RUNS]
        the same order for the probe's cells that run those kernels
        (``E2E_CELLS``): TONES fused (#1), TONES host-fed (#2), TONES
        replay (#4) unsharded and on (1, 1) and (2, 1) meshes (#5),
        DIRECT config 3 fused (#11) unsharded and on a (2, 1) mesh,
        DIRECT config 3 replay (#8)
        unsharded and on a (2, 1) mesh (#10), DIRECT config 1 fused (#9,
        the DDC's row mode), CHIRP config 2 replay at 6M blocks (#18,
        ``chirp_at``), and config 3 host-fed at
        pf_average 400 (#7 at an 8000-tap FIR, ``DEEP_CELL``); each
        cell's RUNS rates (default 10; host clock) and profiled run
        (device busy share, device ms per block) from each checkout's own
        ``probe.probe_cell``, and the host's ms a block in the output
        fetch and the kernels' launch calls, then the medians side by
        side

Only wrappers that the port has had since its last five kernels
(``channelizer``, ``channelizer_scrambled``, ``channelizer_at``,
``channelizer_at_halo``, ``presum``, ``presum_at``, ``ddc_fused``,
``ReplayDDC.step``, ``ShardedReplayDDC.local``, ``fold``,
``fold_streamed``, ``fold_rotg``, ``fold_t`` with one block, ``chain``,
``lockin_self``, ``lockin_table``, ``lockin_at``, ``fused_chirp_lockin``)
are called, so an older checkout runs this file too.  Shapes: the TONES
receiver (nfft 1000, avg 4) for the channelizers, over the blocks of an
8-block (384 MB) recording in turn so that each call reads its rows
from HBM: #1 stream and #4 on
6000-frame blocks, #3 on their first 4000 frames, #5 on one shard's 3000
of a (time=2) mesh, #1 const on one frame standing for 6000; the
pre-sums over the same blocks (#2 streamed after the recording's first
rows as its spare, ``presum``; #6 in place, ``presum_at``) and #6 at the
NOISE replay's shape, 5893 x 1018, over an 8-block recording of its own
(``presum_at_1018``), beside a ``copy_`` of a 48 MB block (``copy``:
the block read, as many bytes written, as the pre-sum moves); config 3
(4,000,000 samples, decimation 100, pf_average 4, 100 tones) for #7
channel mode, #11-#13 and #15 (shard 1 of 2, 20,000 rows), and for #8
and #10 (shard 1 of a (time=2) mesh, 20,000 rows) over the blocks of an
8-block (256 MB) recording in turn; #7 at decimation 10, pf_average 400
(400,000 samples, 40,000 rows); #14 at 4,096,000 samples (nb 40,960), as
the smoke; config 1's one channel for #7's row mode, at config 1 and at
decimation 10, pf_average 800 (400,000 samples).  The yardsticks,
timed the same way: the host-fed PFB route on #1's blocks, the pre-sum
kernel #2 and then ``torch.fft.fft`` (``pfb_two_calls``: no one PyTorch
call computes the channelizer); ``torch.matmul`` of the DDC's
materialized (40,000, 400) window rows by Hmod at config 3
(``ddc_matmul``) and config 1 (``ddc_row_matmul``), of the
fold's (40,000, 100) rotated rows by G2 (as
``chip_smoke.fold_library_ms`` forms it; ``fold_matmul``) and of the
chain's stacked (20,000, 400) rows by G reshaped (400, 100)
(``chain_matmul``), cuBLAS in FP32.  The lock-ins at config 2 (ppt
20,000): #16 (``lockin_table_self``) and #17 (``lockin_table``) over
the blocks of the real one-period table (200 segments, 800 MB) in turn,
as the smoke times them; #18 (``lockin_at``) at the 6,000,000-sample
blocks of the ``chirp_at`` replay (300 segments) over an 8-block (384
MB) recording in turn, at rotating stream positions; #19
(``chirp_lockin``) on 4,000,000-sample blocks of that recording; beside
them ``read``, a torch.sum over the rows of one 6M-sample block (#18's
48 MB read, no chirp formed).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

RUNS, CALLS = 7, 20
E2E_CELLS = ("TONES fused", "TONES host-fed", "TONES replay",
             "TONES replay on (1, 1)",
             "TONES replay on (2, 1)", "DIRECT config 3 fused",
             "DIRECT config 3 fused on (2, 1)", "DIRECT config 3 replay",
             "DIRECT config 3 replay on (2, 1)", "DIRECT config 1 fused",
             "CHIRP config 2 replay, 6M blocks")
DEEP_CELL = "DIRECT config 3 host-fed, pf_average 400"
DEEP_CELL_BLOCKS = 10
R_BLOCKS = 8               # blocks of the channelizers' and #8's recordings
DEEP_DECIM, DEEP_F, DEEP_BLOCK = 10, 400, 400_000    # #7 at a deep FIR
DEEP_ROW_F = 800                   # #7's row mode at a deep FIR, one channel
YARDSTICKS = {"ddc_channel": "ddc_matmul", "ddc_row": "ddc_row_matmul"}
SC_FRAMES = 4000           # #3: 4,000,000 samples at nfft 1000
NOISE_NFFT, NOISE_FRAMES = 1018, 5893   # #6: the NOISE replay's blocks
T_BLOCK = 4_096_000        # #14: JAX's channel-major geometry (nb 40,960)


def time_ms(fn, runs: int = RUNS, n: int = CALLS) -> list:
    """Device ms per call of `n` calls queued behind a device sleep (the
    host enqueues them while the card sleeps, so the CUDA events see the
    kernels back to back and not the wrapper's host time), `runs` times
    after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)           # ~20 ms at ~2 GHz
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def measure() -> dict:
    import torch
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain, chain
    from gpu_sdr_tpu_torch.ops.fold import (TonesDirectFold,
                                            TonesDirectFoldT, fold,
                                            fold_rotg, fold_streamed, fold_t)
    from gpu_sdr_tpu_torch.probe import (CONFIG1, CONFIG3, D_AVG, D_BLOCK,
                                         D_DECIM, D_RATE)
    dev = torch.device("cuda", 0)
    build.load()
    ptxas = [line.split("info    :")[-1].strip()
             for line in build.build_log.splitlines()
             if ("ddc" in line or "chain" in line or "fold" in line or
                 "channelizer" in line or "presum" in line or
                 "lockin" in line or
                 "registers" in line or "spill" in line or
                 "smem" in line) and
             "info" in line and "Function properties" not in line]
    gen = torch.Generator(device=dev).manual_seed(1234)
    times = {}
    for name, freqs, M, f, L in (
            ("ddc_channel", CONFIG3, D_DECIM, D_AVG, D_BLOCK),
            ("ddc_row", CONFIG1, D_DECIM, D_AVG, D_BLOCK),
            ("ddc_channel_f400", CONFIG3, DEEP_DECIM, DEEP_F, DEEP_BLOCK),
            ("ddc_row_f800", CONFIG1, DEEP_DECIM, DEEP_ROW_F, DEEP_BLOCK)):
        cfg = ddc.DirectDDCConfig(D_RATE, M, f, tuple(freqs),
                                  (0,) * len(freqs))
        args = (cfg.modulated_taps(dev), cfg.carrier_ramp(L // M, dev),
                ddc.ddc_carrier_step(cfg, L, dev), D_RATE, M, f,
                ddc.ddc_carrier_init(cfg, dev),
                torch.randn((f - 1) * M, dtype=torch.complex64,
                            device=dev, generator=gen),
                torch.randn(L, dtype=torch.complex64, device=dev,
                            generator=gen))
        times[name] = time_ms(lambda: ddc.ddc_fused(*args))
        if name in YARDSTICKS:          # the yardstick on the same block
            E = torch.cat(args[-2:]).reshape(-1, M)
            A = E.reshape(-1).unfold(0, f * M, M)[:L // M].contiguous()
            times[YARDSTICKS[name]] = time_ms(
                lambda: torch.matmul(A, args[0]))
            del E, A
    measure_replay_ddc(dev, gen, times)
    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * len(CONFIG3))
    ampl = (0.01,) * 100

    def factored(ch):
        crot, qrot = ch.block_rotations_factored(ch.init_state())
        return (ch.P1, ch.G2, crot, qrot, ch.ramp1, ch.nb)
    fch = TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, D_BLOCK, dev)
    fargs = factored(fch)
    times["fold"] = time_ms(lambda: fold(*fargs))
    sch = TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, D_BLOCK, dev,
                          time_shards=2)
    _, srots, drots = sch.rotations(sch.init_state(), 1)
    sargs = (sch.P, sch.G2, srots, drots, sch.ramp, sch.nb)
    times["fold_streamed"] = time_ms(lambda: fold_streamed(*sargs))
    del sch, sargs
    rch = TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, D_BLOCK, dev,
                          rotg=True)
    rargs = factored(rch)
    times["fold_rotg"] = time_ms(lambda: fold_rotg(*rargs))
    tch = TonesDirectFoldT(D_RATE, tuple(CONFIG3), ampl, cfg, T_BLOCK, dev)
    targs = factored(tch.base)
    targs = (*targs[:4], tch.ramp1T, targs[5])
    times["fold_t"] = time_ms(lambda: fold_t(*targs))
    crot = fargs[2]
    A = (fch.P1[None] * crot[:, None, :]).reshape(-1, fch.Ct)[:fch.nb]
    A = A.contiguous()
    times["fold_matmul"] = time_ms(lambda: torch.matmul(A, fch.G2))
    T = 2
    ch = TonesDirectChain(D_RATE, tuple(CONFIG3), (0.01,) * 100, cfg,
                          D_BLOCK, time_shards=T)
    nbt = ch.nb // T
    _, srot, _, drot = ch.block_rotations(ch.init_state(dev))
    cargs = (ch.P[nbt:].to(dev), ch.halo_rows(nbt).to(dev), ch.G.to(dev),
             ch.ramp[nbt:].to(dev), srot, srot, drot)
    times["chain"] = time_ms(lambda: chain(*cargs))
    E = torch.cat([cargs[1] * srot, cargs[0] * srot])
    f = ch.G.shape[0]
    Ac = torch.cat([E[j:j + nbt] for j in range(f)], dim=1)   # (nbt, f*Ct)
    Gr = cargs[2].reshape(-1, ch.Cp)
    times["chain_matmul"] = time_ms(lambda: torch.matmul(Ac, Gr))
    measure_channelizers(dev, gen, times)
    measure_lockins(dev, gen, times)
    return dict(card=card(), torch=torch.__version__, ptxas=ptxas,
                ms={k: dict(median=float(np.median(v)), min=float(min(v)),
                            max=float(max(v))) for k, v in times.items()})


def measure_replay_ddc(dev, gen, times) -> None:
    """#8 (``ReplayDDC.step``) and #10 (``ShardedReplayDDC.local`` on
    shard 1 of a (time=2) mesh) at config 3 into `times`, over the blocks
    of an R_BLOCKS-block (256 MB) recording in turn, so that each call
    reads its rows from HBM."""
    import itertools

    import torch
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.replay_ddc import ReplayDDC, ShardedReplayDDC
    from gpu_sdr_tpu_torch.probe import (CONFIG3, D_AVG, D_BLOCK, D_DECIM,
                                         D_RATE)
    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * len(CONFIG3))
    rec = torch.randn(R_BLOCKS * D_BLOCK, dtype=torch.complex64, device=dev,
                      generator=gen)
    phase, rot = ddc.ddc_carrier_init(cfg, dev), itertools.count()
    rk = ReplayDDC(cfg, rec, D_BLOCK, dev)
    times["replay_ddc"] = time_ms(
        lambda: rk.step((next(rot) % R_BLOCKS, phase, 1)))
    del rk
    sk = ShardedReplayDDC(cfg, rec, D_BLOCK, [dev] * 2)
    times["replay_ddc_sharded"] = time_ms(
        lambda: sk.local((next(rot) % R_BLOCKS, phase, 1), 1))


def measure_channelizers(dev, gen, times) -> None:
    """#1 (const, stream), #3, #4, #5, the two-call host-fed route, #2,
    #6 and a copy_ of a block into `times`, over the blocks of an 8-block
    recording in turn; #6 again over an 8-block recording at the NOISE
    replay's shape."""
    import itertools

    import torch
    from gpu_sdr_tpu_torch.ops import channelizer as ch
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.ops.presum import (pfb_frames_fused, presum,
                                              presum_at, shard_spans,
                                              staged_halos)
    from gpu_sdr_tpu_torch.probe import AVG, FRAMES, NFFT, RATE
    cfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    w2, F1, G = ch.channelizer_consts(cfg, dev)
    X = torch.randn((R_BLOCKS * FRAMES, NFFT), dtype=torch.complex64,
                    device=dev, generator=gen)
    spare, frame, rot = X[:AVG - 1], X[:1], itertools.count()

    def block(n=FRAMES):
        i = next(rot) % R_BLOCKS
        return X[i * FRAMES:i * FRAMES + n]
    times["channelizer_const"] = time_ms(
        lambda: ch.channelizer(w2, F1, G, spare, frame, FRAMES))
    times["channelizer_stream"] = time_ms(
        lambda: ch.channelizer(w2, F1, G, spare, block()))
    times["channelizer_scrambled"] = time_ms(
        lambda: ch.channelizer_scrambled(w2, F1, G, spare, block(SC_FRAMES)))
    times["channelizer_at"] = time_ms(lambda: ch.channelizer_at(
        w2, F1, G, X, next(rot) % R_BLOCKS, 1, FRAMES))
    window, flat = cfg.window(dev), spare.reshape(-1)
    times["pfb_two_calls"] = time_ms(
        lambda: pfb_frames_fused(cfg, window, flat, block().reshape(-1)))
    spans = shard_spans(X, R_BLOCKS, 2)
    halos = staged_halos(X, R_BLOCKS, 2, AVG - 1)

    def shard():
        i = next(rot)
        return spans[i % 2], halos[i % 2], (i // 2) % R_BLOCKS
    times["channelizer_at_halo"] = time_ms(lambda: ch.channelizer_at_halo(
        w2, F1, G, *shard(), 1, FRAMES // 2))
    times["presum"] = time_ms(lambda: presum(w2, spare, block()))
    times["presum_at"] = time_ms(lambda: presum_at(
        w2, X, next(rot) % R_BLOCKS, 1, FRAMES))
    dst = torch.empty((FRAMES, NFFT), dtype=torch.complex64, device=dev)
    times["copy"] = time_ms(lambda: dst.copy_(block()))
    wn = PFBConfig(nfft=NOISE_NFFT, avg=AVG, rate=RATE).window(dev).reshape(
        AVG, NOISE_NFFT)
    XN = torch.randn((R_BLOCKS * NOISE_FRAMES, NOISE_NFFT),
                     dtype=torch.complex64, device=dev, generator=gen)
    times["presum_at_1018"] = time_ms(lambda: presum_at(
        wn, XN, next(rot) % R_BLOCKS, 1, NOISE_FRAMES))


def measure_lockins(dev, gen, times) -> None:
    """#16 and #17 over the blocks of config 2's one-period table, #18 and
    #19 over the blocks of an R_BLOCKS-block recording at rotating stream
    positions, and ``read`` (a torch.sum over the rows of one of its
    6M-sample blocks) into `times`."""
    import itertools

    import torch
    from gpu_sdr_tpu_torch.ops.chirp import ChirpConfig, chirp_period_table
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_at import fused_chirp_lockin, lockin_at
    from gpu_sdr_tpu_torch.ops.lockin_table import lockin_self, lockin_table
    from gpu_sdr_tpu_torch.probe import AT_BLOCK, C_BLOCK, C_RATE, CONFIG2
    cfg = ChirpConfig.from_params(
        CONFIG2["freq"][0], CONFIG2["chirp_f"][0], C_RATE,
        CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0])
    ppt = cfg.length
    nseg, nblk = C_BLOCK // ppt, cfg.period // C_BLOCK
    w = torch.from_numpy(lockin_profile(ppt)).to(dev)
    table = chirp_period_table(cfg, C_BLOCK, ppt, device=dev)
    rot = itertools.count()

    def blk():
        o = next(rot) % nblk
        return o, (o + nblk // 2) % nblk
    times["lockin_table_self"] = time_ms(
        lambda: lockin_self(w, table, blk()[0], nseg))
    times["lockin_table"] = time_ms(
        lambda: lockin_table(w, table, table, *blk(), nseg))
    del table
    at_nseg = AT_BLOCK // ppt
    X = torch.randn((R_BLOCKS * at_nseg, ppt), dtype=torch.complex64,
                    device=dev, generator=gen)
    Y = X.view(R_BLOCKS, AT_BLOCK)[:, :C_BLOCK]

    def at():
        i = next(rot)
        return (cfg, w, (i * AT_BLOCK) % cfg.period, X, i % R_BLOCKS,
                at_nseg)

    def streamed():
        i = next(rot)
        return cfg, w, (i * C_BLOCK) % cfg.period, Y[i % R_BLOCKS]
    times["lockin_at"] = time_ms(lambda: lockin_at(*at()))
    times["chirp_lockin"] = time_ms(lambda: fused_chirp_lockin(*streamed()))
    times["read"] = time_ms(lambda: torch.sum(X[
        (next(rot) % R_BLOCKS) * at_nseg:][:at_nseg].view(torch.float32),
        dim=1))


def measure_cells(runs: int) -> dict:
    """E2E_CELLS and DEEP_CELL through this checkout's probe, `runs` rates
    each, with the host's ms a block over those runs (medians): in the
    fetch's start (the gather, the pinned buffer, the copy queued), in
    its wait for the copy, and in the channelizer's, pre-sum's, DDC's,
    fold's, chain's or lock-in's C launch calls."""
    import time

    import torch
    from gpu_sdr_tpu_torch import probe
    from gpu_sdr_tpu_torch.engine import pipeline
    from gpu_sdr_tpu_torch.kernels import build
    probe.RUNS = runs
    acc, host = {}, []

    def timed(key, fn):
        def wrapped(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
        return wrapped
    fetch, launch, run_once = pipeline._HostFetch, build.launch, \
        probe.run_once
    fetch.start = timed("start", fetch.start)
    fetch.result = staticmethod(timed("wait", fetch.result))
    timed_launch = timed("launch", launch)
    build.launch = lambda name, *args: (
        timed_launch if name.startswith(("sdr_fold", "sdr_chain",
                                         "sdr_channelizer", "sdr_ddc",
                                         "sdr_presum", "sdr_lockin"))
        else launch)(name, *args)

    def counted(*args, **kw):               # the timed runs only
        acc.clear()
        out = run_once(*args, **kw)
        if kw.get("window") is None and out[1] > 2:
            host.append({k: v / out[1] * 1e3 for k, v in acc.items()})
        return out
    probe.run_once = counted
    dev = torch.device("cuda", 0)
    cells = []
    for c in probe.cells() + ((DEEP_CELL, deep_params, True,
                               DEEP_CELL_BLOCKS, probe.D_BLOCK, None),):
        if c[0] in E2E_CELLS or c[0] == DEEP_CELL:
            host.clear()
            cells.append(probe.probe_cell(dev, *c))
            cells[-1]["host_ms_per_block"] = {
                k: float(np.median([h.get(k, 0.0) for h in host]))
                for k in ("start", "wait", "launch")}
    return dict(card=card(), cells=cells)


def deep_params(n_blocks: int):
    """Config 3 host-fed at pf_average 400 (an 8000-tap FIR at decimation
    100): the DDC kernel #7's channel mode at a deep FIR."""
    from gpu_sdr_tpu_torch.probe import CONFIG3, direct_params
    p = direct_params(CONFIG3, 0.01, n_blocks)
    p.A_RX2.pf_average = DEEP_F
    return p


def compare(trees, args=()) -> int:
    """Run this file with `args` from each checkout in the order A B B A;
    each run's JSON line, then side by side: each kernel's median ms
    or, with --cells, each cell's median Msps and busy share."""
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            *args], env=env, cwd=os.path.abspath(tree),
                           capture_output=True, text=True, timeout=600)
        if p.returncode:
            print(p.stdout, p.stderr, file=sys.stderr)
            return p.returncode
        runs.append((tree, json.loads(p.stdout.strip().splitlines()[-1])))
        print(json.dumps({"tree": tree, **runs[-1][1]}), flush=True)
    print(runs[0][1]["card"])
    if args:
        for i, c in enumerate(runs[0][1]["cells"]):
            print(f"{c['cell']}: " + ", ".join(
                f"{t} {np.median(r['cells'][i]['msps']):.1f} Msps "
                f"({100 * r['cells'][i]['device_busy']:.1f}% busy; host ms "
                "a block: " + " / ".join(
                    f"{k} {v:.3f}" for k, v in
                    r['cells'][i]['host_ms_per_block'].items()) + ")"
                for t, r in runs))
        return 0
    for k in runs[0][1]["ms"]:
        print(f"{k}: " + ", ".join(
            f"{t} {r['ms'][k]['median']:.4f}" for t, r in runs) + " ms")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--trees":
        sys.exit(compare(sys.argv[2:]))
    if len(sys.argv) in (4, 5) and sys.argv[1] == "--cells":
        sys.exit(compare(sys.argv[2:4], ("--cells-here",
                                         *sys.argv[4:5])))
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--cells-here":
        print(json.dumps(measure_cells(int((sys.argv[2:] or [10])[0]))))
    else:
        print(json.dumps(measure()))
