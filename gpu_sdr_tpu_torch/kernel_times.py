"""Device times of the DDC (#7, channel and row mode), fold (#11) and
chain (#15) kernels at the main path's shapes, for comparing two
checkouts of the port on one card.

    python -m gpu_sdr_tpu_torch.kernel_times
        one JSON line: the card, ptxas's register and spill lines for the
        kernels, and each kernel's device ms per call (median, min and
        max over 7 runs of 20 calls queued behind a device sleep)
    python -m gpu_sdr_tpu_torch.kernel_times --trees A B
        the line above from checkout A, then B, B and A, each in its own
        process with that checkout first on PYTHONPATH (each builds its
        own sources), then each kernel's times side by side

Only wrappers that the port has had since its sharded layer are called
(``ddc_fused``, ``fold`` with one block, ``chain``), so an older
checkout runs this file too.  Shapes: config 3 (4,000,000 samples,
decimation 100, pf_average 4, 100 tones) for #7 channel mode, #11 and
#15 (shard 1 of 2, 20,000 rows); config 1's one channel for #7's row
mode.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

RUNS, CALLS = 7, 20


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


def measure() -> dict:
    import torch
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain, chain
    from gpu_sdr_tpu_torch.ops.fold import TonesDirectFold, fold
    from gpu_sdr_tpu_torch.probe import (CONFIG1, CONFIG3, D_AVG, D_BLOCK,
                                         D_DECIM, D_RATE)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.load()
    ptxas = [line.split("info    :")[-1].strip()
             for line in build.build_log.splitlines()
             if ("ddc" in line or "chain" in line or "fold" in line or
                 "registers" in line or "spill" in line) and
             "info" in line and "Function properties" not in line]
    gen = torch.Generator(device=dev).manual_seed(1234)
    times = {}
    for name, freqs in (("ddc_channel", CONFIG3), ("ddc_row", CONFIG1)):
        cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(freqs),
                                  (0,) * len(freqs))
        args = (cfg.modulated_taps(dev), cfg.carrier_ramp(D_BLOCK // D_DECIM,
                                                          dev),
                ddc.ddc_carrier_step(cfg, D_BLOCK, dev), D_RATE, cfg.M,
                cfg.f, ddc.ddc_carrier_init(cfg, dev),
                torch.randn((D_AVG - 1) * D_DECIM, dtype=torch.complex64,
                            device=dev, generator=gen),
                torch.randn(D_BLOCK, dtype=torch.complex64, device=dev,
                            generator=gen))
        times[name] = time_ms(lambda: ddc.ddc_fused(*args))
    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * len(CONFIG3))
    fch = TonesDirectFold(D_RATE, tuple(CONFIG3), (0.01,) * 100, cfg,
                          D_BLOCK, dev)
    crot, qrot = fch.block_rotations_factored(fch.init_state())
    fargs = (fch.P1, fch.G2, crot, qrot, fch.ramp1, fch.nb)
    times["fold"] = time_ms(lambda: fold(*fargs))
    T = 2
    ch = TonesDirectChain(D_RATE, tuple(CONFIG3), (0.01,) * 100, cfg,
                          D_BLOCK, time_shards=T)
    nbt = ch.nb // T
    _, srot, _, drot = ch.block_rotations(ch.init_state(dev))
    cargs = (ch.P[nbt:].to(dev), ch.halo_rows(nbt).to(dev), ch.G.to(dev),
             ch.ramp[nbt:].to(dev), srot, srot, drot)
    times["chain"] = time_ms(lambda: chain(*cargs))
    return dict(card=smi, torch=torch.__version__, ptxas=ptxas,
                ms={k: dict(median=float(np.median(v)), min=float(min(v)),
                            max=float(max(v))) for k, v in times.items()})


def compare(trees) -> int:
    """Run measure() from each checkout in the order A B B A."""
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        p = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, cwd=os.path.abspath(tree),
                           capture_output=True, text=True, timeout=600)
        if p.returncode:
            print(p.stdout, p.stderr, file=sys.stderr)
            return p.returncode
        runs.append((tree, json.loads(p.stdout.strip().splitlines()[-1])))
        print(json.dumps({"tree": tree, **runs[-1][1]}), flush=True)
    print(runs[0][1]["card"])
    for k in runs[0][1]["ms"]:
        print(f"{k}: " + ", ".join(
            f"{t} {r['ms'][k]['median']:.4f}" for t, r in runs) + " ms")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--trees":
        sys.exit(compare(sys.argv[2:]))
    print(json.dumps(measure()))
