#!/usr/bin/env python3
"""Drive the PyTorch port (gpu_sdr_tpu_torch) once on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and the CUDA
toolkit (nvcc), builds the port's kernels from ``gpu_sdr_tpu_torch/csrc``
and exits non-zero at the first phase that fails:

1. the card: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   compute capability 9.0;
2. the nvcc build of both kernels, with ptxas' resource report;
3. each kernel against its plain PyTorch version on the card at the main
   path's shape (nfft 1000, avg 4, 6000 frames): the channelizer in both
   modes at >= 90 dB SNR and its first 16 frames against a float64
   numpy oracle, the pre-sum at <= 1e-6 relative error; both times from
   CUDA events, the median of repeated runs;
4. ``run_measurement`` at the reference's network-stress configuration:
   1000 bin-quantized tones at 100 Msps into a 1000-bin TONES receiver,
   6,000,000-sample blocks, 100 blocks, fused on the card;
5. the same measurement host-fed through an ideal channel for 20 blocks,
   held against phase 4's first 20 blocks at >= 90 dB SNR.

Phases 4 and 5 are the main path.  Their CallbackSink checks rows ::97
of every packet (finite, tone amplitudes within 1%) and drops the
packet, and their rates are host-clock Msamples/s from the sink's start
to its end, after a 3-block warm-up of each branch.  Every kernel launch
counter is set to 0 after the warm-up, before phase 4, and read after
phase 5.
The line before the last is a JSON object with one entry per kernel
(the channelizer's times are const-frame mode, the main path's; its
``stream_*`` fields are stream mode); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

NFFT, AVG, RATE = 1000, 4, 100_000_000
FRAMES = 6000                       # frames of one 6,000,000-sample block
BLOCK = NFFT * FRAMES
FUSED_BLOCKS, HOST_BLOCKS = 100, 20
WARMUP_BLOCKS = 3
ROWS = slice(0, None, 97)   # the rows of each packet that are checked
SNR_BAR_DB = 90.0
PRESUM_REL_ERR = 1e-6
TIMED_RUNS = 20


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.complex128).ravel()
    err = np.linalg.norm(ref - np.asarray(test, np.complex128).ravel())
    return float("inf") if err == 0 else \
        20.0 * np.log10(np.linalg.norm(ref) / err)


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median over `runs` of one call's device time, from CUDA events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability {cap}, "
          f"{torch.cuda.device_count()} card(s)")
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")


def phase_build():
    from gpu_sdr_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s for {', '.join(build.SOURCES)} "
          f"(nvcc {build.build_seconds:.2f} s, sm_90a)"
          if build.build_seconds is not None else
          f"build: cached library {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line:
            print("  ptxas:", line.split("info    :")[-1].strip())


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shape."""
    import torch
    from gpu_sdr_tpu_torch.ops.channelizer import (
        channelizer, channelizer_consts, channelizer_plain)
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.ops.presum import presum, presum_plain
    rng = np.random.default_rng(1234)
    cfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    w2, F1, G = channelizer_consts(cfg, dev)
    spare_np = crandn(rng, AVG - 1, NFFT)
    x_np = crandn(rng, FRAMES, NFFT)
    frame_np = crandn(rng, 1, NFFT)
    spare, x, frame = (torch.from_numpy(a).to(dev)
                       for a in (spare_np, x_np, frame_np))
    rows = {}

    # float64 oracle of the first 16 frames of each mode
    w = w2.cpu().numpy().astype(np.float64)

    def oracle(body):
        ext = np.concatenate([spare_np, body[:16]]).astype(np.complex128)
        return np.fft.fft(sum(w[i] * ext[i:i + 16] for i in range(AVG)),
                          axis=-1)

    for mode, args, body in (
            ("stream", (x,), x_np),
            ("const", (frame, FRAMES), np.repeat(frame_np, 16, axis=0))):
        k = channelizer(w2, F1, G, spare, *args)
        p = channelizer_plain(w2, F1, G, spare, *args)
        torch.cuda.synchronize(dev)
        check(k.shape == (FRAMES, NFFT), f"channelizer {mode} shape")
        kn, pn = k.cpu().numpy(), p.cpu().numpy()
        check(np.isfinite(kn).all(), f"channelizer {mode}: non-finite")
        s_plain, s_gold = snr_db(pn, kn), snr_db(oracle(body), kn[:16])
        ms = time_ms(lambda: channelizer(w2, F1, G, spare, *args))
        pms = time_ms(lambda: channelizer_plain(w2, F1, G, spare, *args))
        err = float(np.abs(kn - pn).max())
        print(f"channelizer [{mode}] {FRAMES}x{NFFT}: SNR {s_plain:.1f} dB "
              f"vs plain, {s_gold:.1f} dB vs float64 (16 frames), "
              f"max |err| {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms")
        check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB,
              f"channelizer {mode} under {SNR_BAR_DB} dB")
        rows[f"channelizer_{mode}"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=pms)

    k = presum(w2, spare, x)
    p = presum_plain(w2, spare, x)
    torch.cuda.synchronize(dev)
    kn, pn = k.cpu().numpy(), p.cpu().numpy()
    rel = float(np.linalg.norm(kn - pn) / np.linalg.norm(pn))
    err = float(np.abs(kn - pn).max())
    ms = time_ms(lambda: presum(w2, spare, x))
    pms = time_ms(lambda: presum_plain(w2, spare, x))
    print(f"presum {FRAMES}x{NFFT}: relative error {rel:.3e} vs plain, "
          f"max |err| {err:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms")
    check(np.isfinite(kn).all() and rel <= PRESUM_REL_ERR,
          f"presum relative error {rel:.3e} > {PRESUM_REL_ERR}")
    rows["presum"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    return rows


def loopback_params(n_blocks: int):
    """The reference's network-stress configuration: a 1000-channel PFB
    readout of 1000 bin-quantized tones (bench.py:83-105)."""
    from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams,
                                          UsrpParams, WaveType)
    freqs = [k * (RATE // NFFT) for k in range(-NFFT // 2, NFFT // 2)]
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=BLOCK,
                             freq=freqs, ampl=[1.0 / NFFT] * NFFT,
                             wave_type=[WaveType.TONES] * NFFT)
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=NFFT,
                            pf_average=AVG, buffer_len=BLOCK,
                            samples=n_blocks * BLOCK, freq=freqs,
                            wave_type=[WaveType.TONES] * NFFT)
    return p


class PacketCheck:
    """The callback of the main path's CallbackSink: checks rows ::97 of
    every packet as it arrives (finite, tone amplitudes within 1%) and
    keeps those rows of the first `keep` packets; the packet is dropped."""

    def __init__(self, rows: int, keep: int = 0):
        self.rows, self.keep = rows, keep
        self.kept, self.n = [], 0

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (self.rows, NFFT) and d.dtype == np.complex64,
              f"packet {self.n}: {d.shape} {d.dtype}")
        sub = d[ROWS]
        check(bool(np.isfinite(sub).all()), f"packet {self.n}: non-finite")
        amp = np.abs(sub[1:] if self.n == 0 else sub)   # row 0: startup
        check(bool(np.all(np.abs(amp * NFFT - 1.0) <= 1e-2)),
              f"packet {self.n}: tone amplitude off by more than 1%")
        if self.n < self.keep:
            self.kept.append(sub.copy())
        self.n += 1


def run_path(dev, n_blocks, channel, keep=0):
    """One run_measurement: (packet check, dispatch, Msps from the sink's
    start to its end, seconds with set-up)."""
    from gpu_sdr_tpu_torch import measure
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    stamps = []

    class TimedSink(CallbackSink):
        def on_start(self, n_channels, expected_rows):
            check(n_channels == NFFT, f"{n_channels} channels")
            stamps.append(time.perf_counter())

        def on_end(self):
            stamps.append(time.perf_counter())

    pkt = PacketCheck(FRAMES, keep=keep)
    t0 = time.perf_counter()
    measure.run_measurement(loopback_params(n_blocks),
                            channel=channel, extra_sinks=[TimedSink(pkt)],
                            device=dev)
    wall = time.perf_counter() - t0
    check(pkt.n == n_blocks, f"{pkt.n} of {n_blocks} packets")
    msps = n_blocks * BLOCK / (stamps[1] - stamps[0]) / 1e6
    return pkt, measure.last_dispatch(), msps, wall


def phase_main_path(dev):
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    from gpu_sdr_tpu_torch.ops.channelizer import channelizer
    from gpu_sdr_tpu_torch.ops.presum import presum
    # a few blocks of each branch first: pinned host pools, cuFFT plan
    run_path(dev, WARMUP_BLOCKS, None)
    run_path(dev, WARMUP_BLOCKS, IdealChannel())
    channelizer.launches = presum.launches = 0

    fused, disp, msps, wall = run_path(dev, FUSED_BLOCKS, None,
                                       keep=HOST_BLOCKS)
    n_chan = channelizer.launches
    print(f"fused loopback: {disp}, {FUSED_BLOCKS} blocks of {BLOCK} "
          f"samples, {n_chan} channelizer launches; {msps:.1f} Msps "
          f"streaming, {wall:.3f} s with set-up")
    check(disp == (("A_RX2", "fused_loopback", "channelizer_wavetable"),),
          f"fused dispatch {disp}")
    check(n_chan >= FUSED_BLOCKS and presum.launches == 0,
          f"fused launches: channelizer {n_chan}, presum "
          f"{presum.launches}")

    host, disp, msps, wall = run_path(dev, HOST_BLOCKS, IdealChannel(),
                                      keep=HOST_BLOCKS)
    n_pre = presum.launches
    snr = snr_db(np.stack(fused.kept), np.stack(host.kept))
    print(f"host pipeline: {disp}, {HOST_BLOCKS} blocks, {n_pre} presum "
          f"launches; {msps:.1f} Msps streaming, {wall:.3f} s with "
          "set-up; "
          f"SNR {snr:.1f} dB vs the fused run's first {HOST_BLOCKS} blocks "
          "(rows ::97)")
    check(disp == (("A_RX2", "host_pipeline", None),),
          f"host dispatch {disp}")
    check(n_pre == HOST_BLOCKS and channelizer.launches == n_chan,
          f"host launches: presum {n_pre}, channelizer "
          f"{channelizer.launches - n_chan}")
    check(snr >= SNR_BAR_DB, f"host vs fused {snr:.1f} dB")
    return {"channelizer": channelizer.launches, "presum": presum.launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import gpu_sdr_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.abspath(
            gpu_sdr_tpu_torch.__file__))) != HERE:
        print("chip_smoke: gpu_sdr_tpu_torch is not from this checkout",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        phase_card()
        phase_build()
        rows = phase_kernels(dev)
        launches = phase_main_path(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    src = "gpu_sdr_tpu_torch/csrc/"
    kernels = [
        dict(name="channelizer", route="cuda", source=src + "channelizer.cu",
             replaces="gpu_sdr_tpu/ops/pallas_channelizer.py:390",
             launches=launches["channelizer"], **rows["channelizer_const"],
             **{f"stream_{k}": v
                for k, v in rows["channelizer_stream"].items()}),
        dict(name="presum", route="cuda", source=src + "presum.cu",
             replaces="gpu_sdr_tpu/ops/pallas_pfb.py:82",
             launches=launches["presum"], **rows["presum"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
