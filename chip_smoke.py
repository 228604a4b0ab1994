#!/usr/bin/env python3
"""Drive the PyTorch port (gpu_sdr_tpu_torch) once on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and the CUDA
toolkit (nvcc), builds the port's kernels from ``gpu_sdr_tpu_torch/csrc``
and exits non-zero at the first phase that fails:

1. the card: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   compute capability 9.0;
2. the nvcc build of the kernels, with ptxas' resource report;
3. each kernel against its plain PyTorch version on the card at the main
   path's shape (nfft 1000, avg 4, 6000 frames): the channelizer in both
   modes at >= 90 dB SNR and its first 16 frames against a float64
   numpy oracle, the pre-sum at <= 1e-6 relative error; both times from
   CUDA events, the median of repeated runs;
4. ``run_measurement`` at the reference's network-stress configuration:
   1000 bin-quantized tones at 100 Msps into a 1000-bin TONES receiver,
   6,000,000-sample blocks, 100 blocks, fused on the card;
5. the same measurement host-fed through an ideal channel for 20 blocks,
   held against phase 4's first 20 blocks at >= 90 dB SNR;
6. each DIRECT kernel against its plain version on the card at the full
   width of BASELINE configs 1 and 3 (100 Msps, 4,000,000-sample blocks,
   decim 100, pf_average 4): the DDC at 100 channels, the replay DDC on
   a 100-tone comb quantized to a 100 kHz grid (period 1000), the
   few-channel replay DDC at config 1 (one tone at 10 MHz), the fold at
   config 3 (100 tones at linspace(-45, 45) MHz); each at >= 90 dB SNR
   against plain and, on the stream's first 400 rows, against a float64
   numpy oracle of a 40,000-sample prefix; times as in phase 3;
7. the DIRECT readout through ``run_measurement``: config 3 fused (fold
   kernel), config 1 fused (few-channel replay), the quantized comb
   fused (replay), config 3 host-fed through an ideal channel (DDC
   kernel), the last held against the first blocks of the config-3
   fused run at >= 90 dB SNR; the two share no kernel;
8. the CHIRP lock-in kernel's two modes against their plain versions at
   the full width of BASELINE config 2 (a -40 to +40 MHz chirp of 5000
   steps over 1 s at 100 Msps, ppt 20,000, 4,000,000-sample blocks of
   200 segments) over the real 800 MB one-period table: self mode (#16)
   on blocks 0, 1 and 24, and on blocks 3 and 17 of a random table of
   the same size (on the chirp every row sums to 1), its imaginary half
   exactly 0; table mode (#17) on a random incoming block against
   oscillator blocks 0, 1 and 24; each at >= 90 dB SNR against plain
   and, on blocks 0 and 1 and on the random blocks, against a float64
   numpy oracle; times from CUDA events over
   launches queued behind a device sleep, rotating over every block of
   the table so that no row is read from L2;
9. the CHIRP readout through ``run_measurement``: config 2 fused
   (``chirp_wavetable``, self mode, 50 blocks: two period wraps) and
   host-fed through an ideal channel (table mode, 25 blocks), every
   lock-in point within 1e-5 of the TX amplitude, host-fed against fused
   at >= 90 dB SNR;
10. the device replay's kernels against their plain versions and a
   float64 oracle at full width: the channelizer (#4) and the pre-sum
   (#6) reading blocks of a random 8-block (384 MB) recording in place
   at the TONES geometry (blocks 0 at the stream's start, 3, 7, and 0
   after the loop seam), at >= 90 dB SNR (16 frames against float64) and
   <= 1e-6 relative error, with the channelizer's stream mode (#1) timed
   over the same blocks as #4 is; the pre-sum again, and timed, at its
   main path's shape (NOISE at nfft 1018, blocks of 5893 frames, the
   same four blocks of an 8-block recording); the in-kernel chirp
   lock-in (#18) at config 2
   with 6,000,000-sample blocks (300 segments, the period no multiple of
   them) from stream positions 0, 37,000,000 and 98,000,000 (across the
   period's end) at >= 90 dB against plain and float64, and fed the
   chirp itself, every point within 1e-5 of 1; times as in phase 8,
   rotating over the recording's blocks;
11. the device replay through ``run_measurement(source=ReplaySource)``,
   each recording made on the card and saved as a .npy file: the TONES
   comb (8 blocks looped, 20 acquired, ``channelizer_at``) against phase
   4's first 20 blocks; NOISE at nfft 1018 (``pfb_at``); DIRECT configs
   3 and 1 (``replay_kernel``, ``replay_kernel_t``); CHIRP config 2 (10
   blocks looped over 30: ``chirp_table``, the recording wrapping mod 10
   and the oscillator mod 25) and at 6,000,000-sample blocks
   (``chirp_at``); a 5.5-block config-3 recording, not looped
   (``scan``); then ``SegmentedDeviceReplay`` in 2-block segments over
   16 blocks of a 6-block recording and of a looped 3-block one, with
   its staging time per segment.  Each is held against the host-fed
   pipeline over the same recording at >= 90 dB SNR.

12. the sharded layer's kernels against their plain versions and a
   float64 oracle at full width, on the shards of a (time=2) mesh: the
   channelizer after a staged halo (#5) on an 8-block TONES recording
   (3000 frames a shard), the replay DDC after staged history rows
   (#10) on an 8-block config-3 recording (20,000 rows a shard), the
   G-fused chain (#15) at config 3 (Ct = Cp = 100, f 4), each at the
   stream's start, inside and at the seam, on shards 0 and 1; times as
   phase 10 (#5, #10) or phase 6 (#15, beside one complex matmul of the
   stacked rows, its library_ms);
13. the sharded layer through ``run_measurement(mesh=...)`` on meshes of
   this card, 10 blocks each: TONES fused (2, 1), TONES host-fed (2, 2,
   4 blocks: the psum), config 3 fused (2, 1, ``fold_kernel``) and its
   ``g_chain`` (``ShardedFusedDirect(use_fold=False)``), config 2 fused
   (``chirp_table``), the TONES and config-3 replays (``channelizer_at``,
   ``replay_kernel``), a not-looped config-3 replay (``scan``) and
   ``ShardedSegmentedReplay``; each held against the port's unsharded
   run of the same measurement at >= 90 dB SNR.

Phases 4, 5, 7, 9, 11 and 13 are the main path.  Their CallbackSink checks rows
::97 of every packet (finite; PFB tones within 1% of their amplitude;
DIRECT rows within 2.5% of the TX amplitude, the sum of the other tones'
leakage through the 400-tap FIR's stopband at config 3, and each
channel's mean over the rows within 1%; every CHIRP row) and drops the
packet, and their rates are host-clock Msamples/s from the sink's start
to its end, after a warm-up of each branch.  Every kernel launch
counter is set to 0 just before each run and read just after it.
The line before the last is a JSON object with one entry per kernel
(the channelizer's times are const-frame mode, the main path's; its
``stream_*`` fields are stream mode), each with its bound: the larger
of its bytes over 3.35 TB/s and its FP32 operations over 67 TFLOP/s,
counted from this run's shapes; ``library_ms`` is one PyTorch call
computing the same function where there is one (the lock-in modes:
``torch.einsum``), else null.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
try:    # the main path's configurations (gpu_sdr_tpu_torch/probe.py)
    from gpu_sdr_tpu_torch.probe import (
        AT_BLOCK, AVG, BLOCK, C_BLOCK, C_RATE, CONFIG1, CONFIG2, CONFIG3,
        D_AVG, D_BLOCK, D_DECIM, D_RATE, FRAMES, NFFT, QCOMB, RATE,
        chirp6m_params, chirp_params, direct_params, loopback_params,
        receiver_only, save_recording, tx_recording)
except ImportError as e:
    print(f"chip_smoke: the port is not beside this script: {e}",
          file=sys.stderr)
    sys.exit(1)

FUSED_BLOCKS, HOST_BLOCKS = 100, 20
WARMUP_BLOCKS = 3
ROWS = slice(0, None, 97)   # the rows of each packet that are checked
SNR_BAR_DB = 90.0
PRESUM_REL_ERR = 1e-6
TIMED_RUNS = 20

D_ROWS = D_BLOCK // D_DECIM                     # 40,000 rows per block
ORACLE_ROWS = 400                   # rows of a 40,000-sample prefix
D_FUSED_BLOCKS, D_HOST_BLOCKS, D_WARMUP_BLOCKS = 50, 10, 2
D_ROW_TOL, D_MEAN_TOL = 2.5e-2, 1e-2

C_ROWS = 200                        # lock-in points per config-2 block
C_FUSED_BLOCKS, C_HOST_BLOCKS, C_WARMUP_BLOCKS = 50, 25, 2
C_AMPL, C_TOL = 1.0, 1e-5           # TX amplitude; lock-in row tolerance
C_ORACLE_BLOCKS = (0, 1)            # blocks held against float64
C_RANDOM_BLOCKS = (3, 17)           # self-mode blocks of a random table
QUEUED_RUNS = 5                     # timed passes over the table

# the device replay's kernels: blocks of an 8-block recording, as
# (block, valid): the stream's start, inside, the last block, and block
# 0 after the loop seam (its halo the recording's last frames)
R_BLOCKS = 8
R_IDX = ((0, 0), (3, 1), (7, 1), (0, 1))
AT_POSITIONS = (0, 37_000_000, 98_000_000)   # the last crosses the period
# operations of lockin_at per sample, counted from csrc/lockin.cu's
# chirp mode: 21 integer and float operations for the phase (the uint32
# index, its conversion and scaling), ~25 for sincosf (reduction and two
# polynomials, an FMA counted as 2), 6 for conj(c) * x and 4 for the two
# profile-weighted sums; all counted at the FP32 peak
CHIRP_AT_OPS = 56

# the replay runs: blocks of each looped recording and of its acquisition
R_TONES = (8, 20)                   # comb, channelizer_at
R_NOISE = (4, 10)                   # NOISE at nfft 1018, pfb_at
R_NFFT = 1018                       # split 2 x 509: G_k1 over shared memory
R_DIRECT = (8, 20)                  # configs 3 and 1, replay kernels
R_CHIRP = (10, 30)                  # config 2: wraps mod 10 and mod 25
R_CHIRP6M = (8, 20)                 # config 2 at 6,000,000: chirp_at
R_SCAN = (5.5, 8)                   # config 3, not looped: scan
R_SEGMENTED = ((6, False), (3, True))   # recordings over 16 blocks
R_SEG_BLOCKS, R_SEG_ACQ = 2, 16
S_BLOCKS, S_HOST = 10, 4            # blocks of the sharded main path's runs

# the card's peaks for the bound (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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


def time_ms_queued(fn, n: int, runs: int = QUEUED_RUNS) -> float:
    """Median over `runs` of the device time per call of `n` calls,
    from CUDA events around calls queued behind a device sleep: the
    host enqueues them while the card sleeps, so the events see the
    kernels back to back and not the host's launch overhead."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)           # ~10 ms at ~2 GHz
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the FP32 operations at the
    non-tensor peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def ddc_flops(rows: int, channels: int, taps: int) -> int:
    """A DDC+FIR block: `taps` complex MACs per output, then the two
    complex rotations."""
    return rows * channels * (8 * taps + 12)


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
        # the function's operations: the pre-sum, then an FFT's
        # 5 N log2 N per frame (not the kernel's two-stage matmul DFT)
        flops = FRAMES * (4 * AVG * NFFT + 5 * NFFT * np.log2(NFFT))
        rows[f"channelizer_{mode}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
            **bound(nbytes(w2, F1, G, spare, *args[:1], k), flops))

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
    rows["presum"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          library_ms=None, **bound(
                              nbytes(w2, spare, x, k), 4 * AVG * x.numel()))
    return rows


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


def run_path(dev, params, channel, pkt, n_blocks, block, channels,
             source=None, mesh=None):
    """One run_measurement (fed from `source` when given, on `mesh` when
    given) with `pkt` as the CallbackSink's check: (pkt, dispatch, Msps
    from the sink's start to its end, seconds with set-up)."""
    from gpu_sdr_tpu_torch import measure
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    stamps = []

    class TimedSink(CallbackSink):
        def on_start(self, n_channels, expected_rows):
            check(n_channels == channels, f"{n_channels} channels")
            stamps.append(time.perf_counter())

        def on_end(self):
            stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    measure.run_measurement(params, channel=channel, source=source,
                            extra_sinks=[TimedSink(pkt)], device=dev,
                            mesh=mesh)
    wall = time.perf_counter() - t0
    check(pkt.n == n_blocks, f"{pkt.n} of {n_blocks} packets")
    msps = n_blocks * block / (stamps[1] - stamps[0]) / 1e6
    return pkt, measure.last_dispatch(), msps, wall


def run_pfb(dev, n_blocks, channel, keep=0):
    return run_path(dev, loopback_params(n_blocks), channel,
                    PacketCheck(FRAMES, keep=keep), n_blocks, BLOCK, NFFT)


def phase_main_path(dev):
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    # a few blocks of each branch first: pinned host pools, cuFFT plan
    run_pfb(dev, WARMUP_BLOCKS, None)
    run_pfb(dev, WARMUP_BLOCKS, IdealChannel())

    (fused, disp, msps, wall), counts = counted(
        lambda: run_pfb(dev, FUSED_BLOCKS, None, keep=HOST_BLOCKS))
    n_chan = counts["channelizer"]
    print(f"fused loopback: {disp}, {FUSED_BLOCKS} blocks of {BLOCK} "
          f"samples, {n_chan} channelizer launches; {msps:.1f} Msps "
          f"streaming, {wall:.3f} s with set-up")
    check(disp == (("A_RX2", "fused_loopback", "channelizer_wavetable"),),
          f"fused dispatch {disp}")
    check(n_chan >= FUSED_BLOCKS and
          all(v == 0 for k, v in counts.items() if k != "channelizer"),
          f"fused launches {counts}")

    (host, disp, msps, wall), counts = counted(
        lambda: run_pfb(dev, HOST_BLOCKS, IdealChannel(), keep=HOST_BLOCKS))
    n_pre = counts["presum"]
    snr = snr_db(np.stack(fused.kept), np.stack(host.kept))
    print(f"host pipeline: {disp}, {HOST_BLOCKS} blocks, {n_pre} presum "
          f"launches; {msps:.1f} Msps streaming, {wall:.3f} s with "
          "set-up; "
          f"SNR {snr:.1f} dB vs the fused run's first {HOST_BLOCKS} blocks "
          "(rows ::97)")
    check(disp == (("A_RX2", "host_pipeline", None),),
          f"host dispatch {disp}")
    check(n_pre == HOST_BLOCKS and
          all(v == 0 for k, v in counts.items() if k != "presum"),
          f"host launches {counts}")
    check(snr >= SNR_BAR_DB, f"host vs fused {snr:.1f} dB")
    return {"channelizer": n_chan, "presum": n_pre}, np.stack(fused.kept)


def kernel_counters():
    """Each kernel wrapper, by its name in the kernels line: each holds
    its launch count in ``launches``."""
    from gpu_sdr_tpu_torch.ops.channelizer import channelizer, channelizer_at
    from gpu_sdr_tpu_torch.ops.ddc import ddc_fused
    from gpu_sdr_tpu_torch.ops.fold import fold
    from gpu_sdr_tpu_torch.ops.lockin_at import lockin_at
    from gpu_sdr_tpu_torch.ops.lockin_table import lockin_self, lockin_table
    from gpu_sdr_tpu_torch.ops.presum import presum, presum_at
    from gpu_sdr_tpu_torch.ops.chain import chain
    from gpu_sdr_tpu_torch.ops.channelizer import channelizer_at_halo
    from gpu_sdr_tpu_torch.ops.replay_ddc import (ReplayDDC, ReplayDDCT,
                                                  ShardedReplayDDC)
    return {"channelizer": channelizer, "presum": presum, "ddc": ddc_fused,
            "replay_ddc": ReplayDDC, "replay_ddc_t": ReplayDDCT,
            "fold": fold, "lockin_self": lockin_self,
            "lockin_table": lockin_table, "channelizer_at": channelizer_at,
            "presum_at": presum_at, "lockin_at": lockin_at,
            "channelizer_at_halo": channelizer_at_halo,
            "replay_ddc_sharded": ShardedReplayDDC, "chain": chain}


def counted(run):
    """(run(), launches of every kernel during it): counts set to 0 just
    before the run and read just after."""
    for w in kernel_counters().values():
        w.launches = 0
    out = run()
    return out, {k: w.launches for k, w in kernel_counters().items()}


def via_kernel(name: str, fn):
    """fn(), checked to have launched kernel `name` exactly once, so a
    comparison holds the kernel's own output against the plain version."""
    w = kernel_counters()[name]
    before = w.launches
    out = fn()
    check(w.launches == before + 1, f"{name}: the wrapper did not launch "
          "its kernel")
    return out


def sinc_taps(n: int, fc: float) -> np.ndarray:
    """The DIRECT FIR in float64: Hamming-windowed sinc of length n,
    unit sum (reference make_sinc_window, cpp/kernels.cu:256-310)."""
    i = np.arange(n, dtype=np.float64)
    k = i - (n - 1) // 2
    x = 2.0 * np.pi * fc * k
    sinc = np.where(k != 0, 2.0 * fc * np.sin(x) / np.where(x == 0, 1, x),
                    2.0 * fc)
    w = sinc * (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1)))
    return w / w.sum()


def comb(freqs, ampl, n: int) -> np.ndarray:
    """The first n samples of a TX comb in float64, exact integer phases."""
    t = np.arange(n, dtype=np.int64)
    x = np.zeros(n, dtype=np.complex128)
    for f in freqs:
        x += ampl * np.exp(2j * np.pi * (((f % D_RATE) * t) % D_RATE) /
                           D_RATE)
    return x


def direct_oracle(x: np.ndarray, freqs) -> np.ndarray:
    """Float64 DIRECT readout of a stream that starts at sample 0 with
    zero FIR history: integer-phase mix-down, then the decimating FIR,
    y[n] = sum_i h[i] * z[(n - f + 1)*M + i].  (ORACLE_ROWS, C)."""
    h = sinc_taps(D_DECIM * D_AVG, 0.75 / (2.0 * D_DECIM))
    t = np.arange(len(x), dtype=np.int64)
    out = np.empty((ORACLE_ROWS, len(freqs)), dtype=np.complex128)
    for c, f in enumerate(freqs):
        z = x * np.exp(-2j * np.pi * (((f % D_RATE) * t) % D_RATE) / D_RATE)
        ze = np.concatenate([np.zeros((D_AVG - 1) * D_DECIM), z])
        win = np.lib.stride_tricks.sliding_window_view(ze, len(h))
        out[:, c] = win[::D_DECIM][:ORACLE_ROWS] @ h
    return out


def report(name, k, p, oracle=None, times=None, rows=None, cost=None):
    """Print and check one DIRECT kernel's output `k` against its plain
    version's `p` and, when given, the float64 oracle of its first
    ORACLE_ROWS rows; with `times` (kernel ms, plain ms) and `cost`
    (bytes in and out, operations), keep its row of the kernels line in
    `rows`."""
    import torch
    torch.cuda.synchronize()
    kn, pn = k.cpu().numpy(), p.cpu().numpy()
    check(kn.shape == pn.shape and np.isfinite(kn).all(),
          f"{name}: shape {kn.shape} or non-finite values")
    s_plain = snr_db(pn, kn)
    s_gold = snr_db(oracle, kn[:ORACLE_ROWS]) if oracle is not None \
        else None
    err = float(np.abs(kn - pn).max())
    print(f"{name} {kn.shape[0]}x{kn.shape[1]}: SNR {s_plain:.1f} dB vs "
          f"plain, max |err| {err:.3e}"
          + (f", {s_gold:.1f} dB vs float64 (first {ORACLE_ROWS} rows)"
             if s_gold is not None else "")
          + ("; kernel {:.4f} ms, plain {:.4f} ms".format(*times)
             if times else ""))
    check(s_plain >= SNR_BAR_DB, f"{name} {s_plain:.1f} dB vs plain")
    check(s_gold is None or s_gold >= SNR_BAR_DB,
          f"{name} {s_gold} dB vs float64")
    if times:
        rows[name] = dict(max_abs_err=err, ms=times[0], plain_ms=times[1],
                          library_ms=None, **bound(*cost))


def phase_direct_kernels(dev):
    """Each DIRECT kernel against its plain version at full width."""
    import torch
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.fold import TonesDirectFold, fold, fold_plain
    from gpu_sdr_tpu_torch.ops.replay_ddc import make_replay_ddc
    from gpu_sdr_tpu_torch.ops.tonegen import (comb_period,
                                               tone_comb_wavetable_block)
    rng = np.random.default_rng(4321)
    rows = {}
    prefix = ORACLE_ROWS * D_DECIM              # samples the oracle reads

    # DDC (#7), streamed blocks, config 3 widths: block 0 with zero
    # history against the oracle, block 1 with the carried history timed
    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * len(CONFIG3))
    hmod = cfg.modulated_taps(dev)
    ramp = cfg.carrier_ramp(D_ROWS, dev)
    step = ddc.ddc_carrier_step(cfg, D_BLOCK, dev)
    x0_np = crandn(rng, D_BLOCK)
    x0, x1 = torch.from_numpy(x0_np).to(dev), torch.from_numpy(
        crandn(rng, D_BLOCK)).to(dev)
    st = (ddc.ddc_carrier_init(cfg, dev),
          torch.zeros((D_AVG - 1) * D_DECIM, dtype=torch.complex64,
                      device=dev))
    args = (hmod, ramp, step, D_RATE, cfg.M, cfg.f)
    ph, hist, yk = via_kernel("ddc", lambda: ddc.ddc_fused(*args, *st, x0))
    yp = ddc.direct_ddc_fir(*args, *st, x0)[2]
    report("ddc [block 0]", yk, yp, direct_oracle(
        x0_np[:prefix].astype(np.complex128), CONFIG3))
    yk = via_kernel("ddc", lambda: ddc.ddc_fused(*args, ph, hist, x1))[2]
    yp = ddc.direct_ddc_fir(*args, ph, hist, x1)[2]
    report("ddc", yk, yp, times=(
        time_ms(lambda: ddc.ddc_fused(*args, ph, hist, x1)),
        time_ms(lambda: ddc.direct_ddc_fir(*args, ph, hist, x1))), rows=rows,
        cost=(nbytes(x1, hist, hmod, ramp, ph, yk),
              ddc_flops(D_ROWS, len(CONFIG3), D_DECIM * D_AVG)))

    # replay DDC (#8, #9): the stream's first block (zero history)
    # against the oracle, its second (history wrapped at the seam) timed
    for name, freqs, ampl, kind in (
            ("replay_ddc", QCOMB, 0.01, "replay_kernel"),
            ("replay_ddc_t", CONFIG1, 1.0, "replay_kernel_t")):
        check(D_BLOCK % comb_period(freqs, D_RATE) == 0,
              f"{name}: comb not periodic in the block")
        rcfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(freqs),
                                   (0,) * len(freqs))
        rec = tone_comb_wavetable_block(freqs, [ampl] * len(freqs), D_RATE,
                                        D_BLOCK)
        rk = make_replay_ddc(rcfg, rec, D_BLOCK, dev)
        check(rk is not None and rk.path_name == kind,
              f"{name}: replay kind {getattr(rk, 'path_name', None)}")
        st0 = rk.init_state()
        st1, yk = via_kernel(name, lambda: rk.step(st0))
        report(f"{name} [block 0]", yk, rk.block_plain(st0),
               direct_oracle(comb(freqs, ampl, prefix), freqs))
        yk = via_kernel(name, lambda: rk.step(st1))[1]
        block_bytes = (D_BLOCK + (D_AVG - 1) * D_DECIM) * 8   # rows + halo
        report(name, yk, rk.block_plain(st1), times=(
            time_ms(lambda: rk.step(st1)),
            time_ms(lambda: rk.block_plain(st1))), rows=rows,
            cost=(block_bytes + nbytes(rk._hmod, rk._ramp, st1[1], yk),
                  ddc_flops(D_ROWS, len(freqs), D_DECIM * D_AVG)))

    # fold (#11) at config 3: the stream's first block, startup
    # correction applied, against plain and the oracle; then timed
    chain = TonesDirectFold(D_RATE, tuple(CONFIG3), (0.01,) * 100, cfg,
                            D_BLOCK, dev)
    st0 = chain.init_state()
    crot, qrot = chain.block_rotations_factored(st0)
    fargs = (chain.P1, chain.G2, crot, qrot, chain.ramp1, chain.nb)
    report("fold [stream start]",
           chain.startup_correction(st0, via_kernel(
               "fold", lambda: fold(*fargs))),
           chain.startup_correction(st0, fold_plain(*fargs)),
           direct_oracle(comb(CONFIG3, 0.01, prefix), CONFIG3))
    yk = via_kernel("fold", lambda: fold(*fargs))
    Ct, Cp = chain.G2.shape
    report("fold", yk, fold_plain(*fargs),
           times=(time_ms(lambda: fold(*fargs)),
                  time_ms(lambda: fold_plain(*fargs))), rows=rows,
           cost=(nbytes(*fargs[:5], yk), D_ROWS * Cp * (8 * Ct + 12)))
    return rows


class DirectCheck:
    """The DIRECT main path's packet callback: rows ::97 of every packet
    finite, within D_ROW_TOL of the TX amplitude row by row and within
    D_MEAN_TOL per channel on average (row 0 of the stream is the FIR's
    startup); keeps those rows of the first `keep` packets."""

    def __init__(self, channels: int, ampl: float, keep: int = 0,
                 seam: int = 0):
        self.channels, self.ampl, self.keep = channels, ampl, keep
        self.seam = seam        # a looped recording's blocks: row 0 of
        self.kept, self.n = [], 0   # each packet after its seam mixes both

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (D_ROWS, self.channels) and
              d.dtype == np.complex64, f"packet {self.n}: {d.shape} "
              f"{d.dtype}")
        sub = d[ROWS]
        check(bool(np.isfinite(sub).all()), f"packet {self.n}: non-finite")
        start = self.n == 0 or (self.seam and self.n % self.seam == 0)
        dev = np.abs(sub[1:] if start else sub) / self.ampl - 1.0
        check(float(np.abs(dev).max()) <= D_ROW_TOL,
              f"packet {self.n}: |y| off the TX amplitude by "
              f"{np.abs(dev).max():.4f}")
        check(float(np.abs(dev.mean(axis=0)).max()) <= D_MEAN_TOL,
              f"packet {self.n}: mean |y| off by "
              f"{np.abs(dev.mean(axis=0)).max():.4f}")
        if self.n < self.keep:
            self.kept.append(sub.copy())
        self.n += 1


def run_direct(dev, freqs, ampl, n_blocks, channel, keep=0):
    return run_path(dev, direct_params(freqs, ampl, n_blocks), channel,
                    DirectCheck(len(freqs), ampl, keep=keep), n_blocks,
                    D_BLOCK, len(freqs))


def phase_direct_main_path(dev):
    """The DIRECT readout through run_measurement, four runs."""
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    runs = (
        ("config 3 fused", CONFIG3, 0.01, D_FUSED_BLOCKS, None,
         "fold_kernel", "fold"),
        ("config 1 fused", CONFIG1, 1.0, D_FUSED_BLOCKS, None,
         "replay_kernel_t", "replay_ddc_t"),
        ("quantized 100-tone comb fused", QCOMB, 0.01, D_FUSED_BLOCKS, None,
         "replay_kernel", "replay_ddc"),
        ("config 3 host-fed", CONFIG3, 0.01, D_HOST_BLOCKS, IdealChannel(),
         None, "ddc"),
    )
    launches, kept = {}, {}
    for name, freqs, ampl, n, channel, sub, kernel in runs:
        run_direct(dev, freqs, ampl, D_WARMUP_BLOCKS, channel)   # warm-up
        (pkt, disp, msps, wall), counts = counted(
            lambda: run_direct(dev, freqs, ampl, n, channel,
                               keep=D_HOST_BLOCKS))
        want = (("A_RX2", "fused_loopback", sub),) if channel is None \
            else (("A_RX2", "host_pipeline", None),)
        print(f"DIRECT {name}: {disp}, {n} blocks of {D_BLOCK} samples, "
              f"{counts[kernel]} {kernel} launches; {msps:.1f} Msps "
              f"streaming, {wall:.3f} s with set-up")
        check(disp == want, f"{name} dispatch {disp}")
        check(counts[kernel] == n and
              all(v == 0 for k, v in counts.items() if k != kernel),
              f"{name} launches {counts}")
        launches[kernel] = counts[kernel]
        kept[name] = np.stack(pkt.kept)
    snr = snr_db(kept["config 3 fused"], kept["config 3 host-fed"])
    print(f"DIRECT config 3 host-fed vs fused, first {D_HOST_BLOCKS} blocks "
          f"(rows ::97): SNR {snr:.1f} dB")
    check(snr >= SNR_BAR_DB, f"DIRECT host-fed vs fused {snr:.1f} dB")
    return launches


def chirp_oracle(start: int, n: int) -> np.ndarray:
    """Float64 config-2 chirp at stream positions start .. start+n-1: the
    reference's quantized descriptor and uint64 phase accumulator
    (chirp_parameter, cpp/USRP_demodulator.cpp:192-221; chirp_gen,
    cpp/kernels.cu:335-372), the sin/cos in float64."""
    f_start, f_end = CONFIG2["freq"][0], CONFIG2["chirp_f"][0]
    steps, t = CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0]
    length = int(t * C_RATE / steps)
    u = np.uint64
    chirpness = u(int((2.0 ** 32 - 1) * (f_end - f_start) /
                      ((steps - 1.0) * C_RATE)) % 2 ** 32)
    f0 = u(int((2.0 ** 32 - 1) * (f_start / C_RATE)) % 2 ** 32)
    with np.errstate(over="ignore"):
        eff = np.arange(start, start + n, dtype=np.uint64) % u(steps * length)
        fi = eff // u(length)
        q = (fi // u(2)) * (fi + u(1)) + (fi % u(2)) * ((fi + u(1)) // u(2))
        idx = eff * (f0 + fi * chirpness) - chirpness * (u(length) * q)
    th = np.pi * (idx.astype(np.uint32).astype(np.int32) / 2147483647.5)
    return np.sin(th) - 1j * np.cos(th)


def phase_chirp_kernels(dev):
    """The CHIRP lock-in kernel's two modes against their plain versions
    and a float64 oracle at config 2's full width, over the real table."""
    import torch
    from gpu_sdr_tpu_torch.ops.chirp import ChirpConfig, chirp_period_table
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_table import (
        lockin_self, lockin_self_plain, lockin_table, lockin_table_plain)
    cfg = ChirpConfig.from_params(
        CONFIG2["freq"][0], CONFIG2["chirp_f"][0], C_RATE,
        CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0])
    ppt, nseg = cfg.length, C_BLOCK // cfg.length
    nblk = cfg.period // C_BLOCK
    check((ppt, nseg, nblk) == (20_000, C_ROWS, 25),
          f"config 2 geometry {ppt}, {nseg}, {nblk}")
    t0 = time.perf_counter()
    table = chirp_period_table(cfg, C_BLOCK, ppt, device=dev)
    torch.cuda.synchronize(dev)
    print(f"chirp table: {tuple(table.shape)}, {nbytes(table) / 1e6:.1f} MB "
          f"in {time.perf_counter() - t0:.3f} s")
    w_np = lockin_profile(ppt)
    w = torch.from_numpy(w_np).to(dev)
    wc = w.to(torch.complex64)                   # for the library call
    x_np = crandn(np.random.default_rng(2468), nseg, ppt)
    x = torch.from_numpy(x_np).to(dev)
    w64 = w_np.astype(np.float64)
    rows = {}

    def held(name, yk, yp, oracle=None):
        torch.cuda.synchronize(dev)
        kn, pn = yk.cpu().numpy(), yp.cpu().numpy()
        check(kn.shape == (nseg,) and np.isfinite(kn).all(),
              f"{name}: shape {kn.shape} or non-finite values")
        s_plain = snr_db(pn, kn)
        s_gold = None if oracle is None else snr_db(oracle, kn)
        print(f"{name}: SNR {s_plain:.1f} dB vs plain, max |err| "
              f"{np.abs(kn - pn).max():.3e}" +
              ("" if s_gold is None else f", {s_gold:.1f} dB vs float64"))
        check(s_plain >= SNR_BAR_DB, f"{name} {s_plain:.1f} dB vs plain")
        check(s_gold is None or s_gold >= SNR_BAR_DB,
              f"{name} {s_gold} dB vs float64")
        return float(np.abs(kn - pn).max())

    errs = {"lockin_self": 0.0, "lockin_table": 0.0}
    for o in (0, 1, nblk - 1):
        c64 = chirp_oracle(o * C_BLOCK, C_BLOCK).reshape(nseg, ppt) \
            if o in C_ORACLE_BLOCKS else None
        yk = via_kernel("lockin_self",
                        lambda: lockin_self(w, table, o, nseg))
        torch.cuda.synchronize(dev)
        check(bool((yk.imag == 0).all()),
              f"lockin_self block {o}: imaginary half not exactly 0")
        errs["lockin_self"] = max(errs["lockin_self"], held(
            f"lockin_self [block {o}]", yk,
            lockin_self_plain(w, table, o, nseg),
            None if c64 is None else (np.abs(c64) ** 2) @ w64))
        yk = via_kernel("lockin_table",
                        lambda: lockin_table(w, table, x, o, 0, nseg))
        errs["lockin_table"] = max(errs["lockin_table"], held(
            f"lockin_table [oscillator block {o}]", yk,
            lockin_table_plain(w, table, x, o, 0, nseg),
            None if c64 is None else (np.conj(c64) * x_np) @ w64))

    # self mode on a random, non-unit table of the same size: on the
    # chirp every row sums to sum(w) = 1, so only this shows that the
    # kernel reads the table's values at the right block's rows
    gen = torch.Generator(device=dev).manual_seed(1357)
    rand = torch.randn(table.shape, dtype=torch.complex64, device=dev,
                       generator=gen)
    for o in C_RANDOM_BLOCKS:
        yk = via_kernel("lockin_self", lambda: lockin_self(w, rand, o, nseg))
        torch.cuda.synchronize(dev)
        check(bool((yk.imag == 0).all()),
              f"lockin_self random block {o}: imaginary half not exactly 0")
        r64 = rand[o * nseg:(o + 1) * nseg].cpu().numpy().astype(
            np.complex128)
        errs["lockin_self"] = max(errs["lockin_self"], held(
            f"lockin_self [random table, block {o}]", yk,
            lockin_self_plain(w, rand, o, nseg), (np.abs(r64) ** 2) @ w64))
    del rand

    # times: rotate over every block of the table, (o, i) half a period
    # apart in table mode, so that each call reads its rows from HBM
    rot = itertools.count()

    def nxt():
        o = next(rot) % nblk
        return o, (o + nblk // 2) % nblk

    def rows_of(o, i=None):
        c = table[o * nseg:(o + 1) * nseg]
        return c, c if i is None else table[i * nseg:(i + 1) * nseg]

    def einsum(o, i=None):
        c, s = rows_of(o, i)
        return torch.einsum("sk,sk,k->s", c.conj(), s, wc)

    timed = {
        "lockin_self": (
            lambda: lockin_self(w, table, nxt()[0], nseg),
            lambda: lockin_self_plain(w, table, nxt()[0], nseg),
            lambda: einsum(nxt()[0]),
            nbytes(table[:nseg], w) + nseg * 8, 5 * nseg * ppt),
        "lockin_table": (
            lambda: lockin_table(w, table, table, *nxt(), nseg),
            lambda: lockin_table_plain(w, table, table, *nxt(), nseg),
            lambda: einsum(*nxt()),
            2 * nbytes(table[:nseg]) + nbytes(w) + nseg * 8,
            10 * nseg * ppt),
    }
    for name, (kern, plain, lib, n_bytes, flops) in timed.items():
        ms, pms, lms = (time_ms_queued(f, nblk) for f in (kern, plain, lib))
        b = bound(n_bytes, flops)
        print(f"{name} {nseg}x{ppt}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"library {lms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e6:.0f} MFLOP)")
        rows[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=pms,
                          library_ms=lms, **b)
    return rows


def phase_replay_kernels(dev):
    """The device replay's three kernels against their plain versions and
    a float64 oracle at full width: #4 (channelizer_at) on blocks of a
    random 8-block recording at the TONES geometry, and beside it #1's
    stream mode timed the same way; #6 (presum_at) on those blocks and
    at its main path's own shape, NOISE at nfft 1018 (the pfb_at
    sub-path's blocks of 5893 frames), whose times it reports; #18
    (lockin_at) on blocks of a random recording at config 2 with
    6,000,000-sample blocks (the period is no multiple of them)."""
    import torch
    from gpu_sdr_tpu_torch.engine.planner import plan_blocks
    from gpu_sdr_tpu_torch.ops.channelizer import (
        channelizer, channelizer_at, channelizer_at_plain, channelizer_consts)
    from gpu_sdr_tpu_torch.ops.chirp import ChirpConfig, chirp_block
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_at import lockin_at, lockin_at_plain
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.ops.presum import presum_at, presum_at_plain
    gen = torch.Generator(device=dev).manual_seed(97531)
    rows, errs = {}, {"channelizer_at": 0.0, "presum_at": 0.0,
                      "lockin_at": 0.0}

    def pre64(X, w, T, idx, valid):
        """Float64 pre-sum of the first 16 frames of block `idx`."""
        base, avg = idx * T, w.shape[0]
        halo = torch.arange(base - avg + 1, base, device=dev) % X.shape[0]
        ext = np.concatenate([
            X[halo].cpu().numpy() if valid else
            np.zeros((avg - 1, X.shape[1]), np.complex64),
            X[base:base + 16].cpu().numpy()]).astype(np.complex128)
        return sum(w[i] * ext[i:i + 16] for i in range(avg))

    def held_presum(tag, w2, X, T, idx, valid, keep_err):
        k = via_kernel("presum_at", lambda: presum_at(w2, X, idx, valid, T))
        p = presum_at_plain(w2, X, idx, valid, T)
        torch.cuda.synchronize(dev)
        kn, pn = k.cpu().numpy(), p.cpu().numpy()
        pre = pre64(X, w2.cpu().numpy().astype(np.float64), T, idx, valid)
        rel = float(np.linalg.norm(kn - pn) / np.linalg.norm(pn))
        rel64 = float(np.linalg.norm(kn[:16] - pre) / np.linalg.norm(pre))
        if keep_err:
            errs["presum_at"] = max(errs["presum_at"],
                                    float(np.abs(kn - pn).max()))
        print(f"presum_at [{tag}]: relative error {rel:.3e} vs plain, "
              f"{rel64:.3e} vs float64 (16 frames)")
        check(kn.shape == (T, X.shape[1]) and np.isfinite(kn).all() and
              rel <= PRESUM_REL_ERR and rel64 <= PRESUM_REL_ERR,
              f"presum_at [{tag}] relative error {rel:.3e} / {rel64:.3e}")

    # #4 and #6: a (8 * 6000, 1000) recording, 384 MB
    cfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    w2, F1, G = channelizer_consts(cfg, dev)
    X = torch.randn((R_BLOCKS * FRAMES, NFFT), dtype=torch.complex64,
                    device=dev, generator=gen)
    w = w2.cpu().numpy().astype(np.float64)
    for idx, valid in R_IDX:
        tag = f"block {idx}, valid {valid}"
        spec64 = np.fft.fft(pre64(X, w, FRAMES, idx, valid), axis=-1)
        k = via_kernel("channelizer_at", lambda: channelizer_at(
            w2, F1, G, X, idx, valid, FRAMES))
        p = channelizer_at_plain(w2, F1, G, X, idx, valid, FRAMES)
        torch.cuda.synchronize(dev)
        kn, pn = k.cpu().numpy(), p.cpu().numpy()
        check(kn.shape == (FRAMES, NFFT) and np.isfinite(kn).all(),
              f"channelizer_at [{tag}]: shape {kn.shape} or non-finite")
        s_plain, s_gold = snr_db(pn, kn), snr_db(spec64, kn[:16])
        errs["channelizer_at"] = max(errs["channelizer_at"],
                                     float(np.abs(kn - pn).max()))
        print(f"channelizer_at [{tag}]: SNR {s_plain:.1f} dB vs plain, "
              f"{s_gold:.1f} dB vs float64 (16 frames)")
        check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB,
              f"channelizer_at [{tag}] under {SNR_BAR_DB} dB")
        held_presum(f"nfft {NFFT}, {tag}", w2, X, FRAMES, idx, valid, False)
    # the seam's corners on small recordings (nfft 200, one-frame blocks,
    # avg 4): a halo that wraps in part (4 frames, block 1), and a
    # recording shorter than the halo, which wraps more than once
    sc = channelizer_consts(PFBConfig(nfft=200, avg=AVG, rate=RATE), dev)
    for total, idx in ((4, 1), (4, 0), (2, 1)):
        Xs = X[:total, :200].contiguous()
        k = via_kernel("channelizer_at", lambda: channelizer_at(
            *sc, Xs, idx, 1, 1))
        s_plain = snr_db(channelizer_at_plain(*sc, Xs, idx, 1, 1).cpu(),
                         k.cpu())
        print(f"channelizer_at [{total} frames, block {idx} of 1]: SNR "
              f"{s_plain:.1f} dB vs plain")
        check(s_plain >= SNR_BAR_DB, f"channelizer_at [{total} frames, "
              f"block {idx}] under {SNR_BAR_DB} dB")

    # times: rotate over the recording's blocks (384 MB, past the 50 MB
    # L2), each launch reading its block from HBM; #1's stream mode over
    # the same blocks, so that #4 and #1 differ only in their addressing
    rot = itertools.count()
    spare = X[:AVG - 1]

    def block():
        i = next(rot) % R_BLOCKS
        return X[i * FRAMES:(i + 1) * FRAMES]
    ms, pms = (time_ms_queued(f, 2 * R_BLOCKS) for f in (
        lambda: channelizer_at(w2, F1, G, X, next(rot) % R_BLOCKS, 1,
                               FRAMES),
        lambda: channelizer_at_plain(w2, F1, G, X, next(rot) % R_BLOCKS, 1,
                                     FRAMES)))
    stream_ms = time_ms_queued(
        lambda: channelizer(w2, F1, G, spare, block()), 2 * R_BLOCKS)
    b = bound(2 * FRAMES * NFFT * 8 + nbytes(w2, F1, G),
              FRAMES * (4 * AVG * NFFT + 5 * NFFT * np.log2(NFFT)))
    print(f"channelizer_at {FRAMES}x{NFFT}: kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
          f"channelizer stream mode over the same blocks {stream_ms:.4f} ms")
    rows["channelizer_at"] = dict(max_abs_err=errs["channelizer_at"], ms=ms,
                                  plain_ms=pms, library_ms=None, **b)
    del X, spare

    # #6 at its main path's shape: the pfb_at run's NOISE receiver at nfft
    # 1018, blocks of T frames, over an 8-block recording (~384 MB)
    ncfg = PFBConfig(nfft=R_NFFT, avg=AVG, rate=RATE)
    wn = ncfg.window(dev).reshape(AVG, R_NFFT)
    T = plan_blocks(noise1018_params(1).A_RX2).block_len // R_NFFT
    X = torch.randn((R_BLOCKS * T, R_NFFT), dtype=torch.complex64,
                    device=dev, generator=gen)
    for idx, valid in R_IDX:
        held_presum(f"nfft {R_NFFT}, block {idx}, valid {valid}", wn, X, T,
                    idx, valid, True)
    rot = itertools.count()
    ms, pms = (time_ms_queued(f, 2 * R_BLOCKS) for f in (
        lambda: presum_at(wn, X, next(rot) % R_BLOCKS, 1, T),
        lambda: presum_at_plain(wn, X, next(rot) % R_BLOCKS, 1, T)))
    # bytes: the block read once, the (T, nfft) output written once
    b = bound(2 * T * R_NFFT * 8 + nbytes(wn), 4 * AVG * T * R_NFFT)
    print(f"presum_at {T}x{R_NFFT}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    rows["presum_at"] = dict(max_abs_err=errs["presum_at"], ms=ms,
                             plain_ms=pms, library_ms=None, **b)
    del X

    # #18: config 2 at 6,000,000-sample blocks, 300 segments of 20,000
    ccfg = ChirpConfig.from_params(
        CONFIG2["freq"][0], CONFIG2["chirp_f"][0], C_RATE,
        CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0])
    ppt, nseg = ccfg.length, AT_BLOCK // ccfg.length
    check(ppt == 20_000 and ccfg.period % AT_BLOCK,
          f"chirp_at geometry {ppt}, {nseg}, period {ccfg.period}")
    wp_np = lockin_profile(ppt)
    wp, wp64 = torch.from_numpy(wp_np).to(dev), wp_np.astype(np.float64)
    Xc = torch.randn((R_BLOCKS * nseg, ppt), dtype=torch.complex64,
                     device=dev, generator=gen)
    for pos, idx in zip(AT_POSITIONS, (0, 3, 7)):
        tag = f"position {pos}, block {idx}"
        new, yk = via_kernel("lockin_at", lambda: lockin_at(
            ccfg, wp, pos, Xc, idx, nseg))
        yp = lockin_at_plain(ccfg, wp, pos, Xc, idx, nseg)
        torch.cuda.synchronize(dev)
        check(new == (pos + AT_BLOCK) % ccfg.period,
              f"lockin_at [{tag}]: new position {new}")
        kn, pn = yk.cpu().numpy(), yp.cpu().numpy()
        x64 = Xc[idx * nseg:(idx + 1) * nseg].cpu().numpy()
        y64 = (np.conj(chirp_oracle(pos, AT_BLOCK).reshape(nseg, ppt)) *
               x64) @ wp64
        check(kn.shape == (nseg,) and np.isfinite(kn).all(),
              f"lockin_at [{tag}]: shape {kn.shape} or non-finite")
        s_plain, s_gold = snr_db(pn, kn), snr_db(y64, kn)
        errs["lockin_at"] = max(errs["lockin_at"],
                                float(np.abs(kn - pn).max()))
        print(f"lockin_at [{tag}]: SNR {s_plain:.1f} dB vs plain, "
              f"{s_gold:.1f} dB vs float64")
        check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB,
              f"lockin_at [{tag}] under {SNR_BAR_DB} dB")
    # fed the chirp itself (across the period seam), every lock-in point
    # is sum_k w[k] |c|^2 = 1
    pos = AT_POSITIONS[-1]
    chirp = chirp_block(ccfg, pos, AT_BLOCK, device=dev)[1].reshape(nseg, ppt)
    _, yk = via_kernel("lockin_at", lambda: lockin_at(ccfg, wp, pos, chirp,
                                                      0, nseg))
    off = float((yk - 1).abs().max())
    print(f"lockin_at [the chirp from position {pos}]: max |y - 1| {off:.2e}")
    check(off <= C_TOL, f"lockin_at on the chirp: |y - 1| {off:.2e}")
    del chirp
    rot = itertools.count()

    def at_args():
        i = next(rot)
        return ccfg, wp, (i * AT_BLOCK) % ccfg.period, Xc, i % R_BLOCKS, nseg

    ms, pms = (time_ms_queued(lambda: f(*at_args()), 2 * R_BLOCKS)
               for f in (lockin_at, lockin_at_plain))
    b = bound(nseg * ppt * 8 + nbytes(wp) + nseg * 8,
              CHIRP_AT_OPS * nseg * ppt)
    print(f"lockin_at {nseg}x{ppt}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    rows["lockin_at"] = dict(max_abs_err=errs["lockin_at"], ms=ms,
                             plain_ms=pms, library_ms=None, **b)
    return rows


def comb_at(freqs, ampl, a0: int, n: int) -> np.ndarray:
    """Samples a0 .. a0+n-1 of a TX comb in float64, exact integer phases
    (zero before sample 0: the stream's start)."""
    t = np.arange(a0, a0 + n, dtype=np.int64)
    x = np.zeros(n, dtype=np.complex128)
    for f in freqs:
        x += ampl * np.exp(2j * np.pi * (((f % D_RATE) * (t % D_RATE)) %
                                         D_RATE) / D_RATE)
    x[t < 0] = 0
    return x


def direct_oracle_at(x: np.ndarray, freqs) -> np.ndarray:
    """direct_oracle of rows from absolute sample a0 on, x holding
    samples a0 - (f-1)*M .. of the stream (its history first) and the
    carrier at their absolute index: x = (samples, a0)."""
    xs, a0 = x
    h = sinc_taps(D_DECIM * D_AVG, 0.75 / (2.0 * D_DECIM))
    t = np.arange(a0 - (D_AVG - 1) * D_DECIM,
                  a0 - (D_AVG - 1) * D_DECIM + len(xs), dtype=np.int64)
    out = np.empty((ORACLE_ROWS, len(freqs)), dtype=np.complex128)
    for c, f in enumerate(freqs):
        z = xs * np.exp(-2j * np.pi * (((f % D_RATE) * (t % D_RATE)) %
                                       D_RATE) / D_RATE)
        win = np.lib.stride_tricks.sliding_window_view(z, len(h))
        out[:, c] = win[::D_DECIM][:ORACLE_ROWS] @ h
    return out


def phase_sharded_kernels(dev):
    """The sharded layer's kernels against their plain versions and a
    float64 oracle at full width, each on a (time=2) mesh's shards: #5
    (channelizer_at_halo) on an 8-block TONES recording, #10
    (ShardedReplayDDC) on an 8-block config-3 recording, #15 (chain) at
    config 3 through use_fold=False; each at the stream's start, inside
    and at the loop (or block) seam, on shard 0 and shard 1.  Times as
    phase 10 (#5, #10: queued over rotating blocks) or phase 6 (#15, and
    the library call: one matmul of the stacked rotated rows)."""
    import torch
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.chain import (TonesDirectChain, chain,
                                             chain_plain)
    from gpu_sdr_tpu_torch.ops.channelizer import (
        channelizer_at_halo, channelizer_at_halo_plain, channelizer_consts)
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.ops.presum import shard_spans, staged_halos
    from gpu_sdr_tpu_torch.ops.replay_ddc import ShardedReplayDDC
    gen = torch.Generator(device=dev).manual_seed(24680)
    rows, T = {}, 2
    # (block, valid, shard): stream start on both shards (valid is
    # shard 0's only), inside, the last block, block 0 after the seam
    cases = ((0, 0, 0), (0, 0, 1), (3, 1, 0), (7, 1, 1), (0, 1, 0),
             (0, 1, 1))

    # #5: TONES, 3000 frames per shard per block, 8 blocks (384 MB)
    cfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    w2, F1, G = channelizer_consts(cfg, dev)
    ftl = FRAMES // T
    X = torch.randn((R_BLOCKS * FRAMES, NFFT), dtype=torch.complex64,
                    device=dev, generator=gen)
    spans = shard_spans(X, R_BLOCKS, T)
    halos = staged_halos(X, R_BLOCKS, T, AVG - 1)
    w = w2.cpu().numpy().astype(np.float64)
    err = 0.0
    for idx, valid, t in cases:
        v = valid if t == 0 else 1
        tag = f"block {idx}, shard {t}, valid {v}"
        k = via_kernel("channelizer_at_halo", lambda: channelizer_at_halo(
            w2, F1, G, spans[t], halos[t], idx, v, ftl))
        p = channelizer_at_halo_plain(w2, F1, G, spans[t], halos[t], idx, v,
                                      ftl)
        base = idx * FRAMES + t * ftl                # in stream order
        hrows = torch.arange(base - AVG + 1, base, device=dev) % X.shape[0]
        ext = np.concatenate([
            X[hrows].cpu().numpy() if v else
            np.zeros((AVG - 1, NFFT), np.complex64),
            X[base:base + 16].cpu().numpy()]).astype(np.complex128)
        spec64 = np.fft.fft(sum(w[i] * ext[i:i + 16] for i in range(AVG)),
                            axis=-1)
        torch.cuda.synchronize(dev)
        kn, pn = k.cpu().numpy(), p.cpu().numpy()
        check(kn.shape == (ftl, NFFT) and np.isfinite(kn).all(),
              f"channelizer_at_halo [{tag}]: shape or non-finite")
        s_plain, s_gold = snr_db(pn, kn), snr_db(spec64, kn[:16])
        err = max(err, float(np.abs(kn - pn).max()))
        print(f"channelizer_at_halo [{tag}]: SNR {s_plain:.1f} dB vs "
              f"plain, {s_gold:.1f} dB vs float64 (16 frames)")
        check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB,
              f"channelizer_at_halo [{tag}] under {SNR_BAR_DB} dB")
    rot = itertools.count()

    def nxt():
        i = next(rot)
        return spans[i % T], halos[i % T], (i // T) % R_BLOCKS

    ms, pms = (time_ms_queued(lambda: f(w2, F1, G, *nxt(), 1, ftl),
                              2 * R_BLOCKS)
               for f in (channelizer_at_halo, channelizer_at_halo_plain))
    b = bound(2 * ftl * NFFT * 8 + (AVG - 1) * NFFT * 8 + nbytes(w2, F1, G),
              ftl * (4 * AVG * NFFT + 5 * NFFT * np.log2(NFFT)))
    print(f"channelizer_at_halo {ftl}x{NFFT}: kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    rows["channelizer_at_halo"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       library_ms=None, **b)
    del X, spans, halos

    # #10: config 3, 20,000 rows per shard per block, 8 blocks (256 MB)
    dcfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                               (0,) * len(CONFIG3))
    rec = torch.randn(R_BLOCKS * D_BLOCK, dtype=torch.complex64, device=dev,
                      generator=gen)
    rk = ShardedReplayDDC(dcfg, rec, D_BLOCK, [dev] * T)
    nbt, H = rk.nbr_t, (D_AVG - 1) * D_DECIM
    rec_np = rec.cpu().numpy()
    st0 = rk.init_state()
    err = 0.0
    for idx, valid, t in cases:
        # the block `idx` of a stream that has run `idx` blocks, or, at the
        # seam, R_BLOCKS: its carrier phase advanced by as many
        nabs = R_BLOCKS if (idx, valid) == (0, 1) else idx
        ph = st0[1]
        for _ in range(nabs):
            ph = rk.advance((0, ph, 1))[1]
        st = (idx, ph, valid)
        tag = f"block {idx}, shard {t}, valid {valid if t == 0 else 1}"
        yk = via_kernel("replay_ddc_sharded", lambda: rk.local(st, t))
        a0 = nabs * D_BLOCK + t * (D_BLOCK // T)     # absolute first row
        hist = (np.arange(a0 - H, a0 + ORACLE_ROWS * D_DECIM) %
                len(rec_np))
        xs = rec_np[hist].astype(np.complex128)
        if a0 == 0 and not valid:
            xs[:H] = 0
        report(f"replay_ddc_sharded [{tag}]", yk, rk.local_plain(st, t),
               direct_oracle_at((xs, a0), CONFIG3))
        err = max(err, float((yk - rk.local_plain(st, t)).abs().max()))
    rot = itertools.count()

    def rst():
        i = next(rot)
        return ((i // T) % R_BLOCKS, st0[1], 1), i % T

    ms, pms = (time_ms_queued(lambda: f(*rst()), 2 * R_BLOCKS)
               for f in (rk.local, rk.local_plain))
    b = bound((nbt + D_AVG - 1) * D_DECIM * 8 +
              nbytes(rk._hmod[0], rk._ramp[0], st0[1]) + nbt * 100 * 8,
              ddc_flops(nbt, len(CONFIG3), D_DECIM * D_AVG))
    print(f"replay_ddc_sharded {nbt}x{len(CONFIG3)}: kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    rows["replay_ddc_sharded"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                      library_ms=None, **b)
    del rk, rec

    # #15: config 3 through use_fold=False, 20,000 rows per shard
    ch = TonesDirectChain(D_RATE, tuple(CONFIG3), (0.01,) * 100, dcfg,
                          D_BLOCK, time_shards=T)
    check(ch.ok and ch.nb // T == nbt, "chain geometry")
    Pt = [ch.P[t * nbt:(t + 1) * nbt].to(dev) for t in range(T)]
    hPt = [ch.halo_rows(t * nbt).to(dev) for t in range(T)]
    Gd, ramp = ch.G.to(dev), ch.ramp.to(dev)
    rampt = [ramp[t * nbt:(t + 1) * nbt] for t in range(T)]
    st = ch.init_state(dev)
    states = []
    for blk in range(R_BLOCKS):
        states.append(st)
        st = ch.block_rotations(st)[0]
    err = 0.0
    for blk, t in ((0, 0), (0, 1), (1, 0), (1, 1), (7, 0)):
        _, srot, hrot0, drot = ch.block_rotations(states[blk])
        args = (Pt[t], hPt[t], Gd, rampt[t], srot,
                hrot0 if t == 0 else srot, drot)
        yk = via_kernel("chain", lambda: chain(*args))
        a0 = blk * D_BLOCK + t * (D_BLOCK // T)
        xs = comb_at(CONFIG3, 0.01, a0 - H, H + ORACLE_ROWS * D_DECIM)
        report(f"chain [block {blk}, shard {t}]", yk, chain_plain(*args),
               direct_oracle_at((xs, a0), CONFIG3))
        err = max(err, float((yk - chain_plain(*args)).abs().max()))
    _, srot, hrot0, drot = ch.block_rotations(states[1])
    args = (Pt[1], hPt[1], Gd, rampt[1], srot, srot, drot)
    f = Gd.shape[0]
    E = torch.cat([hPt[1] * srot, Pt[1] * srot])
    A = torch.cat([E[j:j + nbt] for j in range(f)], dim=1)   # (nbt, f*Ct)
    Gr = Gd.reshape(-1, Gd.shape[2])
    ms, pms, lms = (time_ms(fn) for fn in (
        lambda: chain(*args), lambda: chain_plain(*args), lambda: A @ Gr))
    Ct, Cp = Gd.shape[1], Gd.shape[2]
    b = bound(nbytes(*args) + nbt * Cp * 8, nbt * Cp * (8 * f * Ct + 12))
    print(f"chain {nbt}x{Cp}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"library (matmul of the stacked rows) {lms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    rows["chain"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                         library_ms=lms, **b)
    return rows


class ChirpCheck:
    """The CHIRP main path's packet callback: every lock-in point of
    every packet finite and within C_TOL of the TX amplitude; keeps the
    first `keep` packets."""

    def __init__(self, keep: int = 0, rows: int = C_ROWS,
                 ampl_packets=None):
        self.keep, self.rows, self.kept, self.n = keep, rows, [], 0
        # packets whose lock-in points are checked against the amplitude
        # (a replayed recording's blocks before its first wrap), else all
        self.ampl_packets = ampl_packets

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (self.rows, 1) and d.dtype == np.complex64,
              f"packet {self.n}: {d.shape} {d.dtype}")
        check(bool(np.isfinite(d).all()), f"packet {self.n}: non-finite")
        off = float(np.abs(np.abs(d) - C_AMPL).max())
        check(off <= C_TOL or (self.ampl_packets is not None and
                               self.n >= self.ampl_packets),
              f"packet {self.n}: a lock-in point is {off:.2e} off the TX "
              "amplitude")
        if self.n < self.keep:
            self.kept.append(d.copy())
        self.n += 1


def phase_chirp_main_path(dev):
    """The CHIRP readout through run_measurement: config 2 fused (self
    mode) and host-fed (table mode)."""
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    runs = (("config 2 fused", C_FUSED_BLOCKS, None, "chirp_wavetable",
             "lockin_self"),
            ("config 2 host-fed", C_HOST_BLOCKS, IdealChannel(), None,
             "lockin_table"))
    launches, kept = {}, {}
    for name, n, channel, sub, kernel in runs:
        run_path(dev, chirp_params(C_WARMUP_BLOCKS), channel,
                 ChirpCheck(), C_WARMUP_BLOCKS, C_BLOCK, 1)     # warm-up
        (pkt, disp, msps, wall), counts = counted(
            lambda: run_path(dev, chirp_params(n), channel,
                             ChirpCheck(keep=C_HOST_BLOCKS), n, C_BLOCK, 1))
        want = (("A_RX2", "fused_loopback", sub),) if channel is None \
            else (("A_RX2", "host_pipeline", None),)
        print(f"CHIRP {name}: {disp}, {n} blocks of {C_BLOCK} samples, "
              f"{counts[kernel]} {kernel} launches; {msps:.1f} Msps "
              f"streaming, {wall:.3f} s with set-up")
        check(disp == want, f"{name} dispatch {disp}")
        check(counts[kernel] == n and
              all(v == 0 for k, v in counts.items() if k != kernel),
              f"{name} launches {counts}")
        launches[kernel] = counts[kernel]
        kept[name] = np.concatenate(pkt.kept)
    snr = snr_db(kept["config 2 fused"], kept["config 2 host-fed"])
    print(f"CHIRP config 2 host-fed vs fused, first {C_HOST_BLOCKS} blocks: "
          f"SNR {snr:.1f} dB")
    check(snr >= SNR_BAR_DB, f"CHIRP host-fed vs fused {snr:.1f} dB")
    return launches


class KeepCheck:
    """A replay run's packet callback where the rows have no fixed
    amplitude (noise, or a recording past its end): packets in order, of
    the expected shape, rows ::97 finite; keeps those rows of the first
    `keep` packets."""

    def __init__(self, rows: int, channels: int, keep: int = 0):
        self.rows, self.channels, self.keep = rows, channels, keep
        self.kept, self.n = [], 0

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (self.rows, self.channels) and
              d.dtype == np.complex64, f"packet {self.n}: {d.shape} "
              f"{d.dtype}")
        sub = d[ROWS]
        check(bool(np.isfinite(sub).all()), f"packet {self.n}: non-finite")
        if self.n < self.keep:
            self.kept.append(sub.copy())
        self.n += 1


def noise1018_params(n_blocks: int):
    """A full-spectrum NOISE receiver at nfft 1018 (split 2 x 509, whose
    stage-2 constants do not fit one block's shared memory, so the
    channelizer refuses it) at 100 Msps, ~6,000,000-sample blocks."""
    from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams,
                                          UsrpParams, WaveType)
    from gpu_sdr_tpu_torch.engine.planner import plan_blocks
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=R_NFFT,
                            pf_average=AVG, buffer_len=BLOCK, freq=[0],
                            wave_type=[WaveType.NOISE])
    p.A_RX2.samples = n_blocks * plan_blocks(p.A_RX2).block_len
    return p


def host_fed_replay(dev, params, path, loop, pkt):
    """The recording at `path` through the host-fed pipeline
    (engine.run_pipeline over a ReplaySource), into `pkt`."""
    from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    from gpu_sdr_tpu_torch.engine.sources import ReplaySource
    params.validate()
    run_pipeline(make_demodulator(params.A_RX2, dev),
                 ReplaySource(path, loop=loop), [CallbackSink(pkt)])
    return pkt


def replay_run(dev, name, params, path, loop, make_pkt, n, block, channels,
               sub, kernel):
    """run_measurement(source=ReplaySource(path)) after a warm-up, its
    launches counted: (pkt, launches of `kernel`)."""
    from gpu_sdr_tpu_torch.engine.sources import ReplaySource

    def run(n_blocks, pkt):
        return run_path(dev, receiver_only(params(n_blocks)), None, pkt,
                        n_blocks, block, channels,
                        source=ReplaySource(path, loop=loop))
    run(2, make_pkt())                                      # warm-up
    (pkt, disp, msps, wall), counts = counted(lambda: run(n, make_pkt()))
    print(f"replay {name}: {disp}, {n} blocks of {block} samples, "
          f"{counts[kernel]} {kernel} launches; {msps:.1f} Msps "
          f"streaming, {wall:.3f} s with set-up (the upload)")
    check(disp == (("A_RX2", "device_replay", sub),),
          f"replay {name} dispatch {disp}")
    check(counts[kernel] == n and
          all(v == 0 for k, v in counts.items() if k != kernel),
          f"replay {name} launches {counts}")
    return pkt, counts[kernel]


def held_against(name, ref, got, against="the host-fed run") -> bool:
    """Check a replay's kept rows against `ref`'s at SNR_BAR_DB; whether
    they are bit-identical."""
    ref, got = np.stack(ref), np.stack(got)
    same = np.array_equal(ref, got)
    snr = snr_db(ref, got)
    print(f"replay {name} vs {against}: SNR {snr:.1f} dB"
          + (", bit-identical" if same else ""))
    check(snr >= SNR_BAR_DB, f"replay {name} vs {against}: {snr:.1f} dB")
    return same


def phase_replay_main_path(dev, tones_fused):
    """The device replay through run_measurement(source=ReplaySource):
    one run per sub-path, each of a recording made on the card, and
    SegmentedDeviceReplay driven directly."""
    import tempfile

    import torch
    from gpu_sdr_tpu_torch.engine.planner import plan_blocks
    from gpu_sdr_tpu_torch.engine.replay import SegmentedDeviceReplay
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink

    def config3(n):
        return direct_params(CONFIG3, 0.01, n)

    def config1(n):
        return direct_params(CONFIG1, 1.0, n)

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # TONES: the phase-4 comb, one-frame-periodic, so the loop is
        # seamless and the replay equals the fused run
        rec_blocks, n = R_TONES
        path = save_recording(tmp, "tones", tx_recording(
            loopback_params, rec_blocks, BLOCK, dev))
        pkt, launches["channelizer_at"] = replay_run(
            dev, "TONES", loopback_params, path, True,
            lambda: PacketCheck(FRAMES, keep=HOST_BLOCKS), n, BLOCK, NFFT,
            "channelizer_at", "channelizer_at")
        held_against("TONES", tones_fused, pkt.kept,
                     f"the fused run's first {HOST_BLOCKS} blocks")

        # NOISE at nfft 1018: the pre-sum kernel in place, then the FFT
        rec_blocks, n = R_NOISE
        L = plan_blocks(noise1018_params(1).A_RX2).block_len
        gen = torch.Generator(device=dev).manual_seed(8642)
        path = save_recording(tmp, "noise", torch.randn(
            rec_blocks * L, dtype=torch.complex64, device=dev,
            generator=gen).cpu().numpy())
        T = L // R_NFFT
        pkt, launches["presum_at"] = replay_run(
            dev, f"NOISE nfft {R_NFFT}", noise1018_params, path, True,
            lambda: KeepCheck(T, R_NFFT, keep=n), n, L, R_NFFT, "pfb_at",
            "presum_at")
        host = host_fed_replay(dev, noise1018_params(n), path, True,
                               KeepCheck(T, R_NFFT, keep=n))
        held_against(f"NOISE nfft {R_NFFT}", host.kept, pkt.kept)

        # DIRECT config 3 (replay_kernel) and config 1 (replay_kernel_t)
        rec_blocks, n = R_DIRECT
        for name, cfg, freqs, ampl, sub, kernel in (
                ("DIRECT config 3", config3, CONFIG3, 0.01,
                 "replay_kernel", "replay_ddc"),
                ("DIRECT config 1", config1, CONFIG1, 1.0,
                 "replay_kernel_t", "replay_ddc_t")):
            path = save_recording(tmp, sub, tx_recording(
                cfg, rec_blocks, D_BLOCK, dev))
            pkt, _ = replay_run(
                dev, name, cfg, path, True,
                lambda: DirectCheck(len(freqs), ampl, keep=n,
                                    seam=rec_blocks),
                n, D_BLOCK, len(freqs), sub, kernel)
            host = host_fed_replay(dev, receiver_only(cfg(D_HOST_BLOCKS)),
                                   path, True,
                                   DirectCheck(len(freqs), ampl,
                                               keep=D_HOST_BLOCKS,
                                               seam=rec_blocks))
            held_against(name, host.kept, pkt.kept[:D_HOST_BLOCKS])

        # CHIRP config 2: the table (chirp_table) and, at 6,000,000-sample
        # blocks, the in-kernel chirp (chirp_at); amplitude 1 until the
        # recording wraps, then against the host-fed run
        for name, cfg, (rec_blocks, n), block, sub, kernel in (
                ("CHIRP config 2", chirp_params, R_CHIRP, C_BLOCK,
                 "chirp_table", "lockin_table"),
                ("CHIRP config 2, 6M blocks", chirp6m_params, R_CHIRP6M,
                 AT_BLOCK, "chirp_at", "lockin_at")):
            path = save_recording(tmp, sub, tx_recording(
                cfg, rec_blocks, block, dev))
            rows = block // (C_BLOCK // C_ROWS)         # segments
            pkt, count = replay_run(
                dev, name, cfg, path, True,
                lambda: ChirpCheck(keep=n, rows=rows,
                                   ampl_packets=rec_blocks),
                n, block, 1, sub, kernel)
            if kernel == "lockin_at":
                launches[kernel] = count
            host = host_fed_replay(dev, receiver_only(cfg(n)), path, True,
                                   ChirpCheck(keep=n, rows=rows,
                                              ampl_packets=rec_blocks))
            held_against(name, host.kept, pkt.kept)

        # scan: a config-3 recording of 5.5 blocks, not looped; the
        # demodulator's own step (the DDC kernel) over its views
        rec_blocks, n = R_SCAN
        rec = tx_recording(config3, int(np.ceil(rec_blocks)), D_BLOCK, dev)
        path = save_recording(tmp, "scan",
                              rec[:int(rec_blocks * D_BLOCK)])
        pkt, _ = replay_run(
            dev, "DIRECT config 3, not looped", config3, path, False,
            lambda: KeepCheck(D_ROWS, len(CONFIG3), keep=n), n, D_BLOCK,
            len(CONFIG3), "scan", "ddc")
        host = host_fed_replay(dev, receiver_only(config3(n)), path, False,
                               KeepCheck(D_ROWS, len(CONFIG3), keep=n))
        exact = held_against("DIRECT config 3, not looped", host.kept,
                             pkt.kept)
        print("  scan runs the host-fed path's DDC kernel on the same "
              "samples" + ("" if exact else
                           ": not bit-identical (the kernel's sums)"))

        # SegmentedDeviceReplay: segments of 2 blocks over 16 blocks
        params = receiver_only(config3(R_SEG_ACQ))
        params.validate()
        for rec_blocks, loop in R_SEGMENTED:
            name = f"segmented, {rec_blocks} blocks" + \
                (", looped" if loop else "")
            sr = SegmentedDeviceReplay(
                params.A_RX2, rec[:rec_blocks * D_BLOCK], loop=loop,
                segment_bytes=R_SEG_BLOCKS * D_BLOCK * 8, device=dev)
            check(sr.seg_blocks == R_SEG_BLOCKS, f"{name}: segment blocks")
            pkt = KeepCheck(D_ROWS, len(CONFIG3), keep=R_SEG_ACQ)
            t0 = time.perf_counter()
            res, counts = counted(lambda: sr.run([CallbackSink(pkt)]))
            wall = time.perf_counter() - t0
            check(pkt.n == R_SEG_ACQ and counts["ddc"] == R_SEG_ACQ and
                  all(v == 0 for k, v in counts.items() if k != "ddc"),
                  f"{name}: {pkt.n} packets, launches {counts}")
            path = save_recording(tmp, "seg", rec[:rec_blocks * D_BLOCK])
            host = host_fed_replay(dev, receiver_only(config3(R_SEG_ACQ)),
                                   path, loop,
                                   KeepCheck(D_ROWS, len(CONFIG3),
                                             keep=R_SEG_ACQ))
            stage = ", ".join(f"{1e3 * t:.1f}" for t in sr.stage_seconds)
            print(f"replay {name}: {R_SEG_ACQ} blocks, {res.msps:.1f} Msps "
                  f"streaming, {wall:.3f} s with set-up; staging ms per "
                  f"segment [{stage}]")
            held_against(name, host.kept, pkt.kept)
    return launches


def phase_sharded_main_path(dev, meshes=None):
    """The sharded layer through run_measurement(mesh=...) on `meshes`:
    a time-only mesh (by default (2, 1) of this card, virtual shards) for
    TONES fused, config 3 fused and its g_chain (ShardedFusedDirect with
    use_fold=False, which run_measurement never takes), config 2 fused,
    the TONES and config-3 replays, a not-looped config-3 replay (scan)
    and ShardedSegmentedReplay; a (time, channels) mesh (by default
    (2, 2)) for TONES host-fed.  Each run is held against the port's
    unsharded run of the same measurement at >= 90 dB; its kernel
    launched once per shard and block, no other."""
    import tempfile

    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    from gpu_sdr_tpu_torch.engine.replay import SegmentedDeviceReplay
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    from gpu_sdr_tpu_torch.engine.sources import ReplaySource
    from gpu_sdr_tpu_torch.parallel import make_mesh
    from gpu_sdr_tpu_torch.parallel.fused_sharded import (ShardedFusedDirect,
                                                          plan_sharded_block)
    from gpu_sdr_tpu_torch.parallel.sharded_replay import \
        ShardedSegmentedReplay
    m21, m22 = meshes or (make_mesh((2, 1), devices=[dev] * 2),
                          make_mesh((2, 2), devices=[dev] * 4))
    launches = {}

    def config3(n):
        return direct_params(CONFIG3, 0.01, n)

    def held(name, ref, got):
        ref, got = np.stack(ref), np.stack(got)
        check(ref.shape == got.shape, f"sharded {name}: {got.shape} rows "
              f"kept, unsharded {ref.shape}")
        snr = snr_db(ref, got)
        print(f"sharded {name} vs unsharded: SNR {snr:.1f} dB"
              + (", bit-identical" if np.array_equal(ref, got) else ""))
        check(snr >= SNR_BAR_DB, f"sharded {name} vs unsharded {snr:.1f} dB")

    def sharded(name, mesh, run, want, kernel, n):
        """run() -> (pkt, dispatch, Msps, wall), its launches counted."""
        (pkt, disp, msps, wall), counts = counted(run)
        shards = mesh.T * mesh.Kc
        print(f"sharded {name} {tuple(mesh.shape.values())}: {disp}, {n} "
              f"blocks, {counts[kernel]} {kernel} launches; {msps:.1f} Msps "
              f"streaming, {wall:.3f} s with set-up")
        check(disp == (("A_RX2",) + want,) if want else True,
              f"sharded {name} dispatch {disp}")
        check(counts[kernel] == n * shards and
              all(v == 0 for k, v in counts.items() if k != kernel),
              f"sharded {name} launches {counts}")
        launches[kernel] = counts[kernel]
        return pkt

    def measured(params, n, pkt, block, channels, channel=None, mesh=None,
                 source=None):
        return lambda: run_path(dev, params(n), channel, pkt, n, block,
                                channels, source=source, mesh=mesh)

    n = S_BLOCKS
    # TONES: fused on (2, 1), host-fed on (2, 2) (the ShardedPFB psum)
    ref = measured(loopback_params, n, PacketCheck(FRAMES, keep=n), BLOCK,
                   NFFT)()[0].kept
    pkt = sharded("TONES fused", m21, measured(
        loopback_params, n, PacketCheck(FRAMES, keep=n), BLOCK, NFFT,
        mesh=m21), ("sharded_fused", "channelizer_wavetable"),
        "channelizer", n)
    held("TONES fused", ref, pkt.kept)
    pkt = sharded("TONES host-fed", m22, measured(
        loopback_params, S_HOST, PacketCheck(FRAMES, keep=S_HOST), BLOCK,
        NFFT, channel=IdealChannel(), mesh=m22), ("host_pipeline", None),
        "presum", S_HOST)
    held("TONES host-fed", ref[:S_HOST], pkt.kept)
    tones_ref = ref

    # DIRECT config 3: fold_kernel through run_measurement, g_chain direct
    ref = measured(config3, n, DirectCheck(100, 0.01, keep=n), D_BLOCK,
                   100)()[0].kept
    pkt = sharded("config 3 fused", m21, measured(
        config3, n, DirectCheck(100, 0.01, keep=n), D_BLOCK, 100, mesh=m21),
        ("sharded_fused", "fold_kernel"), "fold", n)
    held("config 3 fused", ref, pkt.kept)
    p = config3(n)
    p.validate()
    L, _ = plan_sharded_block(p.A_RX2, m21)
    sf = ShardedFusedDirect(p.A_TXRX, p.A_RX2, m21, block_len=L,
                            use_fold=False)
    check(sf.ok and sf.path == "g_chain", f"g_chain: {sf.ok}, "
          f"{getattr(sf, 'path', None)}")

    def g_chain():
        pkt = DirectCheck(100, 0.01, keep=n)
        t0 = time.perf_counter()
        res = sf.run([CallbackSink(pkt)], n_blocks=n)
        return pkt, None, res.msps, time.perf_counter() - t0
    pkt = sharded("config 3 fused, use_fold=False", m21, g_chain, None,
                  "chain", n)
    held("config 3 g_chain", ref, pkt.kept)

    # CHIRP config 2 fused: the table lock-in at block o*T + t per shard
    ref = measured(chirp_params, n, ChirpCheck(keep=n), C_BLOCK, 1)()[0].kept
    pkt = sharded("config 2 fused", m21, measured(
        chirp_params, n, ChirpCheck(keep=n), C_BLOCK, 1, mesh=m21),
        ("sharded_fused", "chirp_table"), "lockin_self", n)
    held("config 2 fused", ref, pkt.kept)

    with tempfile.TemporaryDirectory() as tmp:
        # the TONES replay (#5) against the unsharded fused TONES run
        path = save_recording(tmp, "tones", tx_recording(
            loopback_params, R_BLOCKS, BLOCK, dev))
        pkt = sharded("TONES replay", m21, measured(
            lambda k: receiver_only(loopback_params(k)), n,
            PacketCheck(FRAMES, keep=n), BLOCK, NFFT, mesh=m21,
            source=ReplaySource(path, loop=True)),
            ("sharded_replay", "channelizer_at"), "channelizer_at_halo", n)
        held("TONES replay", tones_ref, pkt.kept)

        # config 3 replay (#10), its recording looped at 8 blocks
        rec = tx_recording(config3, R_BLOCKS, D_BLOCK, dev)
        path = save_recording(tmp, "c3", rec)

        def c3(k):
            return receiver_only(config3(k))
        ref = measured(c3, n, DirectCheck(100, 0.01, keep=n, seam=R_BLOCKS),
                       D_BLOCK, 100,
                       source=ReplaySource(path, loop=True))()[0].kept
        pkt = sharded("config 3 replay", m21, measured(
            c3, n, DirectCheck(100, 0.01, keep=n, seam=R_BLOCKS), D_BLOCK,
            100, mesh=m21, source=ReplaySource(path, loop=True)),
            ("sharded_replay", "replay_kernel"), "replay_ddc_sharded", n)
        held("config 3 replay", ref, pkt.kept)

        # scan: 5.5 blocks, not looped: the sharded DDC per shard (#7)
        path = save_recording(tmp, "scan", rec[:int(5.5 * D_BLOCK)])
        ref = measured(c3, n, KeepCheck(D_ROWS, 100, keep=n), D_BLOCK, 100,
                       source=ReplaySource(path))()[0].kept
        pkt = sharded("config 3 replay, not looped", m21, measured(
            c3, n, KeepCheck(D_ROWS, 100, keep=n), D_BLOCK, 100, mesh=m21,
            source=ReplaySource(path)), ("sharded_replay", "scan"), "ddc", n)
        held("config 3 scan", ref, pkt.kept)

    # ShardedSegmentedReplay: 2-block segments of a looped 3-block one
    p = c3(n)
    p.validate()
    outs = []
    for mesh in (None, m21):
        kw = dict(loop=True, segment_bytes=R_SEG_BLOCKS * D_BLOCK * 8)
        seg = (SegmentedDeviceReplay(p.A_RX2, rec[:3 * D_BLOCK], device=dev,
                                     **kw) if mesh is None else
               ShardedSegmentedReplay(p.A_RX2, rec[:3 * D_BLOCK], mesh, **kw))
        pkt = KeepCheck(D_ROWS, 100, keep=n)

        def run_seg():
            t0 = time.perf_counter()
            res = seg.run([CallbackSink(pkt)])
            return pkt, None, res.msps, time.perf_counter() - t0
        outs.append(run_seg()[0].kept if mesh is None else sharded(
            "segmented", mesh, run_seg, None, "ddc", n).kept)
    held("segmented", *outs)
    return {k: launches[k] for k in ("channelizer_at_halo",
                                     "replay_ddc_sharded", "chain")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import gpu_sdr_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            gpu_sdr_tpu_torch.__file__))) != HERE:
        print("chip_smoke: gpu_sdr_tpu_torch is not from this checkout",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]", flush=True)
        return out

    try:
        timed("card", phase_card)
        timed("build", phase_build)
        rows = timed("PFB kernels", phase_kernels, dev)
        rows.update(timed("DIRECT kernels", phase_direct_kernels, dev))
        rows.update(timed("CHIRP kernels", phase_chirp_kernels, dev))
        rows.update(timed("replay kernels", phase_replay_kernels, dev))
        launches, tones_fused = timed("TONES main path", phase_main_path,
                                      dev)
        launches.update(timed("DIRECT main path", phase_direct_main_path,
                              dev))
        launches.update(timed("CHIRP main path", phase_chirp_main_path,
                              dev))
        launches.update(timed("replay main path", phase_replay_main_path,
                              dev, tones_fused))
        rows.update(timed("sharded kernels", phase_sharded_kernels, dev))
        launches.update(timed("sharded main path", phase_sharded_main_path,
                              dev))
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
    ] + [
        dict(name=name, route="cuda", source=src + cu, replaces=replaces,
             launches=launches[name], **rows[name])
        for name, cu, replaces in (
            ("ddc", "ddc.cu", "gpu_sdr_tpu/ops/pallas_ddc.py:187"),
            ("replay_ddc", "ddc.cu", "gpu_sdr_tpu/ops/pallas_replay.py:363"),
            ("replay_ddc_t", "ddc.cu",
             "gpu_sdr_tpu/ops/pallas_replay.py:581"),
            ("fold", "fold.cu", "gpu_sdr_tpu/ops/pallas_chain.py:653"),
            ("lockin_self", "lockin.cu",
             "gpu_sdr_tpu/ops/pallas_lockin.py:200"),
            ("lockin_table", "lockin.cu",
             "gpu_sdr_tpu/ops/pallas_lockin.py:121"),
            ("channelizer_at", "channelizer.cu",
             "gpu_sdr_tpu/ops/pallas_channelizer.py:712"),
            ("presum_at", "presum.cu", "gpu_sdr_tpu/ops/pallas_pfb.py:197"),
            ("lockin_at", "lockin.cu",
             "gpu_sdr_tpu/ops/pallas_lockin.py:260"),
            ("channelizer_at_halo", "channelizer.cu",
             "gpu_sdr_tpu/ops/pallas_channelizer.py:622"),
            ("replay_ddc_sharded", "ddc.cu",
             "gpu_sdr_tpu/ops/pallas_replay.py:222"),
            ("chain", "chain.cu", "gpu_sdr_tpu/ops/pallas_chain.py:253"))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
