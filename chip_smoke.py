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
   path's shape (nfft 1000, avg 4, 6000 frames): the channelizer (a
   fused pre-sum and mixed-radix FFT) in both modes at >= 90 dB SNR, its
   first 16 frames against a float64 numpy oracle and the whole block
   against a float64 PFB on the card (the pre-sum and torch.fft in
   complex128), its shared-memory plan in csrc/channelizer.cu and in
   ops/channelizer.py alike for nfft 1..20,000; the channelizer's times
   from CUDA events, the median of repeated runs, beside the host-fed
   route's two calls on the same block (the pre-sum kernel, then
   torch.fft); the pre-sum (#2) at <= 1e-6 relative error against its
   plain version and float64 over the whole block, timed queued over
   the blocks of an 8-block recording beside a ``copy_`` of the same
   bytes (``copy_ms``); then the pre-sum's launch plan in
   csrc/presum.cu and ops/presum.py alike for T 1..70, nfft 1..64, 999,
   1000, 1001, 1018, avg 1..12 and both bodies, and #2 and #6 at <= 1e-6
   against plain and float64 at avg 1, 2, 4, 8 (the register ring) and
   9, 16 (the generic body), at nfft 1001 and on a view one sample into
   a recording (the 8-byte body), on a tail tile and at T < avg - 1,
   and at the seam's corners (a halo that wraps in part, a recording
   shorter than its halo);
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
   numpy oracle of a 40,000-sample prefix; times as in phase 3; the
   DDC's row mode also through a streamed block at one and eight
   channels (block 0 against the oracle, block 1 against plain and
   float64 over the whole block);
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
   after the loop seam), at >= 90 dB SNR (16 frames and the whole
   block against float64) and, the pre-sum, <= 1e-6 relative error
   against plain and float64 over the whole block, with the
   channelizer's stream mode (#1) and the host-fed route's two calls
   timed over the same blocks as #4 is; the pre-sum again, and timed,
   at its main path's shape (NOISE at nfft 1018, blocks of 5893 frames,
   the same four blocks of an 8-block recording); the in-kernel chirp
   lock-in's launch plan in csrc/lockin.cu (``sdr_lockin_chirp_plan``)
   and ops/lockin_at.py alike for nseg 1..40, 200, 300, ppt 1..64,
   1000, 19,999-20,001, 25,000 and both bodies; the in-kernel chirp
   lock-in (#18) at config 2 with 6,000,000-sample blocks (300
   segments, the period no multiple of them) from stream positions 0,
   12,345 (inside a step), 37,000,000, 98,000,000 (across the period's
   end) and period - 7,000 (the seam inside a segment), and at ppt
   19,999 (the 8-byte body) and 25,000 (over a step's length) from
   12,345 and period - 7,000: the integer phases of its walk exactly
   the oracle's on both bodies, >= 90 dB against plain and float64, two
   launches the same bits, and fed the chirp itself every point within
   1e-5 of 1; the oscillator read straight (ppt 1) over 2,000,000
   samples across the seam, >= 90 dB against float64; times as in phase
   8, rotating over the recording's blocks, beside a torch.sum over the
   same rows;
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
   (3000 frames a shard; the whole shard block against float64 too),
   the replay DDC after staged history rows
   (#10) on an 8-block config-3 recording (20,000 rows a shard), the
   G-fused chain (#15) at config 3 (Ct = Cp = 100, f 4), each at the
   stream's start, inside and at the seam, on shards 0 and 1; times as
   phase 10 (#5, #10) or phase 6 (#15, beside one complex matmul of the
   stacked rows, its library_ms); the DDC's row mode after a staged
   halo at one and eight channels (shard 0 at the stream's start, shard
   1 at it and after it) against plain, the oracle and float64;
13. the sharded layer through ``run_measurement(mesh=...)`` on meshes of
   this card, 10 blocks each: TONES fused (2, 1), TONES host-fed (2, 2,
   4 blocks: the psum), config 3 fused (2, 1, ``fold_kernel``) and its
   ``g_chain`` (``ShardedFusedDirect(use_fold=False)``), config 2 fused
   (``chirp_table``), the TONES and config-3 replays (``channelizer_at``,
   ``replay_kernel``), a not-looped config-3 replay (``scan``) and
   ``ShardedSegmentedReplay``; each held against the port's unsharded
   run of the same measurement at >= 90 dB SNR;
14. the deep FIR: the DDC and chain kernels' shared-memory staging plans
   (csrc/ddc.cu, csrc/chain.cu) against their Python mirrors for every f
   up to 4096 (the DDC's row mode at 1-8 channels within two blocks an
   SM, and its whole launch plan for 6,060 (M, f) at each C; its
   channel mode at 9, 100, 128, 129 and 1000 channels within 227 KB,
   the chain's, at 100 tones and channels and at 1000 tones and 300
   channels, within 227 KB); at decimation 10 and 40,000 rows a block,
   #7 and #8 in
   channel mode at 100 channels, pf_average 400 and 1000, #9 in row
   mode at one channel, 800 and 2000, #10 on shard 1 of a (time=2) mesh
   at 400, #15 at 1000, each at the stream's start against its plain
   version and the float64 oracle, timed on the next block (#7 to #10
   also against float64 over that whole block, #9 beside its
   yardstick);
15. config 3 host-fed at pf_average 400 through ``run_measurement`` (the
   DDC kernel), held against the plain DDC over the same TX blocks;
16. the five kernels no engine path takes, at full width against their
   plain versions and float64 oracles: #12 and #13 at config 3, also
   against #11; #14 at block_len 4,096,000 against #11 transposed; #3
   at nfft 1000, avg 4, 4,000,000 samples against #1 permuted (and the
   whole block against float64); #19 at
   config 2 from the stream's start, 12,345, across the period's end
   and from period - 7,000, on the chirp and a down-chirp, against #18
   on the same samples (bit-identical), the integer phases of its walk
   exactly the oracle's, two launches the same bits, fed the chirp every
   point within 1e-5 of 1, and one sample into its allocation (the
   8-byte body); each timed, with its bound;
17. those five through the ops-level entry points that run them, as in
   the JAX package: ``TonesDirectFold.multi_step`` with
   ``time_shards=2`` (#12) and ``rotg=True`` (#13) and
   ``TonesDirectFoldT.multi_step`` (#14) at config 3, each against #11's
   ``multi_step`` over the same blocks; ``channelizer_frames_scrambled``
   (#3) over blocks of the TONES comb, each tone at its scrambled bin
   within 1%, and at nfft 1018, where #3's kernel refuses the split,
   through the pre-sum kernel #2; ``fused_chirp_lockin`` (#19) over 30 blocks of the config-2
   chirp made on the card, every point within 1e-5 of 1.

Phases 4, 5, 7, 9, 11, 13, 15 and 17 are the main path.  Their CallbackSink checks rows
::97 of every packet (finite; PFB tones within 1% of their amplitude;
DIRECT rows within 2.5% of the TX amplitude, the sum of the other tones'
leakage through the 400-tap FIR's stopband at config 3, and each
channel's mean over the rows within 1%; every CHIRP row) and drops the
packet, and their rates are host-clock Msamples/s from the sink's start
to its end, after a warm-up of each branch.  Every kernel launch
counter is set to 0 just before each run and read just after it.
The line before the last is a JSON object with one entry per kernel,
all 19 (the channelizer's times are const-frame mode, the main path's;
its ``stream_*`` fields are stream mode; the DDC-family kernels carry
their deep-FIR rows in ``deep``; the channelizers, #1 and #3-#5, their
SNR against the float64 PFB over the whole block, ``snr_db``, and the
host-fed route's time on the same block, ``two_call_ms``: the pre-sum
kernel #2, then torch.fft; the pre-sums, #2 and #6, a ``copy_`` of the
bytes they move, ``copy_ms``; the chirp lock-ins, #18 and #19, a
torch.sum over the rows they read, ``read_ms``), each with its bound:
the larger of its
bytes over 3.35 TB/s and its FP32 operations over 67 TFLOP/s, counted
from this run's shapes; for the folds and the chain (#11-#15), which run
on the tensor cores with a three-pass TF32 split, three times their
operations over the dense TF32 peak of 495 TFLOP/s in place of the FP32
term, the FP32 bound beside it (``bound_fp32_ms``), and their SNR
against the float64 product at full width (``snr_db``); the DDC
(#7-#10) its SNR against its plain version in float64 over the whole
block (``snr_db``); ``library_ms`` is one PyTorch call computing the
same function where there is one (the lock-in modes: ``torch.einsum``;
the folds and the chain: ``torch.matmul`` of their rotated rows; the
DDC, both modes: ``torch.matmul`` of the materialized (nb, f*M) window
rows by Hmod), else null.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
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
# the pre-sum's cases: avg 1, 2, 4, 8 on the register ring, 9 and 16 on
# the generic body; its plans compared at T x nfft x avg 1..PLAN_AVG
PRESUM_AVGS = (1, 2, 4, 8, 9, 16)
PLAN_T = tuple(range(1, 71))
PLAN_NFFT = tuple(range(1, 65)) + (999, 1000, 1001, 1018)
PLAN_AVG = 12
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
# #18's stream positions: the start, inside a step (no step boundary on
# a segment's edge), interior, across the period's end, and (the seam
# AT_SEAM_BACK samples into the block's first segment) period - 7,000;
# the blocks of the recording each reads
AT_POSITIONS = (0, 12_345, 37_000_000, 98_000_000)
AT_SEAM_BACK = 7_000
AT_POSITION_BLOCKS = (0, 1, 3, 7, 5)
AT_GEOMETRIES = ((19_999, 300), (25_000, 240))   # (ppt, nseg): odd; > length
AT_OSC = 2_000_000                  # oscillator samples read straight
# the chirp mode's launch plans compared at nseg x ppt x both bodies
CHIRP_PLAN_NSEG = tuple(range(1, 41)) + (200, 300)
CHIRP_PLAN_PPT = tuple(range(1, 65)) + (1000, 19_999, 20_000, 20_001, 25_000)
# operations a sample of the chirp lock-in's function (#18, #19), its
# bound's operations term at the FP32 peak: the phase's step (an integer
# add), th (a conversion, two multiplies), its sine and cosine (one
# each), conj(c) * x (four multiplies, two adds) and the weighted sum
# (two multiplies, two adds)
CHIRP_AT_OPS = 16

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

# the deep FIR: decimation 10 keeps the oracle and the plain versions
# cheap at f up to 2000; 40,000 rows a block, as config 3
DEEP_DECIM, DEEP_BLOCK = 10, 400_000
DEEP_ROWS = DEEP_BLOCK // DEEP_DECIM
DEEP_CHANNEL_F = (400, 1000)        # #7, #8: channel mode, 100 channels
DEEP_ROW_F = (800, 2000)            # #9: row mode, one channel
DEEP_SHARD_F, DEEP_CHAIN_F = 400, 1000      # #10 on shard 1 of 2; #15
DEEP_RUN_F, DEEP_RUN_BLOCKS = 400, 4        # config 3 host-fed, run_measurement
DEEP_TIMED_RUNS = 5
F_PLAN = 4096                       # staging plans compared for f 1..F_PLAN
DEEP_PLAN_CHANNELS = (9, 100, 128, 129, 1000)   # the DDC channel mode's, at C
ROW_PLAN_M = tuple(range(1, 301)) + (1000, 4099, 100_000)   # row plans, at M
ROW_PLAN_F = tuple(range(1, 13)) + (100, 319, 320, 321, 400, 800, 2000, 4096)
ROW_COMB8 = [int(f) for f in np.linspace(-40e6, 40e6, 8)]   # row mode, C 8
SM_SMEM = 233_472                   # an SM's shared memory, 1 KB a block kept
F_PLAN_NFFT = 20_000                # the channelizer's, for nfft 1..

# the kernels no engine path takes, driven through their entry points
T_BLOCK = 4_096_000                 # #14: JAX's channel-major geometry
NK_CALLS, NK_K = 5, 2               # #12-#14: calls of multi_step, blocks each
SC_BLOCK = 4_000_000                # #3: tools/perf_fused_channelizer.py:30-31
SC_FRAMES, SC_BLOCKS = SC_BLOCK // NFFT, 3
SC_REFUSED_FRAMES = 5893            # #3's entry at nfft R_NFFT (pfb_at's)
CL_POSITIONS = (0, 12_345, 98_000_000)   # #19's, then period - 7,000
CL_BLOCKS = 30                      # #19's run: past the period (25 blocks)

N_KERNELS = 19                      # the repo's pl.pallas_call sites

# the card's peaks for the bound (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12            # dense, tensor cores
TC_PASSES = 3                       # the folds' and the chain's TF32 split


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


def bound_tc(n_bytes: int, flops: float) -> dict:
    """bound() for the tensor-core kernels (#11-#15): the operations
    TC_PASSES times over at the dense TF32 peak, and the FP32 bound
    beside it as ``bound_fp32_ms``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = TC_PASSES * flops / TF32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_ms=bound(n_bytes, flops)["bound_ms"])


def snr64(name: str, k, plain, *args) -> float:
    """The SNR of a tensor-core kernel's output `k` against its plain
    version evaluated in float64 (complex128) on the same operands, at
    full width; checked against the bar."""
    import torch
    ref = plain(*(t.to(torch.complex128)
                  if torch.is_tensor(t) and t.is_complex() else t
                  for t in args))
    s = snr_db(ref.cpu().numpy(), k.cpu().numpy())
    print(f"{name} {tuple(k.shape)}: {s:.1f} dB vs float64 (its plain "
          "version in complex128)")
    check(s >= SNR_BAR_DB, f"{name} {s:.1f} dB vs float64")
    return s


def pfb64(w2, ext):
    """The float64 PFB spectra of the extended rows `ext` (T + avg-1,
    nfft) on the card: the pre-sum and torch.fft in complex128, the
    oracle of the channelizers (#1, #3-#5) at full width."""
    import torch
    avg = w2.shape[0]
    T = ext.shape[0] - avg + 1
    w, e = w2.to(torch.float64), ext.to(torch.complex128)
    pre = sum(w[i] * e[i:i + T] for i in range(avg))
    return torch.fft.fft(pre, dim=-1)


def snr_full(name, ref, k) -> float:
    """The SNR of a channelizer's whole output `k` against its float64
    oracle `ref` (pfb64); checked against the bar."""
    s = snr_db(ref.cpu().numpy(), k.cpu().numpy())
    print(f"{name} {tuple(k.shape)}: {s:.1f} dB vs float64 (the whole "
          "block)")
    check(s >= SNR_BAR_DB, f"{name} {s:.1f} dB vs float64")
    return s


def pfb_flops(frames: int) -> float:
    """A channelizer's operations on `frames` frames: the pre-sum, then
    an FFT's 5 N log2 N per frame."""
    return frames * (4 * AVG * NFFT + 5 * NFFT * np.log2(NFFT))


def two_calls(cfg, w2, frames: int, rows):
    """One call of the host-fed PFB route on `frames` frames of the block
    `rows()` returns (its first avg-1 rows standing for the spare): the
    pre-sum kernel #2, then torch.fft.fft (ops/presum.pfb_frames_fused),
    the yardstick of #1 and #3-#5, no one PyTorch call computing the
    channelizer."""
    from gpu_sdr_tpu_torch.ops.presum import pfb_frames_fused
    window = w2.reshape(-1)

    def call():
        x = rows()
        return pfb_frames_fused(cfg, window, x[:AVG - 1].reshape(-1),
                                x[:frames].reshape(-1))
    return call


def ddc_flops(rows: int, channels: int, taps: int) -> int:
    """A DDC+FIR block: `taps` complex MACs per output, then the two
    complex rotations."""
    return rows * channels * (8 * taps + 12)


def ddc_library_ms(E, hmod, f: int, timer) -> float:
    """The DDC's yardstick: one torch.matmul of the materialized (nb,
    f*M) complex64 window rows of E (nb + f - 1, M) by hmod (f*M, C),
    cuBLAS in FP32 (config.py keeps TF32 off), timed by `timer`."""
    import torch
    nb, M = E.shape[0] - f + 1, E.shape[1]
    A = E.reshape(-1).unfold(0, f * M, M)[:nb].contiguous()
    ms = timer(lambda: torch.matmul(A, hmod))
    print(f"ddc yardstick: torch.matmul ({nb}, {f * M}) x ({f * M}, "
          f"{hmod.shape[1]}) complex64 {ms:.4f} ms")
    del A
    return ms


def ddc_snr64(name: str, k, hmod, ramp, phase, W: int, M: int, f: int,
              E) -> float:
    """The SNR of a DDC kernel's whole output `k` against its plain
    version (ddc_rows_plain) in float64 over the extended rows E;
    checked against the bar."""
    from gpu_sdr_tpu_torch.ops.ddc import ddc_rows_plain
    return snr64(name, k, ddc_rows_plain, hmod, ramp, phase, W, M, f, E)


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
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops.channelizer import (
        channelizer, channelizer_consts, channelizer_plain, smem_bytes)
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
        s64 = snr_full(f"channelizer [{mode}]", pfb64(w2, torch.cat(
            [spare, args[0].expand(FRAMES, NFFT)])), k)
        ms = time_ms(lambda: channelizer(w2, F1, G, spare, *args))
        pms = time_ms(lambda: channelizer_plain(w2, F1, G, spare, *args))
        err = float(np.abs(kn - pn).max())
        print(f"channelizer [{mode}] {FRAMES}x{NFFT}: SNR {s_plain:.1f} dB "
              f"vs plain, {s_gold:.1f} dB vs float64 (16 frames), "
              f"max |err| {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms")
        check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB,
              f"channelizer {mode} under {SNR_BAR_DB} dB")
        # the function's bytes (the block's rows, or its one frame, the
        # spare, the window, the spectra) and operations (pre-sum and
        # FFT), not the implementation's constants
        rows[f"channelizer_{mode}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
            snr_db=s64, **bound(nbytes(w2, spare, args[0], k),
                                pfb_flops(FRAMES)))
    rows["channelizer_stream"]["two_call_ms"] = time_ms(
        two_calls(cfg, w2, FRAMES, lambda: x))
    lib = build.load()
    plans = [n for n in range(1, F_PLAN_NFFT + 1)
             if lib.sdr_channelizer_smem_bytes(n) != smem_bytes(n)]
    print(f"channelizer shared-memory plan: csrc and ops/channelizer agree "
          f"for nfft 1..{F_PLAN_NFFT}" if not plans else
          f"channelizer shared-memory plans differ at nfft {plans[:8]}")
    check(not plans, "channelizer shared-memory plans differ")

    k = presum(w2, spare, x)
    err = check_presum(f"presum {FRAMES}x{NFFT}", k, lambda c, w:
                       presum_plain(w2.to(w), spare.to(c), x.to(c)))
    # times: rotate over the blocks of an 8-block recording (384 MB, past
    # the 50 MB L2), each launch reading its block from HBM, beside a
    # copy_ of the same bytes (the block read, as many written)
    X = torch.randn((R_BLOCKS * FRAMES, NFFT), dtype=torch.complex64,
                    device=dev)
    rot, dst = itertools.count(), torch.empty_like(x)

    def block():
        i = next(rot) % R_BLOCKS
        return X[i * FRAMES:(i + 1) * FRAMES]
    ms, pms, cms = (time_ms_queued(f, 2 * R_BLOCKS) for f in (
        lambda: presum(w2, spare, block()),
        lambda: presum_plain(w2, spare, block()),
        lambda: dst.copy_(block())))
    b = bound(nbytes(w2, spare, x, k), 4 * AVG * x.numel())
    print(f"presum {FRAMES}x{NFFT}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"copy_ of the same bytes {cms:.4f} ms, bound {b['bound_ms']:.4f} "
          f"ms ({b['bound_by']}; queued over an 8-block recording)")
    rows["presum"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          library_ms=None, copy_ms=cms, **b)
    return rows


def check_presum(tag: str, k, plain) -> float:
    """A pre-sum kernel's output `k` against its plain version, `plain(
    complex dtype, window dtype)`, in complex64 and in complex128: within
    PRESUM_REL_ERR of both, relative over the whole block, its shape and
    finite values checked; returns the max |error| against complex64."""
    import torch
    p = plain(torch.complex64, torch.float32)
    p64 = plain(torch.complex128, torch.float64)
    kn, pn, pn64 = (t.cpu().numpy() for t in (k, p, p64))
    rel = float(np.linalg.norm(kn - pn) / np.linalg.norm(pn))
    rel64 = float(np.linalg.norm(kn - pn64) / np.linalg.norm(pn64))
    print(f"{tag}: relative error {rel:.3e} vs plain, {rel64:.3e} vs "
          "float64")
    check(kn.shape == pn.shape and np.isfinite(kn).all() and
          rel <= PRESUM_REL_ERR and rel64 <= PRESUM_REL_ERR,
          f"{tag}: shape {kn.shape}, relative error {rel:.3e} / "
          f"{rel64:.3e} > {PRESUM_REL_ERR}")
    return float(np.abs(kn - pn).max())


def phase_presum_cases(dev):
    """The pre-sum kernel's launch plan in csrc/presum.cu and its mirror
    ops/presum.presum_plan alike over PLAN_T x PLAN_NFFT x avg 1..12 and
    both bodies; then #2 (presum) and #6 (presum_at) against their plain
    versions and float64 (check_presum) where the plan changes body: avg
    1, 2, 4, 8 (the register ring) and 9, 16 (the generic body); nfft
    1001 and a view one sample into a recording (the 8-byte body); a
    tail tile and T < avg - 1; the seam's corners (a halo that wraps in
    part, a recording shorter than its halo)."""
    import torch
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.ops.presum import (
        pointers_aligned, presum, presum_at, presum_at_plain, presum_plain,
        presum_plan)
    lib = build.load()
    keys = ("vec", "threads", "strips", "rows", "tiles", "ring")
    got, n = (ctypes.c_int * len(keys))(), 0
    for T in PLAN_T:
        for nfft in PLAN_NFFT:
            for avg in range(1, PLAN_AVG + 1):
                for aligned in (0, 1):
                    check(lib.sdr_presum_plan(T, nfft, avg, aligned, got)
                          == 0, f"sdr_presum_plan({T}, {nfft}, {avg}) "
                          "refused")
                    want = presum_plan(T, nfft, avg, bool(aligned))
                    check(dict(zip(keys, got)) == want,
                          f"presum plan at T {T}, nfft {nfft}, avg {avg}, "
                          f"aligned {aligned}: C {list(got)}, Python {want}")
                    n += 1
    print(f"presum plan: C and Python agree at {n} (T, nfft, avg, body)")
    gen = torch.Generator(device=dev).manual_seed(24680)

    def window(nfft, avg):
        return PFBConfig(nfft=nfft, avg=avg, rate=RATE).window(
            dev).reshape(avg, nfft)

    def body(x, hist, out, w):
        return "16-byte" if presum_plan(1, x.shape[-1], 1, pointers_aligned(
            x.data_ptr(), hist.data_ptr() if hist is not None else 0,
            out.data_ptr(), w.data_ptr()))["vec"] == 2 else "8-byte"

    def streamed(nfft, avg, T, want):
        w2 = window(nfft, avg)
        spare = torch.randn((avg - 1, nfft), dtype=torch.complex64,
                            device=dev, generator=gen)
        x = torch.randn((T, nfft), dtype=torch.complex64, device=dev,
                        generator=gen)
        k = via_kernel("presum", lambda: presum(w2, spare, x))
        b = body(x, spare, k, w2)
        check(b == want, f"presum nfft {nfft}: the {b} body")
        check_presum(f"presum [nfft {nfft}, avg {avg}, T {T}, {b}]", k,
                    lambda c, w: presum_plain(w2.to(w), spare.to(c),
                                              x.to(c)))

    def recorded(X, avg, T, idx, valid, want, tag=""):
        nfft = X.shape[1]
        w2 = window(nfft, avg)
        k = via_kernel("presum_at", lambda: presum_at(w2, X, idx, valid, T))
        b = body(X, None, k, w2)
        check(b == want, f"presum_at nfft {nfft}{tag}: the {b} body")
        check_presum(f"presum_at [{X.shape[0]} x {nfft}{tag}, avg {avg}, T "
                    f"{T}, block {idx}, valid {valid}, {b}]", k,
                    lambda c, w: presum_at_plain(w2.to(w), X.to(c), idx,
                                                 valid, T))

    def rec(frames, nfft):
        return torch.randn((frames, nfft), dtype=torch.complex64,
                           device=dev, generator=gen)
    for avg in PRESUM_AVGS:
        streamed(NFFT, avg, FRAMES, "16-byte")
        X = rec(4 * 1000, NFFT)
        for idx, valid in ((0, 0), (2, 1), (0, 1)):
            recorded(X, avg, 1000, idx, valid, "16-byte")
    # the 8-byte body: odd nfft; a view one sample into a recording
    streamed(1001, AVG, 997, "8-byte")
    X = rec(4 * 997, 1001)
    for idx, valid in ((0, 0), (3, 1), (0, 1)):
        recorded(X, AVG, 997, idx, valid, "8-byte")
    flat = torch.randn(4 * 997 * NFFT + 1, dtype=torch.complex64,
                       device=dev, generator=gen)
    X = flat[1:].view(4 * 997, NFFT)
    for idx, valid in ((0, 0), (2, 1), (0, 1)):
        recorded(X, AVG, 997, idx, valid, "8-byte", ", one sample in")
    # a tail tile (997 and 5 frames) and T < avg - 1, on both bodies
    for nfft, want in ((NFFT, "16-byte"), (1001, "8-byte")):
        for avg, T in ((8, 3), (16, 5), (AVG, 1)):
            streamed(nfft, avg, T, want)
            recorded(rec(4 * T, nfft), avg, T, 1, 1, want)
            recorded(rec(4 * T, nfft), avg, T, 0, 1, want)
    # the seam's corners (one-frame blocks): a halo that wraps in part (4
    # frames, block 1) and a recording shorter than its halo (2 frames)
    for total, idx in ((4, 1), (4, 0), (2, 1)):
        for avg in (AVG, 9):
            recorded(rec(total, 200), avg, 1, idx, 1, "16-byte")


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
    from gpu_sdr_tpu_torch.ops.channelizer import channelizer_scrambled
    from gpu_sdr_tpu_torch.ops.fold import fold_rotg, fold_streamed, fold_t
    from gpu_sdr_tpu_torch.ops.lockin_at import fused_chirp_lockin
    return {"channelizer": channelizer, "presum": presum, "ddc": ddc_fused,
            "replay_ddc": ReplayDDC, "replay_ddc_t": ReplayDDCT,
            "fold": fold, "lockin_self": lockin_self,
            "lockin_table": lockin_table, "channelizer_at": channelizer_at,
            "presum_at": presum_at, "lockin_at": lockin_at,
            "channelizer_at_halo": channelizer_at_halo,
            "replay_ddc_sharded": ShardedReplayDDC, "chain": chain,
            "fold_streamed": fold_streamed, "fold_rotg": fold_rotg,
            "fold_t": fold_t, "channelizer_scrambled": channelizer_scrambled,
            "chirp_lockin": fused_chirp_lockin}


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


def direct_oracle(x: np.ndarray, freqs, M: int = D_DECIM,
                  taps: int = D_AVG) -> np.ndarray:
    """Float64 DIRECT readout of a stream that starts at sample 0 with
    zero FIR history: integer-phase mix-down, then the decimating FIR of
    decimation M and `taps` taps per arm, y[n] = sum_i h[i] * z[(n - taps
    + 1)*M + i].  (ORACLE_ROWS, C)."""
    h = sinc_taps(M * taps, 0.75 / (2.0 * M))
    t = np.arange(len(x), dtype=np.int64)
    out = np.empty((ORACLE_ROWS, len(freqs)), dtype=np.complex128)
    for c, f in enumerate(freqs):
        z = x * np.exp(-2j * np.pi * (((f % D_RATE) * t) % D_RATE) / D_RATE)
        ze = np.concatenate([np.zeros((taps - 1) * M), z])
        win = np.lib.stride_tricks.sliding_window_view(ze, len(h))
        out[:, c] = win[::M][:ORACLE_ROWS] @ h
    return out


def report(name, k, p, oracle=None, times=None, rows=None, cost=None,
           tc=False):
    """Print and check one DIRECT kernel's output `k` against its plain
    version's `p` and, when given, the float64 oracle of its first
    ORACLE_ROWS rows; with `times` (kernel ms, plain ms) and `cost`
    (bytes in and out, operations), keep its row of the kernels line in
    `rows`, its bound the tensor cores' with `tc`."""
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
                          library_ms=None,
                          **(bound_tc if tc else bound)(*cost))


def phase_direct_kernels(dev):
    """Each DIRECT kernel against its plain version at full width."""
    import torch
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.fold import TonesDirectFold, fold, fold_plain
    from gpu_sdr_tpu_torch.ops.presum import recording_rows
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
    E = torch.cat([hist, x1]).reshape(-1, D_DECIM)
    rows["ddc"]["snr_db"] = ddc_snr64("ddc", yk, hmod, ramp, ph, D_RATE,
                                      D_DECIM, D_AVG, E)
    rows["ddc"]["library_ms"] = ddc_library_ms(E, hmod, D_AVG, time_ms)

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
        E = recording_rows(rk.X, st1[0], rk.nbr, D_AVG - 1, 1)
        rows[name]["snr_db"] = ddc_snr64(
            name, yk, rk._hmod, rk._ramp, st1[1], D_RATE, D_DECIM, D_AVG, E)
        rows[name]["library_ms"] = ddc_library_ms(E, rk._hmod, D_AVG,
                                                  time_ms)

    # the row mode (#7 at C <= 8) through a streamed block: a one- and an
    # eight-channel comb, block 0 with zero history against the oracle,
    # block 1 with the carried history against plain and float64
    for freqs in (CONFIG1, ROW_COMB8):
        tag = f"ddc [row mode, C {len(freqs)}]"
        rcfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(freqs),
                                   (0,) * len(freqs))
        check(ddc.few_channels(len(freqs)), f"{tag}: not row mode")
        hm, rp = rcfg.modulated_taps(dev), rcfg.carrier_ramp(D_ROWS, dev)
        a = (hm, rp, ddc.ddc_carrier_step(rcfg, D_BLOCK, dev), D_RATE,
             rcfg.M, rcfg.f)
        s0 = (ddc.ddc_carrier_init(rcfg, dev), st[1])
        ph, hist, yk = via_kernel("ddc", lambda: ddc.ddc_fused(*a, *s0, x0))
        report(f"{tag} [block 0]", yk, ddc.direct_ddc_fir(*a, *s0, x0)[2],
               direct_oracle(x0_np[:prefix].astype(np.complex128), freqs))
        yk = via_kernel("ddc", lambda: ddc.ddc_fused(*a, ph, hist, x1))[2]
        report(f"{tag} [block 1]", yk, ddc.direct_ddc_fir(*a, ph, hist, x1)[2])
        ddc_snr64(f"{tag} [block 1]", yk, hm, rp, ph, D_RATE, D_DECIM, D_AVG,
                  torch.cat([hist, x1]).reshape(-1, D_DECIM))

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
           cost=(nbytes(*fargs[:5], yk), D_ROWS * Cp * (8 * Ct + 12)),
           tc=True)
    rows["fold"]["snr_db"] = snr64("fold", yk, fold_plain, *fargs)
    rows["fold"]["library_ms"] = fold_library_ms(chain, crot)
    return rows


def fold_library_ms(chain, crot) -> float:
    """The fold's yardstick: one torch.matmul of its (nb, Ct) rotated
    comb rows P * srot by G2, complex64 (cuBLAS, FP32)."""
    import torch
    R, Ct = chain.P1.shape
    A = (chain.P1[None] * crot[:chain.PB.shape[0], None, :]).reshape(
        -1, Ct)[:chain.nb].contiguous()
    ms = time_ms(lambda: torch.matmul(A, chain.G2))
    print(f"fold yardstick: torch.matmul ({chain.nb}, {Ct}) x ({Ct}, "
          f"{chain.G2.shape[1]}) complex64 {ms:.4f} ms")
    return ms


class DirectCheck:
    """The DIRECT main path's packet callback: rows ::97 of every packet
    finite, within D_ROW_TOL of the TX amplitude row by row and within
    D_MEAN_TOL per channel on average (row 0 of the stream is the FIR's
    startup); keeps those rows of the first `keep` packets."""

    def __init__(self, channels: int, ampl: float, keep: int = 0,
                 seam: int = 0, start_rows: int = 1):
        self.channels, self.ampl, self.keep = channels, ampl, keep
        self.seam = seam        # a looped recording's blocks: row 0 of
        self.kept, self.n = [], 0   # each packet after its seam mixes both
        # the checked rows of the stream's first packet that lie in the
        # FIR's startup (its first f - 1 rows)
        self.skip = -(-start_rows // ROWS.step)

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (D_ROWS, self.channels) and
              d.dtype == np.complex64, f"packet {self.n}: {d.shape} "
              f"{d.dtype}")
        sub = d[ROWS]
        check(bool(np.isfinite(sub).all()), f"packet {self.n}: non-finite")
        held = sub
        if self.n == 0:
            held = sub[self.skip:]
        elif self.seam and self.n % self.seam == 0:
            held = sub[1:]
        dev = np.abs(held) / self.ampl - 1.0
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


def chirp_oracle(start: int, n: int, down: bool = False) -> np.ndarray:
    """Float64 config-2 chirp (or, with `down`, its sweep reversed) at
    stream positions start .. start+n-1: chirp_index_oracle's phases, the
    sin/cos in float64."""
    th = np.pi * (chirp_index_oracle(start, n, down) / 2147483647.5)
    return np.sin(th) - 1j * np.cos(th)


def chirp_index_oracle(start: int, n: int, down: bool = False) -> np.ndarray:
    """The int32 phase indices of chirp_oracle: the reference's
    quantized descriptor and uint64 phase accumulator (chirp_parameter,
    cpp/USRP_demodulator.cpp:192-221; chirp_gen, cpp/kernels.cu:
    335-372), truncated to 32 bits."""
    f_start, f_end = CONFIG2["freq"][0], CONFIG2["chirp_f"][0]
    if down:
        f_start, f_end = f_end, f_start
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
    return idx.astype(np.uint32).astype(np.int32)


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
    6,000,000-sample blocks (the period is no multiple of them), from
    five stream positions and at two other ppt (held_chirp), its
    oscillator read straight, its launch plan in C and Python alike."""
    import torch
    from gpu_sdr_tpu_torch.engine.planner import plan_blocks
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops.channelizer import (
        channelizer, channelizer_at, channelizer_at_plain, channelizer_consts)
    from gpu_sdr_tpu_torch.ops.chirp import ChirpConfig
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_at import (
        chirp_plan, lockin_at, lockin_at_plain, pointers_aligned)
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    from gpu_sdr_tpu_torch.ops.presum import (presum_at, presum_at_plain,
                                              recording_halo)
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
        err = check_presum(f"presum_at [{tag}]", k, lambda c, w:
                           presum_at_plain(w2.to(w), X.to(c), idx, valid, T))
        if keep_err:
            errs["presum_at"] = max(errs["presum_at"], err)

    # #4 and #6: a (8 * 6000, 1000) recording, 384 MB
    cfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    w2, F1, G = channelizer_consts(cfg, dev)
    X = torch.randn((R_BLOCKS * FRAMES, NFFT), dtype=torch.complex64,
                    device=dev, generator=gen)
    w = w2.cpu().numpy().astype(np.float64)
    s64 = float("inf")
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
        s64 = min(s64, snr_full(f"channelizer_at [{tag}]", pfb64(
            w2, torch.cat([recording_halo(X, idx * FRAMES, AVG - 1, valid),
                           X[idx * FRAMES:(idx + 1) * FRAMES]])), k))
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
    two_ms = time_ms_queued(two_calls(cfg, w2, FRAMES, block), 2 * R_BLOCKS)
    # the block's rows and its halo read, the window, the spectra written
    b = bound((2 * FRAMES + AVG - 1) * NFFT * 8 + nbytes(w2),
              pfb_flops(FRAMES))
    print(f"channelizer_at {FRAMES}x{NFFT}: kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
          f"channelizer stream mode over the same blocks {stream_ms:.4f} "
          f"ms; pre-sum kernel + torch.fft {two_ms:.4f} ms")
    rows["channelizer_at"] = dict(max_abs_err=errs["channelizer_at"], ms=ms,
                                  plain_ms=pms, library_ms=None,
                                  two_call_ms=two_ms, snr_db=s64, **b)
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
    rot, dst = itertools.count(), X.new_empty((T, R_NFFT))
    ms, pms, cms = (time_ms_queued(f, 2 * R_BLOCKS) for f in (
        lambda: presum_at(wn, X, next(rot) % R_BLOCKS, 1, T),
        lambda: presum_at_plain(wn, X, next(rot) % R_BLOCKS, 1, T),
        lambda: dst.copy_(X[(next(rot) % R_BLOCKS) * T:][:T])))
    # bytes: the block read once, the (T, nfft) output written once
    b = bound(2 * T * R_NFFT * 8 + nbytes(wn), 4 * AVG * T * R_NFFT)
    print(f"presum_at {T}x{R_NFFT}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"copy_ of the same bytes {cms:.4f} ms, bound {b['bound_ms']:.4f} "
          f"ms ({b['bound_by']})")
    rows["presum_at"] = dict(max_abs_err=errs["presum_at"], ms=ms,
                             plain_ms=pms, library_ms=None, copy_ms=cms, **b)
    del X

    # #18's launch plan in csrc/lockin.cu and in ops/lockin_at.py alike
    lib, got, n_plans = build.load(), (ctypes.c_int * 3)(), 0
    for n, q, aligned in itertools.product(CHIRP_PLAN_NSEG, CHIRP_PLAN_PPT,
                                           (0, 1)):
        p = chirp_plan(n, q, bool(aligned))
        check(lib.sdr_lockin_chirp_plan(n, q, aligned, got) == 0 and
              list(got) == [p["vec"], p["threads"], p["blocks"]],
              f"sdr_lockin_chirp_plan({n}, {q}, {aligned}) {list(got)} "
              f"against chirp_plan {p}")
        n_plans += 1
    print(f"chirp-mode launch plans: C and Python agree at {n_plans} (nseg, "
          "ppt, body)")

    # #18: config 2 at 6,000,000-sample blocks, 300 segments of 20,000
    ccfg = ChirpConfig.from_params(
        CONFIG2["freq"][0], CONFIG2["chirp_f"][0], C_RATE,
        CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0])
    ppt, nseg = ccfg.length, AT_BLOCK // ccfg.length
    check(ppt == 20_000 and ccfg.period % AT_BLOCK,
          f"chirp_at geometry {ppt}, {nseg}, period {ccfg.period}")
    wp_np = lockin_profile(ppt)
    wp = torch.from_numpy(wp_np).to(dev)
    Xc = torch.randn((R_BLOCKS * nseg, ppt), dtype=torch.complex64,
                     device=dev, generator=gen)
    positions = AT_POSITIONS + (ccfg.period - AT_SEAM_BACK,)
    for pos, idx in zip(positions, AT_POSITION_BLOCKS):
        errs["lockin_at"] = max(errs["lockin_at"], held_chirp(
            f"lockin_at [position {pos}, block {idx}]", ccfg, wp, pos, Xc,
            idx, nseg, dev))
    # other geometries, each from inside a step and across the seam: an
    # odd ppt (the 8-byte body) and a ppt over the step's length
    for gppt, gnseg in AT_GEOMETRIES:
        wg = torch.from_numpy(lockin_profile(gppt)).to(dev)
        Xg = torch.randn((2 * gnseg, gppt), dtype=torch.complex64,
                         device=dev, generator=gen)
        body = chirp_plan(gnseg, gppt, pointers_aligned(
            Xg[gnseg:].data_ptr(), wg.data_ptr()))["vec"]
        check(body == (1 if gppt % 2 else 2), f"lockin_at ppt {gppt}: body "
              f"{body}")
        for pos in (AT_POSITIONS[1], ccfg.period - AT_SEAM_BACK):
            held_chirp(f"lockin_at [ppt {gppt} ({8 * body}-byte loads), "
                       f"position {pos}, block 1]", ccfg, wg, pos, Xg, 1, gnseg,
                       dev)
        del Xg
    # the oscillator read straight (ppt 1, a unit profile, a signal of
    # ones: y = conj(c)) across the seam, against float64
    o_pos, ones = ccfg.period - AT_OSC // 2, Xc.new_ones((AT_OSC, 1))
    _, yo = via_kernel("lockin_at", lambda: lockin_at(
        ccfg, wp.new_ones(1), o_pos, ones, 0, AT_OSC))
    s_osc = snr_db(np.conj(chirp_oracle(o_pos, AT_OSC)), yo.cpu().numpy())
    print(f"lockin_at [the oscillator read straight, {AT_OSC} samples from "
          f"position {o_pos}]: {s_osc:.1f} dB vs float64")
    check(s_osc >= SNR_BAR_DB, f"lockin_at oscillator {s_osc:.1f} dB")
    del ones, yo
    rot = itertools.count()

    def at_args():
        i = next(rot)
        return ccfg, wp, (i * AT_BLOCK) % ccfg.period, Xc, i % R_BLOCKS, nseg

    ms, pms = (time_ms_queued(lambda: f(*at_args()), 2 * R_BLOCKS)
               for f in (lockin_at, lockin_at_plain))
    rms = time_ms_queued(lambda: torch.sum(Xc[(next(rot) % R_BLOCKS) * nseg:][
        :nseg].view(torch.float32), dim=1), 2 * R_BLOCKS)
    b = bound(nseg * ppt * 8 + nbytes(wp) + nseg * 8,
              CHIRP_AT_OPS * nseg * ppt)
    print(f"lockin_at {nseg}x{ppt}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"torch.sum over the same rows {rms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {CHIRP_AT_OPS} "
          "operations a sample)")
    rows["lockin_at"] = dict(max_abs_err=errs["lockin_at"], ms=ms,
                             plain_ms=pms, library_ms=None, read_ms=rms,
                             oscillator_snr_db=s_osc, **b)
    return rows


def walk_exact(ccfg, pos: int, nseg: int, ppt: int, dev, down=None) -> bool:
    """Whether the integer phases of chirp mode's walk on the card
    (ops/lockin_at.walk_phases: csrc/lockin.cu's walk, both bodies where
    ppt is even) equal ops/chirp.chirp_phase_index's exactly, and, for
    config 2 (`down` not None), those equal the numpy oracle's."""
    import torch
    from gpu_sdr_tpu_torch.ops.chirp import chirp_phase_index
    from gpu_sdr_tpu_torch.ops.lockin_at import walk_phases
    ref = chirp_phase_index(ccfg, pos, torch.arange(
        nseg * ppt, dtype=torch.int64, device=dev))
    ok = all(torch.equal(walk_phases(ccfg, pos, nseg, ppt, vec, dev), ref)
             for vec in ((2, 1) if ppt % 2 == 0 else (1,)))
    if down is not None:
        ok &= np.array_equal(ref.cpu().numpy(), chirp_index_oracle(
            pos, nseg * ppt, down).astype(np.int64))
    return ok


def held_chirp(tag: str, ccfg, wp, pos: int, X, idx: int, nseg: int,
               dev) -> float:
    """#18 (lockin_at) on block `idx` of the recording X from stream
    position `pos` of the config-2 chirp ccfg: its walk's integer phases
    exactly the oracle's, >= 90 dB against plain and float64, two
    launches the same bits, and fed the chirp itself every point within
    C_TOL of 1; the max |error| against plain."""
    import torch
    from gpu_sdr_tpu_torch.ops.chirp import chirp_block
    from gpu_sdr_tpu_torch.ops.lockin_at import lockin_at, lockin_at_plain
    ppt = wp.shape[0]
    new, yk = via_kernel("lockin_at", lambda: lockin_at(
        ccfg, wp, pos, X, idx, nseg))
    again = via_kernel("lockin_at", lambda: lockin_at(
        ccfg, wp, pos, X, idx, nseg))[1]
    yp = lockin_at_plain(ccfg, wp, pos, X, idx, nseg)
    torch.cuda.synchronize(dev)
    check(new == (pos + nseg * ppt) % ccfg.period,
          f"{tag}: new position {new}")
    kn, pn = yk.cpu().numpy(), yp.cpu().numpy()
    check(kn.shape == (nseg,) and np.isfinite(kn).all(),
          f"{tag}: shape {kn.shape} or non-finite")
    x64 = X[idx * nseg:(idx + 1) * nseg].cpu().numpy()
    y64 = (np.conj(chirp_oracle(pos, nseg * ppt).reshape(nseg, ppt)) *
           x64) @ wp.cpu().numpy().astype(np.float64)
    s_plain, s_gold = snr_db(pn, kn), snr_db(y64, kn)
    exact = walk_exact(ccfg, pos, nseg, ppt, dev, down=False)
    same = torch.equal(yk, again)
    chirp = chirp_block(ccfg, pos, nseg * ppt, device=dev)[1].reshape(
        nseg, ppt)
    off = float((via_kernel("lockin_at", lambda: lockin_at(
        ccfg, wp, pos, chirp, 0, nseg))[1] - 1).abs().max())
    print(f"{tag}: SNR {s_plain:.1f} dB vs plain, {s_gold:.1f} dB vs "
          f"float64; integer phases " + ("exactly" if exact else "NOT") +
          " the oracle's; two launches " + ("the same" if same else
                                           "DIFFERENT") +
          f" bits; on the chirp max |y - 1| {off:.2e}")
    check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB and exact and
          same and off <= C_TOL, f"{tag} failed")
    return float(np.abs(kn - pn).max())


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


def direct_oracle_at(x: np.ndarray, freqs, M: int = D_DECIM,
                     taps: int = D_AVG) -> np.ndarray:
    """direct_oracle of rows from absolute sample a0 on, x holding
    samples a0 - (taps-1)*M .. of the stream (its history first) and the
    carrier at their absolute index: x = (samples, a0)."""
    xs, a0 = x
    h = sinc_taps(M * taps, 0.75 / (2.0 * M))
    t = np.arange(a0 - (taps - 1) * M, a0 - (taps - 1) * M + len(xs),
                  dtype=np.int64)
    out = np.empty((ORACLE_ROWS, len(freqs)), dtype=np.complex128)
    for c, f in enumerate(freqs):
        z = xs * np.exp(-2j * np.pi * (((f % D_RATE) * (t % D_RATE)) %
                                       D_RATE) / D_RATE)
        win = np.lib.stride_tricks.sliding_window_view(z, len(h))
        out[:, c] = win[::M][:ORACLE_ROWS] @ h
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
    from gpu_sdr_tpu_torch.ops.presum import (recording_halo, shard_spans,
                                              staged_halos)
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
    err, s64 = 0.0, float("inf")
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
        s64 = min(s64, snr_full(f"channelizer_at_halo [{tag}]", pfb64(
            w2, torch.cat([recording_halo(X, base, AVG - 1, v),
                           X[base:base + ftl]])), k))
        check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB,
              f"channelizer_at_halo [{tag}] under {SNR_BAR_DB} dB")
    rot = itertools.count()

    def nxt():
        i = next(rot)
        return spans[i % T], halos[i % T], (i // T) % R_BLOCKS

    ms, pms = (time_ms_queued(lambda: f(w2, F1, G, *nxt(), 1, ftl),
                              2 * R_BLOCKS)
               for f in (channelizer_at_halo, channelizer_at_halo_plain))
    def shard_block():
        span, _, i = nxt()
        return span[i * ftl:(i + 1) * ftl]
    two_ms = time_ms_queued(two_calls(cfg, w2, ftl, shard_block),
                            2 * R_BLOCKS)
    # the shard's rows and its staged halo read, the window, the spectra
    b = bound((2 * ftl + AVG - 1) * NFFT * 8 + nbytes(w2), pfb_flops(ftl))
    print(f"channelizer_at_halo {ftl}x{NFFT}: kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
          f"pre-sum kernel + torch.fft {two_ms:.4f} ms")
    rows["channelizer_at_halo"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       library_ms=None, two_call_ms=two_ms,
                                       snr_db=s64, **b)
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
    idx, t = 3, 1                       # a block inside, its halo shard 0's
    st = (idx, st0[1], 1)
    E = torch.cat([rk.H[t][idx], rk.X[t][idx * nbt:(idx + 1) * nbt]])
    s64 = ddc_snr64(f"replay_ddc_sharded [block {idx}, shard {t}]",
                    via_kernel("replay_ddc_sharded", lambda: rk.local(st, t)),
                    rk._hmod[t], rk._ramp[t], st0[1], D_RATE, D_DECIM, D_AVG,
                    E)
    lms = ddc_library_ms(E, rk._hmod[t], D_AVG,
                         lambda fn: time_ms_queued(fn, 2 * R_BLOCKS))
    rows["replay_ddc_sharded"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                      library_ms=lms, snr_db=s64, **b)
    del rk

    # the row mode (#10 at C <= 8) through a staged halo: a one- and an
    # eight-channel comb over the recording's first two blocks, shard 0
    # at the stream's start (zero halo), shard 1 at it (its halo shard
    # 0's rows) and after it; against plain, the oracle and float64
    rec = rec[:2 * D_BLOCK]
    for freqs in (CONFIG1, ROW_COMB8):
        rcfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(freqs),
                                   (0,) * len(freqs))
        check(ddc.few_channels(len(freqs)), "sharded row mode: not row mode")
        rk = ShardedReplayDDC(rcfg, rec, D_BLOCK, [dev] * T)
        st0 = rk.init_state()
        st1 = (1, rk.advance(st0)[1], 1)
        for idx, st, t in ((0, st0, 0), (0, st0, 1), (1, st1, 1)):
            tag = (f"replay_ddc_sharded [row mode, C {len(freqs)}, block "
                   f"{idx}, shard {t}]")
            yk = via_kernel("replay_ddc_sharded", lambda: rk.local(st, t))
            a0 = idx * D_BLOCK + t * (D_BLOCK // T)
            xs = rec_np[np.arange(a0 - H, a0 + ORACLE_ROWS * D_DECIM) %
                        (2 * D_BLOCK)].astype(np.complex128)
            if a0 == 0:                     # the stream's start: no history
                xs[:H] = 0
            report(tag, yk, rk.local_plain(st, t),
                   direct_oracle_at((xs, a0), freqs))
            halo = rk.H[t][idx] if rk._val(t, st[2]) else \
                torch.zeros_like(rk.H[t][idx])
            ddc_snr64(tag, yk, rk._hmod[t], rk._ramp[t], st[1], D_RATE,
                      D_DECIM, D_AVG,
                      torch.cat([halo, rk.X[t][idx * nbt:(idx + 1) * nbt]]))
        del rk
    del rec

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
    s64 = snr64("chain [block 1, shard 1]",
                via_kernel("chain", lambda: chain(*args)), chain_plain, *args)
    f = Gd.shape[0]
    E = torch.cat([hPt[1] * srot, Pt[1] * srot])
    A = torch.cat([E[j:j + nbt] for j in range(f)], dim=1)   # (nbt, f*Ct)
    Gr = Gd.reshape(-1, Gd.shape[2])
    ms, pms, lms = (time_ms(fn) for fn in (
        lambda: chain(*args), lambda: chain_plain(*args), lambda: A @ Gr))
    Ct, Cp = Gd.shape[1], Gd.shape[2]
    b = bound_tc(nbytes(*args) + nbt * Cp * 8, nbt * Cp * (8 * f * Ct + 12))
    print(f"chain {nbt}x{Cp}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"library (matmul of the stacked rows) {lms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; FP32 "
          f"{b['bound_fp32_ms']:.4f})")
    rows["chain"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                         library_ms=lms, snr_db=s64, **b)
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


def deep_row(deep, tmp, name, f, entry):
    """Move report()'s row `entry` of `tmp` into deep[name], as f's."""
    deep.setdefault(name, []).append(dict(f=f, **tmp.pop(entry)))


def phase_deep_fir_kernels(dev):
    """The DDC-family kernels at a deep FIR, where a tile's rows no longer
    fit one block's shared memory at once: the C and Python staging
    plans compared for every f up to F_PLAN; #7 and #8 in channel mode
    at 100 channels (config 3's tones), #9 in row mode at one channel
    (config 1's), #10 on shard 1 of a (time=2) mesh, #15 at f 1000; at
    decimation 10, 40,000 rows a block.  Each at the stream's start
    against its plain version and the float64 oracle, then timed on the
    next block (and #8 / #9 after the loop seam), #9 beside its
    yardstick.  Returns {kernel: [its rows at each f]}."""
    import torch
    from gpu_sdr_tpu_torch.kernels import build
    from gpu_sdr_tpu_torch.ops import chain as chain_ops
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.chain import (TonesDirectChain, chain,
                                             chain_plain)
    from gpu_sdr_tpu_torch.ops.presum import recording_rows
    from gpu_sdr_tpu_torch.ops.replay_ddc import (ReplayDDC, ReplayDDCT,
                                                  ShardedReplayDDC)
    lib = build.load()
    plans = {}
    for C in range(1, ddc.ROW_MODE_MAX_CHANNELS + 1):
        plans[f"ddc row mode, {C} channels"] = (
            lambda f, C=C: lib.sdr_ddc_smem_bytes(f, 1, C),
            lambda f, C=C: ddc.smem_bytes(f, True, C), SM_SMEM // 2 - 1024)
    for C in DEEP_PLAN_CHANNELS:
        plans[f"ddc channel mode, {C} channels"] = (
            lambda f, C=C: lib.sdr_ddc_smem_bytes(f, 0, C),
            lambda f, C=C: ddc.smem_bytes(f, False, C), ddc.SMEM_MAX)
    for Ct, Cp in ((100, 100), (1000, 300)):
        plans[f"chain, {Ct} tones, {Cp} channels"] = (
            lambda f, a=(Ct, Cp): lib.sdr_chain_smem_bytes(f, *a),
            lambda f, a=(Ct, Cp): chain_ops.smem_bytes(f, *a),
            chain_ops.SMEM_MAX)
    for name, (c_plan, py_plan, limit) in plans.items():
        sizes = [c_plan(f) for f in range(1, F_PLAN + 1)]
        check(sizes == [py_plan(f) for f in range(1, F_PLAN + 1)],
              f"{name}: the C and Python staging plans differ")
        check(max(sizes) <= limit,
              f"{name}: a block over {limit} bytes ({max(sizes)})")
        print(f"staging plan, {name}: C and Python agree for f 1..{F_PLAN}; "
              f"at most {max(sizes)} bytes a block (limit {limit})")
    keys = ("CP", "R", "P", "nmc", "J", "npass", "nchunk", "woff", "stage",
            "smem")
    got = (ctypes.c_int * len(keys))()
    n_plans = 0
    for M in ROW_PLAN_M:
        for f in ROW_PLAN_F:
            for C in range(1, ddc.ROW_MODE_MAX_CHANNELS + 1):
                check(lib.sdr_ddc_row_plan(M, f, C, got) == 0,
                      f"sdr_ddc_row_plan({M}, {f}, {C}) refused")
                want = ddc.row_plan(M, f, C)
                check(dict(zip(keys, got)) == want,
                      f"row plan at M {M}, f {f}, C {C}: C {list(got)}, "
                      f"Python {want}")
                check(want["smem"] <= lib.sdr_ddc_smem_bytes(f, 1, C),
                      f"row plan at M {M}, f {f}, C {C} over its bound")
                n_plans += 1
    print(f"row plan: C and Python agree at {n_plans} (M, f, C), each "
          "within its bound")
    gen = torch.Generator(device=dev).manual_seed(86420)
    rng = np.random.default_rng(8642)
    M, nb = DEEP_DECIM, DEEP_ROWS
    prefix = ORACLE_ROWS * M
    deep, tmp = {}, {}

    def cfg_of(freqs, f):
        return ddc.DirectDDCConfig(D_RATE, M, f, tuple(freqs),
                                   (0,) * len(freqs))

    def timed(fn):
        return time_ms(fn, DEEP_TIMED_RUNS)

    # #7: streamed blocks, block 0 with zero history against the oracle
    for f in DEEP_CHANNEL_F:
        cfg = cfg_of(CONFIG3, f)
        hmod, ramp = cfg.modulated_taps(dev), cfg.carrier_ramp(nb, dev)
        args = (hmod, ramp, ddc.ddc_carrier_step(cfg, DEEP_BLOCK, dev),
                D_RATE, M, f)
        x0_np = crandn(rng, DEEP_BLOCK)
        x0 = torch.from_numpy(x0_np).to(dev)
        x1 = torch.randn(DEEP_BLOCK, dtype=torch.complex64, device=dev,
                         generator=gen)
        st = (ddc.ddc_carrier_init(cfg, dev),
              torch.zeros((f - 1) * M, dtype=torch.complex64, device=dev))
        ph, hist, yk = via_kernel("ddc", lambda: ddc.ddc_fused(*args, *st,
                                                                x0))
        report(f"ddc [f {f}, block 0]", yk,
               ddc.direct_ddc_fir(*args, *st, x0)[2],
               direct_oracle(x0_np[:prefix].astype(np.complex128), CONFIG3,
                             M, f))
        yk = via_kernel("ddc", lambda: ddc.ddc_fused(*args, ph, hist, x1))[2]
        report(f"ddc [f {f}]", yk, ddc.direct_ddc_fir(*args, ph, hist, x1)[2],
               times=(timed(lambda: ddc.ddc_fused(*args, ph, hist, x1)),
                      timed(lambda: ddc.direct_ddc_fir(*args, ph, hist, x1))),
               rows=tmp, cost=(nbytes(x1, hist, hmod, ramp, ph, yk),
                               ddc_flops(nb, len(CONFIG3), M * f)))
        tmp[f"ddc [f {f}]"]["snr_db"] = ddc_snr64(
            f"ddc [f {f}]", yk, hmod, ramp, ph, D_RATE, M, f,
            torch.cat([hist, x1]).reshape(-1, M))
        deep_row(deep, tmp, "ddc", f, f"ddc [f {f}]")
        del x0, x1, hist

    # #8 (channel mode) and #9 (row mode) on a random two-block recording:
    # block 0 at the stream's start against the oracle, block 1 timed,
    # block 0 again after the loop seam (its history the recording's end)
    for name, cls, freqs, fs in (
            ("replay_ddc", ReplayDDC, CONFIG3, DEEP_CHANNEL_F),
            ("replay_ddc_t", ReplayDDCT, CONFIG1, DEEP_ROW_F)):
        for f in fs:
            cfg = cfg_of(freqs, f)
            rec = torch.randn(2 * DEEP_BLOCK, dtype=torch.complex64,
                              device=dev, generator=gen)
            rk = cls(cfg, rec, DEEP_BLOCK, dev)
            st0 = rk.init_state()
            st1, yk = via_kernel(name, lambda: rk.step(st0))
            report(f"{name} [f {f}, block 0]", yk, rk.block_plain(st0),
                   direct_oracle(rec[:prefix].cpu().numpy().astype(
                       np.complex128), freqs, M, f))
            st2, yk = via_kernel(name, lambda: rk.step(st1))
            tag = f"{name} [f {f}]"
            report(tag, yk, rk.block_plain(st1), times=(
                timed(lambda: rk.step(st1)),
                timed(lambda: rk.block_plain(st1))), rows=tmp,
                cost=((DEEP_BLOCK + (f - 1) * M) * 8 +
                      nbytes(rk._hmod, rk._ramp, st1[1], yk),
                      ddc_flops(nb, len(freqs), M * f)))
            E = recording_rows(rk.X, st1[0], rk.nbr, f - 1, 1)
            tmp[tag]["snr_db"] = ddc_snr64(
                tag, yk, rk._hmod, rk._ramp, st1[1], D_RATE, M, f, E)
            if name == "replay_ddc_t":    # #9: its yardstick, (nb, f*M) rows
                tmp[tag]["library_ms"] = ddc_library_ms(E, rk._hmod, f,
                                                        timed)
            del E
            deep_row(deep, tmp, name, f, tag)
            report(f"{name} [f {f}, block 0 after the seam]",
                   via_kernel(name, lambda: rk.step(st2))[1],
                   rk.block_plain(st2))
            del rk, rec

    # #10: shard 1 of a (time=2) mesh at the stream's first block (its
    # history shard 0's rows) and the next block
    f = DEEP_SHARD_F
    cfg = cfg_of(CONFIG3, f)
    rec = torch.randn(2 * DEEP_BLOCK, dtype=torch.complex64, device=dev,
                      generator=gen)
    rk = ShardedReplayDDC(cfg, rec, DEEP_BLOCK, [dev] * 2)
    rec_np, H, nbt = rec.cpu().numpy(), (f - 1) * M, rk.nbr_t
    st0 = rk.init_state()
    st1 = (1, rk.advance(st0)[1], 1)
    for idx, st in ((0, st0), (1, st1)):
        yk = via_kernel("replay_ddc_sharded", lambda: rk.local(st, 1))
        a0 = idx * DEEP_BLOCK + DEEP_BLOCK // 2      # shard 1's first sample
        xs = rec_np[np.arange(a0 - H, a0 + prefix)].astype(np.complex128)
        report(f"replay_ddc_sharded [f {f}, block {idx}, shard 1]", yk,
               rk.local_plain(st, 1),
               direct_oracle_at((xs, a0), CONFIG3, M, f))
    tag = f"replay_ddc_sharded [f {f}]"
    report(tag, yk, rk.local_plain(st1, 1), times=(
        timed(lambda: rk.local(st1, 1)), timed(lambda: rk.local_plain(st1, 1))),
        rows=tmp, cost=((nbt + f - 1) * M * 8 + nbytes(
            rk._hmod[1], rk._ramp[1], st1[1], yk),
            ddc_flops(nbt, len(CONFIG3), M * f)))
    tmp[tag]["snr_db"] = ddc_snr64(
        tag, yk, rk._hmod[1], rk._ramp[1], st1[1], D_RATE, M, f,
        torch.cat([rk.H[1][1], rk.X[1][nbt:2 * nbt]]))
    deep_row(deep, tmp, "replay_ddc_sharded", f, tag)
    del rk, rec

    # #15 at f 1000: shard 0 and 1 of the stream's first block, shard 0 of
    # the next (its halo the first block's tail)
    f = DEEP_CHAIN_F
    ch = TonesDirectChain(D_RATE, tuple(CONFIG3), (0.01,) * 100,
                          cfg_of(CONFIG3, f), DEEP_BLOCK, time_shards=2)
    check(ch.ok, "deep chain geometry")
    nbt, H = ch.nb // 2, (f - 1) * M
    Pt = [ch.P[t * nbt:(t + 1) * nbt].to(dev) for t in range(2)]
    hPt = [ch.halo_rows(t * nbt).to(dev) for t in range(2)]
    Gd, ramp = ch.G.to(dev), ch.ramp.to(dev)
    st0 = ch.init_state(dev)
    st1 = ch.block_rotations(st0)[0]
    for blk, st, t in ((0, st0, 0), (0, st0, 1), (1, st1, 0)):
        _, srot, hrot0, drot = ch.block_rotations(st)
        args = (Pt[t], hPt[t], Gd, ramp[t * nbt:(t + 1) * nbt], srot,
                hrot0 if t == 0 else srot, drot)
        yk = via_kernel("chain", lambda: chain(*args))
        a0 = blk * DEEP_BLOCK + t * (DEEP_BLOCK // 2)
        xs = comb_at(CONFIG3, 0.01, a0 - H, H + prefix)
        report(f"chain [f {f}, block {blk}, shard {t}]", yk,
               chain_plain(*args), direct_oracle_at((xs, a0), CONFIG3, M, f))
    tag = f"chain [f {f}]"
    Ct, Cp = Gd.shape[1], Gd.shape[2]
    report(tag, yk, chain_plain(*args), times=(
        timed(lambda: chain(*args)), timed(lambda: chain_plain(*args))),
        rows=tmp, cost=(nbytes(*args) + nbt * Cp * 8,
                        nbt * Cp * (8 * f * Ct + 12)), tc=True)
    tmp[tag]["snr_db"] = snr64(tag, yk, chain_plain, *args)
    deep_row(deep, tmp, "chain", f, tag)
    return deep


def phase_deep_fir_main_path(dev):
    """Config 3 host-fed at pf_average DEEP_RUN_F through run_measurement
    (the DDC kernel, #7), its rows held against the plain DDC over the
    same TX blocks; the FIR's startup rows of the first packet are not
    held to the amplitude."""
    import torch
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    from gpu_sdr_tpu_torch.engine.demodulator import direct_config
    from gpu_sdr_tpu_torch.ops import ddc

    def params(k):
        p = direct_params(CONFIG3, 0.01, k)
        p.A_RX2.pf_average = DEEP_RUN_F
        return p

    def run(k, keep=0):
        return run_path(dev, params(k), IdealChannel(),
                        DirectCheck(100, 0.01, keep=keep,
                                    start_rows=DEEP_RUN_F - 1),
                        k, D_BLOCK, 100)
    n = DEEP_RUN_BLOCKS
    run(1)                                                   # warm-up
    (pkt, disp, msps, wall), counts = counted(lambda: run(n, keep=n))
    print(f"DIRECT config 3 host-fed at pf_average {DEEP_RUN_F}: {disp}, "
          f"{n} blocks, {counts['ddc']} ddc launches; {msps:.1f} Msps "
          f"streaming, {wall:.3f} s with set-up")
    check(disp == (("A_RX2", "host_pipeline", None),),
          f"deep host-fed dispatch {disp}")
    check(counts["ddc"] == n and
          all(v == 0 for k, v in counts.items() if k != "ddc"),
          f"deep host-fed launches {counts}")
    cfg = direct_config(params(n).A_RX2)
    rec = tx_recording(params, n, D_BLOCK, dev)
    args = (cfg.modulated_taps(dev), cfg.carrier_ramp(D_ROWS, dev),
            ddc.ddc_carrier_step(cfg, D_BLOCK, dev), D_RATE, cfg.M, cfg.f)
    st = (ddc.ddc_carrier_init(cfg, dev),
          torch.zeros((cfg.f - 1) * cfg.M, dtype=torch.complex64, device=dev))
    plain = []
    for b in range(n):
        x = torch.from_numpy(rec[b * D_BLOCK:(b + 1) * D_BLOCK]).to(dev)
        ph, hist, y = ddc.direct_ddc_fir(*args, *st, x)
        st = (ph, hist)
        plain.append(y[ROWS].cpu().numpy())
    snr = snr_db(np.stack(plain), np.stack(pkt.kept))
    print(f"DIRECT config 3 host-fed at pf_average {DEEP_RUN_F} vs the plain "
          f"DDC over the same blocks (rows ::97): SNR {snr:.1f} dB")
    check(snr >= SNR_BAR_DB, f"deep host-fed vs plain {snr:.1f} dB")
    return counts["ddc"]


def phase_new_kernels(dev):
    """The five kernels that no engine path takes, each against its plain
    version and a float64 oracle at full width: #12 (fold_streamed) and
    #13 (fold_rotg) at config 3, each also against #11 (fold) as the
    JAX package's tests hold them (tests/test_pallas_chain.py:213-269);
    #14 (fold_t) at block_len 4,096,000 against #11 transposed; #3
    (channelizer_scrambled) at nfft 1000, avg 4, 4,000,000 samples
    against #1's stream mode permuted; #19 (chirp_lockin) at config 2
    from the stream's start, inside a step, across the period's end and
    from period - 7,000, on the chirp and on a down-chirp, against #18
    (lockin_at) on the same samples, the integer phases of its walk
    against the oracle's exactly, two launches the same bits, and one
    sample into its allocation (the 8-byte body).  Times from CUDA events
    (#19: queued over rotating blocks, beside a torch.sum over the same
    rows), each with its bound and, for the folds, the matmul
    yardstick."""
    import torch
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.channelizer import (
        best_split, channelizer, channelizer_consts, channelizer_scrambled,
        channelizer_scrambled_plain, scramble_index, scrambled)
    from gpu_sdr_tpu_torch.ops.chirp import ChirpConfig, chirp_block
    from gpu_sdr_tpu_torch.ops.fold import (
        TonesDirectFold, TonesDirectFoldT, fold, fold_rotg, fold_rotg_plain,
        fold_streamed, fold_streamed_plain, fold_t, fold_t_plain)
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_at import (
        chirp_plan, fused_chirp_lockin, fused_chirp_lockin_plain, lockin_at,
        pointers_aligned)
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    rows = {}
    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * 100)
    ampl = (0.01,) * 100
    oracle = direct_oracle(comb(CONFIG3, 0.01, ORACLE_ROWS * D_DECIM),
                           CONFIG3)

    def folds(L):
        return (TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, L, dev),
                TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, L, dev,
                                time_shards=2),
                TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, L, dev,
                                rotg=True))

    def factored(ch, st):
        _, srots, drots = ch.rotations(st, 1)
        return (ch.P1, ch.G2, *ch.tile_rotations(srots, drots), ch.ramp1,
                ch.nb)

    def streamed(ch, st):
        _, srots, drots = ch.rotations(st, 1)
        return (ch.P, ch.G2, srots, drots, ch.ramp, ch.nb)

    # #12 and #13 (and #11 for reference) at config 3
    f11, f12, f13 = folds(D_BLOCK)
    st0 = f11.init_state()
    st1 = f11.advance(st0)
    ref = via_kernel("fold", lambda: fold(*factored(f11, st1)))
    lms = fold_library_ms(f11, factored(f11, st1)[2])
    Ct, Cp = f11.G2.shape
    for name, ch, kern, plain, argf in (
            ("fold_streamed", f12, fold_streamed, fold_streamed_plain,
             streamed),
            ("fold_rotg", f13, fold_rotg, fold_rotg_plain, factored)):
        a0 = argf(ch, st0)
        report(f"{name} [stream start]", ch.startup_correction(
            st0, via_kernel(name, lambda: kern(*a0))),
            ch.startup_correction(st0, plain(*a0)), oracle)
        a1 = argf(ch, st1)
        yk = via_kernel(name, lambda: kern(*a1))
        s = snr_db(ref.cpu().numpy(), yk.cpu().numpy())
        print(f"{name} vs fold (#11), block 1: SNR {s:.1f} dB")
        check(s >= SNR_BAR_DB, f"{name} vs fold {s:.1f} dB")
        report(name, yk, plain(*a1), times=(
            time_ms(lambda: kern(*a1)), time_ms(lambda: plain(*a1))),
            rows=rows, cost=(nbytes(*a1[:5], yk), D_ROWS * Cp * (8 * Ct + 12)),
            tc=True)
        rows[name]["snr_db"] = snr64(name, yk, plain, *a1)
        rows[name]["library_ms"] = lms
    del f11, f12, f13, ref

    # #14 at block_len 4,096,000 (nb 40,960), against #11 transposed
    fT = TonesDirectFoldT(D_RATE, tuple(CONFIG3), ampl, cfg, T_BLOCK, dev)
    base = fT.base

    def transposed(st):
        a = factored(base, st)
        return (*a[:4], fT.ramp1T, a[5])
    a0 = transposed(st0)
    yk = base.startup_correction(st0, via_kernel("fold_t", lambda: fold_t(
        *a0)), transposed=True)
    report("fold_t [stream start]", yk.T,
           base.startup_correction(st0, fold_t_plain(*a0), transposed=True).T,
           oracle)
    a1 = transposed(st1)
    yk = via_kernel("fold_t", lambda: fold_t(*a1))
    ref = via_kernel("fold", lambda: fold(*factored(base, st1)))
    same = torch.equal(ref.T, yk)
    s = snr_db(ref.cpu().numpy().T, yk.cpu().numpy())
    print(f"fold_t vs fold (#11) transposed, block 1: SNR {s:.1f} dB"
          + (", bit-identical" if same else ""))
    check(s >= SNR_BAR_DB, f"fold_t vs fold {s:.1f} dB")
    report("fold_t", yk.T, fold_t_plain(*a1).T, times=(
        time_ms(lambda: fold_t(*a1)), time_ms(lambda: fold_t_plain(*a1))),
        rows=rows, cost=(nbytes(*a1[:5], yk), fT.nb * Cp * (8 * Ct + 12)),
        tc=True)
    rows["fold_t"]["snr_db"] = snr64("fold_t", yk, fold_t_plain, *a1)
    rows["fold_t"]["library_ms"] = fold_library_ms(base, a1[2])
    del fT, base, ref

    # #3: nfft 1000, avg 4, 4,000,000 samples; its 16 first frames
    # against a float64 oracle, the whole block against #1 permuted
    rng = np.random.default_rng(97531)
    pcfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    w2, F1, G = channelizer_consts(pcfg, dev)
    n1, n2 = best_split(NFFT)
    spare_np, x_np = crandn(rng, AVG - 1, NFFT), crandn(rng, SC_FRAMES, NFFT)
    spare, x = torch.from_numpy(spare_np).to(dev), torch.from_numpy(x_np).to(
        dev)
    k = via_kernel("channelizer_scrambled",
                   lambda: channelizer_scrambled(w2, F1, G, spare, x))
    p = channelizer_scrambled_plain(w2, F1, G, spare, x)
    nat = via_kernel("channelizer", lambda: channelizer(w2, F1, G, spare, x))
    torch.cuda.synchronize(dev)
    kn, pn = k.cpu().numpy(), p.cpu().numpy()
    check(kn.shape == (SC_FRAMES, NFFT) and np.isfinite(kn).all(),
          "channelizer_scrambled: shape or non-finite")
    w = w2.cpu().numpy().astype(np.float64)
    ext = np.concatenate([spare_np, x_np[:16]]).astype(np.complex128)
    spec = np.fft.fft(sum(w[i] * ext[i:i + 16] for i in range(AVG)), axis=-1)
    spec64 = np.empty_like(spec)
    spec64[:, scramble_index(np.arange(NFFT), n1, n2)] = spec
    s_plain, s_gold = snr_db(pn, kn), snr_db(spec64, kn[:16])
    same = torch.equal(scrambled(nat, n1, n2), k)
    s_nat = snr_db(scrambled(nat, n1, n2).cpu().numpy(), kn)
    err = float(np.abs(kn - pn).max())
    s64 = snr_full("channelizer_scrambled", scrambled(pfb64(
        w2, torch.cat([spare, x])), n1, n2), k)
    ms, pms, nms, two_ms = (time_ms(fn) for fn in (
        lambda: channelizer_scrambled(w2, F1, G, spare, x),
        lambda: channelizer_scrambled_plain(w2, F1, G, spare, x),
        lambda: channelizer(w2, F1, G, spare, x),
        two_calls(pcfg, w2, SC_FRAMES, lambda: x)))
    b = bound(nbytes(w2, spare, x, k), pfb_flops(SC_FRAMES))
    print(f"channelizer_scrambled {SC_FRAMES}x{NFFT}: SNR {s_plain:.1f} dB vs "
          f"plain, {s_gold:.1f} dB vs float64 (16 frames), {s_nat:.1f} dB vs "
          f"#1 permuted" + (" (bit-identical)" if same else "") +
          f", max |err| {err:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"#1 stream mode (natural order) {nms:.4f} ms, pre-sum kernel "
          f"+ torch.fft {two_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    check(min(s_plain, s_gold, s_nat) >= SNR_BAR_DB,
          f"channelizer_scrambled under {SNR_BAR_DB} dB")
    rows["channelizer_scrambled"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=pms, library_ms=None,
                                         natural_order_ms=nms,
                                         two_call_ms=two_ms, snr_db=s64,
                                         **b)
    del x, k, p, nat

    # #19 at config 2: a random block from the stream's start, inside a
    # step, across the period's end and from period - 7,000 (the seam
    # inside a segment), for the chirp and its reversed sweep
    steps, chirp_t = CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0]
    f_lo, f_hi = CONFIG2["freq"][0], CONFIG2["chirp_f"][0]
    wp_np = lockin_profile(20_000)
    wp, wp64 = torch.from_numpy(wp_np).to(dev), wp_np.astype(np.float64)
    gen = torch.Generator(device=dev).manual_seed(13579)
    Xc = torch.randn((R_BLOCKS, C_BLOCK), dtype=torch.complex64, device=dev,
                     generator=gen)
    err = 0.0
    for down in (False, True):
        ccfg = ChirpConfig.from_params(f_hi if down else f_lo,
                                       f_lo if down else f_hi, C_RATE, steps,
                                       chirp_t)
        ppt, nseg = ccfg.length, C_BLOCK // ccfg.length
        check((ppt, nseg) == (20_000, C_ROWS), f"chirp geometry {ppt}, {nseg}")
        positions = CL_POSITIONS + (ccfg.period - AT_SEAM_BACK,)
        for pos, blk in zip(positions, (0, 3, 5, 7)):
            tag = (f"chirp_lockin [{'down-chirp' if down else 'chirp'}, "
                   f"position {pos}]")
            x = Xc[blk]
            new, yk = via_kernel("chirp_lockin", lambda: fused_chirp_lockin(
                ccfg, wp, pos, x))
            again = via_kernel("chirp_lockin", lambda: fused_chirp_lockin(
                ccfg, wp, pos, x))[1]
            pnew, yp = fused_chirp_lockin_plain(ccfg, wp, pos, x)
            y18 = via_kernel("lockin_at", lambda: lockin_at(
                ccfg, wp, pos, x.view(nseg, ppt), 0, nseg))[1]
            exact = walk_exact(ccfg, pos, nseg, ppt, dev, down=down)
            y64 = (np.conj(chirp_oracle(pos, C_BLOCK, down)).reshape(
                nseg, ppt) * x.cpu().numpy().reshape(nseg, ppt)) @ wp64
            chirp = chirp_block(ccfg, pos, C_BLOCK, device=dev)[1]
            off = float((via_kernel("chirp_lockin", lambda: fused_chirp_lockin(
                ccfg, wp, pos, chirp))[1] - 1).abs().max())
            torch.cuda.synchronize(dev)
            kn, pn = yk.cpu().numpy(), yp.cpu().numpy()
            check(kn.shape == (nseg,) and np.isfinite(kn).all(),
                  f"{tag}: shape or non-finite")
            s_plain, s_gold = snr_db(pn, kn), snr_db(y64, kn)
            same = torch.equal(yk, y18)
            err = max(err, float(np.abs(kn - pn).max()))
            print(f"{tag}: SNR {s_plain:.1f} dB vs plain, {s_gold:.1f} dB vs "
                  f"float64, " + ("bit-identical to" if same else "differs "
                                  "from") + " #18 on the same samples; "
                  "integer phases " + ("exactly" if exact else "NOT") +
                  " the oracle's; two launches " +
                  ("the same" if torch.equal(yk, again) else "DIFFERENT") +
                  f" bits; on the chirp max |y - 1| {off:.2e}")
            check(new == pnew == (pos + C_BLOCK) % ccfg.period,
                  f"{tag}: new position {new}")
            check(s_plain >= SNR_BAR_DB and s_gold >= SNR_BAR_DB and same and
                  exact and torch.equal(yk, again) and off <= C_TOL,
                  f"{tag} failed")
    # a block one sample into its allocation: the 8-byte body
    x = Xc.view(-1)[1:1 + C_BLOCK]
    check(chirp_plan(nseg, ppt, pointers_aligned(x.data_ptr(), wp.data_ptr(
    )))["vec"] == 1, "chirp_lockin one sample in: not the 8-byte body")
    pos = AT_POSITIONS[1]
    yk = via_kernel("chirp_lockin", lambda: fused_chirp_lockin(
        ccfg, wp, pos, x))[1]
    s_plain = snr_db(fused_chirp_lockin_plain(ccfg, wp, pos, x)[1].cpu()
                     .numpy(), yk.cpu().numpy())
    print(f"chirp_lockin [down-chirp, position {pos}, one sample in (8-byte "
          f"loads)]: SNR {s_plain:.1f} dB vs plain")
    check(s_plain >= SNR_BAR_DB, f"chirp_lockin one sample in {s_plain:.1f}")
    rot = itertools.count()

    def blk_args():
        i = next(rot)
        return ccfg, wp, (i * C_BLOCK) % ccfg.period, Xc[i % R_BLOCKS]
    ms, pms = (time_ms_queued(lambda: fn(*blk_args()), 2 * R_BLOCKS)
               for fn in (fused_chirp_lockin, fused_chirp_lockin_plain))
    rms = time_ms_queued(lambda: torch.sum(Xc[next(rot) % R_BLOCKS].view(
        torch.float32).view(nseg, 2 * ppt), dim=1), 2 * R_BLOCKS)
    b = bound(nbytes(Xc[0], wp) + nseg * 8, CHIRP_AT_OPS * C_BLOCK)
    print(f"chirp_lockin {nseg}x{ppt}: kernel {ms:.4f} ms, plain {pms:.4f} "
          f"ms, torch.sum over the same rows {rms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    rows["chirp_lockin"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                library_ms=None, read_ms=rms, **b)
    return rows


def phase_new_main_path(dev):
    """The five kernels through the ops-level entry points that run them
    (no engine path does, in either package), each run counted: #12 and
    #13 as TonesDirectFold.multi_step with time_shards=2 / rotg=True, and
    #14 as TonesDirectFoldT.multi_step, NK_CALLS calls of NK_K blocks at
    config 3, each against #11's multi_step over the same blocks (run
    first) and its rows ::97 within D_ROW_TOL of the TX amplitude; #3 as
    channelizer_frames_scrambled over SC_BLOCKS blocks of the TONES comb,
    its tones at their scrambled bins within 1% and the rows against #1's
    natural-order route permuted, and at nfft 1018, where #3's kernel
    refuses the split, through the pre-sum kernel #2 (its launches
    checked, not recorded) against the plain PFB frames permuted; #19 as fused_chirp_lockin over
    CL_BLOCKS config-2 chirp blocks made on the card (past the period's
    end), every point within C_TOL of 1."""
    import torch
    from gpu_sdr_tpu_torch.ops import ddc
    from gpu_sdr_tpu_torch.ops.channelizer import (
        best_split, can_fuse_channelizer, channelizer_consts,
        channelizer_frames, channelizer_frames_scrambled, scramble_index,
        scrambled)
    from gpu_sdr_tpu_torch.ops.chirp import ChirpConfig, chirp_block
    from gpu_sdr_tpu_torch.ops.fold import TonesDirectFold, TonesDirectFoldT
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_at import fused_chirp_lockin
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig, pfb_frames, tone_bins
    from gpu_sdr_tpu_torch.ops.tonegen import tone_comb_wavetable_block
    launches = {}

    def entry(name, kernel, run, n, record=True):
        t0 = time.perf_counter()
        out, counts = counted(run)
        torch.cuda.synchronize(dev)
        print(f"{name}: {counts[kernel]} {kernel} launches, "
              f"{time.perf_counter() - t0:.3f} s")
        check(counts[kernel] == n and
              all(v == 0 for k, v in counts.items() if k != kernel),
              f"{name} launches {counts}")
        if record:
            launches[kernel] = counts[kernel]
        return out

    def held(name, ref, got, ampl=None, skip=1):
        ref, got = np.stack(ref), np.stack(got)
        check(ref.shape == got.shape, f"{name}: {got.shape} vs {ref.shape}")
        snr = snr_db(ref, got)
        print(f"{name} vs its reference route: SNR {snr:.1f} dB" +
              (", bit-identical" if np.array_equal(ref, got) else ""))
        check(snr >= SNR_BAR_DB and np.isfinite(got).all(),
              f"{name} vs its reference {snr:.1f} dB")
        if ampl is not None:
            a = np.abs(got.reshape(-1, got.shape[-1])[skip:]) / ampl - 1.0
            check(float(np.abs(a).max()) <= D_ROW_TOL,
                  f"{name}: |y| off the TX amplitude by "
                  f"{np.abs(a).max():.4f}")

    cfg = ddc.DirectDDCConfig(D_RATE, D_DECIM, D_AVG, tuple(CONFIG3),
                              (0,) * 100)
    ampl = (0.01,) * 100

    def fold_run(ch, transposed=False):
        st, out = ch.init_state(), []
        for _ in range(NK_CALLS):
            st, y = ch.multi_step(st, NK_K)
            out.append((y.T if transposed else y)[ROWS].cpu().numpy())
        return out

    for L, opts in ((D_BLOCK, (("TonesDirectFold(time_shards=2)",
                                "fold_streamed", dict(time_shards=2)),
                               ("TonesDirectFold(rotg=True)", "fold_rotg",
                                dict(rotg=True)))),
                    (T_BLOCK, (("TonesDirectFoldT", "fold_t", None),))):
        ref = fold_run(TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, L,
                                       dev))
        for name, kernel, opt in opts:
            ch = (TonesDirectFoldT(D_RATE, tuple(CONFIG3), ampl, cfg, L, dev)
                  if opt is None else
                  TonesDirectFold(D_RATE, tuple(CONFIG3), ampl, cfg, L, dev,
                                  **opt))
            got = entry(f"{name}.multi_step, {NK_CALLS} calls of {NK_K} "
                        f"blocks of {L} samples", kernel,
                        lambda: fold_run(ch, opt is None), NK_CALLS)
            held(name, ref, got, ampl=0.01)

    # #3: the TONES comb (1000 bin-quantized tones) in 4,000,000-sample
    # blocks, the spare carried from the zero spare
    freqs = [k * (RATE // NFFT) for k in range(-NFFT // 2, NFFT // 2)]
    pcfg = PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    window = pcfg.window(dev)
    x = torch.from_numpy(tone_comb_wavetable_block(
        freqs, [1.0 / NFFT] * NFFT, RATE, SC_BLOCK)).to(dev)
    n1, n2 = best_split(NFFT)
    pos = torch.from_numpy(scramble_index(tone_bins(freqs, RATE, NFFT), n1,
                                          n2)).to(dev)
    consts = channelizer_consts(pcfg, dev)
    spare, ref = torch.zeros(AVG - 1, NFFT, dtype=torch.complex64,
                             device=dev), []
    for _ in range(SC_BLOCKS):
        spare, fr = channelizer_frames(consts, spare, x.view(SC_FRAMES, NFFT))
        ref.append(scrambled(fr, n1, n2)[ROWS].cpu().numpy())

    def scrambled_run():
        sp, out = torch.zeros((AVG - 1) * NFFT, dtype=torch.complex64,
                              device=dev), []
        for _ in range(SC_BLOCKS):
            sp, fr = channelizer_frames_scrambled(pcfg, window, sp, x)
            out.append(fr[ROWS].cpu().numpy())
        return out
    got = entry(f"channelizer_frames_scrambled, {SC_BLOCKS} blocks of "
                f"{SC_BLOCK} samples", "channelizer_scrambled", scrambled_run,
                SC_BLOCKS)
    held("channelizer_frames_scrambled", ref, got)
    amp = np.abs(np.stack(got)[:, :, pos.cpu().numpy()]).reshape(-1, NFFT)
    off = float(np.abs(amp[1:] * NFFT - 1.0).max())   # row 0: the startup
    print(f"channelizer_frames_scrambled: tones at their scrambled bins, "
          f"max |amplitude - 1| {off:.2e}")
    check(off <= 1e-2, f"channelizer_frames_scrambled: a tone off by {off}")
    del x

    # #3's entry point where its kernel refuses the geometry (nfft 1018,
    # split 2 x 509): the pre-sum kernel #2, as the JAX package leaves
    # its kernel for XLA, against the plain PFB frames permuted
    rcfg = PFBConfig(nfft=R_NFFT, avg=AVG, rate=RATE)
    check(not can_fuse_channelizer(rcfg, SC_REFUSED_FRAMES * R_NFFT),
          "channelizer_frames_scrambled: nfft 1018 fuses")
    rwin = rcfg.window(dev)
    gen = torch.Generator(device=dev).manual_seed(9753)
    xs = [torch.randn(SC_REFUSED_FRAMES * R_NFFT, dtype=torch.complex64,
                      device=dev, generator=gen) for _ in range(SC_BLOCKS)]
    r1, r2 = best_split(R_NFFT)

    def refused_run(plain=False):
        sp, out = torch.zeros((AVG - 1) * R_NFFT, dtype=torch.complex64,
                              device=dev), []
        for xb in xs:
            if plain:
                sp, fr = pfb_frames(rcfg, rwin, sp, xb)
                fr = scrambled(fr, r1, r2)
            else:
                sp, fr = channelizer_frames_scrambled(rcfg, rwin, sp, xb)
            out.append(fr[ROWS].cpu().numpy())
        return out
    ref = refused_run(plain=True)
    got = entry(f"channelizer_frames_scrambled at nfft {R_NFFT}, "
                f"{SC_BLOCKS} blocks", "presum", refused_run, SC_BLOCKS,
                record=False)
    held(f"channelizer_frames_scrambled at nfft {R_NFFT}", ref, got)
    del xs

    # #19: config 2's chirp looped back, CL_BLOCKS blocks
    ccfg = ChirpConfig.from_params(
        CONFIG2["freq"][0], CONFIG2["chirp_f"][0], C_RATE,
        CONFIG2["swipe_s"][0], CONFIG2["chirp_t"][0])
    wp = torch.from_numpy(lockin_profile(ccfg.length)).to(dev)

    def lockin_run():
        last, offs = 0, []
        for _ in range(CL_BLOCKS):
            _, c = chirp_block(ccfg, last, C_BLOCK, device=dev)
            last, y = fused_chirp_lockin(ccfg, wp, last, c)
            offs.append(float((y.abs() - C_AMPL).abs().max()))
        return offs
    offs = entry(f"fused_chirp_lockin, {CL_BLOCKS} blocks of {C_BLOCK} "
                 "samples", "chirp_lockin", lockin_run, CL_BLOCKS)
    print(f"fused_chirp_lockin: every lock-in point within {max(offs):.2e} "
          "of the TX amplitude")
    check(max(offs) <= C_TOL, f"fused_chirp_lockin off by {max(offs):.2e}")
    return launches


def check_line(kernels) -> None:
    """Every kernel of the repo is in the kernels line once, launched
    by its main path's run, with every key of the line."""
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    names = [k["name"] for k in kernels]
    check(len(kernels) == N_KERNELS and len(set(names)) == N_KERNELS,
          f"{len(kernels)} kernels in the line, expected {N_KERNELS}")
    for k in kernels:
        check(all(key in k for key in keys) and k["launches"] > 0,
              f"kernels line: {k['name']} lacks a key or a launch")


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
        timed("pre-sum cases", phase_presum_cases, dev)
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
        deep = timed("deep-FIR kernels", phase_deep_fir_kernels, dev)
        deep_launches = timed("deep-FIR main path", phase_deep_fir_main_path,
                              dev)
        rows.update(timed("new kernels", phase_new_kernels, dev))
        launches.update(timed("new kernels' entry points",
                              phase_new_main_path, dev))
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
            ("chain", "chain.cu", "gpu_sdr_tpu/ops/pallas_chain.py:253"),
            ("fold_streamed", "fold.cu",
             "gpu_sdr_tpu/ops/pallas_chain.py:606"),
            ("fold_rotg", "fold.cu", "gpu_sdr_tpu/ops/pallas_chain.py:715"),
            ("fold_t", "fold.cu", "gpu_sdr_tpu/ops/pallas_chain.py:938"),
            ("channelizer_scrambled", "channelizer.cu",
             "gpu_sdr_tpu/ops/pallas_channelizer.py:213"),
            ("chirp_lockin", "lockin.cu",
             "gpu_sdr_tpu/ops/pallas_lockin.py:67"))]
    for k in kernels:           # the deep-FIR rows, f in the hundreds
        if k["name"] in deep:
            k["deep"] = deep[k["name"]]
    kernels[[k["name"] for k in kernels].index("ddc")]["deep_launches"] = \
        deep_launches
    check_line(kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
