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

13b. two front ends, the dispatch plan and checkpoints: BASELINE config
   5 (phase 4's configuration on front ends A and B, B at half the
   amplitude, 100 blocks each) through ``run_measurement``:
   ``dual_fused:channelizer_wavetable`` on both, exactly 2 x 100
   channelizer launches and no other, packets A0, B0, A1, B1, ..., each
   front end's first 3 blocks bit-identical to its ``FusedLoopback``
   alone, B's amplitudes half A's, its rate per front end and in total;
   dual config 3 (``fold_kernel``, B's comb 250 kHz up, 20 blocks) bit
   for bit against each chain alone; ``dual_sharded_fused`` at config
   5's widths on a (2, 1) mesh (20 blocks) against the unsharded run at
   >= 90 dB; the sequential paths: B's blocks half A's (two
   ``fused_loopback`` entries and plan_dual's warning) and an ideal
   channel (two ``host_pipeline`` entries, no warning); a TONES
   host-fed (#2), config 3 host-fed (#7) and TONES fused (#1) stream
   saved after 2 blocks (``engine.save_state``), restored into a fresh
   template (``load_state``, its tensors on the card) and continued 2
   blocks bit-identically.  Every ``run_measurement`` of the smoke, in
   every phase, is held against ``engine/dispatch.plan_dispatch``.

18. HDF5 output, mixed wave types, a channel model, socket ingest and
   NODSP through ``run_measurement``, the files in a temporary
   directory on local disk (its free space checked, the files deleted):
   TONES fused (10 x 6M blocks, 480 MB of data; #1), config 3 fused
   (#11) and config 2 fused (#16) into a file and a keeping sink in one
   run (the file's ``data`` the packets transposed bit for bit,
   ``samples`` the rows, no ``errors`` rows, ``get_rx_info`` the
   parameters), then each cell into a dropping sink and into the file
   alone (Msps to the file's close, seconds of ``on_packet`` a block);
   one RX carrying config 3's 100 DIRECT tones and config 2's sweep at
   decim 100 (ppt 2,000,000), 10 x 4M blocks made on the card by the
   port's generators and held on the host: exactly 10 launches of #7
   and of #17, ``data`` and ``mixed_1`` each bit for bit its wave type's
   host-fed run alone, and on a (2, 1) mesh >= 90 dB against the one
   card; its state saved after 2 blocks, restored on the card and
   continued bit for bit; config 3 host-fed through a delay, a resonator at each tone and
   dropouts (4 blocks) bit for bit the run fed the channel's output
   computed on the host, the ``errors`` rows the dropout blocks; a
   producer thread streaming 10 config-3 blocks over 127.0.0.1 into
   ``SocketIngestSource`` (the receiver built by g++ from
   native/stream_ingest.cpp) bit for bit the ArraySource run, and one
   gone after 6 blocks: aborted, 4 blocks short, the file shrunk and
   stamped; NODSP host-fed and replayed, 5 x 4M blocks, bit for bit its
   input;
19. the science loop through the analysis client's entry points, the
   files in a temporary directory on local disk (free space checked,
   deleted after), written and read by client/h5.py, the channel models
   on the host, 1M-sample blocks (the client's commands fix buffer_len
   at 1e6): (a) measure_line_delay at 100 Msps (0.1 s, decim 200)
   through a channel of four resonators (7-31 MHz, 250 kHz wide, a
   16,384-tap response), analysed, written and loaded: within 20
   samples of the channel's group delay, LINE_DELAY["100"] set; (b)
   Single_VNA at BASELINE config 2's widths (-40 to +40 MHz, 5000
   points, 1 s) through the same channel, compensated from LINE_DELAY,
   VNA_analysis (|S21| within 0.05 of 1 away from the dips),
   initialize_peaks + vna_fit (each f0 within one 16 kHz point; Qr's
   error printed); (c) Get_noise at the four fitted tones (DIRECT,
   decim 100, 0.4 s) through the channel plus noise, the Resonators
   copied in, calculate_noise with backend "torch" on the card and
   "scipy" on the host (every channel's PSD within 0.05 dB), the
   frequency timestreams (4, 400,000) finite; (d) Get_noise at config
   3's 100 tones (pf_average 4) through an ideal channel plus noise,
   torch against scipy again, and the Welch on the card (welch_psd,
   CUDA events; batched_welch host to host) beside scipy's on the host
   over the same (100, 400,000) rows and nperseg; (e) Get_full_spec
   (config 4: 1000 channels, a 100-tone comb on the bin grid, 4 blocks)
   fused, the file's data the packets bit for bit.  Each step prints
   its seconds and the channel model's share; every run's dispatch is
   plan_dispatch's for the parameters its file holds; each step's
   launches are its 1M-sample blocks exactly (10, 100, 40, 40, 4), and
   after each step its kernel (#17, #7 in row mode at C 4, #7 in
   channel mode at C 100, #1) runs once more on seeded data at the
   step's own configuration and block, held against its plain version
   at 90 dB;
20. the server on the card: the port's ``Server`` (device cuda:0, the
   native C++ streamer built by g++) answering in a thread of this
   process, driven by the port's client (``gpu_sdr_tpu_torch.pyusrp``:
   ``Connect``, ``send_params``, ``Packets_to_file`` into files read
   back through client/h5.py) over 127.0.0.1 at the probe's widths: (a)
   TONES config 4 (#1), (b) DIRECT config 3 (#11), (c) CHIRP config 2
   (#16), 10 blocks each, fused; (d) config 3 host-fed from a producer
   streaming 5 raw blocks to the server's ingest port (#7); (e) (a)
   through the Python streamer, with the host's RSS and pinned memory;
   (f) (b) through ``python -m gpu_sdr_tpu_torch.server.main
   --one_shot`` in a subprocess (device cuda by default).  Each file's
   data is the in-process run's packets (run_measurement on the card)
   bit for bit, every packet the server sent is in it, the expected row
   count (not the EOM's grace window) ends the client's wait, each
   run's launches are its blocks exactly ((a)-(e)), and each kernel
   launched is held against its plain version at the run's own shapes
   (``held_on_path``).  Msps from send_params to the file's close
   beside the in-process run's into a dropping sink, the bytes on the
   wire, the RSS.
21. the sharded layer across two processes on the card: two ranks of
   ``python -m gpu_sdr_tpu_torch.parallel.rehearsal --size full`` on
   torch.distributed over gloo (named; NCCL refuses two ranks on one
   device), each owning one shard of the card's (2, 1) and (1, 2)
   meshes: (a) config 3 fused (#11), (b) TONES config 4 fused (#1), (c)
   config 3 host-fed through an ideal channel on (1, 2), the channel
   shards and their gather across the ranks (#7), (d) the config 3
   (#10) and TONES (#5) replays of 4-block recordings, (e) config 5 in
   lock-step through ``run_measurement(mesh=)``, 10 blocks each, (f)
   ``PerHostIngest`` at config 3's shape, each rank fed its own span
   over 127.0.0.1 (6 blocks), then rank 1's producer gone after 1.5 of
   4 blocks: both ranks end 2 blocks short.  Every rank's gathered
   streams are this process's one-process run of the same meshes bit
   for bit (each packet's CRC-32 and every 97th row; of the abort run
   its first block), each rank's launches its blocks exactly; Msps a
   rank and in total, the gather's ms a block, each rank's peak memory
   and the wall times.
22. the measurement workflows users run (gpu_sdr_tpu_torch/scripts and
   tools), each a subprocess on the card (``--device cuda --backend
   html``) in a temporary folder with its run report (every
   run_measurement's dispatch its plan, its kernel launched once a
   block and no other), the files read through ``client/h5.py``:
   ``network_test`` at its defaults (1000 channels, 100 Msps, 1 s; the
   generic scan: #2 and torch.fft); ``get_VNA`` at its defaults but 1 s
   (the line delay, then 50,000 points over +-45 MHz host-fed: #17),
   ``analyze_VNA``; ``get_noise`` at config 3's width (100 tones, decim
   100: #11), ``analyze_noise`` on the card; ``get_noise_full`` at 1000
   channels (#1); ``get_dual_VNA`` (#16) and ``get_dual_noise`` (#7);
   ``large_VNA`` over two segments (#16) into a stitched file;
   ``beam_mapper`` on a 3 x 3 grid (#7); ``live_server`` for 3 s, its
   /stream read to its end event; ``tools.array_loop`` (50 resonators:
   test_resonator_array.py's statistics) and ``fit_VNA`` on its VNA;
   ``tools.phase_coherence`` in both modes (#15, #9) over 3 Gsamples
   each, the last block against the earliest at the same comb position
   >= 90 dB.  In the ideal loopback |S21| and the beam map's responses
   are flat at the TX level, DIRECT noise rows at their tones'; each
   kernel run is held against its plain version at its run's shapes
   (``held_on_path``); the kernels line gains ``workflow_launches`` and
   ``workflow_max_abs_err``; every number is printed beside the card's
   name and power limit.

Phases 4, 5, 7, 9, 11, 13, 13b, 15, 17, 18, 19, 20 and 22 are the main
path.  Their
CallbackSink checks rows ::97 of every packet (finite; PFB tones within
1% of their amplitude; DIRECT rows within 2.5% of the TX amplitude, the
sum of the other tones' leakage through the 400-tap FIR's stopband at
config 3, and each channel's mean over the rows within 1%; every CHIRP
row) and drops the
packet, and their rates are host-clock Msamples/s from the sink's start
to its end, after a warm-up of each branch.  Every kernel launch
counter is set to 0 just before each run and read just after it.
The line before the last is a JSON object with one entry per kernel,
all 19 (the channelizer's times are const-frame mode, the main path's,
its ``config5_launches`` those of phase 13b's config-5 run; the
kernels phase 18 runs, their ``io_launches`` there; those phase 19
runs, their ``analysis_launches`` and, held against their plain
versions at phase 19's shapes, ``analysis_max_abs_err``; those phase
20's served runs (a)-(e) launch, their ``server_launches`` (the
in-process reference runs not among them) and ``server_max_abs_err``;
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
        chirp6m_params, chirp_params, config5_params, direct_params,
        loopback_params,
        receiver_only, save_recording, tx_recording)
except ImportError as e:
    print(f"chip_smoke: the port is not beside this script: {e}",
          file=sys.stderr)
    sys.exit(1)

FUSED_BLOCKS, HOST_BLOCKS = 100, 20
DUAL_BLOCKS = 100                   # config 5: blocks a front end
DUAL_SHORT = 20                     # dual config 3, dual_sharded_fused
DUAL_EXACT = 3                      # blocks held bit for bit, one chain
SEQ_BLOCKS = 4                      # the sequential paths' runs
RESUME_BLOCKS = (2, 2)              # blocks before and after a checkpoint
CONFIG3_B = [f + 250_000 for f in CONFIG3]      # dual config 3's B comb
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


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_card():
    import torch
    print(card_name())
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
    every packet as it arrives (finite, tone amplitudes within 1% of
    `ampl`) and keeps those rows of the first `keep` packets; the packet
    is dropped."""

    def __init__(self, rows: int, keep: int = 0, ampl: float = 1.0 / NFFT):
        self.rows, self.keep, self.ampl = rows, keep, ampl
        self.kept, self.n = [], 0

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (self.rows, NFFT) and d.dtype == np.complex64,
              f"packet {self.n}: {d.shape} {d.dtype}")
        sub = d[ROWS]
        check(bool(np.isfinite(sub).all()), f"packet {self.n}: non-finite")
        amp = np.abs(sub[1:] if self.n == 0 else sub)   # row 0: startup
        check(bool(np.all(np.abs(amp / self.ampl - 1.0) <= 1e-2)),
              f"packet {self.n}: tone amplitude off by more than 1%")
        if self.n < self.keep:
            self.kept.append(sub.copy())
        self.n += 1


PLAN_CHECKS = []                    # each run_measurement's planned paths


def run_path(dev, params, channel, pkt, n_blocks, block, channels,
             source=None, mesh=None, sinks=(), filename=None, h5=None):
    """One run_measurement (fed from `source` when given, on `mesh` when
    given, into the HDF5 file `filename` when given) with `pkt` as the
    CallbackSink's check, beside `sinks`: (pkt, dispatch, Msps from the
    first sink start to the last end over n_blocks blocks of `block`
    samples, the end the file's close where `h5` (an H5Timing) times it,
    seconds with set-up).  The dispatch must be engine/dispatch.
    plan_dispatch's, asked just before."""
    from gpu_sdr_tpu_torch import measure
    from gpu_sdr_tpu_torch.engine.dispatch import plan_dispatch
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    stamps = []
    plan = tuple(d.key() for d in plan_dispatch(
        params, source=source, channel=channel, mesh=mesh))

    class TimedSink(CallbackSink):
        def on_start(self, n_channels, expected_rows):
            check(n_channels == channels, f"{n_channels} channels")
            stamps.append(time.perf_counter())

        def on_end(self):
            stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    fn = measure.run_measurement(params, channel=channel, source=source,
                                 extra_sinks=[TimedSink(pkt), *sinks],
                                 device=dev, mesh=mesh, filename=filename)
    wall = time.perf_counter() - t0
    check(measure.last_dispatch() == plan, f"dispatch "
          f"{measure.last_dispatch()}, planned {plan}")
    check(fn == (None if filename is None else
                 os.path.splitext(filename)[0] + ".h5"), f"file name {fn}")
    PLAN_CHECKS.append(plan)
    check(pkt.n == n_blocks, f"{pkt.n} of {n_blocks} packets")
    end = stamps[-1] if h5 is None else max(stamps[-1], h5.ended)
    msps = n_blocks * block / (end - stamps[0]) / 1e6
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
    its launch count in ``launches`` (gpu_sdr_tpu_torch.kernels)."""
    from gpu_sdr_tpu_torch.kernels import wrappers
    return wrappers()


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
    `rows`, its bound the tensor cores' with `tc`.  Returns the max
    |err| against plain."""
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
    return err


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


class DualCheck:
    """The packet callback of a run over several front ends: each front
    end's packets through a check of its own, by the packet's front-end
    code; ``order`` keeps the codes as they came, ``n`` counts them."""

    def __init__(self, checks: dict):
        self.checks, self.order = checks, []

    def __call__(self, meta, d):
        check(meta.front_end_code in self.checks,
              f"front end {meta.front_end_code!r}")
        self.order.append(meta.front_end_code)
        self.checks[meta.front_end_code](meta, d)

    @property
    def n(self) -> int:
        return len(self.order)


class FirstBlocks:
    """A sink keeping whole copies of each front end's first k packets."""

    def __init__(self, k: int):
        self.k, self.kept = k, {}

    def on_start(self, n_channels, expected_rows):
        pass

    def on_packet(self, meta, d):
        got = self.kept.setdefault(meta.front_end_code, [])
        if len(got) < self.k:
            got.append(d.copy())

    def on_end(self):
        pass


def tree_leaves(tree):
    """The leaves of a state tree (tuples, lists, dicts)."""
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tree_leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def phase_dual_main_path(dev):
    """Two front ends, the dispatch plan and checkpoints on the card.
    BASELINE config 5 through run_measurement (dual_fused, the
    channelizer on both front ends, B at half A's amplitude): its
    launches, its packets' lock-step order, each front end's first
    blocks bit for bit against its FusedLoopback alone, its rates; dual
    config 3 (fold_kernel) bit for bit against each chain alone;
    dual_sharded_fused on a (2, 1) mesh against the unsharded run; the
    sequential paths (unmatched block plans, with plan_dual's warning; a
    channel model, with none); then a TONES host-fed (#2), a config-3
    host-fed (#7) and a TONES fused (#1) stream saved after k blocks,
    restored into a fresh template and continued bit for bit, its
    tensors back on the card.  Every run_measurement here, as in every
    phase, is held against plan_dispatch (run_path)."""
    import logging
    import tempfile

    import torch
    from gpu_sdr_tpu_torch.engine import (load_state, make_demodulator,
                                          make_generator, save_state)
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    from gpu_sdr_tpu_torch.engine.fused import FusedLoopback
    from gpu_sdr_tpu_torch.parallel import make_mesh
    A, B = "A_RX2", "B_RX2"
    fused5 = (A, "dual_fused", "channelizer_wavetable")

    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    def tones_check(keep=0, codes=(A, B), rows=(FRAMES, FRAMES)):
        return DualCheck({codes[0]: PacketCheck(rows[0], keep=keep),
                          codes[1]: PacketCheck(rows[1], keep=keep,
                                                ampl=0.5 / NFFT)})

    def alone(params, fe):
        """Front end fe's pair through FusedLoopback alone: whole copies
        of its packets."""
        first = FirstBlocks(DUAL_EXACT)
        FusedLoopback(params.antenna(fe + "_TXRX"),
                      params.antenna(fe + "_RX2"), device=dev).run(
                          [first], front_end=fe)
        return first.kept[fe]

    def exact(name, params, first):
        for fe in "AB":
            ref, got = alone(params, fe), first.kept[fe + "_RX2"]
            check(len(got) == DUAL_EXACT and
                  all(np.array_equal(r, g) for r, g in zip(ref, got)),
                  f"{name}: {fe}_RX2 differs from its chain alone")

    def only(counts, kernel, n, name):
        check(counts[kernel] == n and
              all(v == 0 for k, v in counts.items() if k != kernel),
              f"{name} launches {counts}")

    # BASELINE config 5 at full width
    run_path(dev, config5_params(WARMUP_BLOCKS), None, tones_check(),
             2 * WARMUP_BLOCKS, BLOCK, NFFT)
    first = FirstBlocks(DUAL_EXACT)
    (pkt5, disp, msps, wall), counts = counted(lambda: run_path(
        dev, config5_params(DUAL_BLOCKS), None,
        tones_check(keep=DUAL_SHORT), 2 * DUAL_BLOCKS, BLOCK, NFFT,
        sinks=[first]))
    check(disp == (fused5, (B,) + fused5[1:]), f"config 5 dispatch {disp}")
    only(counts, "channelizer", 2 * DUAL_BLOCKS, "config 5")
    n5 = counts["channelizer"]
    check(pkt5.order == [A, B] * DUAL_BLOCKS, "config 5: packets not in "
          "lock-step order")
    exact("config 5", config5_params(DUAL_EXACT), first)
    amp = {c: float(np.abs(np.stack(pkt5.checks[c].kept)[1:]).mean())
           for c in (A, B)}
    ratio = amp[B] / amp[A]
    check(abs(ratio - 0.5) <= 5e-3, f"config 5: B / A amplitude {ratio}")
    print(f"{card_name()}: config 5 {disp}, 2 x {DUAL_BLOCKS} blocks of "
          f"{BLOCK} samples, {counts['channelizer']} channelizer launches; "
          f"{msps / 2:.1f} Msps per front end, {msps:.1f} in total, "
          f"streaming; {wall:.3f} s with set-up; B / A amplitude "
          f"{ratio:.5f}; each front end's first {DUAL_EXACT} blocks "
          "bit-identical to its FusedLoopback alone")

    # dual config 3: fold_kernel on both front ends
    def config3_dual(n):
        p = direct_params(CONFIG3, 0.01, n)
        q = direct_params(CONFIG3_B, 0.01, n)
        p.B_TXRX, p.B_RX2 = q.A_TXRX, q.A_RX2
        return p
    first = FirstBlocks(DUAL_EXACT)
    (_, disp, msps3, wall), counts = counted(lambda: run_path(
        dev, config3_dual(DUAL_SHORT), None,
        DualCheck({A: DirectCheck(100, 0.01), B: DirectCheck(100, 0.01)}),
        2 * DUAL_SHORT, D_BLOCK, 100, sinks=[first]))
    check(disp == ((A, "dual_fused", "fold_kernel"),
                   (B, "dual_fused", "fold_kernel")),
          f"dual config 3 dispatch {disp}")
    only(counts, "fold", 2 * DUAL_SHORT, "dual config 3")
    exact("dual config 3", config3_dual(DUAL_EXACT), first)
    print(f"dual config 3: {disp}, 2 x {DUAL_SHORT} blocks, "
          f"{counts['fold']} fold launches; {msps3 / 2:.1f} Msps per front "
          f"end, {wall:.3f} s with set-up; bit-identical to each chain "
          "alone")

    # dual_sharded_fused: config 5's widths on a (2, 1) mesh of the card
    m21 = make_mesh((2, 1), devices=[dev] * 2)
    (pkt, disp, msps_s, wall), counts = counted(lambda: run_path(
        dev, config5_params(DUAL_SHORT), None, tones_check(keep=DUAL_SHORT),
        2 * DUAL_SHORT, BLOCK, NFFT, mesh=m21))
    check(disp == ((A, "dual_sharded_fused", "channelizer_wavetable"),
                   (B, "dual_sharded_fused", "channelizer_wavetable")),
          f"dual sharded dispatch {disp}")
    only(counts, "channelizer", 2 * 2 * DUAL_SHORT, "dual sharded")
    for c in (A, B):
        snr = snr_db(np.stack(pkt5.checks[c].kept),
                     np.stack(pkt.checks[c].kept))
        check(snr >= SNR_BAR_DB, f"dual sharded {c} vs unsharded {snr:.1f}")
    print(f"dual sharded (2, 1): {disp}, 2 x {DUAL_SHORT} blocks, "
          f"{counts['channelizer']} channelizer launches; "
          f"{msps_s / 2:.1f} Msps per front end, {wall:.3f} s with set-up; "
          f">= {SNR_BAR_DB} dB against the unsharded run")

    # the sequential paths
    def unmatched(n):
        p = config5_params(n)
        p.B_TXRX.buffer_len = p.B_RX2.buffer_len = BLOCK // 2
        return p
    log = logging.getLogger("gpu_sdr_tpu_torch.dual")
    for name, params, channel, want, kernel, n_kernel in (
            ("unmatched block plans", unmatched, None,
             ("fused_loopback", "channelizer_wavetable"), "channelizer",
             3 * SEQ_BLOCKS),
            ("a channel model", config5_params, IdealChannel(),
             ("host_pipeline", None), "presum", 2 * SEQ_BLOCKS)):
        grab = Warnings()
        log.addHandler(grab)
        try:
            rows_b = FRAMES // 2 if params is unmatched else FRAMES
            (pkt, disp, _, wall), counts = counted(lambda: run_path(
                dev, params(SEQ_BLOCKS), channel,
                tones_check(codes=("A", "B"), rows=(FRAMES, rows_b)),
                # B's half blocks: 3 x SEQ_BLOCKS packets of 4M samples
                n_kernel, 2 * BLOCK // 3 if params is unmatched else BLOCK,
                NFFT))
        finally:
            log.removeHandler(grab)
        check(disp == ((A,) + want, (B,) + want), f"{name}: dispatch {disp}")
        only(counts, kernel, n_kernel, name)
        n_a = pkt.checks["A"].n
        check(pkt.order == ["A"] * n_a + ["B"] * (pkt.n - n_a),
              f"{name}: front ends not one after the other")
        warned = any("unmatched block plans across frontends" in m
                     for m in grab.messages)
        check(warned == (params is unmatched),
              f"{name}: plan_dual's warnings {grab.messages}")
        print(f"sequential, {name}: {disp}, {pkt.n} packets, "
              f"{counts[kernel]} {kernel} launches, {wall:.3f} s; "
              f"warning: {warned}")

    # resume on the card: k blocks, save, restore, continue
    class HostFed:
        def __init__(self, p, blocks):
            self.demod = make_demodulator(p.A_RX2, dev)
            self.blocks = blocks

        def init_state(self):
            return (self.demod.init_state(), 0)

        def step(self, state):
            st, i = state
            st, y = self.demod.step(st, self.blocks[i])
            return (st, i + 1), y

    def tx_blocks(p, n):
        L = make_demodulator(p.A_RX2, dev).plan.block_len
        gen = make_generator(p.A_TXRX, L, dev)
        st, out = gen.init_state(), []
        for _ in range(n):
            st, x = gen.step(st)
            out.append(x)
        return out

    k, m = RESUME_BLOCKS
    tones_p = loopback_params(k + m)
    c3_p = direct_params(CONFIG3, 0.01, k + m)
    for name, make, kernel in (
            ("TONES host-fed",
             lambda b=tx_blocks(tones_p, k + m): HostFed(tones_p, b),
             "presum"),
            ("config 3 host-fed",
             lambda b=tx_blocks(c3_p, k + m): HostFed(c3_p, b), "ddc"),
            ("TONES fused", lambda: FusedLoopback(
                tones_p.A_TXRX, tones_p.A_RX2, device=dev), "channelizer")):
        def run(chain, st, n):
            outs = []
            for _ in range(n):
                st, y = chain.step(st)
                outs.append(y.cpu().numpy())
            return outs, st
        def from_start(n):
            chain = make()
            return run(chain, chain.init_state(), n)
        (ref, _), counts = counted(lambda: from_start(k + m))
        check(counts[kernel] == k + m, f"resume {name}: launches {counts}")
        _, st = from_start(k)
        fresh = make()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "carry")
            save_state(st, path, block_index=k)
            st2, k2 = load_state(path, like=fresh.init_state())
        tensors = [t for t in tree_leaves(st2) if isinstance(t, torch.Tensor)]
        check(k2 == k and tensors and all(t.device == dev for t in tensors),
              f"resume {name}: restored on "
              f"{sorted({str(t.device) for t in tensors})}")
        out, _ = run(fresh, st2, m)
        check(all(np.array_equal(a, b) for a, b in zip(ref[k:], out)),
              f"resume {name}: the continuation differs")
        print(f"resume {name}: saved after {k} blocks, {len(tensors)} "
              f"tensors restored on {dev}, the next {m} blocks "
              f"bit-identical ({counts[kernel]} {kernel} launches)")
    print(f"plan == actual on {len(PLAN_CHECKS)} run_measurement calls")
    return n5


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


# the sizes of the HDF5, mixed, channel, socket and NODSP phase
IO_BLOCKS = 10                      # the HDF5 cells, mixed, socket ingest
IO_SHORT = 6                        # blocks a short socket producer sends
CH_BLOCKS = 4                       # the channel model's run (host numpy)
NODSP_BLOCKS = 5
IO_FREE_BYTES = 4 << 30             # free space the phase's files need
IO_WAIT_S = 60.0                    # each socket wait


class H5Timing:
    """Times client/files.H5Sink for the runs inside it: the seconds of
    each on_packet (the write into the file) and when the last on_end
    (the file's close) returned."""

    def __enter__(self):
        from gpu_sdr_tpu_torch.client.files import H5Sink
        self.cls = H5Sink
        self.orig = (H5Sink.on_packet, H5Sink.on_end)
        self.packet_s, self.ended = [], 0.0
        on_packet, on_end = self.orig

        def timed_packet(sink, meta, data):
            t0 = time.perf_counter()
            on_packet(sink, meta, data)
            self.packet_s.append(time.perf_counter() - t0)

        def timed_end(sink):
            on_end(sink)
            self.ended = time.perf_counter()
        H5Sink.on_packet, H5Sink.on_end = timed_packet, timed_end
        return self

    def __exit__(self, *exc):
        self.cls.on_packet, self.cls.on_end = self.orig
        return False


class Keep:
    """A packet callback keeping every packet (a copy), in order."""

    def __init__(self, rows: int, channels: int):
        self.rows, self.channels = rows, channels
        self.packets, self.n = [], 0

    def __call__(self, meta, d):
        check(meta.packet_number == self.n, "packet order")
        check(d.shape == (self.rows, self.channels) and
              d.dtype == np.complex64, f"packet {self.n}: {d.shape} "
              f"{d.dtype}")
        self.packets.append(d.copy())
        self.n += 1

    @property
    def data(self) -> np.ndarray:
        return np.concatenate(self.packets)


class Drop:
    """A packet callback that drops every packet."""

    def __init__(self):
        self.n = 0

    def __call__(self, meta, d):
        self.n += 1


def host_blocks(x: np.ndarray):
    """A Source serving consecutive blocks of `x` that is not a
    recording: run_measurement feeds it through the host pipeline."""
    from gpu_sdr_tpu_torch.engine.sources import Source

    class HostBlocks(Source):
        def blocks(self, block_len, n_blocks):
            for i in range(n_blocks):
                yield x[i * block_len:(i + 1) * block_len]
    return HostBlocks()


def disk_of(path: str) -> str:
    """The mount holding `path`: its device, mount point and type."""
    best = ("?", "/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            if path.startswith(mnt) and len(mnt) >= len(best[1]):
                best = (dev, mnt, fstype)
    return f"{best[0]} on {best[1]} ({best[2]})"


def same_bits(name, ref, got):
    check(ref.shape == got.shape and ref.dtype == got.dtype,
          f"{name}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite")
    check(np.array_equal(ref, got), f"{name}: not bit-identical")
    print(f"{name}: bit-identical, {got.shape}")


def check_file(fn, params, rx_name, sink_data, dataset="data",
               errors=0):
    """An HDF5 file of run_measurement: `dataset` is `sink_data`
    transposed bit for bit, its `samples` attribute the rows written,
    `errors` holds `errors` rows, and the attributes read back through
    the port's get_rx_info give the parameters."""
    from gpu_sdr_tpu_torch.client import h5
    from gpu_sdr_tpu_torch.client import files
    params.validate()
    with h5.File(fn, "r") as f:
        g = f[f"raw_data{params.usrp_number}"][rx_name]
        data = g[dataset][()]
        samples = int(g[dataset].attrs["samples"])
        n_err = g["errors"].shape[0]
    same_bits(f"{os.path.basename(fn)} {dataset} vs the sink", sink_data.T,
              data)
    check(samples == data.shape[1], f"samples {samples} of {data.shape}")
    check(n_err == errors, f"{n_err} errors rows, expected {errors}")
    check(files.get_rx_info(fn, rx_name) == params.antenna(rx_name),
          f"{fn}: get_rx_info differs from the parameters")
    return data


def io_h5_cell(dev, tmp, name, params, n, block, rows, channels):
    """One HDF5 cell: a checked run into a file beside a MemorySink-like
    keeper (launches counted), then the same cell twice more in this
    process, into a dropping sink and into the file alone (Msps,
    seconds of on_packet a block).  Returns (launches, numbers)."""
    fn = os.path.join(tmp, name.replace(" ", "_") + ".h5")
    (keep, disp, _msps, _wall), counts = counted(
        lambda: run_path(dev, params(n), None, Keep(rows, channels), n,
                         block, channels, filename=fn))
    check_file(fn, params(n), "A_RX2", keep.data)
    os.remove(fn)
    del keep
    _, _, drop_msps, _ = run_path(dev, params(n), None, Drop(), n, block,
                                  channels)
    with H5Timing() as h5:
        _, _, h5_msps, _ = run_path(dev, params(n), None, Drop(), n,
                                    block, channels, filename=fn, h5=h5)
    size = os.path.getsize(fn)
    os.remove(fn)
    per = np.array(h5.packet_s)
    print(f"HDF5 {name}: {disp}; {drop_msps:.1f} Msps into a dropping "
          f"sink, {h5_msps:.1f} Msps into the H5Sink ({size} bytes); "
          f"on_packet {np.median(per):.4f} s a block (median; "
          f"{per.min():.4f}-{per.max():.4f}), "
          f"{size / per.sum() / 1e9:.2f} GB/s")
    return counts, dict(dispatch=disp, drop_msps=drop_msps,
                        h5_msps=h5_msps, write_s=float(np.median(per)),
                        bytes=size)


def mixed_params(n_blocks: int, mesh_ok=True):
    """One RX at 100 Msps carrying config 3's 100 DIRECT tones and config
    2's sweep at the shared decim of 100 (ppt 2,000,000: 2 points a
    4,000,000-sample block), `n_blocks` blocks."""
    from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams,
                                          UsrpParams, WaveType)
    n = len(CONFIG3)
    p = UsrpParams()
    p.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=D_RATE, buffer_len=D_BLOCK, decim=D_DECIM,
        pf_average=D_AVG, samples=n_blocks * D_BLOCK,
        freq=list(CONFIG3) + CONFIG2["freq"],
        wave_type=[WaveType.DIRECT] * n + [WaveType.CHIRP],
        chirp_f=[0] * n + CONFIG2["chirp_f"],
        chirp_t=[0.0] * n + CONFIG2["chirp_t"],
        swipe_s=[0] * n + CONFIG2["swipe_s"])
    return p


def io_mixed(dev, tmp, n):
    """The mixed cell: comb + chirp made on the card by the port's
    generators and held on the host, through run_measurement into a
    file (`data`, `mixed_1`), each group bit for bit against its wave
    type's host-fed run alone on the same samples; on a (2, 1) mesh of
    the card against the single-card output.  Returns (launches,
    numbers)."""
    from gpu_sdr_tpu_torch.client import h5
    import torch
    from gpu_sdr_tpu_torch.engine import make_demodulator, make_generator
    from gpu_sdr_tpu_torch.parallel import make_mesh
    from gpu_sdr_tpu_torch.params import UsrpParams
    comb = make_generator(direct_params(CONFIG3, 0.01, n).A_TXRX, D_BLOCK,
                          dev)
    sweep = make_generator(chirp_params(n, D_BLOCK).A_TXRX, D_BLOCK, dev)
    x = np.concatenate([a + b for a, b in zip(comb.blocks(n),
                                              sweep.blocks(n))])
    del comb, sweep
    p = mixed_params(n)
    groups = make_demodulator(p.A_RX2, dev).groups
    rows0, rows1 = D_BLOCK // D_DECIM, D_BLOCK // (
        groups[1].demod.plan.stride)
    fn = os.path.join(tmp, "mixed.h5")
    (keep, disp, msps, wall), counts = counted(
        lambda: run_path(dev, p, None, Keep(rows0, len(CONFIG3)), n,
                         D_BLOCK, len(CONFIG3), source=host_blocks(x),
                         filename=fn))
    print(f"mixed: {disp}, {n} blocks of {D_BLOCK} samples, "
          f"{counts['ddc']} ddc and {counts['lockin_table']} lockin_table "
          f"launches; {msps:.1f} Msps into the file, {wall:.3f} s with "
          "set-up")
    check(disp == (("A_RX2", "host_pipeline_mixed", None),),
          f"mixed dispatch {disp}")
    torch.cuda.empty_cache()
    check_file(fn, p, "A_RX2", keep.data)
    with h5.File(fn, "r") as f:
        chirp = f["raw_data0"]["A_RX2"]["mixed_1"][()].T
    os.remove(fn)
    for k, g in enumerate(groups):
        q = UsrpParams()
        q.A_RX2 = g.params
        q.A_RX2.samples = n * D_BLOCK
        alone, d, _m, _w = run_path(dev, q, None,
                                    Keep(g.demod.plan.out_rows,
                                         g.demod.n_channels),
                                    n, D_BLOCK, g.demod.n_channels,
                                    source=host_blocks(x))
        check(d == (("A_RX2", "host_pipeline", None),), f"dispatch {d}")
        same_bits(f"mixed group {k} ({g.wave_type.value}) vs its host-fed "
                  "run alone", alone.data, keep.data if k == 0 else chirp)
        torch.cuda.empty_cache()
    check(chirp.shape == (n * 2, 1) and rows1 == 2, f"{chirp.shape}")
    mesh = make_mesh((2, 1), devices=[dev, dev])
    fn = os.path.join(tmp, "mixed_mesh.h5")
    (mkeep, mdisp, mmsps, _w), mcounts = counted(
        lambda: run_path(dev, p, None, Keep(rows0, len(CONFIG3)), n,
                         D_BLOCK, len(CONFIG3), source=host_blocks(x),
                         mesh=mesh, filename=fn))
    with h5.File(fn, "r") as f:
        mchirp = f["raw_data0"]["A_RX2"]["mixed_1"][()].T
    os.remove(fn)
    snr0 = snr_db(keep.data, mkeep.data)
    snr1 = snr_db(chirp, mchirp)
    print(f"mixed on (2, 1): {mdisp}, {mmsps:.1f} Msps; SNR vs one card "
          f"{snr0:.1f} dB (DIRECT), {snr1:.1f} dB (CHIRP); launches "
          f"{ {k: v for k, v in mcounts.items() if v} }")
    check(mdisp == disp, f"mesh dispatch {mdisp}")
    check(min(snr0, snr1) >= SNR_BAR_DB, f"mixed mesh {snr0:.1f} / "
          f"{snr1:.1f} dB")
    del mesh, mkeep
    torch.cuda.empty_cache()
    io_mixed_resume(dev, tmp, p, x)
    _, _, drop_msps, _ = run_path(dev, p, None, Drop(), n, D_BLOCK,
                                  len(CONFIG3), source=host_blocks(x))
    print(f"mixed: {drop_msps:.1f} Msps into a dropping sink, {msps:.1f} "
          "into the file")
    torch.cuda.empty_cache()
    return counts, dict(drop_msps=drop_msps, h5_msps=msps,
                        mesh_h5_msps=mmsps)


def io_mixed_resume(dev, tmp, p, x, k=RESUME_BLOCKS):
    """The mixed demodulator's state (a tuple of its groups' states)
    saved after k[0] blocks, restored on the card into a fresh
    template and continued k[1] blocks, bit for bit the uninterrupted
    stream."""
    import torch
    from gpu_sdr_tpu_torch.engine import (load_state, make_demodulator,
                                          save_state)
    d = make_demodulator(p.A_RX2, dev)
    L = d.plan.block_len

    def run(st, a, b):
        outs = []
        for i in range(a, b):
            st, ys = d.step(st, torch.from_numpy(x[i * L:(i + 1) * L]).to(
                dev))
            outs.append([y.cpu().numpy() for y in ys])
        return st, outs
    _, ref = run(d.init_state(), 0, sum(k))
    st, _ = run(d.init_state(), 0, k[0])
    path = os.path.join(tmp, "mixed_state")
    save_state(st, path, block_index=k[0])
    st, at = load_state(path, like=d.init_state())
    check(at == k[0], f"resumed at {at}")
    _, got = run(st, k[0], sum(k))
    for a, b in zip(ref[k[0]:], got):
        for ga, gb in zip(a, b):
            check(np.array_equal(ga, gb), "mixed resume: not bit-identical")
    print(f"mixed state saved after {k[0]} blocks, restored on the card "
          f"and continued {k[1]}: bit-identical ({len(d.groups)} groups)")


def io_channel(dev, tmp, n):
    """Config 3 host-fed through ChainChannel(DelayChannel,
    make_resonator_channel (a resonator at each tone), DropoutChannel)
    into a file, bit for bit the run fed the same channel output
    computed on the host; the `errors` rows are the dropout events.
    Returns (launches, numbers)."""
    from gpu_sdr_tpu_torch.client import h5
    from gpu_sdr_tpu_torch.engine import make_generator
    from gpu_sdr_tpu_torch.engine import channel as ch

    def chain():
        return ch.ChainChannel([
            ch.DelayChannel(12_345),
            ch.make_resonator_channel(D_RATE, [
                dict(f0=float(f), Qr=1e4, Qe_re=2e4) for f in CONFIG3]),
            ch.DropoutChannel(rate=D_RATE, events_per_second=30.0,
                              dropout_len=1000, seed=31)])
    p = direct_params(CONFIG3, 0.01, n)
    rows = D_BLOCK // D_DECIM
    fn = os.path.join(tmp, "channel.h5")
    t0 = time.perf_counter()
    (keep, disp, msps, wall), counts = counted(
        lambda: run_path(dev, p, chain(), Keep(rows, len(CONFIG3)), n,
                         D_BLOCK, len(CONFIG3), filename=fn))
    check(disp == (("A_RX2", "host_pipeline", None),),
          f"channel dispatch {disp}")
    t1 = time.perf_counter()
    ref_ch, outs, events = chain(), [], []
    for blk in make_generator(p.A_TXRX, D_BLOCK, dev).blocks(n):
        outs.append(ref_ch(blk))
        events.append(ref_ch.take_errors())
    host_s = time.perf_counter() - t1
    check(sum(events) > 0, "no dropout events")
    with h5.File(fn, "r") as f:
        errs = f["raw_data0"]["A_RX2"]["errors"][()].tolist()
    check(errs == [[k * rows, (k + 1) * rows]
                   for k, e in enumerate(events) if e],
          f"errors rows {errs}, dropout events {events}")
    check_file(fn, p, "A_RX2", keep.data, errors=len(errs))
    os.remove(fn)
    ref, d, _m, _w = run_path(dev, receiver_only(direct_params(
        CONFIG3, 0.01, n)), None, Keep(rows, len(CONFIG3)), n, D_BLOCK,
        len(CONFIG3), source=host_blocks(np.concatenate(outs)))
    check(d == (("A_RX2", "host_pipeline", None),), f"dispatch {d}")
    same_bits("channel run vs the host-computed channel output",
              ref.data, keep.data)
    print(f"channel: {disp}, {n} blocks, {counts['ddc']} ddc launches, "
          f"dropout events {events}; {msps:.1f} Msps streaming (the "
          f"channel on the host: {host_s / n:.2f} s a block), "
          f"{t1 - t0:.1f} s")
    return counts, dict(msps=msps, channel_s=host_s / n)


def io_socket(dev, tmp, n, short):
    """A producer thread streams `n` config-3 blocks over 127.0.0.1 into
    SocketIngestSource; the run is bit for bit the ArraySource run
    through run_pipeline.  Then a producer that stops after `short`
    blocks: aborted, the shortfall counted, the file shrunk to the rows
    delivered and stamped.  Returns (launches, numbers)."""
    import socket
    import threading

    from gpu_sdr_tpu_torch.client import h5
    from gpu_sdr_tpu_torch.engine import (make_demodulator, make_generator,
                                          run_pipeline)
    from gpu_sdr_tpu_torch.engine.ingest import SocketIngestSource
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    from gpu_sdr_tpu_torch.engine.sources import ArraySource
    from gpu_sdr_tpu_torch.server import native
    t0 = time.perf_counter()
    native.load_library("ingest")
    built = "built by g++" if "ingest" in native.built_here else "cached"
    print(f"socket: ingest library {native.library_path('ingest').name} "
          f"({built}, {time.perf_counter() - t0:.2f} s)")
    p = direct_params(CONFIG3, 0.01, n)
    x = np.concatenate(list(make_generator(p.A_TXRX, D_BLOCK,
                                           dev).blocks(n)))
    rows = D_BLOCK // D_DECIM
    ref = Keep(rows, len(CONFIG3))
    p.validate()
    run_pipeline(make_demodulator(p.A_RX2, dev), ArraySource(x),
                 [CallbackSink(ref)])

    def stream(k):
        src = SocketIngestSource(block_len=D_BLOCK, queue_len=n + 2,
                                 timeout=IO_WAIT_S)
        wire = {}

        def send():
            t = time.perf_counter()
            with socket.create_connection(("127.0.0.1", src.port),
                                          timeout=IO_WAIT_S) as c:
                c.sendall(memoryview(x[:k * D_BLOCK]).cast("B"))
            wire["s"] = time.perf_counter() - t
        th = threading.Thread(target=send, daemon=True)
        th.start()
        return src, th, wire

    def joined(src, th):
        th.join(timeout=IO_WAIT_S)
        src.close()
        check(not th.is_alive(), "the socket producer did not finish")

    src, th, wire = stream(n)
    try:
        (got, disp, msps, wall), counts = counted(
            lambda: run_path(dev, receiver_only(direct_params(
                CONFIG3, 0.01, n)), None, Keep(rows, len(CONFIG3)), n,
                D_BLOCK, len(CONFIG3), source=src))
        stats = src.stats
    finally:
        joined(src, th)
    check(disp == (("A_RX2", "host_pipeline", None),),
          f"socket dispatch {disp}")
    check(not src.aborted and stats["overflows"] == 0 and
          stats["padded"] == 0, f"socket stats {stats}")
    same_bits("socket ingest vs the ArraySource run", ref.data, got.data)
    wire_msps = n * D_BLOCK / wire["s"] / 1e6
    print(f"socket: {disp}, {n} blocks, {counts['ddc']} ddc launches; "
          f"{msps:.1f} Msps streaming ({wire_msps:.1f} Msps on the wire, "
          f"{stats['fragments']} recv calls), {wall:.3f} s with set-up")

    src, th, _wire = stream(short)
    fn = os.path.join(tmp, "short.h5")
    try:
        short_keep, sdisp, _m, _w = run_path(
            dev, receiver_only(direct_params(CONFIG3, 0.01, n)), None,
            Keep(rows, len(CONFIG3)), short, D_BLOCK, len(CONFIG3),
            source=src, filename=fn)
    finally:
        joined(src, th)
    check(src.aborted and src.shortfall_blocks == n - short,
          f"short producer: aborted {src.aborted}, shortfall "
          f"{src.shortfall_blocks}")
    with h5.File(fn, "r") as f:
        g = f["raw_data0"]["A_RX2"]
        shape, stamp = g["data"].shape, (bool(g.attrs["aborted"]),
                                         int(g.attrs["shortfall_blocks"]))
    os.remove(fn)
    check(shape == (len(CONFIG3), short * rows) and stamp == (True,
                                                              n - short),
          f"short file {shape}, stamp {stamp}")
    same_bits(f"socket, {short} of {n} blocks, vs the ArraySource run",
              ref.data[:short * rows], short_keep.data)
    print(f"socket, producer gone after {short} of {n} blocks: aborted, "
          f"shortfall {n - short}, file {shape}, stamped {stamp}")
    return counts, dict(msps=msps, wire_msps=wire_msps)


def io_nodsp(dev, n):
    """NODSP: the raw stream, host-fed and replayed (scan), bit for bit
    the input.  Returns (launches, numbers)."""
    from gpu_sdr_tpu_torch.engine.sources import ArraySource
    from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams,
                                          UsrpParams, WaveType)
    rng = np.random.default_rng(4321)
    x = (rng.standard_normal(n * D_BLOCK, dtype=np.float32) +
         1j * rng.standard_normal(n * D_BLOCK, dtype=np.float32)
         ).astype(np.complex64)
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=D_RATE,
                            buffer_len=D_BLOCK, samples=n * D_BLOCK,
                            wave_type=[WaveType.NODSP])
    out = {}
    for name, src, want in (
            ("host-fed", host_blocks(x), ("host_pipeline", None)),
            ("replayed", ArraySource(x), ("device_replay", "scan"))):
        (keep, disp, msps, _w), counts = counted(
            lambda: run_path(dev, p, None, Keep(D_BLOCK, 1), n, D_BLOCK, 1,
                             source=src))
        check(disp == (("A_RX2",) + want,), f"NODSP dispatch {disp}")
        check(all(v == 0 for v in counts.values()),
              f"NODSP launched {counts}")
        same_bits(f"NODSP {name} vs its input", x[:, None], keep.data)
        print(f"NODSP {name}: {disp}, {n} blocks, {msps:.1f} Msps")
        out[name] = msps
    return out


def phase_io_main_path(dev):
    """HDF5 output, mixed wave types, a channel model, socket ingest and
    NODSP through run_measurement on the card, each run held against
    plan_dispatch (run_path) and its launches counted.  HDF5: TONES
    fused (#1, 10 x 6M blocks, 480 MB of data), config 3 fused (#11) and
    config 2 fused (#16), each file's data bit for bit the packets,
    `samples` the rows, no errors rows, get_rx_info the parameters; each
    cell's Msps into a dropping sink and into the file, in this process.
    Mixed: config 3's tones and config 2's sweep on one RX (exactly 10
    launches of #7 and of #17), each group bit for bit its wave type
    alone, and >= 90 dB on a (2, 1) mesh.  Channel: config 3 through
    delay, resonators and dropouts, bit for bit the host-computed
    output, the errors rows the dropout events.  Socket: bit for bit the
    ArraySource run, and a producer gone after 6 of 10 blocks aborts
    and shrinks the file.  NODSP: the input, bit for bit.  The files
    go to a temporary directory, deleted after."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"files in {tmp}: {disk_of(os.path.realpath(tmp))}, "
              f"{free / 1e9:.1f} GB free")
        check(free >= IO_FREE_BYTES, f"{free} bytes free in {tmp}")
        numbers, launches = {}, {}

        def expect(name, counts, want):
            check(all(counts[k] == v for k, v in want.items()) and
                  all(v == 0 for k, v in counts.items() if k not in want),
                  f"{name} launches {counts}, expected {want}")
            for k, v in want.items():
                launches[k] = launches.get(k, 0) + v

        n = IO_BLOCKS
        for name, params, block, rows, chans, kernel in (
                ("TONES fused", loopback_params, BLOCK, FRAMES, NFFT,
                 "channelizer"),
                ("config 3 fused", lambda k: direct_params(CONFIG3, 0.01,
                                                           k),
                 D_BLOCK, D_ROWS, len(CONFIG3), "fold"),
                ("config 2 fused", chirp_params, C_BLOCK, C_ROWS, 1,
                 "lockin_self")):
            counts, numbers[name] = io_h5_cell(dev, tmp, name, params, n,
                                               block, rows, chans)
            expect(f"HDF5 {name}", counts, {kernel: n})
        counts, numbers["mixed"] = io_mixed(dev, tmp, n)
        expect("mixed", counts, {"ddc": n, "lockin_table": n})
        counts, numbers["channel"] = io_channel(dev, tmp, CH_BLOCKS)
        expect("channel", counts, {"ddc": CH_BLOCKS})
        counts, numbers["socket"] = io_socket(dev, tmp, n, IO_SHORT)
        expect("socket", counts, {"ddc": n})
        numbers["NODSP"] = io_nodsp(dev, NODSP_BLOCKS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("io numbers:", json.dumps(numbers, default=str))
    return launches


# the science loop (phase 19): four resonators inside config 2's sweep,
# each dip 250 kHz wide (15.6 VNA points); Qe = 2 Qr, depth 0.5
SCI_RESOS = [dict(f0=f, Qr=f / 250e3, Qe_re=2 * f / 250e3)
             for f in (7e6, 15e6, 23e6, 31e6)]
SCI_FFT_LEN = 1 << 16               # the channel's response: 16,384 taps
SCI_GROUP_DELAY = SCI_FFT_LEN // 8  # their causal shift, samples
SCI_DELAY_BAR = 20                  # samples (tests/test_vna_delay.py:64)
# the beat of a delay t is t * rate / duration, under the analysis'
# Nyquist rate / 800 (decimation 400) for t < duration / 800: 125 us
SCI_DELAY_T = 0.1
SCI_VNA = dict(start_f=-40e6, last_f=40e6, measure_t=1.0, n_points=5000,
               tx_gain=0, Rate=100e6, RF=0)          # BASELINE config 2
SCI_POINT = 80e6 / 5000             # 16 kHz between VNA points
SCI_PEAK_WIDTH = 750e3              # 3 linewidths: the fit windows
SCI_NOISE_T = 0.4                   # 40M samples, 400,000 rows at decim 100
SCI_NOISE_RMS = 1e-2
SCI_WELCH = 10                      # calculate_noise's welch: nperseg L/10
SCI_DB = 0.05                       # torch against scipy, every bin
SCI_FULL_T = 0.04                   # Get_full_spec: 4 blocks of 1M
SCI_FREE_BYTES = 2 << 30
SCI_BUFFER = 1_000_000              # the client commands' buffer_len


def sci_blocks(t: float, rate: float) -> int:
    """Blocks of a client acquisition of t seconds at `rate`."""
    return int(t * rate) // SCI_BUFFER


class TimedChannel:
    """A channel model whose calls are timed (its share of a step)."""

    def __init__(self, inner):
        self.inner, self.s = inner, 0.0

    def __call__(self, block):
        t0 = time.perf_counter()
        out = self.inner(block)
        self.s += time.perf_counter() - t0
        return out

    def take_errors(self) -> int:
        take = getattr(self.inner, "take_errors", None)
        return int(take()) if take else 0


class Packets:
    """A push_queue keeping a copy of every packet's data, in order."""

    def __init__(self):
        self.packets = []

    def put(self, item):
        meta, d = item
        check(meta.packet_number == len(self.packets), "packet order")
        self.packets.append(np.array(d))


def client_step(dev, name, call, channel):
    """One client acquisition (its run_measurement inside): (file,
    launches, seconds, the channel's seconds).  The dispatch is
    engine/dispatch.plan_dispatch's for the parameters the file holds."""
    from gpu_sdr_tpu_torch import measure
    from gpu_sdr_tpu_torch.client import files
    from gpu_sdr_tpu_torch.engine.dispatch import plan_dispatch
    timed = TimedChannel(channel) if channel is not None else None
    t0 = time.perf_counter()
    fn, counts = counted(lambda: call(timed))
    wall = time.perf_counter() - t0
    plan = tuple(d.key() for d in plan_dispatch(
        files.retrieve_params_from_file(fn), channel=timed))
    check(measure.last_dispatch() == plan,
          f"{name}: dispatch {measure.last_dispatch()}, planned {plan}")
    PLAN_CHECKS.append(plan)
    ch_s = timed.s if timed is not None else 0.0
    print(f"{name}: {plan}, launches "
          f"{ {k: v for k, v in counts.items() if v} }; {wall:.1f} s, the "
          f"channel model {ch_s:.1f} s of it ({ch_s / wall:.0%})")
    return fn, counts, wall, ch_s


def welch_times(dev, x: np.ndarray, fs: float, nperseg: int) -> dict:
    """ops/spectral.welch_psd on the card (CUDA events, its input
    resident) and batched_welch from and to the host, beside
    scipy.signal.welch on the host in float64 (calculate_noise's
    scipy backend), over the same rows and nperseg."""
    import torch
    from scipy import signal
    from gpu_sdr_tpu_torch.ops import spectral
    xt = torch.from_numpy(x).to(dev)
    ms = time_ms(lambda: spectral.welch_psd(xt, fs, nperseg), runs=10)
    t0 = time.perf_counter()
    _f, p = spectral.batched_welch(x, fs, nperseg, dev)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _fs, ps = signal.welch(x.astype(np.float64), fs=fs, nperseg=nperseg,
                           detrend="linear", scaling="density")
    scipy_s = time.perf_counter() - t0
    err = float(np.max(np.abs(p - ps) / ps))
    print(f"Welch {x.shape} nperseg {nperseg}: welch_psd {ms:.3f} ms on "
          f"the card, batched_welch {host_s * 1e3:.1f} ms host to host, "
          f"scipy {scipy_s * 1e3:.1f} ms on the host; max relative "
          f"difference {err:.2e}")
    check(err < 1e-3, f"Welch: torch against scipy {err:.2e}")
    return dict(welch_psd_ms=ms, batched_welch_ms=host_s * 1e3,
                scipy_ms=scipy_s * 1e3, max_rel=err)


def noise_psds_agree(dev, fn: str, name: str) -> float:
    """calculate_noise with backend="torch" on the card, then "scipy" on
    the host, on one file: every channel's PSD (real and imaginary)
    within SCI_DB dB.  Returns the largest difference in dB."""
    from gpu_sdr_tpu_torch.client import files, noise
    out, secs = [], []
    for backend in ("torch", "scipy"):
        t0 = time.perf_counter()
        noise.calculate_noise(fn, welch=SCI_WELCH, backend=backend,
                              device=dev)
        secs.append(time.perf_counter() - t0)
        out.append(files.get_noise(fn))
    (ti, tf, tre, tim), (si, sf, sre, sim) = out
    check(ti == si and np.array_equal(tf, sf), f"{name}: noise info")
    gaps = np.stack([np.abs(a - b) for a, b in zip(tre + tim, sre + sim)])
    row, k = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
    gap = float(gaps[row, k])
    finite = all(np.isfinite(a).all() for a in tre + tim)
    print(f"{name}: calculate_noise torch {secs[0]:.2f} s, scipy "
          f"{secs[1]:.2f} s, {ti['n_chan']} channels x {len(tf)} bins, "
          f"largest gap {gap:.2e} dB ({'real' if row < len(tre) else 'imag'}"
          f" part of channel {row % len(tre)}, {tf[k]:.1f} Hz, "
          f"{(sre + sim)[row][k]:.1f} dB; the part's median "
          f"{np.median((sre + sim)[row]):.1f} dB)")
    check(finite and gap < SCI_DB, f"{name}: torch and scipy PSDs "
          f"{gap:.3f} dB apart")
    return gap


def held_on_path(dev, fn: str, tag: str, block: int = SCI_BUFFER,
                 fused: bool = False, front_end: str = None) -> dict:
    """The kernel a phase-19, -20 or -22 run ran, at that run's shapes:
    its receiver's parameters (those of the RX antenna on `front_end`,
    "A" or "B", in a file of two) and block length (`block`) read back
    from the run's file, one block of seeded data through the kernel's
    wrapper on the card (via_kernel) against its plain version on the
    same inputs, at SNR_BAR_DB as in the kernel phases.  DIRECT: the DDC
    (#7) in the mode its channel count takes, block 1 of the stream (the
    plain version's phase, a random history), or with `fused` the fold
    (#11) on the fused chain's stream-start rotations; CHIRP: the
    lock-in's table mode (#17), or with `fused` its self mode (#16) on
    the fused chain's table, at the first and last oscillator block;
    TONES or NOISE fused: the channelizer (#1) in const-frame mode on
    the chain's own comb frame, a random spare.  Returns {kernel: max
    |err|}."""
    import torch
    from gpu_sdr_tpu_torch.client import files
    from gpu_sdr_tpu_torch.engine import demodulator as dm
    from gpu_sdr_tpu_torch.engine.fused import FusedLoopback
    from gpu_sdr_tpu_torch.ops import chirp, ddc, lockin
    from gpu_sdr_tpu_torch.ops import lockin_table as lt
    from gpu_sdr_tpu_torch.ops.channelizer import (channelizer,
                                                   channelizer_plain)
    from gpu_sdr_tpu_torch.measure import _pair_tx
    from gpu_sdr_tpu_torch.ops.fold import fold, fold_plain
    from gpu_sdr_tpu_torch.params import AntMode, WaveType
    params = files.retrieve_params_from_file(fn)
    (rx_name, rx), = [(n, a) for n, a in params.active_antennas(AntMode.RX)
                      if front_end is None or n[0] == front_end]
    L = dm.make_demodulator(rx, dev).plan.block_len
    check(L == block, f"{tag}: block {L}, expected {block}")
    rng = np.random.default_rng(1919)

    def on_card(*shape):
        return torch.from_numpy(crandn(rng, *shape)).to(dev)
    wave = rx.wave_type[0]
    if fused and wave in (WaveType.DIRECT, WaveType.CHIRP):
        tx = params.antenna(_pair_tx(params, rx_name))
        fl = FusedLoopback(tx, rx, dev)
        c = fl._chain
    if fused and wave == WaveType.DIRECT:
        check(fl.path == "fold_kernel", f"{tag}: {fl.path}")
        st0 = c.init_state()
        crot, qrot = c.block_rotations_factored(st0)
        fargs = (c.P1, c.G2, crot, qrot, c.ramp1, c.nb)
        yk = via_kernel("fold", lambda: fold(*fargs))
        return {"fold": report(
            f"{tag} fold [{c.G2.shape[0]} x {c.G2.shape[1]}, stream "
            "start]", yk, fold_plain(*fargs))}
    if fused and wave == WaveType.CHIRP:
        check(fl.path == "chirp_wavetable", f"{tag}: {fl.path}")
        err = 0.0
        for o in sorted({0, c.nblk - 1}):
            yk = via_kernel("lockin_self", lambda: lt.lockin_self(
                c.profile, c.table, o, c.nseg))
            torch.cuda.synchronize(dev)
            check(bool((yk.imag == 0).all()),
                  f"{tag}: lockin_self's imaginary half not exactly 0")
            err = max(err, report(
                f"{tag} lockin_self [{c.nseg} x {c.profile.shape[0]}, "
                f"table block {o} of {c.nblk}]", yk[:, None],
                lt.lockin_self_plain(c.profile, c.table, o,
                                     c.nseg)[:, None]))
        return {"lockin_self": err}
    if wave == WaveType.DIRECT:
        cfg = dm.direct_config(rx)
        C = len(cfg.freqs)
        a = (cfg.modulated_taps(dev), cfg.carrier_ramp(L // cfg.M, dev),
             ddc.ddc_carrier_step(cfg, L, dev), cfg.rate, cfg.M, cfg.f)
        hist = on_card((cfg.f - 1) * cfg.M)
        ph = ddc.direct_ddc_fir(*a, ddc.ddc_carrier_init(cfg, dev), hist,
                                on_card(L))[0]
        x = on_card(L)
        yk = via_kernel("ddc", lambda: ddc.ddc_fused(*a, ph, hist, x))[2]
        mode = "row" if ddc.few_channels(C) else "channel"
        return {"ddc": report(
            f"{tag} ddc [{mode} mode, C {C}, M {cfg.M}, f {cfg.f}, block 1]",
            yk, ddc.direct_ddc_fir(*a, ph, hist, x)[2])}
    if wave == WaveType.CHIRP:
        cfg = chirp.chirp_config(rx)
        ppt = cfg.length * int(rx.decim)
        nseg, nblk = L // ppt, cfg.period // L
        check(chirp.chirp_table_fits(cfg, L, ppt), f"{tag}: no table")
        w = torch.from_numpy(lockin.lockin_profile(ppt)).to(dev)
        table = chirp.chirp_period_table(cfg, L, ppt, device=dev)
        x = on_card(nseg, ppt)
        err = 0.0
        for o in sorted({0, nblk - 1}):
            yk = via_kernel("lockin_table", lambda: lt.lockin_table(
                w, table, x, o, 0, nseg))
            err = max(err, report(
                f"{tag} lockin_table [{nseg} x {ppt}, oscillator block {o} "
                f"of {nblk}]", yk[:, None],
                lt.lockin_table_plain(w, table, x, o, 0, nseg)[:, None]))
        return {"lockin_table": err}
    chain = FusedLoopback(params.antenna(_pair_tx(params, rx_name)), rx,
                          dev)
    check(chain.path == "channelizer_wavetable", f"{tag}: {chain.path}")
    c = chain._chain
    w2, F1, G = c._consts
    spare = on_card(*c._spare0.shape)
    yk = via_kernel("channelizer", lambda: channelizer(
        w2, F1, G, spare, c._frame, c.T))
    return {"channelizer": report(
        f"{tag} channelizer [const frame, {c.T} x {w2.shape[1]}]", yk,
        channelizer_plain(w2, F1, G, spare, c._frame, c.T))}


def phase_science_loop(dev):
    """The analysis client's science loop at full width on the card
    (get_VNA -> fit_VNA -> get_noise -> analyze_noise, BASELINE configs
    2-4), every step through the client entry points, the files in a
    temporary directory written and read by client/h5.py: (a) the line
    delay at 100 Msps through the resonator channel of (b), within 20
    samples of its group delay; (b) the VNA at config 2's widths,
    compensated from LINE_DELAY, analysed and fitted: |S21| within 0.05
    of 1 away from the dips, each f0 within one point; (c) noise at the
    fitted tones through the same channel plus noise, the Resonators
    copied in, calculate_noise on the card and with scipy within 0.05
    dB, the frequency timestreams; (d) config 3's 100 tones, torch
    against scipy again, and the Welch timed beside scipy; (e) config
    4's full spectrum fused into a file, its data the packets bit for
    bit.  Each step's launches are pinned to its blocks (1M each, the
    client commands' buffer_len), and its kernel is held against its
    plain version at the step's shapes (held_on_path).  Returns
    (launches, {kernel: max |err| at those shapes})."""
    import shutil
    import tempfile
    from gpu_sdr_tpu_torch.client import (delay, files, fitting, full_spec,
                                          noise, vna)
    from gpu_sdr_tpu_torch.engine import channel as ch
    for r in SCI_RESOS:
        check(r["f0"] / r["Qr"] >= 10 * SCI_POINT, f"dip {r} too narrow")

    def resonators():
        return ch.make_resonator_channel(D_RATE, SCI_RESOS,
                                         fft_len=SCI_FFT_LEN)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sci_")
    launches, numbers, errs = {}, {}, {}

    def held(fn, tag):
        for k, e in held_on_path(dev, fn, tag).items():
            errs[k] = max(errs.get(k, 0.0), e)

    def add(counts, want):
        check(all(counts[k] == v for k, v in want.items()) and
              all(v == 0 for k, v in counts.items() if k not in want),
              f"launches {counts}, expected {want}")
        for k, v in want.items():
            launches[k] = launches.get(k, 0) + v
    try:
        free = shutil.disk_usage(tmp).free
        print(f"files in {tmp}: {disk_of(os.path.realpath(tmp))}, "
              f"{free / 1e9:.1f} GB free")
        check(free >= SCI_FREE_BYTES, f"{free} bytes free in {tmp}")
        delay.LINE_DELAY.clear()

        # (a) line delay
        fn, counts, wall, ch_s = client_step(
            dev, "(a) line delay", lambda c: delay.measure_line_delay(
                D_RATE, 0, "A", duration=SCI_DELAY_T,
                output_filename=os.path.join(tmp, "delay"), channel=c,
                device=dev), resonators())
        t0 = time.perf_counter()
        d = delay.analyze_line_delay(fn)
        delay.write_delay_to_file(fn, d)
        rate_msps, delay_ns = delay.load_delay_from_file(fn)
        err = d * D_RATE - SCI_GROUP_DELAY
        print(f"(a) delay {d * 1e9:.1f} ns ({d * D_RATE:.1f} samples; the "
              f"channel's {SCI_GROUP_DELAY}), analysis "
              f"{time.perf_counter() - t0:.2f} s")
        check(abs(err) <= SCI_DELAY_BAR, f"delay off by {err:.1f} samples")
        msps = int(D_RATE / 1e6)
        check(delay.LINE_DELAY.get(str(msps)) == delay_ns and
              rate_msps == msps, f"LINE_DELAY {delay.LINE_DELAY}")
        add(counts, {"lockin_table": sci_blocks(SCI_DELAY_T, D_RATE)})
        held(fn, "(a)")
        numbers["delay"] = dict(samples=d * D_RATE, s=wall, channel_s=ch_s,
                                launches=counts["lockin_table"])

        # (b) VNA at config 2's widths
        fn, counts, wall, ch_s = client_step(
            dev, "(b) VNA", lambda c: vna.Single_VNA(
                **SCI_VNA, output_filename=os.path.join(tmp, "vna"),
                channel=c, device=dev), resonators())
        check(files.get_rx_info(fn).delay == 1.0 + delay_ns * 1e-9,
              "(b) not compensated from LINE_DELAY")
        add(counts, {"lockin_table": sci_blocks(SCI_VNA["measure_t"],
                                                SCI_VNA["Rate"])})
        held(fn, "(b)")
        t0 = time.perf_counter()
        vna.VNA_analysis(fn)
        freq, s21 = vna.get_VNA_data(fn, calibrated=False)
        check(len(freq) == SCI_VNA["n_points"], f"{len(freq)} VNA points")
        away = np.ones(len(freq), bool)
        away[:20] = False                       # the channel's start-up
        for r in SCI_RESOS:
            away &= np.abs(freq - r["f0"]) > 10 * r["f0"] / r["Qr"]
        flat = float(np.max(np.abs(np.abs(s21[away]) - 1.0)))
        check(flat < 0.05, f"(b) |S21| {flat:.3f} from 1 away from dips")
        check(fitting.initialize_peaks(
            fn, N_peaks=len(SCI_RESOS), peak_width=SCI_PEAK_WIDTH,
            Qr_cutoff=5), "(b) initialize_peaks found too few")
        check(fitting.vna_fit(fn, fit_range=SCI_PEAK_WIDTH),
              "(b) vna_fit failed")
        fits = sorted(fitting.get_fit_param(fn), key=lambda p: p["f0"])
        f0_err = [p["f0"] * 1e6 - r["f0"] for p, r in zip(fits, SCI_RESOS)]
        qr_err = [p["Qr"] / r["Qr"] - 1 for p, r in zip(fits, SCI_RESOS)]
        fit_s = time.perf_counter() - t0
        print(f"(b) {len(freq)} points, |S21| within {flat:.4f} of 1 away "
              f"from the dips; f0 errors {[round(e) for e in f0_err]} Hz, "
              f"Qr errors {[f'{e:+.2%}' for e in qr_err]}; analysis and "
              f"fit {fit_s:.2f} s")
        check(len(fits) == len(SCI_RESOS) and
              max(abs(e) for e in f0_err) < SCI_POINT,
              f"(b) f0 errors {f0_err}")
        numbers["vna"] = dict(s=wall, channel_s=ch_s, flat=flat,
                              f0_err_hz=f0_err, qr_err=qr_err, fit_s=fit_s,
                              launches=counts["lockin_table"])

        # (c) noise at the fitted tones
        rf, tones = fitting.get_tones(fn)
        nf, counts, wall, ch_s = client_step(
            dev, "(c) noise at the fitted tones", lambda c: noise.Get_noise(
                tones, measure_t=SCI_NOISE_T, rate=D_RATE,
                decimation=D_DECIM, RF=rf,
                output_filename=os.path.join(tmp, "noise"), channel=c,
                device=dev),
            ch.ChainChannel([resonators()], noise_rms=SCI_NOISE_RMS,
                            seed=19))
        add(counts, {"ddc": sci_blocks(SCI_NOISE_T, D_RATE)})
        held(nf, "(c)")
        noise.copy_resonator_group(fn, nf)
        gap_c = noise_psds_agree(dev, nf, "(c)")
        dff, dqr = noise.get_frequency_timestreams(nf)
        rows = int(SCI_NOISE_T * D_RATE) // D_DECIM
        check(dff.shape == dqr.shape == (len(SCI_RESOS), rows) and
              np.isfinite(dff).all() and np.isfinite(dqr).all(),
              f"(c) frequency timestreams {dff.shape}")
        print(f"(c) frequency timestreams {dff.shape}, df/f rms "
              f"{np.std(dff, axis=1)}")
        numbers["noise"] = dict(s=wall, channel_s=ch_s, gap_db=gap_c,
                                launches=counts["ddc"])

        # (d) config 3's widths
        nf, counts, wall, ch_s = client_step(
            dev, "(d) config 3 noise", lambda c: noise.Get_noise(
                CONFIG3, measure_t=SCI_NOISE_T, rate=D_RATE,
                decimation=D_DECIM, pf_average=D_AVG, RF=0, delay=0.0,
                output_filename=os.path.join(tmp, "noise3"), channel=c,
                device=dev),
            ch.ChainChannel([ch.IdealChannel()], noise_rms=SCI_NOISE_RMS,
                            seed=3))
        add(counts, {"ddc": sci_blocks(SCI_NOISE_T, D_RATE)})
        held(nf, "(d)")
        gap_d = noise_psds_agree(dev, nf, "(d)")
        data = files.openH5file(nf)
        check(data.shape == (len(CONFIG3), rows), f"(d) {data.shape}")
        x = np.ascontiguousarray(data.real)
        del data
        numbers["config3"] = dict(s=wall, channel_s=ch_s, gap_db=gap_d,
                                  launches=counts["ddc"],
                                  welch=welch_times(dev, x, D_RATE / D_DECIM,
                                                    rows // SCI_WELCH))
        del x

        # (e) config 4: the full spectrum
        keep = Packets()
        fn, counts, wall, _ = client_step(
            dev, "(e) full spectrum", lambda c: full_spec.Get_full_spec(
                QCOMB, channels=NFFT, measure_t=SCI_FULL_T, rate=D_RATE,
                RF=0, delay=0.0, output_filename=os.path.join(tmp, "full"),
                push_queue=keep, device=dev), None)
        n_full = sci_blocks(SCI_FULL_T, D_RATE)
        add(counts, {"channelizer": n_full})
        held(fn, "(e)")
        check(len(keep.packets) == n_full, f"{len(keep.packets)} packets")
        from gpu_sdr_tpu_torch.client import h5
        with h5.File(fn, "r") as f:
            got = f["raw_data0"]["A_RX2"]["data"][()]
        same_bits("(e) the file's data vs the packets",
                  np.concatenate(keep.packets).reshape(1, -1), got)
        numbers["full_spec"] = dict(s=wall, launches=n_full)
    finally:
        delay.LINE_DELAY.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    print("science numbers:", json.dumps(numbers, default=str))
    return launches, errs


# the server on the card (phase 20): the port's daemon answering the
# port's client over 127.0.0.1 at the probe's widths
SRV_BLOCKS = 10                     # runs (a)-(c), (e), (f)
SRV_INGEST = 5                      # run (d)'s blocks over the ingest port
SRV_WAIT_S = 120.0                  # each socket and process wait
SRV_FREE_BYTES = 4 << 30            # free space the phase's files need


def rss_mb() -> float:
    """This process's resident set, MB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def peak_rss_mb() -> float:
    """This process's peak resident set since it began, MB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def pinned_mb() -> dict:
    """Pinned host memory of PyTorch's caching host allocator, MB: what
    it owns (cached blocks included) and what is handed out now and at
    most ({} where this PyTorch has no such counters)."""
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    return {k.split("_")[0] + "." + k.split(".")[1]: round(stats[k] / 1e6, 1)
            for k in ("allocated_bytes.current", "active_bytes.current",
                      "active_bytes.peak") if k in stats}


class CountingQueue:
    """Wraps a Connection's data queue: the packets and bytes the
    client took from it, and when it took the last."""

    def __init__(self):
        import queue
        from gpu_sdr_tpu_torch.server import wire
        self._q, self._hdr = queue.Queue(), wire.HEADER_SIZE
        self.n, self.bytes, self.last = 0, 0, 0.0

    def put(self, item, *a, **k):
        self._q.put(item, *a, **k)

    def get(self, *a, **k):
        item = self._q.get(*a, **k)
        self.n += 1
        self.bytes += self._hdr + item[1].nbytes
        self.last = time.perf_counter()
        return item


class Serving:
    """A port Server on `dev` answering in a thread of this process, so
    counted() sees its launches; closed, and its thread joined, at the
    end."""

    def __init__(self, dev, **kw):
        import threading

        from gpu_sdr_tpu_torch.server.main import Server
        self.srv = Server(async_port=0, data_port=0, host="127.0.0.1",
                          device=dev, **kw)
        self.srv.start()
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.is_set():
            self.srv.serve_one(timeout=0.2)

    def __enter__(self):
        self._th.start()
        return self.srv

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(timeout=SRV_WAIT_S)
        self.srv.close()
        check(not self._th.is_alive(), "the server's loop did not end")
        return False


def over_tcp(u, params, fn, n, block, sync=None, before=None):
    """One measurement through the port's client: send_params, then
    Packets_to_file into `fn` (read back through client/h5.py), told the
    rows to expect.  Returns its numbers: Msps from send_params to the
    file's close, the packets and bytes the client took, the seconds
    from the last packet to the file's close, and, with `sync` (the
    server's NativeSyncServer), the packets and bytes it sent."""
    from gpu_sdr_tpu_torch.params import AntMode, expected_samples_per_channel
    conn = u.get_connection()
    conn.data_queue = q = CountingQueue()
    params.validate()
    (_, rx), = params.active_antennas(AntMode.RX)
    exp = expected_samples_per_channel(rx)
    sent0 = sync.stats if sync is not None else None
    t0 = time.perf_counter()
    conn.send_params(params)
    if before is not None:
        before(conn)
    out = u.Packets_to_file(conn, params, filename=fn, progress=False,
                            timeout=SRV_WAIT_S, dpc_expected=exp)
    t1 = time.perf_counter()
    check(not conn.error_status.is_set(), f"{fn}: the server nacked")
    nums = dict(msps=n * block / (t1 - t0) / 1e6, packets=q.n,
                bytes=q.bytes, tail_s=t1 - q.last, rows=exp, file=out)
    if sync is not None:
        sent1 = sync.stats
        nums.update(sent=sent1["packets_sent"] - sent0["packets_sent"],
                    wire_bytes=sent1["bytes_sent"] - sent0["bytes_sent"])
    return nums


def served_file(name, fn, ref, nums, n):
    """A served run's file: `data` the in-process run's packets bit for
    bit, its rows the expected count, every packet the server sent in
    it, and the expected count (not the EOM's 0.5 s grace window) ended
    the client's wait."""
    from gpu_sdr_tpu_torch.client import files
    data = files.openH5file(nums["file"])
    same_bits(f"{name}: {os.path.basename(fn)} vs the in-process run",
              ref.T, data)
    check(data.shape[1] == nums["rows"], f"{name}: {data.shape[1]} rows, "
          f"expected {nums['rows']}")
    check(nums["packets"] == n, f"{name}: {nums['packets']} of {n} packets")
    if "sent" in nums:
        check(nums["sent"] == n and nums["wire_bytes"] == nums["bytes"],
              f"{name}: the server sent {nums['sent']} packets, "
              f"{nums['wire_bytes']} bytes; the client took "
              f"{nums['packets']}, {nums['bytes']}")
    check(nums["tail_s"] < 0.5, f"{name}: {nums['tail_s']:.3f} s from the "
          "last packet to the file's close: the grace window ended it")
    os.remove(nums["file"])


def phase_server(dev):
    """The port's server on the card, driven by the port's client
    (gpu_sdr_tpu_torch.pyusrp) over 127.0.0.1, at the probe's widths:
    (a) TONES config 4 (#1), (b) DIRECT config 3 (#11), (c) CHIRP
    config 2 (#16), 10 blocks each, fused, through the native streamer;
    (d) config 3 host-fed from a producer streaming raw complex64 to the
    server's ingest port (#7, 5 blocks); (e) (a) again through the
    Python streamer, with the host's RSS and pinned memory; (f) (b)
    again through the CLI in a subprocess (device cuda by default).
    Each file's data is the in-process run's packets (run_measurement on
    the card) bit for bit, every packet the server sent is in it, the
    expected count ends the client's wait, each run's launches are its
    blocks exactly, and each kernel it launched is held against its
    plain version at the run's own shapes (held_on_path).  Msps from
    send_params to the file's close beside the in-process run's into a
    dropping sink, and the bytes on the wire."""
    import importlib.util
    import shutil
    import socket
    import tempfile
    import threading

    import gpu_sdr_tpu_torch.pyusrp as u
    from gpu_sdr_tpu_torch.engine.generator import make_generator
    from gpu_sdr_tpu_torch.server import native, network
    print(card_name())
    t0 = time.perf_counter()
    native.load_library("stream")
    print(f"server: streamer library {native.library_path('stream').name} "
          f"({time.perf_counter() - t0:.2f} s); this host "
          + ("has" if importlib.util.find_spec("matplotlib") else "lacks")
          + " matplotlib (the PNG plots need it, the HTML ones do not)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    launches, errs, numbers = {}, {}, {}
    rss0 = rss_mb()

    def expect(name, counts, want, served=True):
        """Pin a run's launches; a served run's go into the kernels
        line's server_launches, an in-process reference run's do not."""
        check(all(counts[k] == v for k, v in want.items()) and
              all(v == 0 for k, v in counts.items() if k not in want),
              f"{name} launches {counts}, expected {want}")
        for k, v in want.items():
            if served:
                launches[k] = launches.get(k, 0) + v

    def held(fn, tag, block, fused):
        for k, e in held_on_path(dev, fn, tag, block, fused).items():
            errs[k] = max(errs.get(k, 0.0), e)

    def in_process(params, n, block, rows, chans, source=None):
        """(the kept packets, launches, Msps into a dropping sink)."""
        (keep, _d, _m, _w), counts = counted(
            lambda: run_path(dev, params(n), None, Keep(rows, chans), n,
                             block, chans, source=source))
        _, _, drop_msps, _ = run_path(dev, params(n), None, Drop(), n,
                                      block, chans, source=source)
        return keep.data, counts, drop_msps

    def say(name, nums, drop_msps, counts):
        if not isinstance(counts, str):
            counts = {k: v for k, v in counts.items() if v}
        print(f"server {name}: {nums['msps']:.1f} Msps send_params to the "
              f"file's close ({drop_msps:.1f} in process into a dropping "
              f"sink); {nums['packets']} packets, {nums['bytes']} bytes on "
              f"the wire; {nums['tail_s']:.3f} s from the last packet to "
              f"the close; launches {counts}; RSS {rss_mb():.0f} MB")
        numbers[name] = dict(msps=nums["msps"], drop_msps=drop_msps,
                             wire_bytes=nums["bytes"])

    try:
        free = shutil.disk_usage(tmp).free
        check(free >= SRV_FREE_BYTES, f"{free} bytes free in {tmp}")
        n = SRV_BLOCKS
        cells = (
            ("(a) TONES config 4", loopback_params, BLOCK, FRAMES, NFFT,
             "channelizer"),
            ("(b) DIRECT config 3",
             lambda k: direct_params(CONFIG3, 0.01, k), D_BLOCK, D_ROWS,
             len(CONFIG3), "fold"),
            ("(c) CHIRP config 2", chirp_params, C_BLOCK, C_ROWS, 1,
             "lockin_self"))
        refs = {}
        with Serving(dev) as srv:
            check(isinstance(srv.sync, native.NativeSyncServer),
                  f"data plane {type(srv.sync).__name__}")
            u.Connect(host="127.0.0.1", async_port=srv.ports[0],
                      sync_port=srv.ports[1])
            try:
                for name, params, block, rows, chans, kernel in cells:
                    ref, counts, drop_msps = in_process(params, n, block,
                                                        rows, chans)
                    expect(f"{name} in process", counts, {kernel: n},
                           served=False)
                    refs[name] = ref
                    fn = os.path.join(tmp, name[1] + ".h5")
                    nums, counts = counted(lambda: over_tcp(
                        u, params(n), fn, n, block, sync=srv.sync))
                    expect(f"{name} served", counts, {kernel: n})
                    say(name, nums, drop_msps, counts)
                    held(nums["file"], f"server {name}", block, True)
                    served_file(name, fn, ref, nums, n)
            finally:
                u.Disconnect()

        # (d) the ingest port: a producer streams config 3's TX blocks
        name, k = "(d) config 3 ingest", SRV_INGEST
        x = np.concatenate(list(make_generator(
            direct_params(CONFIG3, 0.01, k).A_TXRX, D_BLOCK, dev).blocks(k)))

        def rx_only(m):
            return receiver_only(direct_params(CONFIG3, 0.01, m))
        ref, counts, drop_msps = in_process(rx_only, k, D_BLOCK, D_ROWS,
                                            len(CONFIG3),
                                            source=host_blocks(x))
        expect(f"{name} in process", counts, {"ddc": k}, served=False)
        wire_s = {}

        def produce(conn):
            def send():
                deadline = time.monotonic() + SRV_WAIT_S
                while conn.ingest_port is None:
                    if time.monotonic() > deadline:
                        return
                    time.sleep(0.005)
                t = time.perf_counter()
                with socket.create_connection(
                        ("127.0.0.1", conn.ingest_port),
                        timeout=SRV_WAIT_S) as c:
                    c.sendall(memoryview(x).cast("B"))
                wire_s["s"] = time.perf_counter() - t
            th = threading.Thread(target=send, daemon=True)
            th.start()
            wire_s["th"] = th

        with Serving(dev, ingest_port=0) as srv:
            u.Connect(host="127.0.0.1", async_port=srv.ports[0],
                      sync_port=srv.ports[1])
            try:
                fn = os.path.join(tmp, "d.h5")
                nums, counts = counted(lambda: over_tcp(
                    u, rx_only(k), fn, k, D_BLOCK, sync=srv.sync,
                    before=produce))
            finally:
                u.Disconnect()
                wire_s["th"].join(timeout=SRV_WAIT_S)
        check(not wire_s["th"].is_alive(), "the ingest producer hung")
        expect(f"{name} served", counts, {"ddc": k})
        say(name, nums, drop_msps, counts)
        print(f"server {name}: {k * D_BLOCK / wire_s['s'] / 1e6:.1f} Msps "
              "into the ingest port")
        held(nums["file"], f"server {name}", D_BLOCK, False)
        served_file(name, fn, ref, nums, k)
        del x, ref

        # (e) (a) through the Python streamer: host and pinned memory
        name = "(e) TONES config 4, Python streamer"
        rss1, pin1 = rss_mb(), pinned_mb()
        with Serving(dev, use_native=False) as srv:
            check(isinstance(srv.sync, network.SyncServer),
                  f"data plane {type(srv.sync).__name__}")
            u.Connect(host="127.0.0.1", async_port=srv.ports[0],
                      sync_port=srv.ports[1])
            try:
                fn = os.path.join(tmp, "e.h5")
                nums, counts = counted(lambda: over_tcp(
                    u, loopback_params(n), fn, n, BLOCK))
                pin2 = pinned_mb()
            finally:
                u.Disconnect()
        expect(name, counts, {"channelizer": n})
        say(name, nums, numbers["(a) TONES config 4"]["drop_msps"], counts)
        print(f"server {name}: RSS {rss1:.0f} -> {rss_mb():.0f} MB, the "
              f"process's peak {peak_rss_mb():.0f} MB; pinned (MB) {pin1} "
              f"-> {pin2}")
        numbers[name].update(rss_mb=rss_mb(), pinned_mb=(pin1, pin2))
        served_file(name, fn, refs["(a) TONES config 4"], nums, n)

        # (f) (b) through the CLI in a subprocess, on cuda by default
        name = "(f) DIRECT config 3, the CLI"
        nums = serve_cli(u, tmp, direct_params(CONFIG3, 0.01, n), n)
        say(name, nums, numbers["(b) DIRECT config 3"]["drop_msps"],
            "in the subprocess, not counted here")
        served_file(name, os.path.join(tmp, "f.h5"),
                    refs["(b) DIRECT config 3"], nums, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"server: RSS {rss0:.0f} -> {rss_mb():.0f} MB, the process's "
          f"peak {peak_rss_mb():.0f} MB")
    print("server numbers:", json.dumps(numbers, default=str))
    return launches, errs


def serve_cli(u, tmp, params, n):
    """`python -m gpu_sdr_tpu_torch.server.main --one_shot` in a
    subprocess (its device the default, cuda), its ports read from its
    "server ready" line; one measurement through the port's client into
    tmp/f.h5; the subprocess must exit 0 after it."""
    import queue
    import re
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_sdr_tpu_torch.server.main",
         "--one_shot", "--async_port", "0", "--data_port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE))
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)
    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        t0, ready = time.monotonic(), None
        while ready is None:
            try:
                line = lines.get(timeout=max(
                    0.1, SRV_WAIT_S - (time.monotonic() - t0)))
            except queue.Empty:
                line = None
            check(line is not None, "the CLI server did not start")
            ready = re.search(r"server ready on (\S+): async port (\d+), "
                              r"data port (\d+)", line)
        print(f"CLI: {line.strip()} ({time.monotonic() - t0:.1f} s)")
        check(ready.group(1) == "cuda:0", f"CLI device {ready.group(1)}")
        u.Connect(host="127.0.0.1", async_port=int(ready.group(2)),
                  sync_port=int(ready.group(3)))
        try:
            nums = over_tcp(u, params, os.path.join(tmp, "f.h5"), n,
                            D_BLOCK)
        finally:
            u.Disconnect()
        check(proc.wait(timeout=SRV_WAIT_S) == 0,
              f"the CLI server exited {proc.returncode}")
        return nums
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=SRV_WAIT_S)
        reader.join(timeout=SRV_WAIT_S)


MP_WAIT_S = 600          # phase 21: the two ranks' deadline
# phase 21's cases (parallel/rehearsal.FULL) and each rank's launches of
# them: one a local shard and block (10 blocks; config 5 two front ends;
# the ingest 6 blocks, then 2 before its abort)
MP_LAUNCHES = {"config3_fused": {"fold": 10},
               "tones_fused": {"channelizer": 10},
               "config3_hostfed": {"ddc": 10},
               "replays": {"replay_ddc_sharded": 10,
                           "channelizer_at_halo": 10},
               "config5": {"channelizer": 20},
               "ingest": {"ddc": 8}}


def phase_multiprocess(dev):
    """The sharded layer across two processes on the card: two ranks of
    ``python -m gpu_sdr_tpu_torch.parallel.rehearsal --size full`` on
    torch.distributed over gloo (named: NCCL refuses two ranks on one
    device), each owning one shard of the card's (2, 1) and (1, 2)
    meshes, run the cases (a) config 3 fused (#11), (b) TONES config 4
    fused (#1), (c) config 3 host-fed on (1, 2): the channel shards on
    two ranks, the channel gather across them (#7), (d) the config 3
    (#10) and TONES (#5) replays, (e) config 5 in lock-step through
    run_measurement(mesh=), (f) the per-host ingest at config 3's shape,
    each rank fed its own span over 127.0.0.1, then rank 1's producer
    gone after 1.5 blocks: both ranks end with the same shortfall.  Each
    rank's gathered streams are this process's one-process run of the
    same meshes (virtual shards) bit for bit: each packet's CRC-32 and
    every 97th row (the abort run's first block, the tail being padded
    on one rank); (c)'s one-process run is held at SNR_BAR_DB against
    the unsharded host-fed run of the same stream, which no other phase
    checks at its (1, 2) shape.  Each rank's launches are its blocks
    exactly.  Prints
    Msps a rank and in total, the gather's seconds a block, each rank's
    peak memory and the wall time; returns rank 0's launches."""
    import socket
    import tempfile

    from gpu_sdr_tpu_torch.parallel import rehearsal
    t0 = time.perf_counter()
    ref_reports, ref = rehearsal.run([str(dev)] * 2, (2, 1), size="full")
    t_ref = time.perf_counter() - t0
    for rep in ref_reports:
        want = {k: 2 * v for k, v in MP_LAUNCHES[rep["phase"]].items()}
        check(rep["ok"] and rep["launches"] == want,
              f"one-process {rep['phase']}: ok {rep['ok']}, launches "
              f"{rep['launches']}, expected {want}")
    # (c)'s one-process run against the unsharded host-fed path: the
    # (1, 2) shard shape of #7 (50 channels a shard) and the channel
    # gather against the whole 100 channels in one call
    from gpu_sdr_tpu_torch import measure
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    whole = rehearsal.KeepSink(full=True)
    measure.run_measurement(rehearsal.full_direct()(rehearsal.FULL_BLOCKS),
                            channel=IdealChannel(), device=dev,
                            extra_sinks=[whole])
    check(measure.last_dispatch() == (("A_RX2", "host_pipeline", None),),
          f"unsharded config 3 host-fed dispatch {measure.last_dispatch()}")
    whole = np.concatenate([p[rehearsal.ROWS] for p in whole.packets[
        next(iter(whole.packets))]])
    snr = snr_db(whole, ref["config3_hostfed_rows"])
    print(f"config 3 host-fed, one process on (1, 2) vs unsharded, "
          f"{rehearsal.FULL_BLOCKS} blocks (rows ::97): SNR {snr:.1f} dB")
    check(snr >= SNR_BAR_DB, f"(1, 2) host-fed vs unsharded {snr:.1f} dB")
    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=HERE)
        t1 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gpu_sdr_tpu_torch.parallel.rehearsal",
             "--init", f"tcp://127.0.0.1:{port}", "--world", "2", "--rank",
             str(r), "--mesh", "2x1", "--devices", str(dev), "--backend",
             "gloo", "--size", "full", "--timeout", "120", "--out", tmp],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        deadline = time.monotonic() + MP_WAIT_S
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_ranks = time.perf_counter() - t1
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {r} exited {p.returncode}:\n"
                  f"{log[-3000:]}")
        reports = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                   for r in range(2)]
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(2)]
    first = len(ref["ingest_rows"]) // len(ref["ingest_crc"])
    for r, out in enumerate(outs):
        check(sorted(out) == sorted(ref), f"rank {r} outputs {sorted(out)}")
        for k in ref:
            a, b = ref[k], out[k]
            if k == "ingest_abort_crc":
                a, b = a[:1], b[:1]
            elif k == "ingest_abort_rows":
                a, b = a[:first], b[:first]
            check(a.shape == b.shape and np.array_equal(
                a.view(np.uint8), b.view(np.uint8)),
                f"rank {r} {k}: not the one-process run's bits")
        check(all(np.array_equal(outs[0][k], out[k]) for k in out),
              f"rank {r}'s streams differ from rank 0's")
    launches = {}
    for r, reps in enumerate(reports):
        for rep in reps:
            name = rep["phase"]
            check(rep["ok"] and rep["launches"] == MP_LAUNCHES[name],
                  f"rank {r} {name}: ok {rep['ok']}, launches "
                  f"{rep['launches']}, expected {MP_LAUNCHES[name]}")
            if r == 0:
                for k, v in rep["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    ing = [next(x for x in reps if x["phase"] == "ingest")
           for reps in reports]
    check([x["ingest_abort_shortfall"] for x in ing] == [2, 2] and
          all(x["ingest_abort_aborted"] for x in ing),
          f"ingest abort: {[x['ingest_abort_shortfall'] for x in ing]}")
    print("multi-process (2 ranks, gloo, one card) vs one process: every "
          "stream bit-identical; launches = blocks a rank")
    for name in rehearsal.FULL:
        reps = [next(x for x in rr if x["phase"] == name)
                for rr in reports]
        one = next(x for x in ref_reports if x["phase"] == name)
        for k in sorted(k for k in reps[0] if k.endswith("msps_total")):
            case = k[:-len("_msps_total")] or name
            g = k[:-len("msps_total")] + "gather_s_per_block"
            print(f"  {case}: {reps[0][k]:.1f} Msps total, "
                  f"{reps[0][k.replace('total', 'rank')]:.1f} a rank "
                  f"(one process {one[k]:.1f}); gather "
                  + ", ".join(f"rank {x['rank']} {x[g] * 1e3:.2f}"
                              for x in reps) + " ms a block")
        print(f"  {name}: wall {reps[0]['wall_s']:.2f} s a rank; peak "
              f"memory " + ", ".join(
                  f"rank {x['rank']} {x.get('peak_mem_bytes', 0) / 2**30:.2f}"
                  " GiB" for x in reps))
    print(f"phase 21: one-process reference {t_ref:.1f} s, two ranks "
          f"{t_ranks:.1f} s (start, build load and the cases)")
    return launches


# ---------------------------------------------------------------------
# Phase 22: the measurement workflows users run
# ---------------------------------------------------------------------

WF_WAIT_S = 300                     # each script's deadline
WF_FREE_BYTES = 4 << 30             # free space the phase's files need
WF_NOISE_TONES = [f"{f:.6f}" for f in np.linspace(-45, 45, 100)]   # MHz
WF_NOISE_T = "0.2"                  # get_noise: 20 blocks of 1M
WF_FULL_T = "0.1"                   # get_noise_full: 10 blocks, 80 MB
WF_DUAL_NOISE_T = "0.2"
WF_LIVE_T = "3"                     # the live view: 3 blocks at 1 Msps
WF_COHERENCE_GSAMPLES = 3.0
WF_PROFILE_TOP = 8                  # a profiled run's functions by own time
WF_LEVEL = 1e-3                     # |S21| and |resp| off the TX level
WF_DIRECT_ROW = 0.025               # DIRECT rows (phase 7's bar)
WF_DIRECT_MEAN = 0.01               # a channel's mean over its rows
# the kernel each run of a script launches once a block (None: a run no
# kernel serves, a chirp whose period is not whole blocks: no table);
# one entry serves every run.  The scripts' DIRECT noise at pf_average 1
# (dual noise, the beam map, the live view) takes the generic scan's
# DDC; the array's VNA, its period not whole blocks, no table
WF_KERNELS = {
    "network_test": ["presum"],
    "get_VNA": ["lockin_self", "lockin_table"],     # the delay fused
    "get_noise": ["fold"],
    "get_noise_full": ["channelizer"],
    "get_dual_VNA": ["lockin_self"],
    "get_dual_noise": ["ddc"],
    "large_VNA": ["lockin_self"],
    "beam_mapper": ["ddc"],
    "live_server": ["ddc"],
    "array_loop": [None, "ddc"]}


class Workflows:
    """Phase 22's scripts, each a subprocess on the card in the phase's
    folder with its run report (gpu_sdr_tpu_torch/scripts/_cli.py): the
    launches of the phase by kernel, each script's numbers."""

    def __init__(self, tmp, card):
        self.tmp, self.card = tmp, card
        self.launches, self.rows = {}, {}

    def run(self, mod, *args, name=None, popen=False):
        """python -m gpu_sdr_tpu_torch.<mod> args in the folder: (stdout,
        seconds, report); with `popen`, (the process, report path)."""
        name = name or mod.rsplit(".", 1)[-1]
        report = os.path.join(self.tmp, f"report_{name}.json")
        env = dict(os.environ, PYTHONPATH=HERE,
                   GPU_SDR_TPU_RUN_REPORT=report)
        cmd = [sys.executable, "-m", f"gpu_sdr_tpu_torch.{mod}", *args]
        if popen:
            return subprocess.Popen(cmd, cwd=self.tmp, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True), report
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=self.tmp, env=env, capture_output=True,
                           text=True, timeout=WF_WAIT_S)
        secs = time.perf_counter() - t0
        check(p.returncode == 0, f"{name} exited {p.returncode}:\n"
              f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
        return p.stdout, secs, self.account(name, report, secs)

    def account(self, name, report, secs):
        """Read a script's report: every run's dispatch its plan, its
        kernels' launches its blocks, no other kernel launched; print
        its seconds, each run's Msps and the launches."""
        with open(report) as f:
            r = json.load(f)
        for run in r["runs"]:
            check(run["plan"] == run["dispatch"], f"{name}: dispatch "
                  f"{run['dispatch']}, planned {run['plan']}")
            PLAN_CHECKS.append(tuple(map(tuple, run["plan"])))
        counts = {k: v for k, v in r["launches"].items() if v}
        kinds = WF_KERNELS.get(name)
        if kinds is not None:
            if len(kinds) == 1:
                kinds = kinds * len(r["runs"])
            check(len(kinds) == len(r["runs"]),
                  f"{name}: {len(r['runs'])} runs")
            want = {}
            for k, run in zip(kinds, r["runs"]):
                if k is not None:
                    want[k] = want.get(k, 0) + run["blocks"]
            check(counts == want, f"{name}: launches {counts}, expected "
                  f"{want} (a launch a block)")
        for k, v in counts.items():
            self.launches[k] = self.launches.get(k, 0) + v
        runs = "; ".join(
            f"{'/'.join(str(x) for x in run['dispatch'][0][1:] if x)} "
            f"{run['samples'] / 1e6:.0f} Msamples: streaming "
            f"{run['stream_seconds']:.3f} s "
            f"{run['samples'] / run['stream_seconds'] / 1e6:.1f} Msps, "
            f"with set-up {run['seconds']:.3f} s "
            f"{run['samples'] / run['seconds'] / 1e6:.1f} Msps"
            for run in r["runs"])
        print(f"{name}: {secs:.1f} s; {runs or 'no measurement'}; "
              f"launches {counts} [{self.card}]", flush=True)
        self.rows[name] = dict(seconds=secs, launches=counts, runs=[
            dict(dispatch=run["dispatch"], seconds=run["seconds"],
                 msps=run["samples"] / run["stream_seconds"] / 1e6)
            for run in r["runs"]])
        return r


def wf_file(folder, pattern):
    import glob
    found = sorted(glob.glob(os.path.join(folder, pattern)))
    check(len(found) == 1, f"files {pattern} in {folder}: {found}")
    return found[0]


def wf_flat(name, z, level, bar=WF_LEVEL):
    """|z| within `bar` of `level` everywhere: the ideal loopback."""
    a = np.abs(np.asarray(z))
    check(np.isfinite(a).all() and np.max(np.abs(a - level)) <= bar * level,
          f"{name}: |S21| from {a.min():.6f} to {a.max():.6f}, the TX "
          f"level {level}")
    return float(np.max(np.abs(a - level)) / level)


def wf_direct(name, data, level):
    """DIRECT rows past the FIR's start within WF_DIRECT_ROW of the TX
    level, each channel's mean within WF_DIRECT_MEAN (phase 7's bars)."""
    a = np.abs(np.asarray(data)[:, 8:])
    row = float(np.max(np.abs(a - level)) / level)
    mean = float(np.max(np.abs(a.mean(axis=1) - level)) / level)
    check(np.isfinite(a).all() and row <= WF_DIRECT_ROW and
          mean <= WF_DIRECT_MEAN,
          f"{name}: rows {row:.4f}, means {mean:.5f} off the level {level}")


def wf_held(dev, errs, fn, tag, fused=False, run=None, front_end=None):
    """held_on_path on a phase-22 file, at the block of its report's
    `run` where given; the error merged into `errs`."""
    block = run["samples"] // run["blocks"] if run else SCI_BUFFER
    for k, e in held_on_path(dev, fn, tag, block, fused=fused,
                             front_end=front_end).items():
        errs[k] = max(errs.get(k, 0.0), e)


def wf_held_presum(dev, errs, channels=1000):
    """The pre-sum (#2) network_test's generic scan runs, at its shapes
    (nfft 1024, avg 4, its plan's block), on a seeded block against its
    plain version: scripts/network_test.py's receiver."""
    import torch
    from gpu_sdr_tpu_torch.engine import demodulator as dm
    from gpu_sdr_tpu_torch.ops.presum import presum, presum_plain
    from gpu_sdr_tpu_torch.params import AntennaParams, AntMode, WaveType
    rate = 100_000_000
    tones = np.linspace(-rate / 2 * 0.9, rate / 2 * 0.9, channels)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=1_000_000,
                       samples=rate, fft_tones=1024, pf_average=4,
                       freq=[int(t) for t in tones],
                       wave_type=[WaveType.TONES] * channels, delay=1.0)
    cfg = dm.pfb_config(rx)
    L = dm.make_demodulator(rx, dev).plan.block_len
    rng = np.random.default_rng(2222)
    w2 = cfg.window(dev).reshape(cfg.avg, cfg.nfft)
    spare = torch.from_numpy(crandn(rng, cfg.avg - 1, cfg.nfft)).to(dev)
    X = torch.from_numpy(crandn(rng, L // cfg.nfft, cfg.nfft)).to(dev)
    k = via_kernel("presum", lambda: presum(w2, spare, X))
    errs["presum"] = max(errs.get("presum", 0.0), check_presum(
        f"network_test presum {L // cfg.nfft}x{cfg.nfft}", k,
        lambda c, w: presum_plain(w2.to(w), spare.to(c), X.to(c))))


def wf_held_replay_t(dev, errs):
    """The few-channel replay kernel (#9) phase_coherence's replay mode
    runs, at its shapes (8 tones, 4M blocks): block 1 through the
    wrapper against its plain version."""
    from gpu_sdr_tpu_torch.tools import phase_coherence as pc
    rk = pc.replay_loopback(dev, pc.BLOCK)._chain
    st1 = via_kernel("replay_ddc_t", lambda: rk.step(rk.init_state()))[0]
    yk = via_kernel("replay_ddc_t", lambda: rk.step(st1))[1]
    errs["replay_ddc_t"] = max(errs.get("replay_ddc_t", 0.0), report(
        f"phase_coherence replay_ddc_t [C {rk.cfg.n_channels}, block 1]",
        yk, rk.block_plain(st1)))


def wf_held_chain(dev, errs):
    """The chain (#15) phase_coherence's chain mode runs, at its shapes
    (16 tones, 4M blocks): block 1's rotations through the wrapper
    against its plain version."""
    from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain, chain, \
        chain_plain
    from gpu_sdr_tpu_torch.ops.ddc import DirectDDCConfig
    from gpu_sdr_tpu_torch.tools import phase_coherence as pc
    n = 16
    freqs = tuple(int(f) for f in np.linspace(-40e6, 40e6, n))
    ch = TonesDirectChain(pc.RATE, freqs, (1.0 / n,) * n, DirectDDCConfig(
        pc.RATE, 100, 4, freqs, (0,) * n), pc.BLOCK)
    a = [t.to(dev) for t in (ch.P, ch.halo_rows(0), ch.G, ch.ramp)]
    st = ch.block_rotations(ch.init_state(dev))[0]
    rots = ch.block_rotations(st)[1:]
    yk = via_kernel("chain", lambda: chain(*a, *rots))
    errs["chain"] = max(errs.get("chain", 0.0), report(
        f"phase_coherence chain [{n} tones, block 1]", yk,
        chain_plain(*a, *rots)))


def wf_profile(wf, mod, *args, name, keys, says):
    """A script run again under cProfile, in its own process on the card
    and with no run report (its launches are not the phase's): its
    seconds, the cumulative seconds of the functions named in `keys`
    (where its time goes), and the WF_PROFILE_TOP functions with the
    most seconds of their own.  cProfile adds its cost to every Python
    call, so the script's plain run beside it says what that is.
    Returns {"seconds": s, key: cumulative s}."""
    import pstats
    prof = os.path.join(wf.tmp, f"{name}.prof")
    cmd = [sys.executable, "-m", "cProfile", "-o", prof, "-m",
           f"gpu_sdr_tpu_torch.{mod}", *args]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=wf.tmp, env=dict(os.environ, PYTHONPATH=HERE),
                       capture_output=True, text=True, timeout=WF_WAIT_S)
    secs = time.perf_counter() - t0
    check(p.returncode == 0 and says in p.stdout, f"{name} under cProfile "
          f"exited {p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    st = pstats.Stats(prof).stats
    cum = {}
    for (_fn, _line, func), (_cc, _nc, _tt, ct, _callers) in st.items():
        if func in keys:
            cum[func] = max(cum.get(func, 0.0), ct)
    check(set(cum) == set(keys), f"{name} under cProfile: {sorted(cum)}")
    own = sorted(st.items(), key=lambda kv: -kv[1][2])[:WF_PROFILE_TOP]
    print(f"{name} under cProfile: {secs:.1f} s with start-up; "
          + ", ".join(f"{k} {cum[k]:.2f} s" for k in keys)
          + "; own time: " + "; ".join(
              f"{os.path.basename(fn)}:{line} {func} {v[2]:.2f} s"
              for (fn, line, func), v in own) + f" [{wf.card}]", flush=True)
    return dict(cum, seconds=secs)


def wf_split_host_fed(dev, fn, card):
    """Where the host-fed VNA's seconds go, in this process on the card
    with get_VNA's antennas read back from its file, each stage timed
    over the run's blocks after a first pass of the three: the source
    alone (the TX chirp on the card, the ideal channel's copy to the
    host and the RX delay's skip: measure.ChannelSource), the source
    through HostFeed (each block staged in pinned memory and copied to
    the card), and the whole run (run_pipeline: #17, a sink that drops
    what it is given).  Returns {stage: seconds}."""
    import torch
    from gpu_sdr_tpu_torch.client import files
    from gpu_sdr_tpu_torch.engine import (make_demodulator, make_generator,
                                          run_pipeline)
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    from gpu_sdr_tpu_torch.engine.ingest import HostFeed
    from gpu_sdr_tpu_torch.engine.sinks import CallbackSink
    from gpu_sdr_tpu_torch.measure import ChannelSource
    from gpu_sdr_tpu_torch.params import AntMode
    params = files.retrieve_params_from_file(fn)
    (_, rx), = params.active_antennas(AntMode.RX)
    (_, tx), = params.active_antennas(AntMode.TX)
    demod = make_demodulator(rx, dev)
    L, nb = demod.plan.block_len, demod.plan.n_blocks
    skip = int(round(max(rx.delay - tx.delay, 0.0) * rx.rate))

    def source():
        return ChannelSource(make_generator(tx, L, dev), IdealChannel(),
                             skip_samples=skip)

    def fed():
        for _x, _errs in HostFeed(source(), dev).device_blocks(L, nb):
            pass
        torch.cuda.synchronize(dev)

    stages = {"source": lambda: sum(1 for _ in source().blocks(L, nb)),
              "source + HostFeed": fed,
              "run_pipeline": lambda: run_pipeline(
                  demod, source(), [CallbackSink(lambda m, d: None)])}
    for f in stages.values():
        f()
    took = {}
    for name, f in stages.items():
        t0 = time.perf_counter()
        f()
        took[name] = time.perf_counter() - t0
    print(f"get_VNA's host-fed VNA in this process, {nb} blocks of {L}: "
          + ", ".join(f"{k} {v:.3f} s ({nb * L / v / 1e6:.1f} Msps)"
                      for k, v in took.items()) + f" [{card}]", flush=True)
    return took


def wf_live(wf):
    """The live view for a few seconds: its /stream read to the end
    event, every packet's magnitudes at the tones' level; the server
    ends with its acquisition."""
    import http.client
    import re
    proc, report = wf.run("scripts.live_demo.live_server", "--port", "0",
                          "--time", WF_LIVE_T, "--device", "cuda",
                          name="live_server", popen=True)
    t0 = time.perf_counter()
    try:
        line = proc.stdout.readline()
        m = re.search(r"localhost:(\d+)/", line)
        check(m is not None, f"live_server: {line!r} "
              f"{proc.stderr.read() if proc.poll() is not None else ''}")
        c = http.client.HTTPConnection("127.0.0.1", int(m.group(1)),
                                       timeout=WF_WAIT_S)
        c.request("GET", "/stream")
        r = c.getresponse()
        buf = b""
        while b"event: end" not in buf:
            chunk = r.read1(65536)
            check(bool(chunk), "live_server: stream closed before its end")
            buf += chunk
        rc = proc.wait(timeout=WF_WAIT_S)
        check(rc == 0, f"live_server exited {rc}: {proc.stderr.read()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    secs = time.perf_counter() - t0
    events = [json.loads(b[6:]) for b in buf.decode().split("\n\n")
              if b.startswith("data: ")]
    n = int(float(WF_LIVE_T))
    check([e["packet"] for e in events] == list(range(n)),
          f"live_server: packets {[e['packet'] for e in events]}")
    mags = np.array([e["mags"] for e in events])
    check(np.all(np.abs(mags - 0.5) <= 0.01),
          f"live_server: magnitudes {mags}")
    wf.account("live_server", report, secs)
    print(f"live_server: {len(events)} packets streamed, magnitudes "
          f"{mags.min():.5f}..{mags.max():.5f}")


def phase_workflows(dev):
    """Phase 22: the measurement workflows users run, each a script of
    gpu_sdr_tpu_torch/scripts or tools run as a subprocess on the card
    (--device cuda, --backend html: the card's host has no matplotlib)
    in a temporary folder, every file read through client/h5.py, every
    run's dispatch its plan and its kernels' launches its blocks (the
    scripts' run reports); the kernels each ran held against their
    plain versions at the runs' shapes.  Returns (launches, {kernel:
    max |err| at those shapes})."""
    import shutil
    import tempfile
    from gpu_sdr_tpu_torch.client import files, h5
    card = card_name()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wf_")
    wf, errs = Workflows(tmp, card), {}
    dv, html = ("--device", "cuda"), ("--device", "cuda", "--backend",
                                      "html")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"files in {tmp}: {disk_of(os.path.realpath(tmp))}, "
              f"{free / 1e9:.1f} GB free")
        check(free >= WF_FREE_BYTES, f"{free} bytes free in {tmp}")

        # the stress test at its defaults: 1000 channels, 100 Msps, 1 s
        out, _s, rep = wf.run("scripts.network_test", *dv)
        check("1000 channels @ 100 Msps" in out and
              "Msps sustained" in out, f"network_test: {out}")
        check(rep["runs"][0]["dispatch"][0][1:] == ["fused_loopback",
                                                    "generic_scan"],
              f"network_test: {rep['runs'][0]['dispatch']}")
        wf_held_presum(dev, errs)

        # the quick start: the VNA at its defaults but 1 s, analysed
        out, _s, _r = wf.run("scripts.get_VNA", "--folder", tmp, "--rate",
                             "100", "--f0", "-45", "--f1", "45", "--points",
                             "50000", "--time", "1", *html)
        check("Measuring line delay" in out and "VNA data written" in out,
              f"get_VNA: {out}")
        vna = wf_file(tmp, "USRP_VNA_*.h5")
        delay_fn = wf_file(tmp, "USRP_Delay_*.h5")
        with h5.File(delay_fn, "r") as f:
            check("100" in f["delay_info"].attrs, "no delay_info for 100")
        out, _s, _r = wf.run("scripts.analyze_VNA", "--folder", tmp, *html)
        check("analyzed" in out and "USRP_VNA.html" in out,
              f"analyze_VNA: {out}")
        fq, s21 = files.get_VNA_data(vna, calibrated=False)
        check(len(fq) == 50_000 and np.all(np.diff(fq) > 0),
              f"get_VNA: {len(fq)} points")
        dev_s21 = wf_flat("get_VNA", s21, 1.0)
        wf_held(dev, errs, delay_fn, "get_VNA's line delay", fused=True)
        wf_held(dev, errs, vna, "get_VNA")
        wf_split_host_fed(dev, vna, card)

        # noise at config 3's width, analysed on the card
        out, _s, _r = wf.run("scripts.get_noise", "--folder", tmp, "--rate",
                             "100", "--tones", *WF_NOISE_TONES,
                             "--decimation", "100", "--time", WF_NOISE_T,
                             *dv)
        nfn = wf_file(tmp, "USRP_Noise_*.h5")
        data = files.openH5file(nfn)
        check(data.shape == (100, int(float(WF_NOISE_T) * 1e6)),
              f"get_noise: {data.shape}")
        wf_direct("get_noise", data, 0.01)
        noise_prof = os.path.join(tmp, "noise_prof")
        os.makedirs(noise_prof)
        shutil.copy(nfn, noise_prof)
        out, _s, _r = wf.run("scripts.analyze_noise", "--folder", tmp,
                             *html)
        ninfo, nfreq, real, imag = files.get_noise(nfn)
        check(ninfo["n_chan"] == 100 and len(real) == len(imag) == 100 and
              all(np.isfinite(x).all() for x in real + imag),
              f"analyze_noise: {ninfo}")
        wf_held(dev, errs, nfn, "get_noise", fused=True)
        # where analyze_noise's time goes, on a copy of the same file
        wf_profile(wf, "scripts.analyze_noise", "--folder", noise_prof,
                   *html, name="analyze_noise", says="plot written",
                   keys=("calculate_noise", "openH5file", "batched_welch",
                         "plot_noise_spec", "get_noise", "write_html"))

        # the full spectrum at 1000 channels
        out, _s, _r = wf.run("scripts.get_noise_full", "--folder", tmp,
                             "--rate", "100", "--channels", "1000",
                             "--time", WF_FULL_T, *dv)
        pfn = wf_file(tmp, "USRP_PFB_*.h5")
        z = files.openH5file(pfn)
        check(z.size == int(float(WF_FULL_T) * 1e8) and
              np.isfinite(z).all(), f"get_noise_full: {z.shape}")
        wf_held(dev, errs, pfn, "get_noise_full")

        # two front ends
        dual = os.path.join(tmp, "dual")
        out, _s, rep = wf.run("scripts.get_dual_VNA", "--folder", dual,
                              "--rate", "100", *dv)
        dfn = wf_file(dual, "USRP_VNA_*.h5")
        with h5.File(dfn, "r") as f:
            check("A_RX2" in f["raw_data0"] and "B_RX2" in f["raw_data0"]
                  and len(f["VNA_0"]["frequency"]) == 100_000,
                  "get_dual_VNA: the file's groups")
        fq, s21 = files.get_VNA_data(dfn, calibrated=False)
        wf_flat("get_dual_VNA", s21, 1.0)
        for fe in "AB":
            wf_held(dev, errs, dfn, f"get_dual_VNA {fe}", fused=True,
                    run=rep["runs"][0], front_end=fe)
        out, _s, _r = wf.run("scripts.get_dual_noise", "--folder", dual,
                             "--time", WF_DUAL_NOISE_T, *dv)
        dn = wf_file(dual, "USRP_Noise_*.h5")
        for fe in ("A_RX2", "B_RX2"):
            d = files.openH5file(dn, front_end=fe)
            check(d.shape == (1, int(float(WF_DUAL_NOISE_T) * 1e6)),
                  f"get_dual_noise {fe}: {d.shape}")
            wf_direct(f"get_dual_noise {fe}", d, 1.0)

        # a stitched VNA over two segments
        big = os.path.join(tmp, "big")
        out, _s, rep = wf.run("scripts.large_VNA", "--folder", big,
                              "--start", "200", "--stop", "350",
                              "--points_per_segment", "20000", "--time",
                              "0.2", "--out", "bigvna", *dv)
        check(len(rep["runs"]) == 2 and "stitched VNA" in out,
              f"large_VNA: {out}")
        with h5.File(os.path.join(big, "bigvna.h5"), "r") as f:
            g = f["VNA_0"]
            fq, s21 = np.asarray(g["frequency"]), np.asarray(g["S21"])
            check(int(g.attrs["segments"]) == 2 and
                  list(g.attrs["calibration"]) == [1.0],
                  "large_VNA: the stitched group's attributes")
        check(fq.min() >= 200e6 and fq.max() <= 350e6 and
              np.all(np.diff(fq) >= 0), "large_VNA: the frequency axis")
        wf_flat("large_VNA", s21, float(np.abs(s21).mean()))
        for seg, run in enumerate(rep["runs"]):
            wf_held(dev, errs, os.path.join(big, f"bigvna_seg{seg}.h5"),
                    f"large_VNA segment {seg}", fused=True, run=run)

        # the beam map on a 3 x 3 grid
        beam = os.path.join(tmp, "beam")
        out, _s, _r = wf.run("scripts.beam_mapper.beam_mapper", "--folder",
                             beam, "--nx", "3", "--ny", "3", *dv,
                             name="beam_mapper")
        with h5.File(os.path.join(beam, "beam_map.h5"), "r") as f:
            pos = np.asarray(f["beam_map"]["positions"])
            resp = np.asarray(f["beam_map"]["responses"])
        check(pos.shape == (9, 2) and resp.shape == (9, 1),
              f"beam_mapper: {pos.shape} {resp.shape}")
        wf_flat("beam_mapper", resp, 1.0)
        wf_held(dev, errs, os.path.join(beam, "map_0000.h5"),
                "beam_mapper")

        # the live view
        wf_live(wf)

        # the 50-resonator array: VNA -> fit -> noise, then fit_VNA on
        # its VNA (the ideal loopback has no resonator to fit)
        arr = os.path.join(tmp, "array")
        os.makedirs(arr)
        out, _s, rep = wf.run("tools.array_loop", "--folder", arr,
                              "--device", "cuda")
        res = json.loads(out.strip().splitlines()[-1])
        check(res["failed_checks"] == [],
              f"array_loop: {res['failed_checks']}")
        print(f"array_loop: {res['peak_count_estimated']} peaks estimated,"
              f" {res['peaks_initialized']} initialized, "
              f"{res['n_fitted']} fitted; f0 error median "
              f"{res['f0_err_hz']['median']:.1f} Hz, p90 "
              f"{res['f0_err_hz']['p90']:.1f}, max "
              f"{res['f0_err_hz']['max']:.1f}; Qr error median "
              f"{res['qr_rel_err']['median']:.4f}; "
              f"{res['channels_in_dip_fraction']:.2f} of the channels in "
              f"the dip; steps {res['seconds']} s [{card}]")
        av = os.path.join(arr, "vna_array.h5")
        wf_held(dev, errs, os.path.join(arr, "noise_array.h5"),
                "array_loop noise")
        shutil.copy(av, os.path.join(arr, "vna_refit.h5"))
        out, _s, _r = wf.run("scripts.fit_VNA", "--folder", arr, "--file",
                             "vna_refit.h5", "--peaks", "50",
                             "--peak_width", "30e3", "--Qr_cutoff", "3",
                             "--fit_range", "40e3", *html)
        check("initialize_peaks: ok" in out and "reso_49:" in out and
              "USRP_resonators.html" in out, f"fit_VNA: {out[-800:]}")

        # long-stream phase coherence, both modes
        coherence = {}
        for mode, kernel in (("chain", "chain"), ("replay", "replay_ddc_t")):
            out, secs, _r = wf.run(
                "tools.phase_coherence", "--mode", mode, "--gsamples",
                str(WF_COHERENCE_GSAMPLES), "--device", "cuda",
                name=f"phase_coherence_{mode}")
            c = json.loads(out.strip().splitlines()[-1])
            snr = c["last_vs_first_snr_db"]
            check(c["launches"] == c["blocks"] and c["kernel"] == kernel,
                  f"phase_coherence {mode}: {c['launches']} launches of "
                  f"{c['kernel']}, {c['blocks']} blocks")
            check(snr == "inf" or snr >= SNR_BAR_DB,
                  f"phase_coherence {mode}: last vs first {snr} dB")
            amp = 1.0 / (16 if mode == "chain" else 8)
            check(max(c["amp_err"]) <= WF_LEVEL * amp and
                  max(c["phase_err_rad"]) <= WF_LEVEL,
                  f"phase_coherence {mode}: amplitude errors "
                  f"{max(c['amp_err'])}, phase {max(c['phase_err_rad'])}")
            print(f"phase_coherence {mode}: {c['streamed_gsamples']:.3f} "
                  f"Gsamples in {c['blocks']} blocks, {c['seconds']:.2f} s "
                  f"({c['msps']:.1f} Msps), {secs:.1f} s with start-up; "
                  f"block {c['blocks'] - 1} against block "
                  f"{c['compared_block']} (period {c['period_blocks']}): "
                  f"{snr} dB, bit for bit {c['bit_identical']}; worst "
                  f"amplitude error {max(c['amp_err']):.3e} of {amp}, "
                  f"phase {max(c['phase_err_rad']):.3e} rad; "
                  f"{c['launches']} launches of {kernel} [{card}]")
            coherence[mode] = c
        wf_held_chain(dev, errs)
        wf_held_replay_t(dev, errs)
        print(f"phase 22: {len(wf.rows)} script runs, launches "
              f"{wf.launches}, held against plain {errs}; the loopback "
              f"VNA's |S21| within {dev_s21:.2e} of the TX level [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return wf.launches, errs


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
        config5 = timed("dual, dispatch and checkpoint",
                        phase_dual_main_path, dev)
        deep = timed("deep-FIR kernels", phase_deep_fir_kernels, dev)
        deep_launches = timed("deep-FIR main path", phase_deep_fir_main_path,
                              dev)
        rows.update(timed("new kernels", phase_new_kernels, dev))
        launches.update(timed("new kernels' entry points",
                              phase_new_main_path, dev))
        io_launches = timed("HDF5, mixed, channel, socket and NODSP",
                            phase_io_main_path, dev)
        analysis_launches, analysis_errs = timed(
            "the science loop", phase_science_loop, dev)
        server_launches, server_errs = timed(
            "the server on the card", phase_server, dev)
        mp_launches = timed("the sharded layer across two processes",
                            phase_multiprocess, dev)
        wf_launches, wf_errs = timed("the measurement workflows",
                                     phase_workflows, dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    src = "gpu_sdr_tpu_torch/csrc/"
    kernels = [
        dict(name="channelizer", route="cuda", source=src + "channelizer.cu",
             replaces="gpu_sdr_tpu/ops/pallas_channelizer.py:390",
             launches=launches["channelizer"], config5_launches=config5,
             **rows["channelizer_const"],
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
    for k in kernels:           # the HDF5 / mixed / channel / socket runs
        if k["name"] in io_launches:
            k["io_launches"] = io_launches[k["name"]]
        if k["name"] in analysis_launches:      # the science loop's
            k["analysis_launches"] = analysis_launches[k["name"]]
            k["analysis_max_abs_err"] = analysis_errs[k["name"]]
        if k["name"] in server_launches:        # the server's runs
            k["server_launches"] = server_launches[k["name"]]
            k["server_max_abs_err"] = server_errs[k["name"]]
        if k["name"] in mp_launches:            # phase 21, rank 0's
            k["multiprocess_launches"] = mp_launches[k["name"]]
        if k["name"] in wf_launches:            # phase 22's scripts
            k["workflow_launches"] = wf_launches[k["name"]]
            k["workflow_max_abs_err"] = wf_errs.get(k["name"])
    check_line(kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
