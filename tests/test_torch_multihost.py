"""The port's sharded layer across processes (gpu_sdr_tpu_torch/parallel/
rehearsal.py, the counterpart of tools/multihost_rehearsal.py): N ranks
of `python -m gpu_sdr_tpu_torch.parallel.rehearsal` on torch.distributed
over gloo, 4 virtual CPU shards each, mirroring tests/test_multihost.py:
2 processes on a 2x4 mesh, 4 processes on 4x4 and 2x8 (a time row over
two ranks: the psum and the channel gather cross processes).  Every
phase of the JAX rehearsal and the dry run's sub-paths run on every
rank, and each rank's gathered outputs are held against

(a) the port's one-process mesh of the same shape, bit for bit (a
    gathered stream is copies of the same shards' outputs);
(b) gpu_sdr_tpu.golden's float64 oracles at the JAX rehearsal's bars:
    >= 95 dB for phase 1, >= 90 dB elsewhere (85 dB for the channelizer
    replay, the dry run's), config 5's ptp < 1e-2 and |pd| < 1e-3;
(c) the JAX package's one-process sharded run of the same chain on the
    8 virtual CPU devices, at the bars of tests/test_torch_fused_sharded
    .py and test_torch_sharded_replay.py (90 dB).

The per-host ingest's abort: one rank's producer gone after 1.5 blocks
ends every rank short with the same shortfall_blocks.  Every spawned
process gets 2 OpenMP / MKL threads and a free port on 127.0.0.1; every
wait has a deadline of at most 180 s, and the ranks are killed at it.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu_torch.parallel import rehearsal as R

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 180.0
THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
           "OPENBLAS_NUM_THREADS": "2"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, mesh, per, out, extra=(), env_extra=None):
    """Start n ranks of the rehearsal, each with `per` CPU shards; wait
    for all (one deadline of WAIT_S, every rank killed at it); return
    each rank's reports and outputs."""
    port = free_port()
    env = dict(os.environ, **THREADS, **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gpu_sdr_tpu_torch.parallel.rehearsal",
         "--init", f"tcp://127.0.0.1:{port}", "--world", str(n),
         "--rank", str(r), "--mesh", mesh, "--devices", f"cpu*{per}",
         "--backend", "gloo", "--timeout", "60", "--out", str(out),
         *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    deadline = time.monotonic() + WAIT_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    reports = [json.load(open(out / f"rank{r}.json")) for r in range(n)]
    outputs = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return reports, outputs


@functools.lru_cache(maxsize=None)
def one_process(shape):
    """The same phases on the port's one-process mesh of `shape`."""
    reports, outputs = R.run(["cpu"] * int(np.prod(shape)), shape)
    assert all(r["ok"] for r in reports), reports
    return outputs


def bit_identical(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and
            np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def masked_snr(ref, got):
    """SNR over the reference's finite rows (NaN rows are transient)."""
    m = np.isfinite(ref)
    return golden.snr_db(ref[m], got[m])


# -- (b) the float64 oracles -------------------------------------------
def golden_snrs(out, T, n_dev):
    """Each phase's SNR against gpu_sdr_tpu.golden, and its bar."""
    rate = R.RATE
    snr = {}
    x = golden.tone_block(R.FREQS8, R.AMPLS8, rate, 0, R.N1 * R.L1)
    ref = golden.GoldenDirectDemodulator(R.FREQS8, rate, R.DECIM, R.PFA)(x).T
    snr["fused_direct"] = (golden.snr_db(ref, out["fused_direct"]), 95.0)
    snr["g_chain"] = (golden.snr_db(ref, out["g_chain"]), 90.0)
    # phase 3: the PFB with the zero-primed halo's transient masked
    Lp, xs = R.pfb_small(T)
    ft, skip = Lp // R.PFB_NFFT, R.PFB_AVG - 1
    frames = golden.pfb_frames(np.concatenate(xs), R.PFB_NFFT, R.PFB_AVG)
    sel = golden.tone_select(frames, list(R.PFB_BINS))
    rows = np.full((2 * ft, len(R.PFB_BINS)), np.nan + 0j)
    rows[skip:] = sel[:2 * ft - skip]
    snr["tones"] = (masked_snr(rows, out["tones"]), 90.0)
    mark = np.full((2 * ft, R.PFB_NFFT), np.nan + 0j)
    mark[skip:] = frames[:2 * ft - skip]
    avg = mark.reshape(-1, R.PFB_DEC, R.PFB_NFFT).mean(axis=1)
    snr["noise_decim"] = (masked_snr(avg, out["noise_decim"]), 90.0)
    cfg, xc = R.chirp_small()
    cp = golden.ChirpParameter(-300_000, 300_000, rate, 1000, 0.1)
    z = golden.chirp_demod(cp, 0, np.concatenate(xc))
    snr["chirp"] = (golden.snr_db(golden.GoldenVNADecimator(cp.length)(z),
                                  out["chirp"]), 90.0)
    # phase 4: the mixed receiver's block from its rows
    B = out["mixed_direct"].shape[0] * 100 // 2
    _rx, ccfg = R.mixed_small()
    xm = R.mixed_input(ccfg, B)
    refd = golden.GoldenDirectDemodulator(R.MIXED_FREQS, rate, 100,
                                          R.PFA)(xm).T
    refc = golden.GoldenVNADecimator(cp.length * 100)(
        golden.chirp_demod(cp, 0, xm))[:, None]
    snr["mixed_direct"] = (golden.snr_db(refd, out["mixed_direct"]), 90.0)
    snr["mixed_chirp"] = (golden.snr_db(refc, out["mixed_chirp"]), 90.0)
    # phases 5 and 6
    _rx, rec = R.replay_small()
    ref = golden.GoldenDirectDemodulator(R.FREQS8, rate, 100, R.PFA)(rec).T
    assert out["replay"].shape == ref.shape
    snr["replay"] = (golden.snr_db(ref, out["replay"]), 90.0)
    rec = golden.tone_block(R.FREQS8, R.AMPLS8, rate, 0, 300_000)
    ref = golden.GoldenDirectDemodulator(R.FREQS8, rate, 100, R.PFA)(rec).T
    assert out["ingest"].shape == ref.shape
    snr["ingest"] = (golden.snr_db(ref, out["ingest"]), 90.0)
    # the dry run's sub-paths
    _rx, rec = R.seg_small()
    ref = golden.GoldenDirectDemodulator(R.FREQS8, rate, R.DECIM,
                                         R.PFA)(rec).T
    snr["segmented"] = (golden.snr_db(ref, out["segmented"]), 90.0)
    _rx, rec = R.chan_replay_small(n_dev)
    ref = golden.pfb_frames(np.concatenate([rec, rec]).astype(np.complex128),
                            1000, 4)
    got = out["channelizer_replay"][3:]
    n = min(len(ref), len(got))
    snr["channelizer_replay"] = (golden.snr_db(ref[:n], got[:n]), 85.0)
    L = R.time_mesh_len(n_dev)
    x = golden.tone_block(R.CHAN_FREQS, R.CHAN_AMPLS, rate, 0, 4 * L)
    ref = golden.pfb_frames(x, 1000, 4)[
        :, golden.tone_bins(R.CHAN_FREQS, rate, 1000)]
    got = out["channelizer_loopback"][3:]
    n = min(len(ref), len(got))
    snr["channelizer_loopback"] = (golden.snr_db(ref[:n], got[:n]), 90.0)
    _rx, rec = R.replay_kernel_small(n_dev)
    ref = golden.GoldenDirectDemodulator(R.FREQS8, rate, R.DECIM, R.PFA)(
        np.concatenate([rec, rec])).T
    snr["replay_kernel"] = (golden.snr_db(ref, out["replay_kernel"]), 90.0)
    return snr


def unsharded_chirp_table(n_dev):
    """The dry run's reference of the sharded chirp table: the port's
    unsharded fused chain of the same pair."""
    from gpu_sdr_tpu_torch.engine.fused import FusedLoopback
    from gpu_sdr_tpu_torch.engine.sinks import MemorySink
    tx, rx = R.chirp_table_small(n_dev)
    s = MemorySink()
    FusedLoopback(tx, rx, device="cpu").run([s])
    return s.data


# -- (c) JAX's one-process sharded runs ---------------------------------
@functools.lru_cache(maxsize=None)
def jax_runs(T):
    """JAX's sharded chains on a (T, 8 / T) mesh of its 8 virtual CPU
    devices, on the inputs of the rehearsal's phases 1, 3, 4 and 5."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    from gpu_sdr_tpu.engine import make_demodulator
    from gpu_sdr_tpu.engine.sinks import MemorySink
    from gpu_sdr_tpu.ops import cplx
    from gpu_sdr_tpu.ops import pfb as pfb_ops
    from gpu_sdr_tpu.ops.chirp import ChirpConfig
    from gpu_sdr_tpu.parallel import make_mesh
    from gpu_sdr_tpu.parallel.fused_sharded import ShardedFusedDirect
    from gpu_sdr_tpu.parallel.sharded_chirp import ShardedChirpLockin
    from gpu_sdr_tpu.parallel.sharded_pfb import ShardedPFB
    from gpu_sdr_tpu.parallel.sharded_replay import ShardedDeviceReplay
    mesh = make_mesh((T, 8 // T), ("time", "channels"))
    out = {}
    tx, rx = R.direct_pair(P=jparams)
    sf = ShardedFusedDirect(tx, rx, mesh, blocks_per_exec=2,
                            block_len=R.L1)
    st, ys = sf.init_state(), []
    for _ in range(R.N1 // 2):
        st, y = sf.run_exec(st)
        y = cplx.to_np(y)
        ys.append(y.reshape(-1, y.shape[-1]))
    out["fused_direct"] = np.concatenate(ys)
    Lp, xs = R.pfb_small(T)
    pcfg = pfb_ops.PFBConfig(nfft=R.PFB_NFFT, avg=R.PFB_AVG, rate=R.RATE)
    for name, sp, dec in (
            ("tones", ShardedPFB(pcfg, mesh, Lp, bins=R.PFB_BINS), 0),
            ("noise_decim", ShardedPFB(pcfg, mesh, Lp), R.PFB_DEC)):
        carry, ys = sp.init_state(), []
        for b in xs:
            carry, y = sp.step(carry, sp.shard_input(b))
            if dec:
                y = pfb_ops.average_frames(y, dec)
            ys.append(cplx.to_np(y))
        out[name] = np.concatenate(ys)
    _cfg, xc = R.chirp_small()
    ccfg = ChirpConfig.from_params(-300_000, 300_000, R.RATE, 1000, 0.1)
    sc = ShardedChirpLockin(ccfg, mesh, R.CHIRP_LC, ccfg.length)
    last, ys = sc.init_state(), []
    for b in xc:
        last, y = sc.step(last, sc.shard_input(b))
        ys.append(cplx.to_np(y))
    out["chirp"] = np.concatenate(ys)[:, None]     # the port's (rows, 1)
    rxm, _ = R.mixed_small(P=jparams)
    dm = make_demodulator(rxm, mesh=mesh)
    B = dm.plan.block_len
    _rx, tcfg = R.mixed_small()
    xm = R.mixed_input(tcfg, B)
    spec = NamedSharding(mesh, PartitionSpec("time"))
    st, od, oc = dm.init_state(), [], []
    for b in range(2):
        blk = xm[b * B:(b + 1) * B]
        xb = cplx.C(jax.device_put(blk.real.astype(np.float32), spec),
                    jax.device_put(blk.imag.astype(np.float32), spec))
        st, (yd, yc) = dm.step(st, xb)
        od.append(cplx.to_np(yd))
        oc.append(cplx.to_np(yc))
    out["mixed_direct"] = np.concatenate(od)
    out["mixed_chirp"] = np.concatenate(oc)
    rxr, rec = R.replay_small(P=jparams)
    s = MemorySink()
    ShardedDeviceReplay(rxr, rec, mesh, loop=False).run([s])
    out["replay"] = s.data
    return out


def check_rehearsal(reports, outputs, shape):
    T, Kc = shape
    n_dev = T * Kc
    # every rank ran every phase and passed its own checks
    for rank_reports in reports:
        assert [r["phase"] for r in rank_reports] == list(R.SMALL)
        assert all(r["ok"] for r in rank_reports), rank_reports
    abort = [{k: v for k, v in r.items() if k.startswith("ingest_abort")}
             for rr in reports for r in rr if r["phase"] == "ingest"]
    assert all(a["ingest_abort_shortfall"] == 2 and
               a["ingest_abort_aborted"] for a in abort), abort
    # (a) bit for bit the one-process mesh, on every rank; the abort run's
    # padded tail is another process's in one process, so its first block
    ref = one_process(tuple(shape))
    rows = ref["ingest"].shape[0] // 3
    for r, out in enumerate(outputs):
        assert sorted(out) == sorted(ref), (r, sorted(out))
        for k in ref:
            a, b = ref[k], out[k]
            if k == "ingest_abort":
                a, b = a[:rows], b[:rows]
            assert bit_identical(a, b), (r, k)
    out = outputs[0]
    # (b) the float64 oracles
    for k, (snr, bar) in golden_snrs(out, T, n_dev).items():
        assert snr >= bar, f"{k}: {snr:.1f} dB against float64"
    assert golden.snr_db(unsharded_chirp_table(n_dev),
                         out["chirp_table"]) >= 95.0
    al = R.config5_alignment(out["config5_A_RX2"], out["config5_B_RX2"])
    assert al["config5_ptp"] < 1e-2 and al["config5_pd"] < 1e-3, al
    # (c) JAX's one-process sharded run
    for k, theirs in jax_runs(T).items():
        assert theirs.shape == out[k].shape, (k, theirs.shape)
        snr = golden.snr_db(theirs.astype(np.complex128), out[k])
        assert snr > 90.0, f"{k}: {snr:.1f} dB against JAX"


def test_two_process_rehearsal(tmp_path):
    """2 processes x 4 CPU shards on a 2x4 mesh: one time row a rank."""
    reports, outputs = run_ranks(2, "2x4", 4, tmp_path)
    check_rehearsal(reports, outputs, (2, 4))


@pytest.mark.parametrize("mesh", ["4x4", "2x8"])
def test_four_process_rehearsal(tmp_path, mesh):
    """4 processes x 4 CPU shards: 4x4 (a time row a rank) and 2x8 (a
    time row over two ranks: the halo ring's hops, the psum's all_reduce
    and the channel gather cross processes)."""
    reports, outputs = run_ranks(4, mesh, 4, tmp_path)
    check_rehearsal(reports, outputs, tuple(int(v) for v in
                                            mesh.split("x")))


def test_one_host_abort_ends_every_rank_short(tmp_path):
    """Rank 0's producer gone after 1.5 blocks of 4: both ranks deliver
    the same two blocks and end with the same shortfall; the first block
    is the one-process mesh's, bit for bit."""
    reports, outputs = run_ranks(2, "2x4", 4, tmp_path,
                                 ("--phases", "ingest", "--abort_rank", "0"))
    reps = [rr[0] for rr in reports]
    assert [r["ingest_abort_shortfall"] for r in reps] == [2, 2]
    assert all(r["ingest_abort_aborted"] and r["ingest_abort_blocks"] == 2
               for r in reps)
    assert not any(r["ingest_aborted"] for r in reps)
    # the padded tail is stamped on the rank that padded it, on block 1
    assert reps[0]["ingest_abort_errors"] == [0, reps[0][
        "ingest_abort_local_len"] // 2]
    assert reps[1]["ingest_abort_errors"] == [0, 0]
    assert bit_identical(outputs[0]["ingest_abort"],
                         outputs[1]["ingest_abort"])
    rows = outputs[0]["ingest"].shape[0] // 3
    assert bit_identical(outputs[0]["ingest_abort"][:rows],
                         one_process((2, 4))["ingest_abort"][:rows])
