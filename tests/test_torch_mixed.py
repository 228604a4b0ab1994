"""Mixed wave types on one antenna, and NODSP, through the port against
the JAX package: the four cases of tests/test_mixed_modes.py (the groups
and their common block, demodulation against both float64 oracles, the
file layout with `data` and `mixed_1`, a mesh against one device), each
also held against JAX at >= 90 dB SNR (tests/test_ops_pfb_chirp.py:
50-51) and against the oracles at that file's own 80 dB; meshes (2, 1)
and (2, 4).  NODSP passes the stream through bit for bit, as in JAX.
The JAX side runs its Pallas kernels in interpret mode
(GPU_SDR_TPU_PALLAS=1).
"""

import dataclasses

import h5py
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.client import files as jfiles
from gpu_sdr_tpu.engine import make_demodulator as jmake_demod
from gpu_sdr_tpu.engine.pipeline import \
    run_pipeline_mixed as jrun_pipeline_mixed
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.engine.sources import ArraySource as JArraySource
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.client import files as tfiles
from gpu_sdr_tpu_torch.engine import make_demodulator
from gpu_sdr_tpu_torch.engine.demodulator import MixedDemodulator
from gpu_sdr_tpu_torch.engine.pipeline import run_pipeline_mixed
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource
from gpu_sdr_tpu_torch.parallel import make_mesh
from test_torch_files import assert_same_file

torch.set_num_threads(2)

RATE = 1_000_000
F_TONES = [100_000, -200_000]
CHIRP = dict(f0=-300_000, f1=300_000, steps=1000, chirp_t=0.1)
SNR_JAX_DB = 90.0
SNR_ORACLE_DB = 80.0          # tests/test_mixed_modes.py's bar


def mixed_rx(P, samples=400_000):
    W = P.WaveType
    return P.AntennaParams(
        mode=P.AntMode.RX, rate=RATE, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4, freq=F_TONES + [CHIRP["f0"]],
        wave_type=[W.DIRECT, W.DIRECT, W.CHIRP],
        chirp_f=[0, 0, CHIRP["f1"]], chirp_t=[0.0, 0.0, CHIRP["chirp_t"]],
        swipe_s=[0, 0, CHIRP["steps"]])


def stimulus(n):
    """Tone comb + full-scale chirp superimposed (test_mixed_modes)."""
    comb = golden.tone_block(F_TONES, [0.4, 0.25], RATE, 0, n)
    cp = golden.ChirpParameter(CHIRP["f0"], CHIRP["f1"], RATE,
                               CHIRP["steps"], CHIRP["chirp_t"])
    return (comb + golden.chirp_signal(cp, 0, n)).astype(np.complex64), cp


def oracles(x, cp):
    """(DIRECT group's (rows, 2), CHIRP group's (rows,)) in float64."""
    tones = golden.GoldenDirectDemodulator(F_TONES, RATE, 100, 4)(x).T
    vna = golden.GoldenVNADecimator(cp.length * 100)(
        golden.chirp_demod(cp, 0, x))
    return tones, vna


def geometry(plan):
    """A BlockPlan of either package as a tuple."""
    return dataclasses.astuple(plan)


def held(ref, got, bar, what):
    m = min(len(ref), len(got))
    snr = golden.snr_db(ref[:m], got[:m])
    assert snr > bar, f"{what}: {snr:.1f} dB"


def test_mixed_demodulator_groups_and_plan():
    d = make_demodulator(mixed_rx(tparams), "cpu")
    jd = jmake_demod(mixed_rx(jparams))
    assert isinstance(d, MixedDemodulator)
    assert [g.wave_type for g in d.groups] == [g.wave_type
                                               for g in jd.groups]
    assert [g.channel_idx for g in d.groups] == [(0, 1), (2,)]
    assert [g.params.to_json_dict() for g in d.groups] == \
        [g.params.to_json_dict() for g in jd.groups]
    assert geometry(d.plan) == geometry(jd.plan)
    assert [geometry(g.demod.plan) for g in d.groups] == \
        [geometry(g.demod.plan) for g in jd.groups]
    assert d.plan.block_len % (100 * 100) == 0
    assert d.n_channels == 3
    # with samples= as in JAX's make_demodulator
    assert geometry(make_demodulator(mixed_rx(tparams), "cpu",
                                     samples=1_000_000).plan) == \
        geometry(jmake_demod(mixed_rx(jparams), samples=1_000_000).plan)


def test_mixed_demodulation_matches_jax_and_golden_models(monkeypatch):
    """Each group against JAX's and against its float64 oracle; the
    shared block is read by both groups and written by neither."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    d = make_demodulator(mixed_rx(tparams), "cpu")
    n = d.plan.n_blocks * d.plan.block_len
    x, cp = stimulus(n)
    x_before = x.copy()
    sinks = [[MemorySink()], [MemorySink()]]
    res = run_pipeline_mixed(d, ArraySource(x), sinks)
    assert np.array_equal(x, x_before)
    assert res.n_blocks == d.plan.n_blocks and res.samples_in == n
    assert res.rows == sum(len(s[0].data) for s in sinks)
    jsinks = [[JMemorySink()], [JMemorySink()]]
    jrun_pipeline_mixed(jmake_demod(mixed_rx(jparams)), JArraySource(x),
                        jsinks)
    tones, vna = sinks[0][0].data, sinks[1][0].data
    assert tones.shape == jsinks[0][0].data.shape == (n // 100, 2)
    assert vna.shape == jsinks[1][0].data.shape
    held(jsinks[0][0].data, tones, SNR_JAX_DB, "DIRECT vs JAX")
    held(jsinks[1][0].data, vna, SNR_JAX_DB, "CHIRP vs JAX")
    ref_t, ref_c = oracles(x, cp)
    held(ref_t, tones, SNR_ORACLE_DB, "DIRECT vs float64")
    held(ref_c, vna[:, 0], SNR_ORACLE_DB, "CHIRP vs float64")
    # group 0 alone: the DIRECT-only host-fed demodulator, bit for bit
    solo = make_demodulator(d.groups[0].params, "cpu")
    only = MemorySink()
    from gpu_sdr_tpu_torch.engine import run_pipeline
    run_pipeline(solo, ArraySource(x), [only], n_blocks=d.plan.n_blocks)
    assert np.array_equal(only.data, tones)


def test_mixed_measurement_h5_layout(monkeypatch, tmp_path):
    """run_measurement writes `data` (group 0) and `mixed_1` (group 1)
    with wave_type / channel_index attributes, the same file as JAX's,
    readable through either package's openH5file and mixed_streams."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    d = make_demodulator(mixed_rx(tparams), "cpu")
    n = d.plan.n_blocks * d.plan.block_len
    x, cp = stimulus(n)
    fns = []
    for P, run, Src, kw in (
            (jparams, jmeasure.run_measurement, JArraySource, {}),
            (tparams, measure.run_measurement, ArraySource,
             dict(device="cpu"))):
        p = P.UsrpParams()
        p.A_RX2 = mixed_rx(P)
        (tmp_path / P.__name__).mkdir()
        fns.append(run(p, filename=str(tmp_path / P.__name__ / "mixed"),
                       source=Src(x), **kw))
        assert (jmeasure if P is jparams else measure).last_dispatch() == \
            (("A_RX2", "host_pipeline_mixed", None),)
    jfn, fn = fns
    assert_same_file(jfn, fn)
    for reader in (jfiles, tfiles):
        streams = reader.mixed_streams(fn)
        assert [s[0] for s in streams] == ["data", "mixed_1"]
        assert list(streams[1][1]["wave_type"]) in (["CHIRP"], [b"CHIRP"])
        assert list(streams[1][1]["channel_index"]) == [2]
        assert str(reader.mixed_streams(jfn)) == str(streams)
    tones = tfiles.openH5file(fn)
    assert tones.shape[0] == 2
    # the chirp sweeps through the tone frequencies, so a few rows carry
    # crossing leakage: judge the bulk by the median (test_mixed_modes)
    assert abs(np.median(np.abs(tones[0, 16:])) - 0.4) < 3e-3
    assert abs(np.median(np.abs(tones[1, 16:])) - 0.25) < 3e-3
    vna = jfiles.openH5file(fn, dataset="mixed_1")
    assert vna.shape[0] == 1
    held(oracles(x, cp)[1], vna[0], SNR_ORACLE_DB, "mixed_1 vs float64")
    with h5py.File(fn, "r") as f:
        g = f["raw_data0"]["A_RX2"]
        assert g["data"].attrs["samples"] == n // 100
        assert g["mixed_1"].attrs["samples"] == n // (cp.length * 100)


@pytest.mark.parametrize("shape", [(2, 1), (2, 4)])
def test_mixed_on_mesh_matches_single_device_and_jax(monkeypatch, shape):
    """Every group's sharded demodulator consumes the same time-sharded
    block; the outputs match the single-device mixed path and JAX's
    mesh, block by block, across the blocks' carries."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    mesh = make_mesh(shape, devices=["cpu"] * 8)
    dm = make_demodulator(mixed_rx(tparams), mesh=mesh)
    ds = make_demodulator(mixed_rx(tparams), "cpu")
    jdm = jmake_demod(mixed_rx(jparams),
                      mesh=jmake_mesh(shape, ("time", "channels")))
    assert isinstance(dm, MixedDemodulator) and dm.mesh is mesh
    assert dm.plan.block_len % (2 * 100 * 100) == 0
    assert geometry(dm.plan) == geometry(ds.plan) == geometry(jdm.plan)
    B = dm.plan.block_len
    x, _cp = stimulus(3 * B)
    sm, ss, sj = dm.init_state(), ds.init_state(), jdm.init_state()
    for b in range(3):
        blk = x[b * B:(b + 1) * B]
        sm, ym = dm.step(sm, torch.from_numpy(blk))
        ss, ys = ds.step(ss, torch.from_numpy(blk))
        sj, yj = jdm.step(sj, jcplx.from_np(blk))
        for g, (a, r, j) in enumerate(zip(ym, ys, yj)):
            a = a.gather("cpu").numpy()
            held(r.numpy(), a, SNR_JAX_DB, f"block {b} group {g} vs one "
                 "device")
            held(jcplx.to_np(j), a, SNR_JAX_DB, f"block {b} group {g} vs "
                 "JAX's mesh")


def test_mixed_run_measurement_on_mesh(monkeypatch):
    """run_measurement(mesh=...) takes the mixed host pipeline with the
    sharded groups, as JAX does, and gives the unsharded run's data."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    x, _cp = stimulus(400_000)
    out = []
    for mesh in (None, make_mesh((2, 1), devices=["cpu"] * 2)):
        p = tparams.UsrpParams()
        p.A_RX2 = mixed_rx(tparams)
        s = MemorySink()
        measure.run_measurement(p, source=ArraySource(x), extra_sinks=[s],
                                mesh=mesh, device="cpu")
        assert measure.last_dispatch() == (("A_RX2", "host_pipeline_mixed",
                                            None),)
        out.append(s.data)
    held(out[0], out[1], SNR_JAX_DB, "mesh vs one device")


def test_two_chirps_raise_as_in_jax():
    """A mixed antenna with two CHIRP channels: the reference does not
    demodulate more than one chirp, and neither package does."""
    def rx(P):
        p = mixed_rx(P)
        p.wave_type.append(P.WaveType.CHIRP)
        p.freq.append(-100_000)
        p.chirp_f.append(100_000)
        p.chirp_t.append(0.1)
        p.swipe_s.append(1000)
        return p
    for mk, kw in ((jmake_demod, {}), (make_demodulator,
                                       dict(device="cpu"))):
        with pytest.raises(NotImplementedError, match="matches reference"):
            mk(rx(jparams if mk is jmake_demod else tparams), **kw)


class Blocks:
    """A plain source (no recording to replay): the host pipeline."""

    def __init__(self, data):
        self.data_ = data

    def blocks(self, block_len, n_blocks):
        for i in range(n_blocks):
            yield self.data_[i * block_len:(i + 1) * block_len]


@pytest.mark.parametrize("feed", ["recording", "host"])
def test_nodsp_passes_the_stream_through(monkeypatch, tmp_path, feed):
    """NODSP: the raw stream, one channel, bit for bit the input and
    JAX's output, on the device replay's scan and the host pipeline, and
    the file's `data` holds it."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    x = (np.random.default_rng(4).standard_normal(200_000) * (1 + 1j)
         ).astype(np.complex64)
    out = []
    for P, run, Src, kw in (
            (jparams, jmeasure.run_measurement, JArraySource, {}),
            (tparams, measure.run_measurement, ArraySource,
             dict(device="cpu"))):
        p = P.UsrpParams()
        p.A_RX2 = P.AntennaParams(mode=P.AntMode.RX, rate=RATE,
                                  buffer_len=50_000, samples=200_000,
                                  wave_type=[P.WaveType.NODSP])
        s = JMemorySink() if P is jparams else MemorySink()
        (tmp_path / P.__name__).mkdir()
        fn = run(p, source=Src(x) if feed == "recording" else Blocks(x),
                 extra_sinks=[s],
                 filename=str(tmp_path / P.__name__ / "raw"), **kw)
        out.append((s.data, fn,
                    (jmeasure if P is jparams else measure).last_dispatch()))
    (jdata, jfn, jdisp), (data, fn, disp) = out
    assert disp == jdisp == ((("A_RX2", "device_replay", "scan"),)
                             if feed == "recording" else
                             (("A_RX2", "host_pipeline", None),))
    assert data.shape == (200_000, 1) and data.dtype == np.complex64
    assert np.array_equal(data[:, 0], x)
    assert np.array_equal(data, jdata)
    assert np.array_equal(tfiles.openH5file(fn), x[None])
    assert_same_file(jfn, fn)
