"""The port's sharded fused chains (gpu_sdr_tpu_torch/parallel/
fused_sharded.py) against the JAX package's (gpu_sdr_tpu/parallel/
fused_sharded.py) and the float64 oracles, on the mesh shapes the JAX
tests use: every sub-path (``channelizer_wavetable``, ``pfb_scan`` with
a constant and a synthesised comb, ``chirp_table``, ``chirp_lockin``,
``fold_kernel``, ``g_chain``), the ``run_measurement(mesh=...)`` dispatch
with its path and sub-path, and each chain's state carried from JAX in
mid-stream.  The JAX side runs its kernels in interpret mode
(GPU_SDR_TPU_PALLAS=1) where its gates need them.

Bars: 90 dB SNR against JAX and the golden PFB / DIRECT streams (the JAX
tests': 90 dB PFB, 95 dB DIRECT, 100 dB chirp), the VNA's lock-in points
within 1e-4 of the amplitude (tests/test_fused_sharded.py:206).
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu.parallel import fused_sharded as jfs
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import convert, measure
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.parallel import Sharded, make_mesh
from gpu_sdr_tpu_torch.parallel import fused_sharded as fs

torch.set_num_threads(2)


def meshes(shape):
    return (jmake_mesh(shape, ("time", "channels")),
            make_mesh(shape, ("time", "channels"), devices=["cpu"] * 8))


def tones_pair(rate, freqs, ampls, nfft, avg):
    kw = dict(rate=rate, buffer_len=rate, freq=list(freqs),
              wave_type=[WaveType.TONES] * len(freqs))
    return (AntennaParams(mode=AntMode.TX, ampl=list(ampls), **kw),
            AntennaParams(mode=AntMode.RX, fft_tones=nfft, pf_average=avg,
                          **kw))


def run_port(chain, n_blocks, state=None):
    st = chain.init_state() if state is None else state
    outs = []
    for _ in range(n_blocks):
        st, y = chain.step(st)
        assert isinstance(y, Sharded)
        outs.append(y.gather().numpy())
    return np.concatenate(outs), st


def run_jax(chain, n_exec, state=None):
    st = chain.init_state() if state is None else state
    outs = []
    for _ in range(n_exec):
        st, ys = chain.run_exec(st)
        y = jcplx.to_np(ys)
        outs.append(y.reshape(-1, y.shape[-1]))
    return np.concatenate(outs), st


def golden_selected(freqs, ampls, rate, nfft, avg, n):
    x = golden.tone_block(list(freqs), list(ampls), rate, 0, n)
    frames = golden.pfb_frames(x, nfft, avg)
    return frames[:, golden.tone_bins(list(freqs), rate, nfft)]


@pytest.mark.parametrize("freqs, shape, pallas, path", [
    ((3000, -7000, 15000), (8, 1), "1", "channelizer_wavetable"),
    ((3000, -7000, 15000), (4, 2), "1", "pfb_scan"),       # const comb
    ((3001, -7013), (4, 2), "0", "pfb_scan"),              # synthesised
    ((2000, -5000), (4, 1), "0", "channelizer_wavetable"),
], ids=lambda v: str(v))
def test_sharded_fused_loopback_matches_jax_and_golden(monkeypatch, freqs,
                                                       shape, pallas, path):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", pallas)
    rate, nfft, avg = 64_000, 64, 4
    ampls = tuple(0.5 for _ in freqs)
    tx, rx = tones_pair(rate, freqs, ampls, nfft, avg)
    L = shape[0] * nfft * 8
    jm, m = meshes(shape)
    jsf = jfs.ShardedFusedLoopback(tx, rx, jm, blocks_per_exec=2,
                                   block_len=L)
    sf = fs.ShardedFusedLoopback(tx, rx, m, block_len=L)
    assert sf.path == path
    if pallas == "1":
        assert jsf.path == path
    ours, _ = run_port(sf, 4)
    theirs, _ = run_jax(jsf, 2)
    assert ours.shape == theirs.shape == (4 * L // nfft, len(freqs))
    assert golden.snr_db(theirs, ours) > 90.0
    ref = golden_selected(freqs, ampls, rate, nfft, avg, 4 * L)
    skip = avg - 1                      # the zero-primed halo
    n = min(len(ref), len(ours) - skip)
    assert golden.snr_db(ref[:n], ours[skip:skip + n]) > 90.0


def vna_pair(L, samples, ampl=0.8):
    kw = dict(rate=1_000_000, buffer_len=L, samples=samples,
              freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
              swipe_s=[1000], wave_type=[WaveType.CHIRP])
    return (AntennaParams(mode=AntMode.TX, ampl=[ampl], **kw),
            AntennaParams(mode=AntMode.RX, decim=1, **kw))


@pytest.mark.parametrize("L, path", [(100_000, "chirp_table"),
                                     (120_000, "chirp_lockin")])
def test_sharded_fused_vna_matches_jax(monkeypatch, L, path):
    """chirp_table where one period (100,000 samples) is whole blocks,
    chirp_lockin where it is not; both ways the JAX chain's points."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    tx, rx = vna_pair(L, 4 * L)
    jm, m = meshes((4, 2))
    jsf = jfs.ShardedFusedVNA(tx, rx, jm, blocks_per_exec=2, block_len=L)
    sf = fs.ShardedFusedVNA(tx, rx, m, block_len=L)
    assert sf.path == path
    ours, st = run_port(sf, 4)
    theirs, _ = run_jax(jsf, 2)
    assert ours.shape == theirs.shape == (4 * L // 100, 1)
    assert golden.snr_db(theirs, ours) > 100.0
    np.testing.assert_allclose(np.abs(ours), 0.8, atol=1e-4)


def direct_pair(freqs, ampls, L, decim=10, pfa=4):
    kw = dict(rate=1_000_000, buffer_len=L, freq=list(freqs),
              wave_type=None)
    tx = AntennaParams(mode=AntMode.TX, ampl=list(ampls),
                       **{**kw, "wave_type": [WaveType.TONES] * len(freqs)})
    rx = AntennaParams(mode=AntMode.RX, decim=decim, pf_average=pfa,
                       **{**kw, "wave_type": [WaveType.DIRECT] * len(freqs)})
    return tx, rx


def golden_direct(freqs, ampls, L, n_blocks, decim=10, pfa=4):
    x = golden.tone_block(list(freqs), list(ampls), 1_000_000, 0,
                          n_blocks * L)
    g = golden.GoldenDirectDemodulator(list(freqs), 1_000_000, decim, pfa)
    return np.concatenate([g(x[i * L:(i + 1) * L]) for i in range(n_blocks)],
                          axis=1).T


@pytest.mark.parametrize("use_fold, shape", [(True, (2, 4)), (True, (8, 1)),
                                             (False, (2, 2)),
                                             (False, (4, 1))],
                         ids=lambda v: str(v))
def test_sharded_fused_direct_matches_jax_and_golden(use_fold, shape):
    freqs = (12_345, -67_891, 300_001, -111_111)
    ampls = (0.4, 0.3, 0.2, 0.1)
    L = 80_000
    tx, rx = direct_pair(freqs, ampls, L)
    jm, m = meshes(shape)
    jsf = jfs.ShardedFusedDirect(tx, rx, jm, blocks_per_exec=2, block_len=L,
                                 use_fold=use_fold)
    sf = fs.ShardedFusedDirect(tx, rx, m, block_len=L, use_fold=use_fold)
    assert jsf.ok and sf.ok and sf.path == jsf.path == \
        ("fold_kernel" if use_fold else "g_chain")
    ours, st = run_port(sf, 4)
    theirs, jst = run_jax(jsf, 2)
    assert ours.shape == theirs.shape == (4 * L // 10, len(freqs))
    assert golden.snr_db(theirs, ours) > 90.0
    assert golden.snr_db(golden_direct(freqs, ampls, L, 4), ours) > 95.0
    assert np.array_equal(st[0].numpy(), np.asarray(jst[0]))
    assert np.array_equal(st[1].numpy(), np.asarray(jst[1]))


def test_sharded_fused_direct_refuses_what_does_not_tile():
    tx, rx = direct_pair((12_345, -67_891, 300_001), (0.3,) * 3, 80_000)
    assert not fs.ShardedFusedDirect(tx, rx, meshes((2, 2))[1],
                                     block_len=80_000).ok   # 3 tones / 2
    assert fs.make_sharded_fused(tx, rx, meshes((2, 2))[1], 80_000) is None
    assert not fs.ShardedFusedDirect(tx, rx, meshes((1, 1))[1],
                                     block_len=80_005).ok


def _tones_params(n_blocks, block=65_536):
    rate, nfft = 1_024_000, 64
    bh = rate // nfft
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=block,
                             samples=n_blocks * block,
                             freq=[5 * bh, -10 * bh], ampl=[0.4, 0.3],
                             wave_type=[WaveType.TONES] * 2)
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=block,
                            samples=n_blocks * block,
                            freq=[5 * bh, -10 * bh], fft_tones=nfft,
                            pf_average=4, wave_type=[WaveType.TONES] * 2)
    return p


def _direct_params(n_blocks):
    p = UsrpParams()
    f = [12_345, -67_891]
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1_000_000,
                             buffer_len=40_000, samples=n_blocks * 50_000,
                             freq=f, ampl=[0.5, 0.5],
                             wave_type=[WaveType.TONES] * 2)
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                            buffer_len=40_000, samples=n_blocks * 50_000,
                            freq=f, decim=10, pf_average=4,
                            wave_type=[WaveType.DIRECT] * 2)
    return p


def _vna_params(n_blocks, table_rows=True):
    """The VNA loopback; with table_rows, the chirp of
    tests/test_fused_sharded.py:440-446 (period 128,000, 64,000-sample
    blocks: 16 segments a shard on 4 shards, whole 8-segment tiles)."""
    p = UsrpParams()
    if not table_rows:
        p.A_TXRX, p.A_RX2 = vna_pair(100_000, n_blocks * 100_000, ampl=1.0)
        return p
    kw = dict(rate=1_000_000, buffer_len=64_000, samples=n_blocks * 64_000,
              freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
              swipe_s=[128], wave_type=[WaveType.CHIRP])
    p.A_TXRX = AntennaParams(mode=AntMode.TX, ampl=[1.0], **kw)
    p.A_RX2 = AntennaParams(mode=AntMode.RX, decim=1, **kw)
    return p


@pytest.mark.parametrize("kind, shape, sub", [
    ("tones", (8, 1), "channelizer_wavetable"),
    ("tones", (4, 2), "pfb_scan"),
    ("direct", (2, 2), "fold_kernel"),
    ("vna", (4, 2), "chirp_table"),
], ids=lambda v: str(v))
def test_run_measurement_dispatches_sharded_fused(monkeypatch, kind, shape,
                                                  sub):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    params = {"tones": _tones_params, "direct": _direct_params,
              "vna": _vna_params}[kind]
    jm, m = meshes(shape)
    js, s = JMemorySink(), MemorySink()
    jmeasure.run_measurement(params(3), extra_sinks=[js], mesh=jm)
    measure.run_measurement(params(3), extra_sinks=[s], mesh=m)
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "sharded_fused", sub),)
    assert s.data.shape == js.data.shape
    assert [m_.packet_number for m_ in s.metas] == list(range(len(s.metas)))
    assert golden.snr_db(js.data, s.data) > 90.0


def test_channelizer_wavetable_takes_frames_jax_refuses(monkeypatch):
    """Divergence (ROADMAP Queue 3): 125 frames per shard is no multiple
    of the TPU kernel's 8-frame tile, so JAX takes pfb_scan; the port's
    channelizer masks its last tile and keeps channelizer_wavetable.  The
    streams agree."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    jm, m = meshes((8, 1))
    js, s = JMemorySink(), MemorySink()
    jmeasure.run_measurement(_tones_params(2, 64_000), extra_sinks=[js],
                             mesh=jm)
    measure.run_measurement(_tones_params(2, 64_000), extra_sinks=[s],
                            mesh=m)
    assert jmeasure.last_dispatch()[0][2] == "pfb_scan"
    assert measure.last_dispatch()[0][2] == "channelizer_wavetable"
    assert golden.snr_db(js.data, s.data) > 90.0


def test_chirp_table_takes_segments_jax_refuses(monkeypatch):
    """Divergence (ROADMAP Queue 3): 250 segments per shard is no
    multiple of the TPU kernel's 8-row tile, so JAX takes chirp_lockin;
    the port keeps chirp_table.  The lock-in points agree."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    jm, m = meshes((4, 1))
    js, s = JMemorySink(), MemorySink()
    jmeasure.run_measurement(_vna_params(2, False), extra_sinks=[js],
                             mesh=jm)
    measure.run_measurement(_vna_params(2, False), extra_sinks=[s], mesh=m)
    assert jmeasure.last_dispatch()[0][2] == "chirp_lockin"
    assert measure.last_dispatch()[0][2] == "chirp_table"
    assert golden.snr_db(js.data, s.data) > 100.0


@pytest.mark.parametrize("kind", ["channelizer_wavetable", "pfb_scan",
                                  "chirp_table", "chirp_lockin",
                                  "fold_kernel", "g_chain"])
def test_sharded_fused_state_carried_from_jax(monkeypatch, kind):
    """A JAX sharded chain stopped after one execution (2 blocks)
    continues in the port from its converted state."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    if kind == "channelizer_wavetable":
        tx, rx = tones_pair(64_000, (3000, -7000), (0.5, 0.5), 64, 4)
        L, shape = 8 * 64 * 8, (8, 1)
        make = (lambda M, j: (jfs.ShardedFusedLoopback(
            tx, rx, M, blocks_per_exec=2, block_len=L) if j else
            fs.ShardedFusedLoopback(tx, rx, M, block_len=L)))
    elif kind == "chirp_lockin":
        tx, rx = vna_pair(120_000, 480_000)
        shape = (4, 2)
        make = (lambda M, j: (jfs.ShardedFusedVNA(
            tx, rx, M, blocks_per_exec=2, block_len=120_000) if j else
            fs.ShardedFusedVNA(tx, rx, M, block_len=120_000)))
    elif kind == "pfb_scan":
        tx, rx = tones_pair(64_000, (3001, -7013), (0.5, 0.5), 64, 4)
        L, shape = 4 * 64 * 8, (4, 2)
        make = (lambda M, j: (jfs.ShardedFusedLoopback(
            tx, rx, M, blocks_per_exec=2, block_len=L) if j else
            fs.ShardedFusedLoopback(tx, rx, M, block_len=L)))
    elif kind == "chirp_table":
        p = _vna_params(4)
        tx, rx, shape = p.A_TXRX, p.A_RX2, (4, 2)
        make = (lambda M, j: (jfs.ShardedFusedVNA(
            tx, rx, M, blocks_per_exec=2, block_len=64_000) if j else
            fs.ShardedFusedVNA(tx, rx, M, block_len=64_000)))
    else:
        tx, rx = direct_pair((12_345, -67_891), (0.5, 0.25), 40_000)
        shape, fold = (2, 2), kind == "fold_kernel"
        make = (lambda M, j: (jfs.ShardedFusedDirect(
            tx, rx, M, blocks_per_exec=2, block_len=40_000,
            use_fold=fold) if j else fs.ShardedFusedDirect(
            tx, rx, M, block_len=40_000, use_fold=fold)))
    jm, m = meshes(shape)
    jsf, sf = make(jm, True), make(m, False)
    assert sf.path == jsf.path == kind
    _, jst = run_jax(jsf, 1)
    theirs, _ = run_jax(jsf, 1, jst)
    ours, _ = run_port(sf, 2, convert.sharded_fused_state(jst, sf))
    assert golden.snr_db(theirs, ours) > 90.0
