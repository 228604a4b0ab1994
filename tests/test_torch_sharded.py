"""The port's sharded demodulators (gpu_sdr_tpu_torch/parallel/sharded.py,
sharded_pfb.py, sharded_chirp.py, engine/demodulator.py's mesh builders)
against the JAX package's on the mesh shapes its tests use, over 8
virtual CPU devices (JAX) and 8 "cpu" shards (the port): the same seeded
blocks through both, block after block, the halo ring and the carried
phases crossing blocks; the host pipeline through
``run_measurement(mesh=...)``; each sharded state carried from JAX in
mid-stream (convert.py) and stepped on.

Bars: 90 dB SNR against JAX and against the single-device path
(tests/test_sharded_tones.py:49), 100 dB for CHIRP
(tests/test_sharded_chirp.py:45); the integer phases equal.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine import make_demodulator as jmake_demod
from gpu_sdr_tpu.engine.channel import IdealChannel as JIdealChannel
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import convert, measure
from gpu_sdr_tpu_torch.engine import make_demodulator
from gpu_sdr_tpu_torch.engine.channel import IdealChannel
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.parallel import Sharded, make_mesh

torch.set_num_threads(2)

SHAPES = [(1, 1), (2, 4), (4, 2), (8, 1)]
RATE = 1_024_000


def meshes(shape):
    return (jmake_mesh(shape, ("time", "channels")),
            make_mesh(shape, ("time", "channels"), devices=["cpu"] * 8))


def crandn(rng, n):
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def rx_of(kind):
    if kind == "direct":
        f = [100_000, -200_000, 50_000, -350_000]
        return AntennaParams(mode=AntMode.RX, rate=RATE, decim=16,
                             pf_average=4, buffer_len=64_000,
                             samples=128_000, freq=f,
                             wave_type=[WaveType.DIRECT] * 4)
    if kind == "direct3":        # 3 tones: padded to the channel axis
        f = [100_000, -200_000, 50_000]
        return AntennaParams(mode=AntMode.RX, rate=RATE, decim=16,
                             pf_average=4, buffer_len=64_000,
                             samples=128_000, freq=f,
                             wave_type=[WaveType.DIRECT] * 3)
    if kind in ("tones", "tones_decim"):
        bh = RATE // 64
        return AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=64,
                             pf_average=4, buffer_len=64_000,
                             samples=128_000,
                             decim=4 if kind == "tones_decim" else 0,
                             freq=[5 * bh, -10 * bh, 20 * bh],
                             wave_type=[WaveType.TONES] * 3)
    if kind == "noise_decim":
        return AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=64,
                             pf_average=4, decim=4, buffer_len=64_000,
                             samples=128_000, freq=[0],
                             wave_type=[WaveType.NOISE])
    return AntennaParams(mode=AntMode.RX, rate=1_000_000, decim=1,
                         buffer_len=100_000, samples=200_000,
                         freq=[-300_000], chirp_f=[300_000],
                         chirp_t=[0.1], swipe_s=[1000],
                         wave_type=[WaveType.CHIRP])


def run_both(kind, shape, n_blocks=3, seed=0):
    """Both sharded demodulators over the same seeded blocks: (port
    output, JAX output, port demodulator, JAX demodulator)."""
    jm, m = meshes(shape)
    rx = rx_of(kind)
    jd, d = jmake_demod(rx, mesh=jm), make_demodulator(rx, mesh=m)
    assert d.plan == type(d.plan)(**jd.plan.__dict__)
    assert d.n_channels == jd.n_channels
    rng = np.random.default_rng(seed)
    js, s = jd.init_state(), d.init_state()
    outs, jouts = [], []
    for _ in range(n_blocks):
        x = crandn(rng, d.plan.block_len)
        js, jy = jd.step(js, jcplx.from_np(x))
        s, y = d.step(s, torch.from_numpy(x))
        assert isinstance(y, Sharded)
        outs.append(y.gather().numpy())
        jouts.append(jcplx.to_np(jy))
    return np.concatenate(outs), np.concatenate(jouts), d, jd


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["direct", "tones", "noise_decim"])
def test_sharded_demodulator_matches_jax(kind, shape):
    ours, theirs, d, _ = run_both(kind, shape)
    assert ours.shape == theirs.shape and ours.dtype == np.complex64
    assert golden.snr_db(theirs, ours) > 90.0


@pytest.mark.parametrize("kind, shape", [
    ("direct3", (2, 4)), ("tones_decim", (2, 4)), ("chirp", (4, 2)),
    ("chirp", (8, 1))], ids=lambda v: str(v))
def test_sharded_demodulator_edge_cases_match_jax(kind, shape):
    ours, theirs, d, _ = run_both(kind, shape, n_blocks=2)
    assert ours.shape == theirs.shape
    assert golden.snr_db(theirs, ours) > (100.0 if kind == "chirp"
                                          else 90.0)


@pytest.mark.parametrize("kind", ["direct", "tones_decim"])
def test_sharded_matches_single_device_stream(kind):
    """The sharded stream equals the single-device demodulator's over the
    same samples (its block re-cut), as the JAX tests hold theirs."""
    ours, _, d, _ = run_both(kind, (2, 4), n_blocks=2, seed=3)
    rng = np.random.default_rng(3)
    stream = np.concatenate([crandn(rng, d.plan.block_len)
                             for _ in range(2)])
    d1 = make_demodulator(rx_of(kind), "cpu")
    s, outs = d1.init_state(), []
    L1 = d1.plan.block_len
    for i in range(len(stream) // L1):
        s, y = d1.step(s, torch.from_numpy(stream[i * L1:(i + 1) * L1]))
        outs.append(y.numpy())
    ref = np.concatenate(outs)
    n = min(len(ref), len(ours))
    assert golden.snr_db(ref[:n], ours[:n]) > 90.0


def test_sharded_ddc_phase_and_carry_match_jax():
    """The carried state itself: integer phases equal to JAX's on every
    shard, the halo carry each time shard's last received tail."""
    jm, m = meshes((4, 2))
    rx = rx_of("direct")
    jd, d = jmake_demod(rx, mesh=jm), make_demodulator(rx, mesh=m)
    rng = np.random.default_rng(9)
    js, s = jd.init_state(), d.init_state()
    for _ in range(2):
        x = crandn(rng, d.plan.block_len)
        js, _ = jd.step(js, jcplx.from_np(x))
        s, _ = d.step(s, torch.from_numpy(x))
    phase, carry = s
    jphase = np.asarray(js[0])
    sd = d.sharded
    for t in range(4):
        for c in range(2):
            assert np.array_equal(
                phase[t][c].numpy(), jphase[c * sd.Cl:(c + 1) * sd.Cl])
    jcarry = jcplx.to_np(js[1]).reshape(4, -1)
    for t in range(4):
        assert np.array_equal(carry[t][0].numpy(), jcarry[t])


@pytest.mark.parametrize("kind", ["direct", "tones", "chirp"])
def test_sharded_state_carried_from_jax(kind):
    """A JAX sharded stream stopped after a block continues in the port
    from its converted state."""
    shape = (2, 1) if kind == "chirp" else (2, 4)
    jm, m = meshes(shape)
    rx = rx_of(kind)
    jd, d = jmake_demod(rx, mesh=jm), make_demodulator(rx, mesh=m)
    rng = np.random.default_rng(21)
    x0, x1 = (crandn(rng, d.plan.block_len) for _ in range(2))
    js, _ = jd.step(jd.init_state(), jcplx.from_np(x0))
    js2, jy = jd.step(js, jcplx.from_np(x1))
    if kind == "direct":
        st = convert.sharded_ddc_state(js, d.sharded)
    elif kind == "tones":
        st = convert.sharded_pfb_state(js, d.sharded)
    else:
        st = convert.sharded_chirp_state(js)
    st2, y = d.step(st, torch.from_numpy(x1))
    assert golden.snr_db(jcplx.to_np(jy), y.gather().numpy()) > 90.0
    if kind == "chirp":
        assert st2 == convert.sharded_chirp_state(js2)


def _host_params(kind, n_blocks=2):
    p = UsrpParams()
    if kind == "direct":
        f = [12_345, -67_891]
        p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1_000_000,
                                 buffer_len=40_000, freq=f, ampl=[0.5, 0.5],
                                 wave_type=[WaveType.TONES] * 2)
        p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                                buffer_len=40_000, samples=n_blocks * 50_000,
                                freq=f, decim=10, pf_average=4,
                                wave_type=[WaveType.DIRECT] * 2)
    else:
        bh = RATE // 64
        f = [5 * bh, -10 * bh]
        p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE,
                                 buffer_len=64_000, freq=f, ampl=[0.4, 0.3],
                                 wave_type=[WaveType.TONES] * 2)
        p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=64,
                                pf_average=4, buffer_len=64_000,
                                samples=n_blocks * 64_000, freq=f,
                                wave_type=[WaveType.TONES] * 2)
    return p


@pytest.mark.parametrize("kind, shape", [("direct", (2, 2)),
                                         ("tones", (2, 2)),
                                         ("tones", (8, 1))],
                         ids=lambda v: str(v))
def test_host_pipeline_under_a_mesh_matches_jax(kind, shape):
    """run_measurement(mesh=..., channel=...) feeds host blocks to the
    shards: the JAX dispatch, the JAX stream."""
    jm, m = meshes(shape)
    js, s = JMemorySink(), MemorySink()
    jmeasure.run_measurement(_host_params(kind), channel=JIdealChannel(),
                             extra_sinks=[js], mesh=jm)
    measure.run_measurement(_host_params(kind), channel=IdealChannel(),
                            extra_sinks=[s], mesh=m)
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "host_pipeline", None),)
    assert s.data.shape == js.data.shape
    assert golden.snr_db(js.data, s.data) > 90.0
