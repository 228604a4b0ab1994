"""The port's CHIRP / VNA readout against the JAX package: the CHIRP
demodulator's three steps, the CHIRP generator, the fused
``chirp_wavetable`` loopback, ``run_measurement`` fused and host-fed,
resuming from JAX state, and the divergences the port records.

Geometry of tests/test_pallas_lockin.py:113-148: rate 1e6, a -300 kHz
to +300 kHz chirp of 128 steps over 0.128 s (1000 samples a step, so
ppt 1000 at decim 1), 64,000-sample blocks of 64 segments, two blocks
per period.  The JAX side runs its Pallas kernels in interpret mode
(GPU_SDR_TPU_PALLAS=1) unless a test says otherwise.  Bars: 120 dB SNR
against JAX (the same float32 arithmetic summed in another order); 90 dB
against the float64 oracle (golden.chirp_demod + GoldenVNADecimator);
the same dispatch (``LAST_DISPATCH``, and JAX's ``plan_dispatch``)
wherever JAX's gates pass; exact stream positions.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine import make_demodulator as jmake_demod
from gpu_sdr_tpu.engine import make_generator as jmake_gen
from gpu_sdr_tpu.engine.channel import IdealChannel as JIdealChannel
from gpu_sdr_tpu.engine.dispatch import plan_dispatch
from gpu_sdr_tpu.engine.fused import FusedLoopback as JFusedLoopback
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import convert, measure
from gpu_sdr_tpu_torch.engine import (FusedLoopback, make_demodulator,
                                      make_generator)
from gpu_sdr_tpu_torch.engine.channel import IdealChannel
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.ops.lockin_table import lockin_self, lockin_table

torch.set_num_threads(2)

RATE, BLOCK, PPT = 1_000_000, 64_000, 1000
NSEG = BLOCK // PPT
AMPL = 0.7
CHIRP = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
             swipe_s=[128])


def antennas(n_blocks=5, decim=1, buffer_len=BLOCK, ampl=AMPL, chirp=None,
             **tx_kw):
    def c():
        return {k: list(v) for k, v in (chirp or CHIRP).items()}
    tx = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=buffer_len,
                       ampl=[ampl], wave_type=[WaveType.CHIRP], **c(),
                       **tx_kw)
    rx = AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=buffer_len,
                       samples=n_blocks * buffer_len, decim=decim,
                       wave_type=[WaveType.CHIRP], **c())
    return tx, rx


def make_params(n_blocks=5, **kw):
    p = UsrpParams()
    p.A_TXRX, p.A_RX2 = antennas(n_blocks, **kw)
    return p


def golden_stream(n_samples, chirp=None, ampl=AMPL, ppt=PPT):
    """Float64 oracle: the TX chirp looped back, demodulated from stream
    position 0 and lock-in averaged."""
    c = chirp or CHIRP
    cp = golden.ChirpParameter(c["freq"][0], c["chirp_f"][0], RATE,
                               c["swipe_s"][0], c["chirp_t"][0])
    x = golden.chirp_signal(cp, 0, n_samples, scale=ampl)
    return golden.GoldenVNADecimator(ppt)(golden.chirp_demod(cp, 0, x))


def noise_blocks(n, L, seed=23):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(L) + 1j * rng.standard_normal(L)
             ).astype(np.complex64) for _ in range(n)]


def position(state):
    """The stream position of a port CHIRP state."""
    return state[0] if isinstance(state, tuple) else state


def run_jax(jd, blocks, jstate=None):
    js = jd.init_state() if jstate is None else jstate
    out = []
    for b in blocks:
        js, jy = jd.step(js, jcplx.from_np(b))
        out.append(jcplx.to_np(jy))
    return js, out


def run_demods(jd, td, blocks, jstate=None, tstate=None):
    """Both demodulators over the same blocks, the stream positions
    compared after every block: (JAX out, port out, JAX state, port
    state)."""
    js = jd.init_state() if jstate is None else jstate
    ts = td.init_state() if tstate is None else tstate
    jo, to = [], []
    for b in blocks:
        js, (jy,) = run_jax(jd, [b], js)
        ts, ty = td.step(ts, torch.from_numpy(b))
        jo.append(jy)
        to.append(ty.numpy())
        assert position(convert.chirp_state(js)) == position(ts)
    return np.concatenate(jo), np.concatenate(to), js, ts


@pytest.mark.parametrize("kind, kw", [
    ("table", {}),
    ("plain", dict(buffer_len=96_000)),       # period % L != 0
    ("plain_decim3", dict(decim=3)),          # ppt 3000, L 63,000
    ("passthrough", dict(decim=0)),
])
def test_demodulator_steps_match_jax(monkeypatch, kind, kw):
    """Five blocks of noise, across the period seam, through each CHIRP
    step, with the stream position checked after every block."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    _, rx = antennas(**kw)
    jd, td = jmake_demod(rx), make_demodulator(rx, "cpu")
    assert td.plan == jd.plan or \
        (td.plan.block_len, td.plan.out_rows) == \
        (jd.plan.block_len, jd.plan.out_rows)
    table = isinstance(jd.init_state(), tuple)
    assert table == isinstance(td.init_state(), tuple) == (kind == "table")
    L = td.plan.block_len
    jout, tout, _, _ = run_demods(jd, td, noise_blocks(5, L))
    assert tout.shape == jout.shape == (5 * td.plan.out_rows, 1)
    assert tout.dtype == np.complex64
    assert golden.snr_db(jout, tout) > 120.0


@pytest.mark.parametrize("burst", [False, True], ids=["steady", "burst"])
def test_generator_matches_jax(burst):
    kw = dict(burst_on=0.05, burst_off=0.03) if burst else {}
    tx, _ = antennas(**kw)
    jg, tg = jmake_gen(tx, block_len=BLOCK), make_generator(tx, BLOCK, "cpu")
    jx = np.concatenate(list(jg.blocks(3)))
    tx_ = np.concatenate(list(tg.blocks(3)))
    assert tx_.dtype == np.complex64 and tx_.shape == (3 * BLOCK,)
    assert golden.snr_db(jx, tx_) > 120.0
    if burst:
        assert np.abs(tx_[50_000:80_000]).max() == 0.0
        np.testing.assert_allclose(np.abs(tx_[:50_000]), AMPL, rtol=1e-6)
    else:
        cp = golden.ChirpParameter(-300_000, 300_000, RATE, 128, 0.128)
        assert golden.snr_db(golden.chirp_signal(cp, 0, 3 * BLOCK,
                                                 scale=AMPL), tx_) > 90.0


def test_fused_loopback_matches_jax(monkeypatch):
    """FusedLoopback takes chirp_wavetable in both packages; five blocks
    wrap the period twice; every lock-in point is the TX amplitude with
    an imaginary half of exactly 0."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    tx, rx = antennas()
    jf, tf = JFusedLoopback(tx, rx), FusedLoopback(tx, rx, device="cpu")
    assert jf.path == tf.path == "chirp_wavetable"
    js, ts = JMemorySink(), MemorySink()
    jf.run([js])
    before = lockin_self.launches
    tf.run([ts])
    assert lockin_self.launches == before       # the CPU takes plain
    assert ts.data.shape == js.data.shape == (5 * NSEG, 1)
    assert golden.snr_db(js.data, ts.data) > 120.0
    assert golden.snr_db(golden_stream(5 * BLOCK), ts.data[:, 0]) > 90.0
    assert np.array_equal(ts.data.imag, np.zeros_like(ts.data.imag))
    np.testing.assert_allclose(ts.data.real, AMPL, rtol=1e-5)


@pytest.mark.parametrize("host", [False, True],
                         ids=["fused_loopback", "host_pipeline"])
def test_run_measurement_matches_jax(monkeypatch, host):
    """run_measurement in both packages: the same LAST_DISPATCH, which is
    JAX's plan_dispatch row; outputs against JAX and the float64
    oracle; on the CPU the kernels' plain versions run and count no
    launch."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    js, ts = JMemorySink(), MemorySink()
    jp = make_params()
    plan = tuple(d.key() for d in plan_dispatch(
        jp, channel=JIdealChannel() if host else None))
    jmeasure.run_measurement(jp, channel=JIdealChannel() if host else None,
                             extra_sinks=[js])
    before = (lockin_self.launches, lockin_table.launches)
    measure.run_measurement(make_params(),
                            channel=IdealChannel() if host else None,
                            extra_sinks=[ts], device="cpu")
    assert (lockin_self.launches, lockin_table.launches) == before
    assert measure.last_dispatch() == jmeasure.last_dispatch() == plan == \
        ((("A_RX2", "host_pipeline", None),) if host else
         (("A_RX2", "fused_loopback", "chirp_wavetable"),))
    assert [m.packet_number for m in ts.metas] == list(range(5))
    assert ts.data.shape == js.data.shape == (5 * NSEG, 1)
    assert golden.snr_db(js.data, ts.data) > 120.0
    assert golden.snr_db(golden_stream(5 * BLOCK), ts.data[:, 0]) > 90.0
    assert np.abs(np.abs(ts.data) - AMPL).max() < 1e-5


def test_resume_fused_chain_from_jax_state(monkeypatch):
    """The fused chain's JAX state (uint32 position, int32 period block,
    the wavetable) taken after three blocks, past the seam, carries into
    the port's chain, which continues where JAX does."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    tx, rx = antennas()
    jchain = JFusedLoopback(tx, rx)._chain
    jst, _ = jchain.multi_step(jchain.init_state(), 3)
    jst2, jy = jchain.multi_step(jst, 2)
    chain = FusedLoopback(tx, rx, device="cpu")
    st = convert.chirp_state(jst)
    assert st == (3 * BLOCK % 128_000, 1)
    ys = []
    for _ in range(2):
        st, y = chain._step(st)
        ys.append(y.numpy())
    assert st == convert.chirp_state(jst2)
    assert golden.snr_db(jcplx.to_np(jy), np.concatenate(ys)) > 120.0


@pytest.mark.parametrize("kind, kw", [
    ("table", {}), ("plain", dict(buffer_len=96_000))])
def test_resume_demodulator_from_jax_state(monkeypatch, kind, kw):
    """The host-fed steps' JAX states, (uint32 position, int32
    oscillator block) for the table step and a uint32 position for the
    plain one, taken after three blocks, carry into the port."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    _, rx = antennas(**kw)
    jd, td = jmake_demod(rx), make_demodulator(rx, "cpu")
    blocks = noise_blocks(5, td.plan.block_len, seed=29)
    jst, _ = run_jax(jd, blocks[:3])
    st = convert.chirp_state(jst)
    assert position(st) == 3 * td.plan.block_len % 128_000
    assert isinstance(st, tuple) == (kind == "table")
    td.init_state()                     # the table step builds its table
    jout, tout, _, _ = run_demods(jd, td, blocks[3:], jst, st)
    assert golden.snr_db(jout, tout) > 120.0


def test_segment_tile_divergence(monkeypatch):
    """50 segments a block (a 0.1 s chirp of 100 steps, 50,000-sample
    blocks): JAX's kernels need 8-segment row tiles, so its fused
    loopback takes generic_scan and its host-fed demodulator the XLA
    step; the port takes chirp_wavetable and the table step.  The
    outputs agree (ROADMAP Queue 3)."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    chirp = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
                 swipe_s=[100])
    kw = dict(chirp=chirp, buffer_len=50_000, n_blocks=3)
    tx, rx = antennas(**kw)
    assert JFusedLoopback(tx, rx).path == "generic_scan"
    assert FusedLoopback(tx, rx, device="cpu").path == "chirp_wavetable"
    jd, td = jmake_demod(rx), make_demodulator(rx, "cpu")
    assert not isinstance(jd.init_state(), tuple)
    assert isinstance(td.init_state(), tuple)
    jout, tout, _, _ = run_demods(jd, td, noise_blocks(3, 50_000))
    assert golden.snr_db(jout, tout) > 120.0
    js, ts = JMemorySink(), MemorySink()
    p = make_params(**kw)
    jmeasure.run_measurement(p, extra_sinks=[js])
    measure.run_measurement(make_params(**kw), extra_sinks=[ts],
                            device="cpu")
    assert jmeasure.last_dispatch()[0][2] == "generic_scan"
    assert measure.last_dispatch()[0][2] == "chirp_wavetable"
    assert golden.snr_db(js.data, ts.data) > 120.0


def test_host_fed_table_gate_divergence(monkeypatch):
    """A 10 s chirp of 10,000 steps: its one-period table is 80 MB, over
    JAX's 64 MB host-fed closure limit (a limit of its remote-compile
    relay), so JAX takes the XLA step and the port the table step, as
    both do for a smaller table.  The outputs agree."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    chirp = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[10.0],
                 swipe_s=[10_000])
    _, rx = antennas(chirp=chirp, buffer_len=1_000_000, n_blocks=1)
    jd, td = jmake_demod(rx), make_demodulator(rx, "cpu")
    assert td.plan.block_len == 1_000_000
    assert not isinstance(jd.init_state(), tuple)
    assert isinstance(td.init_state(), tuple)
    jout, tout, _, _ = run_demods(jd, td, noise_blocks(1, 1_000_000))
    assert golden.snr_db(jout, tout) > 120.0


def test_no_pallas_switch_divergence(monkeypatch):
    """The port has no kernel switch: with GPU_SDR_TPU_PALLAS=0 JAX's
    fused loopback takes generic_scan and its host-fed demodulator the
    XLA step, while the port keeps chirp_wavetable and the table step.
    The outputs agree."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "0")
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(make_params(3), extra_sinks=[js])
    measure.run_measurement(make_params(3), extra_sinks=[ts], device="cpu")
    assert jmeasure.last_dispatch()[0][2] == "generic_scan"
    assert measure.last_dispatch()[0][2] == "chirp_wavetable"
    assert golden.snr_db(js.data, ts.data) > 120.0
    _, rx = antennas()
    assert not isinstance(jmake_demod(rx).init_state(), tuple)
    assert isinstance(make_demodulator(rx, "cpu").init_state(), tuple)


def test_mismatched_demodulator_takes_generic_scan(monkeypatch):
    """A receiver whose chirp is not the TX chirp cannot read the TX
    table: both packages run the generator and the demodulator back to
    back, and a burst-gated chirp likewise."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    for edit in (lambda p: p.A_RX2.chirp_f.__setitem__(0, 200_000),
                 lambda p: setattr(p.A_TXRX, "burst_on", 0.05)):
        js, ts = JMemorySink(), MemorySink()
        p, q = make_params(3), make_params(3)
        edit(p)
        edit(q)
        jmeasure.run_measurement(p, extra_sinks=[js])
        measure.run_measurement(q, extra_sinks=[ts], device="cpu")
        assert measure.last_dispatch() == jmeasure.last_dispatch() == \
            (("A_RX2", "fused_loopback", "generic_scan"),)
        assert golden.snr_db(js.data, ts.data) > 120.0


@pytest.mark.parametrize("case", ["chirp_rx", "chirp_tx"])
def test_chirp_with_a_tone_comb_matches_jax(monkeypatch, case):
    """A TONES comb into a CHIRP receiver, and a CHIRP into a TONES
    receiver through an ideal channel, host-fed in both packages."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")

    def mk():
        p = UsrpParams()
        freqs = [-256_000, 4_000, 100_000]
        p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE,
                                 buffer_len=128_000, freq=freqs,
                                 ampl=[0.2] * 3,
                                 wave_type=[WaveType.TONES] * 3)
        p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=1000,
                                buffer_len=128_000, samples=256_000,
                                freq=freqs, wave_type=[WaveType.TONES] * 3)
        if case == "chirp_rx":
            p.A_RX2.wave_type, p.A_RX2.decim = [WaveType.CHIRP], 10
            p.A_RX2.chirp_f, p.A_RX2.chirp_t = [1000], [0.1]
        else:
            p.A_TXRX.wave_type, p.A_TXRX.freq = [WaveType.CHIRP], [1000]
            p.A_TXRX.ampl = [0.5]
            p.A_TXRX.chirp_f, p.A_TXRX.chirp_t = [2000], [0.1]
        return p

    ch = (JIdealChannel(), IdealChannel()) if case == "chirp_tx" else \
        (None, None)
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(mk(), channel=ch[0], extra_sinks=[js])
    measure.run_measurement(mk(), channel=ch[1], extra_sinks=[ts],
                            device="cpu")
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "host_pipeline", None),)
    assert ts.data.shape == js.data.shape
    assert golden.snr_db(js.data, ts.data) > 90.0
