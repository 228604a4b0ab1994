"""The port's channel models (engine/channel.py) against the JAX
package's: each model on the same seeded blocks gives the same samples
bit for bit, and the same take_errors sequence; a host-fed measurement
through a channel equals the same measurement fed the channel's output
as a recording.  The models are host-side numpy in both packages.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu.engine import channel as jchannel
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.engine import channel as tchannel
from gpu_sdr_tpu_torch.engine import make_demodulator, make_generator
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource

torch.set_num_threads(2)

RATE = 1_000_000
RESONATORS = [dict(f0=120_000.0, Qr=2e4, Qe_re=4e4, Qe_im=3e3),
              dict(f0=-75_000.0, Qr=1e4, Qe_re=2e4, a=0.3)]


def blocks(lengths, seed=21):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64) * 0.3 for n in lengths]


def notch(f):
    return 1.0 / (1.0 + (f / 2e5) ** 2) * np.exp(-2j * np.pi * f * 1e-6)


MODELS = {
    "ideal": lambda m: m.IdealChannel(),
    "delay": lambda m: m.DelayChannel(1234),
    "delay_over_block": lambda m: m.DelayChannel(25_000),
    "delay_zero": lambda m: m.DelayChannel(0),
    "frequency_response": lambda m: m.FrequencyResponseChannel(
        rate=RATE, response=notch, fft_len=1 << 12),
    "resonators": lambda m: m.make_resonator_channel(RATE, RESONATORS,
                                                     fft_len=1 << 14),
    "dropout": lambda m: m.DropoutChannel(rate=RATE, events_per_second=200.0,
                                          dropout_len=300, seed=9),
    "chain": lambda m: m.ChainChannel(
        [m.DelayChannel(77), m.make_resonator_channel(RATE, RESONATORS[:1],
                                                      fft_len=1 << 12),
         m.DropoutChannel(rate=RATE, events_per_second=100.0, seed=3)],
        noise_rms=0.01, seed=17),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax_bit_for_bit(name):
    jm, tm = MODELS[name](jchannel), MODELS[name](tchannel)
    assert isinstance(tm, tchannel.Channel)
    errs_j, errs_t = [], []
    for b in blocks([20_000, 20_000, 7_000, 1, 33_333]):
        yj, yt = jm(b.copy()), tm(b.copy())
        assert np.asarray(yt).dtype == np.asarray(yj).dtype
        assert np.array_equal(yt, yj)
        if hasattr(jm, "take_errors"):
            errs_j.append(jm.take_errors())
            errs_t.append(tm.take_errors())
    assert errs_t == errs_j
    if name in ("dropout", "chain"):
        assert sum(errs_t) > 0
    if name.startswith("frequency") or name == "resonators":
        assert tm.extra_delay == jm.extra_delay


@pytest.mark.parametrize("a", [0.0, 0.4])
def test_resonator_s21_matches_jax(a):
    f = np.linspace(-3e5, 3e5, 4001)
    args = (f, 1.1e5, 3e4, 5e4, 2e3, a)
    assert np.array_equal(tchannel.resonator_s21(*args),
                          jchannel.resonator_s21(*args))
    # the dip: |S21| is smallest at (about) the resonance
    s = np.abs(tchannel.resonator_s21(*args))
    assert abs(f[np.argmin(s)] - 1.1e5) < 2e3


def _config(n_blocks):
    """A small DIRECT readout: three tones at 1 Msps, decim 100."""
    freqs = [12_345, -67_891, 300_001]
    p = tparams.UsrpParams()
    kw = dict(rate=RATE, buffer_len=100_000, freq=freqs)
    p.A_TXRX = tparams.AntennaParams(mode=tparams.AntMode.TX,
                                     ampl=[0.15] * 3,
                                     wave_type=[tparams.WaveType.TONES] * 3,
                                     **kw)
    p.A_RX2 = tparams.AntennaParams(mode=tparams.AntMode.RX, decim=100,
                                    pf_average=4, samples=n_blocks * 100_000,
                                    wave_type=[tparams.WaveType.DIRECT] * 3,
                                    **kw)
    return p


def _chain():
    return tchannel.ChainChannel([
        tchannel.DelayChannel(4321),
        tchannel.make_resonator_channel(
            RATE, [dict(f0=f, Qr=1e4, Qe_re=2e4) for f in
                   (12_345, -67_891, 300_001)], fft_len=1 << 14),
        tchannel.DropoutChannel(rate=RATE, events_per_second=20.0,
                                dropout_len=400, seed=8)])


def test_channel_run_equals_array_run(tmp_path):
    """run_measurement through the channel (host pipeline) == the same
    blocks of the channel's output, computed on the host, replayed as a
    recording; the errors rows are the dropout events."""
    n_blocks = 4
    p = _config(n_blocks)
    s = MemorySink()
    fn = measure.run_measurement(p, channel=_chain(), extra_sinks=[s],
                                 filename=str(tmp_path / "ch"),
                                 device="cpu")
    assert measure.last_dispatch() == (("A_RX2", "host_pipeline", None),)
    ch = _chain()
    gen = make_generator(p.A_TXRX, 100_000, "cpu")
    outs, errs = [], []
    for x in gen.blocks(n_blocks):
        outs.append(ch(x))
        errs.append(ch.take_errors())
    ref = MemorySink()
    measure.run_measurement(_config(n_blocks),
                            source=ArraySource(np.concatenate(outs)),
                            extra_sinks=[ref], device="cpu")
    assert np.array_equal(s.data, ref.data)
    assert [m.errors for m in s.metas] == errs and sum(errs) > 0
    import h5py
    rows = 100_000 // 100
    with h5py.File(fn, "r") as f:
        e = f["raw_data0"]["A_RX2"]["errors"][()]
    assert e.tolist() == [[k * rows, (k + 1) * rows]
                          for k, n in enumerate(errs) if n]
    d = make_demodulator(p.A_RX2, "cpu")
    assert s.data.shape == (n_blocks * d.plan.out_rows, 3)
