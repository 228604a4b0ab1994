"""The PyTorch port's measurement slice against the JAX package:
``run_measurement`` for a bin-quantized TONES comb looped back into a
TONES or NOISE receiver, fused on the device and host-fed, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(GPU_SDR_TPU_PALLAS=1, as tests/test_fused.py does).  Bars: the same
dispatch on both sides; 90 dB SNR against JAX and against the float64
oracle (tests/test_ops_pfb_chirp.py:50-51); steady tone amplitudes
within 1% (tests/test_fused.py:153-155).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine.channel import IdealChannel as JIdealChannel
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch.engine.channel import IdealChannel
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.ops.channelizer import channelizer
from gpu_sdr_tpu_torch.ops.presum import presum

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 1_000_000
NFFT = 1000
AVG = 4
BLOCK = 128 * NFFT
N_TONES = 16
FREQS = [k * (RATE // NFFT) for k in range(-256, 256, 512 // N_TONES)]
AMPLS = [1.0 / N_TONES] * N_TONES


def make_params(rx_wave, n_blocks, freqs=FREQS, ampls=AMPLS, **tx_kw):
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=BLOCK,
                             freq=list(freqs), ampl=list(ampls),
                             wave_type=[WaveType.TONES] * len(freqs),
                             **tx_kw)
    tones = rx_wave == WaveType.TONES
    p.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=RATE, fft_tones=NFFT, pf_average=AVG,
        buffer_len=BLOCK, samples=n_blocks * BLOCK,
        freq=list(freqs) if tones else [0],
        wave_type=[rx_wave] * (len(freqs) if tones else 1))
    return p


def run_both(monkeypatch, rx_wave, n_blocks, host, pallas="1", **kw):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", pallas)
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(make_params(rx_wave, n_blocks, **kw),
                             channel=JIdealChannel() if host else None,
                             extra_sinks=[js])
    jdisp = jmeasure.last_dispatch()
    measure.run_measurement(make_params(rx_wave, n_blocks, **kw),
                            channel=IdealChannel() if host else None,
                            extra_sinks=[ts], device="cpu")
    assert measure.last_dispatch() == jdisp
    assert [m.packet_number for m in ts.metas] == list(range(n_blocks))
    assert ts.data.dtype == np.complex64
    assert ts.data.shape == js.data.shape
    return jdisp, js.data, ts.data


def golden_stream(rx_wave, n_blocks, freqs=FREQS, ampls=AMPLS):
    """Float64 oracle of the whole acquisition: the comb through the PFB
    with a zero-primed spare, tones selected for TONES."""
    x = golden.tone_block(freqs, ampls, RATE, 0, n_blocks * BLOCK)
    x = np.concatenate([np.zeros((AVG - 1) * NFFT), x])
    frames = golden.pfb_frames(x, NFFT, AVG)
    if rx_wave == WaveType.TONES:
        return golden.tone_select(frames, golden.tone_bins(freqs, RATE,
                                                           NFFT))
    return frames


@pytest.mark.parametrize("host", [False, True],
                         ids=["fused_loopback", "host_pipeline"])
@pytest.mark.parametrize("rx_wave", [WaveType.TONES, WaveType.NOISE],
                         ids=["tones", "noise"])
def test_slice_matches_jax_and_golden(monkeypatch, rx_wave, host):
    n_blocks = 3 if host else 2
    disp, jdata, data = run_both(monkeypatch, rx_wave, n_blocks, host)
    assert disp == ((("A_RX2", "host_pipeline", None),) if host else
                    (("A_RX2", "fused_loopback", "channelizer_wavetable"),))
    assert golden.snr_db(jdata, data) > 90.0
    assert golden.snr_db(golden_stream(rx_wave, n_blocks), data) > 90.0
    steady = data[AVG - 1:]
    if rx_wave == WaveType.TONES:
        assert data.shape == (n_blocks * 128, N_TONES)
        np.testing.assert_allclose(np.abs(steady), 1.0 / N_TONES,
                                   rtol=1e-2)
    else:
        assert data.shape == (n_blocks * 128, NFFT)
        bins = golden.tone_bins(FREQS, RATE, NFFT)
        np.testing.assert_allclose(np.abs(steady[:, bins]), 1.0 / N_TONES,
                                   rtol=1e-2)
        assert np.abs(np.delete(steady, bins, axis=1)).max() < 1e-3


def test_generic_scan_matches_jax(monkeypatch):
    """An aperiodic comb is no single wavetable frame: both packages run
    the generator and the host-fed demodulator back to back."""
    freqs, ampls = [12_345, -67_891, 300_001], [0.3, 0.3, 0.4]
    disp, jdata, data = run_both(monkeypatch, WaveType.TONES, 2, False,
                                 pallas="0", freqs=freqs, ampls=ampls)
    assert disp == (("A_RX2", "fused_loopback", "generic_scan"),)
    assert golden.snr_db(jdata, data) > 90.0
    assert golden.snr_db(golden_stream(WaveType.TONES, 2, freqs, ampls),
                         data) > 90.0


def test_burst_gated_loopback_matches_jax(monkeypatch):
    disp, jdata, data = run_both(monkeypatch, WaveType.TONES, 2, False,
                                 pallas="0", burst_on=0.05, burst_off=0.03)
    assert disp == (("A_RX2", "fused_loopback", "generic_scan"),)
    assert golden.snr_db(jdata, data) > 90.0
    assert np.abs(data[AVG - 1:]).min() < 1e-3 < np.abs(data).max()


def test_white_noise_rx_matches_jax(monkeypatch):
    """No TX: the receiver reads seeded white noise from the host."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    p = make_params(WaveType.NOISE, 2)
    p.A_TXRX = AntennaParams()
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(p, extra_sinks=[js])
    p2 = make_params(WaveType.NOISE, 2)
    p2.A_TXRX = AntennaParams()
    measure.run_measurement(p2, extra_sinks=[ts], device="cpu")
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "host_pipeline", None),)
    assert golden.snr_db(js.data, ts.data) > 90.0


@pytest.mark.parametrize("kind", ["loopback", "array"])
def test_run_pipeline_sources_match_jax(monkeypatch, kind):
    """The engine's own loop: make_demodulator + run_pipeline over a
    seeded noisy loopback or an in-memory array, both packages."""
    from gpu_sdr_tpu.engine import (make_demodulator as jmake_demod,
                                    make_generator as jmake_gen,
                                    run_pipeline as jrun)
    from gpu_sdr_tpu.engine.sources import (ArraySource as JArraySource,
                                            LoopbackSource as JLoopback)
    from gpu_sdr_tpu_torch.engine import (make_demodulator,
                                          make_generator, run_pipeline)
    from gpu_sdr_tpu_torch.engine.sources import ArraySource, LoopbackSource
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    p = make_params(WaveType.TONES, 2)
    p.validate()
    tx, rx = p.A_TXRX, p.A_RX2
    jd, td = jmake_demod(rx), make_demodulator(rx, "cpu")
    assert dataclasses.astuple(td.plan) == dataclasses.astuple(jd.plan)
    if kind == "loopback":
        jsrc = JLoopback(jmake_gen(tx, block_len=BLOCK), noise_rms=0.01,
                         seed=5)
        src = LoopbackSource(make_generator(tx, BLOCK, "cpu"),
                             noise_rms=0.01, seed=5)
    else:
        rng = np.random.default_rng(31)
        data = (rng.standard_normal(2 * BLOCK) +
                1j * rng.standard_normal(2 * BLOCK)).astype(np.complex64)
        jsrc, src = JArraySource(data[:-1000]), ArraySource(data[:-1000])
    js, ts = JMemorySink(), MemorySink()
    jres = jrun(jd, jsrc, [js])
    res = run_pipeline(td, src, [ts])
    assert (res.n_blocks, res.rows, res.channels, res.samples_in) == \
        (jres.n_blocks, jres.rows, jres.channels, jres.samples_in)
    assert golden.snr_db(js.data, ts.data) > 90.0


def test_host_feed_surfaces_source_errors():
    """A source that fails mid-stream fails the pipeline with its own
    error; the packets before it reach the sinks, which are closed."""
    from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
    from gpu_sdr_tpu_torch.engine.sinks import Sink

    class Broken:
        def blocks(self, block_len, n_blocks):
            yield np.zeros(block_len, np.complex64)
            raise OSError("radio gone")

    class Recorder(MemorySink):
        ended = False

        def on_end(self):
            self.ended = True

    p = make_params(WaveType.TONES, 3)
    p.validate()
    sink = Recorder()
    assert isinstance(sink, Sink)
    with pytest.raises(OSError, match="radio gone"):
        run_pipeline(make_demodulator(p.A_RX2, "cpu"), Broken(), [sink])
    assert len(sink.packets) == 1 and sink.ended


def test_slice_runs_with_jax_blocked():
    """The port imports nothing of JAX or of the JAX package: with both
    unimportable it still runs both branches of the slice, through both
    kernel wrappers, the CHIRP readout fused and host-fed (its table
    step), and a device replay (engine/replay.py) directly and through
    run_measurement, and loads no module of either."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["gpu_sdr_tpu"] = None
        import gpu_sdr_tpu_torch
        import numpy as np, torch
        torch.set_num_threads(2)
        from gpu_sdr_tpu_torch import measure
        from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams,
                                              UsrpParams, WaveType)
        from gpu_sdr_tpu_torch.engine.channel import IdealChannel
        from gpu_sdr_tpu_torch.engine.sinks import MemorySink
        freqs = [k * 1000 for k in range(-4, 4)]
        for ch in (None, IdealChannel()):
            p = UsrpParams()
            p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1_000_000,
                                     buffer_len=64_000, freq=freqs,
                                     ampl=[0.125] * 8,
                                     wave_type=[WaveType.TONES] * 8)
            p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                                    fft_tones=1000, pf_average=4,
                                    buffer_len=64_000, samples=128_000,
                                    freq=freqs,
                                    wave_type=[WaveType.TONES] * 8)
            s = MemorySink()
            measure.run_measurement(p, channel=ch, extra_sinks=[s],
                                    device="cpu")
            assert s.data.shape == (128, 8), s.data.shape
            np.testing.assert_allclose(abs(s.data[3:]), 0.125, rtol=1e-2)
            print(measure.last_dispatch()[0][1])
        for ch in (None, IdealChannel()):
            c = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
                     swipe_s=[128], wave_type=[WaveType.CHIRP])
            p = UsrpParams()
            p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1_000_000,
                                     buffer_len=64_000, ampl=[0.5], **c)
            p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                                    buffer_len=64_000, samples=128_000,
                                    decim=1, **c)
            s = MemorySink()
            measure.run_measurement(p, channel=ch, extra_sinks=[s],
                                    device="cpu")
            assert s.data.shape == (128, 1), s.data.shape
            np.testing.assert_allclose(abs(s.data), 0.5, rtol=1e-5)
            print(measure.last_dispatch()[0][2])
        # a recording replayed from device memory, through the replay
        # module directly and through run_measurement(source=...)
        from gpu_sdr_tpu_torch.engine import replay
        from gpu_sdr_tpu_torch.engine.sources import ArraySource
        x = np.exp(2j * np.pi * 1000 * np.arange(128_000) / 1_000_000)
        rx = AntennaParams(mode=AntMode.RX, rate=1_000_000, fft_tones=1000,
                           pf_average=4, buffer_len=64_000, samples=192_000,
                           freq=[1000], wave_type=[WaveType.TONES])
        dr = replay.DeviceReplay(rx, x.astype(np.complex64), device="cpu")
        s = MemorySink()
        dr.run([s])
        np.testing.assert_allclose(abs(s.data[3:]), 1.0, rtol=1e-2)
        print(dr.path)
        p = UsrpParams()
        p.A_RX2 = rx
        measure.run_measurement(p, source=ArraySource(x[:100_000]),
                                extra_sinks=[s], device="cpu")
        print(":".join(map(str, measure.last_dispatch()[0][1:])))
        assert sys.modules["jax"] is None
        assert sys.modules["gpu_sdr_tpu"] is None
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gpu_sdr_tpu")
                    and sys.modules[m] is not None]
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["fused_loopback", "host_pipeline",
                                  "chirp_wavetable", "None",
                                  "channelizer_at", "device_replay:scan"]


def test_kernel_wrappers_count_no_cpu_launch():
    """On the CPU a wrapper runs its plain version and counts nothing."""
    before = (channelizer.launches, presum.launches)
    measure.run_measurement(make_params(WaveType.TONES, 1),
                            extra_sinks=[MemorySink()], device="cpu")
    assert (channelizer.launches, presum.launches) == before


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.run_measurement(make_params(WaveType.TONES, 1),
                                extra_sinks=[MemorySink()], device="cuda")


def _dual(p):
    p.B_TXRX = AntennaParams(**{**p.A_TXRX.__dict__})
    p.B_RX2 = AntennaParams(**{**p.A_RX2.__dict__})


def _chirp_tx(p):
    """A CHIRP loopback on both front ends (the dual VNA): the CHIRP
    readout itself is ported (tests/test_torch_chirp_slice.py), two
    front ends are not."""
    for a in (p.A_TXRX, p.A_RX2):
        a.wave_type, a.freq = [WaveType.CHIRP], [1000]
        a.chirp_f, a.chirp_t = [2000], [0.1]
    p.A_TXRX.ampl, p.A_RX2.decim = [0.5], 10
    _dual(p)


def _mixed(p):
    p.A_RX2.wave_type[0] = WaveType.DIRECT
    p.A_RX2.decim = 100


@pytest.mark.parametrize("case, edit, kwargs", [
    ("hdf5", None, dict(filename="out.h5")),
    ("mesh", None, dict(mesh=object())),
    ("dual", _dual, {}),
    ("chirp_tx", _chirp_tx, dict(channel=IdealChannel())),
    ("mixed", _mixed, {}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_unported_branches_raise(case, edit, kwargs):
    p = make_params(WaveType.TONES, 1)
    if edit is not None:
        edit(p)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        measure.run_measurement(p, extra_sinks=[MemorySink()],
                                device="cpu", **kwargs)
