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
from gpu_sdr_tpu_torch.parallel import make_mesh

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
    step), a device replay (engine/replay.py) directly and through
    run_measurement, both again on a (2, 1) mesh of the CPU
    (parallel/), two front ends in lock-step (engine/dual.py) against
    their plan (engine/dispatch.py) and a checkpoint of their state
    (engine/checkpoint.py), their HDF5 file (client/files.py), a mixed
    DIRECT + CHIRP antenna through a trigger (client/triggers.py) into a
    file, the channel models and a NODSP stream over the socket ingest
    (server/native.py), and loads no module of either."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["gpu_sdr_tpu"] = None
        sys.modules["h5py"] = None          # the port writes HDF5 itself
        import gpu_sdr_tpu_torch
        import numpy as np, torch
        torch.set_num_threads(2)
        from gpu_sdr_tpu_torch.parallel import (distributed, host_ingest,
                                                rehearsal)
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
        # the sharded layer: a (2, 1) mesh of the CPU, fused and host-fed
        from gpu_sdr_tpu_torch.parallel import make_mesh
        mesh = make_mesh((2, 1), devices=["cpu"] * 2)
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
                                    mesh=mesh)
            assert s.data.shape == (128, 8), s.data.shape
            np.testing.assert_allclose(abs(s.data[3:]), 0.125, rtol=1e-2)
            print(":".join(map(str, measure.last_dispatch()[0][1:])))
        # two front ends in lock-step, the dispatch plan, a checkpoint
        from gpu_sdr_tpu_torch.engine import dispatch, dual
        from gpu_sdr_tpu_torch.engine.checkpoint import (load_state,
                                                         save_state)
        p.B_TXRX = AntennaParams(**p.A_TXRX.__dict__)
        p.B_RX2 = AntennaParams(**p.A_RX2.__dict__)
        plan = [d.key() for d in dispatch.plan_dispatch(p)]
        s = MemorySink()
        measure.run_measurement(p, extra_sinks=[s], device="cpu")
        assert plan == list(measure.last_dispatch()), plan
        print(":".join(map(str, measure.last_dispatch()[1][1:])))
        d = dual.DualFused(dual.plan_dual(p), device="cpu")
        st, _ = d.step(d.init_state())
        import tempfile, os
        with tempfile.TemporaryDirectory() as tmp:
            save_state(st, os.path.join(tmp, "c"), block_index=1)
            st2, k = load_state(os.path.join(tmp, "c"), d.init_state())
        assert k == 1 and all(torch.equal(a, b) for a, b in zip(st, st2))
        # HDF5 output, triggers, mixed wave types, NODSP, the channel
        # models and socket ingest (client/, engine/, server/native.py)
        import socket, threading
        from gpu_sdr_tpu_torch.client import files, triggers
        from gpu_sdr_tpu_torch.engine import channel
        from gpu_sdr_tpu_torch.engine.ingest import SocketIngestSource
        with tempfile.TemporaryDirectory() as tmp:
            fn = measure.run_measurement(p, filename=os.path.join(tmp, "m"),
                                         device="cpu", note="blocked")
            assert files.openH5file(fn, front_end="B_RX2").shape == (8, 128)
            rx = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                               buffer_len=50_000, samples=100_000, decim=100,
                               freq=[1000, -300_000], chirp_f=[0, 300_000],
                               chirp_t=[0.0, 0.1], swipe_s=[0, 1000],
                               wave_type=[WaveType.DIRECT, WaveType.CHIRP])
            q = UsrpParams()
            q.A_RX2 = rx
            ch = channel.ChainChannel([channel.DelayChannel(10),
                                       channel.DropoutChannel(1e6, seed=1)])
            fn = measure.run_measurement(
                q, filename=os.path.join(tmp, "x"), device="cpu",
                source=ArraySource(x[:100_000]),
                trigger=triggers.deriv_test())
            print(measure.last_dispatch()[0][1], files.mixed_streams(fn)[1][0])
            q.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                                    buffer_len=50_000, samples=100_000,
                                    wave_type=[WaveType.NODSP])
            raw = (x[:100_000] * ch.channels[0](x[:100_000])).astype(
                np.complex64)
            with SocketIngestSource(block_len=50_000, timeout=30.0) as src:
                def send():
                    with socket.create_connection(("127.0.0.1", src.port),
                                                  timeout=30) as c:
                        c.sendall(raw.tobytes())
                th = threading.Thread(target=send, daemon=True)
                th.start()
                s = MemorySink()
                measure.run_measurement(q, source=src, extra_sinks=[s],
                                        device="cpu")
                th.join(timeout=30)
            assert np.array_equal(s.data[:, 0], raw)
            print(measure.last_dispatch()[0][1])
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
                                  "channelizer_at", "device_replay:scan",
                                  "sharded_fused:channelizer_wavetable",
                                  "host_pipeline:None",
                                  "dual_fused:channelizer_wavetable",
                                  "host_pipeline_mixed", "mixed_1",
                                  "host_pipeline"]


def test_multihost_runs_with_jax_blocked(tmp_path):
    """Two ranks of the rehearsal (parallel/rehearsal.py) on gloo over
    127.0.0.1, each with jax, the JAX package and h5py unimportable: the
    PFB / chirp families (the halo ring, the psum, the gather across the
    processes) and the per-host ingest with its abort, every rank's
    gathered outputs the same; neither loads a module of JAX."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["gpu_sdr_tpu"] = None
        sys.modules["h5py"] = None
        from gpu_sdr_tpu_torch.parallel import rehearsal
        rc = rehearsal.main(sys.argv[1:])
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gpu_sdr_tpu", "h5py")
                    and sys.modules[m] is not None]
        sys.exit(rc)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, "--init", f"tcp://127.0.0.1:{port}",
         "--world", "2", "--rank", str(r), "--mesh", "2x2", "--devices",
         "cpu*2", "--backend", "gloo", "--timeout", "60", "--phases",
         "families,ingest", "--out", str(tmp_path)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    a, b = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert sorted(a.files) == ["chirp", "ingest", "ingest_abort",
                               "noise_decim", "tones"]
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_server_runs_with_jax_blocked(tmp_path):
    """With jax, the JAX package, h5py and matplotlib unimportable, the
    port's facade imports and the port's Server (on the CPU, the native
    streamer) serves one measurement to the port's Connection over
    127.0.0.1, Packets_to_file writing it through client/h5.py; no
    module of the four loads."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "gpu_sdr_tpu", "h5py", "matplotlib"):
            sys.modules[m] = None
        import threading
        import numpy as np, torch
        torch.set_num_threads(2)
        import gpu_sdr_tpu_torch.pyusrp as u
        from gpu_sdr_tpu_torch.server.main import Server
        srv = Server(async_port=0, data_port=0, host="127.0.0.1",
                     device="cpu")
        srv.start()
        th = threading.Thread(target=lambda: srv.serve_one(timeout=60),
                              daemon=True)
        th.start()
        try:
            assert u.Connect(host="127.0.0.1", async_port=srv.ports[0],
                             sync_port=srv.ports[1])
            p = u.global_parameter()
            p.A_TXRX = u.AntennaParams(
                mode=u.AntMode.TX, rate=1_000_000, buffer_len=100_000,
                samples=200_000, freq=[50_000], ampl=[0.5],
                wave_type=[u.WaveType.TONES], delay=1.0)
            p.A_RX2 = u.AntennaParams(
                mode=u.AntMode.RX, rate=1_000_000, buffer_len=100_000,
                samples=200_000, decim=100, pf_average=4, freq=[50_000],
                wave_type=[u.WaveType.DIRECT], delay=1.0)
            conn = u.get_connection()
            conn.send_params(p)
            fn = u.Packets_to_file(conn, p, filename="served",
                                   progress=False, timeout=60)
            th.join(timeout=60)
            assert not th.is_alive()
            sent = srv.sync.stats["packets_sent"]
        finally:
            u.Disconnect()
            srv.close()
        data = u.openH5file(fn)
        assert data.shape == (1, 2000), data.shape
        np.testing.assert_allclose(abs(data[0, 8:]), 0.5, atol=2e-3)
        print(type(srv.sync).__name__, sent)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gpu_sdr_tpu", "h5py",
                                           "matplotlib")
                    and sys.modules[m] is not None]
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["NativeSyncServer", "2"]


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
    """A CHIRP loopback on both front ends (the dual VNA)."""
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
    ("mixed", _mixed, {}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_unported_branches_raise(monkeypatch, tmp_path, case, edit, kwargs):
    """The two branches that raised before ROADMAP Queue 1 item 3 was
    ported now run as in JAX: HDF5 output (the same file, its name
    returned) and mixed wave types (the same dispatch, group 0's packets
    to the extra sinks at >= 90 dB against JAX's).  Beside them
    amplitude_trigger(vna=...), which raised until the resonator fit
    (item 3b) was ported, loads JAX's fit parameters and calibration
    from a fitted VNA file; a second chirp on a mixed antenna still
    raises, as the reference refuses it too."""
    from test_torch_files import assert_same_file
    from gpu_sdr_tpu_torch.client import triggers
    from gpu_sdr_tpu_torch.engine import make_demodulator
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    out = []
    for run, sink, kw in ((jmeasure.run_measurement, JMemorySink(), {}),
                          (measure.run_measurement, MemorySink(),
                           dict(device="cpu"))):
        p = make_params(WaveType.TONES, 1)
        if edit is not None:
            edit(p)
        side = tmp_path / ("torch" if kw else "jax")
        side.mkdir()
        monkeypatch.chdir(side)
        fn = run(p, extra_sinks=[sink], **kwargs, **kw)
        disp = (measure if kw else jmeasure).last_dispatch()
        out.append((fn, disp, sink.data))
    (jfn, jdisp, jdata), (fn, disp, data) = out
    assert disp == jdisp
    assert data.shape == jdata.shape
    assert golden.snr_db(jdata, data) >= 90.0
    if case == "hdf5":
        assert (jfn, fn) == ("out.h5", "out.h5")
        assert_same_file(str(tmp_path / "jax" / jfn),
                         str(tmp_path / "torch" / fn))
        from gpu_sdr_tpu.client import fitting as jfit
        from gpu_sdr_tpu.client import triggers as jtriggers
        from gpu_sdr_tpu.client import vna as jvna
        from gpu_sdr_tpu.engine.channel import make_resonator_channel
        jvna.LINE_DELAY["1"] = 512e-6 * 1e9
        try:
            vna = jvna.Single_VNA(
                start_f=-400_000, last_f=400_000, measure_t=0.2,
                n_points=800, tx_gain=0, Rate=RATE, RF=10_000_000,
                output_filename="vna", channel=make_resonator_channel(
                    RATE, [dict(f0=150_000.0, Qr=25.0, Qe_re=50.0)],
                    fft_len=1 << 12))
        finally:
            jvna.LINE_DELAY.clear()
        jvna.VNA_analysis(vna)
        assert jfit.initialize_peaks(vna, N_peaks=1, peak_width=50e3,
                                     Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                     exclude_center=False)
        jfit.vna_fit(vna, fit_range=60e3)
        jt = jtriggers.amplitude_trigger(sample_rate=RATE, threshold=3.0,
                                         vna=vna)
        tt = triggers.amplitude_trigger(sample_rate=RATE, threshold=3.0,
                                        vna=vna)
        assert len(tt.fit_params) == 1 and tt.fit_params == jt.fit_params
        assert tt.cal == jt.cal > 0
    else:
        assert disp == (("A_RX2", "host_pipeline_mixed", None),)
        assert (jfn, fn) == (None, None)
        p = make_params(WaveType.TONES, 1)
        _mixed(p)
        p.A_RX2.wave_type[1:3] = [WaveType.CHIRP] * 2
        p.A_RX2.chirp_f = [0, 10_000, 20_000]
        p.A_RX2.chirp_t = [0.0, 0.1, 0.1]
        with pytest.raises(NotImplementedError, match="matches reference"):
            make_demodulator(p.A_RX2, "cpu")


def _edited(edit):
    """make_params(TONES, 2) with `edit`."""
    p = make_params(WaveType.TONES, 2)
    edit(p)
    return p


@pytest.mark.parametrize("case, edit, mesh_shape, channel, want", [
    ("dual", _dual, None, False,
     ("dual_fused", "channelizer_wavetable")),
    ("mesh", _dual, (2, 1), False,
     ("dual_sharded_fused", "channelizer_wavetable")),
    ("chirp_tx", _chirp_tx, None, True, ("host_pipeline", None)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_two_front_ends_match_jax(monkeypatch, case, edit, mesh_shape,
                                  channel, want):
    """The edits that raised before the dual front ends were ported:
    both front ends in lock-step (on a (2, 1) CPU mesh too), and the
    dual VNA through a channel model, one front end after the other;
    each front end within 90 dB of the JAX package's."""
    from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(
        _edited(edit), extra_sinks=[js],
        channel=JIdealChannel() if channel else None,
        mesh=jmake_mesh(mesh_shape, ("time", "channels"))
        if mesh_shape else None)
    jdisp = jmeasure.last_dispatch()
    kw = (dict(mesh=make_mesh(mesh_shape, devices=["cpu"] * 2))
          if mesh_shape else dict(device="cpu"))
    measure.run_measurement(_edited(edit), extra_sinks=[ts],
                            channel=IdealChannel() if channel else None,
                            **kw)
    disp = measure.last_dispatch()
    assert disp == (("A_RX2",) + want, ("B_RX2",) + want)
    assert [d[:2] for d in disp] == [d[:2] for d in jdisp]
    codes = sorted({m.front_end_code for m in ts.metas})
    assert codes == sorted({m.front_end_code for m in js.metas})
    for code in codes:
        def stream(sink):
            return np.concatenate([d for m, d in zip(sink.metas,
                                                     sink.packets)
                                   if m.front_end_code == code])
        j, t = stream(js), stream(ts)
        assert t.shape == j.shape and len(t)
        assert golden.snr_db(j, t) > 90.0
