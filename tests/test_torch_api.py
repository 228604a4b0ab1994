"""The small public-API pieces the port gained beside its workflow
scripts, against the JAX package's, on the CPU:

* ``UsrpParams`` / ``AntennaParams`` helpers: ``effective_rate``,
  ``get_output_buffer_size``, ``dynamic_buffer``, ``get_number``,
  ``is_A_active``, ``is_B_active``, each equal to JAX's on every wave
  type and antenna layout;
* the window builders ``sinc_window``, ``hamming_window`` and
  ``flat_window`` (exported from ``ops`` as JAX's are), bit for bit
  JAX's at float32 and float64;
* ``config.maybe_profile``: a torch.profiler trace of
  ``run_measurement`` written under GPU_SDR_TPU_PROFILE on the CPU,
  nothing when it is unset, and a trace that cannot start raising with
  the directory named (divergence 38: JAX's runs untraced);
* the open fault's hunt (ROADMAP Queue 3): the host-fed CHIRP case's
  chirp blocks and lock-in points are bit for bit the same whether
  PyTorch's intra-op pool splits a 64,000-sample op in two chunks or
  runs it whole, from one thread or from several at once.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import params as jp
from gpu_sdr_tpu.ops import windows as jw
from gpu_sdr_tpu_torch import params as tp
from gpu_sdr_tpu_torch.ops import windows as tw

torch.set_num_threads(2)


def antennas(P):
    W = P.WaveType
    base = dict(rate=1_000_000, buffer_len=64_000, freq=[1000, -2000])
    return [
        P.AntennaParams(mode=P.AntMode.RX, decim=100,
                        wave_type=[W.DIRECT] * 2, **base),
        P.AntennaParams(mode=P.AntMode.RX, decim=0,
                        wave_type=[W.DIRECT] * 2, **base),
        P.AntennaParams(mode=P.AntMode.RX, fft_tones=1000, decim=0,
                        wave_type=[W.TONES] * 2, **base),
        P.AntennaParams(mode=P.AntMode.RX, fft_tones=1000, decim=4,
                        wave_type=[W.TONES] * 2, **base),
        P.AntennaParams(mode=P.AntMode.RX, fft_tones=100, decim=2,
                        wave_type=[W.NOISE], rate=1_000_000,
                        buffer_len=64_000)] + [
        P.AntennaParams(mode=P.AntMode.RX, rate=1_000_000,
                        buffer_len=64_000, freq=[-300_000],
                        chirp_f=[300_000], chirp_t=[0.128], swipe_s=[128],
                        decim=d, wave_type=[W.CHIRP])
        for d in (1, 5)] + [
        P.AntennaParams(mode=P.AntMode.RX, rate=1_000_000, freq=[-300_000],
                        chirp_f=[300_000], chirp_t=[0.1], swipe_s=[],
                        decim=0, wave_type=[W.CHIRP]),
        P.AntennaParams(mode=P.AntMode.RX, wave_type=[W.NODSP], rate=5,
                        buffer_len=0),
        P.AntennaParams(mode=P.AntMode.TX, wave_type=[W.TONES, W.TONES],
                        **base),
        P.AntennaParams(mode=P.AntMode.TX, wave_type=[W.TONES, W.CHIRP],
                        **base),
        P.AntennaParams()]


def test_antenna_helpers_match_jax():
    for a, b in zip(antennas(jp), antennas(tp)):
        assert b.effective_rate() == a.effective_rate()
        assert b.get_output_buffer_size() == a.get_output_buffer_size()
        assert b.dynamic_buffer() == a.dynamic_buffer()


def test_usrp_helpers_match_jax():
    layouts = [(), ("A_RX2",), ("A_TXRX", "B_RX2"), ("B_TXRX",),
               ("A_TXRX", "A_RX2", "B_TXRX", "B_RX2")]
    for on in layouts:
        ups = []
        for P in (jp, tp):
            u = P.UsrpParams()
            for n in on:
                mode = P.AntMode.TX if "TX" in n else P.AntMode.RX
                setattr(u, n, P.AntennaParams(mode=mode))
            ups.append(u)
        a, b = ups
        for m in ("OFF", "RX", "TX"):
            assert b.get_number(tp.AntMode[m]) == a.get_number(jp.AntMode[m])
        assert (b.is_A_active(), b.is_B_active()) == (a.is_A_active(),
                                                      a.is_B_active())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_builders_match_jax(dtype):
    from gpu_sdr_tpu_torch import ops
    assert (ops.sinc_window, ops.hamming_window, ops.flat_window) == (
        tw.sinc_window, tw.hamming_window, tw.flat_window)
    for n in (1, 2, 7, 100, 4000):
        for fc in (0.5 / max(n, 1), 0.1, 0.375 / 100):
            a = jw.sinc_window(n, fc, dtype=dtype)
            b = tw.sinc_window(n, fc, dtype=dtype)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for side in sorted({0, min(1, n - 1), n // 10, n - 1}):
            for name in ("hamming_window", "flat_window"):
                a = getattr(jw, name)(n, side, dtype=dtype)
                b = getattr(tw, name)(n, side, dtype=dtype)
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (name, n, side)
    assert np.array_equal(tw.hamming_window(64, dtype=dtype),
                          jw.hamming_window(64, dtype=dtype))
    assert np.array_equal(tw.pfb_window(64, 4, dtype=dtype),
                          jw.pfb_window(64, 4, dtype=dtype))


def small_measurement():
    p = tp.UsrpParams()
    W = tp.WaveType
    p.A_TXRX = tp.AntennaParams(mode=tp.AntMode.TX, rate=1_000_000,
                                buffer_len=64_000, freq=[1000],
                                ampl=[0.5], wave_type=[W.TONES])
    p.A_RX2 = tp.AntennaParams(mode=tp.AntMode.RX, rate=1_000_000,
                               buffer_len=64_000, samples=128_000,
                               freq=[1000], decim=100,
                               wave_type=[W.DIRECT])
    return p


def test_maybe_profile_traces_run_measurement(tmp_path, monkeypatch):
    from gpu_sdr_tpu_torch import measure
    from gpu_sdr_tpu_torch.config import maybe_profile
    from gpu_sdr_tpu_torch.engine.sinks import MemorySink
    monkeypatch.delenv("GPU_SDR_TPU_PROFILE", raising=False)
    with maybe_profile("x", "cpu") as m:
        pass
    assert m.path is None and not os.listdir(tmp_path)

    monkeypatch.setenv("GPU_SDR_TPU_PROFILE", str(tmp_path / "prof"))
    s = MemorySink()
    measure.run_measurement(small_measurement(), extra_sinks=[s],
                            device="cpu")
    assert s.data.shape == (1280, 1)
    (trace,) = (tmp_path / "prof" / "measurement").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]


def test_divergence_38_maybe_profile_raises(tmp_path, monkeypatch):
    """A trace that cannot start raises, naming the directory (JAX's
    runs untraced)."""
    from gpu_sdr_tpu_torch import measure
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv("GPU_SDR_TPU_PROFILE", str(blocker))
    with pytest.raises(RuntimeError, match="cannot start a trace under "
                       + repr(str(blocker / "measurement"))):
        measure.run_measurement(small_measurement(), device="cpu")


def test_open_fault_chirp_bits_ignore_the_chunk_split():
    """The host-fed CHIRP case of test_slice_runs_with_jax_blocked
    (64,000-sample blocks, ppt 1000: PyTorch's intra-op pool splits its
    elementwise ops in two chunks of 32 segments at two threads): its TX
    blocks and lock-in points are the same bits at one thread and at
    two, and from three threads at once beside a fourth busy with
    matmuls and sines."""
    from gpu_sdr_tpu_torch.ops import chirp
    from gpu_sdr_tpu_torch.ops.lockin import lockin_profile
    from gpu_sdr_tpu_torch.ops.lockin_table import lockin_table
    rx = tp.AntennaParams(mode=tp.AntMode.RX, rate=1_000_000,
                          buffer_len=64_000, freq=[-300_000],
                          chirp_f=[300_000], chirp_t=[0.128],
                          swipe_s=[128], decim=1,
                          wave_type=[tp.WaveType.CHIRP])
    cfg, L = chirp.chirp_config(rx), 64_000
    profile = torch.from_numpy(lockin_profile(1000))
    table = chirp.chirp_period_table(cfg, L, 1000, device="cpu")

    def points(b):
        x = chirp.chirp_block(cfg, b * L, L, scale=0.5, device="cpu")[1]
        return x, lockin_table(profile, table, x.reshape(64, 1000), b, 0,
                               64)

    ref = [points(b) for b in range(2)]
    for x, y in ref:
        np.testing.assert_allclose(y.abs().numpy(), 0.5, rtol=1e-6)
    torch.set_num_threads(1)
    try:
        one = [points(b) for b in range(2)]
    finally:
        torch.set_num_threads(2)
    stop, bad = threading.Event(), []

    def busy():
        a = torch.randn(400, 400)
        while not stop.is_set():
            torch.sin(a @ a)

    def feeder():
        for _ in range(10):
            for b in range(2):
                x, y = points(b)
                if not (torch.equal(x, ref[b][0]) and
                        torch.equal(y, ref[b][1])):
                    bad.append(b)
    t = threading.Thread(target=busy)
    t.start()
    try:
        fs = [threading.Thread(target=feeder) for _ in range(3)]
        for f in fs:
            f.start()
        for f in fs:
            f.join()
    finally:
        stop.set()
        t.join()
    for (x1, y1), (x2, y2) in zip(one, ref):
        assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert bad == []
