"""The port's device-resident replay (gpu_sdr_tpu_torch/engine/replay.py)
on the CPU, against the JAX package's DeviceReplay (Pallas in interpret
mode, GPU_SDR_TPU_PALLAS=1) on the same sub-path and against the port's
own host-fed run_pipeline over the same recording.

Bars: ``scan`` bit-equal to host-fed (tests/test_device_replay.py:28-48);
the kernel sub-paths at 90 dB SNR (tests/test_device_replay.py:121), the
JAX channelizer_at, whose constants are a bf16 hi/lo split, at its own
85 dB (tests/test_device_replay.py:215).  Where the port and the JAX
package choose different sub-paths (ROADMAP Queue 3), the choice is
pinned and the outputs still agree.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine.replay import DeviceReplay as JDeviceReplay
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.engine.sources import ReplaySource as JReplaySource
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import convert, measure
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine import replay
from gpu_sdr_tpu_torch.engine.replay import DeviceReplay
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import (ArraySource, ReplaySource,
                                              WhiteNoiseSource)
from gpu_sdr_tpu_torch.ops.channelizer import channelizer_at
from gpu_sdr_tpu_torch.ops.lockin_at import lockin_at
from gpu_sdr_tpu_torch.ops.presum import presum_at

torch.set_num_threads(2)

RATE = 1_000_000
CHIRP = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
             swipe_s=[128], wave_type=[WaveType.CHIRP])
F10 = [int(f) for f in np.linspace(-400_000, 400_000, 10)]


def rx_of(kind, blocks):
    """An RX antenna of each kind, acquiring `blocks` planned blocks."""
    def rx(block, **kw):
        return AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=block,
                             samples=blocks * block, **kw)
    direct = dict(decim=10, pf_average=4)
    return {
        "direct2": lambda: rx(50_000, freq=[100_000, -250_000],
                              wave_type=[WaveType.DIRECT] * 2, **direct),
        "direct10": lambda: rx(50_000, freq=F10,
                               wave_type=[WaveType.DIRECT] * 10, **direct),
        "tones": lambda: rx(128_000, fft_tones=1000, pf_average=4,
                            freq=[50_000, -200_000],
                            wave_type=[WaveType.TONES] * 2),
        "noise": lambda: rx(128_000, fft_tones=1000, pf_average=4,
                            freq=[0], wave_type=[WaveType.NOISE]),
        "noise1009": lambda: rx(64 * 1009, fft_tones=1009, pf_average=4,
                                freq=[0], wave_type=[WaveType.NOISE]),
        "noise1018": lambda: rx(64 * 1018, fft_tones=1018, pf_average=4,
                                freq=[0], wave_type=[WaveType.NOISE]),
        "tones500": lambda: rx(100_000, fft_tones=500, pf_average=4,
                               freq=[50_000], wave_type=[WaveType.TONES]),
        "noise4096": lambda: rx(4096 * 64, fft_tones=4096, pf_average=4,
                                freq=[0], wave_type=[WaveType.NOISE]),
        "chirp64k": lambda: rx(64_000, decim=1, **CHIRP),
        "chirp96k": lambda: rx(96_000, decim=1, **CHIRP),
        "chirp60k": lambda: rx(60_000, decim=1, **CHIRP),
    }[kind]()


def rec_of(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def port_replay(rx, rec, loop=True):
    dr = DeviceReplay(rx, rec, loop=loop, device="cpu")
    sink = MemorySink()
    res = dr.run([sink])
    assert res.n_blocks == dr.demod.plan.n_blocks
    return dr.path, sink.data


def jax_replay(rx, rec, loop=True):
    dr = JDeviceReplay(rx, rec, blocks_per_exec=2, loop=loop)
    sink = JMemorySink()
    dr.run([sink])
    return dr.path, sink.data


def host_fed(rx, source):
    sink = MemorySink()
    run_pipeline(make_demodulator(rx, "cpu"), source, [sink])
    return sink.data


def saved(tmp_path, rec, loop, name="rec.npy"):
    path = str(tmp_path / name)
    np.save(path, rec) if name.endswith(".npy") else rec.tofile(path)
    return ReplaySource(path, loop=loop)


@pytest.mark.parametrize("rec_len, loop, path", [
    (60_000, False, "scan"),      # recording shorter than the acquisition
    (55_000, False, "scan"),      # partial tail block, then zeros
    (50_000, True, "replay_kernel_t"),    # looped, whole blocks
])
def test_replay_matches_host_fed_and_jax(monkeypatch, tmp_path, rec_len,
                                         loop, path):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    rx = rx_of("direct2", 2)
    rec = rec_of(rec_len)
    got, data = port_replay(rx, rec, loop)
    host = host_fed(rx, saved(tmp_path, rec, loop))
    assert got == path and data.shape == host.shape == (10_000, 2)
    if path == "scan":
        assert np.array_equal(data, host), "scan must bit-match host-fed"
    else:
        assert golden.snr_db(host, data) > 90.0
    jpath, jdata = jax_replay(rx, rec, loop)
    assert jpath == path
    assert golden.snr_db(jdata, data) > 90.0


@pytest.mark.parametrize("kind, rec_blocks, blocks, path, jax_bar", [
    ("direct10", 2, 4, "replay_kernel", 90.0),
    ("tones", 2, 3, "channelizer_at", 85.0),
    ("noise", 2, 3, "channelizer_at", 85.0),
    ("noise1009", 2, 3, "pfb_at", 90.0),
    # 3 blocks of a 2-block period: the oscillator wraps mod 2, the
    # recording mod 3 (o != i)
    ("chirp64k", 3, 10, "chirp_table", 90.0),
    ("chirp96k", 2, 6, "chirp_at", 90.0),
])
def test_sub_path_matches_jax_and_host_fed(monkeypatch, tmp_path, kind,
                                           rec_blocks, blocks, path,
                                           jax_bar):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    rx = rx_of(kind, blocks)
    L = make_demodulator(rx, "cpu").plan.block_len
    rec = rec_of(rec_blocks * L, seed=len(kind))
    got, data = port_replay(rx, rec)
    assert got == path
    channels = len(rx.freq) if rx.wave_type[0] != WaveType.NOISE \
        else int(rx.fft_tones)
    assert data.shape[1] == channels
    host = host_fed(rx, saved(tmp_path, rec, True))
    assert data.shape == host.shape
    assert golden.snr_db(host, data) > 90.0
    jpath, jdata = jax_replay(rx, rec)
    assert jpath == path and jdata.shape == data.shape
    assert golden.snr_db(jdata, data) > jax_bar


def jax_state_after(jdr, n_exec):
    """The JAX replay's carry after n_exec executions, and the blocks of
    the next execution."""
    import jax.numpy as jnp
    st = (jdr._kernel_state_init() if jdr._kernel_path is not None
          else jdr.demod.init_state())
    idx = jnp.int32(0)
    for _ in range(n_exec):
        st, idx, _ = jdr._multi(st, idx, jdr._Xarg)
    return (st, idx), jcplx.to_np(jdr._multi(st, idx, jdr._Xarg)[2])


@pytest.mark.parametrize("kind, loop, path, to_port", [
    ("direct2", True, "replay_kernel_t",
     lambda c: convert.replay_state(c[0], "cpu")),
    ("tones", True, "channelizer_at", convert.replay_at_state),
    ("noise1009", True, "pfb_at", convert.replay_at_state),
    ("chirp64k", True, "chirp_table", convert.replay_chirp_table_state),
    ("chirp96k", True, "chirp_at", convert.replay_chirp_at_state),
    ("direct2", False, "scan", lambda c: convert.replay_scan_state(
        c, lambda s: convert.ddc_state(s, "cpu"))),
])
def test_convert_continues_jax_replay(monkeypatch, kind, loop, path,
                                      to_port):
    """A replay the JAX package started continues in the port: after two
    blocks of JAX's, the port's next two blocks from the converted state
    equal JAX's next two."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    rx = rx_of(kind, 6)
    L = make_demodulator(rx, "cpu").plan.block_len
    rec = rec_of(3 * L - (0 if loop else L // 2), seed=7)
    jdr = JDeviceReplay(rx, rec, blocks_per_exec=2, loop=loop)
    dr = DeviceReplay(rx, rec, loop=loop, device="cpu")
    assert jdr.path == dr.path == path
    carry, want = jax_state_after(jdr, 1)
    state = to_port(carry)
    for k in range(2):
        state, y = dr.step(state)
        assert golden.snr_db(want[k], y.numpy()) > \
            (85.0 if path == "channelizer_at" else 90.0), k


def params_with(rx):
    p = UsrpParams()
    p.A_RX2 = rx
    return p


@pytest.mark.parametrize("kind, rec_blocks, blocks, loop, sub", [
    ("direct2", 2, 4, True, "replay_kernel_t"),
    ("direct2", 2, 3, False, "scan"),
    ("tones", 1, 2, True, "channelizer_at"),
    ("chirp64k", 2, 3, True, "chirp_table"),
])
def test_run_measurement_dispatches_as_jax(monkeypatch, tmp_path, kind,
                                           rec_blocks, blocks, loop, sub):
    """run_measurement(source=ReplaySource) records the JAX package's
    dispatch, (rx, "device_replay", sub-path), and its data."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    L = make_demodulator(rx_of(kind, 1), "cpu").plan.block_len
    rec = rec_of(rec_blocks * L)
    path = str(tmp_path / "rec.npy")
    np.save(path, rec)
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(params_with(rx_of(kind, blocks)), None,
                             source=JReplaySource(path, loop=loop),
                             extra_sinks=[js])
    measure.run_measurement(params_with(rx_of(kind, blocks)),
                            source=ReplaySource(path, loop=loop),
                            extra_sinks=[ts], device="cpu")
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "device_replay", sub),)
    assert ts.data.shape == js.data.shape
    assert [m.packet_number for m in ts.metas] == list(range(blocks))
    assert golden.snr_db(js.data, ts.data) > \
        (85.0 if sub == "channelizer_at" else 90.0)


def test_budget_gate(monkeypatch, tmp_path):
    """Over the device budget a recording takes segmented_replay, with
    the same data; a source without a recording is no replay."""
    rx = rx_of("direct2", 3)
    rec = rec_of(100_000)
    src = saved(tmp_path, rec, False, name="rec.c64")    # raw complex64
    assert replay.can_device_replay(src)
    assert not replay.can_segmented_replay(src)
    sinks = MemorySink(), MemorySink()
    measure.run_measurement(params_with(rx), source=src,
                            extra_sinks=[sinks[0]], device="cpu")
    assert measure.last_dispatch() == (("A_RX2", "device_replay", "scan"),)
    monkeypatch.setattr(replay, "DEVICE_REPLAY_MAX_BYTES", rec.size * 8 - 1)
    assert not replay.can_device_replay(src)
    assert replay.can_segmented_replay(src)
    measure.run_measurement(params_with(rx_of("direct2", 3)), source=src,
                            extra_sinks=[sinks[1]], device="cpu")
    assert measure.last_dispatch() == (("A_RX2", "segmented_replay", None),)
    assert np.array_equal(sinks[0].data, sinks[1].data)
    for other in (WhiteNoiseSource(), ArraySource(np.zeros(0, np.complex64))):
        assert not replay.can_device_replay(other)
        assert not replay.can_segmented_replay(other)


@pytest.mark.parametrize("case", ["partial_loop", "noise", "channel"])
def test_other_sources_are_host_fed_as_in_jax(monkeypatch, tmp_path, case):
    """A looped recording that is not whole blocks, a source that is no
    recording, and a recording through a channel model all feed the
    host pipeline, in both packages."""
    from gpu_sdr_tpu.engine.channel import IdealChannel as JIdealChannel
    from gpu_sdr_tpu.engine.sources import WhiteNoiseSource as JNoise
    from gpu_sdr_tpu_torch.engine.channel import IdealChannel
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    path = str(tmp_path / "rec.npy")
    np.save(path, rec_of(75_000))
    srcs = {"partial_loop": (JReplaySource(path, loop=True),
                             ReplaySource(path, loop=True), None, None),
            "noise": (JNoise(seed=4), WhiteNoiseSource(seed=4), None, None),
            "channel": (JReplaySource(path), ReplaySource(path),
                        JIdealChannel(), IdealChannel())}
    jsrc, src, jch, ch = srcs[case]
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(params_with(rx_of("direct2", 3)), None,
                             channel=jch, source=jsrc, extra_sinks=[js])
    measure.run_measurement(params_with(rx_of("direct2", 3)), channel=ch,
                            source=src, extra_sinks=[ts], device="cpu")
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "host_pipeline", None),)
    assert golden.snr_db(js.data, ts.data) > 90.0


@pytest.mark.parametrize("case", [
    "nfft500", "nfft4096", "chirp_segments", "no_pallas", "nfft1018"])
def test_divergence_from_jax(monkeypatch, case):
    """Where the port and the JAX package choose different sub-paths
    (ROADMAP Queue 3), both still compute the same readout:

    * nfft 500 at a 100k block and nfft 4096 (n1 = 64 > 16): JAX pfb_at,
      port channelizer_at (its kernel takes these splits);
    * chirp blocks of 60 segments (not a multiple of 8): JAX scan, port
      chirp_at;
    * JAX without its Pallas switch: scan for every recording; the port
      has no switch;
    * nfft 1018 (split 2 x 509, G_k1 over one block's shared memory):
      JAX channelizer_at, port pfb_at."""
    kind, ours, theirs, pallas = {
        "nfft500": ("tones500", "channelizer_at", "pfb_at", "1"),
        "nfft4096": ("noise4096", "channelizer_at", "pfb_at", "1"),
        "chirp_segments": ("chirp60k", "chirp_at", "scan", "1"),
        "no_pallas": ("direct2", "replay_kernel_t", "scan", "0"),
        "nfft1018": ("noise1018", "pfb_at", "channelizer_at", "1"),
    }[case]
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", pallas)
    rx = rx_of(kind, 3)
    L = make_demodulator(rx, "cpu").plan.block_len
    rec = rec_of(2 * L)
    path, data = port_replay(rx, rec)
    jpath, jdata = jax_replay(rx, rec)
    assert (path, jpath) == (ours, theirs)
    assert golden.snr_db(jdata, data) > \
        (85.0 if "channelizer_at" in (ours, theirs) else 90.0)


def test_upload_reads_a_memmap_in_chunks(monkeypatch, tmp_path):
    """A raw recording is mapped, not read, and uploaded in chunks: the
    resident copy equals the file, zero-padded past its end."""
    rec = rec_of(10_007)
    src = saved(tmp_path, rec, False, name="rec.c64")
    assert isinstance(src.data, np.memmap)
    monkeypatch.setattr(replay, "UPLOAD_CHUNK", 1000)
    X = replay.upload(src.data, "cpu", 12_000)
    assert np.array_equal(X[:10_007].numpy(), rec)
    assert not X[10_007:].any()


def test_device_replay_refuses_and_counts_no_cpu_launch():
    """A looped recording must be whole blocks; on the CPU no kernel
    launch is counted."""
    with pytest.raises(ValueError, match="whole blocks"):
        DeviceReplay(rx_of("direct2", 2), rec_of(75_000), loop=True,
                     device="cpu")
    before = (channelizer_at.launches, presum_at.launches,
              lockin_at.launches)
    for kind in ("tones", "noise1009", "chirp96k"):
        rx = rx_of(kind, 2)
        L = make_demodulator(rx, "cpu").plan.block_len
        port_replay(rx, rec_of(L))
    assert (channelizer_at.launches, presum_at.launches,
            lockin_at.launches) == before
