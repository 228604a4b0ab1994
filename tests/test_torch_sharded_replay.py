"""The port's device replay under a mesh (gpu_sdr_tpu_torch/parallel/
sharded_replay.py) against the JAX package's (gpu_sdr_tpu/parallel/
sharded_replay.py): each sub-path (``replay_kernel``, ``channelizer_at``,
``scan``) on the mesh shapes the JAX tests use, the loop seam,
``ShardedSegmentedReplay``, the ``run_measurement(mesh=..., source=...)``
dispatch with its path and sub-path, and a replay state carried from JAX
in mid-stream.  The JAX side runs its kernels in interpret mode
(GPU_SDR_TPU_PALLAS=1) where its gates need them.

Bars: 90 dB SNR against JAX and the host-fed pipeline (the JAX tests'
are 80-110 dB); the sharded replay kernel bit-equal to the sharded scan
(the same shard arithmetic on the CPU); the dispatch equal.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine import replay as jreplay_mod
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.engine.sources import ArraySource as JArraySource
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu.parallel.sharded_replay import (
    ShardedDeviceReplay as JShardedReplay,
    ShardedSegmentedReplay as JShardedSegmented)
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import convert, measure
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine import replay as replay_mod
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource
from gpu_sdr_tpu_torch.parallel import make_mesh
from gpu_sdr_tpu_torch.parallel import sharded_replay as sr_mod
from gpu_sdr_tpu_torch.parallel.sharded_replay import (
    ShardedDeviceReplay, ShardedSegmentedReplay)

torch.set_num_threads(2)

RATE = 1_000_000


def meshes(shape):
    return (jmake_mesh(shape, ("time", "channels")),
            make_mesh(shape, ("time", "channels"), devices=["cpu"] * 8))


def crandn(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def rx_of(kind, samples):
    if kind == "direct":
        return AntennaParams(mode=AntMode.RX, rate=RATE, decim=100,
                             pf_average=4, buffer_len=128_000,
                             samples=samples, freq=[100_000, -250_000],
                             wave_type=[WaveType.DIRECT] * 2)
    if kind in ("tones", "noise"):
        n = 1 if kind == "noise" else 2
        return AntennaParams(
            mode=AntMode.RX, rate=RATE, buffer_len=128_000, samples=samples,
            fft_tones=1000, pf_average=4, freq=[50_000, -200_000][:n],
            wave_type=[WaveType.NOISE if kind == "noise"
                       else WaveType.TONES] * n)
    return AntennaParams(mode=AntMode.RX, rate=RATE, decim=1,
                         buffer_len=100_000, samples=samples,
                         freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
                         swipe_s=[1000], wave_type=[WaveType.CHIRP])


def run_both(monkeypatch, kind, shape, rec, samples, loop):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    jm, m = meshes(shape)
    rx = rx_of(kind, samples)
    jr = JShardedReplay(rx, rec, jm, blocks_per_exec=2, loop=loop)
    r = ShardedDeviceReplay(rx, rec, m, loop=loop)
    js, s = JMemorySink(), MemorySink()
    jr.run([js])
    r.run([s])
    assert s.data.shape == js.data.shape and s.data.dtype == np.complex64
    return r, jr, s.data, js.data


@pytest.mark.parametrize("kind, shape, n_rec, samples, loop, path", [
    ("direct", (8, 1), 256_000, 512_000, True, "replay_kernel"),
    ("direct", (2, 1), 256_000, 512_000, True, "replay_kernel"),
    ("tones", (8, 1), 128_000, 256_000, True, "channelizer_at"),
    ("noise", (8, 1), 128_000, 256_000, True, "channelizer_at"),
    ("direct", (4, 2), 256_000, 512_000, True, "scan"),      # the seam
    ("direct", (2, 4), 200_000, 384_000, False, "scan"),     # past the end
    ("tones", (2, 4), 256_000, 256_000, False, "scan"),
    ("chirp", (4, 2), 200_000, 400_000, True, "scan"),
], ids=lambda v: str(v))
def test_sharded_replay_matches_jax(monkeypatch, kind, shape, n_rec,
                                    samples, loop, path):
    rec = crandn(7, n_rec)
    r, jr, ours, theirs = run_both(monkeypatch, kind, shape, rec, samples,
                                   loop)
    assert r.path == jr.path == path
    assert golden.snr_db(theirs, ours) > 90.0


@pytest.mark.parametrize("kind", ["direct", "tones"])
def test_sharded_replay_matches_host_fed(kind):
    """Looped over its seam, the sharded replay equals the host-fed
    single-device pipeline over the same stream."""
    rec = crandn(11, 256_000 if kind == "direct" else 128_000)
    rx = rx_of(kind, 512_000 if kind == "direct" else 384_000)
    r = ShardedDeviceReplay(rx, rec, meshes((8, 1))[1], loop=True)
    s = MemorySink()
    r.run([s])

    class Loop:
        def blocks(self, block_len, n_blocks):
            for i in range(n_blocks):
                yield rec[(np.arange(block_len) + i * block_len) % len(rec)]

    h = MemorySink()
    run_pipeline(make_demodulator(rx, "cpu"), Loop(), [h])
    n = min(len(h.data), len(s.data))
    assert n == len(s.data)
    assert golden.snr_db(h.data[:n], s.data) > 90.0


def test_sharded_replay_kernel_bit_equal_to_sharded_scan(monkeypatch):
    """On the CPU the replay kernel's plain version and the sharded DDC
    step do the same shard arithmetic on the same rows."""
    rec = crandn(13, 256_000)
    rx = rx_of("direct", 512_000)
    m = meshes((2, 1))[1]
    outs = []
    for force_scan in (False, True):
        if force_scan:
            monkeypatch.setattr(sr_mod, "plan_sharded_replay_kernel",
                                lambda *a: False)
        r = ShardedDeviceReplay(rx, rec, m, loop=True)
        assert r.path == ("scan" if force_scan else "replay_kernel")
        s = MemorySink()
        r.run([s])
        outs.append(s.data)
    assert np.array_equal(outs[0], outs[1])


def test_sharded_segmented_matches_jax_and_dispatches(monkeypatch):
    """A recording over the budget takes ShardedSegmentedReplay, 3
    segment boundaries crossed, the JAX stream and the JAX dispatch."""
    rec = crandn(17, 800_000) + 0.01
    rx = rx_of("direct", 800_000)
    rx.buffer_len = 100_000
    jm, m = meshes((4, 2))
    jsr = JShardedSegmented(rx, rec, jm, blocks_per_exec=1,
                            segment_bytes=2 * 100_000 * 8)
    sr = ShardedSegmentedReplay(rx, rec, m, segment_bytes=2 * 100_000 * 8)
    assert sr.seg_blocks == jsr.seg_blocks == 2
    js, s = JMemorySink(), MemorySink()
    jsr.run([js])
    sr.run([s])
    assert s.data.shape == js.data.shape
    assert golden.snr_db(js.data, s.data) > 90.0
    assert len(sr.stage_seconds) == 4
    monkeypatch.setattr(jreplay_mod, "DEVICE_REPLAY_MAX_BYTES", 2 * 800_000)
    monkeypatch.setattr(replay_mod, "DEVICE_REPLAY_MAX_BYTES", 2 * 800_000)
    p = UsrpParams()
    p.A_RX2 = rx
    js2, s2 = JMemorySink(), MemorySink()
    jmeasure.run_measurement(p, source=JArraySource(rec), mesh=jm,
                             extra_sinks=[js2])
    measure.run_measurement(p, source=ArraySource(rec), mesh=m,
                            extra_sinks=[s2])
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "sharded_segmented_replay", None),)
    assert golden.snr_db(js2.data, s2.data) > 90.0


@pytest.mark.parametrize("kind, shape, loop, sub", [
    ("direct", (8, 1), True, "replay_kernel"),
    ("tones", (8, 1), True, "channelizer_at"),
    ("direct", (4, 2), False, "scan"),
], ids=lambda v: str(v))
def test_run_measurement_mesh_replay_dispatch(monkeypatch, kind, shape,
                                              loop, sub):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    n_rec = 256_000 if kind == "direct" else 128_000
    rec = crandn(19, n_rec)
    jm, m = meshes(shape)
    p = UsrpParams()
    p.A_RX2 = rx_of(kind, 2 * n_rec)
    jsrc, src = JArraySource(rec), ArraySource(rec)
    jsrc.loop = src.loop = loop
    js, s = JMemorySink(), MemorySink()
    jmeasure.run_measurement(p, source=jsrc, mesh=jm, extra_sinks=[js])
    measure.run_measurement(p, source=src, mesh=m, extra_sinks=[s])
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "sharded_replay", sub),)
    assert golden.snr_db(js.data, s.data) > 90.0


@pytest.mark.parametrize("kind, shape", [("direct", (2, 1)),
                                         ("tones", (8, 1)),
                                         ("direct", (4, 2))],
                         ids=lambda v: str(v))
def test_sharded_replay_state_carried_from_jax(monkeypatch, kind, shape):
    """A JAX sharded replay stopped after one execution (2 blocks)
    continues in the port from its converted state."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    n_rec = 256_000 if kind == "direct" else 128_000
    rec = crandn(23, n_rec)
    jm, m = meshes(shape)
    rx = rx_of(kind, 4 * n_rec)
    jr = JShardedReplay(rx, rec, jm, blocks_per_exec=2, loop=True)
    r = ShardedDeviceReplay(rx, rec, m, loop=True)
    assert r.path == jr.path
    # the JAX run's carry is (sub-path state, block index), one
    # execution of 2 blocks per _multi
    carry = (jr._kernel_state_init() if jr._kernel_path is not None
             else jr.demod.init_state(), np.int32(0))
    carry = jr._multi(carry[0], carry[1], jr._X)[:2]
    st = convert.sharded_replay_state(
        carry, r, lambda d: convert.sharded_ddc_state(d, r.demod.sharded))
    jy = jcplx.to_np(jr._multi(carry[0], carry[1], jr._X)[2])
    jy = jy[..., :r.demod.n_channels].reshape(-1, r.demod.n_channels)
    outs = []
    for _ in range(2):
        st, y = r.step(st)
        outs.append(y.gather().numpy())
    assert golden.snr_db(jy, np.concatenate(outs)) > 90.0
