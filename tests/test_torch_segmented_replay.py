"""The port's segmented replay (engine/replay.SegmentedDeviceReplay) on
the CPU: a recording over the device budget, staged segment by segment,
bit-equal to the port's host-fed pipeline across segment boundaries
(the cases of tests/test_segmented_replay.py:50-92) and at 90 dB SNR
against the JAX package's SegmentedDeviceReplay.

The port runs one block per step where JAX runs K, so a segment holds
max(1, segment_bytes // (L * 8)) blocks, not a multiple of K; the
outputs are the same (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.engine.replay import \
    SegmentedDeviceReplay as JSegmentedDeviceReplay
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import measure, spans
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine import replay
from gpu_sdr_tpu_torch.engine.replay import SegmentedDeviceReplay
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource, ReplaySource

torch.set_num_threads(2)

BLK = 50_000          # the planner's block for this antenna


def _rx(samples):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000,
                         buffer_len=20_000, samples=samples,
                         decim=10, pf_average=4, freq=[100_000, -250_000],
                         wave_type=[WaveType.DIRECT] * 2)


def _rec(n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def host_fed(rx, rec, loop, tmp_path):
    path = str(tmp_path / "rec.npy")
    np.save(path, rec)
    sink = MemorySink()
    run_pipeline(make_demodulator(rx, "cpu"), ReplaySource(path, loop=loop),
                 [sink])
    return sink.data


@pytest.mark.parametrize("rec_blocks, loop, acq_blocks", [
    (16, False, 16),     # segment boundaries inside the recording
    (5, False, 16),      # tail zero-pad, then segments past the recording
    (3, True, 16),       # looped: the wrap point straddles segments
])
def test_segmented_matches_host_fed_and_jax(tmp_path, rec_blocks, loop,
                                            acq_blocks):
    rx = _rx(samples=acq_blocks * BLK)
    rec = _rec(rec_blocks * BLK)
    sr = SegmentedDeviceReplay(rx, rec, loop=loop,
                               segment_bytes=2 * BLK * 8, device="cpu")
    assert (sr.L, sr.seg_blocks) == (BLK, 2)
    sink = MemorySink()
    with spans.recording() as recorder:
        res = sr.run([sink])
    assert res.n_blocks == acq_blocks
    assert recorder.summary()["sdr.replay.stage_segment"]["count"] == \
        acq_blocks // 2
    host = host_fed(rx, rec, loop, tmp_path)
    assert sink.data.shape == host.shape
    assert np.array_equal(sink.data, host), \
        "segmented replay must bit-match the host-fed path"
    jsr = JSegmentedDeviceReplay(rx, rec, loop=loop, blocks_per_exec=2,
                                 segment_bytes=2 * BLK * 8)
    jsink = JMemorySink()
    jsr.run([jsink])
    assert golden.snr_db(jsink.data, sink.data) > 90.0


@pytest.mark.parametrize("seg_blocks", [1, 3, 8])
def test_state_carries_across_segments(seg_blocks):
    """The stream is continuous across segment boundaries: any segment
    size gives the same bits as one segment for the whole recording,
    including a size that does not divide the acquisition."""
    rx = _rx(samples=8 * BLK)
    rec = _rec(8 * BLK)
    one = SegmentedDeviceReplay(rx, rec, segment_bytes=8 * BLK * 8,
                                device="cpu")
    many = SegmentedDeviceReplay(rx, rec, segment_bytes=seg_blocks * BLK * 8,
                                 device="cpu")
    assert (one.seg_blocks, many.seg_blocks) == (8, seg_blocks)
    s1, s2 = MemorySink(), MemorySink()
    one.run([s1])
    many.run([s2])
    assert np.array_equal(s1.data, s2.data)


def test_segment_is_at_least_one_block():
    sr = SegmentedDeviceReplay(_rx(samples=2 * BLK), _rec(2 * BLK),
                               segment_bytes=100, device="cpu")
    assert sr.seg_blocks == 1
    with pytest.raises(ValueError, match="whole blocks"):
        SegmentedDeviceReplay(_rx(samples=2 * BLK), _rec(BLK + 7), loop=True,
                              device="cpu")


def test_dispatch_rule(monkeypatch, tmp_path):
    """run_measurement routes a recording over the budget to the
    segmented path, one within it to DeviceReplay, with the JAX
    package's dispatch strings and the host-fed data."""
    from gpu_sdr_tpu import measure as jmeasure
    from gpu_sdr_tpu.engine import replay as jreplay
    from gpu_sdr_tpu.engine.sources import ArraySource as JArraySource
    rec = _rec(4 * BLK)
    for mod in (replay, jreplay):
        monkeypatch.setattr(mod, "DEVICE_REPLAY_MAX_BYTES", 2 * BLK * 8)
    src = ArraySource(rec)
    assert not replay.can_device_replay(src)
    assert replay.can_segmented_replay(src)
    p, jp = UsrpParams(), UsrpParams()
    p.A_RX2, jp.A_RX2 = _rx(samples=4 * BLK), _rx(samples=4 * BLK)
    sink, jsink = MemorySink(), JMemorySink()
    measure.run_measurement(p, source=src, extra_sinks=[sink], device="cpu")
    jmeasure.run_measurement(jp, None, source=JArraySource(rec),
                             extra_sinks=[jsink])
    assert measure.last_dispatch() == jmeasure.last_dispatch() == \
        (("A_RX2", "segmented_replay", None),)
    # the host-fed run of the validated antenna (validate() sets the
    # block the measurement plans)
    assert np.array_equal(sink.data, host_fed(p.A_RX2, rec, False, tmp_path))
    assert golden.snr_db(jsink.data, sink.data) > 90.0
