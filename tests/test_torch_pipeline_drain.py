"""When the host-fed loop (engine/pipeline._host_fed) hands a block to the
sinks: at once when its feed has no next block staged
(``HostFeed.starved``), else once `depth` later blocks are in flight.
A source that waits for each packet before it yields the next block
runs to its end; a feed forced to look saturated keeps depth + 1 blocks
in flight, one forced to look starved one; and the packets, their metas
and their error stamps are those of the depth-capped loop whichever way
the feed looks, an ingest overflow's stamp included.  Divergence 39."""

import threading

import numpy as np
import pytest
import torch

from gpu_sdr_tpu_torch import spans
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine.ingest import HostFeed, SocketIngestSource
from gpu_sdr_tpu_torch.engine.pipeline import run_pipeline_mixed
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import Source
from gpu_sdr_tpu_torch.params import AntMode, AntennaParams, WaveType
from test_torch_ingest import WAIT_S as INGEST_WAIT_S
from test_torch_ingest import _settled, send

torch.set_num_threads(2)

BLK = 50_000
PACKETS = 6
DEPTH = 2
WAIT_S = 5.0
REC = (np.random.default_rng(23).standard_normal((PACKETS, BLK)) +
       0.25j).astype(np.complex64)


def _rx(blocks=PACKETS):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=BLK,
                         samples=blocks * BLK, decim=10, pf_average=4,
                         freq=[100_000, -250_000],
                         wave_type=[WaveType.DIRECT] * 2)


def _mixed_rx():
    return AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=BLK,
                         samples=PACKETS * BLK, decim=10, pf_average=4,
                         freq=[100_000, -300_000],
                         wave_type=[WaveType.DIRECT, WaveType.CHIRP],
                         chirp_f=[0, 300_000], chirp_t=[0.0, 0.1],
                         swipe_s=[0, 1000])


class _Blocks(Source):
    """REC's blocks from the host, block k stamped with k errors."""

    def __init__(self):
        self._next_errors = 0

    def take_errors(self):
        return self._next_errors

    def blocks(self, block_len, n_blocks):
        for k in range(n_blocks):
            self._next_errors = k
            yield REC[k % len(REC)]


class _Handshake(Source):
    """Yields block k+1 only once the sink holds packet k: the next block
    depends on the last packet, as a live feedback loop's does."""

    def __init__(self, sink):
        self.sink = sink

    def blocks(self, block_len, n_blocks):
        for k in range(n_blocks):
            if k and not self.sink.wait_for(k, WAIT_S):
                raise TimeoutError(f"packet {k - 1} not drained in "
                                   f"{WAIT_S} s: block {k} never sent")
            yield REC[k % len(REC)]


class _WaitSink(MemorySink):
    """A MemorySink whose packets can be waited for."""

    def __init__(self):
        super().__init__()
        self._cv = threading.Condition()

    def on_packet(self, meta, data):
        with self._cv:
            super().on_packet(meta, data)
            self._cv.notify_all()

    def wait_for(self, n, timeout):
        with self._cv:
            return self._cv.wait_for(lambda: len(self.metas) >= n, timeout)


def _counters(rec):
    return rec.record()["counters"]


def _force(monkeypatch, starved):
    if starved is not None:
        monkeypatch.setattr(HostFeed, "starved", lambda self: starved)


def test_a_source_waiting_on_each_packet_runs_to_its_end():
    """The parent loop held packet k until block k+2 was launched, so this
    source waited forever for it; now each packet leaves once its block
    is done, since the feed is starved behind it."""
    sink = _WaitSink()
    with spans.recording() as rec:
        res = run_pipeline(make_demodulator(_rx(), "cpu"), _Handshake(sink),
                           [sink], depth=DEPTH)
    assert res.n_blocks == PACKETS
    assert [m.packet_number for m in sink.metas] == list(range(PACKETS))
    c = _counters(rec)
    assert c["inflight_max"] == 1
    # the last block may find the feeder ended, and leave in the flush
    assert PACKETS - 1 <= c["drains_starved"] <= PACKETS


@pytest.mark.parametrize("starved, inflight_max, drains_starved", [
    (False, DEPTH + 1, 0), (True, 1, PACKETS)],
    ids=["saturated", "starved"])
def test_forced_feed_pins_the_blocks_in_flight(monkeypatch, starved,
                                               inflight_max, drains_starved):
    _force(monkeypatch, starved)
    sink = MemorySink()
    with spans.recording() as rec:
        run_pipeline(make_demodulator(_rx(), "cpu"), _Blocks(), [sink],
                     depth=DEPTH)
    c = _counters(rec)
    assert c["inflight_max"] == inflight_max
    assert c.get("drains_starved", 0) == drains_starved
    assert [m.packet_number for m in sink.metas] == list(range(PACKETS))


def _run(kind, monkeypatch, starved):
    """(metas, packets) of each output of a run of `kind`."""
    _force(monkeypatch, starved)
    if kind == "mixed":
        sinks = [[MemorySink()], [MemorySink()]]
        run_pipeline_mixed(make_demodulator(_mixed_rx(), "cpu"), _Blocks(),
                           sinks, depth=DEPTH)
    else:
        sinks = [[MemorySink()]]
        run_pipeline(make_demodulator(_rx(), "cpu"), _Blocks(), sinks[0],
                     depth=DEPTH)
    return [(s.metas, s.packets) for (s,) in sinks]


def _same(got, want):
    assert len(got) == len(want)
    for (metas, packets), (wmetas, wpackets) in zip(got, want):
        assert metas == wmetas
        assert len(packets) == len(wpackets)
        for p, w in zip(packets, wpackets):
            assert p.dtype == w.dtype and np.array_equal(p, w)


@pytest.mark.parametrize("kind", ["single", "mixed"])
@pytest.mark.parametrize("starved", [None, True],
                         ids=["as_observed", "forced_starved"])
def test_same_packets_as_the_depth_capped_loop(monkeypatch, kind, starved):
    """The packets, metas (numbers, lengths, error stamps) and data of
    the depth-capped loop (the feed forced saturated: the parent's
    policy), whichever rule drains."""
    want = _run(kind, monkeypatch, False)
    got = _run(kind, monkeypatch, starved)
    assert [m.errors for m in want[0][0]] == list(range(PACKETS))
    _same(got, want)


class _Burst(Source):
    """test_torch_ingest's overflow case through the pipeline: six blocks
    sent into a three-slot ring before the first pop, three more once
    block 0 is popped and before block 1 is."""

    def __init__(self, src):
        self.src = src
        self.take_errors = src.take_errors

    def blocks(self, block_len, n_blocks):
        gen = self.src.blocks(block_len, n_blocks)
        yield next(gen)
        send(self.src.port, np.zeros(BLK * 3, np.complex64).tobytes())
        _settled(self.src, 9)
        yield from gen


def _overflow_run(monkeypatch, starved):
    _force(monkeypatch, starved)
    with SocketIngestSource(block_len=BLK, queue_len=3,
                            timeout=INGEST_WAIT_S) as src:
        send(src.port, np.zeros(BLK * 6, np.complex64).tobytes())
        _settled(src, 6)
        cap = src.stats["blocks_received"]
        first = src.stats["overflows"]
        assert first == 6 - cap > 0
        sink = MemorySink()
        run_pipeline(make_demodulator(_rx(cap + 1), "cpu"), _Burst(src),
                     [sink], depth=DEPTH)
        assert not src.aborted
    assert [m.errors for m in sink.metas] == [first, 2] + [0] * (cap - 1)
    return [(sink.metas, sink.packets)]


@pytest.mark.parametrize("starved", [None, True],
                         ids=["as_observed", "forced_starved"])
def test_overflow_stamps_as_in_the_depth_capped_loop(monkeypatch, starved):
    """An overflow is stamped on the block popped after it
    (test_torch_ingest.test_overflow_is_stamped_on_the_block_popped_
    after_it) whichever rule drains."""
    want = _overflow_run(monkeypatch, False)
    _same(_overflow_run(monkeypatch, starved), want)
