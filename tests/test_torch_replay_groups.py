"""The device replay's K blocks a step (engine/replay._GraphGroups) on
the CPU, K given by graph_group(), with a stand-in for a CUDA graph
whose replay runs its captured steps again: the set-up's warm-up, the
captures keyed by the chain state's numbers, the static output and
state tensors, and the pipeline's one loop (engine/pipeline._loop),
which launches K blocks a step, starts one copy a step and drains each
block as its own packet.  Its packets, metas, numbers and data are those
of one block a step on every sub-path that groups, for windows that are
not a multiple of K and recordings whose block count K does not divide;
the launch counters count one a block run, the warm-up's included, and
none for a capture; K is the largest divisor of the recording's block
count up to 8, on a card only; every other chain stays at one block a
step; a sink that raises inside a step still ends every sink once, and
each block flushed after it keeps its number; and the host-fed loop
makes one step, one copy and one drain a block, in the order it always
has, with no block replayed by a graph.  On a card, where the graphs
are CUDA's, chip_smoke.py's phase ``replay graphs`` holds them bit for
bit against the eager loop."""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from gpu_sdr_tpu_torch import kernels, measure, spans
from gpu_sdr_tpu_torch.engine import make_demodulator, pipeline, run_pipeline
from gpu_sdr_tpu_torch.engine.ingest import HostFeed
from gpu_sdr_tpu_torch.engine.replay import (DeviceReplay,
                                             SegmentedDeviceReplay,
                                             _GraphGroups, group_blocks)
from gpu_sdr_tpu_torch.engine.sinks import MemorySink, Sink
from gpu_sdr_tpu_torch.engine.sources import Source
from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams, UsrpParams,
                                      WaveType)

torch.set_num_threads(2)

RATE = 1_000_000
BLK = 50_000
F10 = [int(f) for f in np.linspace(-400_000, 400_000, 10)]
DIRECT = dict(decim=10, pf_average=4)
# a receiver for each sub-path that groups, and for two that do not
RX = {
    "replay_kernel_t": dict(freq=[100_000, -250_000],
                            wave_type=[WaveType.DIRECT] * 2, **DIRECT),
    "replay_kernel": dict(freq=F10, wave_type=[WaveType.DIRECT] * 10,
                          **DIRECT),
    "channelizer_at": dict(fft_tones=1000, pf_average=4,
                           freq=[50_000, -200_000],
                           wave_type=[WaveType.TONES] * 2),
    "chirp_at": dict(decim=1, freq=[-300_000], chirp_f=[300_000],
                     chirp_t=[0.128], swipe_s=[128],
                     wave_type=[WaveType.CHIRP]),
}
GROUPED = ("channelizer_at", "replay_kernel", "replay_kernel_t")
CHIRP_AT_BLK = 96_000       # no one-period table: the in-kernel chirp


def _rx(path, n, block=BLK):
    return AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=block,
                         samples=n * block, **RX[path])


def _rec(n_samples, seed=28):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n_samples) +
            1j * rng.standard_normal(n_samples)).astype(np.complex64)


def _replay(path, nblk, n, block=BLK):
    replay = DeviceReplay(_rx(path, n, block), _rec(nblk * block), loop=True,
                          device="cpu")
    assert replay.path == path
    return replay


def _on_card(replay):
    """The replay as a card would hold it, for graph_group() alone."""
    card = copy.copy(replay)
    card.device = torch.device("cuda")
    return card


class _Graph:
    """A CUDA graph's stand-in: its replay runs the captured function
    again, on the same static tensors, and takes back the launches that
    counts (_GraphGroups.step adds the capture's)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        counts = kernels.launch_counts()
        self.fn()
        for k, w in kernels.wrappers().items():
            w.launches = counts[k]


@contextlib.contextmanager
def _capturing(self):
    yield lambda fn: (_Graph(fn), fn())


def _run(replay, K, sinks, usrp_number=0, front_end="A"):
    """replay.run at K blocks a step, its graphs the stand-ins."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(replay, "graph_group", lambda: K)
        mp.setattr(_GraphGroups, "_capturing", _capturing)
        return replay.run(sinks, usrp_number, front_end)


# (K, recording blocks, packets): windows of K + 5, 2K + 3, K + 4 and
# 3K + 5 blocks; recordings K divides and recordings it does not.  The
# groups after the first and before the tail are replayed.
CASES = [(8, 8, 13), (5, 10, 13), (8, 12, 13), (5, 7, 12), (8, 16, 29)]


@pytest.mark.parametrize("K, nblk, n", CASES,
                         ids=[f"K{k}-rec{r}-n{n}" for k, r, n in CASES])
@pytest.mark.parametrize("path", GROUPED)
def test_k_blocks_a_step_are_one_block_a_step(path, K, nblk, n):
    replay = _replay(path, nblk, n)
    one, grouped = MemorySink(), MemorySink()
    r1 = replay.run([one], 3, "B")
    with spans.recording() as rec:
        rk = _run(replay, K, [grouped], 3, "B")
    summary = rec.summary()
    assert summary["sdr.loop.step"]["count"] == -(-n // K)
    assert summary["sdr.fetch.start"]["count"] == -(-n // K)
    for name in ("sdr.inflight", "sdr.drain.wait", "sdr.drain.sinks"):
        assert summary[name]["count"] == n, name
    assert rec.record()["counters"]["graph_blocks"] == n - K - n % K
    assert dataclasses.replace(rk, elapsed_s=0) == \
        dataclasses.replace(r1, elapsed_s=0)
    assert grouped.metas == one.metas
    assert [m.packet_number for m in grouped.metas] == list(range(n))
    assert all(m.usrp_number == 3 and m.front_end_code == "B"
               for m in grouped.metas)
    for a, b in zip(grouped.packets, one.packets):
        assert a.shape == b.shape == (one.packets[0].shape[0],
                                      len(RX[path]["freq"]))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nblk, K", [(256, 8), (250, 5), (13, 1), (1, 1),
                                     (24, 8), (10, 5), (12, 6), (7, 7),
                                     (9, 3)])
def test_k_is_the_largest_divisor_up_to_8(nblk, K):
    assert group_blocks(nblk) == K


def test_the_launches_count_one_a_block_run(monkeypatch):
    """K 8 over a 16-block recording, 29 packets: the warm-up's 8
    launches and one a block replayed or run eagerly, none for the two
    captures; one a block at one block a step."""
    replay = _replay("replay_kernel_t", 16, 29)
    wrapper = kernels.wrappers()["replay_ddc_t"]
    real = replay._chain.step

    def step(state):         # the CPU's plain version counts no launch
        wrapper.launches += 1
        return real(state)
    monkeypatch.setattr(replay._chain, "step", step)
    for K, want in ((1, 29), (8, 29 + 8)):
        kernels.reset_launch_counts()
        with spans.recording() as rec:
            _run(replay, K, [MemorySink()])
        assert kernels.launch_counts()["replay_ddc_t"] == want, K
        assert rec.record()["counters"]["graph_blocks"] == \
            (16 if K == 8 else 0)


def test_the_grouping_chains_take_k_on_a_card():
    """graph_group(), the K run() takes, is group_blocks(nblk) on each
    grouping sub-path on a card; off a card run() steps one block."""
    for path in GROUPED:
        replay = _replay(path, 10, 4)
        assert _on_card(replay).graph_group() == 5, path
        assert replay.graph_group() == 1, path
    seen = []
    real = pipeline._loop

    def spy(*a, **kw):
        seen.append(kw.get("group", 1))
        return real(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "_loop", spy)
        _replay("replay_kernel", 10, 4).run([MemorySink()])
    assert seen == [1]


def _one_block_chains():
    """(name, a callable that runs the chain on the CPU, its
    graph_group() or None)."""
    direct = _rx("replay_kernel_t", 6)
    chirp = _replay("chirp_at", 4, 6, CHIRP_AT_BLK)
    scan = DeviceReplay(direct, _rec(5 * BLK + BLK // 2), loop=False,
                        device="cpu")
    assert scan.path == "scan"
    seg = SegmentedDeviceReplay(direct, _rec(4 * BLK), loop=True,
                                segment_bytes=2 * BLK * 8, device="cpu")
    tx = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=BLK,
                       samples=6 * BLK, freq=[100_000], ampl=[0.5],
                       wave_type=[WaveType.TONES])
    params = UsrpParams()
    params.A_TXRX, params.A_RX2 = tx, _rx("replay_kernel_t", 6)

    def fused(sink):
        measure.run_measurement(params, extra_sinks=[sink], device="cpu")
        assert measure.last_dispatch()[0][1] == "fused_loopback"

    def host_fed(sink):
        measure.run_measurement(_params(direct), source=_Blocks(),
                                extra_sinks=[sink], device="cpu")
        assert measure.last_dispatch()[0][1] == "host_pipeline"
    return [("scan", lambda s: scan.run([s]), _on_card(scan).graph_group()),
            ("chirp_at", lambda s: chirp.run([s]),
             _on_card(chirp).graph_group()),
            ("segmented", lambda s: seg.run([s]), None),
            ("fused", fused, None), ("host_fed", host_fed, None)]


def _params(rx):
    p = UsrpParams()
    p.A_RX2 = rx
    return p


class _Blocks(Source):
    """A host source: the host-fed pipeline's path."""

    def blocks(self, block_len, n_blocks):
        rec = _rec(4 * block_len).reshape(4, block_len)
        for k in range(n_blocks):
            yield rec[k % 4]


def test_the_other_chains_stay_at_one_block_a_step(monkeypatch):
    seen = []
    real = pipeline._loop

    def spy(*a, **kw):
        seen.append(kw.get("group", 1))
        return real(*a, **kw)
    monkeypatch.setattr(pipeline, "_loop", spy)
    for name, run, k in _one_block_chains():
        del seen[:]
        with spans.recording() as rec:
            sink = MemorySink()
            run(sink)
        assert seen == [1], name
        assert k in (None, 1), name
        s = rec.summary()
        assert s["sdr.loop.step"]["count"] == len(sink.packets) == 6, name
        assert rec.record()["counters"]["graph_blocks"] == 0, name


class _Fault(Exception):
    pass


class _Raises(Sink):
    """Raises at packet `at`, and with `once` False at every later one."""

    def __init__(self, at, once):
        self.at, self.once, self.ended = at, once, 0

    def on_packet(self, meta, data):
        k = meta.packet_number
        if k == self.at or (k > self.at and not self.once):
            raise _Fault(k)

    def on_end(self):
        self.ended += 1


class _Ended(MemorySink):
    def __init__(self):
        super().__init__()
        self.ended = 0

    def on_end(self):
        self.ended += 1


@pytest.mark.parametrize("once", [False, True],
                         ids=["from_k_on", "at_k_only"])
def test_a_sink_raising_inside_a_step(once):
    """K 8 over 24 blocks: the sink raises at packet 10, inside the
    second step, drained while the third is in flight.  Every sink ends
    once; packets 11-23 are flushed after the fault, each with its own
    number and data (with `once`; else the raising sink stops them)."""
    K, n, at = 8, 24, 10
    replay = _replay("replay_kernel_t", 8, n)
    ref = _Ended()
    _run(replay, K, [ref])
    want = dict(zip((m.packet_number for m in ref.metas), ref.packets))
    assert sorted(want) == list(range(n))
    bad, got = _Raises(at, once), _Ended()
    with pytest.raises(_Fault):
        _run(replay, K, [bad, got])
    assert bad.ended == got.ended == 1
    nums = [m.packet_number for m in got.metas]
    assert nums == list(range(at)) + (list(range(at + 1, n)) if once
                                      else [])
    for m, p in zip(got.metas, got.packets):
        np.testing.assert_array_equal(p, want[m.packet_number])


def test_the_host_fed_loop_makes_its_calls_a_block(monkeypatch):
    """A spy on a host-fed run with a saturated feed (depth 2): one
    step, one copy started and one drain a block, in the order the loop
    has always made them, and no block replayed by a graph."""
    monkeypatch.setattr(HostFeed, "starved", lambda self: False)
    calls = []
    start, result = pipeline._HostFetch.start, pipeline._HostFetch.result

    def spy_start(self, y):
        calls.append("fetch")
        return start(self, y)

    def spy_result(pending):
        calls.append("drain")
        return result(pending)
    monkeypatch.setattr(pipeline._HostFetch, "start", spy_start)
    monkeypatch.setattr(pipeline._HostFetch, "result",
                        staticmethod(spy_result))
    demod = make_demodulator(_rx("replay_kernel_t", 6), "cpu")
    real_step = demod.step

    def step(state, x):
        calls.append("step")
        return real_step(state, x)
    demod = dataclasses.replace(demod, step=step)
    n = 6
    with spans.recording() as rec:
        sink = MemorySink()
        run_pipeline(demod, _Blocks(), [sink], n_blocks=n)
    want = []
    for k in range(n):
        want += ["step", "fetch"] + (["drain"] if k >= 2 else [])
    want += ["drain", "drain"]
    assert calls == want
    assert [m.packet_number for m in sink.metas] == list(range(n))
    c = rec.record()["counters"]
    assert c["graph_blocks"] == 0 and c["inflight_max"] == 3
