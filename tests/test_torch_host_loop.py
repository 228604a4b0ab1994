"""The pipeline's one host loop (engine/pipeline._loop) when a sink
raises, on every kind of path it serves: a device replay (run_chunked),
the host-fed demodulator (run_pipeline) and two front ends in lock-step
(DualFused).  Every sink of every output still ends, the packets before
the fault reach the sinks after the raising one, and a block flushed
after the fault keeps its own packet number and data.  The host-fed
feed is held saturated, so its loop keeps depth (2) blocks in flight
behind the faulty one and flushes both."""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu_torch.engine import dual, make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine.ingest import HostFeed
from gpu_sdr_tpu_torch.engine.replay import DeviceReplay
from gpu_sdr_tpu_torch.engine.sinks import MemorySink, Sink
from gpu_sdr_tpu_torch.engine.sources import Source
from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams, UsrpParams,
                                      WaveType)

torch.set_num_threads(2)

BLK = 50_000
PACKETS = 6
AT = 2                 # the packet number at which the sink raises
REC = (np.random.default_rng(27).standard_normal((PACKETS, BLK)) +
       0.5j).astype(np.complex64)


def _rx(freq=(100_000, -250_000)):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=BLK,
                         samples=PACKETS * BLK, decim=10, pf_average=4,
                         freq=list(freq),
                         wave_type=[WaveType.DIRECT] * len(freq))


def _dual_params():
    p = UsrpParams()
    for fe, f in (("A", 100_000), ("B", -70_000)):
        setattr(p, f"{fe}_TXRX", AntennaParams(
            mode=AntMode.TX, rate=1_000_000, buffer_len=BLK,
            samples=PACKETS * BLK, freq=[f], ampl=[0.5],
            wave_type=[WaveType.TONES]))
        setattr(p, f"{fe}_RX2", _rx([f]))
    return p


class _HostBlocks(Source):
    def blocks(self, block_len, n_blocks):
        for k in range(n_blocks):
            yield REC[k % len(REC)]


def _run(kind, sinks_per_output):
    if kind == "replay":
        DeviceReplay(_rx(), REC.reshape(-1), loop=True,
                     device="cpu").run(sinks_per_output[0])
    elif kind == "host_fed":
        run_pipeline(make_demodulator(_rx(), "cpu"), _HostBlocks(),
                     sinks_per_output[0])
    else:
        dual.DualFused(dual.plan_dual(_dual_params()),
                       device="cpu").run(sinks_per_output)


OUTPUTS = {"replay": 1, "host_fed": 1, "dual": 2}
# the blocks in flight behind packet AT: depth 1 on the device, 2 fed
FLUSHED = {"replay": [AT + 1], "host_fed": [AT + 1, AT + 2],
           "dual": [AT + 1]}


class _Fault(Exception):
    pass


class _Ended(MemorySink):
    def __init__(self):
        super().__init__()
        self.ended = 0

    def on_end(self):
        self.ended += 1


class _Raises(Sink):
    """Raises at packet AT, and with `once` False at every later one."""

    def __init__(self, once):
        self.once, self.ended = once, 0

    def on_packet(self, meta, data):
        k = meta.packet_number
        if k == AT or (k > AT and not self.once):
            raise _Fault(k)

    def on_end(self):
        self.ended += 1


@pytest.mark.parametrize("once", [False, True],
                         ids=["from_k_on", "at_k_only"])
@pytest.mark.parametrize("kind", sorted(OUTPUTS))
def test_a_sink_raising_at_packet_k(monkeypatch, kind, once):
    monkeypatch.setattr(HostFeed, "starved", lambda self: False)
    n = OUTPUTS[kind]
    ref = [_Ended() for _ in range(n)]
    _run(kind, [[s] for s in ref])
    want = [dict(zip((m.packet_number for m in s.metas), s.packets))
            for s in ref]
    assert all(sorted(w) == list(range(PACKETS)) for w in want)

    bad = _Raises(once)
    got = [_Ended() for _ in range(n)]
    with pytest.raises(_Fault):
        _run(kind, [[bad, got[0]]] + [[s] for s in got[1:]])
    assert bad.ended == 1
    assert [s.ended for s in got] == [1] * n
    for s, w in zip(got, want):
        nums = [m.packet_number for m in s.metas]
        assert nums == list(range(AT)) + (FLUSHED[kind] if once else [])
        for m, p in zip(s.metas, s.packets):
            np.testing.assert_array_equal(p, w[m.packet_number])
