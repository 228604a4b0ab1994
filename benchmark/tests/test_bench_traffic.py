"""The pacing arithmetic of the mixes, on a simulated clock."""

import numpy as np
import pytest

import traffic


class FakeClock:
    """A clock that moves only when the source sleeps or `work` runs."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.now += s


def test_the_radio_rate_is_a_block_every_10_ms():
    assert traffic.block_period(100, 1_000_000) == pytest.approx(0.01)
    assert traffic.blocks_due(20.0, 0.01) == 2000
    assert traffic.blocks_due(20.004, 0.01) == 2001
    assert traffic.due_times(5.0, 0.01, 3).tolist() == pytest.approx(
        [5.0, 5.01, 5.02])


def _rec(nrec=3, L=4):
    return np.arange(nrec * L, dtype=np.complex64).reshape(nrec, L)


def test_open_loop_sends_on_schedule_and_loops_the_recording():
    clk = FakeClock()
    src = traffic.HostRecording(_rec(), seconds=0.05, period=0.01,
                                clock=clk, sleep=clk.sleep)
    got = []
    for blk in src.blocks(4, 10 ** 6):
        got.append((clk.now, blk[0].real))
    assert len(got) == 5 == src.limit()
    assert [t for t, _ in got] == pytest.approx(src.due().tolist())
    assert [v for _, v in got] == [0, 4, 8, 0, 4]
    assert np.all(src.lateness() == 0)


def test_open_loop_does_not_slow_when_the_system_does():
    clk = FakeClock()
    src = traffic.HostRecording(_rec(), seconds=0.05, period=0.01,
                                clock=clk, sleep=clk.sleep)
    sent = []
    for k, _ in enumerate(src.blocks(4, 10 ** 6)):
        sent.append(clk.now)
        clk.now += 0.025 if k == 1 else 0.001     # a stall after block 1
    due = src.due()
    # the blocks due during the stall go out at once, late, and the
    # schedule after it is kept; their lateness is the system's
    assert sent[2] - due[2] == pytest.approx(0.015)
    assert sent[3] - due[3] == pytest.approx(0.006)
    assert sent[4] == pytest.approx(due[4])
    assert len(src.lateness()) == 3


def test_closed_loop_ends_after_its_seconds():
    clk = FakeClock()
    src = traffic.HostRecording(_rec(), seconds=0.1, clock=clk,
                                sleep=clk.sleep)
    n = 0
    for _ in src.blocks(4, 10 ** 6):
        clk.now += 0.003
        n += 1
    assert n == 34                       # asked at 0, 3, ..., 99 ms
    src = traffic.HostRecording(_rec(), max_blocks=5)
    assert len(list(src.blocks(4, 10 ** 6))) == 5


def test_the_mixes_name_their_source():
    rec = _rec().reshape(-1)
    dev = traffic.make_source({"recording": "device"}, rec, 4)
    assert dev.loop and dev.data.shape == (12,)
    host = traffic.make_source({"recording": "host", "rate_msps": 1e-4},
                               rec, 4, seconds=1.0)
    assert host.period == pytest.approx(0.04) and not hasattr(host, "data")
    with pytest.raises(ValueError):
        next(host.blocks(8, 1))
