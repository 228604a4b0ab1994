"""The one traffic generator: the sources a mix's parameters describe.

A mix (``mixes/<name>.json``) names the path it drives and how blocks
arrive:

* ``"recording": "host"``: a :class:`HostRecording`, the recording in
  host RAM served block after block as a NIC ring would hand them over,
  looped.  With ``rate_msps`` null it is a closed loop (the next block
  as soon as the feeder asks); with a rate, an open loop: block k is due
  at t0 + k * L / rate whatever the system does, and its latency counts
  from then.
* ``"recording": "device"``: a :class:`DeviceRecording`, a looped
  recording with ``.data``, which the program uploads once and replays
  from device memory.

The host source ends the window itself: a closed loop after `seconds`,
an open loop after the blocks due in `seconds`.
"""

from __future__ import annotations

import math
import time

import numpy as np

from gpu_sdr_tpu_torch.engine.sources import ArraySource, Source


def block_period(rate_msps: float, block_len: int) -> float:
    """Seconds between two blocks of `block_len` samples at `rate_msps`."""
    return block_len / (float(rate_msps) * 1e6)


def blocks_due(seconds: float, period: float) -> int:
    """Blocks due in a window of `seconds` at one per `period`: those
    due strictly before its end."""
    return max(1, math.ceil(seconds / period - 1e-9))


def due_times(t0: float, period: float, n: int) -> np.ndarray:
    """The due time of each of the first n blocks."""
    return t0 + period * np.arange(n, dtype=np.float64)


class HostRecording(Source):
    """Blocks of a host recording (nrec, L) complex64, looped, block k
    the recording's block k mod nrec.  `seconds` ends a closed loop,
    `max_blocks` any loop; with `period` the loop is open.  Records the
    due time (open loop), the time each block was asked for and the time
    it was handed over."""

    def __init__(self, recording: np.ndarray, seconds=None, period=None,
                 max_blocks=None, clock=time.perf_counter,
                 sleep=time.sleep):
        self.rec = recording
        self.seconds, self.period = seconds, period
        self.max_blocks = max_blocks
        self.clock, self.sleep = clock, sleep
        self.t0 = None
        self.asked, self.sent = [], []

    def limit(self) -> int | None:
        """The blocks this source yields at most: an open loop's due
        blocks, else `max_blocks`."""
        n = self.max_blocks
        if self.period is not None and self.seconds is not None:
            due = blocks_due(self.seconds, self.period)
            n = due if n is None else min(n, due)
        return n

    def due(self) -> np.ndarray:
        """The due times of the blocks an open loop yields."""
        return due_times(self.t0, self.period, self.limit())

    def blocks(self, block_len: int, n_blocks: int):
        nrec, L = self.rec.shape
        if block_len != L:
            raise ValueError(f"the recording's blocks are {L} samples, "
                             f"the plan's {block_len}")
        limit = self.limit()
        n = n_blocks if limit is None else min(n_blocks, limit)
        self.t0 = self.clock()
        for k in range(n):
            now = self.clock()
            self.asked.append(now)
            if self.period is not None:
                wait = self.t0 + k * self.period - now
                if wait > 0:
                    self.sleep(wait)
            elif self.seconds is not None and now - self.t0 >= self.seconds:
                return
            self.sent.append(self.clock())
            yield self.rec[k % nrec]

    def lateness(self) -> np.ndarray:
        """An open loop's own lateness, block by block: how long after
        its due time it was handed over, for the blocks the feeder asked
        for before they were due (a block asked for later waited on the
        system, not on the source)."""
        due = self.due()[:len(self.sent)]
        asked = np.asarray(self.asked[:len(self.sent)])
        sent = np.asarray(self.sent)
        return (sent - due)[asked <= due]


class DeviceRecording(ArraySource):
    """A looped recording the program uploads once and replays."""

    loop = True


def make_source(mix: dict, recording: np.ndarray, block_len: int,
                seconds=None, max_blocks=None):
    """The source of one run_measurement call under `mix`, over
    `recording` (numpy complex64, whole blocks)."""
    if mix["recording"] == "device":
        return DeviceRecording(recording)
    period = (block_period(mix["rate_msps"], block_len)
              if mix.get("rate_msps") else None)
    return HostRecording(recording.reshape(-1, block_len), seconds=seconds,
                         period=period, max_blocks=max_blocks)
