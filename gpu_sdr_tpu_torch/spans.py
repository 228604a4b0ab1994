"""Spans and counters of the port's host path: the one recorder.

A span is a named interval of host time on ``time.perf_counter_ns``,
with the span that encloses it on the same thread (its parent), its
thread and the block it belongs to (its id; -1 for none: a child takes
its parent's).  Its self time is its duration less the time its
children cover.  An interval (``interval``) is a span of no thread: the
time a block spent between two points of the loop, such as the hold in
the drain's queue.

What is recorded, and when:

* once-a-call spans (``once``, ``stream_started`` / ``stream_ended``:
  the set-up's parts and ``sdr.stream``), in every ``run_measurement``
  call: ``measure.RUNS``' ``stream_seconds`` comes from ``sdr.stream``;
* per-block spans (``begin`` / ``end``), intervals, high-water
  counters (``high``) and summing ones (``add``), only while the
  recorder is on: for a ``run_measurement`` call that starts while a
  ``torch.profiler`` records (the benchmark's ``--trace 1``,
  ``GPU_SDR_TPU_PROFILE``), and inside ``recording()``.  Off, a site
  is one test of a module global: no clock read, no allocation, no
  ``record_function``.

While a profiler records, every span also opens
``torch.profiler.record_function(name)``, so it lands in the profiler's
Chrome trace beside the kernels and copies, on the trace's own clock
(as ``user_annotation``; a thread the profiler does not follow leaves
none).  ``Recorder.anchor`` keeps the ``perf_counter_ns`` start of the
first span so emitted: the spans recorded after the profiler stops, or
on a thread it does not follow, lie at ``start - anchor`` after that
event on the trace's timeline.

Memory is bounded: each span is one row of RING int64 fields in a ring
preallocated once a process (``table()`` reads the rows still there),
folded into per-name aggregates (count, total, self time, a histogram
of BINS_PER_OCTAVE log-spaced bins an octave for the percentiles) a
quarter of the ring at a time as it fills, and when a call ends.  Nothing leaves the
process but through the profiler and ``measure.RUNS`` (``record()``).
"""

from __future__ import annotations

import contextlib
import itertools
import struct
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

RING = 1 << 20                      # rows of the ring
FIELDS = ("name", "seq", "parent", "thread", "block", "start", "end",
          "self")
ROW = np.dtype([(f, np.int64) for f in FIELDS])
BINS_PER_OCTAVE = 64                # a bin is 1.1% wide
N_BINS = 41 * BINS_PER_OCTAVE       # 1 ns to 2**41 ns (36 minutes)
MAX_NAMES = 64

_PACK = struct.Struct("8q").pack_into
_now = time.perf_counter_ns
_ident = threading.get_ident


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def profiling() -> bool:
        """Whether a torch.profiler is recording now (on any thread)."""
        return _autograd_profiler._is_profiler_enabled
else:                               # a PyTorch without the flag
    def profiling() -> bool:
        """Whether a torch.profiler is recording now (on this thread)."""
        return torch._C._autograd._profiler_enabled()


class Recorder:
    """The spans, intervals and counters of one call (``reset`` starts
    anew).  ``blocks`` says whether the per-block sites record.

    A row's slot comes from a counter that threads share (atomic under
    the interpreter lock), so writers take no lock; a quarter of the
    ring is folded every quarter, all but the last sixteenth written,
    which a writer interrupted between its slot and its row may still
    owe."""

    def __init__(self, ring: int = RING):
        self.size = int(ring)
        self._chunk, self._lag = max(1, self.size // 4), \
            max(1, self.size // 16)
        self.names: list = []
        self._ids: dict = {}
        self._rows = None                 # the ring (zero pages until used)
        self._lock = threading.Lock()     # names, threads and folds
        self.reset()

    def reset(self, blocks: bool = False) -> None:
        if self._rows is None:
            self._rows = np.zeros(self.size, ROW)
            self._buf = memoryview(self._rows.view(np.uint8))
        self.blocks = bool(blocks)
        self._slots = itertools.count()
        self._seq = itertools.count()
        self._folded = 0
        self._threads: dict = {}          # thread ident: (index, stack)
        self.threads: list = []
        self.anchor = None                # (perf_counter_ns, span name)
        self._agg = np.zeros((MAX_NAMES, 3), np.int64)
        self._hist = np.zeros((MAX_NAMES, N_BINS), np.int64)
        self._high: dict = {}
        self._counts: dict = {}
        self._at_start = self._stream_tok = None
        self.stream_first = self.stream_last = None

    # ------------------------------------------------------------ spans

    def name_id(self, name: str) -> int:
        nid = self._ids.get(name)
        if nid is None:
            with self._lock:
                nid = self._ids.setdefault(name, len(self.names))
                if nid == len(self.names):
                    if nid >= MAX_NAMES:
                        raise ValueError(f"span {name!r}: over {MAX_NAMES} "
                                         "span names")
                    self.names.append(name)
        return nid

    def _new_thread(self) -> tuple:
        with self._lock:
            entry = (len(self.threads), [])
            self.threads.append(threading.current_thread().name)
            self._threads[_ident()] = entry
        return entry

    def begin(self, name: str, block: int = -1) -> list:
        """Open span `name` on this thread: its token for ``end``."""
        tid, stack = self._threads.get(_ident()) or self._new_thread()
        nid = self._ids.get(name)
        if nid is None:
            nid = self.name_id(name)
        parent = -1
        if stack:
            top = stack[-1]
            parent = top[1]
            if block < 0:
                block = top[3]
        rf = None
        if profiling():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        # name, seq, parent, block, start, children's time, emitted,
        # thread, the thread's stack
        tok = [nid, next(self._seq), parent, block, 0, 0, rf, tid, stack]
        stack.append(tok)
        tok[4] = _now()
        if rf is not None and self.anchor is None:
            self.anchor = (tok[4], name)
        return tok

    def end(self, tok: list, keep: bool = True) -> int:
        """Close the span of `tok` (and any child left open), and record
        it unless not `keep`: the clock at its end."""
        t1 = _now()
        if tok[6] is not None:
            tok[6].__exit__(None, None, None)
        stack = tok[8]
        while stack and stack.pop() is not tok:
            pass
        if keep:
            dur = t1 - tok[4]
            if stack:
                stack[-1][5] += dur
            i = next(self._slots)
            _PACK(self._buf, (i % self.size) * ROW.itemsize, tok[0], tok[1],
                  tok[2], tok[7], tok[3], tok[4], t1, dur - tok[5])
            if (i + 1) % self._chunk == 0:
                self._fold(i + 1 - self._lag)
        return t1

    def interval(self, name: str, block: int, t0: int, t1: int) -> None:
        """Record [t0, t1] as an interval `name` of block `block`."""
        self._write(self.name_id(name), next(self._seq), -1, -1, block, t0,
                    t1, t1 - t0)

    def _write(self, *row) -> None:
        i = next(self._slots)
        _PACK(self._buf, (i % self.size) * ROW.itemsize, *row)
        if (i + 1) % self._chunk == 0:
            self._fold(i + 1 - self._lag)

    def _written(self) -> int:
        """The rows written (every writer done): the next slot, put
        back."""
        n = next(self._slots)
        self._slots = itertools.count(n)
        return n

    def _fold(self, upto: int) -> None:
        """Add rows [folded, upto) to the aggregates."""
        with self._lock:
            lo = self._folded
            if upto <= lo:
                return
            r = self._rows[np.arange(lo, upto) % self.size]
            self._folded = upto
            name, dur = r["name"], r["end"] - r["start"]
            agg, m = self._agg, MAX_NAMES
            agg[:, 0] += np.bincount(name, minlength=m)
            agg[:, 1] += np.bincount(name, weights=dur,
                                     minlength=m).astype(np.int64)
            agg[:, 2] += np.bincount(name, weights=r["self"],
                                     minlength=m).astype(np.int64)
            b = np.floor(np.log2(np.maximum(dur, 1)) * BINS_PER_OCTAVE)
            b = np.clip(b, 0, N_BINS - 1).astype(np.int64)
            self._hist += np.bincount(name * N_BINS + b, minlength=m *
                                      N_BINS).reshape(m, N_BINS)

    # --------------------------------------------------------- counters

    def high(self, name: str, value: int) -> None:
        """Keep the largest `value` seen under `name`."""
        if value > self._high.get(name, -1):
            self._high[name] = int(value)

    def add(self, name: str, n: int) -> None:
        """Add `n` to the summing counter `name`."""
        self._counts[name] = self._counts.get(name, 0) + int(n)

    @staticmethod
    def _snapshot(device) -> dict:
        """The kernels' launches and the caches' counts now: the
        caching allocators' segments on the card (cudaMalloc calls) and
        new pinned host blocks, and the cuFFT plans in torch's plan
        cache for the card; 0 off a card (none is made there)."""
        from . import kernels
        cuda = device is not None and torch.device(device).type == "cuda"
        dev = torch.cuda.memory_stats(device) if cuda else {}
        host = torch.cuda.host_memory_stats() if cuda else {}
        plans = 0
        if cuda:
            index = torch.device(device).index
            plans = torch.backends.cuda.cufft_plan_cache[
                torch.cuda.current_device() if index is None else index].size
        return {"launches": kernels.launch_counts(),
                "device_segments": dev.get("segment.all.allocated", 0),
                "pinned_allocs": host.get("num_host_alloc",
                                          host.get("allocations.allocated",
                                                   0)),
                "fft_plans": plans}

    def stream_start(self, device) -> None:
        """The sinks start: sdr.stream opens; counters read, and
        ``graph_blocks`` (the blocks a CUDA graph replay issued,
        engine/replay._GraphGroups) starts at 0."""
        self._stream_tok = self.begin("sdr.stream")
        if self.stream_first is None:
            self.stream_first = self._stream_tok[4]
        if self.blocks:
            self._at_start = self._snapshot(device)
            self._counts.setdefault("graph_blocks", 0)

    def stream_end(self, device) -> None:
        """The sinks have ended: sdr.stream closes; counters read."""
        if self.blocks and self._at_start is not None:
            now, was = self._snapshot(device), self._at_start
            launches = self._counts.setdefault("launches", {})
            for kern, n in now.pop("launches").items():
                n -= was["launches"].get(kern, 0)
                if n:
                    launches[kern] = launches.get(kern, 0) + n
            for k, v in now.items():
                self._counts[k] = self._counts.get(k, 0) + v - was[k]
            self._at_start = None
        if self._stream_tok is not None:
            self.stream_last = self.end(self._stream_tok)
            self._stream_tok = None

    # ------------------------------------------------------------ reads

    def stream_seconds(self) -> float:
        """The first sink start to the last sink end, in seconds."""
        if self.stream_first is None or self.stream_last is None:
            return 0.0
        return (self.stream_last - self.stream_first) / 1e9

    def _quantile(self, nid: int, q: float) -> float:
        """The nearest-rank q-quantile of span `nid`'s durations, at the
        centre of its histogram bin, in seconds."""
        cum = np.cumsum(self._hist[nid])
        b = int(np.searchsorted(cum, max(1, int(np.ceil(q * cum[-1])))))
        return 2.0 ** ((b + 0.5) / BINS_PER_OCTAVE) / 1e9

    def summary(self) -> dict:
        """{name: count, seconds, self_seconds, p50_seconds,
        p99_seconds} of every span name recorded."""
        self._fold(self._written())
        out = {}
        for nid, name in enumerate(self.names):
            count, total, own = (int(v) for v in self._agg[nid, :3])
            if count:
                out[name] = dict(count=count, seconds=total / 1e9,
                                 self_seconds=own / 1e9,
                                 p50_seconds=self._quantile(nid, 0.5),
                                 p99_seconds=self._quantile(nid, 0.99))
        return out

    def record(self) -> dict:
        """What a run_measurement record gains while the recorder was
        on: ``spans`` (``summary()``) and ``counters``; else nothing."""
        if not self.blocks:
            return {}
        return dict(spans=self.summary(),
                    counters={**self._counts, **self._high})

    def table(self) -> np.ndarray:
        """The rows still in the ring, oldest first (FIELDS; ``name``
        indexes ``names``, ``thread`` ``threads``, -1 for none)."""
        n = self._written()
        return self._rows[np.arange(max(0, n - self.size), n) % self.size]

    def durations(self, name: str) -> np.ndarray:
        """The seconds of each span `name` still in the ring, oldest
        first."""
        t = self.table()
        t = t[t["name"] == self._ids.get(name, -1)]
        return (t["end"] - t["start"]) / 1e9


RECORDER = Recorder()
_ON = None          # RECORDER while the per-block sites record
_CALL = None        # RECORDER while a call (or recording()) runs
_forced = 0         # recording() blocks open


def begin(name: str, block: int = -1):
    """Open a per-block span: a token for ``end``, None when off."""
    if _ON is None:
        return None
    return _ON.begin(name, block)


def end(tok, keep: bool = True):
    """Close the span of `tok` (None: nothing); with `keep` false it is
    not recorded.  The clock at its end, None when off."""
    if tok is None:
        return None
    return RECORDER.end(tok, keep)


def interval(name: str, block: int, t0) -> None:
    """Record an interval from `t0` (an ``end``'s clock) to now."""
    if _ON is not None and t0 is not None:
        _ON.interval(name, block, t0, _now())


def high(name: str, value: int) -> None:
    """A high-water counter: the largest `value` of the call."""
    if _ON is not None:
        _ON.high(name, value)


def add(name: str, n: int) -> None:
    """A summing counter: `n` more under `name` for the call."""
    if _ON is not None:
        _ON.add(name, n)


@contextlib.contextmanager
def once(name: str):
    """A once-a-call span, recorded in every call (and under
    ``recording()``)."""
    rec = _CALL
    tok = rec.begin(name) if rec is not None else None
    try:
        yield
    finally:
        if tok is not None:
            rec.end(tok)


def stream_started(device) -> None:
    """The sinks start (``sdr.stream`` opens)."""
    if _CALL is not None:
        _CALL.stream_start(device)


def stream_ended(device) -> None:
    """The sinks have ended (``sdr.stream`` closes)."""
    if _CALL is not None:
        _CALL.stream_end(device)


def _switch(on, call):
    global _ON, _CALL
    prev, (_ON, _CALL) = (_ON, _CALL), (on, call)
    return prev


@contextlib.contextmanager
def call(trace: bool = False):
    """One run_measurement call: the recorder starts anew, on when a
    profiler records now, inside ``recording()`` or with `trace` (a
    profiler about to start); it yields RECORDER, whose ``record()``
    and ``stream_seconds()`` hold the call's after it."""
    on = bool(trace or _forced or profiling())
    RECORDER.reset(blocks=on)
    prev = _switch(RECORDER if on else None, RECORDER)
    try:
        yield RECORDER
    finally:
        _switch(*prev)
        RECORDER._fold(RECORDER._written())


@contextlib.contextmanager
def recording():
    """The recorder on, anew, for what this wraps: yields RECORDER.
    Each run_measurement call inside starts it anew again."""
    global _forced
    RECORDER.reset(blocks=True)
    _forced += 1
    prev = _switch(RECORDER, RECORDER)
    try:
        yield RECORDER
    finally:
        _forced -= 1
        _switch(*prev)
