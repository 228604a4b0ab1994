"""Host-fed streaming ingest (port of gpu_sdr_tpu/engine/ingest.py:
HostFeed and SocketIngestSource).

The reference's real-time loop lands radio blocks in pinned host buffers
and overlaps the host->device copy of buffer i+1 with the kernels of
buffer i (rx_single_link, cpp/USRP_server_link_threads.cpp:604-702).
:class:`HostFeed` does the same: a feeder thread stays `depth` blocks
ahead of the consumer, copies each numpy block into pinned host memory
and issues a ``non_blocking`` host->device copy on its own CUDA stream,
recording an event the consumer's stream waits on.  The bounded queue is
the double buffer; `depth=2` is the classic scheme.  On the CPU the
block is handed over as it is.

:class:`SocketIngestSource` is a Source whose blocks arrive from an
external producer over TCP, through the native receiver
(server/native.py).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Optional

import torch

from .. import spans
from .sources import Source


class HostFeed:
    """Wrap a Source so blocks are staged and copied to `device` `depth`
    blocks ahead of consumption on a feeder thread.

    ``device_blocks()`` yields ``(block, errors)``: `block` is an (L,)
    complex64 tensor on `device`, ready for the consumer's current
    stream; `errors` is the source's per-block error count, sampled on
    the feeder thread right after the block is produced."""

    _END = object()

    def __init__(self, source: Source, device, depth: int = 2):
        if depth < 1:
            raise ValueError("HostFeed depth must be >= 1")
        self.source = source
        self.device = torch.device(device)
        self.depth = int(depth)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._ended = False

    def _stage(self, blk, stream):
        x = torch.from_numpy(blk)
        if self.device.type != "cuda":
            return x.to(self.device), None
        tok = spans.begin("sdr.feed.pin")
        pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        spans.end(tok)
        tok = spans.begin("sdr.feed.copy")
        pinned.copy_(x)
        spans.end(tok)
        tok = spans.begin("sdr.feed.h2d")
        with torch.cuda.stream(stream):
            d = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        spans.end(tok)
        return d, ready

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _feed(self, block_len: int, n_blocks: int) -> None:
        take_errors = getattr(self.source, "take_errors", lambda: 0)
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" else None)
        try:
            blocks = iter(self.source.blocks(block_len, n_blocks))
            for k in itertools.count():
                tok = spans.begin("sdr.feed.source", k)
                blk = next(blocks, None)
                spans.end(tok, keep=blk is not None)
                if blk is None or self._stop.is_set():
                    return
                errs = int(take_errors())
                tok = spans.begin("sdr.feed.stage", k)
                staged = self._stage(blk, stream)
                spans.end(tok)
                tok = spans.begin("sdr.feed.put_wait", k)
                put = self._put((*staged, errs))
                spans.end(tok)
                if not put:
                    return
                spans.high("feed_queue_max", self._q.qsize())
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._ended = True
            self._put(self._END)

    def starved(self) -> bool:
        """Whether the consumer would wait for its next block now: no
        staged block is queued and the feeder has not ended.  It does
        not block."""
        return self._q.empty() and not self._ended

    def device_blocks(self, block_len: int, n_blocks: int):
        """Yield up to n_blocks (device block, errors) pairs."""
        self._stop.clear()
        self._err = None
        self._ended = False
        while True:       # drop what an earlier, interrupted run left
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        thread = threading.Thread(target=self._feed,
                                  args=(block_len, n_blocks),
                                  name="host-feed", daemon=True)
        thread.start()
        try:
            for k in itertools.count():
                tok = spans.begin("sdr.loop.get_wait", k)
                item = self._q.get()
                spans.end(tok, keep=item is not self._END)
                if item is self._END:
                    if self._err is not None:
                        raise self._err
                    return
                x, ready, errs = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    x.record_stream(consumer)
                yield x, errs
        finally:
            self._stop.set()
            thread.join(timeout=5.0)


class SocketIngestSource(Source):
    """Blocks arriving from an external producer over TCP.

    Backed by the native ingest receiver (native/stream_ingest.cpp,
    built by server/native.py): a C++ thread reassembles the raw
    complex64 byte stream into fixed-size blocks in a lock-free ring;
    `blocks()` pops them here.  Ring overflows (the consumer falling
    behind the wire) and the zero-padded samples of a partial tail block
    are reported through `take_errors`, like the reference's UHD error
    counters (cpp/USRP_server_diagnostic.cpp:14-106).  An overflow is
    stamped on the block popped after the drop, as in the JAX package.
    The padding is stamped on the tail block that carries it, whatever
    the timing (the JAX package stamps it on whichever block is popped
    after the receiver counted it, divergence 36): once the padding is
    counted, a popped block is the tail if the stream ends with nothing
    left in the ring.

    Use `port=0` for an ephemeral port; read `.port` to tell the
    producer where to connect.  A producer that disconnects, or delivers
    nothing for `timeout` seconds, ends the stream short: no block is
    fabricated, `aborted` is set and `shortfall_blocks` counts the
    blocks not delivered (the reference declares "USRP is not
    streaming" and aborts, cpp/USRP_hardware_manager.cpp:1546-1560);
    the pipeline's accounting and the H5 sink's end-of-run shrink take
    the short stream."""

    def __init__(self, block_len: int, port: int = 0, queue_len: int = 16,
                 timeout: float = 30.0):
        from ..server.native import NativeIngest
        self._ingest = NativeIngest(block_len, port=port,
                                    queue_len=queue_len)
        self.port = self._ingest.port
        self.block_len = int(block_len)
        self.timeout = float(timeout)
        self._overflows_reported = 0
        self._padded_reported = 0
        self._padded_due = 0        # the padding of the tail, once yielded
        self.aborted = False
        self.shortfall_blocks = 0

    def take_errors(self) -> int:
        """The error count since the last call: overflows counted so far,
        plus the padded samples of the tail block once `blocks()` has
        yielded it."""
        over = self._ingest.stats["overflows"]
        delta = over - self._overflows_reported + self._padded_due
        self._overflows_reported = over
        self._padded_due = 0
        return int(delta)

    @property
    def stats(self) -> dict:
        return self._ingest.stats

    def _pop(self):
        try:
            return self._ingest.pop_block(timeout=self.timeout)
        except TimeoutError:
            return None

    def _is_tail(self) -> bool:
        """Whether the block just popped is the padded tail.  The receiver
        counts a tail's padding before it pushes the tail, and sees the
        end of the stream right after: so with no new padding counted the
        block is not the tail, and with new padding it is the tail when
        the stream ends with nothing left in the ring, and not when the
        ring holds more.  Only the blocks popped after the padding was
        counted wait, and only until the receiver pushes the tail."""
        if self._ingest.stats["padded"] == self._padded_reported:
            return False
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            if self._ingest.pending():
                return False
            if self._ingest.drained():
                return True
            time.sleep(0.0005)
        return False

    def blocks(self, block_len: int, n_blocks: int):
        if block_len != self.block_len:
            raise ValueError(f"ingest blocks are {self.block_len} samples "
                             f"(the native ring's slots), not {block_len}")
        for i in range(n_blocks):
            try:
                blk = self._ingest.pop_block(timeout=self.timeout)
            except TimeoutError:
                blk = None
            if blk is None:
                self.aborted = True
                self.shortfall_blocks = n_blocks - i
                logging.getLogger("gpu_sdr_tpu_torch.ingest").error(
                    "ingest producer is not streaming: ending measurement "
                    "%d blocks short (%d/%d delivered)",
                    self.shortfall_blocks, i, n_blocks)
                return
            if self._is_tail():
                padded = self._ingest.stats["padded"]
                self._padded_due += padded - self._padded_reported
                self._padded_reported = padded
            yield blk

    def close(self) -> None:
        self._ingest.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
