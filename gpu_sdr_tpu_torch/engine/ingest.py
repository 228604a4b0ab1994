"""Host-fed streaming ingest (port of gpu_sdr_tpu/engine/ingest.HostFeed).

The reference's real-time loop lands radio blocks in pinned host buffers
and overlaps the host->device copy of buffer i+1 with the kernels of
buffer i (rx_single_link, cpp/USRP_server_link_threads.cpp:604-702).
:class:`HostFeed` does the same: a feeder thread stays `depth` blocks
ahead of the consumer, copies each numpy block into pinned host memory
and issues a ``non_blocking`` host->device copy on its own CUDA stream,
recording an event the consumer's stream waits on.  The bounded queue is
the double buffer; `depth=2` is the classic scheme.  On the CPU the
block is handed over as it is.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import torch

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

    def _stage(self, blk, stream):
        x = torch.from_numpy(blk)
        if self.device.type != "cuda":
            return x.to(self.device), None
        pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        pinned.copy_(x)
        with torch.cuda.stream(stream):
            d = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
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
            for blk in self.source.blocks(block_len, n_blocks):
                if self._stop.is_set():
                    return
                errs = int(take_errors())
                if not self._put((*self._stage(blk, stream), errs)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._END)

    def device_blocks(self, block_len: int, n_blocks: int):
        """Yield up to n_blocks (device block, errors) pairs."""
        self._stop.clear()
        self._err = None
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
            while True:
                item = self._q.get()
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
