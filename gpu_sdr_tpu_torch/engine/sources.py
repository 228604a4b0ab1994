"""IQ block sources (port of gpu_sdr_tpu/engine/sources.py): a source
yields fixed-size numpy complex64 blocks from the host, as a radio
would; a recording (ReplaySource, ArraySource) also exposes its samples
as ``data``.  The loopback source feeds a TX Generator's output straight into
RX, the reference's software loopback (cpp/USRP_hardware_manager.cpp:
1071-1123, 1331-1395)."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .generator import Generator


class Source:
    """Iterable of numpy complex64 blocks."""

    def blocks(self, block_len: int, n_blocks: int) -> Iterator[np.ndarray]:
        raise NotImplementedError


class LoopbackSource(Source):
    """TX generator -> RX, the reference's software loopback mode."""

    def __init__(self, generator: Generator, noise_rms: float = 0.0,
                 seed: int = 0):
        self.generator = generator
        self.noise_rms = float(noise_rms)
        self.rng = np.random.default_rng(seed)

    def blocks(self, block_len: int, n_blocks: int):
        assert block_len == self.generator.block_len, \
            "loopback TX/RX block lengths must match"
        for x in self.generator.blocks(n_blocks):
            if self.noise_rms > 0.0:
                n = self.rng.standard_normal(2 * len(x)) * \
                    (self.noise_rms / np.sqrt(2.0))
                x = x + (n[::2] + 1j * n[1::2]).astype(np.complex64)
            yield np.asarray(x, dtype=np.complex64)


class ReplaySource(Source):
    """Replay a recorded IQ stream from disk (raw complex64 or .npy).

    The file replaces the radio: blocks are served in order, zero-padded at
    the tail, looping if `loop` is set.  The file is mapped, not read:
    ``run_measurement`` uploads it once to the device (engine/replay.py)
    when it fits, else streams it.
    """

    def __init__(self, path: str, loop: bool = False):
        self.path = path
        self.loop = loop
        if path.endswith(".npy"):
            self.data = np.load(path, mmap_mode="r")
        else:
            self.data = np.memmap(path, dtype=np.complex64, mode="r")

    def blocks(self, block_len: int, n_blocks: int):
        n = len(self.data)
        pos = 0
        for _ in range(n_blocks):
            if pos + block_len <= n:
                # a copy: the mapped file is read-only
                blk = np.array(self.data[pos:pos + block_len],
                               dtype=np.complex64)
                pos += block_len
            else:
                blk = np.zeros(block_len, dtype=np.complex64)
                take = max(0, n - pos)
                if take > 0:
                    blk[:take] = self.data[pos:]
                if self.loop:
                    # wrap as many times as needed: the recording may be
                    # shorter than one block
                    filled = take
                    while filled < block_len:
                        rem = min(n, block_len - filled)
                        blk[filled:filled + rem] = self.data[:rem]
                        filled += rem
                    pos = (pos + block_len) % n
                else:
                    pos = n
            yield blk


class WhiteNoiseSource(Source):
    """Complex white noise of given RMS (synthetic-noise ingest)."""

    def __init__(self, rms: float = 1.0, seed: int = 0):
        self.rms = float(rms)
        self.rng = np.random.default_rng(seed)

    def blocks(self, block_len: int, n_blocks: int):
        for _ in range(n_blocks):
            n = self.rng.standard_normal(2 * block_len) * \
                (self.rms / np.sqrt(2.0))
            yield (n[::2] + 1j * n[1::2]).astype(np.complex64)


class ArraySource(Source):
    """Serve blocks from an in-memory array (tests)."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.complex64)

    def blocks(self, block_len: int, n_blocks: int):
        for i in range(n_blocks):
            blk = self.data[i * block_len:(i + 1) * block_len]
            if len(blk) < block_len:
                blk = np.pad(blk, (0, block_len - len(blk)))
            yield blk
