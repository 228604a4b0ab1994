"""Demodulated-stream sinks: memory and callbacks (a copy of
gpu_sdr_tpu/engine/sinks.py).

A sink receives per-block (metadata, (rows, channels) complex64 numpy)
packets.  The HDF5 sink is client/files.H5Sink.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np


@dataclasses.dataclass
class PacketMeta:
    """Per-block packet metadata — the RX_wrapper fields
    (headers/USRP_server_settings.hpp:216-224)."""

    usrp_number: int = 0
    front_end_code: str = "A"
    packet_number: int = 0
    length: int = 0          # rows * channels (samples in packet)
    errors: int = 0
    channels: int = 1


class Sink:
    def on_start(self, n_channels: int, expected_rows: int) -> None:
        pass

    def on_packet(self, meta: PacketMeta, data: np.ndarray) -> None:
        raise NotImplementedError

    def on_end(self) -> None:
        pass


class MemorySink(Sink):
    """Accumulate all packets; `.data` is (total_rows, channels)."""

    def __init__(self):
        self.packets: List[np.ndarray] = []
        self.metas: List[PacketMeta] = []

    def on_packet(self, meta: PacketMeta, data: np.ndarray) -> None:
        self.metas.append(meta)
        self.packets.append(np.asarray(data))

    @property
    def data(self) -> np.ndarray:
        if not self.packets:
            return np.zeros((0, 0), dtype=np.complex64)
        return np.concatenate(self.packets, axis=0)


class CallbackSink(Sink):
    def __init__(self, fn: Callable[[PacketMeta, np.ndarray], None]):
        self.fn = fn

    def on_packet(self, meta: PacketMeta, data: np.ndarray) -> None:
        self.fn(meta, data)
