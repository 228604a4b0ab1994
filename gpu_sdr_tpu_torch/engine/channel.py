"""Channel models for loopback measurements (port of the ideal wire of
gpu_sdr_tpu/engine/channel.py; the reference's --sw_loop copies the TX
buffer to RX, cpp/USRP_hardware_manager.cpp:1331-1395).  A channel is
applied host-side, block by block, to numpy complex64 blocks."""

from __future__ import annotations


class Channel:
    """Stateful stream transformation applied block-by-block."""

    def __call__(self, block):
        raise NotImplementedError


class IdealChannel(Channel):
    def __call__(self, block):
        return block
