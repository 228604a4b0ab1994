"""Wire formats of the TCP protocol — byte-compatible with the reference
(the port's copy of gpu_sdr_tpu/server/wire.py: the same bytes, so
either package's client talks to the other's server).

Sync (data) channel, port 61360: each packet is a 21-byte packed header
mirroring the RX_wrapper struct (headers/USRP_server_settings.hpp:216-224,
serialized in format_net_buffer, cpp/USRP_server_network.cpp:164-191, and
decoded by the numpy header_type dtype, pyUSRP/USRP_low_level.py:63-70):

    int32  usrp_number
    char   front_end_code      ('A'=A_TXRX 'B'=A_RX2 'C'=B_TXRX 'D'=B_RX2)
    int32  packet_number
    int32  length              (total complex samples in the payload)
    int32  errors
    int32  channels

followed by `length` complex64 samples (8*length bytes).

Async (command) channel, port 22001: 8-byte header (uint32 zero, uint32
payload length) + JSON payload (Encode_async_message,
pyUSRP/USRP_connections.py:484-498).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

SYNC_PORT = 61360
ASYNC_PORT = 22001
# raw-IQ ingest port (no reference analog: the radio was on a dedicated
# 10 GbE link; here an external producer streams complex64 over TCP)
INGEST_PORT = 61362

HEADER_STRUCT = struct.Struct("<i c i i i i")
HEADER_SIZE = 21
assert HEADER_STRUCT.size == HEADER_SIZE

# numpy mirror (identical to pyUSRP header_type)
header_dtype = np.dtype([
    ("usrp_number", np.int32),
    ("front_end_code", np.dtype("|S1")),
    ("packet_number", np.int32),
    ("length", np.int32),
    ("errors", np.int32),
    ("channels", np.int32),
])

FRONT_END_CODES = {"A_TXRX": b"A", "A_RX2": b"B",
                   "B_TXRX": b"C", "B_RX2": b"D"}
FRONT_END_NAMES = {v: k for k, v in FRONT_END_CODES.items()}


def encode_sync_packet(usrp_number: int, front_end_code: bytes,
                       packet_number: int, errors: int, channels: int,
                       data: np.ndarray) -> bytes:
    """Serialize one RX packet (header + complex64 payload).
    `data` is any complex64 array; its flattened length is the wire length."""
    payload = np.ascontiguousarray(data, dtype=np.complex64)
    header = HEADER_STRUCT.pack(int(usrp_number), front_end_code,
                                int(packet_number), int(payload.size),
                                int(errors), int(channels))
    return header + payload.tobytes()


def decode_sync_header(raw: bytes) -> dict:
    """Decode the 21-byte sync header into a metadata dict
    (Decode_Sync_Header, pyUSRP/USRP_connections.py:393-425)."""
    h = np.frombuffer(raw, dtype=header_dtype, count=1)[0]
    return {
        "usrp_number": int(h["usrp_number"]),
        "front_end_code": FRONT_END_NAMES.get(bytes(h["front_end_code"]),
                                              "A_RX2"),
        "packet_number": int(h["packet_number"]),
        "length": int(h["length"]),
        "errors": int(h["errors"]),
        "channels": int(h["channels"]),
    }


def encode_async_message(payload: bytes | str) -> bytes:
    """8-byte header (0, length) + JSON payload
    (Encode_async_message, pyUSRP/USRP_connections.py:484-498)."""
    if isinstance(payload, str):
        payload = payload.encode()
    return struct.pack("<II", 0, len(payload)) + payload


def decode_async_header(raw: bytes) -> int:
    """Return payload length, or 0 on a malformed header
    (Decode_Async_header, pyUSRP/USRP_connections.py:438-444)."""
    zero, length = struct.unpack("<II", raw)
    return int(length) if zero == 0 else 0


def recv_exact(sock, n: int, stop=None) -> Optional[bytes]:
    """Read exactly n bytes from a socket (None on EOF).

    A socket timeout with NOTHING consumed propagates (the caller's poll
    loop); once partial data has arrived the read continues across
    timeouts — abandoning a half-read message would permanently desync
    the framing (the next header would be parsed from mid-payload
    bytes).  `stop` (nullary callable) aborts a mid-message wait."""
    import socket as _socket
    chunks = []
    got = 0
    while got < n:
        try:
            b = sock.recv(n - got)
        except _socket.timeout:
            if got == 0:
                raise
            if stop is not None and stop():
                return None
            continue
        if not b:
            return None
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)
