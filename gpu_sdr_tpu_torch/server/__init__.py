"""Server runtime of the port: the reference C++ daemon's equivalent on a
CUDA card (a copy of gpu_sdr_tpu/server; SURVEY.md L3-L4):

  wire     <- RX_wrapper packet framing + async JSON framing
              (cpp/USRP_server_network.cpp:164-191, USRP_low_level.py:63-70)
  network  <- Sync_server (data plane, port 61360) + Async_server (command
              plane, port 22001) (cpp/USRP_server_network.cpp)
  native   <- the C++ data plane (native/stream_server.cpp) and the TCP
              ingest receiver (native/stream_ingest.cpp), built by g++
  txrx     <- TXRX orchestrator: set/start/stop of a measurement
              (cpp/USRP_server_link_threads.cpp)
  main     <- CLI entry point (cpp/usrp_server.cpp:19-114)
"""

from .wire import (FRONT_END_CODES, HEADER_STRUCT, decode_async_header,
                   decode_sync_header, encode_async_message,
                   encode_sync_packet)  # noqa: F401
from .txrx import TXRX  # noqa: F401
