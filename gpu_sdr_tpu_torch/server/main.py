"""Server entry point — the usrp_server daemon of the port (a copy of
gpu_sdr_tpu/server/main.py that measures on a CUDA card).

Mirrors the reference main loop (cpp/usrp_server.cpp:19-114): parse CLI
flags, start the command (async) and data (sync) TCP servers, then loop:
receive JSON command -> validate (chk_param) -> ack/nack -> set/start the
measurement -> poll completion -> send the EOM ack.

Hardware I/O is replaced by replay/synthetic ingest: --sw_loop (default)
loops TX generation into RX through an optional channel model; --replay
serves IQ blocks from a recorded file; --ingest takes a raw complex64
stream over TCP.  The measurements run on --device (``cuda`` by default,
the card of ``ServerSettings.device_index``); with no card, ``cuda``
raises.

    python -m gpu_sdr_tpu_torch.server.main [--device cuda:0] [...]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from ..engine.sources import ReplaySource
from ..params import ParamError, ServerSettings, UsrpParams
from ..utils.log import get_logger, init_logger, set_this_thread_name
from .network import AsyncServer, SyncServer, server_ack, server_nack
from .txrx import TXRX
from . import wire

log = get_logger("main")


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flags (reference boost::program_options,
    cpp/usrp_server.cpp:34-47), and the device."""
    p = argparse.ArgumentParser(
        prog="gpu-sdr-tpu-torch-server",
        description="SDR readout server on a CUDA card")
    p.add_argument("--fw", action="store_true",
                   help="enable server-side file writing")
    p.add_argument("--no_net", action="store_true",
                   help="disable TCP streaming of results")
    p.add_argument("--sw_loop", action="store_true", default=True,
                   help="software loopback instead of hardware (default; "
                        "this build has no radio hardware)")
    p.add_argument("--replay", type=str, default=None,
                   help="replay IQ stream from file instead of loopback")
    p.add_argument("--ingest", type=int, nargs="?", const=wire.INGEST_PORT,
                   default=None, metavar="PORT",
                   help="host-fed ingest: per measurement, listen on PORT "
                        f"(default {wire.INGEST_PORT}; 0 = ephemeral, "
                        "announced in an 'ingest port N' ack) for a raw "
                        "complex64 TCP stream that replaces the radio")
    p.add_argument("--clock", type=str, default="internal",
                   choices=["internal", "external"])
    p.add_argument("--async_port", "--async", dest="async_port", type=int,
                   default=wire.ASYNC_PORT,
                   help="TCP command port (reference --async)")
    p.add_argument("--data_port", "--data", dest="data_port", type=int,
                   default=wire.SYNC_PORT,
                   help="TCP data port (reference --data)")
    p.add_argument("--args", type=str, default="",
                   help="device arguments (accepted for compatibility)")
    p.add_argument("--uhd_dbg", action="store_true",
                   help="accepted for reference CLI compatibility "
                        "(UHD debug logging; no UHD in this build)")
    p.add_argument("--one_shot", action="store_true",
                   help="serve a single measurement then exit (testing)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the measurements run on: cuda (the card "
                        "of ordinal 0), cuda:N or cpu")
    return p


class Server:
    """The composed daemon: async + sync servers + TXRX on `device`.

    The data plane is the native C++ streamer (server/native.py, built
    by g++ at first use; a failed build raises) unless `use_native` is
    False, which takes the Python streamer (server/network.py)."""

    def __init__(self, async_port: int = wire.ASYNC_PORT,
                 data_port: int = wire.SYNC_PORT,
                 file_writing: bool = False, tcp_streaming: bool = True,
                 replay: Optional[str] = None, channel=None,
                 host: str = "0.0.0.0", use_native: bool = True,
                 ingest_port: Optional[int] = None, device="cuda"):
        self.settings = ServerSettings(tcp_streaming=tcp_streaming,
                                       file_writing=file_writing)
        source = ReplaySource(replay) if replay else None
        # the device first: with no card, "cuda" raises before a port
        # is bound
        self.txrx = TXRX(self.settings, channel=channel, source=source,
                         ingest_port=ingest_port, device=device)
        self.sync = None
        if tcp_streaming:
            if not use_native:
                self.sync = SyncServer(port=data_port, host=host)
            else:
                from . import native as native_mod
                self.sync = native_mod.NativeSyncServer(port=data_port)
                log.info("using native C++ data-plane streamer")
        self.txrx.sync_server = self.sync
        self.async_srv = AsyncServer(port=async_port, host=host)
        if self.sync is not None:
            # command-socket drop flags the data socket for reconnect
            # (the reference's reconnect_data + virtual_pinger watchdog)
            self.async_srv.on_disconnect = self.sync.drop_client
        self._active = True

    @property
    def device(self):
        return self.txrx.device

    @property
    def ports(self):
        return (self.async_srv.port,
                self.sync.port if self.sync else None)

    def start(self):
        if self.sync is not None:
            self.sync.start()
        self.async_srv.start()

    def serve_one(self, timeout: Optional[float] = None) -> bool:
        """One main-loop iteration (reference cpp/usrp_server.cpp:75-108):
        returns True if a measurement was served."""
        cmd = self.async_srv.recv_command(timeout=timeout)
        if cmd is None:
            return False
        try:
            params = UsrpParams.from_json(cmd)
            warnings = params.validate()
            for w in warnings:
                log.warning("%s", w)
        except (ParamError, ValueError, KeyError) as e:
            log.error("bad command: %s", e)
            self.async_srv.send(server_nack(str(e)))
            return False
        self.async_srv.send(server_ack("parameters accepted"))
        self.txrx.set(params)
        self.txrx.start()
        if self.txrx.ingest_port is not None and self.txrx.source is None:
            port = self.txrx.wait_ingest_port()
            if port is not None:
                # tell the producer-side client where to stream raw IQ
                self.async_srv.send(server_ack(f"ingest port {port}"))
        while not self.txrx.stop():
            time.sleep(0.1)          # reference polls every 500 ms
        if self.sync is not None:
            self.sync.flush()
        if self.txrx.error is not None:
            self.async_srv.send(server_nack(str(self.txrx.error)))
        else:
            if self.txrx.last_filename:
                # report the server-side filename like the reference
                # (Decode_Async_payload 'filename' handling,
                # pyUSRP/USRP_connections.py:467-469)
                self.async_srv.send(server_ack(
                    f'filename "{self.txrx.last_filename}"'))
            self.async_srv.send(server_ack("EOM: end of measurement"))
        return True

    def serve_forever(self):
        set_this_thread_name("server_main")
        while self._active:
            self.serve_one(timeout=0.5)

    def close(self):
        self._active = False
        # detach the reconnect hook before teardown: the async rx thread
        # may observe its client's EOF while the data plane is destroyed
        self.async_srv.on_disconnect = None
        if self.sync is not None:
            self.sync.close()
        self.async_srv.close()


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from ..config import configure_precision
    configure_precision()
    init_logger()
    log.info("server starting (sw_loop=%s replay=%s device=%s)",
             args.sw_loop, args.replay, args.device)
    srv = Server(async_port=args.async_port, data_port=args.data_port,
                 file_writing=args.fw, tcp_streaming=not args.no_net,
                 replay=args.replay, ingest_port=args.ingest,
                 device=args.device)
    srv.start()
    print(f"gpu_sdr_tpu_torch server ready on {srv.device}: async port "
          f"{srv.ports[0]}, data port {srv.ports[1]}", flush=True)
    try:
        if args.one_shot:
            while not srv.serve_one(timeout=1.0):
                pass
        else:
            srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
