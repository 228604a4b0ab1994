#!/usr/bin/env python3
"""External channel-simulator producer for the host-fed science loop
(the port's copy of tools/science_producer.py).

Stands in for the radio + cryostat in the full stack (external stream ->
server DSP -> TCP -> client HDF5 -> VNA fit): synthesizes the
measurement's TX chirp/comb with the port's generator on the host CPU,
passes it through a resonator channel model
(engine/channel.make_resonator_channel), and streams the resulting raw
complex64 IQ into the server's --ingest receiver over TCP, as a UHD RX
front end would deliver it.

Run:

  python -m gpu_sdr_tpu_torch.tools.science_producer --params cmd.json \
      --portfile port.txt --resonators '[{"f0":-150000,"Qr":30,...}]'

The measurement command JSON tells the producer what stimulus to
synthesize; the ingest port is read from --portfile once the client has
learned it from the server's ack.
"""

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", required=True,
                    help="measurement command JSON (UsrpParams.to_json)")
    ap.add_argument("--portfile", required=True,
                    help="file the client writes the ingest port to")
    ap.add_argument("--resonators", required=True,
                    help="JSON list of resonator dicts (f0/Qr/Qe_re...)")
    ap.add_argument("--fft_len", type=int, default=1 << 12)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--wait_s", type=float, default=60.0)
    args = ap.parse_args()

    from gpu_sdr_tpu_torch.engine.channel import make_resonator_channel
    from gpu_sdr_tpu_torch.engine.generator import make_generator
    from gpu_sdr_tpu_torch.engine.planner import _pair_tx, plan_blocks
    from gpu_sdr_tpu_torch.measure import ChannelSource
    from gpu_sdr_tpu_torch.params import AntMode, UsrpParams

    with open(args.params) as f:
        params = UsrpParams.from_json(f.read())
    rx_name, rx = next(iter(params.active_antennas(AntMode.RX)))
    tx = params.antenna(_pair_tx(params, rx_name))
    plan = plan_blocks(rx)
    chan = make_resonator_channel(float(rx.rate),
                                  json.loads(args.resonators),
                                  fft_len=args.fft_len)
    gen = make_generator(tx, plan.block_len, "cpu")
    # timed RX start: the client's line-delay calibration rides the
    # rx/tx delay difference, which a radio honors via the stream
    # command's time spec; the simulator drops the first `skip` samples
    skip = int(round(max(rx.delay - tx.delay, 0.0) * rx.rate))
    src = ChannelSource(gen, chan, skip_samples=skip)

    deadline = time.monotonic() + args.wait_s
    port = None
    while time.monotonic() < deadline:
        try:
            with open(args.portfile) as f:
                port = int(f.read().strip())
            break
        except (OSError, ValueError):
            time.sleep(0.05)
    if port is None:
        print("producer: no ingest port announced", file=sys.stderr)
        return 1

    sent = 0
    with socket.create_connection((args.host, port)) as s:
        for blk in src.blocks(plan.block_len, plan.n_blocks):
            payload = np.ascontiguousarray(blk, dtype=np.complex64)
            s.sendall(payload.tobytes())
            sent += len(payload)
    print(f"producer done: {sent} samples -> port {port}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
