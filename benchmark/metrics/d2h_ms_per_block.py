"""d2h_ms_per_block: device milliseconds of device-to-host copies in
the traced window, per packet delivered in it."""

import trace_reader


def read(run):
    if run.trace is None or not run.trace["packets"]:
        return None
    s, n = trace_reader.op_seconds(run.trace, "Memcpy DtoH")
    return 1e3 * s / run.trace["packets"] if n else None
