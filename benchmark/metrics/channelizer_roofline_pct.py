"""channelizer_roofline_pct: the fused channelizer kernel's bound a call
(pfb_roofline.channelizer_counts at the configuration's shapes) over its
device time a call in the traced window, in percent.  The kernel is the
program's csrc/channelizer.cu, launched as channelizer_kernel: #4 on a
block of a resident recording."""

import pfb_roofline
import trace_reader


def read(run):
    if run.trace is None:
        return None
    s, n = trace_reader.op_seconds(run.trace, "channelizer_")
    if not n:
        return None
    return 100.0 * pfb_roofline.bound_s(
        *pfb_roofline.channelizer_counts(run.cfg["rx"])) / (s / n)
