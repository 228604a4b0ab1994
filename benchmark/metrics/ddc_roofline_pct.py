"""ddc_roofline_pct: the DDC kernel's bound a call (roofline.ddc_counts
at the configuration's shapes) over its device time a call in the
traced window, in percent.  The kernel is the program's csrc/ddc.cu,
launched as ddc_channel_kernel or ddc_row_kernel: #7 on a streamed
block, #8 on a block of a resident recording."""

import roofline
import trace_reader


def read(run):
    if run.trace is None:
        return None
    s, n = trace_reader.op_seconds(run.trace, "ddc_")
    if not n:
        return None
    return 100.0 * roofline.bound_s(*roofline.ddc_counts(run.cfg["rx"])) \
        / (s / n)
