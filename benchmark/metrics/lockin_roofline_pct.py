"""lockin_roofline_pct: the table-mode lock-in kernel's bound a call
(roofline.lockin_table_counts at the configuration's shapes) over its
device time a call in the traced window, in percent.  The kernel is the
program's csrc/lockin.cu, launched as lockin_kernel (#17)."""

import roofline
import trace_reader


def read(run):
    if run.trace is None:
        return None
    s, n = trace_reader.op_seconds(run.trace, "lockin_kernel")
    if not n:
        return None
    return 100.0 * roofline.bound_s(
        *roofline.lockin_table_counts(run.cfg["rx"])) / (s / n)
