"""block_latency_p99_ms: the 99th percentile, by nearest rank, over
every block due in the window, of the time from its due time to its
packet's arrival at the sink (a block with no packet counts to the
window's end)."""

import stats


def read(run):
    if run.latencies is None:
        return None
    return 1e3 * stats.p99(run.latencies)
