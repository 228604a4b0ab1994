"""device_ms_per_block.realtime: the device's busy union over the
traced window, in milliseconds per packet delivered in it."""


def read(run):
    if run.trace is None or not run.trace["packets"]:
        return None
    return 1e3 * run.trace["busy_s"] / run.trace["packets"]
