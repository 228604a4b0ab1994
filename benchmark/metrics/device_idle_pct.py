"""device_idle_pct: 100 less the device's busy union over the traced
window, in percent of the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
