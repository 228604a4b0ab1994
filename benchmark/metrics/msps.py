"""msps: input Msamples/s, every sample demodulated in the window over
the window's whole time (the sinks' first start to their last end)."""


def read(run):
    return run.samples / run.window_s / 1e6
