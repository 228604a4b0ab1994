"""setup_s: from the process's start to the window's start (the first
sink's on_start): imports, the card, the kernels' build or load, the
input, the warm-up and the window call's own set-up."""


def read(run):
    return run.setup_s
