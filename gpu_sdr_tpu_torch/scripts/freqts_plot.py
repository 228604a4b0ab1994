#!/usr/bin/env python3
"""Frequency/dissipation timestream plot from a noise file with fit
parameters (the port's copy of scripts/freqts_plot.py), drawn as a PNG
(matplotlib) or an HTML page."""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Plot frequency timestreams.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    parser.add_argument("--displayed", type=int, default=10000)
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)
    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_Noise*.h5"))[-1]
    dff, dqr = u.get_frequency_timestreams(fn)
    step = max(1, dff.shape[1] // args.displayed)

    if args.backend == "html":
        from gpu_sdr_tpu_torch.client.htmlplot import Figure
        fig = Figure(title="Frequency timestreams")
        p0 = fig.panel(ylabel="df/f")
        p1 = fig.panel(ylabel="d(1/Qr)", xlabel="sample")
        for i in range(dff.shape[0]):
            n = np.arange(0, dff.shape[1], step)
            p0.line(n, dff[i, ::step], name=f"ch{i}", color=u.get_color(i))
            p1.line(n, dqr[i, ::step], name=f"ch{i}", color=u.get_color(i))
        out = fig.write_html("frequency_timestreams.html")
    else:
        import matplotlib
        matplotlib.use("agg")
        import matplotlib.pyplot as pl
        fig, (a0, a1) = pl.subplots(nrows=2, sharex=True, figsize=(10, 7))
        for i in range(dff.shape[0]):
            a0.plot(dff[i, ::step], label=f"ch{i}")
            a1.plot(dqr[i, ::step])
        a0.set_ylabel("df/f")
        a1.set_ylabel("d(1/Qr)")
        a1.set_xlabel("sample")
        a0.legend(fontsize=7)
        a0.grid(); a1.grid()
        out = "frequency_timestreams.png"
        fig.savefig(out, bbox_inches="tight")
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
