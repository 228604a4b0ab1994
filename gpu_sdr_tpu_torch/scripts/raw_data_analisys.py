#!/usr/bin/env python3
"""Offline spectrum analysis of a raw (NODSP) capture (the port's copy of
scripts/raw_data_analisys.py): scipy's Welch on the host, drawn as a PNG
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
    parser = argparse.ArgumentParser(description="Raw capture analysis.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    parser.add_argument("--welch", "-w", type=int, default=8)
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)
    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_*.h5"))[-1]
    info = u.get_rx_info(fn)
    data = u.openH5file(fn)[0]
    from scipy import signal
    f, p = signal.welch(data, fs=info.rate, nperseg=len(data) // args.welch,
                        return_onesided=False, scaling="density")
    order = np.argsort(f)
    x = (info.tone + f[order]) / 1e6
    y = 10 * np.log10(p[order] + 1e-30)

    if args.backend == "html":
        from gpu_sdr_tpu_torch.client.htmlplot import Figure
        fig = Figure(title="Raw capture spectrum")
        fig.panel(ylabel="PSD [dB/Hz]", xlabel="Frequency [MHz]").line(
            x, y, name=os.path.basename(fn))
        out = fig.write_html("raw_spectrum.html")
    else:
        import matplotlib
        matplotlib.use("agg")
        import matplotlib.pyplot as pl
        fig, ax = pl.subplots(figsize=(10, 6))
        ax.plot(x, y)
        ax.set_xlabel("Frequency [MHz]")
        ax.set_ylabel("PSD [dB/Hz]")
        ax.grid()
        out = "raw_spectrum.png"
        fig.savefig(out, bbox_inches="tight")
    print(f"spectrum written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
