#!/usr/bin/env python3
"""Compute and plot noise PSDs (the port's copy of
scripts/analyze_noise.py).  The Welch PSDs run on --device
(calculate_noise's torch backend)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Analyze noise files.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", nargs="+")
    parser.add_argument("--welch", "-w", type=int, default=None)
    parser.add_argument("--dbc", action="store_true")
    parser.add_argument("--no_plot", action="store_true")
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    device = _cli.start(args)

    os.chdir(args.folder)
    files = args.file or sorted(glob.glob("USRP_Noise*.h5"))
    for fn in files:
        u.calculate_noise(fn, welch=args.welch, dbc=args.dbc,
                          backend="torch", device=device)
        print(f"analyzed {fn}")
    if files and not args.no_plot:
        out = u.plot_noise_spec(files, dbc=args.dbc, backend=args.backend)
        print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
