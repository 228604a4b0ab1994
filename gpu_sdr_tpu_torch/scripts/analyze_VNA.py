#!/usr/bin/env python3
"""Analyze + plot VNA files (the port's copy of scripts/analyze_VNA.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Analyze VNA files.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", nargs="+",
                        help="VNA files (default: all USRP_VNA* in folder)")
    parser.add_argument("--no_plot", action="store_true")
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)

    os.chdir(args.folder)
    files = args.file or sorted(glob.glob("USRP_VNA*.h5"))
    for fn in files:
        if not u.is_VNA_analyzed(fn):
            u.VNA_analysis(fn)
        print(f"analyzed {fn}")
    if files and not args.no_plot:
        out = u.plot_VNA(files, backend=args.backend)
        print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
