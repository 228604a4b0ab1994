#!/usr/bin/env python3
"""Plot raw/demodulated timestreams (the port's copy of
scripts/raw_plot.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Plot raw data.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", nargs="+",
                        help="default: most recent USRP_*.h5")
    parser.add_argument("--mode", "-m", type=str, default="IQ",
                        choices=["IQ", "PM"])
    parser.add_argument("--decimation", "-d", type=int, default=None)
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)
    os.chdir(args.folder)
    files = args.file or sorted(glob.glob("USRP_*.h5"))[-1:]
    out = u.plot_raw_data(files, mode=args.mode,
                          decimation=args.decimation, backend=args.backend)
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
