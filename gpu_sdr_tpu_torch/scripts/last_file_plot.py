#!/usr/bin/env python3
"""Plot the most recent measurement file in a folder (the port's copy of
scripts/last_file_plot.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Plot the newest file.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--mode", "-m", type=str, default="PM",
                        choices=["IQ", "PM"])
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)
    os.chdir(args.folder)
    files = sorted(glob.glob("USRP_*.h5"), key=os.path.getmtime)
    if not files:
        u.print_error("no measurement files found")
        return 1
    out = u.plot_raw_data([files[-1]], mode=args.mode, backend=args.backend)
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
