#!/usr/bin/env python3
"""Per-sweep (dynamic) VNA analysis + waterfall plot (the port's copy of
scripts/analyze_dynamic_VNA.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Dynamic VNA analysis.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)
    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_VNA*.h5"))[-1]
    u.VNA_timestream_analysis(fn)
    out = u.VNA_timestream_plot(fn, backend=args.backend)
    print(f"dynamic VNA waterfall written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
