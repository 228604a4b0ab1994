#!/usr/bin/env python3
"""Dual-frontend noise acquisition (the port's copy of
scripts/get_dual_noise.py)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Dual-frontend noise acquisition.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq_a", type=float, default=300)
    parser.add_argument("--freq_b", type=float, default=500)
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--tones_a", "-TA", nargs="+", default=["1"])
    parser.add_argument("--tones_b", "-TB", nargs="+", default=["1"])
    parser.add_argument("--decimation", "-d", type=int, default=100)
    parser.add_argument("--time", "-t", type=float, default=10)
    parser.add_argument("--gain", "-g", type=int, default=0)
    parser.add_argument("--mode", "-m", type=str, default="DIRECT")
    _cli.add_device(parser)
    args = parser.parse_args()
    device = _cli.start(args)

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        return 1
    fn = u.dual_get_noise(
        [float(t) * 1e6 for t in args.tones_a],
        [float(t) * 1e6 for t in args.tones_b],
        measure_t=args.time, rate=args.rate * 1e6,
        decimation=args.decimation, RF_A=args.freq_a * 1e6,
        RF_B=args.freq_b * 1e6, tx_gain=args.gain, mode=args.mode,
        device=device)
    print(f"dual noise data written to {fn}")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
