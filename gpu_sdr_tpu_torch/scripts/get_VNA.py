#!/usr/bin/env python3
"""VNA scan over a gain x frequency grid with automatic line-delay
calibration (the port's copy of scripts/get_VNA.py).  The line delay's
diagnostic PNG is drawn with the matplotlib backend only."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402

import numpy as np  # noqa: E402


def run(gain, iters, rate, freq, front_end, f0, f1, lapse, points, ntones,
        delay_duration, delay_over, device, backend):
    if str(int(rate / 1e6)) not in u.LINE_DELAY:
        if delay_over is None:
            print("Measuring line delay before VNA...")
            filename = u.measure_line_delay(
                rate, freq, front_end, duration=delay_duration,
                compensate=True, device=device)
            delay = u.analyze_line_delay(filename, backend == "matplotlib")
            u.write_delay_to_file(filename, delay)
            u.load_delay_from_file(filename)
        else:
            u.set_line_delay(rate, delay_over)
    if ntones == 1:
        ntones = None
    return u.Single_VNA(start_f=f0, last_f=f1, measure_t=lapse,
                        n_points=points, tx_gain=gain, Rate=rate,
                        decimation=True, RF=freq, Front_end=front_end,
                        Multitone_compensation=ntones, Iterations=iters,
                        device=device)


def main():
    parser = argparse.ArgumentParser(description="Run VNA scans.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq", "-f", nargs="+",
                        help="LO frequencies in MHz")
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--frontend", "-rf", type=str, default="A")
    parser.add_argument("--f0", type=float, default=-45)
    parser.add_argument("--f1", type=float, default=+45)
    parser.add_argument("--points", "-p", type=float, default=50e3)
    parser.add_argument("--time", "-t", type=float, default=10)
    parser.add_argument("--iter", "-i", type=float, default=1)
    parser.add_argument("--gain", "-g", nargs="+")
    parser.add_argument("--tones", type=int, default=1)
    parser.add_argument("--delay_duration", "-dd", type=float, default=0.01)
    parser.add_argument("--delay_over", "-do", type=float, default=None)
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    device = _cli.start(args)

    frequencies = [float(a) for a in (args.freq or [300])]
    gains = [int(float(a)) for a in (args.gain or [0])]
    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        u.print_error("Cannot reach the server")
        return 1

    f0 = np.clip(args.f0, -args.rate / 2, args.rate / 2)
    f1 = np.clip(args.f1, -args.rate / 2, args.rate / 2)
    for g in gains:
        for f in frequencies:
            fn = run(gain=g, iters=int(args.iter), rate=args.rate * 1e6,
                     freq=f * 1e6, front_end=args.frontend, f0=f0 * 1e6,
                     f1=f1 * 1e6, lapse=args.time, points=int(args.points),
                     ntones=args.tones, delay_duration=args.delay_duration,
                     delay_over=args.delay_over, device=device,
                     backend=args.backend)
            print(f"VNA data written to {fn}")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
