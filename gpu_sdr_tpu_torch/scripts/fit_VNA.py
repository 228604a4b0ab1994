#!/usr/bin/env python3
"""Initialize peaks, fit resonators, plot (the port's copy of
scripts/fit_VNA.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import gpu_sdr_tpu_torch.pyusrp as u  # noqa: E402
from gpu_sdr_tpu_torch.scripts import _cli  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Fit VNA resonators.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    parser.add_argument("--peaks", "-p", type=int, default=1,
                        help="expected number of resonators")
    parser.add_argument("--peak_width", "-w", type=float, default=90e3)
    parser.add_argument("--Qr_cutoff", "-q", type=float, default=5e3)
    parser.add_argument("--fit_range", type=float, default=10e4)
    parser.add_argument("--gradient", action="store_true",
                        help="use the simple gradient peak estimator")
    _cli.add_device(parser)
    _cli.add_backend(parser)
    args = parser.parse_args()
    _cli.start(args)

    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_VNA*.h5"))[-1]
    if not u.is_VNA_analyzed(fn):
        u.VNA_analysis(fn)
    if args.gradient:
        n = u.extimate_peak_number(fn, peak_width=args.peak_width)
        print(f"gradient estimator initialized {n} peaks")
    else:
        ok = u.initialize_peaks(fn, N_peaks=args.peaks,
                                peak_width=args.peak_width,
                                Qr_cutoff=args.Qr_cutoff)
        print(f"initialize_peaks: {'ok' if ok else 'count mismatch'}")
    u.vna_fit(fn, fit_range=args.fit_range)
    for i, p in enumerate(u.get_fit_param(fn)):
        print(f"reso_{i}: f0={p['f0']:.6f} MHz Qr={p['Qr']:.0f} "
              f"Qi={p['Qi']:.0f} a={p['a']:.3f}")
    out = u.plot_resonators(fn, backend=args.backend)
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
