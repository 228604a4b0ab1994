#!/usr/bin/env python3
"""Generate a synthetic IQ recording for replay-mode demos and tests (the
port's copy of tools/make_test_recording.py).

Writes complex64 raw (or .npy) containing a multi-tone comb, optional
simulated resonator dips and additive noise, suitable for
`python -m gpu_sdr_tpu_torch.server.main --replay <file>` or
ReplaySource.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main():
    parser = argparse.ArgumentParser(description="Synthesize IQ recording.")
    parser.add_argument("--out", "-o", type=str, default="recording.npy")
    parser.add_argument("--rate", "-r", type=float, default=1e6)
    parser.add_argument("--seconds", "-t", type=float, default=1.0)
    parser.add_argument("--tones", "-T", nargs="+", default=["100e3"],
                        help="baseband tone frequencies in Hz")
    parser.add_argument("--noise", type=float, default=1e-3,
                        help="additive complex noise RMS")
    parser.add_argument("--resonator", nargs=3, type=float, default=None,
                        metavar=("F0", "QR", "QE"),
                        help="add a resonator dip (f0 Hz, Qr, Qe)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    from gpu_sdr_tpu_torch import golden

    rate = int(args.rate)
    n = int(args.rate * args.seconds)
    tones = [int(float(t)) for t in args.tones]
    x = golden.tone_block(tones, [1.0 / len(tones)] * len(tones), rate,
                          0, n).astype(np.complex64)
    if args.resonator:
        from gpu_sdr_tpu_torch.engine.channel import make_resonator_channel
        f0, qr, qe = args.resonator
        chan = make_resonator_channel(rate,
                                      [dict(f0=f0, Qr=qr, Qe_re=qe)])
        x = chan(x)
    if args.noise > 0:
        rng = np.random.default_rng(args.seed)
        nn = rng.standard_normal(2 * n) * (args.noise / np.sqrt(2))
        x = x + (nn[::2] + 1j * nn[1::2]).astype(np.complex64)
    x = np.asarray(x, dtype=np.complex64)
    if args.out.endswith(".npy"):
        np.save(args.out, x)
    else:
        x.tofile(args.out)
    print(f"{n} samples ({n * 8 / 1e6:.1f} MB) written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
