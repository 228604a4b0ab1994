"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below the configuration's (for
float32: TF32 matmuls where the reference multiplies matrices, else
bfloat16), judged by the same comparison as a run.  It has to come out
not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Run from the root of a checkout on the card.  For each seed: the cell's
input as a run makes it, the packets a run keeps (the first, the last
of a window of --packets, and harness.KEEP drawn from the seed), each
computed by the control and compared with the float64 reference.  The
benchmark's own runs never run it; benchmark/tests/test_control.py
does, on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def readings(workload: str, seeds, n_packets: int, device: str = "cuda",
             cfg_over: dict | None = None, spec: dict | None = None) -> list:
    """[(seed, the comparison's numbers)] of the control."""
    import torch
    spec = harness.load_spec() if spec is None else spec
    cell, entry = harness.find_cell(spec, workload)
    cfg = harness.merged(harness.load_config(entry), cfg_over)
    mix = harness.load_mix(cell["traffic"])
    ref_mod = harness.reference_module(cfg)
    dev = torch.device(device)
    n_rec = int(cfg["recording_blocks"][mix["recording"]])
    out = []
    for seed in seeds:
        rec = ref_mod.make_recording(cfg, seed, n_rec, dev).cpu().numpy()
        ref = ref_mod.Reference(cfg, rec, dev)
        kept = {k: ref.output(k, control=True).cpu().numpy()
                for k in harness.kept_packets(seed, n_packets)}
        out.append((seed, harness.compare(ref, kept)))
        del rec, ref, kept
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--packets", type=int, default=20_000,
                    help="packets of the window the kept ones are drawn "
                         "from")
    args = ap.parse_args(argv)
    cell, entry = harness.find_cell(harness.load_spec(), args.workload)
    limit = harness.load_config(entry)["limits"]["rel_err"]
    for seed, r in readings(args.workload, args.seeds, args.packets):
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              limit=limit, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
