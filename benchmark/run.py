"""The port's benchmark: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA card: the
cells, their configurations, mixes and metrics are in BENCHMARK.json,
and benchmark/README.md says how a run goes and how to add to it.  The
last line of the standard output is the run's result, one JSON object;
the numbers its correctness was decided on are the last lines of the
standard error.  Without a card, or without the program beside it, the
run fails and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the run at a fixed path in the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "CUDA_CACHE_PATH": "nv_compute"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    sys.path[:0] = [HERE, ROOT]
    import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
