"""What the workflow scripts share: the ``--device`` and ``--backend``
flags, the device check made before any file is written, and the
optional report of a script's runs.

With GPU_SDR_TPU_RUN_REPORT naming a file, a script writes there at
exit one JSON object: ``runs``, the record of each ``run_measurement``
call it made (``measure.RUNS``: the dispatch planned and the one
taken, its RX blocks and samples, its seconds and its stream's), and
``launches``, each kernel wrapper's launch count over the script."""

from __future__ import annotations

import atexit
import json
import os

REPORT_ENV = "GPU_SDR_TPU_RUN_REPORT"


def add_device(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, cuda:N or cpu (default cuda; with no "
                             "card cuda raises)")


def add_backend(parser) -> None:
    parser.add_argument("--backend", type=str, default="matplotlib",
                        choices=["matplotlib", "html"],
                        help="plot files: PNG (matplotlib) or HTML")


def start(args) -> str:
    """Resolve ``args.device`` (a CUDA device without a card raises
    here, before any file is written) and start the run report when
    GPU_SDR_TPU_RUN_REPORT is set.  Returns the device's name."""
    from ..config import resolve_device
    dev = str(resolve_device(args.device))
    report_from_env()
    return dev


def report_from_env() -> None:
    """Start the run report when GPU_SDR_TPU_RUN_REPORT names a file
    (the path taken before a script changes its folder)."""
    path = os.environ.get(REPORT_ENV)
    if path:
        _report_to(os.path.abspath(path))


def _report_to(path: str) -> None:
    from .. import kernels, measure

    measure.RUNS.clear()
    kernels.reset_launch_counts()

    def write():
        with open(path, "w") as f:
            json.dump(dict(runs=list(measure.RUNS),
                           launches=kernels.launch_counts()), f)

    atexit.register(write)
