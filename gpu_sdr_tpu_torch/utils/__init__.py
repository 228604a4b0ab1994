"""Infrastructure utilities: logging, diagnostics, timing (the port's
copy of gpu_sdr_tpu/utils)."""

from .log import get_logger, init_logger  # noqa: F401
from .diagnostics import StopWatch, print_error, print_warning, print_debug  # noqa: F401
