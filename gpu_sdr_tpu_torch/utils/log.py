"""Logging: rotating files with the reference's record format.

Equivalent of the reference boost::log setup (init_logger,
cpp/USRP_server_diagnostic.cpp:421-439): rotating files under logs/ named
by timestamp, 10 MB rotation, record format
``TimeStamp;ThreadName;Severity;Message``.  The port's loggers live under
``gpu_sdr_tpu_torch``.
"""

from __future__ import annotations

import datetime
import logging
import logging.handlers
import os
import threading

_FORMAT = "%(asctime)s;%(threadName)s;%(levelname)s;%(message)s"
ROOT = "gpu_sdr_tpu_torch"
_initialized = False


def init_logger(log_dir: str = "logs", level: int = logging.INFO,
                max_bytes: int = 10 * 1024 * 1024,
                backup_count: int = 100) -> logging.Logger:
    """Install the rotating file handler (idempotent)."""
    global _initialized
    root = logging.getLogger(ROOT)
    if _initialized:
        return root
    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(log_dir, f"{stamp}_00000.log")
    handler = logging.handlers.RotatingFileHandler(
        path, maxBytes=max_bytes, backupCount=backup_count)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    root.setLevel(level)
    _initialized = True
    return root


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")


def set_this_thread_name(name: str) -> None:
    """Name the current thread for log records and OS tools
    (reference set_this_thread_name, cpp/USRP_server_diagnostic.cpp:4-11)."""
    threading.current_thread().name = name
