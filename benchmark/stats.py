"""The statistics the metric readers and the harness share."""

from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q% of the values at or below it (0 for no values)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if len(v) == 0:
        return 0.0
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def p99(values) -> float:
    return percentile(values, 99)


def latencies(t_packets: np.ndarray, due: np.ndarray, t_end: float):
    """Each due block's latency, from its due time to its packet's
    arrival at the sink; a block with no packet counts to the window's
    end."""
    n = min(len(t_packets), len(due))
    lat = t_end - due
    lat[:n] = t_packets[:n] - due[:n]
    return lat
