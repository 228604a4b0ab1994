"""What a chrome trace of one run says about the device.

A frozen copy of the program's trace reader (``gpu_sdr_tpu_torch/
probe.py``'s ``device_breakdown``): the window is the host-side
profiler span the benchmark's sink opens at its start and closes at its
end; the device's busy time is the union of its kernel, copy and memset
intervals clipped to the window; each operation's device time is summed
by its short name.  Added here: launches counted by name, the idle gaps
inside the window named by the host operation that overlaps each most,
and the top entries of both for the result's breakdown.
"""

from __future__ import annotations

import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"             # the profiler span of the sink's window
TOP = 10


def short_name(name: str, cat: str) -> str:
    """A kernel's name without return type, namespaces and arguments;
    a copy's or a memset's as the trace gives it."""
    if cat != "kernel":
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        name = name.split(cut)[0]
    return name.split("::")[-1] or name


def _union(spans) -> list:
    """Sorted, merged intervals of `spans`."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_events(path: str) -> list:
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def breakdown(events: list) -> dict:
    """From the events of a chrome trace: ``window_s`` (the span's
    length), ``busy_s`` (the device's busy union in it), ``op_s`` and
    ``launches`` (device seconds and events in the window by short
    name), ``device_ops`` and ``idle_gaps`` (the top TOP of each, in
    seconds).  Raises if the trace has no window or no device work in
    it."""
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e
           and e.get("cat") == "user_annotation"] or \
          [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise RuntimeError("the traced run left no window span")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans, op_us, launches = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        spans.append((a, b))
        op = short_name(e["name"], e["cat"])
        op_us[op] = op_us.get(op, 0.0) + (b - a)
        launches[op] = launches.get(op, 0) + 1
    if not spans:
        raise RuntimeError(f"no device work inside the window [{lo}, {hi}] "
                           "us of the trace")
    busy = _union(spans)
    gaps, end = [], lo
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    h_a = np.array([e["ts"] for e in host], dtype=np.float64)
    h_b = h_a + np.array([e["dur"] for e in host], dtype=np.float64)
    idle = []
    for a, b in gaps:
        ov = np.minimum(b, h_b) - np.maximum(a, h_a)
        i = int(np.argmax(ov)) if len(ov) else -1
        name = host[i]["name"] if i >= 0 and ov[i] > 0 else "nothing traced"
        idle.append([name, (b - a) / 1e6])
    ops = sorted(op_us.items(), key=lambda kv: -kv[1])
    return dict(window_s=(hi - lo) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6,
                op_s={k: v / 1e6 for k, v in op_us.items()},
                launches=launches,
                device_ops=[[k, v / 1e6] for k, v in ops[:TOP]],
                idle_gaps=idle)


def op_seconds(trace: dict, prefix: str) -> tuple:
    """(device seconds, events) of the operations whose short name
    starts with `prefix`, in the window."""
    names = [k for k in trace["op_s"] if k.startswith(prefix)]
    return (sum(trace["op_s"][k] for k in names),
            sum(trace["launches"][k] for k in names))
