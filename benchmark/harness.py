"""One run of one cell of the port's benchmark.

Everything that belongs to one configuration, mix or metric is found by
its name in ``BENCHMARK.json``: the configuration's file of sizes
(``configs/<config>.json``) and its plain reference beside it
(``configs/<kind>.py``), the mix's parameters (``mixes/<traffic>.json``,
read by ``traffic.py``), and each metric's reader
(``metrics/<name>.py``).

A run, in order: the card's name, count and power limit; the kernels
built or loaded (``gpu_sdr_tpu_torch/_build/``); the cell's input made
from the seed on the card and moved to host RAM; one short warm-up
``run_measurement`` of the cell's own shapes; the measured window, one
``run_measurement`` whose source ends it (a replay's call sized from the
warm-up's rate); then, with the window closed and the program's state
freed, the comparison of the packets kept from the window against the
plain reference.  The window's sink keeps the first packet, the last,
and KEEP more drawn from the seed (reservoir sampling), all by
reference: the program hands the sinks a fresh host buffer a packet.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import resource
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

import stats
import trace_reader
import traffic
from gpu_sdr_tpu_torch.engine.sinks import Sink

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_sdr_tpu")
KEEP = 12                   # packets drawn from the seed for the comparison
RX = "A_RX2"                # the receiving antenna of every configuration
ENDLESS_BLOCKS = 10 ** 7    # a host cell's plan: its source ends the window
TRACE_SECONDS = 3.0         # the traced part of a --trace 1 window


class NoCard(RuntimeError):
    pass


# ---------------------------------------------------------------- the data

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, workload: str) -> tuple:
    """(cell, configuration entry) of `workload`."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return cell, entry


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(entry: dict, root: Path = ROOT) -> dict:
    return json.loads((root / entry["file"]).read_text())


def load_mix(name: str) -> dict:
    return json.loads((BENCH_DIR / "mixes" / f"{name}.json").read_text())


def reference_module(cfg: dict):
    kind = cfg["kind"]
    return load_module(BENCH_DIR / "configs" / f"{kind}.py",
                       f"bench_reference_{kind}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


def cell_metrics(spec: dict, workload: str, section: str) -> list:
    """The metrics of `section` a cell reports: those that list it, and
    those without a list (an end-to-end metric in every cell, a
    per-layer one in every cell that reports the metric it moves)."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])}
    if section == "end_to_end":
        return [m for m in spec["end_to_end"] if m["name"] in e2e]
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in e2e)]


def merged(base: dict, over: dict | None) -> dict:
    """`base` with `over`'s keys, dictionaries merged one level down."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def rx_params(cfg: dict, samples: int):
    """The configuration's receiver alone (TX off: the benchmark's input
    stands in for the radio), acquiring `samples` samples."""
    from gpu_sdr_tpu_torch.params import (AntennaParams, AntMode,
                                          UsrpParams, WaveType)
    rx = dict(cfg["rx"])
    wave = WaveType[rx.pop("wave_type")]
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, samples=int(samples),
                            wave_type=[wave] * len(rx["freq"]), **rx)
    return p


# ---------------------------------------------------------------- the card

def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {chips}")


def card_info(dev) -> dict:
    """The card's name from torch, and nvidia-smi's name and power
    limit where it answers."""
    import torch
    if dev.type != "cuda":
        return dict(kind="cpu", smi="")
    smi = ""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        smi = out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        pass
    return dict(kind=torch.cuda.get_device_name(dev), smi=smi)


# ---------------------------------------------------------------- the sink

class Reservoir:
    """Which packets a window keeps besides its first and last: KEEP of
    packets 1, 2, ... drawn from `seed` (reservoir sampling), each
    offered in turn."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def offer(self, k: int) -> int | None:
        """The slot packet k (from 1) takes, or None."""
        if k <= KEEP:
            return k - 1
        j = self.rng.randrange(k)
        return j if j < KEEP else None


def kept_packets(seed: int, n: int) -> list:
    """The packet numbers a window of n packets keeps."""
    res, slots = Reservoir(seed), [0] * min(KEEP, max(n - 1, 0))
    for k in range(1, n):
        j = res.offer(k)
        if j is not None:
            slots[j] = k
    return sorted({0, n - 1, *slots})


class WindowSink(Sink):
    """Stamps the window and every packet on the host clock, checks
    packet numbers, and keeps the first packet, the last and KEEP
    drawn from `seed` by reference.  With `span`, a profiler span of
    that name covers the window."""

    def __init__(self, seed: int, span: str | None = None,
                 span_s: float = 0.0, on_span_end=None):
        self.reservoir = Reservoir(seed)
        self.span_name, self._span = span, None
        self.span_s, self.on_span_end = span_s, on_span_end
        self.span_packets = 0
        self.starts, self.ends, self.t = [], [], []
        self.misordered = self.errors = 0
        self.first = self.last = None
        self.slots: list = []           # [(packet, data)]

    def on_start(self, n_channels, expected_rows):
        self.starts.append(time.perf_counter())
        if self.span_name and self._span is None:
            import torch
            self._span = torch.profiler.record_function(self.span_name)
            self._span.__enter__()

    def _close_span(self):
        self._span.__exit__(None, None, None)
        self._span = None
        self.span_packets = len(self.t)
        if self.on_span_end is not None:
            self.on_span_end()

    def on_packet(self, meta, data):
        k = len(self.t)
        self.t.append(time.perf_counter())
        if self._span is not None and \
                self.t[-1] - self.starts[0] >= self.span_s:
            self._close_span()
        self.misordered += meta.packet_number != k
        self.errors += int(meta.errors)
        if k == 0:
            self.first = data
        else:
            j = self.reservoir.offer(k)
            if j == len(self.slots):
                self.slots.append((k, data))
            elif j is not None:
                self.slots[j] = (k, data)
        self.last = (k, data)

    def on_end(self):
        if self._span is not None:
            self._close_span()
        self.ends.append(time.perf_counter())

    def kept(self) -> dict:
        """packet number -> data of the packets kept."""
        out = dict(self.slots)
        if self.first is not None:
            out[0] = self.first
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


# ---------------------------------------------------------------- a run

def _measure(params, source, sink, dev):
    from gpu_sdr_tpu_torch import measure
    measure.run_measurement(params, source=source, extra_sinks=[sink],
                            device=dev)
    return measure.last_dispatch(), measure.RUNS[-1]


def _profiler():
    """A torch.profiler of the host and the device, not yet started."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _read_trace(prof, log) -> dict:
    """The breakdown of a stopped profiler's trace, through a chrome
    trace in a temporary file in TMPDIR, read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t = time.perf_counter()
        prof.export_chrome_trace(path)
        events = trace_reader.read_events(path)
        print(f"trace: {len(events)} events, {os.path.getsize(path) / 1e6:.1f}"
              f" MB, written and read in {time.perf_counter() - t:.1f} s",
              file=log, flush=True)
        return trace_reader.breakdown(events)
    finally:
        os.unlink(path)


def rel_err(y: np.ndarray, ref) -> float:
    """The worst channel's largest error over its reference's rms."""
    import torch
    d = torch.from_numpy(np.ascontiguousarray(y)).to(ref.device,
                                                     torch.complex128)
    ref = ref.to(torch.complex128)
    rms = ref.abs().pow(2).mean(0).sqrt().clamp_min(1e-300)
    return float(((d - ref).abs().amax(0) / rms).max())


def compare(ref, kept: dict, control: bool = False) -> dict:
    """The comparison of the kept packets with the reference: the worst
    rel_err, and the packets of another shape or type."""
    worst, bad = 0.0, 0
    for k in sorted(kept):
        y, r = kept[k], ref.output(k, control=control)
        if tuple(y.shape) != tuple(r.shape) or y.dtype != np.complex64:
            bad += 1
            continue
        worst = max(worst, rel_err(y, r))
    return dict(rel_err=worst, bad_packets=bad)


def steady_msps(t: np.ndarray, block_len: int) -> float:
    """The rate of a call's second half of packets, from their arrival
    times: what a longer call of the same kind sustains."""
    h = len(t) // 2
    if len(t) - h < 2 or t[-1] <= t[h]:
        raise RuntimeError(f"{len(t)} warm-up packets: too few to rate")
    return (len(t) - 1 - h) * block_len / (t[-1] - t[h]) / 1e6


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class HostWatch:
    """What the host did while a window ran, for the standard error: the
    process's CPU seconds and involuntary context switches, the
    machine's CPU time stolen by its hypervisor, and the time the
    garbage collector took, by generation."""

    def __init__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = None

    @staticmethod
    def _steal() -> tuple:
        """(steal, all) jiffies of the machine's CPUs, or (0, 0)."""
        try:
            with open("/proc/stat") as f:
                v = [int(x) for x in f.readline().split()[1:]]
            return v[7], sum(v)
        except (OSError, IndexError, ValueError):
            return 0, 0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1
            self._t = None

    def __enter__(self):
        self.ru0, self.st0 = resource.getrusage(resource.RUSAGE_SELF), \
            self._steal()
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.ru1, self.st1 = resource.getrusage(resource.RUSAGE_SELF), \
            self._steal()

    def report(self, t: np.ndarray, log) -> None:
        """Prints the host's share in the window, and the spacing of
        the packets `t` (the sink's arrival times)."""
        cpu = (self.ru1.ru_utime + self.ru1.ru_stime -
               self.ru0.ru_utime - self.ru0.ru_stime)
        d_all = self.st1[1] - self.st0[1]
        steal = 100.0 * (self.st1[0] - self.st0[0]) / d_all if d_all else 0.0
        print(f"host: process CPU {cpu:.3f} s, involuntary switches "
              f"{self.ru1.ru_nivcsw - self.ru0.ru_nivcsw}, voluntary "
              f"{self.ru1.ru_nvcsw - self.ru0.ru_nvcsw}, steal {steal:.3f}%, "
              "gc " + ", ".join(f"gen{g} {n} in {s:.4f} s" for g, (n, s)
                                in enumerate(zip(self.gc_n, self.gc_s))),
              file=log, flush=True)
        gaps = np.diff(t)
        if len(gaps) < 2:
            return
        med = float(np.median(gaps))
        slow = gaps[gaps > 4 * med]
        print("packet spacing ms: " + ", ".join(
            f"p{q} {1e3 * stats.percentile(gaps, q):.4f}"
            for q in (10, 50, 90, 99, 99.9)) +
            f", max {1e3 * gaps.max():.4f}; {len(slow)} gaps over 4x the "
            f"median, {slow.sum():.4f} s in all",
            file=log, flush=True)


def _account(src, sink, mix: dict, n_plan: int, log) -> tuple:
    """(blocks attempted, blocks failed, each due block's latency or
    None) of a window.  An open loop's blocks are those due, failed when
    over the mix's late limit; a closed loop's or a replay's those sent,
    failed when no packet came."""
    t = np.asarray(sink.t)
    if getattr(src, "period", None) is None:
        attempted = len(src.sent) if hasattr(src, "sent") else n_plan
        return attempted, attempted - len(t), None
    late = src.lateness()
    print(f"source lateness: {len(late)} blocks due before asked, max "
          f"{1e3 * late.max() if len(late) else 0.0:.4f} ms, p99 "
          f"{1e3 * stats.p99(late):.4f} ms", file=log, flush=True)
    due = src.due()
    lat = stats.latencies(t, due, sink.ends[-1])
    print("block latency ms: " + ", ".join(
        f"p{q} {1e3 * stats.percentile(lat, q):.4f}"
        for q in (50, 90, 95, 99)) + f", max {1e3 * lat.max():.4f}",
        file=log, flush=True)
    return len(due), int(np.sum(lat > float(mix["late_limit_s"]))), lat


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t0: float | None = None, device: str = "cuda",
        need_card: bool = True, cfg_over: dict | None = None,
        mix_over: dict | None = None, spec: dict | None = None,
        log=sys.stderr) -> dict:
    """One run of `workload` of `spec` (BENCHMARK.json's): the result
    line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec() if spec is None else spec
    cell, entry = find_cell(spec, workload)
    cfg = merged(load_config(entry), cfg_over)
    mix = merged(load_mix(cell["traffic"]), mix_over)
    ref_mod = reference_module(cfg)
    import torch
    if need_card:
        check_card(int(cell["chips"]))
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    card = card_info(dev)
    print(f"card: {card['smi'] or card['kind']}", file=log, flush=True)
    if dev.type == "cuda":
        from gpu_sdr_tpu_torch.kernels import build
        build.load()
    L = int(cfg["rx"]["buffer_len"])
    n_rec = int(cfg["recording_blocks"][mix["recording"]])
    rec = ref_mod.make_recording(cfg, seed, n_rec, dev).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    want = ((RX, mix["path"], cfg["dispatch"][mix["path"]]),)
    host = mix["recording"] == "host"

    # warm-up: the cell's shapes, one short call
    if host:
        src = traffic.make_source({**mix, "rate_msps": None}, rec, L,
                                  max_blocks=int(mix["warmup_blocks"]))
        n_warm = ENDLESS_BLOCKS
    else:
        src = traffic.make_source(mix, rec, L)
        n_warm = int(mix["warmup_passes"]) * n_rec
    sink = WindowSink(seed)
    disp, _ = _measure(rx_params(cfg, n_warm * L), src, sink, dev)
    if disp != want:
        raise RuntimeError(f"warm-up dispatch {disp}, the cell wants {want}")
    warm_msps = steady_msps(np.asarray(sink.t), L)
    del sink, src

    # the window
    if host:
        src = traffic.make_source(mix, rec, L, seconds=seconds)
        n_plan = ENDLESS_BLOCKS
    else:
        src = traffic.make_source(mix, rec, L)
        n_plan = max(1, round(warm_msps * 1e6 * seconds / L))
    params = rx_params(cfg, n_plan * L)
    prof = _profiler() if trace else None
    sink = WindowSink(seed, span=trace_reader.WINDOW if trace else None,
                span_s=min(seconds, TRACE_SECONDS),
                on_span_end=prof.stop if trace else None)
    if trace:
        prof.start()
    with HostWatch() as host_watch:
        disp, record = _measure(params, src, sink, dev)
    tr = None
    if trace:
        tr = _read_trace(prof, log)
        tr["packets"] = sink.span_packets
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")

    packets = len(sink.t)
    window_s = sink.ends[-1] - sink.starts[0]
    tenths = np.histogram(np.asarray(sink.t), bins=10,
                          range=(sink.starts[0], sink.ends[-1]))[0]
    attempted, failed, lat = _account(src, sink, mix, n_plan, log)
    host_watch.report(np.asarray(sink.t), log)
    ctx = types.SimpleNamespace(
        cfg=cfg, setup_s=sink.starts[0] - t0, window_s=window_s,
        packets=packets, samples=packets * L, latencies=lat,
        measure_run=record, trace=tr)

    # the comparison, with the program's state freed
    kept = sink.kept()
    errors, misordered = sink.errors, sink.misordered
    del sink, src
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_mod.Reference(cfg, rec, dev)
    cmp = compare(ref, kept)
    limit = cfg["limits"]["rel_err"]
    checks = {
        "rel_err": (cmp["rel_err"], limit),
        "missing_packets": (attempted - packets, 0),
        "misordered_packets": (misordered, 0),
        "bad_packets": (cmp["bad_packets"], 0),
        "packet_errors": (errors, 0),
        "dispatch_mismatch": (int(disp != want), 0),
    }
    correct = all(lim is not None and v <= lim for v, lim in checks.values())

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, workload, section):
        v = metric_reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": card["kind"], "count": int(cell["chips"]),
                  "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_out}
    if tr is not None:
        device_out.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    print("Msps by tenths of the window: " + " ".join(
        f"{n * L / (window_s / 10) / 1e6:.0f}" for n in tenths),
        file=log, flush=True)
    print(f"dispatch {list(disp)}; {packets} packets in {window_s:.4f} s "
          f"({packets * L / window_s / 1e6:.1f} Msps); warm-up "
          f"{warm_msps:.1f} Msps; compared packets {sorted(kept)}",
          file=log, flush=True)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=log, flush=True)
    return out


def main(args, t0: float) -> int:
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t0=t0)
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0
