"""The main-path cells, and where their time goes on one CUDA card.

    python -m gpu_sdr_tpu_torch.probe [CELL ...]

Run from the root of a checkout; with CELL names, only those cells.
The cells are the runs that ``chip_smoke.py`` drives through
``measure.run_measurement`` (it takes its configurations from here):

* TONES fused and host-fed: the reference's network-stress
  configuration, 1000 bin-quantized tones at 100 Msps into a 1000-bin
  PFB receiver, 6,000,000-sample blocks (bench.py:83-105);
* DIRECT config 3 fused and host-fed, config 1 fused, and config 3's
  comb quantized to a 100 kHz grid, fused: BASELINE's DIRECT widths
  (tools/bench_configs.py:68-105), 100 Msps, 4,000,000-sample blocks,
  decim 100, pf_average 4;
* CHIRP config 2 fused (50 blocks, two period wraps) and host-fed (25
  blocks, one period): BASELINE's VNA sweep (tools/bench_configs.py:
  86-95), a -40 to +40 MHz chirp of 5000 steps over 1 s at 100 Msps,
  lock-in at decim 1 (ppt 20,000), 4,000,000-sample blocks of 200
  segments, a 100,000,000-sample (800 MB) period;
* TONES config 5 dual fused: BASELINE config 5, the dual-channel
  readout, the network-stress configuration on front ends A and B in
  lock-step (engine/dual.py), B's tones at half A's amplitude;
* replay through ``run_measurement(source=ReplaySource(..., loop=True))``
  of a recording of the TX signal of a loopback cell, made by the port's
  generator and uploaded once: TONES (8 blocks, ``channelizer_at``),
  DIRECT config 3 (8 blocks, ``replay_kernel``), CHIRP config 2 (10
  blocks, ``chirp_table``) and config 2 at 6,000,000-sample blocks,
  which do not divide its period (8 blocks, ``chirp_at``).  The upload
  is set-up.

For each cell, after one warm-up run: RUNS runs into a sink that drops
every packet unread, each with its set-up seconds (``run_measurement``
called to the sink's start) and its rate (input Msamples/s, host clock,
sink start to sink end); then one run of PROFILE_BLOCKS blocks under
``torch.profiler`` with the device's busy share (the union of its
kernel and copy intervals over the sink's window) and the device
milliseconds per block of the largest operations (a dual cell's rates
are per front end, its totals beside them, and its device ms per block
cover both front ends' blocks).  The profiler's own
host cost slows that run, so its rate is printed beside it.  The last
line of the output is one JSON object with every number.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# TONES: the network-stress configuration
NFFT, AVG, RATE = 1000, 4, 100_000_000
FRAMES = 6000                       # frames of one 6,000,000-sample block
BLOCK = NFFT * FRAMES

# DIRECT: BASELINE configs 1 and 3
D_RATE, D_BLOCK, D_DECIM, D_AVG = 100_000_000, 4_000_000, 100, 4
CONFIG1 = [10_000_000]                           # amplitude 1.0
CONFIG3 = [int(f) for f in np.linspace(-45e6, 45e6, 100)]   # 0.01 each
QCOMB = [int(round(f / 1e5)) * 100_000 for f in CONFIG3]    # period 1000

# CHIRP: BASELINE config 2
C_RATE, C_BLOCK = 100_000_000, 4_000_000
AT_BLOCK = 6_000_000                # config 2 at 300 segments a block
CONFIG2 = dict(freq=[-40_000_000], chirp_f=[40_000_000], chirp_t=[1.0],
               swipe_s=[5000])                   # amplitude 1.0, decim 1

RUNS = 3
PROFILE_BLOCKS = 30
TOP_OPS = 6
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "probe.stream"             # the profiler span of the sink's window


def loopback_params(n_blocks: int):
    """The network-stress configuration: a 1000-channel PFB readout of
    1000 bin-quantized tones, `n_blocks` blocks."""
    from .params import AntMode, AntennaParams, UsrpParams, WaveType
    freqs = [k * (RATE // NFFT) for k in range(-NFFT // 2, NFFT // 2)]
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=BLOCK,
                             freq=freqs, ampl=[1.0 / NFFT] * NFFT,
                             wave_type=[WaveType.TONES] * NFFT)
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=NFFT,
                            pf_average=AVG, buffer_len=BLOCK,
                            samples=n_blocks * BLOCK, freq=freqs,
                            wave_type=[WaveType.TONES] * NFFT)
    return p


def config5_params(n_blocks: int):
    """BASELINE config 5, the dual-channel readout: the network-stress
    configuration on front end A, and on B the same 1000 bins at half
    the amplitude (so a swap of A and B shows), `n_blocks` blocks each."""
    from .params import AntennaParams
    p = loopback_params(n_blocks)
    p.B_TXRX = AntennaParams(**{**p.A_TXRX.__dict__,
                                "ampl": [0.5 / NFFT] * NFFT})
    p.B_RX2 = AntennaParams(**p.A_RX2.__dict__)
    return p


def direct_params(freqs, ampl, n_blocks: int):
    """BASELINE config 1 / 3 geometry for a TX comb into a DIRECT
    receiver at the same frequencies, `n_blocks` blocks."""
    from .params import AntMode, AntennaParams, UsrpParams, WaveType
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=D_RATE,
                             buffer_len=D_BLOCK, freq=list(freqs),
                             ampl=[ampl] * len(freqs),
                             wave_type=[WaveType.TONES] * len(freqs))
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=D_RATE,
                            buffer_len=D_BLOCK, decim=D_DECIM,
                            pf_average=D_AVG, samples=n_blocks * D_BLOCK,
                            freq=list(freqs),
                            wave_type=[WaveType.DIRECT] * len(freqs))
    return p


def chirp_params(n_blocks: int, block: int = C_BLOCK):
    """BASELINE config 2: the VNA chirp looped into a lock-in receiver
    with the same chirp, `n_blocks` blocks of `block` samples."""
    from .params import AntMode, AntennaParams, UsrpParams, WaveType

    def chirp():
        return dict(wave_type=[WaveType.CHIRP],
                    **{k: list(v) for k, v in CONFIG2.items()})
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=C_RATE,
                             buffer_len=block, ampl=[1.0], **chirp())
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=C_RATE,
                            buffer_len=block, decim=1,
                            samples=n_blocks * block, **chirp())
    return p


def chirp6m_params(n_blocks: int):
    """Config 2 at 6,000,000-sample blocks (300 segments), which do not
    divide the 100,000,000-sample period: no one-period table serves
    them, so a replay takes the in-kernel chirp (chirp_at)."""
    return chirp_params(n_blocks, AT_BLOCK)


def tx_recording(params, n_blocks: int, block: int, device) -> np.ndarray:
    """`n_blocks` blocks of the TX signal of a configuration, made by the
    port's generator on `device`: the recording of a loopback."""
    from .engine.generator import make_generator
    gen = make_generator(params(n_blocks).A_TXRX, block, device)
    return np.concatenate(list(gen.blocks(n_blocks)))


def save_recording(directory: str, name: str, rec: np.ndarray) -> str:
    """The recording as a .npy file, for engine/sources.ReplaySource."""
    path = os.path.join(directory, name + ".npy")
    np.save(path, rec)
    return path


def receiver_only(p):
    """The configuration with its TX antenna off: a recording feeds RX."""
    from .params import AntennaParams
    p.A_TXRX = AntennaParams()
    return p


SHARDED_SHAPES = ((1, 1), (2, 1))    # meshes of one card: virtual shards
SHARDED_CELLS = ("TONES fused", "DIRECT config 3 fused", "TONES replay",
                 "DIRECT config 3 replay")


def cells():
    """(name, params(n_blocks), host-fed, blocks per run, block length,
    blocks of the looped recording a replay cell reads, else None, mesh
    shape or None): the single-device cells, then SHARDED_CELLS again
    through run_measurement(mesh=...) on each of SHARDED_SHAPES."""
    base = [c + (None,) for c in _cells()]
    return tuple(base) + tuple(
        (f"{c[0]} on {shape}",) + c[1:6] + (shape,)
        for shape in SHARDED_SHAPES for c in base if c[0] in SHARDED_CELLS)


def _cells():
    def config3(n):
        return direct_params(CONFIG3, 0.01, n)
    return (
        ("TONES fused", loopback_params, False, 100, BLOCK, None),
        ("TONES host-fed", loopback_params, True, 20, BLOCK, None),
        ("DIRECT config 3 fused", config3, False, 50, D_BLOCK, None),
        ("DIRECT config 1 fused",
         lambda n: direct_params(CONFIG1, 1.0, n), False, 50, D_BLOCK, None),
        ("DIRECT quantized comb fused",
         lambda n: direct_params(QCOMB, 0.01, n), False, 50, D_BLOCK, None),
        ("DIRECT config 3 host-fed", config3, True, 10, D_BLOCK, None),
        ("CHIRP config 2 fused", chirp_params, False, 50, C_BLOCK, None),
        ("CHIRP config 2 host-fed", chirp_params, True, 25, C_BLOCK, None),
        ("TONES replay", loopback_params, False, 100, BLOCK, 8),
        ("DIRECT config 3 replay", config3, False, 50, D_BLOCK, 8),
        ("CHIRP config 2 replay", chirp_params, False, 50, C_BLOCK, 10),
        ("CHIRP config 2 replay, 6M blocks", chirp6m_params, False, 50,
         AT_BLOCK, 8),
        ("TONES config 5 dual fused", config5_params, False, 100, BLOCK,
         None),
    )


def front_ends(params) -> int:
    """The active RX antennas of a configuration."""
    from .params import AntMode
    return len(list(params.active_antennas(AntMode.RX)))


def run_once(dev, params, host_fed: bool, window=None, source=None,
             mesh=None):
    """One run_measurement into a dropping sink, fed from `source` when
    given, on `mesh` when given: (dispatch, packets, set-up s, streaming
    s).  The sink serves every front end: the window runs from the
    first start to the last end.  With `window`, a profiler span of that
    name covers it."""
    import torch
    from . import measure
    from .engine.channel import IdealChannel
    from .engine.sinks import Sink
    stamps, span = [], []
    n_fe = front_ends(params)

    class DropSink(Sink):
        packets = ends = 0

        def on_start(self, n_channels, expected_rows):
            stamps.append(time.perf_counter())
            if window and not span:
                span.append(torch.profiler.record_function(window))
                span[0].__enter__()

        def on_packet(self, meta, data):
            self.packets += 1

        def on_end(self):
            self.ends += 1
            if span and self.ends == n_fe:
                span[0].__exit__(None, None, None)
            stamps.append(time.perf_counter())

    sink = DropSink()
    t0 = time.perf_counter()
    measure.run_measurement(params, extra_sinks=[sink], device=dev,
                            channel=IdealChannel() if host_fed else None,
                            source=source, mesh=mesh)
    return (measure.last_dispatch(), sink.packets, stamps[0] - t0,
            stamps[-1] - stamps[0])


def _short(name: str, cat: str) -> str:
    """A kernel's name without return type, namespaces and arguments."""
    if cat != "kernel":
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        name = name.split(cut)[0]
    return name.split("::")[-1] or name


def device_breakdown(trace_path: str, n_blocks: int):
    """(busy share of the sink's window, [(op, device ms per block)])
    from a chrome trace of one profiled run."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise RuntimeError("the profiled run left no sink window")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans, per_op = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        spans.append((a, b))
        op = _short(e["name"], e["cat"])
        per_op[op] = per_op.get(op, 0.0) + (b - a) / 1e3 / n_blocks
    if not spans:
        dev = [e for e in events
               if e.get("cat") in DEVICE_CATS and "dur" in e]
        raise RuntimeError(
            f"no device work inside the sink's window [{lo}, {hi}] us: the "
            f"trace holds {len(dev)} device events" +
            (f" in [{min(e['ts'] for e in dev)}, "
             f"{max(e['ts'] + e['dur'] for e in dev)}] us" if dev else ""))
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return busy / (hi - lo), top


def probe_cell(dev, name, params, host_fed, n_blocks, block, rec_blocks,
               shape=None):
    from torch.profiler import ProfilerActivity, profile
    from .engine.sources import ReplaySource
    from .parallel import make_mesh
    mesh = None if shape is None else make_mesh(
        shape, devices=[dev] * int(np.prod(shape)))
    with tempfile.TemporaryDirectory() as tmp:
        path = None
        if rec_blocks:          # the loopback's TX signal, recorded
            path = save_recording(tmp, "rec", tx_recording(
                params, rec_blocks, block, dev))
            tx_params = params

            def params(n):
                return receiver_only(tx_params(n))

        def source():
            return ReplaySource(path, loop=True) if path else None
        run_once(dev, params(2), host_fed, source=source(),
                 mesh=mesh)                                    # warm-up
        n_fe = front_ends(params(1))
        setup, msps, disp = [], [], None
        for _ in range(RUNS):
            disp, n, s, t = run_once(dev, params(n_blocks), host_fed,
                                     source=source(), mesh=mesh)
            if n != n_blocks * n_fe:
                raise RuntimeError(f"{name}: {n} of {n_blocks * n_fe} "
                                   "packets")
            setup.append(s)
            msps.append(n_blocks * block / t / 1e6)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, _, t = run_once(dev, params(PROFILE_BLOCKS), host_fed,
                                  window=WINDOW, source=source(), mesh=mesh)
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy, top = device_breakdown(trace, PROFILE_BLOCKS)
    prof_msps = PROFILE_BLOCKS * block / t / 1e6
    total = (f" per front end, {[round(n_fe * m, 1) for m in msps]} in "
             "total" if n_fe > 1 else "")
    print(f"{name}: {disp}; set-up s {[round(s, 4) for s in setup]}; "
          f"{[round(m, 1) for m in msps]} Msps{total}; profiled "
          f"{PROFILE_BLOCKS} blocks: {prof_msps:.1f} Msps, device busy "
          f"{100 * busy:.1f}%, device ms per block: "
          + ", ".join(f"{op} {ms:.4f}" for op, ms in top), flush=True)
    out = dict(cell=name, dispatch=[list(d) for d in disp], blocks=n_blocks,
               setup_s=setup, msps=msps, profiled_msps=prof_msps,
               device_busy=busy, device_ms_per_block=dict(top))
    if n_fe > 1:
        out.update(front_ends=n_fe, msps_total=[n_fe * m for m in msps])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    print(card)
    dev = torch.device("cuda", 0)
    names = sys.argv[1:]
    unknown = set(names) - {c[0] for c in cells()}
    if unknown:
        print(f"probe: no cell {sorted(unknown)}", file=sys.stderr)
        return 1
    out = []
    for c in cells():
        if names and c[0] not in names:
            continue
        try:
            out.append(probe_cell(dev, *c))
        except RuntimeError as e:       # the next cells still run
            print(f"{c[0]}: FAILED: {e}", flush=True)
            out.append(dict(cell=c[0], error=str(e)))
    # the sharded layer's cost on one card: each sharded cell's median
    # rate over its single-device cell's
    median = {c["cell"]: float(np.median(c["msps"])) for c in out
              if "msps" in c}
    for c in out:
        base = c["cell"].split(" on (")[0]
        if base != c["cell"] and c["cell"] in median and base in median:
            c["ratio_to_unsharded"] = median[c["cell"]] / median[base]
            print(f"{c['cell']}: {c['ratio_to_unsharded']:.3f} of "
                  f"{base}'s median rate", flush=True)
    print(json.dumps({"card": card, "cells": out}))
    return 1 if any("error" in c for c in out) else 0


if __name__ == "__main__":
    sys.exit(main())
