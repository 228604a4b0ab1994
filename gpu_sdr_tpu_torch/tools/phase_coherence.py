#!/usr/bin/env python3
"""Long-stream phase coherence on the port (its copies of
tools/phase_coherence.py and tools/phase_coherence_replay.py).

Two modes, each about 3 Gsamples of a loopback tone comb, 4M-sample
blocks at 100 Msps:

* ``chain``: 16 tones over +-40 MHz through the G-fused TONES->DIRECT
  chain (ops/chain.TonesDirectChain, kernel #15), decimation 100,
  pf_average 4, block after block;
* ``replay``: an 8-tone periodic comb (every tone a multiple of
  rate/1000) through the public FusedLoopback, which routes it onto
  the few-channel replay kernel (ops/replay_ddc.ReplayDDCT, #9).

The integer phase accumulators are exact, so phase error must not
accumulate: each channel's end-of-stream mean sits at its tone's
amplitude with no phase, and since the integer phases repeat every
``period`` blocks, the last block is bit for bit the earliest block at
the same position in that period (the stream's first block, which
starts with an empty history, is not compared).

Run:  python -m gpu_sdr_tpu_torch.tools.phase_coherence --mode chain
Prints one JSON line: the amplitude and phase error of every channel,
the last-versus-earliest SNR (``"inf"`` when bit for bit), the rate and
the kernel's launches.
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

RATE = 100_000_000
BLOCK = 4_000_000
TAIL_ROWS = 2000


def period_blocks(freqs, block_len: int, rate: int) -> int:
    """Blocks after which every tone's integer phase f * n mod rate
    repeats at a block start: the lcm over the tones of rate /
    gcd(f * block_len mod rate, rate)."""
    p = 1
    for f in freqs:
        p = math.lcm(p, rate // math.gcd((int(f) * block_len) % rate, rate))
    return p


def chain_stream(device, block_len):
    """(step, state, freqs, amplitude, kernel name): the #15 chain."""
    import torch
    from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain, chain
    from gpu_sdr_tpu_torch.ops.ddc import DirectDDCConfig

    n = 16
    freqs = tuple(int(f) for f in np.linspace(-40e6, 40e6, n))
    cfg = DirectDDCConfig(rate=RATE, decim=100, pf_average=4, freqs=freqs,
                          phases=(0,) * n)
    ch = TonesDirectChain(rate=RATE, tx_freqs=freqs,
                          tx_ampls=(1.0 / n,) * n, cfg=cfg,
                          block_len=block_len)
    assert ch.ok
    dev = torch.device(device)
    P, hP, G, ramp = (t.to(dev) for t in (ch.P, ch.halo_rows(0), ch.G,
                                          ch.ramp))

    def step(state):
        new, srot, hrot, drot = ch.block_rotations(state)
        return new, chain(P, hP, G, ramp, srot, hrot, drot)
    return step, ch.init_state(dev), freqs, 1.0 / n, "chain"


def replay_loopback(device, block_len):
    """The replay mode's FusedLoopback: an 8-tone comb, every tone a
    multiple of rate/1000, DIRECT at decimation 100, pf_average 4."""
    from gpu_sdr_tpu_torch.engine.fused import FusedLoopback
    from gpu_sdr_tpu_torch.params import AntennaParams, AntMode, WaveType

    freqs = [int(k * (RATE // 1000)) for k in
             (-400, -250, -120, -30, 40, 160, 280, 410)]
    n = len(freqs)
    tx = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=block_len,
                       freq=freqs, ampl=[1.0 / n] * n,
                       wave_type=[WaveType.TONES] * n)
    rx = AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=block_len,
                       decim=100, pf_average=4, freq=freqs,
                       wave_type=[WaveType.DIRECT] * n)
    fl = FusedLoopback(tx, rx, device=device)
    assert fl.path == "replay_kernel_t", fl.path
    assert fl.demod.plan.block_len == block_len, fl.demod.plan
    return fl


def replay_stream(device, block_len):
    """(step, state, freqs, amplitude, kernel name): FusedLoopback's
    replay_kernel_t (#9)."""
    fl = replay_loopback(device, block_len)
    freqs = fl.tx.freq
    return fl.step, fl.init_state(), freqs, 1.0 / len(freqs), \
        "replay_ddc_t"


def run(mode="chain", gsamples=3.0, device="cuda") -> dict:
    """Stream about `gsamples` Gsamples (at least period + 2 blocks)
    through the mode's chain: the JSON line's dict."""
    from gpu_sdr_tpu_torch import kernels
    from gpu_sdr_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    make = chain_stream if mode == "chain" else replay_stream
    step, state, freqs, amp, kernel = make(dev, BLOCK)
    period = period_blocks(freqs, BLOCK, RATE)
    n_blocks = max(int(gsamples * 1e9) // BLOCK, period + 2)
    # the earliest block at the last block's position, past block 0
    first = (n_blocks - 1) % period or period
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ref = None
    for b in range(n_blocks):
        state, y = step(state)
        if b == first:
            ref = y.clone()
    last = y.cpu().numpy()
    seconds = time.perf_counter() - t0
    ref = ref.cpu().numpy()
    mean = last[-TAIL_ROWS:].mean(axis=0)
    err = last.astype(np.complex128) - ref
    e2 = float(np.sum(np.abs(err) ** 2))
    snr = (10 * math.log10(float(np.sum(np.abs(ref.astype(np.complex128))
                                        ** 2)) / e2) if e2 else "inf")
    return {
        "mode": mode, "device": str(dev), "kernel": kernel,
        "launches": kernels.launch_counts()[kernel],
        "block_len": BLOCK, "blocks": n_blocks,
        "streamed_gsamples": n_blocks * BLOCK / 1e9,
        "seconds": seconds, "msps": n_blocks * BLOCK / seconds / 1e6,
        "period_blocks": period, "compared_block": first,
        "amp_err": [float(abs(abs(m) - amp)) for m in mean],
        "phase_err_rad": [float(abs(np.angle(m))) for m in mean],
        "last_vs_first_snr_db": snr,
        "bit_identical": e2 == 0.0,
    }


def main():
    parser = argparse.ArgumentParser(
        description="Long-stream phase coherence of a loopback comb.")
    parser.add_argument("--mode", choices=["chain", "replay"],
                        default="chain")
    parser.add_argument("--gsamples", type=float, default=3.0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    from gpu_sdr_tpu_torch.scripts import _cli
    _cli.report_from_env()
    print(json.dumps(run(args.mode, args.gsamples, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
