"""The 1000-resonator PFB readout (the benchmark's ``tones1000``
configuration) on the CPU: Get_noise's PFB rule on network_test's comb,
the port's TONES paths against the benchmark's plain float64 reference
(``benchmark/configs/pfb.py``, loaded by path), the float16 control
failing that comparison, the PFB's spans and counter, and the
channelizer kernel's prime pass (csrc/channelizer.cu ``pass_any``, the
101-point pass of nfft 1111) emulated in float32 against numpy's FFT.

The port's paths run at nfft 1111 on blocks of 46 frames (51,106
samples: the planner's smallest block, its floor being 5e4 samples),
a recording of 3 blocks streamed for 7, so each path's stream start,
spare and loop seam are compared."""

import dataclasses
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from gpu_sdr_tpu_torch import measure, spans
from gpu_sdr_tpu_torch.client.noise import compose_noise_command
from gpu_sdr_tpu_torch.engine import replay
from gpu_sdr_tpu_torch.engine.planner import plan_blocks
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource, Source
from gpu_sdr_tpu_torch.ops import channelizer as ch
from gpu_sdr_tpu_torch.ops.pfb import tone_bins
from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams, UsrpParams,
                                      WaveType)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "tones1000.json")
SEED = 2 ** 31 + 24
FRAMES = 46                         # a block of the planner's smallest size
REC_BLOCKS, STREAM_BLOCKS = 3, 7


def _reference_module():
    spec = importlib.util.spec_from_file_location(
        "bench_reference_pfb",
        os.path.join(ROOT, "benchmark", "configs", "pfb.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PFB = _reference_module()


def _config(small: bool = True) -> dict:
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    if small:
        cfg["rx"]["buffer_len"] = FRAMES * cfg["rx"]["fft_tones"]
    return cfg


def _params(cfg: dict, blocks: int) -> UsrpParams:
    """The configuration's receiver alone, for `blocks` blocks (as the
    benchmark's harness builds it)."""
    rx = dict(cfg["rx"])
    wave = WaveType[rx.pop("wave_type")]
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, samples=blocks * rx["buffer_len"],
                            wave_type=[wave] * len(rx["freq"]), **rx)
    return p


def _rel_err(y: np.ndarray, ref: torch.Tensor) -> float:
    """The worst channel's largest error over its reference's rms."""
    ref = ref.to(torch.complex128)
    d = torch.from_numpy(np.asarray(y)).to(torch.complex128) - ref
    rms = ref.abs().pow(2).mean(0).sqrt().clamp_min(1e-300)
    return float((d.abs().amax(0) / rms).max())


class _HostBlocks(Source):
    """The recording served block after block, looped, from the host:
    not a recording source, so the host-fed pipeline takes it."""

    def __init__(self, rec: np.ndarray, block_len: int):
        self.rec = rec.reshape(-1, block_len)

    def blocks(self, block_len, n_blocks):
        for k in range(n_blocks):
            yield self.rec[k % len(self.rec)]


@pytest.fixture(scope="module")
def small():
    """(configuration, recording, reference) at 46 frames a block."""
    cfg = _config()
    rec = PFB.make_recording(cfg, SEED, REC_BLOCKS, "cpu").numpy()
    return cfg, rec, PFB.Reference(cfg, rec, torch.device("cpu"))


def test_get_noise_pfb_rule_on_the_comb():
    """Get_noise's PFB branch on network_test's 1000 tones: nfft
    ceil(rate / min spacing) = 1111 = 11 x 101, every tone on a bin of
    its own (922 at network_test's fixed 1024), pf_average 4, decim 0,
    and the planner's block of 900 frames for the 1e6 buffer; the
    configuration file holds exactly that."""
    cmd = compose_noise_command(np.linspace(-45e6, 45e6, 1000) + 300e6, 1.0,
                                100e6, mode="PFB")
    rx = cmd.A_RX2
    assert (rx.fft_tones, rx.pf_average, rx.decim) == (1111, 4, 0)
    assert rx.freq[0] == -45_004_500 and rx.freq[-1] == 45_004_500
    assert len(set(tone_bins(rx.freq, rx.rate, 1111).tolist())) == 1000
    assert len(set(tone_bins(np.linspace(-45e6, 45e6, 1000), rx.rate,
                             1024).tolist())) == 922
    plan = plan_blocks(rx, 10 ** 7)
    assert (plan.block_len, plan.stride, plan.out_rows) == (999_900, 1111,
                                                            900)
    cfg = _config(small=False)
    assert cfg["rx"] == {"wave_type": "TONES", "rate": 100_000_000,
                         "buffer_len": 999_900, "fft_tones": 1111,
                         "pf_average": 4, "decim": 0,
                         "freq": [int(f) for f in rx.freq]}
    assert cfg["reduced"] == [] and cfg["kind"] == "pfb"
    assert plan_blocks(dataclasses.replace(rx, buffer_len=999_900),
                       10 ** 7).block_len == 999_900
    assert cfg["dispatch"] == {"host_pipeline": None,
                               "device_replay": "channelizer_at"}
    # the replay's recording stays inside the device-replay budget
    n = cfg["recording_blocks"]["device"] * 999_900
    assert n * 8 <= replay.DEVICE_REPLAY_MAX_BYTES
    assert replay.replay_path(_params(cfg, 1).A_RX2, n, 999_900,
                              True) == "channelizer_at"


def _run(route, cfg, rec, monkeypatch):
    """The port's packets of `route` over STREAM_BLOCKS blocks, and the
    dispatch it took."""
    L = cfg["rx"]["buffer_len"]
    if route == "host_pipeline":
        source = _HostBlocks(rec, L)
    else:
        source = ArraySource(rec)
        source.loop = True
    if route == "pfb_at":
        monkeypatch.setattr(replay, "plan_channelizer_replay",
                            lambda *a: False)
    sink = MemorySink()
    measure.run_measurement(_params(cfg, STREAM_BLOCKS), source=source,
                            extra_sinks=[sink], device="cpu")
    return sink.packets, measure.last_dispatch()


ROUTES = {"host_pipeline": ("host_pipeline", None),
          "channelizer_at": ("device_replay", "channelizer_at"),
          "pfb_at": ("device_replay", "pfb_at")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_port_matches_the_plain_reference(route, small, monkeypatch):
    """Each TONES route, packet by packet (the stream's start, the spare
    or the halo of the recording, the loop seam twice), within the
    configuration's rel_err limit of the float64 reference."""
    cfg, rec, ref = small
    packets, disp = _run(route, cfg, rec, monkeypatch)
    assert disp == (("A_RX2",) + ROUTES[route],)
    assert len(packets) == STREAM_BLOCKS
    limit = cfg["limits"]["rel_err"]
    for k, y in enumerate(packets):
        assert y.shape == (FRAMES, 1000) and y.dtype == np.complex64
        assert _rel_err(y, ref.output(k)) < limit / 3, k


def test_the_float16_control_fails(small):
    """The reference with its window and input rounded to float16
    (one step below the configuration's float32) fails the comparison
    by over 10x its limit, on every packet the port is held to."""
    cfg, _, ref = small
    limit = cfg["limits"]["rel_err"]
    for k in range(STREAM_BLOCKS):
        assert _rel_err(ref.output(k, control=True).numpy(),
                        ref.output(k)) > 10 * limit, k


SPANS = {"host_pipeline": {"sdr.pfb.presum", "sdr.pfb.fft", "sdr.pfb.select"},
         "channelizer_at": {"sdr.pfb.channelize", "sdr.pfb.select"},
         "pfb_at": {"sdr.pfb.presum", "sdr.pfb.fft", "sdr.pfb.select"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_pfb_spans_and_counter(route, small, monkeypatch):
    """On, each route's ``sdr.pfb.*`` spans count one a block inside
    ``sdr.loop.step``, and the counters hold ``fft_plans`` (0 off a
    card); off, the record holds neither."""
    cfg, rec, _ = small
    with spans.recording() as rec_:
        _run(route, cfg, rec, monkeypatch)
    run = measure.RUNS[-1]
    pfb = {k: v for k, v in run["spans"].items() if k.startswith("sdr.pfb.")}
    assert set(pfb) == SPANS[route]
    assert all(v["count"] == STREAM_BLOCKS for v in pfb.values())
    assert run["counters"]["fft_plans"] == 0
    t = rec_.table()
    step = rec_.names.index("sdr.loop.step")
    steps = {int(r["seq"]): r for r in t[t["name"] == step]}
    for name in SPANS[route]:
        for r in t[t["name"] == rec_.names.index(name)]:
            parent = steps[int(r["parent"])]
            assert parent["start"] <= r["start"] <= r["end"] <= \
                parent["end"]
    _run(route, cfg, rec, monkeypatch)
    assert "spans" not in measure.RUNS[-1]
    assert "counters" not in measure.RUNS[-1]


def _kp() -> int:
    """pass_any's output pairs a thread, read from csrc/channelizer.cu."""
    text = open(os.path.join(ROOT, "gpu_sdr_tpu_torch", "csrc",
                             "channelizer.cu")).read()
    return int(re.search(r"constexpr int KP = (\d+);", text).group(1))


def _prime_pass(a: torch.Tensor, R: int, ns: int, tw: torch.Tensor,
                off: int, kp: int) -> torch.Tensor:
    """pass_any over frames a (F, n) complex64, in float32: butterfly j's
    inputs a[j + q nb] twiddled in place by tw[off + (q-1) ns + m] (m =
    j % ns), then output 0 their sum and, for each group of kp outputs
    k and their mirrors R - k, sums s_q = x_q + x_{R-q} and differences
    d_q = x_q - x_{R-q} against the roots' cos and -sin, q = 1 .. R//2,
    accumulated in q order; output k of butterfly j to b[(j - m) R + m +
    k ns]."""
    F, n = a.shape
    nb, H = n // R, R // 2
    j = torch.arange(nb)
    m = j % ns
    q = torch.arange(R)[:, None]
    x = a[:, j[None, :] + q * nb].clone()                      # (F, R, nb)
    x[:, 1:] = x[:, 1:] * tw[off + (q[1:] - 1) * ns + m]
    roots = tw[off + ns * (R - 1):off + ns * (R - 1) + R]
    y = torch.empty_like(x)
    y[:, 0] = x.sum(dim=1)
    groups = (H + kp - 1) // kp
    for g in range(groups):
        for p in range(kp):
            k = 1 + g * kp + p
            if k > H:
                break
            c = x[:, 0].clone()
            sn = torch.zeros_like(c)
            for qq in range(1, H + 1):
                w = roots[(qq * k) % R]
                u, v = x[:, qq], x[:, R - qq]
                c = c + (u + v) * w.real
                sn = sn + (u - v) * w.imag
            y[:, k] = c + 1j * sn
            y[:, R - k] = c - 1j * sn
    b = torch.empty_like(a)
    b[:, ((j - m) * R + m + q * ns).reshape(-1)] = y.reshape(F, -1)
    return b


@pytest.mark.parametrize("nfft", [1111, 127, 1016])
def test_the_prime_pass_is_the_fft(nfft):
    """The kernel's plan for nfft (register radices by a direct DFT,
    each prime factor over 7 through pass_any's pairs), in float32,
    against numpy's float64 FFT: over 120 dB SNR on random frames."""
    radices = ch.fft_radices(nfft)
    assert any(r > 7 for r in radices)
    table = torch.from_numpy(ch.fft_table(radices))
    rng = np.random.default_rng(nfft)
    x = (rng.standard_normal((3, nfft)) +
         1j * rng.standard_normal((3, nfft))).astype(np.complex64)
    a, ns, off = torch.from_numpy(x), 1, 0
    for R in radices:
        if R in ch.FFT_RADICES:
            nb = a.shape[1] // R
            j = torch.arange(nb)
            m = j % ns
            r = torch.arange(R)[:, None]
            v = a[:, j[None, :] + r * nb]
            v[:, 1:] = v[:, 1:] * table[off + (r[1:] - 1) * ns + m]
            y = torch.einsum("kq,fqj->fkj",
                             table[off + ns * (R - 1) + (r * r.T) % R], v)
            b = torch.empty_like(a)
            b[:, ((j - m) * R + m + r * ns).reshape(-1)] = y.reshape(3, -1)
            a = b
        else:
            a = _prime_pass(a, R, ns, table, off, _kp())
        off, ns = off + ns * (R - 1) + R, ns * R
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    err = np.sum(np.abs(a.numpy().astype(np.complex128) - ref) ** 2)
    assert 10 * np.log10(np.sum(np.abs(ref) ** 2) / err) > 120.0
