"""Raw capture and full-spectrum PFB acquisition (a copy of
gpu_sdr_tpu/client/full_spec.py, which mirrors pyUSRP/USRP_full_spec.py).

`get_NODSP_tones` records undemodulated IQ (wave_type NODSP,
USRP_full_spec.py:50-210); `Get_full_spec` records the full PFB spectrogram
(wave_type NOISE, :212-399).
"""

from __future__ import annotations

import datetime

import numpy as np

from ..params import AntennaParams, AntMode, UsrpParams, WaveType
from .delay import LINE_DELAY
from .noise import pfb_bins_for_tones


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def _tx_rx_common(tones, rate, RF, amplitudes, tx_gain, delay, samples):
    if RF is None:
        RF = float(np.mean(tones))
        tones = np.asarray(tones, dtype=np.float64) - RF
    if amplitudes is None or len(amplitudes) != len(tones):
        amplitudes = [1.0 / len(tones)] * len(tones)
    if delay is None:
        delay = LINE_DELAY.get(str(int(rate / 1e6)), 0.0) * 1e-9
    tx = AntennaParams(
        mode=AntMode.TX, rate=int(rate), gain=int(abs(tx_gain)),
        bw=int(2 * rate), tone=int(RF), samples=int(samples), delay=1.0,
        buffer_len=int(1e6), fft_tones=100,
        freq=[int(t) for t in tones],
        ampl=[float(a) for a in amplitudes],
        wave_type=[WaveType.TONES] * len(tones))
    return tx, tones, RF, delay


def get_NODSP_tones(tones, measure_t, rate, amplitudes=None, RF=None,
                    tx_gain=0, output_filename=None, Front_end=None,
                    Device=None, delay=None, channel=None, source=None,
                    push_queue=None, **kwargs) -> str:
    """Raw IQ recording with a tone comb on TX (reference get_NODSP_tones,
    USRP_full_spec.py:50-210)."""
    from ..measure import run_measurement

    if measure_t <= 0:
        raise ValueError("Cannot execute a measure with nonpositive duration")
    samples = int(rate * measure_t)
    tx, tones, RF, delay = _tx_rx_common(tones, rate, RF, amplitudes,
                                         tx_gain, delay, samples)
    rx = AntennaParams(
        mode=AntMode.RX, rate=int(rate), gain=0, bw=int(2 * rate),
        tone=int(RF), samples=samples, delay=1.0 + delay,
        buffer_len=int(1e6), decim=0,
        freq=[int(t) for t in tones],
        ampl=[1.0] * len(tones),
        wave_type=[WaveType.NODSP])
    cmd = UsrpParams(usrp_number=int(Device or 0))
    fe = Front_end or "A"
    setattr(cmd, f"{fe}_TXRX", tx)
    setattr(cmd, f"{fe}_RX2", rx)
    if output_filename is None:
        output_filename = "USRP_Noise_" + _timestamp()
    return run_measurement(cmd, output_filename, channel=channel,
                           source=source, meas_type="Raw_data",
                           extra_sinks=_push_sinks(push_queue), **kwargs)


def Get_full_spec(tones, channels, measure_t, rate, RF=None, Front_end=None,
                  amplitudes=None, tx_gain=0, decimation=None, pf_average=4,
                  output_filename=None, Device=None, delay=None,
                  channel=None, source=None, push_queue=None,
                  **kwargs) -> str:
    """Full-spectrum PFB acquisition (reference Get_full_spec,
    USRP_full_spec.py:212-399): every PFB bin is recorded (NOISE wave
    type), optionally frame-averaged by `decimation`."""
    from ..measure import run_measurement

    if measure_t <= 0:
        raise ValueError("Cannot execute a measure with nonpositive duration")
    samples = int(rate * measure_t)
    tx, tones, RF, delay = _tx_rx_common(tones, rate, RF, amplitudes,
                                         tx_gain, delay, samples)
    if np.max(np.abs(tones)) > rate / 2:
        # reference check (USRP_full_spec.py:283-285): an out-of-band
        # tone would alias into the spectrogram instead of erroring
        raise ValueError(
            "Cannot acquire tones outside the Nyquist band "
            f"(max |tone| {np.max(np.abs(tones)):.0f} > rate/2)")
    min_fft = pfb_bins_for_tones(tones, rate)
    final_fft_bins = max(int(channels), min_fft, 10)
    if decimation in (0, 1):
        decimation = None
    rx = AntennaParams(
        mode=AntMode.RX, rate=int(rate), gain=0, bw=int(2 * rate),
        tone=int(RF), samples=samples, delay=1.0 + delay,
        buffer_len=int(1e6), fft_tones=final_fft_bins,
        pf_average=int(pf_average),
        decim=int(decimation) if decimation else 0,
        freq=[int(t) for t in tones],
        ampl=[1.0] * len(tones),
        wave_type=[WaveType.NOISE])
    cmd = UsrpParams(usrp_number=int(Device or 0))
    fe = Front_end or "A"
    setattr(cmd, f"{fe}_TXRX", tx)
    setattr(cmd, f"{fe}_RX2", rx)
    if output_filename is None:
        output_filename = "USRP_PFB_" + _timestamp()
    return run_measurement(cmd, output_filename, channel=channel,
                           source=source, meas_type="PFB",
                           extra_sinks=_push_sinks(push_queue), **kwargs)


def _push_sinks(push_queue):
    """Live-consumer sink for the reference's push_queue kwarg
    (USRP_full_spec.py:69/84): (meta, data) per packet — previously the
    kwarg fell into the H5 attribute tags and crashed params_to_h5."""
    if push_queue is None:
        return []
    from ..engine.sinks import CallbackSink
    return [CallbackSink(lambda meta, data: push_queue.put((meta, data)))]
