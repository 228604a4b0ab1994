"""Plotting for measurements and analysis (mirrors pyUSRP/USRP_plotting.py
plus the plot functions of USRP_VNA/USRP_noise/USRP_fitting/USRP_full_spec).

Two backends, like the reference (pyUSRP offered matplotlib and plotly):

  * ``backend="matplotlib"`` (default) — PNG files;
  * ``backend="plotly"`` (alias ``"html"``) — self-contained interactive
    HTML with pan/zoom/hover/legend toggling (client/htmlplot.py; this
    environment ships no plotly package, so the interactive backend is
    implemented from scratch with an inline SVG renderer — reference
    surface: plot_VNA, pyUSRP/USRP_VNA.py:807-1100, styled via
    style_plotly_figure, pyUSRP/USRP_plotting.py:63-71).

Unknown backends raise ValueError.  All functions return the output
filename.

The port's copy of gpu_sdr_tpu/client/plotting.py.  matplotlib is
imported by the functions that draw with it, not with this module, so
the facade (pyusrp.py) imports on a host without it; a plot that needs
it there raises ImportError naming it.
"""

from __future__ import annotations

import os
import numpy as np

from . import files as Ufiles
from .fitting import get_fit_data, get_fit_param, vrms2dbm
from .htmlplot import Figure as HtmlFigure

COLORS = ["black", "red", "green", "blue", "orange", "violet", "brown",
          "purple"]

_HTML_BACKENDS = ("plotly", "html")


def _matplotlib():
    """matplotlib on its file-only "agg" backend, imported at first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          f"installed ({e})") from e
    matplotlib.use("agg")
    return matplotlib


def _pyplot():
    _matplotlib()
    import matplotlib.pyplot as pl
    return pl


def get_color(N):
    """Cyclic color picker (reference get_color,
    pyUSRP/USRP_plotting.py:50-61)."""
    return COLORS[N % len(COLORS)]


def style_plotly_figure(fig):
    """Transparent-background styling for dict-like figures (reference
    style_plotly_figure, pyUSRP/USRP_plotting.py:63-71; the HTML backend
    is transparent by default)."""
    fig["layout"].update(paper_bgcolor="rgba(0,0,0,0)")
    fig["layout"].update(plot_bgcolor="rgba(0,0,0,0)")


def _is_html(backend: str) -> bool:
    if backend == "matplotlib":
        return False
    if backend in _HTML_BACKENDS:
        return True
    raise ValueError(
        f"unknown plotting backend {backend!r}: use 'matplotlib' or "
        f"'plotly'/'html'")


def _out_name(output_filename, default, html=False):
    return (output_filename or default) + (".html" if html else ".png")


def plot_raw_data(filenames, decimation=None, displayed_samples=None,
                  low_pass=None, backend="matplotlib", output_filename=None,
                  channel_list=None, mode="IQ", start_time=None,
                  end_time=None, auto_open=False, **kwargs) -> str:
    """Plot raw demodulated timestreams in IQ or PM (phase/magnitude) mode
    (reference plot_raw_data, pyUSRP/USRP_plotting.py:73-335)."""
    html = _is_html(backend)
    if isinstance(filenames, str):
        filenames = [filenames]
    series = []                       # (t, y, label, color_idx)
    for fn in filenames:
        info = Ufiles.get_rx_info(fn)
        rate = info.rate / max(int(info.decim), 1) if info.decim else info.rate
        data = Ufiles.openH5file(fn)
        chans = channel_list if channel_list is not None \
            else range(data.shape[0])
        s0 = int((start_time or 0) * rate)
        s1 = int(end_time * rate) if end_time else data.shape[1]
        for i, ch in enumerate(chans):
            y = data[ch, s0:s1]
            eff_rate = rate
            if decimation and decimation > 1:
                from scipy import signal as sg
                y = sg.decimate(y, int(decimation), ftype="fir")
                eff_rate = rate / int(decimation)
            if displayed_samples:
                step = max(1, len(y) // displayed_samples)
                y = y[::step]
                eff_rate /= step
            t = (start_time or 0) + np.arange(len(y)) / eff_rate
            series.append((t, y, f"{os.path.basename(fn)} ch{ch}", i))
    if mode == "IQ":
        tops = [(t, y.real) for t, y, *_ in series]
        bots = [(t, y.imag) for t, y, *_ in series]
        labels = ("I [ADCu]", "Q [ADCu]")
    else:
        tops = [(t, np.abs(y)) for t, y, *_ in series]
        bots = [(t, np.unwrap(np.angle(y))) for t, y, *_ in series]
        labels = ("Magnitude [ADCu]", "Phase [rad]")
    out = _out_name(output_filename, "USRP_raw_data", html)
    if html:
        fig = HtmlFigure(title="Raw demodulated data")
        p0 = fig.panel(ylabel=labels[0])
        p1 = fig.panel(ylabel=labels[1], xlabel="Time [s]")
        for (tx, ty), (bx, by), (_, _, name, i) in zip(tops, bots, series):
            p0.line(tx, ty, name=name, color=get_color(i))
            p1.line(bx, by, name=name, color=get_color(i), dash=True)
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, axes = pl.subplots(nrows=2, ncols=1, sharex=True, figsize=(10, 7))
    for (tx, ty), (bx, by), (_, _, name, i) in zip(tops, bots, series):
        axes[0].plot(tx, ty, color=get_color(i), label=name)
        axes[1].plot(bx, by, color=get_color(i), ls="--")
    axes[0].set_ylabel(labels[0])
    axes[1].set_ylabel(labels[1])
    axes[1].set_xlabel("Time [s]")
    axes[0].legend(fontsize=7)
    axes[0].grid(); axes[1].grid()
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def plot_VNA(filenames, backend="matplotlib", output_filename=None,
             unwrap_phase=True, auto_open=False, **kwargs) -> str:
    """Magnitude/phase S21 plot of analyzed VNA files
    (reference plot_VNA, pyUSRP/USRP_VNA.py:807-1100)."""
    html = _is_html(backend)
    if isinstance(filenames, str):
        filenames = [filenames]
    traces = []
    for i, fn in enumerate(filenames):
        freq, s21 = Ufiles.get_VNA_data(fn, calibrated=True)
        phase = np.angle(s21)
        if unwrap_phase:
            phase = np.unwrap(phase)
        traces.append((freq / 1e6, vrms2dbm(np.abs(s21)), phase,
                       os.path.basename(fn), i))
    out = _out_name(output_filename, "USRP_VNA", html)
    if html:
        fig = HtmlFigure(title="VNA S21")
        pm = fig.panel(ylabel="S21 Magnitude [dB]")
        pp = fig.panel(ylabel="S21 Phase [rad]", xlabel="Frequency [MHz]")
        for f, m, ph, name, i in traces:
            pm.line(f, m, name=name, color=get_color(i))
            pp.line(f, ph, name=name, color=get_color(i))
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, (axm, axp) = pl.subplots(nrows=2, ncols=1, sharex=True,
                                  figsize=(10, 7))
    for f, m, ph, name, i in traces:
        axm.plot(f, m, color=get_color(i), label=name)
        axp.plot(f, ph, color=get_color(i))
    axm.set_ylabel("S21 Magnitude [dB]")
    axp.set_ylabel("S21 Phase [rad]")
    axp.set_xlabel("Frequency [MHz]")
    axm.legend(fontsize=7)
    axm.grid(); axp.grid()
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def VNA_timestream_plot(filename, output_filename=None, backend="matplotlib",
                        auto_open=False, **kwargs) -> str:
    """Waterfall of per-iteration VNA sweeps (reference VNA_timestream_plot,
    pyUSRP/USRP_VNA.py:563-680)."""
    html = _is_html(backend)
    with Ufiles.bound_open(filename) as f:
        grp = f["VNA_dynamic_0"]
        freq = np.asarray(grp["frequency"])
        traces = np.asarray(grp["S21"])
    z = vrms2dbm(np.abs(traces))
    out = _out_name(output_filename, "USRP_VNA_timestream", html)
    if html:
        fig = HtmlFigure(title="Dynamic VNA waterfall")
        p = fig.panel(ylabel="Sweep iteration", xlabel="Frequency [MHz]")
        p.image(z, extent=[freq[0] / 1e6, freq[-1] / 1e6, 0, len(traces)],
                label="S21 [dB]")
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, ax = pl.subplots(figsize=(10, 6))
    im = ax.imshow(z, aspect="auto", origin="lower",
                   extent=[freq[0] / 1e6, freq[-1] / 1e6, 0, len(traces)],
                   cmap="viridis")
    fig.colorbar(im, ax=ax, label="S21 [dB]")
    ax.set_xlabel("Frequency [MHz]")
    ax.set_ylabel("Sweep iteration")
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def plot_resonators(filenames, reso_freq=None, backend="matplotlib",
                    title_info=None, output_filename=None, auto_open=False,
                    attenuation=None, **kwargs) -> str:
    """IQ circle + magnitude + phase per fitted resonator
    (reference plot_resonators, pyUSRP/USRP_fitting.py:840-1204)."""
    html = _is_html(backend)
    if isinstance(filenames, str):
        filenames = [filenames]
    all_data = []
    for fn in filenames:
        all_data.extend(get_fit_data(fn))
    out = _out_name(output_filename, "USRP_resonators", html)
    if html:
        fig = HtmlFigure(title=title_info or "Fitted resonators")
        for i, d in enumerate(all_data):
            f, orig, fit = d["frequency"], d["original"], d["fitted"]
            piq = fig.panel(ylabel=f"reso {i} Q", xlabel="I")
            piq.line(orig.real, orig.imag, name="data", color="#888888",
                     markers=True)
            piq.line(fit.real, fit.imag, name="fit", color="#d62728")
            pm = fig.panel(ylabel=f"reso {i} |S21| [dB]",
                           xlabel="Frequency [MHz]")
            pm.line(f / 1e6, vrms2dbm(np.abs(orig)), name="data",
                    color="#888888", markers=True)
            pm.line(f / 1e6, vrms2dbm(np.abs(fit)), name="fit",
                    color="#d62728")
            pp = fig.panel(ylabel=f"reso {i} phase [rad]",
                           xlabel="Frequency [MHz]")
            pp.line(f / 1e6, np.unwrap(np.angle(orig)), name="data",
                    color="#888888", markers=True)
            pp.line(f / 1e6, np.unwrap(np.angle(fit)), name="fit",
                    color="#d62728")
        return fig.write_html(out, auto_open=auto_open)
    n = max(1, len(all_data))
    pl = _pyplot()
    fig, axes = pl.subplots(nrows=n, ncols=3, figsize=(14, 4 * n),
                            squeeze=False)
    for i, d in enumerate(all_data):
        f, orig, fit = d["frequency"], d["original"], d["fitted"]
        axes[i][0].plot(orig.real, orig.imag, ".", color="grey",
                        label="data")
        axes[i][0].plot(fit.real, fit.imag, color="red", label="fit")
        axes[i][0].set_xlabel("I"); axes[i][0].set_ylabel("Q")
        axes[i][0].legend(fontsize=7); axes[i][0].axis("equal")
        axes[i][1].plot(f / 1e6, vrms2dbm(np.abs(orig)), ".", color="grey")
        axes[i][1].plot(f / 1e6, vrms2dbm(np.abs(fit)), color="red")
        axes[i][1].set_xlabel("Frequency [MHz]")
        axes[i][1].set_ylabel("Magnitude [dB]")
        axes[i][2].plot(f / 1e6, np.unwrap(np.angle(orig)), ".",
                        color="grey")
        axes[i][2].plot(f / 1e6, np.unwrap(np.angle(fit)), color="red")
        axes[i][2].set_xlabel("Frequency [MHz]")
        axes[i][2].set_ylabel("Phase [rad]")
        for ax in axes[i]:
            ax.grid()
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def plot_noise_spec(filenames, channel_list=None, max_frequency=None,
                    title_info=None, backend="matplotlib",
                    cryostat_attenuation=0, auto_open=False,
                    output_filename=None, **kwargs) -> str:
    """Per-channel noise PSD plot (reference plot_noise_spec,
    pyUSRP/USRP_noise.py:830-1067)."""
    html = _is_html(backend)
    if isinstance(filenames, str):
        filenames = [filenames]
    traces = []
    for fn in filenames:
        info, freq, real, imag = Ufiles.get_noise(fn,
                                                  channel_list=channel_list)
        for i in range(len(real)):
            sel = slice(None)
            if max_frequency is not None:
                sel = freq <= max_frequency
            traces.append((freq[sel], real[i][sel], imag[i][sel],
                           os.path.basename(fn), i))
    ylab = "PSD [dBc/Hz]" if kwargs.get("dbc") else "PSD [dB/Hz]"
    out = _out_name(output_filename, "USRP_noise_spec", html)
    if html:
        fig = HtmlFigure(title=title_info or "Noise PSD")
        p = fig.panel(ylabel=ylab, xlabel="Frequency [Hz]", xlog=True)
        for ci, (f, re, im, name, i) in enumerate(traces):
            p.line(f[f > 0], re[f > 0], name=f"{name} ch{i} I",
                   color=get_color(ci))
            p.line(f[f > 0], im[f > 0], name=f"ch{i} Q",
                   color=get_color(ci), dash=True)
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, ax = pl.subplots(figsize=(10, 6))
    for ci, (f, re, im, name, i) in enumerate(traces):
        ax.semilogx(f, re, color=get_color(ci), label=f"{name} ch{i} I")
        ax.semilogx(f, im, color=get_color(ci), ls="--", label=f"ch{i} Q")
    ax.set_xlabel("Frequency [Hz]")
    ax.set_ylabel(ylab)
    ax.legend(fontsize=7)
    ax.grid(which="both")
    if title_info:
        ax.set_title(title_info)
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def plot_pfb(filename, decimation=None, low_pass=None, backend="matplotlib",
             output_filename=None, start_time=None, end_time=None,
             auto_open=False, **kwargs) -> str:
    """Full-PFB waterfall + trace stack (reference plot_pfb,
    pyUSRP/USRP_full_spec.py:402-522): the flattened spectra stream is
    reshaped by fft_tones and rolled by -fft_tones/2 so DC sits centered."""
    html = _is_html(backend)
    info = Ufiles.get_rx_info(filename)
    nfft = int(info.fft_tones)
    z = Ufiles.openH5file(filename)[0]
    n_frames = len(z) // nfft
    z = 20 * np.log10(np.abs(z[:n_frames * nfft]) + 1e-12)
    z_shaped = np.roll(z.reshape(n_frames, nfft), -nfft // 2, axis=1)
    x_label = (info.tone + (np.arange(nfft) - nfft / 2) *
               (info.rate / nfft)) / 1e6
    out = _out_name(output_filename, "USRP_PFB_waterfall", html)
    if html:
        fig = HtmlFigure(title="PFB full spectrum")
        pw = fig.panel(ylabel="Frame", xlabel="Channel [MHz]")
        pw.image(z_shaped, extent=[x_label.min(), x_label.max(),
                                   0, n_frames], label="Power [dB]")
        pt = fig.panel(ylabel="Power [dBm]", xlabel="Channel [MHz]")
        for k, zz in enumerate(z_shaped[::max(1, n_frames // 20)]):
            pt.line(x_label, zz, name=f"frame {k}", color="#00000022")
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, (ax0, ax1) = pl.subplots(nrows=2, figsize=(10, 10))
    im = ax0.imshow(z_shaped, aspect="auto", interpolation="nearest",
                    extent=[x_label.min(), x_label.max(), 0, n_frames])
    fig.colorbar(im, ax=ax0, label="Power [dB]")
    ax0.set_xlabel("Channel [MHz]")
    ax0.set_ylabel("Frame")
    for zz in z_shaped[::max(1, n_frames // 50)]:
        ax1.plot(x_label, zz, color="k", alpha=0.1)
    ax1.set_xlabel("Channel [MHz]")
    ax1.set_ylabel("Power [dBm]")
    ax1.grid()
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def plot_frequency_timestreams(filenames, decimation=None,
                               displayed_samples=None, low_pass=None,
                               backend="matplotlib", output_filename=None,
                               channel_list=None, start_time=None,
                               end_time=None, auto_open=False,
                               **kwargs) -> str:
    """Plot df/f and Qr timestreams from a frequency-converted file
    (reference plot_frequency_timestreams, pyUSRP/USRP_noise.py:1229-1462)."""
    return plot_raw_data(filenames, decimation=decimation,
                         displayed_samples=displayed_samples,
                         backend=backend,
                         output_filename=output_filename or
                         "USRP_frequency_timestreams",
                         channel_list=channel_list, mode="IQ",
                         start_time=start_time, end_time=end_time,
                         auto_open=auto_open)


def plot_reso_stat(filenames, reso_freq=None, backend="matplotlib",
                   title_info=None, additional_info=None,
                   output_filename=None, auto_open=False,
                   attr=None, **kwargs) -> str:
    """Resonator fit parameters vs readout power (or a custom raw_data0
    attribute).  The reference declares this function but leaves it empty
    (plot_reso_stat, pyUSRP/USRP_fitting.py:1206-1226); implemented here:
    one panel per parameter (Qr, Qi, f0 shift, a), one line per resonator.
    """
    from .files import get_readout_power

    html = _is_html(backend)
    if isinstance(filenames, str):
        filenames = [filenames]
    points = {}          # reso index -> list of (x, params)
    for fn in filenames:
        params = get_fit_param(fn)
        for i, p in enumerate(params):
            if attr is not None:
                with Ufiles.bound_open(fn) as f:
                    x = f["raw_data0"].attrs.get(attr)
            else:
                try:
                    x = get_readout_power(fn, i)
                except (IndexError, KeyError):
                    x = 0.0
            points.setdefault(i, []).append((float(x), p))
    panels = [("Qr", lambda p: p["Qr"]),
              ("Qi", lambda p: p["Qi"]),
              ("f0 [MHz]", lambda p: p["f0"]),
              ("a (nonlinearity)", lambda p: p["a"])]
    xlabel = attr if attr else "readout power [dBm]"
    out = _out_name(output_filename, "USRP_reso_stat", html)
    if html:
        fig = HtmlFigure(title=title_info or "Resonator statistics")
        for label, getter in panels:
            pn = fig.panel(ylabel=label, xlabel=xlabel)
            for i, series in sorted(points.items()):
                series = sorted(series, key=lambda s: s[0])
                pn.line([s[0] for s in series],
                        [getter(s[1]) for s in series],
                        name=f"reso {i}", color=get_color(i), markers=True)
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, axes = pl.subplots(nrows=2, ncols=2, figsize=(11, 8))
    for ax, (label, getter) in zip(axes.flat, panels):
        for i, series in sorted(points.items()):
            series = sorted(series, key=lambda s: s[0])
            xs = [s[0] for s in series]
            ys = [getter(s[1]) for s in series]
            ax.plot(xs, ys, "o-", color=get_color(i), label=f"reso {i}")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(label)
        ax.grid()
    axes.flat[0].legend(fontsize=7)
    if title_info:
        fig.suptitle(title_info)
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out


def diagnostic_VNA_noise(noise_filename, vna_filename=None, ant=None,
                         backend="matplotlib", output_filename=None,
                         auto_open=False, **kwargs) -> str:
    """Overlay noise acquisition tone points on the VNA trace
    (reference diagnostic_VNA_noise, pyUSRP/USRP_noise.py:1465-1658)."""
    html = _is_html(backend)
    vna = None
    if vna_filename is not None:
        freq, s21 = Ufiles.get_VNA_data(vna_filename, calibrated=True)
        vna = (freq / 1e6, vrms2dbm(np.abs(s21)))
    info = Ufiles.get_rx_info(noise_filename, ant=ant)
    data = Ufiles.openH5file(noise_filename)
    tones = [((info.tone + f) / 1e6,
              vrms2dbm(np.mean(np.abs(data[i]))))
             for i, f in enumerate(info.freq)]
    out = _out_name(output_filename, "USRP_VNA_noise_diagnostic", html)
    if html:
        fig = HtmlFigure(title="VNA / noise consistency")
        p = fig.panel(ylabel="Level [dB]", xlabel="Frequency [MHz]")
        if vna is not None:
            p.line(vna[0], vna[1], name="VNA", color="#888888")
        for i, (tf, lv) in enumerate(tones):
            p.line([tf], [lv], name=f"tone {i}", color=get_color(i),
                   markers=True)
        return fig.write_html(out, auto_open=auto_open)
    pl = _pyplot()
    fig, ax = pl.subplots(figsize=(10, 6))
    if vna is not None:
        ax.plot(vna[0], vna[1], color="grey", label="VNA")
    for i, (tf, lv) in enumerate(tones):
        ax.plot(tf, lv, "o", color=get_color(i), label=f"tone {i}")
    ax.set_xlabel("Frequency [MHz]")
    ax.set_ylabel("Level [dB]")
    ax.legend(fontsize=7)
    ax.grid()
    fig.savefig(out, bbox_inches="tight")
    pl.close(fig)
    return out
