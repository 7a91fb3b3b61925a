"""Live plotting consumer of the monitor stream — the Qt GUI role.

The port's copy of the JAX package's ``utils/plotview.py`` (matplotlib,
no device).  The reference ships a Qt spectrogram/xcorr display fed by ZMQ
(``experiments/2403/zmq_rx.py:1-285``: a frequency sink and time sinks
per channel).  This is its consumer for the ``monitor --serve`` /
``dllpll --serve`` broadcast (``utils/stream.py``): three stacked panels

- decimated spectrum per channel (the qtgui frequency-sink role),
- per-epoch delay track (the xcorr-peak time sink),
- per-epoch SNR track (and DLL/PLL ``gd_ns`` rows when a tracking
  producer publishes ``track`` messages),

rendered with matplotlib.  On a display-less host (the common
deployment: processing boxes are headless) the view renders with the
Agg backend and writes a PNG snapshot every ``save_every_s`` seconds —
an operator watches it with any auto-refreshing image viewer or a
browser tab; with a display and ``interactive=True`` it live-updates a
window.

Channel colors are the Okabe-Ito blue/vermillion pair (a
colorblind-safe two-hue assignment), fixed per channel — never cycled —
with neutral ink for text and recessive grids.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["LiveMonitorPlot"]

#: fixed channel -> color assignment (Okabe-Ito; CVD-safe pair)
_SERIES = ("#0072B2", "#D55E00", "#009E73", "#CC79A7")
_INK = "#333333"
_GRID = "#dddddd"


def _color(ch: int) -> str:
    return _SERIES[(int(ch) - 1) % len(_SERIES)]


class LiveMonitorPlot:
    """Consume monitor messages and render/save the live view.

    Feed :meth:`handle` message dicts (the ``utils/stream.py`` wire
    protocol), then :meth:`render`/:meth:`save`; or drive everything
    with :meth:`run` on a message iterator (e.g.
    ``connect_monitor(...)``).
    """

    def __init__(
        self,
        max_points: int = 4000,
        interactive: bool = False,
        save_path: str | None = "monitor_live.png",
        save_every_s: float = 2.0,
    ):
        import matplotlib

        if not interactive:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        self._plt = plt
        self.interactive = interactive
        self.save_path = save_path
        self.save_every_s = save_every_s
        self.max_points = max_points
        self.fs = None
        self.hello: dict = {}
        self.spectra: dict[int, tuple[list, float, float]] = {}
        self.delays: dict[int, list[tuple[float, float]]] = {}
        self.snrs: dict[int, list[tuple[float, float]]] = {}
        self.tracks: dict[str, list[tuple[float, float]]] = {}
        self.n_msgs = 0
        self._last_save = 0.0
        self._fig = None

    # -- message intake --------------------------------------------------
    def handle(self, msg: dict) -> None:
        t = msg.get("type")
        self.n_msgs += 1
        if t == "hello":
            self.hello = msg
            self.fs = msg.get("fs")
        elif t == "spectrum":
            self.spectra[int(msg.get("ch", 1))] = (
                msg["bins_db"], msg.get("f_lo_hz", 0.0),
                msg.get("f_hi_hz", 0.0),
            )
        elif t == "row":
            ch = int(msg.get("ch", 1))
            self.delays.setdefault(ch, []).append(
                (float(msg["epoch"]), float(msg["delay_samp"]))
            )
            self.snrs.setdefault(ch, []).append(
                (float(msg["epoch"]), float(msg["snr_db"]))
            )
            for d in (self.delays, self.snrs):
                if len(d[ch]) > self.max_points:
                    del d[ch][: len(d[ch]) - self.max_points]
        elif t == "track":
            key = f"PRN{msg.get('prn', '?')}"
            self.tracks.setdefault(key, []).append(
                (float(msg["second"]), float(msg["gd_ns"]))
            )
            if len(self.tracks[key]) > self.max_points:
                del self.tracks[key][: len(self.tracks[key]) - self.max_points]

    # -- rendering -------------------------------------------------------
    def _axes(self):
        if self._fig is None:
            self._fig, self._ax = self._plt.subplots(
                3, 1, figsize=(9, 8), constrained_layout=True
            )
            if self.interactive:
                self._plt.ion()
                self._fig.show()
        return self._ax

    def render(self) -> None:
        ax_sp, ax_dl, ax_snr = self._axes()
        for a in (ax_sp, ax_dl, ax_snr):
            a.clear()
            a.grid(True, color=_GRID, linewidth=0.6)
            a.tick_params(colors=_INK, labelsize=8)
            for s in a.spines.values():
                s.set_color(_GRID)

        for ch, (bins, flo, fhi) in sorted(self.spectra.items()):
            f = np.linspace(flo, fhi, len(bins)) / 1e3
            ax_sp.plot(f, bins, color=_color(ch), linewidth=1.4,
                       label=f"ch{ch}")
        ax_sp.set_title("spectrum (decimated)", color=_INK, fontsize=10)
        ax_sp.set_xlabel("kHz", color=_INK, fontsize=8)
        ax_sp.set_ylabel("dB", color=_INK, fontsize=8)
        if len(self.spectra) >= 2:
            ax_sp.legend(fontsize=8, frameon=False, labelcolor=_INK)

        for ch, pts in sorted(self.delays.items()):
            p = np.asarray(pts)
            ax_dl.plot(p[:, 0], p[:, 1], color=_color(ch), linewidth=1.4,
                       label=f"ch{ch}")
        ns_per_samp = 1e9 / self.fs if self.fs else 200.0  # hello's fs
        for i, (key, pts) in enumerate(sorted(self.tracks.items())):
            p = np.asarray(pts)
            ax_dl.plot(p[:, 0], p[:, 1] / ns_per_samp,  # gd_ns -> samples
                       color=_SERIES[i % len(_SERIES)], linewidth=1.2,
                       linestyle="--", label=key)
        ax_dl.set_title("correlation-peak delay", color=_INK, fontsize=10)
        ax_dl.set_xlabel("epoch / second", color=_INK, fontsize=8)
        ax_dl.set_ylabel("samples", color=_INK, fontsize=8)
        if len(self.delays) + len(self.tracks) >= 2:
            ax_dl.legend(fontsize=8, frameon=False, labelcolor=_INK)

        for ch, pts in sorted(self.snrs.items()):
            p = np.asarray(pts)
            ax_snr.plot(p[:, 0], p[:, 1], color=_color(ch), linewidth=1.4,
                        label=f"ch{ch}")
        ax_snr.set_title("SNR", color=_INK, fontsize=10)
        ax_snr.set_xlabel("epoch", color=_INK, fontsize=8)
        ax_snr.set_ylabel("dB", color=_INK, fontsize=8)
        if len(self.snrs) >= 2:
            ax_snr.legend(fontsize=8, frameon=False, labelcolor=_INK)

        if self.interactive:
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()

    def save(self, path: str | None = None) -> str:
        path = path or self.save_path
        if self._fig is None:
            self.render()
        self._fig.savefig(path, dpi=110)
        return path

    # -- main loop -------------------------------------------------------
    def run(self, messages) -> str | None:
        """Consume a message iterator; re-render/save periodically and
        once at the end.  Returns the final snapshot path (None when no
        save_path and not interactive)."""
        for msg in messages:
            self.handle(msg)
            now = time.monotonic()
            if now - self._last_save >= self.save_every_s:
                self._last_save = now
                self.render()
                if self.save_path:
                    self.save()
            if msg.get("type") == "end":
                break
        self.render()
        return self.save() if self.save_path else None
