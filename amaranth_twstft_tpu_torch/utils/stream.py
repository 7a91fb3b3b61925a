"""Live monitoring pub/sub: broadcast a capture's rows to N consumers.

The port's copy of the JAX package's ``utils/stream.py`` (stdlib and
NumPy; no device).  The reference distributes the live X310 stream over
ZMQ to remote Qt GUI subscribers (``experiments/2403/x310_twstft_gr.py``
publishes on tcp://5555, ``zmq_rx.py:38-78`` subscribes with time/frequency
sinks).  Here the *processed* observables are broadcast instead of raw
samples — per-epoch delay/SNR rows and decimated spectra are ~1e4x smaller
than the 40 MB/s sample stream — over plain TCP with newline-delimited
JSON (any language can subscribe with ``nc host port``).

Wire protocol (byte for byte the JAX package's, so a consumer of either
package reads a producer of the other): one JSON object per line, UTF-8.

- ``{"type": "hello", "fs": ..., "channels": ...}`` on connect,
- ``{"type": "row", "epoch": n, "ch": c, "delay_samp": ..., "df_hz":
  ..., "snr_db": ..., "cn0_dbhz": ...}`` per processed epoch,
- ``{"type": "track", "second": s, "physical": ..., "prn": ..., ...}`` per
  DLL/PLL report (``dllpll --serve``),
- ``{"type": "spectrum", "epoch": n, "ch": c, "bins_db": [...],
  "f_lo_hz": ..., "f_hi_hz": ...}`` per batch (decimated magnitude
  spectrum, the qtgui freq-sink role),
- ``{"type": "end"}`` when the producer stops.

A failure of the accept thread other than the server's own close is kept
and raised by the next :meth:`MonitorServer.publish` or
:meth:`MonitorServer.close`, so it never passes for an end of stream.
"""

from __future__ import annotations

import json
import socket
import threading

import numpy as np

__all__ = [
    "MonitorServer",
    "connect_monitor",
    "spectrum_summary",
]


class MonitorServer:
    """Broadcast JSON messages to every connected subscriber.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    Slow or dead subscribers are dropped after ``send_timeout_s`` rather
    than stalling the producer (the ZMQ pub/sub conflate-style policy:
    monitoring must never backpressure acquisition/processing).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        send_timeout_s: float = 0.5,
        hello: dict | None = None,
    ):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._timeout = send_timeout_s
        self._hello = dict(hello or {})
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        self._error: BaseException | None = None
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._acceptor.start()

    def _accept_loop(self) -> None:
        try:
            self._accept_clients()
        except BaseException as e:  # noqa: BLE001 — raised by publish/close
            self._error = e

    def _accept_clients(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                if self._closed:
                    return  # server socket closed by close()
                raise
            conn.settimeout(self._timeout)
            try:
                conn.sendall(
                    (json.dumps({"type": "hello", **self._hello}) + "\n")
                    .encode()
                )
            except OSError:
                conn.close()
                continue
            with self._lock:
                if self._closed:
                    # close() ran between accept() and here: this
                    # subscriber would never see the 'end' message and
                    # would hang until its own recv timeout
                    conn.close()
                    return
                self._clients.append(conn)

    def _raise_acceptor_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("monitor server accept thread failed") from self._error

    @property
    def n_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def publish(self, msg: dict) -> None:
        """Send one message to every subscriber; drop the slow/dead."""
        self._raise_acceptor_error()
        data = (json.dumps(msg) + "\n").encode()
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(data)
                    alive.append(c)
                except OSError:
                    c.close()
            self._clients = alive

    def close(self) -> None:
        """Publish ``end`` and tear down sockets."""
        if self._closed:
            return
        try:
            self.publish({"type": "end"})
        finally:
            self._closed = True
            with self._lock:
                for c in self._clients:
                    try:
                        c.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    c.close()
                self._clients = []
            try:
                # wakes the accept() that close() alone leaves blocked
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._srv.close()
            self._acceptor.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect_monitor(host: str, port: int, timeout_s: float | None = 30.0):
    """Subscribe to a :class:`MonitorServer`; yields message dicts.

    Returns when the producer publishes ``end`` or closes the
    connection; raises ``socket.timeout`` after ``timeout_s`` without
    traffic (None = wait forever).
    """
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                msg = json.loads(line)
                yield msg
                if msg.get("type") == "end":
                    return


def spectrum_summary(
    iq: np.ndarray, fs: float, bins: int = 128
) -> tuple[list[float], float, float]:
    """Decimated magnitude spectrum of a (complex) epoch batch in dB —
    the payload of ``spectrum`` messages (the qtgui frequency-sink role
    of ``zmq_rx.py``, at broadcastable size).

    Returns ``(bins_db, f_lo_hz, f_hi_hz)``: ``bins`` max-pooled dB
    values over the fftshifted spectrum of the batch mean periodogram.
    """
    z = np.asarray(iq)
    if z.ndim == 1:
        z = z[None]
    spec = np.abs(np.fft.fft(z, axis=-1)) ** 2
    p = np.fft.fftshift(spec.mean(axis=0))
    n = len(p)
    if n <= bins:
        pooled = np.pad(p, (0, bins - n), constant_values=1e-30)
    else:
        k = -(-n // bins)  # ceil: exactly `bins` pooled values
        pooled = np.pad(
            p, (0, k * bins - n), constant_values=1e-30
        ).reshape(bins, k).max(axis=1)
    db = (10.0 * np.log10(np.maximum(pooled, 1e-30))).tolist()
    return [round(v, 2) for v in db], -fs / 2.0, fs / 2.0
