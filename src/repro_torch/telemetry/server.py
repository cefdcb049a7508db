"""Dependency-free threaded HTTP status server over a TelemetryBus.

Port of ``repro.telemetry.server`` (pure Python and numpy; only the
imports differ): for the same bus state every endpoint serves the JAX
package's bytes (``/status`` but for ``uptime_s``).

The paper's workflow renders probe data *after* the run; a serving
process needs the same visibility *during* it.  This module exposes a
live :class:`~repro_torch.telemetry.bus.TelemetryBus` over plain stdlib
``http.server`` (no new dependencies, usable from ``curl`` or any
dashboard):

================  =====================================================
endpoint          content
================  =====================================================
``/status``       bounded summary: streams, engine totals, alert count
``/probes``       per-probe aggregates per stream (calls, total, mean,
                  ema, min, p50, p99, max) — exactly the in-process
                  ``StreamAggregator`` values
``/mesh/skew``    device-major streams: per-probe skew, per-device
                  totals, worst (device, probe) cell
``/engine/phases``  per-phase step/cycle bills + recent request bills
``/alerts``       the sentinel's fired ``DriftEvent`` ring
``/metrics``      Prometheus-style text exposition of the same numbers
================  =====================================================

JSON responses are key-sorted and schema-stable (documented in
docs/telemetry.md; asserted in tests/test_torch_telemetry.py).  The server
always binds ``port=0`` by default and reports the real port back via
``server.port`` / ``server.url`` — tests never hard-code ports.

Serving is read-only and touches only host-side aggregates, so a
session keeps its records and outputs bit-identical with the server
attached.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.telemetry.bus import TelemetryBus

JSON_KW = dict(sort_keys=True, separators=(",", ":"))


def render_json(obj: Any) -> bytes:
    """Canonical key-sorted JSON encoding (the schema-stability tests
    compare served bytes against exactly this)."""
    return (json.dumps(obj, **JSON_KW) + "\n").encode()


def _probes_doc(bus: TelemetryBus) -> Dict[str, Any]:
    return {name: st.rows() for name, st in bus.streams().items()}


def _skew_doc(bus: TelemetryBus) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, st in bus.streams().items():
        if st.n_devices <= 1:
            continue
        totals = st.agg.total.reshape(st.n_devices, len(st.paths))
        skew = st.skew()
        worst = {"device": None, "path": None}
        if totals.size and totals.any():
            d, p = np.unravel_index(int(totals.argmax()), totals.shape)
            worst = {"device": int(d), "path": st.paths[int(p)]}
        out[name] = {
            "n_devices": st.n_devices,
            "paths": list(st.paths),
            "skew": [int(s) for s in skew],
            "per_device_totals": totals.tolist(),
            "worst": worst,
        }
    return out


def _engine_doc(bus: TelemetryBus) -> Dict[str, Any]:
    with bus._lock:
        return {
            "phases": {p: dict(v) for p, v in bus.engine.phases.items()},
            "buckets": {str(k): v for k, v in bus.engine.buckets.items()},
            "requests_done": bus.engine.requests_done,
            "recent_requests": list(bus.engine.recent),
        }


def _alerts_doc(bus: TelemetryBus) -> Dict[str, Any]:
    events = [e.to_dict() if hasattr(e, "to_dict") else dict(e)
              for e in bus.alerts()]
    return {"total": bus.alerts_total, "events": events}


def _esc(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def render_metrics(bus: TelemetryBus) -> str:
    """Prometheus text exposition (counters/gauges, no dependencies)."""
    lines = []

    def metric(name: str, help_: str, kind: str, rows):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in rows:
            lab = ",".join(f'{k}="{_esc(v)}"'
                           for k, v in sorted(labels.items()))
            lines.append(f"{name}{{{lab}}} {value}" if lab
                         else f"{name} {value}")

    calls, totals, p99s = [], [], []
    for name, st in sorted(bus.streams().items()):
        snap = st.agg.copy()
        for row in range(snap.n):
            d, p = divmod(row, len(st.paths))
            labels = {"stream": name, "path": st.paths[p]}
            if st.n_devices > 1:
                labels["device"] = d
            calls.append((labels, int(snap.count[row])))
            totals.append((labels, int(snap.total[row])))
            p99s.append((labels, snap.quantile(row, 0.99)))
    metric("repro_probe_calls_total",
           "observed calls per probe", "counter", calls)
    metric("repro_probe_cycles_total",
           "total observed cycles per probe", "counter", totals)
    metric("repro_probe_p99_cycles",
           "histogram-estimated p99 cycles per call", "gauge", p99s)
    eng = _engine_doc(bus)
    metric("repro_engine_phase_cycles_total",
           "engine cycles per phase", "counter",
           [({"phase": p}, v["cycles"])
            for p, v in sorted(eng["phases"].items())])
    metric("repro_engine_phase_steps_total",
           "engine steps per phase", "counter",
           [({"phase": p}, v["steps"])
            for p, v in sorted(eng["phases"].items())])
    metric("repro_engine_requests_total",
           "finished engine requests", "counter",
           [({}, eng["requests_done"])])
    metric("repro_alerts_total",
           "drift events fired by the sentinel", "counter",
           [({}, bus.alerts_total)])
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-telemetry/1"

    def do_GET(self):  # noqa: N802  (http.server naming)
        bus: TelemetryBus = self.server.bus          # type: ignore
        path = self.path.split("?", 1)[0].rstrip("/") or "/status"
        routes: Dict[str, Callable[[], Any]] = {
            "/status": bus.status,
            "/probes": lambda: _probes_doc(bus),
            "/mesh/skew": lambda: _skew_doc(bus),
            "/engine/phases": lambda: _engine_doc(bus),
            "/alerts": lambda: _alerts_doc(bus),
        }
        try:
            if path == "/metrics":
                body = render_metrics(bus).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif path in routes:
                body, ctype, code = (render_json(routes[path]()),
                                     "application/json", 200)
            else:
                body, ctype, code = (
                    render_json({"error": f"unknown endpoint {path!r}",
                                 "endpoints": sorted(routes) + ["/metrics"]}),
                    "application/json", 404)
        except Exception as e:       # never kill the serving thread
            body, ctype, code = (render_json({"error": repr(e)}),
                                 "application/json", 500)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass                         # keep serving loops quiet


class StatusServer:
    """Threaded HTTP server over a bus.

    ::

        bus = TelemetryBus()
        srv = StatusServer(bus).start()     # binds 127.0.0.1, port 0
        print(srv.url)                      # real port read back
        ...
        srv.stop()

    ``port=0`` (the default, and the only mode the test suite uses)
    lets the OS pick a free port — no hard-coded ports anywhere.
    """

    def __init__(self, bus: TelemetryBus, host: str = "127.0.0.1",
                 port: int = 0):
        self.bus = bus
        self.host = host
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StatusServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        httpd.bus = self.bus                         # type: ignore
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="repro-status-server",
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class ControlPlane:
    """Launcher bundle: bus + drift sentinel + status server.

    ``serve.py --status-port`` needs the three objects wired together;
    this keeps them so.  ``finish()`` prints the sentinel's alert table (if
    anything fired) and stops the server.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 retune=None):
        from repro_torch.telemetry.sentinel import DriftSentinel
        self.bus = TelemetryBus()
        self.sentinel = DriftSentinel(self.bus, retune=retune)
        self.server = StatusServer(self.bus, host=host, port=port)

    def start(self) -> "ControlPlane":
        self.server.start()
        print(f"[telemetry] status server on {self.server.url} "
              f"(/status /probes /mesh/skew /engine/phases /alerts "
              f"/metrics)", flush=True)
        return self

    def finish(self):
        events = self.sentinel.tripped()
        if events:
            from repro_torch.core.report import telemetry_alert_table
            print("\n# sentinel drift events")
            print(telemetry_alert_table(events))
        self.server.stop()
