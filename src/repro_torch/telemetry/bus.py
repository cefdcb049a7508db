"""Telemetry bus: the one host-side aggregation point for live probes.

Port of ``repro.telemetry.bus`` (pure Python and numpy; only the imports
differ). ``ProbeSession`` (its ``StreamingSink`` worker) and
``InferenceEngine`` (per-phase / per-request cycle bills) publish to it;
the device-major streams (``n_devices > 1``) of a ``MeshProbeSession``
(``core.meshprobe``, sources ``train/mesh`` / ``serve/mesh``) serve
``/mesh/skew`` and the fault driver's ``StragglerFault``. The pub/sub
abstraction:

- **streams** — named per-probe duration statistics.  A publisher
  registers a :class:`ProbeStream` (``bus.stream(name, paths)``) and
  feeds it per-call cycle durations; the stream owns a
  :class:`~repro_torch.core.streaming.StreamAggregator`, so the served
  aggregates are *exactly* the in-process values.  Device-major
  streams (``n_devices > 1``) carry one row per (device, probe) — the
  mesh skew substrate.
- **windows** — publishers close sliding windows (``stream.roll()``);
  the bus emits a :class:`WindowFrame` holding the window's exact
  count/total/histogram deltas to every ``"window"`` subscriber.  The
  :class:`~repro_torch.telemetry.sentinel.DriftSentinel` is such a
  subscriber.
- **engine topics** — per-phase step/cycle totals and bounded
  per-request bills (``publish_phase`` / ``publish_request``).
- **alerts** — structured :class:`~repro_torch.telemetry.sentinel.DriftEvent`
  records (``publish_alert``), kept in a bounded ring and surfaced on
  the status server's ``/alerts`` endpoint.

Publishing is decode-side only: calls happen on the streaming sink's
worker thread, at window boundaries, and around engine phase steps —
never inside the step — so the device hot path is untouched and the
host cost is a lock + a handful of numpy folds per ring row.
Everything is thread-safe; every retained structure is bounded, so a
bus attached to a months-long serving process stays constant-size.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.streaming import HIST_BUCKETS, StreamAggregator, _bucket_rep

# topics a subscriber may attach to
TOPICS = ("window", "alert", "phase", "request")


def hist_quantile(hist: np.ndarray, q: float,
                  count: Optional[int] = None) -> int:
    """q-quantile (bucket-midpoint estimate) of a log₂-bucket histogram
    — the same estimator as ``StreamAggregator.quantile``, usable on a
    raw window-delta histogram."""
    h = np.asarray(hist, np.int64)
    n = int(h.sum()) if count is None else int(count)
    if n <= 0:
        return 0
    target = max(1, int(np.ceil(q * n)))
    b = int(np.searchsorted(np.cumsum(h), target))
    return _bucket_rep(min(b, HIST_BUCKETS - 1))


@dataclass(frozen=True)
class WindowFrame:
    """One closed sliding window of a stream: exact deltas since the
    previous roll.  Arrays are device-major ``(n_devices * n_probes,)``
    rows — row ``d * n_probes + p`` is probe ``p`` on device ``d``
    (single-device streams simply have ``n_devices == 1``)."""
    stream: str
    index: int                      # 0-based window ordinal
    start_step: int
    end_step: int
    paths: Tuple[str, ...]
    n_devices: int
    counts: np.ndarray              # (D*n,) samples folded in the window
    totals: np.ndarray              # (D*n,) cycle total delta
    hist: np.ndarray                # (D*n, HIST_BUCKETS) histogram delta
    exact_totals: Optional[np.ndarray] = None   # device-counter delta

    @property
    def n_probes(self) -> int:
        return len(self.paths)

    def per_device(self, arr: Optional[np.ndarray] = None) -> np.ndarray:
        """View a row-major array as ``(n_devices, n_probes)``."""
        a = self.totals if arr is None else arr
        return np.asarray(a).reshape(self.n_devices, self.n_probes)

    def p99(self, row: int, q: float = 0.99) -> int:
        return hist_quantile(self.hist[row], q, count=int(self.counts[row]))


class ProbeStream:
    """Named per-probe duration statistics + sliding-window rolls.

    ``add(pid, durations)`` folds per-call cycle durations into the
    stream's :class:`StreamAggregator` — the identical code path the
    sessions used before the refactor, so served aggregates stay
    bit-equal to in-process ones.  ``roll()`` closes the current window
    and hands its exact deltas to the bus's window subscribers.
    """

    def __init__(self, name: str, paths: Sequence[str], *,
                 n_devices: int = 1, ema_alpha: float = 0.1,
                 on_window: Optional[Callable[[WindowFrame], None]] = None):
        self.name = name
        self.paths = tuple(paths)
        self.n_devices = int(n_devices)
        self.agg = StreamAggregator(self.n_devices * len(self.paths),
                                    ema_alpha=ema_alpha)
        self._on_window = on_window
        self.rows_published = 0
        self.windows = 0
        self._lock = threading.Lock()
        n = self.agg.n
        self._mark_count = np.zeros(n, np.int64)
        self._mark_total = np.zeros(n, np.int64)
        self._mark_hist = np.zeros((n, HIST_BUCKETS), np.int64)

    @property
    def n_rows(self) -> int:
        return self.agg.n

    def add(self, pid: int, durations: np.ndarray):
        """Fold per-call cycle durations for row ``pid`` (device-major
        index for mesh streams)."""
        self.agg.add(pid, durations)
        with self._lock:
            self.rows_published += 1

    def roll(self, start_step: int = 0, end_step: int = 0,
             exact_totals: Optional[np.ndarray] = None) -> WindowFrame:
        """Close the current window: emit the exact aggregate deltas
        since the previous roll to the bus's window subscribers."""
        snap = self.agg.copy()
        with self._lock:
            frame = WindowFrame(
                stream=self.name, index=self.windows,
                start_step=int(start_step), end_step=int(end_step),
                paths=self.paths, n_devices=self.n_devices,
                counts=snap.count - self._mark_count,
                totals=snap.total - self._mark_total,
                hist=snap.hist - self._mark_hist,
                exact_totals=None if exact_totals is None
                else np.asarray(exact_totals, np.int64).reshape(-1))
            self._mark_count = snap.count
            self._mark_total = snap.total
            self._mark_hist = snap.hist
            self.windows += 1
        if self._on_window is not None:
            self._on_window(frame)
        return frame

    def rows(self) -> List[Dict[str, Any]]:
        """Per-row served aggregates — exactly the ``StreamAggregator``
        values (ints exact; floats survive JSON round-trips bit-exact)."""
        snap = self.agg.copy()
        out = []
        for row in range(snap.n):
            d, p = divmod(row, len(self.paths))
            cnt = int(snap.count[row])
            out.append({
                "path": self.paths[p],
                "device": d,
                "calls": cnt,
                "total_cycles": int(snap.total[row]),
                "mean": float(snap.total[row]) / cnt if cnt else 0.0,
                "ema": float(snap.ema[row]),
                "min": int(snap.min[row]) if cnt else 0,
                "p50": snap.quantile(row, 0.50),
                "p99": snap.quantile(row, 0.99),
                "max": int(snap.max[row]),
            })
        return out

    def skew(self) -> np.ndarray:
        """Per-probe max−min of total cycles across devices."""
        return self.agg.skew(self.n_devices)


@dataclass
class _EngineStats:
    phases: Dict[str, Dict[str, int]] = field(default_factory=dict)
    buckets: Dict[int, int] = field(default_factory=dict)
    requests_done: int = 0
    recent: deque = field(default_factory=lambda: deque(maxlen=64))


class TelemetryBus:
    """The process-wide pub/sub hub (see module docstring).

    Constructing one is cheap; pass the same instance to every session,
    engine, sentinel, and the status server.  All methods are
    thread-safe.
    """

    def __init__(self, *, max_alerts: int = 256, max_requests: int = 64):
        self._lock = threading.RLock()
        self._streams: Dict[str, ProbeStream] = {}
        self._subs: Dict[str, List[Callable]] = {t: [] for t in TOPICS}
        self._alerts: deque = deque(maxlen=max_alerts)
        self.alerts_total = 0
        self.engine = _EngineStats()
        self.engine.recent = deque(maxlen=max_requests)
        self._t0 = time.time()

    # -- streams ---------------------------------------------------------
    def stream(self, name: str, paths: Optional[Sequence[str]] = None, *,
               n_devices: int = 1, ema_alpha: float = 0.1) -> ProbeStream:
        """Get or create the named stream.  Re-registering with a
        different shape (new probe set after a retarget) replaces it."""
        with self._lock:
            st = self._streams.get(name)
            if st is not None and (paths is None or
                                   (st.paths == tuple(paths) and
                                    st.n_devices == int(n_devices))):
                return st
            if paths is None:
                raise KeyError(f"unknown stream {name!r} "
                               f"(known: {sorted(self._streams)})")
            st = ProbeStream(name, paths, n_devices=n_devices,
                             ema_alpha=ema_alpha,
                             on_window=self._emit_window)
            self._streams[name] = st
            return st

    def streams(self) -> Dict[str, ProbeStream]:
        with self._lock:
            return dict(self._streams)

    def publish(self, name: str, pid: int, durations: np.ndarray):
        """Fold durations into an existing stream (see
        :meth:`ProbeStream.add`)."""
        self.stream(name).add(pid, durations)

    def _emit_window(self, frame: WindowFrame):
        for fn in self._snapshot_subs("window"):
            fn(frame)

    # -- engine topics ---------------------------------------------------
    def publish_phase(self, phase: str, *, cycles: int = 0, steps: int = 1,
                      batch: Optional[int] = None):
        """Accumulate one engine phase step (prefill/cache/decode)."""
        with self._lock:
            st = self.engine.phases.setdefault(phase,
                                               {"steps": 0, "cycles": 0})
            st["steps"] += int(steps)
            st["cycles"] += int(cycles)
            if batch is not None:
                b = int(batch)
                self.engine.buckets[b] = self.engine.buckets.get(b, 0) + 1
        for fn in self._snapshot_subs("phase"):
            fn(phase, cycles, steps)

    def publish_request(self, info: Dict[str, Any]):
        """Record one finished request's phase bill (bounded history)."""
        with self._lock:
            self.engine.requests_done += 1
            self.engine.recent.append(dict(info))
        for fn in self._snapshot_subs("request"):
            fn(info)

    # -- alerts ----------------------------------------------------------
    def publish_alert(self, event: Any):
        with self._lock:
            self.alerts_total += 1
            self._alerts.append(event)
        for fn in self._snapshot_subs("alert"):
            fn(event)

    def alerts(self) -> List[Any]:
        with self._lock:
            return list(self._alerts)

    # -- subscriptions ---------------------------------------------------
    def subscribe(self, topic: str, fn: Callable) -> Callable:
        """Attach ``fn`` to a topic (``window``/``alert``/``phase``/
        ``request``); returns ``fn`` for symmetry with unsubscribe."""
        if topic not in self._subs:
            raise ValueError(f"unknown topic {topic!r}; "
                             f"expected one of {TOPICS}")
        with self._lock:
            self._subs[topic].append(fn)
        return fn

    def unsubscribe(self, topic: str, fn: Callable):
        with self._lock:
            if fn in self._subs.get(topic, ()):
                self._subs[topic].remove(fn)

    def _snapshot_subs(self, topic: str) -> List[Callable]:
        with self._lock:
            return list(self._subs[topic])

    # -- views -----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The ``/status`` document: bounded summary of everything the
        bus has seen (full per-probe rows live on ``/probes``)."""
        with self._lock:
            streams = dict(self._streams)
            phases = {p: dict(v) for p, v in self.engine.phases.items()}
            requests_done = self.engine.requests_done
            alerts_total = self.alerts_total
        return {
            "schema": 1,
            "uptime_s": round(time.time() - self._t0, 3),
            "streams": {
                name: {
                    "n_probes": len(st.paths),
                    "n_devices": st.n_devices,
                    "rows_published": st.rows_published,
                    "windows": st.windows,
                    "samples": int(st.agg.count.sum()),
                    "total_cycles": int(st.agg.total.sum()),
                } for name, st in streams.items()},
            "engine": {"phases": phases, "requests": requests_done},
            "alerts": alerts_total,
        }
