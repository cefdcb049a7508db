"""Online drift sentinel: the CI regression gate, moved into serving.

Port of ``repro.telemetry.sentinel`` (pure Python and numpy; only the
imports differ).

``benchmarks/check_regression.py`` catches a cycle regression only
after the fact, in CI, against a committed baseline.  Production wants
the same judgement *online*: watch the live probe streams and flag the
moment a probe's cycle distribution shifts, a p99 regresses, or one
device of a mesh starts straggling.  The sentinel subscribes to the
:class:`~repro_torch.telemetry.bus.TelemetryBus` window topic and applies
three rules to every closed window, per (stream, probe) row:

- **hist-drift** — total-variation distance between the window's
  normalized log₂-bucket histogram and the reference histogram exceeds
  ``hist_threshold``.  Catches shape changes the scalar rules miss.
- **p99-regression** — the window's histogram-estimated p99 exceeds
  ``p99_ratio ×`` the reference p99.
- **straggler** — (device-major streams only) one device's window
  cycle total exceeds ``skew_ratio ×`` the across-device median.
  Names the straggling device.

Detection discipline (what makes it testable):

- **Warmup gate.** The first ``warmup_windows`` windows of a row form
  its frozen reference; no judgement is made until the reference is
  complete, and windows with fewer than ``min_samples`` observations
  are never judged (nor folded into a partial reference verdict).
- **Hysteresis.** A rule must breach on ``trip_windows`` *consecutive*
  windows before an event fires — a single noisy window never alerts.
- **Rebaseline on fire.** Firing emits one structured
  :class:`DriftEvent` (published on the bus's ``alert`` topic), then
  resets the row: the post-drift regime becomes the next reference, so
  a persistent step change alerts exactly once and a continuing ramp
  alerts repeatedly — both asserted by the fault-injection harness in
  ``tests/test_torch_telemetry.py``.

A ``retune`` hook (see :func:`make_retune_hook`) receives every fired
event: any callable. The port has no DSE engine yet, so nothing re-tunes
behind it.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.bus import TelemetryBus, WindowFrame, hist_quantile

KINDS = ("hist-drift", "p99-regression", "straggler")


@dataclass(frozen=True)
class SentinelConfig:
    """Detection knobs (defaults sized for ≥32-sample windows)."""
    warmup_windows: int = 4       # windows forming the frozen reference
    min_samples: int = 8          # ignore windows with fewer samples
    hist_threshold: float = 0.35  # total-variation distance trip point
    p99_ratio: float = 1.8        # window p99 / reference p99 trip point
    skew_ratio: float = 2.0       # device total / median trip point
    trip_windows: int = 2         # consecutive breaches before firing


@dataclass(frozen=True)
class DriftEvent:
    """One fired detection, named down to the probe (and device)."""
    kind: str                     # one of KINDS
    stream: str
    path: str                     # probe path inside the stream
    device: Optional[int]         # straggler device (None off-mesh)
    window: int                   # frame index that tripped the rule
    severity: float               # rule statistic (tv / ratio)
    threshold: float              # the trip point it exceeded
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "stream": self.stream,
                "path": self.path, "device": self.device,
                "window": self.window,
                "severity": round(float(self.severity), 4),
                "threshold": float(self.threshold),
                "detail": self.detail}


@dataclass
class _RowState:
    """Per (stream, row) detector state — constant size."""
    windows_seen: int = 0
    ref_hist: np.ndarray = None       # accumulated warmup histogram
    ref_count: int = 0
    breaches: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in KINDS})


class DriftSentinel:
    """Sliding-window drift detection over bus streams (see module
    docstring).  Attach with ``DriftSentinel(bus)``; every fired event
    lands on the bus's alert ring (``/alerts``) and in ``self.events``.
    """

    def __init__(self, bus: TelemetryBus,
                 config: SentinelConfig = SentinelConfig(), *,
                 retune: Optional[Callable[[DriftEvent], None]] = None):
        self.bus = bus
        self.cfg = config
        self.retune = retune
        self.events: List[DriftEvent] = []
        self._rows: Dict[Tuple[str, int], _RowState] = {}
        self._lock = threading.Lock()
        bus.subscribe("window", self.observe)

    def close(self):
        self.bus.unsubscribe("window", self.observe)

    # -- state views -----------------------------------------------------
    def row_state(self, stream: str, row: int) -> _RowState:
        key = (stream, row)
        st = self._rows.get(key)
        if st is None:
            st = self._rows[key] = _RowState()
        return st

    def tripped(self) -> List[DriftEvent]:
        with self._lock:
            return list(self.events)

    # -- detection -------------------------------------------------------
    def observe(self, frame: WindowFrame):
        """Judge one closed window (the bus window-topic callback)."""
        with self._lock:
            fired = list(self._judge(frame))
        for ev in fired:
            self.bus.publish_alert(ev)
            if self.retune is not None:
                self.retune(ev)

    def _judge(self, frame: WindowFrame):
        cfg = self.cfg
        dev_totals = frame.per_device()              # (D, n)
        for row in range(len(frame.counts)):
            d, p = divmod(row, frame.n_probes)
            st = self.row_state(frame.stream, row)
            n = int(frame.counts[row])
            if n < cfg.min_samples:
                continue                             # never judged
            if st.windows_seen < cfg.warmup_windows:
                # frozen reference under construction
                if st.ref_hist is None:
                    st.ref_hist = np.zeros_like(frame.hist[row])
                st.ref_hist = st.ref_hist + frame.hist[row]
                st.ref_count += n
                st.windows_seen += 1
                continue
            st.windows_seen += 1
            # straggler first on mesh streams: a single-device shift
            # trips both it and hist-drift, and the straggler verdict
            # is the actionable one (it names the device).  A global
            # shift moves the median too, so it never trips straggler.
            ev = None
            if frame.n_devices > 1:
                ev = self._rule_straggler(frame, row, st,
                                          dev_totals, d, p)
            ev = (ev or self._rule_hist(frame, row, st)
                  or self._rule_p99(frame, row, st))
            if ev is not None:
                self._reset(st)
                yield ev

    def _fire(self, st: _RowState, kind: str, frame: WindowFrame,
              row: int, severity: float, threshold: float,
              detail: str, device: Optional[int] = None
              ) -> Optional[DriftEvent]:
        """Hysteresis: breach must persist ``trip_windows`` windows."""
        st.breaches[kind] += 1
        if st.breaches[kind] < self.cfg.trip_windows:
            return None
        d, p = divmod(row, frame.n_probes)
        if device is None and frame.n_devices > 1:
            device = d                 # device-major row names its device
        ev = DriftEvent(kind=kind, stream=frame.stream,
                        path=frame.paths[p], device=device,
                        window=frame.index, severity=severity,
                        threshold=threshold, detail=detail)
        self.events.append(ev)
        return ev

    def _reset(self, st: _RowState):
        """Rebaseline after firing: the new regime becomes the next
        reference (fresh warmup), counters cleared."""
        st.windows_seen = 0
        st.ref_hist = None
        st.ref_count = 0
        st.breaches = {k: 0 for k in KINDS}

    def _rule_hist(self, frame: WindowFrame, row: int,
                   st: _RowState) -> Optional[DriftEvent]:
        ref = st.ref_hist / max(st.ref_count, 1)
        cur = frame.hist[row] / max(int(frame.counts[row]), 1)
        tv = 0.5 * float(np.abs(ref - cur).sum())
        if tv <= self.cfg.hist_threshold:
            st.breaches["hist-drift"] = 0
            return None
        return self._fire(st, "hist-drift", frame, row, tv,
                          self.cfg.hist_threshold,
                          f"tv={tv:.3f} over {int(frame.counts[row])} "
                          f"samples")

    def _rule_p99(self, frame: WindowFrame, row: int,
                  st: _RowState) -> Optional[DriftEvent]:
        ref_p99 = hist_quantile(st.ref_hist, 0.99, count=st.ref_count)
        cur_p99 = frame.p99(row)
        ratio = cur_p99 / max(ref_p99, 1)
        if ratio <= self.cfg.p99_ratio:
            st.breaches["p99-regression"] = 0
            return None
        return self._fire(st, "p99-regression", frame, row, ratio,
                          self.cfg.p99_ratio,
                          f"p99 {ref_p99} -> {cur_p99} cycles")

    def _rule_straggler(self, frame: WindowFrame, row: int,
                        st: _RowState, dev_totals: np.ndarray,
                        device: int, probe: int) -> Optional[DriftEvent]:
        col = dev_totals[:, probe]
        med = float(np.median(col))
        mine = float(dev_totals[device, probe])
        ratio = mine / max(med, 1.0)
        if med <= 0 or ratio <= self.cfg.skew_ratio \
                or int(np.argmax(col)) != device:
            st.breaches["straggler"] = 0
            return None
        return self._fire(st, "straggler", frame, row, ratio,
                          self.cfg.skew_ratio,
                          f"device {device} at {int(mine)} cycles vs "
                          f"median {int(med)}", device=device)


def make_retune_hook(tune: Callable[[DriftEvent], Any], *,
                     background: bool = True) -> Callable[[DriftEvent], None]:
    """Wrap a tuning callable as a sentinel ``retune`` hook.

    At most one re-tune runs at a time: events arriving while a tune is
    in flight are coalesced into ``hook.skipped`` (a drifting kernel
    fires repeatedly; re-tuning once covers the batch).  With
    ``background=True`` the tune runs on a daemon thread so detection
    never blocks on it; tests use ``background=False`` for
    determinism.
    """
    lock = threading.Lock()

    def hook(event: DriftEvent):
        if not lock.acquire(blocking=False):
            hook.skipped += 1
            return
        def run():
            try:
                hook.last_result = tune(event)
                hook.fired += 1
            finally:
                lock.release()
        if background:
            threading.Thread(target=run, daemon=True).start()
        else:
            run()

    hook.fired = 0
    hook.skipped = 0
    hook.last_result = None
    return hook
