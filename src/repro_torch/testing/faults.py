"""Fault-injection harness for the telemetry drift sentinel.

Port of ``repro.testing.faults`` (pure Python and numpy; only the
imports differ): the same seed gives the JAX driver's durations.

A sentinel validated only on happy-path traffic is a sentinel that has
never been tested (SPRING's systematic-profiling framing, PAPERS.md):
the detection claims that matter are *injected-fault* claims — every
planted drift is caught, named correctly, within a bounded number of
windows, and stationary traffic never alerts.  This module provides
the deterministic traffic driver those claims are asserted against
(``tests/test_torch_telemetry.py``):

- :class:`FakeClock` — a manually advanced cycle clock, so runs are
  time-independent and replayable.
- Fault specs — :class:`StepFault` (sudden sustained shift),
  :class:`RampFault` (compounding multiplicative creep), and
  :class:`StragglerFault` (one device of a device-major stream slows,
  the stream a ``MeshProbeSession`` publishes).
- :class:`FaultDriver` — generates seeded synthetic per-call cycle
  durations window by window, applies the active fault factors,
  publishes them to a :class:`~repro_torch.telemetry.bus.ProbeStream`, and
  rolls the window.  Same seed ⇒ identical durations, regardless of
  the publishing ``chunk`` size (the sentinel chunking-invariance
  property rides on this).

Baseline durations default to bucket-interior values (the uniform
jitter band stays inside one log₂ bucket), making the zero-false-
positive sweep exact rather than probabilistic; pass ``base`` values
near a power of two to exercise edge-straddling traffic too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.telemetry.bus import TelemetryBus, WindowFrame


class FakeClock:
    """Deterministic cycle clock: advances only when told to."""

    def __init__(self, start: int = 0):
        self.cycles = int(start)

    def now(self) -> int:
        return self.cycles

    def advance(self, cycles: int) -> int:
        self.cycles += int(cycles)
        return self.cycles


@dataclass(frozen=True)
class StepFault:
    """From ``at_window`` on, ``path``'s durations are ``factor``×."""
    path: str
    at_window: int
    factor: float = 3.0

    def scale(self, path: str, device: int, window: int) -> float:
        return self.factor if path == self.path \
            and window >= self.at_window else 1.0


@dataclass(frozen=True)
class RampFault:
    """From ``start_window`` on, ``path``'s durations compound by
    ``rate``× every window — the slow-creep regression."""
    path: str
    start_window: int
    rate: float = 1.25

    def scale(self, path: str, device: int, window: int) -> float:
        if path != self.path or window < self.start_window:
            return 1.0
        return self.rate ** (window - self.start_window + 1)


@dataclass(frozen=True)
class StragglerFault:
    """From ``at_window`` on, every probe on ``device`` runs
    ``factor``× slow (device-major streams only)."""
    device: int
    at_window: int
    factor: float = 3.0
    path: Optional[str] = None        # restrict to one probe if set

    def scale(self, path: str, device: int, window: int) -> float:
        if device != self.device or window < self.at_window:
            return 1.0
        return self.factor if self.path in (None, path) else 1.0


Fault = Union[StepFault, RampFault, StragglerFault]


class FaultDriver:
    """Seeded synthetic traffic generator over one bus stream.

    Each window publishes ``samples_per_window`` per-call durations per
    (device, probe) row — ``base[path] × fault factors × uniform
    jitter`` — then rolls the window, waking every bus window
    subscriber (the sentinel).  Fully deterministic in ``seed``.
    """

    def __init__(self, bus: TelemetryBus, *, source: str = "drive",
                 paths: Sequence[str] = ("attn", "mlp"),
                 n_devices: int = 1, seed: int = 0,
                 samples_per_window: int = 64, jitter: float = 0.1,
                 base: Optional[Dict[str, int]] = None,
                 faults: Sequence[Fault] = (), chunk: Optional[int] = None,
                 clock: Optional[FakeClock] = None):
        self.bus = bus
        self.paths = tuple(paths)
        self.n_devices = int(n_devices)
        self.stream = bus.stream(source, self.paths, n_devices=n_devices)
        self.rng = np.random.default_rng(seed)
        self.samples = int(samples_per_window)
        self.jitter = float(jitter)
        # defaults sit mid-bucket: base*(1±jitter) spans no log₂ edge,
        # so stationary traffic is *exactly* stationary bucket-wise
        self.base = dict(base) if base else {
            p: 700 * (3 ** i) for i, p in enumerate(self.paths)}
        self.faults = tuple(faults)
        self.chunk = chunk
        self.clock = clock or FakeClock()
        self.windows_run = 0
        self.frames: List[WindowFrame] = []

    def factor(self, path: str, device: int, window: int) -> float:
        f = 1.0
        for fault in self.faults:
            f *= fault.scale(path, device, window)
        return f

    def _durations(self, path: str, device: int, window: int) -> np.ndarray:
        base = self.base[path] * self.factor(path, device, window)
        jit = self.rng.uniform(1.0 - self.jitter, 1.0 + self.jitter,
                               self.samples)
        return np.maximum(1, np.round(base * jit)).astype(np.int64)

    def run(self, n_windows: int) -> List[WindowFrame]:
        """Drive ``n_windows`` windows; returns their frames (also
        accumulated on ``self.frames``)."""
        out = []
        for _ in range(n_windows):
            w = self.windows_run
            for d in range(self.n_devices):
                for p, path in enumerate(self.paths):
                    durs = self._durations(path, d, w)
                    row = d * len(self.paths) + p
                    step = self.chunk or len(durs)
                    for i in range(0, len(durs), step):
                        self.stream.add(row, durs[i:i + step])
                    self.clock.advance(int(durs.sum()))
            frame = self.stream.roll(w * self.samples,
                                     (w + 1) * self.samples)
            out.append(frame)
            self.windows_run += 1
        self.frames.extend(out)
        return out
