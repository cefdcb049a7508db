"""Streaming probe telemetry: continuous in-production profiling.

Port of ``repro.core.streaming``. One-shot ``probe(fn)`` answers "where
did *this* call spend its cycles"; a serving or training loop needs
"where do cycles go across millions of steps, right now" — the paper's
always-available counters, kept running. This module provides that as a
session::

    from repro_torch.core import ProbeSession, ProbeConfig

    with ProbeSession(decode_step, ProbeConfig(targets=("layers",))) as s:
        for batch in stream:
            out = s.step(params, cache, batch)       # identical outputs
            if s.steps % 512 == 0:
                print(s.snapshot().table())          # running aggregates

Design points (the JAX session's, on eager PyTorch):

- **One capture.** The wrapped function is captured once; every
  ``step`` reruns it instrumented against the session's own device
  state (``ProbedFunction``'s stateful run), so cycle and call totals
  accumulate across steps on the device.
- **Host mirrors, no per-step device reads.** The session owns its
  state, so it keeps the host's copy of the call counts across steps
  (the instrumented run knows every exit) and, in model mode, the clock
  (the run knows every segment's cycles). ``clock()`` is then a host
  read; JAX reads the device. Both mirrors are checked against the
  device at every ``snapshot()``.
- **Constant memory.** Cross-step aggregation keeps only fixed-size
  per-probe arrays — call counts, total/min/max cycles, an EMA, and a
  64-bucket log2 histogram for p50/p99 — never the per-call history.
  ``ProbeSession.state_nbytes()`` is independent of step count.
- **Asynchronous host offload.** Each full ring row is copied to a
  pinned host block on the step's stream, and the step hands its rows
  over with one CUDA event after the last copy (``core.instrument``);
  the ``StreamingSink`` queues the rows WITH their event, and a worker
  thread waits on the event before it decodes the rows and folds them
  into the aggregates, keeping the copies off the step's critical
  path. One queue item a step, not one a row: on the card, per-row
  pinned blocks, events and worker wake-ups cost the host more than
  the probe's launches (``PERF.md``).
- **Non-intrusive.** The instrumented step never reads probe state into
  model math, so outputs stay bitwise the unprobed function's.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import report as report_mod
from repro_torch.core.buffer import HostSink, rows_array, state_bytes
from repro_torch.core.instrument import (decode_record, state_clock,
                                         state_totals)
from repro_torch.core.pragma import ProbeConfig, ProbedFunction, probe

HIST_BUCKETS = 64
_I64_MAX = np.iinfo(np.int64).max


# powers of two for exact vectorized bit_length (searchsorted over
# uint64 is integer-exact, unlike float log2 near power-of-two edges)
_POW2 = (np.uint64(1) << np.arange(HIST_BUCKETS - 1, dtype=np.uint64))


def _buckets_of(durations: np.ndarray) -> np.ndarray:
    """Log2 bucket index per duration: bucket b holds [2^(b-1), 2^b).

    Vectorized bit_length: the number of powers of two <= |x| equals
    ``int(x).bit_length()`` exactly, clamped to the last bucket."""
    d = np.abs(np.asarray(durations, dtype=np.int64)).astype(np.uint64)
    return np.searchsorted(_POW2, d, side="right").astype(np.int64)


def _bucket_rep(b: int) -> int:
    """Representative cycle value for bucket ``b`` (its midpoint)."""
    if b <= 0:
        return 0
    return ((1 << (b - 1)) + (1 << b) - 1) // 2


class StreamAggregator:
    """Constant-memory per-probe duration statistics.

    Fixed-size arrays over ``n`` probes: call count, total, min, max,
    EMA of per-call cycles, and a log-bucketed histogram from which
    quantiles (p50/p99) are estimated. Thread-safe: the streaming
    sink's worker updates it while snapshots copy it.
    """

    def __init__(self, n_probes: int, ema_alpha: float = 0.1):
        self.n = n_probes
        self.alpha = float(ema_alpha)
        self.count = np.zeros(n_probes, np.int64)
        self.total = np.zeros(n_probes, np.int64)
        self.min = np.full(n_probes, _I64_MAX, np.int64)
        self.max = np.zeros(n_probes, np.int64)
        self.ema = np.zeros(n_probes, np.float64)
        self.hist = np.zeros((n_probes, HIST_BUCKETS), np.int64)
        self._lock = threading.Lock()

    def add(self, pid: int, durations: np.ndarray):
        """Fold per-call cycle durations (oldest first) into the stats.

        Whole-array numpy: the EMA uses the closed form of the
        recurrence ``e <- (1-a)e + ax``, the same statistic as the
        sequential loop up to float rounding."""
        d = np.asarray(durations, dtype=np.int64).ravel()
        if d.size == 0:
            return
        with self._lock:
            first = self.count[pid] == 0
            self.count[pid] += d.size
            self.total[pid] += int(d.sum())
            self.min[pid] = min(int(self.min[pid]), int(d.min()))
            self.max[pid] = max(int(self.max[pid]), int(d.max()))
            a = self.alpha
            k = d.size
            # weights w[i] = (1-a)^(k-1-i): one dot product replaces the
            # per-sample Python recurrence
            w = np.power(1.0 - a, np.arange(k - 1, -1, -1, dtype=np.float64))
            x = d.astype(np.float64)
            if first:
                e = float(x[0]) if k == 1 else \
                    float(w[0] * x[0] + a * np.dot(w[1:], x[1:]))
            else:
                e = float((1.0 - a) ** k * self.ema[pid] + a * np.dot(w, x))
            self.ema[pid] = e
            np.add.at(self.hist[pid], _buckets_of(d), 1)

    def copy(self) -> "StreamAggregator":
        with self._lock:
            out = StreamAggregator(self.n, self.alpha)
            out.count = self.count.copy()
            out.total = self.total.copy()
            out.min = self.min.copy()
            out.max = self.max.copy()
            out.ema = self.ema.copy()
            out.hist = self.hist.copy()
        return out

    def __getstate__(self):
        # pickles without its lock (a mesh rank's snapshot goes back to
        # the parent process)
        with self._lock:
            return {k: v for k, v in self.__dict__.items() if k != "_lock"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def quantile(self, pid: int, q: float) -> int:
        """Histogram-estimated q-quantile of per-call cycles (bucket
        midpoint, clamped to the exact observed [min, max])."""
        n = int(self.count[pid])
        if n == 0:
            return 0
        target = max(1, int(np.ceil(q * n)))
        cum = np.cumsum(self.hist[pid])
        b = int(np.searchsorted(cum, target))
        return int(np.clip(_bucket_rep(b), self.min[pid], self.max[pid]))

    # -- cross-device reductions ----------------------------------------
    # A device-major aggregator lays its rows out as (device, probe)
    # flattened — row d*n_probes+p is probe p on device d. These views
    # reduce across that leading device axis (the bus's ``/mesh/skew``).

    REDUCTIONS = ("per-device", "max", "mean")

    def reduce(self, mode: str = "max", n_devices: int = 1) -> np.ndarray:
        """Per-probe total cycles reduced across devices: ``max`` (the
        critical path), ``mean`` (the balanced view), or ``per-device``
        (the full (D, n) matrix)."""
        t = self.total.reshape(int(n_devices), -1)
        if mode == "per-device":
            return t
        if mode == "max":
            return t.max(axis=0)
        if mode == "mean":
            return t.mean(axis=0)
        raise ValueError(f"unknown reduction {mode!r}; "
                         f"expected one of {self.REDUCTIONS}")

    def skew(self, n_devices: int) -> np.ndarray:
        """Per-probe max-min of total cycles across devices — the
        straggler signal (0 = perfectly balanced)."""
        t = self.total.reshape(int(n_devices), -1)
        return t.max(axis=0) - t.min(axis=0)

    @property
    def nbytes(self) -> int:
        return (self.count.nbytes + self.total.nbytes + self.min.nbytes +
                self.max.nbytes + self.ema.nbytes + self.hist.nbytes)


class StreamingSink(HostSink):
    """Drop-in ``HostSink`` that aggregates spills instead of storing.

    ``dump`` (called by the instrumented run at its end) only enqueues
    the run's rows with the CUDA event recorded after their copies; a
    daemon worker thread waits on that event, decodes the rows to
    per-call durations and folds them into a ``repro_torch.telemetry.
    bus.ProbeStream`` (``stats`` exposes the stream's aggregator). The raw
    history is never retained, so memory stays constant no matter how
    many rings spill; ``records()`` returns ``[]``.

    With a ``TelemetryBus`` attached, the stream is registered on the bus
    under ``source`` and the session's window rolls flow through the same
    FIFO queue as the ring rows (``queue_roll``), so bus windows close in
    spill order. The worker touches CUDA only through
    ``Event.synchronize()``; a batch that fails to decode, or a probe's
    rows that fail to fold, count in ``dropped`` and never stop the
    worker, so ``flush()`` cannot hang.
    """

    def __init__(self, ema_alpha: float = 0.1, *, bus=None,
                 source: str = "session"):
        super().__init__()
        self.ema_alpha = ema_alpha
        self.bus = bus
        self.source = source
        self._stream = None
        self.dropped = 0
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None

    @property
    def stats(self) -> Optional[StreamAggregator]:
        """The live aggregator (the bus stream's)."""
        return self._stream.agg if self._stream is not None else None

    def bind(self, n_probes: int, paths: Optional[Tuple[str, ...]] = None):
        """Size the aggregator (probe count is known only post-build)."""
        paths = tuple(paths) if paths is not None else \
            tuple(f"probe{i}" for i in range(n_probes))
        if self._stream is None or self._stream.paths != paths:
            from repro_torch.telemetry.bus import ProbeStream
            if self.bus is not None:
                self._stream = self.bus.stream(self.source, paths,
                                               ema_alpha=self.ema_alpha)
            else:
                self._stream = ProbeStream(self.source, paths,
                                           ema_alpha=self.ema_alpha)
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _store(self, probe_ids, base_counts, rows, ready=None):
        self._q.put(("rows", probe_ids, rows, ready))

    def queue_roll(self, start_step: int, end_step: int,
                   exact_totals: Optional[np.ndarray] = None):
        """Enqueue a window-roll marker; the drain worker closes the bus
        window after folding every ring row queued before it."""
        self._q.put(("roll", start_step, end_step, exact_totals))

    def _fold(self, per_pid: Dict[int, List[np.ndarray]]):
        for pid, durs in per_pid.items():
            try:
                if self._stream is None:
                    raise RuntimeError("sink not bound")
                self._stream.add(pid, np.concatenate(durs))
            except Exception:
                self.dropped += 1
        per_pid.clear()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            # batch: grab everything already queued, decode the rows to
            # durations, then fold ONE concatenated array per probe per
            # window segment — queue FIFO keeps per-probe sample order
            # and window-roll ordering
            batch = [item]
            done = 1
            stop = False
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                done += 1
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            per_pid: Dict[int, List[np.ndarray]] = {}
            for item in batch:
                if item[0] == "roll":
                    self._fold(per_pid)    # close the segment in order
                    try:
                        if self._stream is not None:
                            self._stream.roll(item[1], item[2],
                                              exact_totals=item[3])
                    except Exception:
                        self.dropped += 1
                    continue
                _, pids, rows, ready = item
                try:
                    if ready is not None:
                        ready.synchronize()     # the rows' copies landed
                    arr = rows_array(rows)
                    durs = arr[:, :, 1] - arr[:, :, 0]
                    if len(durs) != len(pids):
                        raise ValueError(f"{len(durs)} rows for "
                                         f"{len(pids)} probe ids")
                    for pid, d in zip(pids, durs):
                        per_pid.setdefault(pid, []).append(d)
                except Exception:
                    # a poisoned batch must not kill the drain thread —
                    # that would turn every later flush() into a hang
                    self.dropped += 1
            self._fold(per_pid)
            for _ in range(done):
                self._q.task_done()
            if stop:
                return

    def flush(self):
        """Block until every enqueued spill has landed and been folded
        (the worker waits on each row's event before it folds it)."""
        self._q.join()

    def close(self):
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._q.join()
            self._worker.join(timeout=5.0)
        self._worker = None


@dataclass
class WindowStat:
    """Per-probe cycles spent inside one time window of the session."""
    label: str
    start_step: int
    end_step: int
    totals: np.ndarray            # (n_probes,) int64


@dataclass
class StreamRow:
    """Running aggregate for one probe at snapshot time."""
    path: str
    calls: int                    # exact, from the device counter
    total_cycles: int             # exact, from the device counter
    observed: int                 # calls covered by duration stats
    mean: float
    ema: float
    min: int
    p50: int
    p99: int
    max: int


@dataclass
class StreamSnapshot:
    """Point-in-time view of a live session (itself constant-size)."""
    steps: int
    span: int                     # cumulative cycles since session start
    wall_s: float
    paths: Tuple[str, ...]
    rows: List[StreamRow]
    windows: List[WindowStat]
    state_nbytes: int

    def table(self) -> str:
        return report_mod.streaming_table(self)

    def bump_chart(self, top: int = 5, width: int = 18) -> str:
        return report_mod.streaming_bump_chart(self, top=top, width=width)

    def row(self, path: str) -> Optional[StreamRow]:
        for r in self.rows:
            if r.path == path:
                return r
        return None

    def bottleneck(self) -> Optional[StreamRow]:
        leaf = [r for r in self.rows
                if not any(o.path.startswith(r.path + "/")
                           for o in self.rows)]
        return max(leaf or self.rows, key=lambda r: r.total_cycles,
                   default=None)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "steps": self.steps, "span": self.span, "wall_s": self.wall_s,
            "rows": [r.__dict__ for r in self.rows],
            "windows": [{"label": w.label, "start_step": w.start_step,
                         "end_step": w.end_step,
                         "totals": w.totals.tolist()}
                        for w in self.windows],
            "state_nbytes": self.state_nbytes,
        }


class ProbeSession:
    """Continuous profiling session over an eager step function.

    Lifecycle: construct (or ``with ProbeSession(fn) as s``), call
    ``s.step(*args)`` in place of the step function — outputs are
    unchanged — then ``s.snapshot()`` any time for running aggregates
    and ``s.close()`` when done (returns the final snapshot).

    ``fn`` may be a plain callable or an existing ``ProbedFunction``;
    either way the session installs its :class:`StreamingSink`, captures
    on the first step, and every step reruns the same capture against
    the session's state. Every step must take arguments of the first
    step's structure, shapes, dtypes and devices (a changed key would be
    a new capture with other probes: it raises). The state lives on
    ``device`` (the GPU unless 'cpu' is asked; ignored for an existing
    ``ProbedFunction``).

    By default every probe spills its ring (``offload=1.0``) so the
    duration statistics cover *all* calls; pass a custom ``ProbeConfig``
    to restrict targets or disable spilling (stats then cover only each
    probe's first ``buffer_depth`` calls, like one-shot truncation).
    """

    def __init__(self, fn: Union[Callable, ProbedFunction],
                 config: Optional[ProbeConfig] = None, *,
                 window_steps: int = 16, max_windows: int = 8,
                 ema_alpha: float = 0.1, poll_every: int = 1,
                 bus=None, source: str = "session", device=None):
        if isinstance(fn, ProbedFunction):
            self.pf = fn
            if config is not None:
                self.pf.retarget(config)
        else:
            self.pf = probe(fn, config if config is not None
                            else ProbeConfig(offload=1.0), device=device)
        self.sink = StreamingSink(ema_alpha=ema_alpha, bus=bus,
                                  source=source)
        # every run of the wrapped function reads its sink; close()
        # restores the original one
        self._orig_sink = self.pf.sink
        self.pf.sink = self.sink
        self.window_steps = int(window_steps)
        self.max_windows = int(max_windows)
        self.poll_every = int(poll_every)
        self._state = None
        self._asg = None
        self._calls: List[int] = []
        self._clock = 0
        self._steps = 0
        self._closed = False
        self._t0 = 0.0
        self._prev_totals: Optional[np.ndarray] = None
        self._win_start = 0
        self._windows: deque = deque(maxlen=max_windows)

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "ProbeSession":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def paths(self) -> Tuple[str, ...]:
        return self.pf.assignment.paths

    @property
    def model_clock(self) -> bool:
        return self.pf.config.cycle_source == "model"

    def step(self, *args, **kwargs):
        """Run one profiled step; returns exactly ``fn(*args)``'s output."""
        if self._closed:
            raise RuntimeError("session is closed")
        if self._state is None:
            self._start(*args, **kwargs)
        self.pf.ensure_built(*args, **kwargs)
        if self.pf.assignment is not self._asg:
            raise RuntimeError(
                "the session's step got arguments of another structure or "
                "shape than its first step (a new capture)")
        out, _ = self.pf._run(self._state, args, kwargs, calls=self._calls)
        self._clock += self.pf.last_run["cycles"]
        self._steps += 1
        if self._steps % self.poll_every == 0:
            self._maybe_roll_window()
        return out

    def _start(self, *args, **kwargs):
        self.pf.ensure_built(*args, **kwargs)
        self._asg = self.pf.assignment
        n = self._asg.n
        self.sink.bind(n, paths=self._asg.paths)
        self._state = self.pf.init_state()
        self._calls = [0] * n
        self._clock = 0
        self._prev_totals = np.zeros(n, np.int64)
        self._win_start = 0
        self._t0 = time.perf_counter()

    def clock(self) -> int:
        """Current clock value (cycles since the session's first step; 0
        before any step). In model mode it is the host's copy, which
        costs no device read — the serving engine takes clock deltas
        around each step call; in wallclock mode it reads the device."""
        if self._state is None:
            return 0
        if self.model_clock:
            return self._clock
        return state_clock(self._state)

    def _maybe_roll_window(self):
        """Close the current time window once it is full. The window
        delta telescopes to (totals now - totals at window start), so
        the device read happens once per window boundary."""
        if self._steps - self._win_start < self.window_steps:
            return
        totals = state_totals(self._state)
        delta = totals - self._prev_totals
        self._windows.append(WindowStat(
            f"[{self._win_start}..{self._steps})", self._win_start,
            self._steps, delta))
        # every ring row of the window was queued on the host during its
        # step, so the roll marker closes the bus window at exactly this
        # boundary
        self.sink.queue_roll(self._win_start, self._steps,
                             exact_totals=delta)
        self._prev_totals = totals
        self._win_start = self._steps

    # -- results ---------------------------------------------------------
    def _merged_stats(self, rec: Dict[str, Any]) -> StreamAggregator:
        """Aggregates incl. calls still sitting in the device rings."""
        asg = self.pf.assignment
        merged = self.sink.stats.copy()
        for pid in range(asg.n):
            calls = int(rec["calls"][pid])
            rem = (calls % asg.depth) if asg.spill[pid] \
                else min(calls, asg.depth)
            if rem:
                spans = rec["ring"][pid, :rem]
                merged.add(pid, spans[:, 1] - spans[:, 0])
        return merged

    def _check_mirrors(self, rec: Dict[str, Any]) -> None:
        calls = [int(c) for c in rec["calls"]]
        if calls != self._calls:
            raise RuntimeError(f"the host's call counts {self._calls} "
                               f"differ from the device's {calls}")
        if self.model_clock and rec["cycle"] != self._clock:
            raise RuntimeError(f"the host's clock {self._clock} differs "
                               f"from the device's {rec['cycle']}")

    def snapshot(self) -> StreamSnapshot:
        """Flush pending offloads and build a constant-size snapshot.

        The device read comes first and waits for every step queued so
        far; the flush then waits for the worker to fold every queued
        row (each after its copy's event), so the aggregates cover every
        call the counters have seen. The host's mirrors of the call
        counts and the clock are checked against the device here."""
        if self._state is None:
            raise RuntimeError("no steps executed yet")
        rec = decode_record(self._state)
        self._check_mirrors(rec)
        self.sink.flush()
        asg = self.pf.assignment
        stats = self._merged_stats(rec)
        rows = []
        for pid, path in enumerate(asg.paths):
            cnt = int(stats.count[pid])
            rows.append(StreamRow(
                path=path,
                calls=int(rec["calls"][pid]),
                total_cycles=int(rec["totals"][pid]),
                observed=cnt,
                mean=float(stats.total[pid]) / cnt if cnt else 0.0,
                ema=float(stats.ema[pid]),
                min=int(stats.min[pid]) if cnt else 0,
                p50=stats.quantile(pid, 0.50),
                p99=stats.quantile(pid, 0.99),
                max=int(stats.max[pid])))
        windows = list(self._windows)
        if self._steps > self._win_start:
            partial = rec["totals"] - self._prev_totals
            if partial.any():
                windows.append(WindowStat(
                    f"[{self._win_start}..{self._steps})*",
                    self._win_start, self._steps, partial))
        return StreamSnapshot(
            steps=self._steps, span=rec["cycle"],
            wall_s=time.perf_counter() - self._t0,
            paths=asg.paths, rows=rows, windows=windows,
            state_nbytes=self.state_nbytes())

    def state_nbytes(self) -> int:
        """Total profiling-state footprint: device counters + host
        aggregates + bounded window history. Independent of ``steps``."""
        host = self.sink.stats.nbytes if self.sink.stats is not None else 0
        if self._prev_totals is not None:
            host += self._prev_totals.nbytes
        host += sum(w.totals.nbytes for w in self._windows)
        dev = state_bytes(self.pf.assignment.n, self.pf.config.buffer_depth) \
            if self._state is not None else 0
        return host + dev

    def close(self) -> Optional[StreamSnapshot]:
        """End the session; returns the final snapshot (None if unused).

        Restores the wrapped function's original sink, so later one-shot
        calls don't spill into the now-dead streaming worker."""
        if self._closed:
            return None
        snap = self.snapshot() if self._state is not None else None
        self.sink.close()
        self.pf.sink = self._orig_sink
        self._closed = True
        return snap
