"""Result collection + visualization (paper stage 5, Fig 4 / Fig 14).

Port of ``repro.core.report`` (the one-shot views, the streaming
session's table and bump chart, the serving engine's phase, chunk and
request bills, the telemetry sentinel's tables, the mesh views of
``core.meshprobe`` and the DSE leaderboard) and the kernel grid-step views
(``kernel_grid_table``, ``kernel_grid_heat``). Builds per-probe
rows (calls, total cycles, start/end, first-N iteration spans) from the
decoded device record, merges offloaded history from the host sink, and
renders a table, an ASCII execution timeline (the Fig 4 waveform) and a
bottleneck bump chart (the Fig 14 ranking-shift view). The text of
every view is the JAX package's, byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.buffer import HostSink
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.instrument import ProbeAssignment, decode_record


@dataclass
class ProbeRow:
    path: str
    calls: int
    total_cycles: int
    start: int
    end: int
    iters: List[Tuple[int, int]]
    source: str = ""
    static_cycles: Optional[int] = None
    dynamic: bool = False


@dataclass
class Report:
    rows: List[ProbeRow]
    span: int
    cycle_source: str

    def row(self, path: str) -> Optional[ProbeRow]:
        for r in self.rows:
            if r.path == path:
                return r
        return None

    def bottleneck(self, prefix: str = "") -> Optional[ProbeRow]:
        cands = [r for r in self.rows
                 if r.path.startswith(prefix) and r.path != prefix]
        leaf = [r for r in cands
                if not any(o.path.startswith(r.path + "/") for o in cands)]
        pool = leaf or cands
        return max(pool, key=lambda r: r.total_cycles, default=None)

    # ---------------------------------------------------------- rendering
    def table(self) -> str:
        w = max((len(r.path) for r in self.rows), default=4) + 2
        lines = [f"{'module':<{w}}{'calls':>7}{'cycles':>14}{'%span':>7}"
                 f"{'start':>12}{'end':>12}  {'static(C-synth)':>16}  source"]
        for r in self.rows:
            pct = 100.0 * r.total_cycles / self.span if self.span else 0.0
            stat = ("?" if r.dynamic else str(r.static_cycles)
                    ) if r.static_cycles is not None else ""
            lines.append(f"{r.path:<{w}}{r.calls:>7}{r.total_cycles:>14}"
                         f"{pct:>6.1f}%{r.start:>12}{r.end:>12}"
                         f"  {stat:>16}  {r.source}")
        return "\n".join(lines)

    def timeline(self, width: int = 72) -> str:
        """ASCII waveform: one lane per probe, bars over the global span."""
        if not self.rows or self.span <= 0:
            return "(empty)"
        w = max(len(r.path) for r in self.rows) + 2
        lines = []
        for r in self.rows:
            lane = [" "] * width
            spans = r.iters if r.iters else [(r.start, r.end)]
            for (s, e) in spans:
                i0 = int(width * s / self.span)
                i1 = max(i0 + 1, int(width * e / self.span))
                for i in range(i0, min(i1, width)):
                    lane[i] = "█"
            lines.append(f"{r.path:<{w}}|{''.join(lane)}|")
        scale = f"{'':<{w}} 0{'cycles':^{width - 10}}{self.span}"
        return "\n".join(lines + [scale])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span": self.span,
            "cycle_source": self.cycle_source,
            "rows": [r.__dict__ for r in self.rows],
        }


def build_report(h: Hierarchy, asg: ProbeAssignment, record: Dict[str, Any],
                 sink: Optional[HostSink], cycle_source: str) -> Report:
    rec = decode_record(record)
    starts, ends = rec["starts"], rec["ends"]
    totals, calls, ring = rec["totals"], rec["calls"], rec["ring"]
    span = rec["cycle"]
    rows: List[ProbeRow] = []
    for pid, path in enumerate(asg.paths):
        node = h.node(path)
        n_calls = int(calls[pid])
        iters: List[Tuple[int, int]] = []
        if sink is not None and asg.spill[pid]:
            iters.extend(sink.records(pid))
        # ring holds the first `depth` iterations, or — with spill — the
        # most recent partial window beyond the dumps
        kept = (n_calls % asg.depth) if asg.spill[pid] \
            else min(n_calls, asg.depth)
        iters.extend((int(ring[pid, s, 0]), int(ring[pid, s, 1]))
                     for s in range(kept))
        static = None
        dynamic = False
        if node is not None:
            # C-synth-style TOTAL estimate: per-visit static cycles times
            # the product of ancestor (and own) static loop trip counts;
            # any while/cond on the path makes the estimate unknowable.
            mult = 1
            cur = ""
            for seg in path.split("/"):
                cur = f"{cur}/{seg}" if cur else seg
                anc = h.node(cur)
                if anc is None:
                    continue
                if anc.kind == "loop" and anc.trip_count:
                    mult *= anc.trip_count
                if anc.kind in ("while", "cond"):
                    dynamic = True
            static = node.static_cycles * mult
            dynamic = dynamic or node.dynamic
        rows.append(ProbeRow(path=path, calls=n_calls,
                             total_cycles=int(totals[pid]),
                             start=int(starts[pid]), end=int(ends[pid]),
                             iters=iters,
                             source=node.source if node else "",
                             static_cycles=static, dynamic=dynamic))
    return Report(rows=rows, span=span, cycle_source=cycle_source)


# ------------------------------------------- kernel grid-step rendering

def _grid_rows(h: Hierarchy, report: Report):
    """(row, ScopeNode) pairs for kernel grid probes in a report."""
    out = []
    for r in report.rows:
        node = h.node(r.path)
        if node is not None and node.kind == "loop" and node.grid:
            out.append((r, node))
    return out


def kernel_grid_table(h: Hierarchy, report: Report) -> str:
    """Per-kernel grid-step imbalance summary.

    One row per probed ``kernel/<name>/grid`` scope: grid shape, steps
    executed, recorded per-step durations (ring depth, or all steps
    with offload) with min/mean/max and the step skew (max-min: the
    causal-skip / tile-imbalance signal), plus the static per-step
    estimate.
    """
    rows = _grid_rows(h, report)
    if not rows:
        return "(no kernel grid probes in this report)"
    w = max(len(r.path) for r, _ in rows) + 2
    lines = [f"{'kernel grid':<{w}}{'grid':>14}{'steps':>7}{'rec':>5}"
             f"{'min':>8}{'mean':>9}{'max':>8}{'skew':>8}{'static/step':>12}"]
    for r, node in rows:
        durs = [e - s for s, e in r.iters]
        per_visit = node.static_cycles
        if durs:
            lines.append(
                f"{r.path:<{w}}{'x'.join(map(str, node.grid)):>14}"
                f"{r.calls:>7}{len(durs):>5}{min(durs):>8}"
                f"{sum(durs) / len(durs):>9.1f}{max(durs):>8}"
                f"{max(durs) - min(durs):>8}{per_visit:>12}")
        else:
            lines.append(f"{r.path:<{w}}{'x'.join(map(str, node.grid)):>14}"
                         f"{r.calls:>7}{0:>5}{'-':>8}{'-':>9}{'-':>8}"
                         f"{'-':>8}{per_visit:>12}")
    return "\n".join(lines)


def kernel_grid_heat(h: Hierarchy, report: Report,
                     path: Optional[str] = None,
                     chars: str = " .:-=+*#%@") -> str:
    """ASCII heat map of per-grid-step cycles for one kernel.

    Rows/columns follow the grid (leading axes flattened into rows,
    last, the sequential axis, across). Renders every recorded step
    (all of them when the probe offloads, the first ``depth``
    otherwise); dark cells are expensive tiles, so a causal flash
    kernel shows its triangle. Defaults to the grid probe with the
    largest step skew."""
    rows = _grid_rows(h, report)
    if not rows:
        return "(no kernel grid probes in this report)"
    if path is None:
        def skew(r):
            d = [e - s for s, e in r.iters]
            return (max(d) - min(d)) if d else -1
        row, node = max(rows, key=lambda rn: skew(rn[0]))
    else:
        match = [(r, n) for r, n in rows if r.path == path]
        if not match:
            raise ValueError(f"no grid probe at {path!r}; have "
                             f"{[r.path for r, _ in rows]}")
        row, node = match[0]
    durs = np.asarray([e - s for s, e in row.iters], np.int64)
    if durs.size == 0:
        return f"# heat: {row.path} — no recorded steps"
    lo, hi = int(durs.min()), int(durs.max())
    span = (hi - lo) or 1
    last = node.grid[-1]
    full = durs.size % last == 0
    grid2d = durs.reshape(-1, last) if full else durs.reshape(1, -1)
    cell = len(str(hi)) + 1
    lines = [f"# heat: {row.path} grid={'x'.join(map(str, node.grid))} "
             f"recorded={durs.size}/{row.calls} steps "
             f"(min={lo} max={hi} skew={hi - lo})"]
    for r in range(grid2d.shape[0]):
        cells = []
        for c in range(grid2d.shape[1]):
            v = int(grid2d[r, c])
            shade = chars[int((v - lo) / span * (len(chars) - 1))]
            cells.append(f"{shade}{v:>{cell}}")
        lines.append(" ".join(cells))
    return "\n".join(lines)


# ------------------------------------------------------ mesh rendering

_HEAT_CHARS = " .:-=+*#%@"


def mesh_device_table(rec, top: int = 0) -> str:
    """Per-device cycle table for a ``meshprobe.CycleRecord``: one row
    per probe, one column per device, plus the cross-device reductions
    (max / mean) and the skew straggler signal."""
    D = rec.n_devices
    w = max((len(p) for p in rec.paths), default=6) + 2
    dev_w = max(10, len(str(int(rec.totals.max(initial=0)))) + 2)
    head = (f"{'module':<{w}}" +
            "".join(f"{'dev' + str(d):>{dev_w}}" for d in range(D)) +
            f"{'max':>{dev_w}}{'mean':>{dev_w}}{'skew':>{dev_w}}")
    coord = (f"{'(mesh coord)':<{w}}" +
             "".join(f"{str(rec.coords(d)):>{dev_w}}" for d in range(D)))
    lines = [f"# mesh {dict(zip(rec.mesh_axes, rec.mesh_shape))} — "
             f"{D} devices, span max={int(rec.cycle.max(initial=0))} cycles",
             head, coord]
    order = np.argsort(-rec.totals.max(axis=0), kind="stable")
    if top:
        order = order[:top]
    for pid in order:
        t = rec.totals[:, pid]
        lines.append(
            f"{rec.paths[pid]:<{w}}" +
            "".join(f"{int(t[d]):>{dev_w}}" for d in range(D)) +
            f"{int(t.max()):>{dev_w}}{t.mean():>{dev_w}.1f}"
            f"{int(t.max() - t.min()):>{dev_w}}")
    return "\n".join(lines)


def mesh_heat(rec, path: Optional[str] = None, chars: str = _HEAT_CHARS
              ) -> str:
    """ASCII heat map of one probe's cycles over the mesh grid — the
    per-device view at a glance (dark cell = straggler). 1D meshes
    render as a row; >2D meshes flatten their leading axes into rows."""
    if not rec.paths:
        return "(no probes selected)"
    if path is None:
        _, path = rec.straggler()
    pid = rec.paths.index(path)
    t = rec.totals[:, pid].astype(np.float64)
    lo, hi = float(t.min()), float(t.max())
    span = (hi - lo) or 1.0
    shape = rec.mesh_shape if len(rec.mesh_shape) > 1 else \
        (1,) + tuple(rec.mesh_shape)
    grid = t.reshape((-1, shape[-1]))
    cell = max((len(str(int(x))) for x in t), default=1) + 1
    lines = [f"# heat: {path} over mesh "
             f"{dict(zip(rec.mesh_axes, rec.mesh_shape))} "
             f"(min={int(lo)} max={int(hi)} skew={int(hi - lo)})"]
    for r in range(grid.shape[0]):
        cells = []
        for c in range(grid.shape[1]):
            v = grid[r, c]
            shade = chars[int((v - lo) / span * (len(chars) - 1))]
            cells.append(f"{shade}{int(v):>{cell}}")
        lines.append(" ".join(cells))
    return "\n".join(lines)


def mesh_comm_table(rec, hierarchy, sites,
                    bytes_per_cycle: Optional[float] = None) -> str:
    """Compute vs. communication per module: measured cycles (max over
    devices) against the ring-model collective cycles attributed to the
    same scope path (static per program run, ancestor loop trips
    folded in). Comm cycles are wire bytes over ``bytes_per_cycle``
    (default: the model's NVLink ``LINK_BYTES_PER_CYCLE``, where the JAX
    package divides by its ICI rate)."""
    if bytes_per_cycle is None:
        from repro_torch.core.costmodel import LINK_BYTES_PER_CYCLE
        bytes_per_cycle = LINK_BYTES_PER_CYCLE

    def trip_mult(path: str) -> int:
        mult, cur = 1, ""
        for seg in (path.split("/") if path else []):
            cur = f"{cur}/{seg}" if cur else seg
            node = hierarchy.node(cur)
            if node is not None and node.kind == "loop" and node.trip_count:
                mult *= node.trip_count
        return mult

    per_path: Dict[str, Dict[str, float]] = {}
    for s in sites:
        d = per_path.setdefault(s.path, {"count": 0, "wire": 0.0,
                                         "kinds": set()})
        m = trip_mult(s.path)
        d["count"] += m
        d["wire"] += s.wire_bytes * m
        d["kinds"].add(s.kind)
    if not per_path:
        return "(no collectives in the probed program)"
    probed = {p: int(rec.totals[:, i].max())
              for i, p in enumerate(rec.paths)}

    def nearest_probe_cycles(path: str) -> Optional[int]:
        cur = path
        while True:
            if cur in probed:
                return probed[cur]
            if "/" not in cur:
                return probed.get("", None)
            cur = cur.rsplit("/", 1)[0]

    w = max(len(p) for p in per_path) + 2
    lines = [f"{'module':<{w}}{'collectives':>12}{'wire_B':>12}"
             f"{'comm_cyc':>10}{'probed_cyc':>11}{'comm%':>7}  kinds"]
    for path in sorted(per_path, key=lambda p: -per_path[p]["wire"]):
        d = per_path[path]
        comm_cyc = int(np.ceil(d["wire"] / bytes_per_cycle))
        total = nearest_probe_cycles(path)
        pct = (f"{100.0 * comm_cyc / total:6.1f}%" if total else f"{'-':>7}")
        lines.append(f"{path or '/':<{w}}{int(d['count']):>12}"
                     f"{int(d['wire']):>12}{comm_cyc:>10}"
                     f"{total if total is not None else '-':>11}{pct}"
                     f"  {','.join(sorted(d['kinds']))}")
    return "\n".join(lines)


def mesh_session_table(snap, reduce: str = "max") -> str:
    """Running table for a live ``MeshProbeSession`` snapshot, reduced
    across devices (or expanded per device via ``reduce='per-device'``,
    which falls through to the full device table)."""
    rec = snap.record
    if reduce == "per-device":
        return mesh_device_table(rec)
    red = rec.reduce(reduce)
    skew = rec.skew()
    calls = rec.calls.max(axis=0)
    span = int(rec.cycle.max(initial=0))
    w = max((len(p) for p in rec.paths), default=6) + 2
    lines = [f"# mesh session: {snap.steps} steps, {rec.n_devices} devices, "
             f"span(max)={span} cycles, state={snap.state_nbytes}B",
             f"{'module':<{w}}{'calls':>9}{f'cycles({reduce})':>16}"
             f"{'%span':>7}{'skew':>12}"]
    for pid in np.argsort(-np.asarray(red), kind="stable"):
        pct = 100.0 * float(red[pid]) / span if span else 0.0
        lines.append(f"{rec.paths[pid]:<{w}}{int(calls[pid]):>9}"
                     f"{float(red[pid]):>16.1f}{pct:>6.1f}%"
                     f"{int(skew[pid]):>12}")
    return "\n".join(lines)


def bump_chart(rankings: Dict[str, List[str]], width: int = 18) -> str:
    """Fig-14-style bottleneck ranking shifts across profiling stages.

    rankings: stage name -> module paths ordered worst-first.
    """
    stages = list(rankings)
    lines = ["  ".join(f"{s:<{width}}" for s in stages)]
    depth = max(len(v) for v in rankings.values())
    for rank in range(depth):
        cells = []
        for s in stages:
            v = rankings[s]
            cells.append(f"#{rank + 1} {v[rank] if rank < len(v) else '':<{width - 3}}")
        lines.append("  ".join(cells))
    return "\n".join(lines)


def streaming_table(snapshot) -> str:
    """Running table for a live ``ProbeSession`` snapshot.

    ``snapshot`` is a ``streaming.StreamSnapshot`` (duck-typed: ``rows``
    with per-probe running stats, ``steps``, ``span``). Shows the
    constant-memory aggregates — counts, totals, EMA and the
    log-bucket-derived p50/p99 — instead of raw per-iteration spans.
    """
    rows = snapshot.rows
    w = max((len(r.path) for r in rows), default=6) + 2
    head = (f"{'module':<{w}}{'calls':>9}{'cycles':>14}{'%span':>7}"
            f"{'mean':>10}{'ema':>10}{'min':>9}{'p50':>9}{'p99':>9}"
            f"{'max':>9}")
    lines = [f"# session: {snapshot.steps} steps, span={snapshot.span} "
             f"cycles", head]
    for r in rows:
        pct = 100.0 * r.total_cycles / snapshot.span if snapshot.span else 0.0
        lines.append(
            f"{r.path:<{w}}{r.calls:>9}{r.total_cycles:>14}{pct:>6.1f}%"
            f"{r.mean:>10.1f}{r.ema:>10.1f}{r.min:>9}{r.p50:>9}{r.p99:>9}"
            f"{r.max:>9}")
    return "\n".join(lines)


def streaming_bump_chart(snapshot, top: int = 5, width: int = 18) -> str:
    """Fig-14-style ranking shifts across the session's time windows.

    Each retained window (bounded deque — constant memory) becomes one
    bump-chart stage ranking probes by cycles spent *inside that
    window*, so hot-spot drift over a long-running session is visible.
    """
    if not snapshot.windows:
        return "(no complete windows yet)"
    rankings: Dict[str, List[str]] = {}
    for wdw in snapshot.windows:
        order = np.argsort(-np.asarray(wdw.totals, dtype=np.int64),
                           kind="stable")[:top]
        rankings[wdw.label] = [snapshot.paths[i] for i in order
                               if wdw.totals[i] > 0]
    return bump_chart(rankings, width=width)


# ------------------------------------------------- serving engine views

def engine_phase_table(phase_totals: Dict[str, Dict[str, int]]) -> str:
    """Per-phase cycle attribution for a serving-engine run.

    ``phase_totals``: phase name -> {"cycles": total model-clock cycles,
    "steps": step-function invocations} as produced by
    ``repro_torch.engine.InferenceEngine.stats()``. Shows where the engine's
    device time goes: prompt prefill vs token decode vs paged-cache
    management (page scatter).
    """
    total = sum(v.get("cycles", 0) for v in phase_totals.values())
    lines = [f"{'phase':<16}{'steps':>8}{'cycles':>14}{'%':>7}"
             f"{'cycles/step':>13}"]
    for phase, v in phase_totals.items():
        cyc, steps = v.get("cycles", 0), v.get("steps", 0)
        pct = 100.0 * cyc / total if total else 0.0
        per = cyc / steps if steps else 0.0
        lines.append(f"{phase:<16}{steps:>8}{cyc:>14}{pct:>6.1f}%"
                     f"{per:>13.1f}")
    lines.append(f"{'total':<16}{'':>8}{total:>14}{100.0 if total else 0.0:>6.1f}%")
    return "\n".join(lines)


def engine_chunk_table(chunk_stats: Dict[tuple, Dict[str, int]]) -> str:
    """Per-(ctx pages, chunk pages) attribution for chunked-prefill
    continuation steps (``InferenceEngine.chunk_stats``). Each row is
    one pinned chunkpf trace shape; cycles include the paired cache
    scatter, so rows sum to the chunked share of prefill+cache time."""
    lines = [f"{'ctx pages':>10}{'chunk pages':>13}{'steps':>8}"
             f"{'cycles':>14}{'cycles/step':>13}"]
    for (cs, n) in sorted(chunk_stats):
        v = chunk_stats[(cs, n)]
        cyc, steps = v.get("cycles", 0), v.get("steps", 0)
        per = cyc / steps if steps else 0.0
        lines.append(f"{cs:>10}{n:>13}{steps:>8}{cyc:>14}{per:>13.1f}")
    return "\n".join(lines)


def engine_request_table(requests) -> str:
    """Per-request phase attribution rows for finished engine requests.

    Each request carries exact integer cycle deltas per phase (prefill
    and cache-scatter run exclusively at batch 1; decode cycles are the
    shared batched-step totals the request participated in, shown with
    the mean batch size so a fair per-request share can be read off).
    """
    lines = [f"{'req':>5}{'prompt':>8}{'new':>6}{'prefill':>12}"
             f"{'cache':>10}{'decode(shared)':>16}{'avg B':>7}"
             f"{'shared pages':>14}"]
    for r in requests:
        nd = len(r.decode_batches)
        avg_b = sum(r.decode_batches) / nd if nd else 0.0
        lines.append(
            f"{r.rid:>5}{len(r.prompt):>8}{len(r.out_tokens):>6}"
            f"{r.phase_cycles.get('prefill', 0):>12}"
            f"{r.phase_cycles.get('cache', 0):>10}"
            f"{r.phase_cycles.get('decode', 0):>16}{avg_b:>7.2f}"
            f"{r.shared_pages:>14}")
    return "\n".join(lines)


# ------------------------------------------------- telemetry sentinel

def telemetry_alert_table(events) -> str:
    """Fired :class:`~repro_torch.telemetry.sentinel.DriftEvent` rows, most
    recent last — the on-exit summary serve/train print when a drift
    sentinel ran (``--status-port``)."""
    if not events:
        return "# sentinel: no drift events"
    lines = [f"{'window':>7}  {'kind':<16}{'stream':<18}{'probe':<22}"
             f"{'dev':>4}{'severity':>10}{'trip':>7}"]
    for e in events:
        dev = "-" if e.device is None else str(e.device)
        lines.append(f"{e.window:>7}  {e.kind:<16}{e.stream:<18}"
                     f"{e.path:<22}{dev:>4}{e.severity:>10.3f}"
                     f"{e.threshold:>7.2f}")
    return "\n".join(lines)


def sentinel_table(sentinel) -> str:
    """Per-(stream, probe) detector state of a live
    :class:`~repro_torch.telemetry.sentinel.DriftSentinel`: warmup progress,
    reference sample count, and current consecutive-breach counters."""
    rows = sorted(sentinel._rows.items())
    if not rows:
        return "# sentinel: no windows observed yet"
    warm = sentinel.cfg.warmup_windows
    lines = [f"{'stream':<18}{'row':>5}{'windows':>9}{'ref_n':>8}"
             f"{'state':<10}{'breaches':<24}"]
    for (stream, row), st in rows:
        state = "warmup" if st.windows_seen < warm else "armed"
        br = ",".join(f"{k}:{v}" for k, v in st.breaches.items() if v)
        lines.append(f"{stream:<18}{row:>5}{st.windows_seen:>9}"
                     f"{st.ref_count:>8}  {state:<10}{br or '-':<24}")
    lines.append(f"# {len(sentinel.events)} event(s) fired")
    return "\n".join(lines)


def dse_leaderboard(result, top: int = 10) -> str:
    """Ranked table for a ``dse.TuneResult`` (port of the JAX report's):
    measured candidates by probed cycles/step (speedup vs the untuned
    default), then the statically pruned ones with their rejection
    reason. ``smem_B`` is a CTA's shared memory, dynamic and static, in
    place of the TPU's VMEM bytes."""
    def cfg_s(cfg):
        return ",".join(f"{k}={v}" for k, v in sorted(cfg.items()))

    def smem(t):
        r = t.resources
        return (r.smem_bytes + r.static_smem_bytes) if r else 0

    measured = sorted((t for t in result.trials if t.measured),
                      key=lambda t: t.cycles_per_step)
    pruned = [t for t in result.trials if t.pruned is not None]
    base = (result.default.cycles_per_step
            if result.default is not None and result.default.measured
            else None)
    w = max([len(cfg_s(t.config)) for t in result.trials] + [6]) + 2
    lines = [f"# DSE leaderboard: {result.kernel_id} on {result.device} — "
             f"{result.n_candidates} candidates, {result.n_pruned} pruned, "
             f"{result.n_measurements} measured "
             f"({result.measured_steps} probed steps), "
             f"{result.n_cache_hits} cache hits",
             f"{'config':<{w}}{'cyc/step':>12}{'steps':>7}{'speedup':>9}"
             f"{'smem_B':>9}  flags"]
    for t in measured[:top]:
        su = f"{base / t.cycles_per_step:8.2f}x" if base else f"{'-':>9}"
        flags = []
        if result.best is t:
            flags.append("BEST")
        if t.is_default:
            flags.append("default")
        if t.cache_hits:
            flags.append("cached")
        lines.append(
            f"{cfg_s(t.config):<{w}}{t.cycles_per_step:>12.1f}"
            f"{t.steps:>7}{su}{smem(t):>9}  {' '.join(flags)}")
    for t in pruned[:top]:
        lines.append(f"{cfg_s(t.config):<{w}}{'pruned':>12}{'':>7}{'':>9}"
                     f"{smem(t):>9}  [{t.pruned}]")
    return "\n".join(lines)
