"""Result collection + visualization (paper stage 5, Fig 4 / Fig 14).

Port of ``repro.core.report`` (the one-shot views; the streaming, mesh,
kernel-grid and engine tables come with their modules). Builds per-probe
rows (calls, total cycles, start/end, first-N iteration spans) from the
decoded device record, merges offloaded history from the host sink, and
renders a table, an ASCII execution timeline (the Fig 4 waveform) and a
bottleneck bump chart (the Fig 14 ranking-shift view).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

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
