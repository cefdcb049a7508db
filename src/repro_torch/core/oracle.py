"""Independent oracle — the paper's ILA cross-check.

Port of ``repro.core.oracle``. It runs the function once more under a
pricing dispatch mode of its own and keeps every counter as a host
Python int. It prices each aten operation live (``core.costmodel``),
tracks the scope stack itself (its own site table: it grows one, as a
capture does) and applies the JAX package's transition rule operation by
operation: an operation at a path other than the current one first
exits and enters the probes in between. It does NOT read the capture's
segment table or the device state, so device counters == oracle is a
check of the capture, the segment bookkeeping and the kernel, as the
JAX ``Oracle`` re-evaluates the jaxpr. ``run`` executes the function;
as in a capture, its in-place writes to tensors it did not create are
undone when the run ends (``hierarchy._WriteGuard``), so the caller's
caches are left as they were. ``KernelOracle`` (grid-step replay) is
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from repro_torch.core.hierarchy import OpTracker
from repro_torch.core.instrument import ProbeAssignment


@dataclass
class OracleCounters:
    n: int
    depth: int
    cycle: int = 0
    starts: List[int] = field(default_factory=list)
    ends: List[int] = field(default_factory=list)
    totals: List[int] = field(default_factory=list)
    last: List[int] = field(default_factory=list)
    calls: List[int] = field(default_factory=list)
    ring: List[List[Tuple[int, int]]] = field(default_factory=list)
    history: List[List[Tuple[int, int]]] = field(default_factory=list)

    def __post_init__(self):
        z = [0] * self.n
        self.starts, self.ends, self.totals = list(z), list(z), list(z)
        self.last, self.calls = list(z), list(z)
        self.ring = [[(0, 0)] * self.depth for _ in range(self.n)]
        self.history = [[] for _ in range(self.n)]


class Oracle(OpTracker):
    def __init__(self, assignment: ProbeAssignment):
        super().__init__()
        self.asg = assignment
        self.st = OracleCounters(n=assignment.n, depth=assignment.depth)

    def run(self, fn, *args, **kwargs) -> OracleCounters:
        with self:
            fn(*args, **kwargs)
        return self.st

    # -- events ------------------------------------------------------------
    def _enter(self, pid: int):
        st, t, depth = self.st, self.st.cycle, self.asg.depth
        spill = self.asg.spill[pid]
        if st.calls[pid] == 0:
            st.starts[pid] = t
        st.last[pid] = t
        slot = st.calls[pid] % depth if spill else min(st.calls[pid],
                                                        depth - 1)
        if spill or st.calls[pid] < depth:
            st.ring[pid][slot] = (t, st.ring[pid][slot][1])
        st.history[pid].append((t, -1))

    def _exit(self, pid: int):
        st, t, depth = self.st, self.st.cycle, self.asg.depth
        spill = self.asg.spill[pid]
        st.ends[pid] = t
        st.totals[pid] += t - st.last[pid]
        slot = st.calls[pid] % depth if spill else min(st.calls[pid],
                                                        depth - 1)
        if spill or st.calls[pid] < depth:
            st.ring[pid][slot] = (st.ring[pid][slot][0], t)
        st.history[pid][-1] = (st.history[pid][-1][0], t)
        st.calls[pid] += 1

    def _transition(self, old: str, new: str):
        a, b = self.asg.chain(old), self.asg.chain(new)
        i = 0
        while i < len(a) and i < len(b) and a[i] == b[i]:
            i += 1
        for pid in reversed(a[i:]):
            self._exit(pid)
        for pid in b[i:]:
            self._enter(pid)

    def _at(self, f):
        """An operation runs at frame ``f``'s path."""
        if not f.transparent and f.entry.cur != f.path:
            self._transition(f.entry.cur, f.path)
            f.entry.cur = f.path

    # -- tracker hooks -------------------------------------------------------
    def priced(self, name, cost):
        self._at(self.top)
        self.st.cycle += cost.cycles

    def trigger(self, f):
        self._at(f)

    def frame_open(self, f):
        if f.loop_path is not None:
            pid = self.asg.id_of(f.loop_path)
            if pid is not None:
                self._enter(pid)

    def frame_close(self, f):
        if f.kind in ("iter", "body", "branch", "root"):
            self._transition(f.cur, f.path)
            if f.loop_path is not None:
                pid = self.asg.id_of(f.loop_path)
                if pid is not None:
                    self._exit(pid)
