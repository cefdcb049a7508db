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
caches are left as they were.

A kernel region with a grid plan whose body the oracle's
``kernel_probes`` match is replayed step by step with Python integers
(``core.kernelprobe``): the same transitions as the fold, with each
step's cycles from the plan and the counts its *inputs* imply
(``GridPlan.expected``), never from the kernel's counter block, so
device record == oracle also checks that the kernel skipped what the
plan says. ``KernelOracle`` adds the grid-totals helper.

``copies`` counts the device-to-host copies of spilled ring rows that
the run's rule implies: one a filled ring of a spilled probe, and one a
kernel call in whose grid a spilled probe fills a ring (its rows go out
in one block). ``core.overhead`` holds the instrumented run's copies to
it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import costmodel as cm
from repro_torch.core import kernelprobe as kp
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
    copies: int = 0

    def __post_init__(self):
        z = [0] * self.n
        self.starts, self.ends, self.totals = list(z), list(z), list(z)
        self.last, self.calls = list(z), list(z)
        self.ring = [[(0, 0)] * self.depth for _ in range(self.n)]
        self.history = [[] for _ in range(self.n)]


class Oracle(OpTracker):
    def __init__(self, assignment: ProbeAssignment,
                 kernel_probes: Sequence[str] = ()):
        super().__init__()
        self.asg = assignment
        self.kernel_probes = tuple(kernel_probes)
        self.st = OracleCounters(n=assignment.n, depth=assignment.depth)
        self._kpaths: Dict[int, str] = {}      # kernel site -> its path
        self._kindex: Dict[str, int] = {}      # parent path -> kernels
        self._in_grid = False                  # replaying a kernel's grid

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
        if spill and not self._in_grid and st.calls[pid] % depth == 0:
            st.copies += 1                     # a filled ring

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

    # -- kernel regions with a plan ----------------------------------------
    def kernel_enter(self, ev):
        plan = ev.plan()
        if not kp.matches(self.kernel_probes, plan.body):
            self.priced(ev.name, cm.kernel_cost(*ev.cost(), body=plan.body))
            return
        f = ev.parent
        kpath = self._kpaths.get(ev.sid)
        if kpath is None:
            i = self._kindex.get(f.path, 0)
            self._kindex[f.path] = i + 1
            kpath = self._kpaths[ev.sid] = kp.kernel_path(f.path, plan.body,
                                                          i)
        cur = f.entry.cur
        self._transition(cur, kpath)
        self.replay(plan, kpath)
        self._transition(kpath, cur)

    def replay(self, plan, kpath: str) -> None:
        """The grid's steps, one transition at a time, in the TPU
        kernel's order, from the counts the plan's inputs imply."""
        paths = kp.grid_paths(kpath, plan)
        gpath, inner = paths[0], paths[1:]
        cycles = plan.step_cycles(plan.expected()).tolist()
        st, depth = self.st, self.asg.depth
        spilled = [i for i in map(self.asg.id_of, paths)
                   if i is not None and self.asg.spill[i]]
        rings = [st.calls[i] // depth for i in spilled]
        self._in_grid = True
        for step in cycles:
            self._transition(kpath, gpath)
            st.cycle += plan.transfer
            cur = gpath
            for path, c in zip(inner, step):
                self._transition(cur, path)
                cur = path
                st.cycle += c
            self._transition(cur, gpath)
            self._transition(gpath, kpath)
        self._in_grid = False
        if [st.calls[i] // depth for i in spilled] != rings:
            st.copies += 1                     # the grid's filled rings


class KernelOracle(Oracle):
    """The oracle for kernel-level validation: the base class already
    replays every matched kernel region grid step by grid step; this
    one adds the grid totals, for the sum-of-grid-steps == kernel-scope
    check."""

    def grid_totals(self, counters: OracleCounters,
                    paths: Tuple[str, ...]) -> Dict[str, int]:
        """Per-grid-probe total cycles from a replay (paths ending in
        ``/grid``), keyed by path."""
        return {p: counters.totals[pid] for pid, p in enumerate(paths)
                if p.endswith("/" + kp.GRID_SEG)}
