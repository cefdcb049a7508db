"""Non-intrusive instrumentation: the instrumented eager run.

Port of ``repro.core.instrument``. JAX re-evaluates the traced jaxpr
equation by equation and threads a probe state through it; here the
function simply runs again, eagerly, with the scope markers
(``core.scope``) live and NO dispatch hook, and at **scope transitions
only** (the paper's edge-triggered sampling) the host applies the exits
and enters to a device state with one ``kernels.probe_events`` launch:

    enter(p):  starts[p] (first call), totals[p] -= now, ring write
    exit(p):   ends[p] = now, totals[p] += now, ring write, calls[p] += 1

Between transitions the model clock advances by the executed segments'
cycles, taken from the capture's segment table (``core.hierarchy``),
keyed by (site, ordinal within the visit): loop iterations and taken
branches resolve to their own entries. The host sums them and passes the
sum with the next launch ("now" = clock + segment cycles), so a segment
costs no device work of its own. A run whose marker sequence leaves the
captured one raises before it writes anything for it: it never writes
counts that mean something else.

In ``cycle_source="wallclock"`` "now" is the device's ``%globaltimer``
(ns) read in stream order by the same kernel: on an asynchronous GPU the
host's clock times the launch, not the execution. On the CPU the plain
version reads ``time.perf_counter_ns()``, as the JAX package does.

The state is int64 tensors: ``cycle`` (), ``cnt`` (3, n) with the
STARTS / TOTALS / ENDS planes, ``calls`` (n,) and ``ring`` (n, depth, 2).
The JAX package builds 64-bit counters from uint32 (hi, lo) pairs
(``core/counters.py``) so that their width never depends on
``jax_enable_x64``; CUDA and PyTorch have native int64 adds, so the port
keeps plain int64 and has no counters module. As in the packed layout,
an enter subtracts "now" from TOTALS and the exit adds it back, so no
``last`` plane is needed.

A kernel region that the hierarchy probes (``core.kernelprobe``:
``ProbeConfig(kernel_probes=...)``) is handled where it starts: the run
flushes, moves to the kernel's path, asks the kernel for its counter
block, and folds the grid's steps into the state with one
``probe_grid`` launch, then moves back. The host's mirrors of the calls
and the model clock come from the plan (grid calls from the grid alone,
the cycles from the counts the inputs imply, held on the host where the
caller gives them), so a session needs no device read a step for them.
A region the hierarchy does not probe adds its flat cycles to the
segment, as before.

Outputs are untouched: the launches read and write only the state.
The host counts every probe's calls (it issues the events), so it knows
when a spilling probe's ring fills and queues a copy of the full row
into a pinned host block on the stream, right after that event; at the
end of the run the block goes to the ``HostSink`` (``core.buffer``) with
one CUDA event recorded after the last copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kernelprobe as kp
from repro_torch.core import scope as sc
from repro_torch.core.buffer import HostSink
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.kernels import probe_events as kpe

STARTS, TOTALS, ENDS = kpe.STARTS, kpe.TOTALS, kpe.ENDS
CYCLE_SOURCES = ("model", "wallclock")


def init_state(n_probes: int, depth: int, device=None) -> Dict[str, Any]:
    """A zeroed probe state on ``device`` (the GPU unless 'cpu' is asked)."""
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)
    return {"cycle": z(), "cnt": z(3, n_probes), "calls": z(n_probes),
            "ring": z(n_probes, depth, 2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decode_record(record: Dict[str, Any]) -> Dict[str, Any]:
    """Host-side view of a probe state: ``cycle`` (int),
    ``starts``/``ends``/``totals``/``calls`` (int64 arrays) and ``ring``
    (int64, (n, depth, 2) of (start, end) pairs), the keys of the JAX
    package's ``decode_record``."""
    cnt = _np(record["cnt"]).astype(np.int64)
    return {
        "cycle": int(_np(record["cycle"])),
        "starts": np.atleast_1d(cnt[STARTS].copy()),
        "ends": np.atleast_1d(cnt[ENDS].copy()),
        "totals": np.atleast_1d(cnt[TOTALS].copy()),
        "calls": np.atleast_1d(_np(record["calls"]).astype(np.int64)),
        "ring": _np(record["ring"]).astype(np.int64),
    }


def state_totals(state: Dict[str, Any]) -> np.ndarray:
    """Per-probe total cycles (int64) straight from a raw state: the
    cheap read sessions poll at window boundaries (a device read)."""
    return np.atleast_1d(_np(state["cnt"][TOTALS]).astype(np.int64))


def state_clock(state: Dict[str, Any]) -> int:
    """The state's clock (a device read). The port keeps one int64
    ``cycle``, where the JAX package joins a (hi, lo) uint32 pair."""
    return int(_np(state["cycle"]))


@dataclass
class ProbeAssignment:
    paths: Tuple[str, ...]                 # probe id -> scope path
    depth: int                             # ring depth per probe
    spill: Tuple[bool, ...]                # probe id -> DRAM offload enabled

    def __post_init__(self):
        self._ids = {p: i for i, p in enumerate(self.paths)}
        self._chains: Dict[str, Tuple[int, ...]] = {}

    @property
    def n(self) -> int:
        return len(self.paths)

    def id_of(self, path: str) -> Optional[int]:
        return self._ids.get(path)

    def chain(self, path: str) -> Tuple[int, ...]:
        """Probe ids active (outermost first) when executing at ``path``."""
        hit = self._chains.get(path)
        if hit is None:
            ids, cur = [], ""
            for s in (path.split("/") if path else []):
                cur = f"{cur}/{s}" if cur else s
                pid = self._ids.get(cur)
                if pid is not None:
                    ids.append(pid)
            hit = self._chains[path] = tuple(ids)
        return hit


class Runner(sc.Tracker):
    """One instrumented run: follows the markers against the capture and
    writes the state.

    ``calls`` is the host's copy of the state's call counts, a list the
    run keeps up to date (a ``ProbeSession`` owns its state and keeps
    one across steps); without it a run whose probes spill reads the
    counts from the device first, which waits for the device. ``cycles``
    counts the model-clock cycles the run adds to the state's clock, so
    an owner can keep the clock on the host too. ``rows_hint`` sizes the
    pinned block the spilled rows are copied into (the caller passes the
    last run's ``dumps``; the block grows if the run spills more)."""
    grow_sites = False

    def __init__(self, h: Hierarchy, asg: ProbeAssignment,
                 state: Dict[str, Any], cycle_source: str = "model",
                 sink: Optional[HostSink] = None,
                 calls: Optional[List[int]] = None, rows_hint: int = 0):
        if cycle_source not in CYCLE_SOURCES:
            raise ValueError(f"unknown cycle source {cycle_source!r}")
        super().__init__(h.sites)
        self.segs = h.segments
        self.kernels = h.kernels
        self.grid_cycles = h.grid_cycles
        self.asg = asg
        self.state = state
        self.wall = cycle_source == "wallclock"
        self.sink = sink
        self.launch = kpe.Launcher(state)
        self.pending = 0               # segment cycles not yet on the device
        self._ev: List[int] = []       # coded events of the next launch
        self.launches = 0
        self.folds = 0                 # probe_grid launches
        self.transitions = 0
        self.dumps = 0                 # spilled rows copied to the host
        self.copies = 0                # their copies (a fold's: one)
        self.cycles = 0                # model cycles added to the clock
        self.rows_hint = rows_hint
        self._blocks: List[torch.Tensor] = []     # spilled rows, in order
        self._fill = 0                            # rows in the last block
        self._spilled: Tuple[List[int], List[int]] = ([], [])
        # host copy of the call counts: the caller's, or, for spills,
        # one read of the device state (which waits for it)
        self.calls = calls
        if calls is None and any(asg.spill):
            self.calls = state["calls"].cpu().tolist()

    # -- events ------------------------------------------------------------
    def _flush(self) -> None:
        if self._ev or (self.pending and not self.wall):
            self.launch(self._ev, self.pending, self.wall)
            self.launches += 1
            if not self.wall:
                self.cycles += self.pending
        self._ev = []
        self.pending = 0

    def _enter(self, pid: int) -> None:
        self._ev.append(kpe.encode(pid, True, self.asg.spill[pid]))

    def _exit(self, pid: int) -> None:
        spill = self.asg.spill[pid]
        self._ev.append(kpe.encode(pid, False, spill))
        if self.calls is not None:
            self.calls[pid] += 1
            if spill and self.calls[pid] % self.asg.depth == 0:
                self._flush()
                self._dump(pid, self.calls[pid] - self.asg.depth)

    def _dump(self, pid: int, base: int) -> None:
        if self.sink is None:
            return
        row = self.state["ring"][pid]
        if not self._blocks or self._fill == len(self._blocks[-1]):
            n = max(self.rows_hint - self.dumps, 8)
            self._blocks.append(torch.empty(
                (n,) + tuple(row.shape), dtype=row.dtype,
                pin_memory=row.device.type == "cuda"))
            self._fill = 0
        self._blocks[-1][self._fill].copy_(row, non_blocking=True)
        self._fill += 1
        self._spilled[0].append(pid)
        self._spilled[1].append(base)
        self.dumps += 1
        self.copies += 1

    def _ship(self) -> None:
        """Hand the run's spilled rows to the sink, with one event after
        their copies."""
        if not self.dumps:
            return
        rows = self._blocks[:-1] + [self._blocks[-1][:self._fill]]
        ready = None
        if self.state["ring"].device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self.sink.dump(*self._spilled, rows, ready)

    def _fold(self, plan, counters, kpath: str) -> None:
        """One ``probe_grid`` launch for a probed kernel call, with the
        host's mirrors kept from the plan."""
        # the clock mirror, from the counts the host holds (no device read)
        counts = np.ascontiguousarray(plan.mirror(), np.int32)
        if counts.shape != tuple(plan.counter_shape):
            raise ValueError(f"{plan.body}: host counts {counts.shape}, the "
                             f"plan's {tuple(plan.counter_shape)}")
        raw = counts.tobytes()
        ids = [self.asg.id_of(p) for p in kp.grid_paths(kpath, plan)]
        ids = [-1 if i is None else i for i in ids]
        spill = [i >= 0 and self.asg.spill[i] for i in ids]
        dump, offs, rows = None, (), []
        if self.sink is not None and any(spill):
            rows, offs = kpe.grid_dump_rows(self.calls, ids, spill,
                                            plan.steps, self.asg.depth)
            if rows:
                dump = torch.zeros((len(rows), self.asg.depth, 2),
                                   dtype=torch.int64,
                                   device=self.state["ring"].device)
        kpe.probe_grid(self.state, plan, counters, ids, spill, dump, offs)
        self.folds += 1
        hit = self.grid_cycles.get(kpath)
        if hit is None or hit[0] != raw:
            hit = self.grid_cycles[kpath] = (raw, plan.cycles(counts))
        self.cycles += hit[1]
        if self.calls is not None:
            for i in ids:
                if i >= 0:
                    self.calls[i] += plan.steps
        if dump is not None:
            host = torch.empty(dump.shape, dtype=dump.dtype,
                               pin_memory=dump.device.type == "cuda")
            host.copy_(dump, non_blocking=True)
            if self._blocks:
                # the rows spilled so far end where they were filled: an
                # unfilled tail would ship as rows of later probes
                self._blocks[-1] = self._blocks[-1][:self._fill]
            self._blocks.append(host)
            self._fill = len(host)
            self._spilled[0].extend(pid for pid, _ in rows)
            self._spilled[1].extend(base for _, base in rows)
            self.dumps += len(rows)
            self.copies += 1

    def kernel(self, name, cost, plan=None):
        if self.in_kernel or plan is None:
            return sc._NULL          # priced in its segment
        return _RunKernel(self, name, plan)

    def _move(self, old: str, new: str) -> None:
        a, b = self.asg.chain(old), self.asg.chain(new)
        i = 0
        while i < len(a) and i < len(b) and a[i] == b[i]:
            i += 1
        if i < len(a) or i < len(b):
            self.transitions += 1
        for pid in reversed(a[i:]):
            self._exit(pid)
        for pid in b[i:]:
            self._enter(pid)

    # -- tracker hooks -------------------------------------------------------
    def _seg(self, f) -> Any:
        seg = self.segs.get((f.site, f.ord))
        if seg is None:
            raise RuntimeError(
                f"the run left the captured scope sequence at "
                f"{f.path or '/'} (segment {f.ord} was never captured)")
        return seg

    def seg_begin(self, f):
        seg = self._seg(f)
        if not f.transparent and seg.triggers and f.entry.cur != f.path:
            self._move(f.entry.cur, f.path)
            f.entry.cur = f.path
        if self._ev and (seg.n_ops or seg.cycles):
            self._flush()          # the events happen before these ops
        self.pending += seg.cycles

    def seg_end(self, f, nxt):
        want = self._seg(f).nxt
        if want != nxt:
            raise RuntimeError(
                f"the run left the captured scope sequence at "
                f"{f.path or '/'} (segment {f.ord}): captured {want}, "
                f"ran {nxt}")

    def frame_open(self, f):
        if f.loop_path is not None:
            pid = self.asg.id_of(f.loop_path)
            if pid is not None:
                self._enter(pid)

    def frame_close(self, f):
        if f.kind in ("iter", "body", "branch", "root"):
            self._move(f.cur, f.path)
            if f.loop_path is not None:
                pid = self.asg.id_of(f.loop_path)
                if pid is not None:
                    self._exit(pid)
        if f.kind == "root":
            self._flush()
            self._ship()

    def stats(self) -> Dict[str, int]:
        return dict(transitions=self.transitions, launches=self.launches,
                    folds=self.folds, dumps=self.dumps, copies=self.copies,
                    cycles=self.cycles)


class _RunKernel:
    """A kernel region with a plan in the instrumented run: its flat
    cycles where the hierarchy does not probe it; else the move to its
    path, the counter block asked for (``probed``), the fold, and the
    move back. A probed region whose wrapper hands no counter block to
    ``fold`` raises."""

    def __init__(self, rec: Runner, name: str, plan):
        self.rec, self.name, self.plan_fn = rec, name, plan
        self.probed = self.folded = False

    def __enter__(self):
        rec = self.rec
        self.parent, sid = rec.kernel_event(self.name)
        ks = self.ks = rec.kernels.get(sid)
        if ks is None:
            raise RuntimeError(f"the run left the captured scope sequence: "
                               f"kernel {self.name} at "
                               f"{self.parent.path or '/'} was never "
                               f"captured")
        if ks.path is None:
            if rec._ev:
                rec._flush()
            rec.pending += ks.flat
        else:
            if rec.wall:
                raise ValueError("kernel probes require cycle_source="
                                 "'model': grid steps inside one kernel "
                                 "launch have no timestamps of their own")
            self.plan = self.plan_fn()
            if self.plan.signature() != ks.plan:
                raise RuntimeError(
                    f"kernel {self.plan.body} at {ks.path} declares "
                    f"{self.plan.signature()}, the capture {ks.plan}")
            self.cur = self.parent.entry.cur
            rec._move(self.cur, ks.path)
            rec._flush()
            self.probed = True
        rec.in_kernel = True
        return self

    def fold(self, counters) -> None:
        if not self.probed:
            return
        if self.folded:
            raise RuntimeError(f"kernel {self.plan.body}: a second counter "
                               f"block for one call")
        self.rec._fold(self.plan, counters, self.ks.path)
        self.folded = True

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        rec.in_kernel = False
        if exc_type is not None:
            return False
        if self.probed:
            if not self.folded:
                raise RuntimeError(
                    f"kernel {self.plan.body} at {self.ks.path} was asked "
                    f"for its counter block and handed none to the fold")
            rec._move(self.ks.path, self.cur)
        rec.kernel_done(self.parent)
        return False
