"""Probe-state transitions: a CUDA kernel for Hopper and its plain
PyTorch version.

The port's counterpart of the TPU path's ``emit_events`` and
``CycleSource`` (``src/repro/core/instrument.py``): one call applies one
scope transition's exits and enters to the int64 probe state of
``core.instrument`` (``cycle`` (), ``cnt`` (3, n), ``calls`` (n,),
``ring`` (n, depth, 2)); the CUDA source is
``src/repro_torch/csrc/probe_events.cu``, which states the semantics.
An event is coded ``pid << 2 | enter << 1 | spill`` (``encode``).

In model mode "now" is the clock plus ``seg``; in wallclock mode the
kernel reads the SM's ``%globaltimer`` (ns) in stream order, and the
plain version ``time.perf_counter_ns()``, as the JAX package reads the
host clock. CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``launches`` counts calls that launched it.

``probe_grid`` is the second kernel: the fold of a probed kernel call's
grid steps (``core.kernelprobe``). One launch applies, for every step of
a ``GridPlan`` in the TPU kernel's order, what a chain of
``probe_events`` transitions would: the grid probe's enter, the step's
transfer cycles, each inner scope's enter, cycles and exit, the grid
probe's exit; the step's cycles come from the plan's cost tables and the
kernel's counter block. A spilling probe's full ring rows go to a device
block, in window order, which the run copies to the host once. The
plain version computes the same by prefix sums (``probe_grid_plain``).
"""
from __future__ import annotations

import ctypes
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_EVENTS = 64
STARTS, TOTALS, ENDS = 0, 1, 2

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe_events": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P, _I,
                     _I, _P],
    "globaltimer_steps": [_P, _I, _I, _P],
    "probe_grid": [_P, _P, _P, _P, _I, _I, _P, ctypes.c_longlong,
                   ctypes.c_longlong, _I, ctypes.c_longlong, _I, _P, _P, _P,
                   _P, _P, _P, _P, _P, _I, _I, _P],
}
MAX_GRID_IDS = 8           # the grid node and up to seven inner scopes
MAX_TABLE = 320            # cost-table entries of one plan, all scopes


def encode(pid: int, enter: bool, spill: bool) -> int:
    return (pid << 2) | (int(enter) << 1) | int(spill)


def probe_events_plain(state, codes: Sequence[int], seg: int = 0,
                       wallclock: bool = False) -> None:
    """The same updates with PyTorch indexing, event by event (reads the
    clock and the call counts on the host)."""
    cnt, calls, ring = state["cnt"], state["calls"], state["ring"]
    depth = ring.shape[1]
    now = (time.perf_counter_ns() if wallclock
           else int(state["cycle"]) + int(seg))
    state["cycle"].fill_(now)
    for code in codes:
        p, enter, spill = code >> 2, (code >> 1) & 1, code & 1
        c = int(calls[p])
        slot = c % depth if spill else min(c, depth - 1)
        write = spill or c < depth
        if enter:
            if c == 0:
                cnt[STARTS, p] = now
            cnt[TOTALS, p] -= now
            if write:
                ring[p, slot, 0] = now
        else:
            cnt[TOTALS, p] += now
            cnt[ENDS, p] = now
            if write:
                ring[p, slot, 1] = now
            calls[p] = c + 1


def _check(state):
    for name in ("cycle", "cnt", "calls", "ring"):
        t = state[name]
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"state[{name!r}] must be contiguous int64")
    dev = state["cycle"].device
    if any(state[k].device != dev for k in ("cnt", "calls", "ring")):
        raise ValueError("the state's tensors lie on different devices")


class Launcher:
    """``probe_events`` bound to one state: the checks, pointers, sizes,
    device and stream are taken once, so a launch costs one ctypes call
    (the instrumented run launches once a transition). Launches go on
    the stream that was current when the launcher was made."""

    def __init__(self, state):
        _check(state)
        self.state = state
        self.n, self.depth = state["ring"].shape[:2]
        cycle = state["cycle"]
        self.cpu = cycle.device.type == "cpu"
        if self.cpu:
            return
        if cycle.device.type != "cuda":
            raise ValueError(f"no probe-events kernel for {cycle.device}")
        self.lib = _build.load("probe_events", _SIGNATURES)
        self.args = (cycle.data_ptr(), state["cnt"].data_ptr(),
                     state["calls"].data_ptr(), state["ring"].data_ptr(),
                     self.n, self.depth)
        self.where = (cycle.device.index,
                      torch.cuda.current_stream(cycle.device).cuda_stream)

    def __call__(self, codes: Sequence[int], seg: int = 0,
                 wallclock: bool = False) -> None:
        """Apply the coded events, in order, at one "now"."""
        if len(codes) > MAX_EVENTS:
            raise ValueError(f"{len(codes)} events in one transition > "
                             f"{MAX_EVENTS}")
        if any(c < 0 or (c >> 2) >= self.n for c in codes):
            raise ValueError(f"probe id out of range for {self.n} probes")
        if self.cpu:
            return probe_events_plain(self.state, codes, seg, wallclock)
        arr = (ctypes.c_int * max(len(codes), 1))(*codes)
        code = self.lib.probe_events(*self.args, int(wallclock), int(seg),
                                     arr, len(codes), *self.where)
        if code:
            _build.check(self.lib, code, "probe_events")
        probe_events.launches += 1


def probe_events(state, codes: Sequence[int], seg: int = 0,
                 wallclock: bool = False) -> None:
    """Apply the coded events, in order, at one "now". ``launches``
    counts calls that launched the kernel (here or by a ``Launcher``)."""
    Launcher(state)(codes, seg, wallclock)


probe_events.launches = 0


def _grid_spans(plan, counters, t0: int):
    """Every step's (enter, exit) per id (grid first, then the scopes in
    body order), by prefix sums: two (ids, steps) int64 arrays."""
    cyc = plan.step_cycles(counters)                      # (steps, n)
    dur = plan.transfer + cyc.sum(axis=1)
    end = t0 + np.cumsum(dur)
    start = end - dur
    inner = start[:, None] + plan.transfer + np.cumsum(cyc, axis=1) - cyc
    enters = np.concatenate([start[None], inner.T])
    exits = np.concatenate([end[None], (inner + cyc).T])
    return enters, exits


def grid_dump_rows(calls: Sequence[int], ids: Sequence[int],
                   spill: Sequence[bool], steps: int, depth: int):
    """The full ring rows a fold writes, in block order: (probe id,
    base call count) per row, and each id's first row in the block
    (-1 for an id that writes none). ``calls`` holds the calls before
    the fold of each id's probe."""
    rows, offs = [], []
    for pid, sp in zip(ids, spill):
        if pid < 0 or not sp:
            offs.append(-1)
            continue
        c0 = int(calls[pid])
        offs.append(len(rows))
        rows += [(pid, w * depth)
                 for w in range(c0 // depth, (c0 + steps) // depth)]
    return rows, offs


def probe_grid_plain(state, plan, counters, ids: Sequence[int],
                     spill: Sequence[bool], dump=None,
                     dump_offsets: Sequence[int] = ()) -> None:
    """The fold in plain PyTorch and numpy (reads the state on the host).
    ``ids``: probe id of the grid node, then of each inner scope (-1 for
    one that is not probed); ``dump`` (rows, depth, 2) int64 takes each
    spilling id's full ring rows from row ``dump_offsets[k]`` on."""
    cnt, calls, ring = state["cnt"], state["calls"], state["ring"]
    depth, steps = ring.shape[1], plan.steps
    t0 = int(state["cycle"])
    enters, exits = _grid_spans(plan, np.asarray(counters), t0)

    def t(a):                             # numpy -> the state's device
        return torch.from_numpy(np.asarray(a)).to(ring.device)
    for k, pid in enumerate(ids):
        if pid < 0:
            continue
        c0 = int(calls[pid])
        e, x = enters[k], exits[k]
        if c0 == 0:
            cnt[STARTS, pid] = int(e[0])
        cnt[ENDS, pid] = int(x[-1])
        cnt[TOTALS, pid] += int((x - e).sum())
        calls[pid] = c0 + steps
        n = c0 + np.arange(steps)
        spans = np.stack([e, x], axis=1)
        if not spill[k]:
            keep = n < depth
            ring[pid, t(n[keep])] = t(spans[keep])
            continue
        end = c0 + steps
        full = (n // depth + 1) * depth <= end
        off = dump_offsets[k] if dump is not None and dump_offsets else -1
        if off >= 0 and c0 % depth and (c0 // depth + 1) * depth <= end:
            dump[off, :c0 % depth] = ring[pid, :c0 % depth]
        if off >= 0 and full.any():
            dump[t(off + n[full] // depth - c0 // depth),
                 t(n[full] % depth)] = t(spans[full])
        last = n + depth >= end
        ring[pid, t(n[last] % depth)] = t(spans[last])
    state["cycle"].fill_(int(exits[0][-1]))


def _grid_args(plan, ids, spill, dump_offsets):
    n = len(plan.scopes)
    if n + 1 > MAX_GRID_IDS or len(ids) != n + 1 or len(spill) != n + 1:
        raise ValueError(f"{plan.body}: {n} inner scopes; want one id and "
                         f"spill flag each for the grid node and them "
                         f"(at most {MAX_GRID_IDS})")
    table = [c for sc in plan.scopes for c in sc.table]
    if len(table) > MAX_TABLE:
        raise ValueError(f"{plan.body}: {len(table)} cost-table entries > "
                         f"{MAX_TABLE}")
    offs = list(dump_offsets) or [-1] * (n + 1)

    def ints(xs):
        return (ctypes.c_int * len(xs))(*[int(x) for x in xs])
    return (n, ints([sc.rule for sc in plan.scopes]),
            ints([len(sc.table) for sc in plan.scopes]),
            (ctypes.c_longlong * max(len(table), 1))(*table),
            ints(plan.geom), ints(ids), ints([int(bool(s)) for s in spill]),
            ints(offs))


def probe_grid(state, plan, counters, ids: Sequence[int],
               spill: Sequence[bool], dump=None,
               dump_offsets: Sequence[int] = ()) -> None:
    """Fold a kernel call's grid steps into the state (see the module
    docstring and ``probe_grid_plain``). ``counters`` is the kernel's
    counter block (int32, the plan's ``counter_shape``), on the state's
    device. CPU states take the plain version; CUDA states launch the
    kernel or raise. ``launches`` counts calls that launched it."""
    _check(state)
    n_probes, depth = state["ring"].shape[:2]
    if any(i >= n_probes for i in ids):
        raise ValueError(f"probe id out of range for {n_probes} probes")
    if tuple(counters.shape) != tuple(plan.counter_shape):
        raise ValueError(f"{plan.body}: counter block "
                         f"{tuple(counters.shape)} does not match the "
                         f"plan's {tuple(plan.counter_shape)}")
    cycle = state["cycle"]
    if cycle.device.type == "cpu":
        return probe_grid_plain(state, plan, counters.numpy(), ids, spill,
                                dump, dump_offsets)
    if cycle.device.type != "cuda":
        raise ValueError(f"no probe-grid kernel for {cycle.device}")
    if (counters.device != cycle.device or counters.dtype != torch.int32
            or not counters.is_contiguous()):
        raise ValueError("the counter block must be contiguous int32 on "
                         "the state's device")
    if dump is not None and (dump.device != cycle.device
                             or dump.dtype != torch.int64
                             or not dump.is_contiguous()):
        raise ValueError("the dump block must be contiguous int64 on the "
                         "state's device")
    args = _grid_args(plan, ids, spill, dump_offsets)
    lib = _build.load("probe_events", _SIGNATURES)
    code = lib.probe_grid(
        cycle.data_ptr(), state["cnt"].data_ptr(), state["calls"].data_ptr(),
        state["ring"].data_ptr(), n_probes, depth, counters.data_ptr(),
        counters.numel(), plan.steps, plan.grid[-1], plan.transfer, *args,
        dump.data_ptr() if dump is not None else None,
        0 if dump is None else dump.shape[0], cycle.device.index,
        torch.cuda.current_stream(cycle.device).cuda_stream)
    _build.check(lib, code, "probe_grid")
    probe_grid.launches += 1


probe_grid.launches = 0


def globaltimer_steps(device, n: int = 4096) -> torch.Tensor:
    """The first ``n`` steps (ns) of ``%globaltimer`` seen by one thread
    spinning on it: its resolution on this card."""
    device = torch.device(device)
    out = torch.empty(n, dtype=torch.int64, device=device)
    lib = _build.load("probe_events", _SIGNATURES)
    code = lib.globaltimer_steps(
        out.data_ptr(), n, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, "globaltimer_steps")
    return out.cpu()
