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
"""
from __future__ import annotations

import ctypes
import time
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_EVENTS = 64
STARTS, TOTALS, ENDS = 0, 1, 2

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe_events": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P, _I,
                     _I, _P],
    "globaltimer_steps": [_P, _I, _I, _P],
}


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
