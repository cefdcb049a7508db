"""Trace-once cycle simulator: capture a candidate ONCE, price it any
time with no run and no device.

Port of ``repro.core.tracesim``. LightningSim and the Rapid
Cycle-Accurate Simulator (PAPERS.md) split *trace capture* from *cycle
evaluation* so new configurations re-price without re-running the
design. The JAX package walks a traced jaxpr; a CUDA kernel has no body
to walk, so here :func:`capture_entry` runs one bound candidate once
under a live-pricing tracker (``core.hierarchy.OpTracker``, its in-place
writes undone) and records:

- ``base_cycles``: the model-clock cycles of every operation outside the
  kernels, as the capture and the oracle price them;
- one :class:`KernelSite` per distinct kernel call (body, grid plan
  signature), with its count: the grid (``GridPlan``), the
  per-step transfer term, the call's uncalibrated flat cycles (the
  region's roofline term) and, with ``walk``, the grid's cycles for the
  counts the inputs imply (``GridPlan.cycles(GridPlan.expected())``).

:func:`price` replays that arithmetic, honouring the process-global
``set_kernel_calibration`` state at pricing time, in two modes that
match the two live clocks:

``mode="sim"``
    each site's walked grid: integer-equal to the kernel-probed run's
    model clock (``ProbeConfig(kernel_probes=("*",))`` span) of the same
    call, since the oracle replays the same plan from the same inputs;
    calibration-free.

``mode="flat"``
    each site's flat cycles under the current calibration:
    integer-equal to ``DSEEngine._measure`` under the model clock (a
    ``ProbeSession``'s span a step), so a sweep filters candidates on
    the clock its finalists are measured on.

A capture prices what ran: for a program with data-dependent control
flow (``scope.cond``/``while_loop``) the price holds for the captured
inputs. ``TraceStore`` persists artifacts next to the
:class:`~repro_torch.core.incremental.EvalCache`
(``<cache>/traces/``), one JSON per (kernel, shape, space fingerprint):
a kernel edit changes the fingerprint and invalidates the stale file,
with the same ``FileLock`` read-merge-write discipline as the cache.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core.hierarchy import OpTracker
from repro_torch.core.incremental import FileLock, capture_fingerprint

TRACE_VERSION = 1


# ----------------------------------------------------------- artifacts

@dataclass(frozen=True)
class KernelSite:
    """One distinct kernel call in the captured run. ``count`` is how
    often it ran; ``flat`` its uncalibrated flat cycles a call;
    ``walked`` its grid's cycles a call for the captured inputs (None
    when the capture ran with ``walk=False``)."""
    kernel: str                   # the plan's body name ('flash_kernel')
    grid: Tuple[int, ...]
    steps: int                    # grid-step product
    count: int
    dma: int                      # the plan's transfer cycles a step
    flat: int
    walked: Optional[int] = None

    def cycles(self, mode: str) -> int:
        if mode == "sim" and self.walked is not None:
            return self.count * self.walked
        return self.count * cm.flat_kernel_cycles(self.kernel, self.flat)


@dataclass
class TraceEntry:
    """The captured run of ONE (config, shape) candidate: the flat
    cycles of everything outside the kernels, plus the kernel sites,
    which re-price against the calibration current at :func:`price`
    time. ``smem_bytes`` ... ``grid_steps`` are the candidate's declared
    resources (``SearchSpace.resources``), for budget pruning."""
    config: Dict[str, Any]
    fingerprint: str              # the capture fingerprint (cache key)
    base_cycles: int
    sites: List[KernelSite] = field(default_factory=list)
    exact: bool = True            # sim price == live replay for its inputs
    walked: bool = True           # sites carry grid totals?
    smem_bytes: int = 0
    static_smem_bytes: int = 0
    threads: int = 0
    registers: int = 0
    hbm_bytes: int = 0
    flops: int = 0
    grid_steps: int = 0


@dataclass
class KernelTrace:
    """All captured entries for one (kernel, shape), keyed by canonical
    config JSON. ``space_fingerprint`` is the default config's capture
    fingerprint: any edit to a kernel source changes it, so a persisted
    trace can never silently price a stale schedule."""
    kernel_id: str
    shape: str
    space_fingerprint: str = ""
    entries: Dict[str, TraceEntry] = field(default_factory=dict)
    version: int = TRACE_VERSION


def config_key(config: Dict[str, Any]) -> str:
    return json.dumps(config, sort_keys=True, separators=(",", ":"))


def shape_signature(args: Sequence[Any]) -> str:
    """Canonical (shape, dtype) signature of example inputs."""
    leaves = [[list(t.shape), str(t.dtype)]
              for t in torch.utils._pytree.tree_leaves(args)
              if isinstance(t, torch.Tensor)]
    return json.dumps(leaves, separators=(",", ":"))


# ------------------------------------------------------------- capture

class _Recorder(OpTracker):
    """Live pricing of one run: operations into ``base``, kernel calls
    into sites."""

    def __init__(self, walk: bool):
        super().__init__()
        self.walk = walk
        self.base = 0
        self.calls: Dict[Any, List[Any]] = {}

    def priced(self, name, cost):
        self.base += cost.cycles

    def kernel_enter(self, ev):
        plan = ev.plan()
        flops, nbytes = ev.cost()
        flat = cm.roofline_cycles(int(flops), int(nbytes))
        walked = plan.cycles(plan.expected()) if self.walk else None
        key = (plan.signature(), flat, walked)
        if key in self.calls:
            self.calls[key][1] += 1
        else:
            self.calls[key] = [plan, 1, flat, walked]


def capture_run(fn, args, *, config: Optional[Dict[str, Any]] = None,
                walk: bool = True) -> TraceEntry:
    """Capture a trace entry from one run of ``fn(*args)``."""
    rec = _Recorder(walk)
    with rec:
        fn(*args)
    entry = TraceEntry(config=dict(config or {}),
                       fingerprint=capture_fingerprint(fn, args),
                       base_cycles=rec.base, walked=walk)
    for plan, count, flat, walked in rec.calls.values():
        entry.sites.append(KernelSite(
            kernel=plan.body, grid=tuple(plan.grid), steps=plan.steps,
            count=count, dma=plan.transfer, flat=flat, walked=walked))
    return entry


def capture_entry(space, config: Dict[str, Any], *,
                  walk: bool = True) -> TraceEntry:
    """Run ONE candidate of a ``SearchSpace`` and capture it (the only
    step that runs anything; everything downstream is arithmetic)."""
    entry = capture_run(space.bind(config), space.args, config=config,
                        walk=walk)
    if space.resources is not None:
        r = space.resources(config)
        entry.smem_bytes, entry.static_smem_bytes = (r.smem_bytes,
                                                     r.static_smem_bytes)
        entry.threads, entry.registers = r.threads, r.registers
        entry.hbm_bytes, entry.flops = r.hbm_bytes, r.flops
        entry.grid_steps = r.grid_steps
    return entry


def capture(space, configs: Optional[Sequence[Dict[str, Any]]] = None, *,
            walk: bool = True,
            space_fingerprint: str = "") -> KernelTrace:
    """Capture a :class:`KernelTrace` over ``configs`` (default: every
    valid candidate of the space)."""
    trace = KernelTrace(kernel_id=space.kernel_id,
                        shape=shape_signature(space.args),
                        space_fingerprint=space_fingerprint)
    for cfg in (space.candidates() if configs is None else configs):
        trace.entries[config_key(cfg)] = capture_entry(space, cfg, walk=walk)
    return trace


def space_fingerprint(space) -> str:
    """Capture fingerprint of the space's DEFAULT config: the staleness
    key for persisted traces (any kernel-source edit changes it)."""
    return capture_fingerprint(space.bind(space.default), space.args)


# ------------------------------------------------------------- pricing

def price(trace: Union[KernelTrace, TraceEntry],
          config: Optional[Dict[str, Any]] = None, *,
          mode: str = "sim") -> int:
    """Cycles of one captured candidate: pure arithmetic, re-evaluated
    against the CURRENT kernel calibration (flat site term). See the
    module docstring for the two modes."""
    if mode not in ("sim", "flat"):
        raise ValueError(f"price mode must be 'sim' or 'flat', got {mode!r}")
    if isinstance(trace, KernelTrace):
        if config is None:
            raise ValueError("price(trace, config): config required when "
                             "pricing a KernelTrace")
        key = config_key(config)
        entry = trace.entries.get(key)
        if entry is None:
            raise KeyError(
                f"config {key} not captured in trace of "
                f"{trace.kernel_id} ({len(trace.entries)} entries)")
    else:
        entry = trace
    return int(entry.base_cycles + sum(s.cycles(mode) for s in entry.sites))


def entry_resources(entry: TraceEntry) -> cm.KernelResources:
    """The candidate's footprint for ``DeviceBudget`` pruning, rebuilt
    from the artifact (``static_cycles`` is the kernel sites' flat term
    under the current calibration)."""
    static = sum(s.count * cm.flat_kernel_cycles(s.kernel, s.flat)
                 for s in entry.sites)
    return cm.KernelResources(
        smem_bytes=entry.smem_bytes,
        static_smem_bytes=entry.static_smem_bytes, threads=entry.threads,
        registers=entry.registers, hbm_bytes=entry.hbm_bytes,
        flops=entry.flops, grid_steps=entry.grid_steps,
        static_cycles=static)


# ------------------------------------------------------- serialization

_RES = ("smem_bytes", "static_smem_bytes", "threads", "registers",
        "hbm_bytes", "flops", "grid_steps")


def entry_to_dict(e: TraceEntry) -> Dict[str, Any]:
    d = {"config": e.config, "fingerprint": e.fingerprint,
         "base_cycles": e.base_cycles, "exact": e.exact, "walked": e.walked,
         "sites": [{"kernel": s.kernel, "grid": list(s.grid),
                    "steps": s.steps, "count": s.count, "dma": s.dma,
                    "flat": s.flat, "walked": s.walked} for s in e.sites]}
    d.update({k: getattr(e, k) for k in _RES})
    return d


def entry_from_dict(d: Dict[str, Any]) -> TraceEntry:
    return TraceEntry(
        config=dict(d["config"]), fingerprint=d["fingerprint"],
        base_cycles=int(d["base_cycles"]), exact=bool(d["exact"]),
        walked=bool(d["walked"]),
        sites=[KernelSite(
            kernel=s["kernel"], grid=tuple(s["grid"]), steps=int(s["steps"]),
            count=int(s["count"]), dma=int(s["dma"]), flat=int(s["flat"]),
            walked=int(s["walked"]) if s["walked"] is not None else None)
            for s in d["sites"]],
        **{k: int(d[k]) for k in _RES})


def to_dict(trace: KernelTrace) -> Dict[str, Any]:
    return {"kernel": trace.kernel_id, "shape": trace.shape,
            "space_fingerprint": trace.space_fingerprint,
            "version": trace.version,
            "entries": {k: entry_to_dict(e)
                        for k, e in sorted(trace.entries.items())}}


def from_dict(d: Dict[str, Any]) -> KernelTrace:
    return KernelTrace(
        kernel_id=d["kernel"], shape=d["shape"],
        space_fingerprint=d.get("space_fingerprint", ""),
        version=int(d.get("version", TRACE_VERSION)),
        entries={k: entry_from_dict(v) for k, v in d["entries"].items()})


def to_json(trace: KernelTrace) -> str:
    """Canonical JSON: sorted keys, fixed separators, byte-identical
    across round-trips, so artifacts diff and hash cleanly."""
    return json.dumps(to_dict(trace), sort_keys=True,
                      separators=(",", ":"))


def from_json(s: str) -> KernelTrace:
    return from_dict(json.loads(s))


# ------------------------------------------------------------ on-disk

class TraceStore:
    """Shared on-disk store of trace artifacts, colocated with the
    ``EvalCache`` root. One JSON file per (kernel, shape, space
    fingerprint); concurrent ``merge`` calls are read-merge-write under
    a :class:`FileLock`, entry-wise, so parallel capture workers never
    drop each other's entries."""

    def __init__(self, root: str):
        self.root = os.path.join(os.path.expanduser(root), "traces")

    def path_for(self, kernel_id: str, shape: str,
                 space_fingerprint: str = "") -> str:
        blob = f"{kernel_id}|{shape}|{space_fingerprint}|v{TRACE_VERSION}"
        h = hashlib.sha256(blob.encode()).hexdigest()[:16]
        return os.path.join(self.root, f"{kernel_id}__{h}.json")

    def load(self, kernel_id: str, shape: str,
             space_fingerprint: str = "") -> Optional[KernelTrace]:
        path = self.path_for(kernel_id, shape, space_fingerprint)
        try:
            with open(path) as f:
                return from_dict(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    def merge(self, trace: KernelTrace) -> KernelTrace:
        """Merge ``trace``'s entries into the stored artifact (new
        entries win per config key); returns the merged trace."""
        path = self.path_for(trace.kernel_id, trace.shape,
                             trace.space_fingerprint)
        os.makedirs(self.root, exist_ok=True)
        with FileLock(path + ".lock"):
            try:
                with open(path) as f:
                    merged = from_dict(json.load(f))
            except (OSError, ValueError, KeyError):
                merged = KernelTrace(
                    kernel_id=trace.kernel_id, shape=trace.shape,
                    space_fingerprint=trace.space_fingerprint)
            merged.entries.update(trace.entries)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(to_json(merged))
            os.replace(tmp, path)
        return merged
