"""The user-facing probe API — the ``#pragma HLS RealProbe`` analogue.

Port of ``repro.core.pragma`` for eager PyTorch functions::

    pf = probe(step, ProbeConfig(targets=("layers",)))
    out, record = pf(x, w)          # outputs as step(x, w) gives them
    print(pf.report(record).table())

The first call captures the function ONCE (``core.hierarchy``: one run
under a recording dispatch mode, whose in-place writes are undone, so a
step that updates its cache in place advances it once), selects probes,
and then runs it instrumented (``core.instrument``).
``kernel_probes`` (kernel body names, or ``"*"``) probes the grid steps
of the matched hand kernels (``core.kernelprobe``); it needs the model
clock, as in the JAX package. The capture is
memoised per ``ProbedFunction``, keyed on the arguments' tree structure
and their tensors' shapes, dtypes and devices; Python ints and floats
are run-time values, as a traced int32 is in JAX (a scalar that changes
shapes must be closed over). ``retarget`` changes the probes and reuses the capture
(incremental synthesis), also when it flips ``kernel_probes``: the
hierarchy for other kernel probes is another view of the same capture.
The function runs on its own tensors' devices; the probe state lives on
``device`` (the GPU unless 'cpu' is asked).

Not in this port: the ``legacy`` state layout (the JAX package's
equivalence reference); asking for it raises.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch import resolve_device
from repro_torch.core import inline as inline_mod
from repro_torch.core.buffer import HostSink, state_bytes
from repro_torch.core.hierarchy import Hierarchy, capture
from repro_torch.core.instrument import (CYCLE_SOURCES, ProbeAssignment,
                                         Runner, init_state)
from repro_torch.core.oracle import Oracle, OracleCounters
from repro_torch.core.report import Report, build_report


@dataclass(frozen=True)
class ProbeConfig:
    targets: Tuple[str, ...] = ("",)      # subtree roots ("" = everything)
    depth_limit: Optional[int] = None     # max hierarchy depth below target
    max_probes: int = 50                  # paper's conservative default
    buffer_depth: int = 4                 # iteration records kept on-chip
    offload: float = 0.0                  # fraction of probes that DRAM-spill
                                          # when their ring fills
    cycle_source: str = "model"           # model | wallclock
    inline: str = "default"               # default | off_all | off_top
    kernel_probes: Tuple[str, ...] = ()   # kernel body names to probe
                                          # grid steps of ("*" = all)
    layout: str = "packed"                # not ported: only "packed"

    def __post_init__(self):
        if self.layout != "packed":
            raise NotImplementedError(
                f"state layout {self.layout!r} is not ported; the port has "
                f"one int64 layout")
        if self.cycle_source not in CYCLE_SOURCES:
            raise ValueError(f"unknown cycle source {self.cycle_source!r}")
        if self.buffer_depth < 1:
            raise ValueError("buffer_depth must be >= 1")

    def replace(self, **kw) -> "ProbeConfig":
        return dataclasses.replace(self, **kw)


def _select_probes(h: Hierarchy, cfg: ProbeConfig) -> Tuple[str, ...]:
    eligible = set(inline_mod.selectable_paths(h, cfg.inline, cfg.targets))
    tset = [t.strip("/") for t in cfg.targets]

    def in_target(path: str) -> bool:
        return any(t == "" or path == t or path.startswith(t + "/")
                   for t in tset)

    chosen = []
    for node in h.root.walk():          # preorder: shallow scopes first
        p = node.path
        if not p or p not in eligible or not in_target(p):
            continue
        if cfg.depth_limit is not None:
            rel_depth = p.count("/") + 1
            for t in tset:
                if t and (p == t or p.startswith(t + "/")):
                    rel_depth = p[len(t):].count("/")
                    break
            if rel_depth > cfg.depth_limit:
                continue
        chosen.append(p)
        if len(chosen) >= cfg.max_probes:
            break
    return tuple(chosen)


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return ("scalar", type(x).__name__)       # a run-time value
    return ("static", repr(x))


def _sorted_dicts(tree):
    """``tree`` with every dict's keys in sorted order, as the JAX
    package's pytrees order them: a capture is keyed on the arguments'
    structure, not on the order a caller built a dict in."""
    if type(tree) is dict:
        return {k: _sorted_dicts(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted_dicts(x) for x in tree)
    return tree


class ProbedFunction:
    """Instrumented wrapper around an eager PyTorch function."""

    def __init__(self, fn: Callable, config: ProbeConfig = ProbeConfig(),
                 device=None):
        self.fn = fn
        self.config = config
        self.device = resolve_device(device)
        self.sink = HostSink()
        self._hierarchy: Optional[Hierarchy] = None
        self._key = None
        self._kernel_key: Tuple[str, ...] = ()
        self._assignment: Optional[ProbeAssignment] = None
        self.captures = 0
        self.capture_seconds = 0.0     # host time of the captures
        self.last_run: Dict[str, int] = {}

    # -- stage 2: module extraction (once) ------------------------------
    def trace(self, *args, **kwargs) -> Hierarchy:
        """The hierarchy for these arguments' shapes (captured by one run
        of the function the first time) and the config's kernel probes
        (a view of the capture: flipping them captures nothing)."""
        leaves, spec = pytree.tree_flatten(_sorted_dicts((args, kwargs)))
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        kkey = tuple(self.config.kernel_probes)
        if self._hierarchy is None or key != self._key:
            t0 = time.perf_counter()
            self._hierarchy, _ = capture(self.fn, *args, **kwargs)
            self.capture_seconds += time.perf_counter() - t0
            self._key = key
            self._kernel_key = ()
            self._assignment = None
            self.captures += 1
        if kkey != self._kernel_key:
            self._hierarchy = self._hierarchy.with_kernel_probes(kkey)
            self._kernel_key = kkey
            self._assignment = None
        return self._hierarchy

    @property
    def hierarchy(self) -> Hierarchy:
        if self._hierarchy is None:
            raise RuntimeError("call .trace(*args) or the function first")
        return self._hierarchy

    # -- stage 3: probe selection ----------------------------------------
    def _build(self, *args, **kwargs) -> None:
        if self.config.kernel_probes and self.config.cycle_source != "model":
            raise ValueError("kernel_probes require cycle_source='model': "
                             "grid steps run inside one kernel launch, so "
                             "there is no timestamp per step")
        h = self.trace(*args, **kwargs)
        if self._assignment is not None:
            return
        paths = _select_probes(h, self.config)
        n_spill = int(math.ceil(float(self.config.offload) * len(paths)))
        self._assignment = ProbeAssignment(
            paths=paths, depth=self.config.buffer_depth,
            spill=tuple(i < n_spill for i in range(len(paths))))

    def ensure_built(self, *args, **kwargs) -> "ProbedFunction":
        self._build(*args, **kwargs)
        return self

    # -- public ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """One-shot: (outputs, record) from a fresh zeroed state."""
        self._build(*args, **kwargs)
        return self._run(self.init_state(), args, kwargs,
                         calls=[0] * self.assignment.n)

    def init_state(self) -> Dict[str, Any]:
        """Fresh zeroed device counter state for the stateful entry."""
        return init_state(self.assignment.n, self.config.buffer_depth,
                          device=self.device)

    def stateful_call(self, state, *args, **kwargs):
        """Run one step with caller-owned counter state, so cycle and call
        totals accumulate across steps. Returns (outputs, state); the
        state is updated in place."""
        self._build(*args, **kwargs)
        return self._run(state, args, kwargs)

    def _run(self, state, args, kwargs, calls=None):
        run = Runner(self._hierarchy, self._assignment, state,
                     cycle_source=self.config.cycle_source, sink=self.sink,
                     calls=calls, rows_hint=self.last_run.get("dumps", 0))
        with run:
            out = self.fn(*args, **kwargs)
        self.last_run = run.stats()
        return out, state

    def retarget(self, config: ProbeConfig) -> "ProbedFunction":
        """Incremental re-instrumentation: reuses the capture; only probe
        selection is redone (paper §IV-C.2)."""
        self.config = config
        self._assignment = None
        return self

    @property
    def assignment(self) -> ProbeAssignment:
        if self._assignment is None:
            raise RuntimeError("not built yet")
        return self._assignment

    def probe_paths(self) -> Tuple[str, ...]:
        return self.assignment.paths

    def resource_bytes(self) -> int:
        return state_bytes(self.assignment.n, self.config.buffer_depth)

    # -- verification / reporting ------------------------------------------
    def oracle(self, *args, **kwargs) -> OracleCounters:
        """Host-int counters from an independent live-priced run (the
        function runs once more; its in-place writes are undone)."""
        self._build(*args, **kwargs)
        return Oracle(self._assignment, self.config.kernel_probes).run(
            self.fn, *args, **kwargs)

    def report(self, record: Dict[str, Any]) -> Report:
        return build_report(self.hierarchy, self.assignment, record,
                            self.sink, cycle_source=self.config.cycle_source)


def probe(fn: Callable, config: ProbeConfig = ProbeConfig(),
          device=None) -> ProbedFunction:
    """Single-directive activation (the pragma)."""
    return ProbedFunction(fn, config, device=device)
