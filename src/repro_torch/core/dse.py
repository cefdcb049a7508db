"""Automated design-space exploration (paper §IV-E, Fig 13).

Port of ``repro.core.dse``. Two DSE loops live here:

**run_dse** explores profiling configurations — storage class
(register-like shallow rings, BRAM-like deep rings, hybrid) x DRAM dump
ratio (0/25/50/75%) — and scores each on the paper's three metrics:

  1) resource overhead      on-device state bytes + the instrumented
                            run's extra launches (``probe_events``,
                            ``probe_grid``, dump copies; weighted,
                            relative to the base program's operations),
  2) DRAM bandwidth         offloaded bytes / profiled span (the span on
                            the H100's model clock),
  3) latency impact         measured wall time of the instrumented call
                            relative to the unprobed call (Fmax analogue).

It returns all points plus the Pareto-optimal subset. Incremental
re-instrumentation (the capture reused by every retarget) is what makes
the sweep cheap: each point only redoes probe selection.

**DSEEngine** closes the paper's second loop: probe telemetry driving
*kernel-configuration* search under device resource budgets. Given a
:class:`SearchSpace` (the CUDA kernels' tiles, ``kernels.search_spaces``)
it

  1) enumerates candidate configs,
  2) prunes statically against a :class:`~repro_torch.core.costmodel.
     DeviceBudget` (shared memory, threads and registers a CTA needs,
     as each kernel wrapper states them from its source's formula; HBM
     traffic and FLOPs optionally): a candidate the card cannot hold is
     never launched,
  3) measures survivors with ``ProbeSession`` telemetry under successive
     halving (cheap configs get few steps, finalists many),
  4) memoizes every measurement in the on-disk :class:`~repro_torch.
     core.incremental.EvalCache` keyed by (kernel id, config, capture
     fingerprint, device kind), so a re-run after an unrelated edit
     re-measures nothing.

The clock it measures with: the model clock prices a CUDA kernel by its
bytes and FLOPs, which are the same at every tile, so on the card it
cannot rank tiles. On CUDA the engine therefore measures with
``cycle_source="wallclock"`` (``%globaltimer``, ns) and holds the stream
behind a ~20 ms spin (``torch.cuda._sleep``) before each measured step,
so the host enqueues the step's probe events and kernels before the
first runs and the scope's interval reads device time, not host launch
gaps; the measured value is the top-level scopes' total a step. On the
CPU it keeps the JAX default, the model clock, and measures the
session's span a step, as the reference does.

Which candidate wins: on the card a step's time varies from step to
step, so a candidate replaces the default only if it beats the default
by more than the rung's measured spread (each reading's fastest to
slowest step, relative to its mean); on the deterministic model clock
the spread is 0 and this is the reference's rule (the default keeps a
tie). The winner is recorded at the shapes it was tuned at
(``kernels.tuning.shape_key``), and ``--autotune`` applies it only to
calls of those shapes.

``run_sweep``, the trace-once sweep farm (capture once with
``core.tracesim``, price every candidate in microseconds, measure only
the finalists in spawned workers sharing one cache), is the JAX
module's, over the port's spaces.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.buffer import state_bytes
from repro_torch.core.costmodel import (CLOCK_HZ, DeviceBudget,
                                        KernelResources)
from repro_torch.core.incremental import (EvalCache, capture_fingerprint,
                                          device_kind, device_of, sync,
                                          tensors)
from repro_torch.core.instrument import decode_record
from repro_torch.core.pragma import ProbeConfig, probe
from repro_torch.kernels import tuning

STORAGE_DEPTH = {"registers": 4, "hybrid": 16, "bram": 64}
# the spin before each measured step on the card: ~20 ms at the H100's
# ~1.98 GHz boost clock (as chip_smoke.py's timing hold)
HOLD_CYCLES = 40_000_000


@dataclass
class DSEPoint:
    storage: str
    depth: int
    offload_ratio: float
    n_probes: int
    state_bytes: int
    extra_eqns: int                  # extra launches a call (see overhead)
    dram_bytes: int
    dram_bandwidth_bps: float        # modeled at the H100's clock
    latency_overhead: float          # measured wall-time ratio - 1
    weighted_resource: float

    def dominates(self, o: "DSEPoint") -> bool:
        a = (self.weighted_resource, self.dram_bandwidth_bps,
             self.latency_overhead)
        b = (o.weighted_resource, o.dram_bandwidth_bps, o.latency_overhead)
        return all(x <= y for x, y in zip(a, b)) and a != b


@dataclass
class DSEResult:
    points: List[DSEPoint]
    pareto: List[DSEPoint]

    def best(self) -> Optional[DSEPoint]:
        return min(self.pareto,
                   key=lambda p: p.weighted_resource + p.latency_overhead,
                   default=None)

    def table(self) -> str:
        hdr = (f"{'storage':<10}{'depth':>6}{'dump%':>7}{'probes':>8}"
               f"{'state_B':>9}{'xeqns':>7}{'dram_B':>8}{'bw_MBps':>9}"
               f"{'lat_ovh':>9}  pareto")
        lines = [hdr]
        ps = {id(p) for p in self.pareto}
        for p in self.points:
            lines.append(
                f"{p.storage:<10}{p.depth:>6}{p.offload_ratio * 100:>6.0f}%"
                f"{p.n_probes:>8}{p.state_bytes:>9}{p.extra_eqns:>7}"
                f"{p.dram_bytes:>8}{p.dram_bandwidth_bps / 1e6:>9.3f}"
                f"{p.latency_overhead * 100:>8.2f}%"
                f"  {'*' if id(p) in ps else ''}")
        return "\n".join(lines)


def _timeit(f, args, repeats: int = 3) -> float:
    """Best host wall time of ``f(*args)`` over ``repeats`` calls, each
    ended by a synchronise of the card (a host clock around work that
    ends in a synchronise)."""
    dev = device_of(args)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        f(*args)
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def run_dse(fn: Callable, args: Sequence[Any],
            base_cfg: ProbeConfig = ProbeConfig(),
            storages: Sequence[str] = ("registers", "hybrid", "bram"),
            offload_ratios: Sequence[float] = (0.0, 0.25, 0.5, 0.75),
            resource_weights: Tuple[float, float] = (1.0, 1.0),
            repeats: int = 3, device=None,
            check: Optional[Callable[[Any, Dict[str, Any], Any], None]]
            = None) -> DSEResult:
    """Sweep storage class x offload ratio over ``fn(*args)`` (see the
    module docstring). The probe state lives on ``device`` (the GPU
    unless 'cpu' is asked). ``check(pf, record, outputs)``, if given, is
    called on each point's first probed call (``chip_smoke.py`` holds
    each point's record against the oracle and its outputs against the
    unprobed ones there)."""
    from repro_torch.core.overhead import measure_overhead

    fn(*args)                             # warm up
    sync(device_of(args))
    t_base = _timeit(fn, args, repeats=repeats)

    pf = probe(fn, base_cfg, device=device)   # one capture for the sweep
    pf.trace(*args)

    points: List[DSEPoint] = []
    for storage in storages:
        depth = STORAGE_DEPTH[storage]
        for ratio in offload_ratios:
            cfg = base_cfg.replace(buffer_depth=depth, offload=ratio)
            pf.retarget(cfg)
            pf.sink.reset()
            out, rec = pf(*args)
            dec = decode_record(rec)
            if check is not None:
                check(pf, dec, out)
            t_inst = _timeit(lambda *a: pf(*a), args, repeats=repeats)
            span_s = max(dec["cycle"] / CLOCK_HZ, 1e-12)
            dram = pf.sink.bytes_received     # of these 1 + repeats calls
            ov = measure_overhead(fn, args, cfg, device=pf.device, pf=pf)
            sbytes = state_bytes(pf.assignment.n, depth)
            wres = (resource_weights[0] * sbytes / 1024.0 +
                    resource_weights[1] * ov["extra_eqns"] /
                    max(ov["base_eqns"], 1))
            points.append(DSEPoint(
                storage=storage, depth=depth, offload_ratio=ratio,
                n_probes=pf.assignment.n, state_bytes=sbytes,
                extra_eqns=ov["extra_eqns"], dram_bytes=dram,
                dram_bandwidth_bps=dram / span_s,
                latency_overhead=max(t_inst / max(t_base, 1e-12) - 1.0, 0.0),
                weighted_resource=wres))
    pareto = [p for p in points
              if not any(o.dominates(p) for o in points)]
    return DSEResult(points=points, pareto=pareto)


# ===================================================================
# Kernel-configuration autotuning (probe-guided, budget-constrained)
# ===================================================================

@dataclass
class SearchSpace:
    """Declarative candidate space for one kernel.

    ``axes`` maps axis name -> allowed values; candidates are the
    cartesian product filtered through ``is_valid``. ``bind(config)``
    returns a callable taking ``args`` (example inputs at the shapes
    being tuned) that executes the kernel under that config.
    ``default`` is the untuned baseline the leaderboard compares
    against. ``resources(config)``, where the kernel states it, is the
    candidate's ``KernelResources`` by its source's formula (a CUDA
    kernel has no jaxpr to walk); without it a candidate needs nothing
    the budget checks, as a JAX program without Pallas calls.
    """
    kernel_id: str
    axes: Dict[str, Tuple[Any, ...]]
    bind: Callable[[Dict[str, Any]], Callable]
    args: Tuple[Any, ...]
    default: Dict[str, Any]
    is_valid: Optional[Callable[[Dict[str, Any]], bool]] = None
    resources: Optional[Callable[[Dict[str, Any]], KernelResources]] = None

    def candidates(self) -> List[Dict[str, Any]]:
        names = sorted(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[n] for n in names)):
            cfg = dict(zip(names, combo))
            if self.is_valid is None or self.is_valid(cfg):
                out.append(cfg)
        return out

    @property
    def device(self) -> torch.device:
        return device_of(self.args)


@dataclass
class Trial:
    """One candidate's journey through the engine."""
    config: Dict[str, Any]
    resources: Optional[KernelResources] = None
    fingerprint: str = ""
    pruned: Optional[str] = None          # reason, when statically rejected
    cycles_per_step: Optional[float] = None
    steps: int = 0                        # largest rung this trial ran at
    cache_hits: int = 0
    measurements: int = 0
    is_default: bool = False
    value_steps: int = 0                  # the run cycles_per_step is of
    spread: float = 0.0                   # that run's step-to-step spread
    # grid-step calibration (``DSEEngine.measure_tiles``): per-step
    # cycles from the kernel-probed counters vs the flat per-step
    # estimate; residual = static - measured. tile_dma is the per-step
    # transfer term of the grid plans.
    tile_static: Optional[float] = None
    tile_measured: Optional[float] = None
    tile_residual: Optional[float] = None
    tile_dma: Optional[float] = None

    @property
    def measured(self) -> bool:
        return self.cycles_per_step is not None


@dataclass
class TuneResult:
    kernel_id: str
    trials: List[Trial]
    best: Optional[Trial]
    default: Optional[Trial]
    n_candidates: int
    n_pruned: int
    n_measurements: int                   # ProbeSession runs performed
    n_cache_hits: int
    measured_steps: int                   # total steps across measurements
    wall_s: float
    device: str = ""

    @property
    def speedup(self) -> float:
        """Default cycles/step over best cycles/step (>1 = tuned wins)."""
        if (self.best is None or self.default is None
                or not self.default.measured or not self.best.measured):
            return 1.0
        return self.default.cycles_per_step / max(self.best.cycles_per_step,
                                                  1e-12)

    def leaderboard(self, top: int = 10) -> str:
        from repro_torch.core import report as report_mod
        return report_mod.dse_leaderboard(self, top=top)

    def to_dict(self) -> Dict[str, Any]:
        def trial(t: Optional[Trial]):
            if t is None:
                return None
            return {"config": t.config, "pruned": t.pruned,
                    "cycles_per_step": t.cycles_per_step, "steps": t.steps,
                    "cache_hits": t.cache_hits,
                    "measurements": t.measurements,
                    "is_default": t.is_default,
                    "tile_residual": t.tile_residual}
        return {
            "kernel": self.kernel_id, "device": self.device,
            "n_candidates": self.n_candidates, "n_pruned": self.n_pruned,
            "n_measurements": self.n_measurements,
            "n_cache_hits": self.n_cache_hits,
            "measured_steps": self.measured_steps,
            "speedup": round(self.speedup, 4),
            "best": trial(self.best), "default": trial(self.default),
            "trials": [trial(t) for t in self.trials],
        }


def keeps_default(default_cycles: float, best_cycles: float,
                  spread: float) -> bool:
    """Does the default stay the winner? Yes unless the best candidate
    beats it by more than ``spread``, the larger relative spread of the
    two readings (0 on the model clock, where a tie keeps the default,
    as in the reference)."""
    return best_cycles >= default_cycles * (1 - spread)


class DSEEngine:
    """Probe-guided autotuner for the port's CUDA kernel configurations.

    ``tune()`` runs enumerate -> static-prune -> successive-halving
    measurement -> cache, and returns a :class:`TuneResult`. The
    baseline (``space.default``) is always measured alongside the
    survivors so the leaderboard's speedup is honest.

    Successive halving: every surviving candidate runs ``r0`` probed
    steps; the best ``1/eta`` fraction advances with ``eta``x the steps,
    until one remains or ``max_steps`` is reached. All measurements go
    through the :class:`EvalCache`, so a warm re-run performs zero new
    measurements: a rung reads the cached run of exactly its steps where
    there is one (``EvalCache.get``), so a warm run ranks each rung as the
    cold run did even on a noisy clock, and the default is compared at
    the finalists' rung (JAX compares it at its longest cached run, which
    may read an extra cache hit less). ``cycle_source`` None picks the
    clock by the space's device (see the module docstring).
    """

    def __init__(self, space: SearchSpace, *,
                 budget: Optional[DeviceBudget] = DeviceBudget(),
                 cache: Optional[EvalCache] = None,
                 cache_dir: Optional[str] = None,
                 cycle_source: Optional[str] = None,
                 r0: int = 1, eta: int = 2, max_steps: int = 4,
                 static_prune_ratio: Optional[float] = None):
        if r0 < 1 or eta < 2 or max_steps < r0:
            raise ValueError(f"bad halving schedule r0={r0} eta={eta} "
                             f"max_steps={max_steps}")
        self.space = space
        self.budget = budget
        self.cache = cache if cache is not None else EvalCache(cache_dir)
        dev = space.device
        self.cycle_source = cycle_source or (
            "wallclock" if dev.type == "cuda" else "model")
        self.r0, self.eta, self.max_steps = r0, eta, max_steps
        self.static_prune_ratio = static_prune_ratio
        self.device = device_kind(dev)
        # kernel body names observed by measure_tiles (calibrate targets)
        self._tile_kernels: set = set()
        # run accounting (reset per tune())
        self.n_measurements = 0
        self.n_cache_hits = 0
        self.measured_steps = 0

    # -- stage 1+2: enumerate & statically analyze ----------------------
    def analyze(self, config: Dict[str, Any]) -> Trial:
        """One candidate's declared resources (nothing runs: a candidate
        over the budget is never launched). Its fingerprint is taken at
        its first evaluation (``fingerprint``)."""
        res = (self.space.resources(config) if self.space.resources
               is not None else KernelResources())
        return Trial(config=dict(config), resources=res)

    def fingerprint(self, t: Trial) -> str:
        """The candidate's capture fingerprint (one run of it), memoised
        on the trial."""
        if not t.fingerprint:
            t.fingerprint = capture_fingerprint(self.space.bind(t.config),
                                                self.space.args)
        return t.fingerprint

    def prune(self, trials: Sequence[Trial]) -> List[Trial]:
        """Static rejection against the device budget; optionally also
        drop candidates whose flat estimate exceeds ``static_prune_ratio``
        x the best. Hard budget checks can never discard a config that
        actually fits the device, so the measured-best always survives
        default pruning."""
        alive = []
        for t in trials:
            if self.budget is not None and t.resources is not None:
                v = self.budget.violations(t.resources)
                if v:
                    t.pruned = "; ".join(v)
                    continue
            alive.append(t)
        if self.static_prune_ratio is not None and alive:
            floor = min(t.resources.static_cycles for t in alive
                        if t.resources is not None)
            kept = []
            for t in alive:
                if (t.resources is not None and floor > 0 and
                        t.resources.static_cycles >
                        self.static_prune_ratio * floor):
                    t.pruned = (f"static {t.resources.static_cycles} cyc > "
                                f"{self.static_prune_ratio:g}x floor {floor}")
                else:
                    kept.append(t)
            alive = kept
        return alive

    # -- stage 3: probed measurement ------------------------------------
    def _measure(self, config: Dict[str, Any], steps: int
                 ) -> Tuple[float, float]:
        """Run ``steps`` probed steps of the candidate under a
        ``ProbeSession``; returns its cycles a step (see the module
        docstring: the span a step on the model clock; on the card, the
        top-level scopes' ns a step with the stream held) and their
        spread: (slowest - fastest step) / mean, 0 on the model clock."""
        from repro_torch.core.streaming import ProbeSession
        fn = self.space.bind(config)
        args = self.space.args
        dev = self.space.device
        # every scope selectable (``off_all``): the top-level scope, whose
        # total the wallclock measurement reads, may hold one kernel call,
        # which the default policy would inline
        cfg = ProbeConfig(targets=("",), max_probes=4, buffer_depth=2,
                          cycle_source=self.cycle_source, inline="off_all")
        pf = probe(fn, cfg, device=dev)
        pf.ensure_built(*args)            # the capture, before any hold
        sync(dev)
        with ProbeSession(pf, window_steps=steps + 1) as s:
            for _ in range(steps):
                if dev.type == "cuda":
                    torch.cuda._sleep(HOLD_CYCLES)
                s.step(*args)
            sync(dev)
            snap = s.snapshot()
        self.n_measurements += 1
        self.measured_steps += steps
        if self.cycle_source == "model":
            return snap.span / max(steps, 1), 0.0
        rows = [r for r in snap.rows if "/" not in r.path]
        cps = sum(r.total_cycles for r in rows) / max(steps, 1)
        width = sum(r.max - r.min for r in rows)
        return cps, (width / cps if cps > 0 else 0.0)

    def _eval_fingerprint(self, t: Trial) -> str:
        """Trial fingerprint extended with the measuring clock and the
        installed kernel-calibration state: cycles measured under another
        clock or calibration never share a cache key. The model clock
        uncalibrated leaves the key the fingerprint itself."""
        from repro_torch.core.costmodel import kernel_calibration_state
        fp = self.fingerprint(t)
        if self.cycle_source != "model":
            return f"{fp}|{self.cycle_source}"
        state = kernel_calibration_state()
        if not state:
            return fp
        tag = ";".join(f"{k}={v:.6f}" for k, v in state)
        return f"{fp}|calib[{tag}]"

    def evaluate(self, t: Trial, steps: int) -> float:
        """Cache-through evaluation at a rung of ``steps`` steps."""
        fp = self._eval_fingerprint(t)
        hit = self.cache.get(self.space.kernel_id, t.config, fp,
                             self.device, min_steps=steps)
        if hit is not None:
            t.cache_hits += 1
            self.n_cache_hits += 1
            t.cycles_per_step = float(hit["cycles_per_step"])
            t.spread = float(hit.get("spread", 0.0))
            t.steps = max(t.steps, int(hit["steps"]))
            t.value_steps = int(hit["at_steps"])
            return t.cycles_per_step
        cps, spread = self._measure(t.config, steps)
        t.measurements += 1
        t.cycles_per_step, t.spread = cps, spread
        t.steps = t.value_steps = steps
        self.cache.put(self.space.kernel_id, t.config, fp,
                       self.device, cycles_per_step=cps, steps=steps,
                       spread=spread)
        return cps

    # -- grid-step calibration (measured per-step cycles) ----------------
    def measure_tiles(self, t: Trial) -> Trial:
        """Probe the candidate's kernels grid step by grid step (model
        clock: grid steps inside one launch have no timestamps) and
        record per-step cycles on the trial: ``tile_measured`` the grid
        probes' total over their calls (the counters see the causal
        skips), ``tile_static`` the flat estimate a step, ``tile_dma``
        the plans' transfer term a step. The kernel body names observed
        are remembered as ``calibrate()`` targets."""
        from repro_torch.core import kernelprobe as kp
        fn = self.space.bind(t.config)
        args = self.space.args
        cfg = ProbeConfig(targets=("",), max_probes=16, buffer_depth=2,
                          cycle_source="model", kernel_probes=("*",),
                          inline="off_all")
        pf = probe(fn, cfg, device=self.space.device)
        h = pf.trace(*args)
        kpaths = tuple(n.path for n in h.root.walk() if n.kind == "kernel")
        if not kpaths:
            raise ValueError(
                f"measure_tiles({t.config}): the bound function calls no "
                f"kernel with a grid plan to probe")
        pf.retarget(cfg.replace(targets=kpaths))
        _, rec = pf(*args)
        dec = decode_record(rec)
        grid_total = grid_calls = 0
        for i, path in enumerate(pf.probe_paths()):
            if path.endswith("/" + kp.GRID_SEG):
                grid_total += int(dec["totals"][i])
                grid_calls += int(dec["calls"][i])
                # <scope>/kernel/<name>#i/grid -> <name>
                self._tile_kernels.add(
                    path.rsplit("/", 2)[-2].split("#")[0])
        if grid_calls:
            t.tile_measured = grid_total / grid_calls
        dma_total = steps_total = 0
        for ks in h.kernels.values():
            if ks.path is None:
                continue
            steps = int(np.prod(ks.plan[1]))
            dma_total += ks.plan[2] * steps
            steps_total += steps
        if steps_total:
            t.tile_dma = dma_total / steps_total
        if t.resources is not None and t.resources.grid_steps:
            t.tile_static = (t.resources.static_cycles /
                             t.resources.grid_steps)
        if t.tile_measured is not None and t.tile_static is not None:
            t.tile_residual = t.tile_static - t.tile_measured
        return t

    def calibration(self, trials: Optional[Sequence[Trial]] = None
                    ) -> Optional[float]:
        """measured / static ratio a step. The port prices a kernel
        region flat as ONE roofline term with no separate transfer term
        (the JAX package's body + DMA), and the calibration scales that
        whole term, so the ratio is taken over the whole step: installed,
        it makes the calibrated flat step equal the measured one."""
        ratios = [t.tile_measured / t.tile_static
                  for t in (trials if trials is not None else [])
                  if t.tile_measured is not None and t.tile_static]
        if not ratios:
            return None
        return float(np.mean(ratios))

    def calibrate(self, trials: Sequence[Trial]) -> Optional[float]:
        """Install the measured ratio (``costmodel.set_kernel_calibration``)
        for every kernel body seen by ``measure_tiles``: later captures
        price those kernels' flat cycles by it. Returns the scale (None
        without tile data); undo with ``costmodel.
        clear_kernel_calibration()``."""
        from repro_torch.core import costmodel as _cm
        scale = self.calibration(trials)
        if scale is None:
            return None
        for kname in sorted(self._tile_kernels):
            _cm.set_kernel_calibration(kname, scale)
        return scale

    def successive_halving(self, trials: List[Trial]) -> Optional[Trial]:
        active = list(trials)
        r = self.r0
        while active:
            for t in active:
                self.evaluate(t, r)
            active.sort(key=lambda t: t.cycles_per_step)
            if len(active) == 1 or r >= self.max_steps:
                return active[0]
            keep = max(1, math.ceil(len(active) / self.eta))
            active = active[:keep]
            r = min(r * self.eta, self.max_steps)
        return None

    # -- the whole loop --------------------------------------------------
    def tune(self) -> TuneResult:
        self.n_measurements = self.n_cache_hits = self.measured_steps = 0
        t0 = time.perf_counter()
        configs = self.space.candidates()
        trials = [self.analyze(c) for c in configs]
        default_trial = None
        for t in trials:
            if t.config == self.space.default:
                t.is_default = True
                default_trial = t
        survivors = self.prune(trials)
        best = self.successive_halving(survivors)
        # always measure the baseline (even if pruned / not in the space),
        # at the SAME rung as the finalist
        if default_trial is None:
            default_trial = self.analyze(self.space.default)
            default_trial.is_default = True
            trials.append(default_trial)
        base_steps = best.steps if (best is not None and best.measured) \
            else self.r0
        if not default_trial.measured or \
                default_trial.value_steps < base_steps:
            self.evaluate(default_trial, base_steps)
        if best is None or (default_trial.measured and best.measured and
                            keeps_default(
                                default_trial.cycles_per_step,
                                best.cycles_per_step,
                                max(default_trial.spread, best.spread))):
            best = default_trial
        if best is not None and best.measured:
            shape = tuning.shape_key(self.space.kernel_id,
                                     tensors(self.space.args))
            self.cache.set_winner(self.space.kernel_id, self.device,
                                  best.config,
                                  cycles_per_step=best.cycles_per_step,
                                  shape=shape)
        return TuneResult(
            kernel_id=self.space.kernel_id, trials=trials, best=best,
            default=default_trial, n_candidates=len(configs),
            n_pruned=sum(1 for t in trials if t.pruned is not None),
            n_measurements=self.n_measurements,
            n_cache_hits=self.n_cache_hits,
            measured_steps=self.measured_steps,
            wall_s=time.perf_counter() - t0, device=self.device)


# ===================================================================
# Trace-once sweep farm (simulator-first, multi-process, shared cache)
# ===================================================================
#
# Successive halving measures tens of candidates; the sweep farm covers
# many more. The phases (the JAX package's):
#
#   1. capture  — workers run each missing (config, shape) once and
#                 merge the KernelTrace artifacts into the shared
#                 TraceStore;
#   2. calibrate — one kernel-probed run on the first shape installs the
#                 measured/static ratio (``DSEEngine.measure_tiles`` +
#                 ``calibrate``), which transfers to every other shape
#                 through the artifacts;
#   3. simulate — the parent re-prices EVERY candidate from the
#                 artifacts (flat mode: the model clock's measurement),
#                 prunes against the budget, and ranks;
#   4. measure  — only the per-shape finalists (default + top priced)
#                 run, in workers sharing one EvalCache.
#
# Workers run in *spawned* processes: tasks carry only plain data,
# spaces are rebuilt by name via ``search_spaces.sweep_space`` (bind
# closures don't pickle), and the installed calibration state is
# re-applied inside the worker. On the card the simulated (model-clock)
# ranking cannot tell tiles apart (see the module docstring); the
# finalists' measurement decides.

@dataclass
class SweepShapeOutcome:
    shape: Dict[str, Any]
    n_candidates: int
    n_pruned: int
    best_config: Optional[Dict[str, Any]] = None
    best_cycles: Optional[float] = None
    default_config: Optional[Dict[str, Any]] = None
    default_cycles: Optional[float] = None

    @property
    def speedup(self) -> float:
        if not self.best_cycles or not self.default_cycles:
            return 1.0
        return self.default_cycles / max(self.best_cycles, 1e-12)


@dataclass
class SweepResult:
    kernel_id: str
    device: str
    shapes: List[SweepShapeOutcome]
    n_candidates: int             # configs x shapes enumerated
    n_captured: int               # traces captured this run (rest reused)
    n_pruned: int
    n_priced: int                 # simulator-priced candidates
    n_finalists: int
    n_measured: int               # ProbeSession runs performed
    n_cache_hits: int
    n_calibration_runs: int
    calibration_scale: Optional[float]
    workers: int
    top_k: int
    price_wall_s: float           # capture phase
    sim_wall_s: float             # pure artifact re-pricing
    measure_wall_s: float
    wall_s: float

    @property
    def sim_us_per_config(self) -> float:
        return 1e6 * self.sim_wall_s / max(self.n_candidates, 1)

    def summary(self) -> str:
        lines = [
            f"sweep {self.kernel_id} on {self.device}: "
            f"{self.n_candidates} candidates over {len(self.shapes)} "
            f"shapes, {self.n_pruned} pruned, {self.n_finalists} "
            f"finalists, {self.n_measured} device measurements "
            f"({self.n_cache_hits} cache hits)",
            f"  capture {self.price_wall_s:.2f}s "
            f"({self.n_captured} captured, rest reused) | simulate "
            f"{self.sim_wall_s * 1e3:.1f}ms "
            f"({self.sim_us_per_config:.1f}us/config) | measure "
            f"{self.measure_wall_s:.2f}s",
        ]
        if self.calibration_scale is not None:
            lines.append(f"  calibration scale {self.calibration_scale:.4f} "
                         f"(transferred to all shapes)")
        for o in self.shapes:
            lines.append(
                f"  {o.shape}: best {o.best_config} "
                f"{o.best_cycles if o.best_cycles is not None else float('nan'):.0f} cyc/step, "
                f"{o.speedup:.2f}x vs default")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel_id, "device": self.device,
            "n_candidates": self.n_candidates,
            "n_captured": self.n_captured, "n_pruned": self.n_pruned,
            "n_priced": self.n_priced, "n_finalists": self.n_finalists,
            "n_measured": self.n_measured,
            "n_cache_hits": self.n_cache_hits,
            "n_calibration_runs": self.n_calibration_runs,
            "calibration_scale": self.calibration_scale,
            "workers": self.workers, "top_k": self.top_k,
            "sim_us_per_config": round(self.sim_us_per_config, 3),
            "shapes": [{
                "shape": o.shape, "n_candidates": o.n_candidates,
                "n_pruned": o.n_pruned, "best": o.best_config,
                "best_cycles": o.best_cycles, "default": o.default_config,
                "default_cycles": o.default_cycles,
                "speedup": round(o.speedup, 4)} for o in self.shapes],
        }


def _sweep_worker(task: Dict[str, Any]) -> Dict[str, Any]:
    """One farm work unit; module-level, plain data in and out (it
    crosses the spawn pickle boundary)."""
    from repro_torch.core import costmodel as _cm
    from repro_torch.core import tracesim as _ts
    from repro_torch.kernels import search_spaces as _ss

    _cm.clear_kernel_calibration()
    for kname, scale in task.get("calibration", ()):
        _cm.set_kernel_calibration(kname, float(scale))
    space = _ss.sweep_space(task["kernel"], device=task["device"],
                            **task["shape"])
    out: Dict[str, Any] = {"shape_idx": task["shape_idx"], "rows": [],
                           "measurements": 0, "cache_hits": 0}
    if task["phase"] == "capture":
        trace = _ts.KernelTrace(kernel_id=space.kernel_id,
                                shape=_ts.shape_signature(space.args),
                                space_fingerprint=task["space_fp"])
        for cfg in task["configs"]:
            trace.entries[_ts.config_key(cfg)] = _ts.capture_entry(
                space, cfg, walk=task.get("walk", False))
        _ts.TraceStore(task["cache_dir"]).merge(trace)
        out["captured"] = len(task["configs"])
        return out
    # phase == "measure": probed runs through the shared cache
    engine = DSEEngine(space, budget=None,
                       cache=EvalCache(task["cache_dir"]),
                       cycle_source=task.get("cycle_source"),
                       r0=task["steps"], max_steps=task["steps"])
    for cfg in task["configs"]:
        t = engine.analyze(cfg)
        cps = engine.evaluate(t, task["steps"])
        out["rows"].append({"config": cfg, "cycles": float(cps),
                            "steps": int(t.steps),
                            "spread": float(t.spread)})
    out["measurements"] = engine.n_measurements
    out["cache_hits"] = engine.n_cache_hits
    return out


def _run_tasks(tasks: List[Dict[str, Any]], workers: int) -> List[Dict]:
    if workers > 1 and len(tasks) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=ctx) as ex:
            return list(ex.map(_sweep_worker, tasks))
    return [_sweep_worker(t) for t in tasks]


def _chunked(seq: List[Any], size: int) -> List[List[Any]]:
    return [seq[i:i + size] for i in range(0, len(seq), max(size, 1))]


def run_sweep(kernel_id: str,
              shapes: Optional[Sequence[Dict[str, Any]]] = None, *,
              workers: int = 2, top_k: int = 16, steps: int = 4,
              budget: Optional[DeviceBudget] = DeviceBudget(),
              cache: Optional[EvalCache] = None,
              cache_dir: Optional[str] = None,
              calibrate: bool = False, walk: bool = False,
              chunk: int = 64, cycle_source: Optional[str] = None,
              reuse_traces: bool = True, device=None) -> SweepResult:
    """Simulator-first DSE over configs x shapes (see the phase map
    above) on ``device`` (the GPU unless 'cpu'). Measurement is reserved
    for at most ``max(2, top_k // n_shapes)`` finalists per shape, the
    default config plus the top simulator-priced survivors, however
    many candidates the sweep enumerates."""
    from repro_torch import resolve_device
    from repro_torch.core import costmodel as _cm
    from repro_torch.core import tracesim as ts
    from repro_torch.kernels import search_spaces as ss

    t_start = time.perf_counter()
    dev = str(resolve_device(device))
    shape_list = [dict(s) for s in
                  (shapes if shapes is not None
                   else ss.sweep_shapes(kernel_id))]
    cache = cache if cache is not None else EvalCache(cache_dir)
    store = ts.TraceStore(cache.root)
    dkind = device_kind(dev)

    spaces = [ss.sweep_space(kernel_id, device=dev, **sh)
              for sh in shape_list]
    space_fps = [ts.space_fingerprint(sp) for sp in spaces]
    shape_sigs = [ts.shape_signature(sp.args) for sp in spaces]
    cand_lists = [sp.candidates() for sp in spaces]
    for sp, cands in zip(spaces, cand_lists):
        if sp.default not in cands:
            cands.append(sp.default)
    n_candidates = sum(len(c) for c in cand_lists)

    # -- phase 1: capture missing traces (workers) ----------------------
    t0 = time.perf_counter()
    tasks = []
    for i, (sh, sig, sfp, sp, cands) in enumerate(
            zip(shape_list, shape_sigs, space_fps, spaces, cand_lists)):
        stored = (store.load(kernel_id, sig, sfp)
                  if reuse_traces else None)
        have = set(stored.entries) if stored is not None else set()
        missing = [c for c in cands if ts.config_key(c) not in have
                   and (budget is None or sp.resources is None
                        or not budget.violations(sp.resources(c)))]
        for part in _chunked(missing, chunk):
            tasks.append({"phase": "capture", "kernel": kernel_id,
                          "shape": sh, "shape_idx": i, "configs": part,
                          "walk": walk, "cache_dir": cache.root,
                          "space_fp": sfp, "calibration": (),
                          "device": dev})
    n_captured = sum(r.get("captured", 0)
                     for r in _run_tasks(tasks, workers))
    price_wall = time.perf_counter() - t0
    traces = [store.load(kernel_id, sig, sfp)
              for sig, sfp in zip(shape_sigs, space_fps)]
    for i, tr in enumerate(traces):
        if tr is None:
            raise RuntimeError(
                f"sweep capture produced no trace for shape "
                f"{shape_list[i]} (store {store.root})")

    # -- phase 2: one calibration run, transferred to every shape ------
    scale = None
    calib_runs = 0
    if calibrate:
        sp0, tr0 = spaces[0], traces[0]
        # the captured candidate with the MOST grid steps: fine tiles see
        # the most causal-skip structure, which the flat price cannot see
        pick = min((c for c in cand_lists[0]
                    if ts.config_key(c) in tr0.entries),
                   key=lambda c: (-tr0.entries[ts.config_key(c)].grid_steps,
                                  ts.price(tr0, c, mode="flat"),
                                  ts.config_key(c)),
                   default=sp0.default)
        engine = DSEEngine(sp0, budget=None, cache=cache,
                           cycle_source=cycle_source, r0=steps,
                           max_steps=steps)
        trial = engine.analyze(pick)
        engine.measure_tiles(trial)
        calib_runs = 1
        scale = engine.calibrate([trial])

    # -- phase 3: simulate every candidate from the artifacts ----------
    t0 = time.perf_counter()
    ranked: List[List[Tuple[int, Dict[str, Any]]]] = []
    outcomes: List[SweepShapeOutcome] = []
    n_pruned = n_priced = 0
    for sh, sp, tr, cands in zip(shape_list, spaces, traces, cand_lists):
        rows = []
        pruned_here = 0
        for cfg in cands:
            entry = tr.entries.get(ts.config_key(cfg))
            if entry is None or (budget is not None and budget.violations(
                    ts.entry_resources(entry))):
                pruned_here += 1
                continue
            rows.append((ts.price(entry, mode="flat"), cfg))
        rows.sort(key=lambda rc: (rc[0], ts.config_key(rc[1])))
        ranked.append(rows)
        n_pruned += pruned_here
        n_priced += len(rows)
        outcomes.append(SweepShapeOutcome(
            shape=sh, n_candidates=len(cands), n_pruned=pruned_here,
            default_config=dict(sp.default)))
    sim_wall = time.perf_counter() - t0

    # -- phase 4: measure only the finalists (workers, shared cache) ---
    per_shape = max(2, top_k // max(len(shape_list), 1))
    t0 = time.perf_counter()
    tasks = []
    finalists_per_shape: List[List[Dict[str, Any]]] = []
    calib_state = [(k, v) for k, v in _cm.kernel_calibration_state()]
    for i, (sp, rows) in enumerate(zip(spaces, ranked)):
        finalists = [dict(sp.default)]
        for _, cfg in rows:
            if len(finalists) >= per_shape:
                break
            if cfg != sp.default:
                finalists.append(cfg)
        finalists_per_shape.append(finalists)
        parts = (_chunked(finalists, max(1, (len(finalists) + 1) // 2))
                 if workers > 1 else [finalists])
        for part in parts:
            tasks.append({"phase": "measure", "kernel": kernel_id,
                          "shape": shape_list[i], "shape_idx": i,
                          "configs": part, "steps": steps,
                          "cache_dir": cache.root,
                          "cycle_source": cycle_source,
                          "calibration": calib_state, "device": dev})
    n_measured = n_cache_hits = 0
    measured: List[Dict[str, List]] = [{"rows": []} for _ in shape_list]
    for res in _run_tasks(tasks, workers):
        n_measured += res["measurements"]
        n_cache_hits += res["cache_hits"]
        measured[res["shape_idx"]]["rows"].extend(res["rows"])
    measure_wall = time.perf_counter() - t0

    for i, (sp, o) in enumerate(zip(spaces, outcomes)):
        rows = measured[i]["rows"]
        if not rows:
            continue
        best = min(rows, key=lambda r: (r["cycles"],
                                        ts.config_key(r["config"])))
        for r in rows:
            if r["config"] == sp.default:
                o.default_cycles = r["cycles"]
                if keeps_default(r["cycles"], best["cycles"],
                                 max(r["spread"], best["spread"])):
                    best = r
                break
        o.best_config, o.best_cycles = dict(best["config"]), best["cycles"]
        # each shape's winner, applied by --autotune at that shape only
        cache.set_winner(kernel_id, dkind, o.best_config,
                         cycles_per_step=o.best_cycles,
                         shape=tuning.shape_key(kernel_id,
                                                tensors(sp.args)))

    return SweepResult(
        kernel_id=kernel_id, device=dkind, shapes=outcomes,
        n_candidates=n_candidates, n_captured=n_captured,
        n_pruned=n_pruned, n_priced=n_priced,
        n_finalists=sum(len(f) for f in finalists_per_shape),
        n_measured=n_measured, n_cache_hits=n_cache_hits,
        n_calibration_runs=calib_runs, calibration_scale=scale,
        workers=workers, top_k=top_k, price_wall_s=price_wall,
        sim_wall_s=sim_wall, measure_wall_s=measure_wall,
        wall_s=time.perf_counter() - t_start)
