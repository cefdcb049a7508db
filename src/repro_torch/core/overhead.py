"""Analytical instrumentation-overhead model (paper §IV-D).

Port of ``repro.core.overhead``. The paper budgets LUT/FF as

    C_axi + C_pc + C_decode*log2(N) + Σ_i (C_1 + C_2 * D_i)

The JAX package spends "resource" as extra HLO equations and on-device
state bytes; an eager PyTorch program has no HLO, and what the probe
adds to it is launches: the instrumented run's ``probe_events`` launches
(one a scope transition), ``probe_grid`` folds (one a kernel-probed
call) and the copies of spilled ring rows (one a filled ring; one for a
kernel call's spilled grid rows). So here

    extra_eqns(N, D, E, ...)  =  those launches a call, against
    base_eqns                 =  the program's own operations a call
                                 (aten operations, each hand-kernel call
                                 one, as ``incremental.capture_ops``
                                 counts them)
    state_bytes(N, D)         =  8 + N*(32 + 16*D)   (``buffer.state_bytes``)

where N = probes, D = ring depth, E = static event sites. The linear
``OverheadModel`` is fitted to measured samples as the JAX package fits
its own (the same features, the same least squares) over the launches;
the copies are not fitted. The JAX package's spill is a static ``cond``
at each exit site of a spilled probe, whatever the depth; here each
ring that fills is a copy at run time, so halving the depth doubles
them, which no static feature sees. The oracle counts them from its
own run (``OracleCounters.copies``, not the instrumented run's
counter): ``spill_copies``, which the model adds as it stands, and
which ``testing.conformance`` holds the measured ``copies`` to exactly.
Samples without spill fit JAX's coefficients bit for bit. And
``adapt_allocation`` shrinks depth, then probes, to fit a state budget
(the paper's "adjusts the number of profiling modules and queue
depths").

``count_sites`` counts the instrumented program's static structure from
one run: the distinct scope transitions it makes (each (from, to) pair
once, however often it runs: a site, as the JAX package counts an
equation boundary once in the jaxpr) and their enter/exit events, plus
the loop and kernel-grid probes' own events; ``cf_sites`` is the loop,
while, cond and grid nodes of the hierarchy that hold a probe (the
control flow whose iterations the probe follows).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.buffer import state_bytes
from repro_torch.core.instrument import Runner
from repro_torch.core.pragma import ProbeConfig, ProbedFunction, probe


class _SiteRunner(Runner):
    """An instrumented run that also records its distinct transitions."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.moves: Dict[Tuple[str, str], int] = {}

    def _move(self, old: str, new: str) -> None:
        a, b = self.asg.chain(old), self.asg.chain(new)
        i = 0
        while i < len(a) and i < len(b) and a[i] == b[i]:
            i += 1
        if len(a) - i + len(b) - i:
            self.moves[(old, new)] = len(a) - i + len(b) - i
        super()._move(old, new)

    def frame_open(self, f):
        if f.loop_path is not None and self.asg.id_of(f.loop_path) \
                is not None:
            self.moves[("loop", f.loop_path)] = 2
        super().frame_open(f)


def count_sites(pf: ProbedFunction, args: Sequence[Any] = (),
                kwargs=None) -> Dict[str, int]:
    """Static structure of the instrumented program (see the module
    docstring): ``event_sites`` (enter/exit emissions at distinct
    transitions), ``transitions`` (distinct transitions, each one
    ``probe_events`` launch site) and ``cf_sites`` (probed control
    flow). Runs ``pf``'s function once, instrumented, on a fresh state;
    ``pf`` must have been built for ``args``."""
    kwargs = kwargs or {}
    pf.ensure_built(*args, **kwargs)
    run = _SiteRunner(pf.hierarchy, pf.assignment, pf.init_state(),
                      cycle_source=pf.config.cycle_source, sink=None,
                      calls=[0] * pf.assignment.n)
    with run:
        pf.fn(*args, **kwargs)
    probed = set(pf.assignment.paths)
    cf = 0
    for node in pf.hierarchy.root.walk():
        if node.kind in ("loop", "while", "cond") and any(
                p == node.path or p.startswith(node.path + "/")
                for p in probed):
            cf += 1
    return dict(event_sites=sum(run.moves.values()),
                transitions=len(run.moves), cf_sites=cf)


def count_event_sites(pf: ProbedFunction, args: Sequence[Any] = ()) -> int:
    """Static enter/exit emission sites in the instrumented program."""
    return count_sites(pf, args)["event_sites"]


def measure_overhead(fn, args, cfg: ProbeConfig, device=None,
                     pf: ProbedFunction = None) -> Dict[str, Any]:
    """Measured instrumentation cost of ``fn(*args)`` under ``cfg``: the
    extra launches of one instrumented call (``probe_events``,
    ``probe_grid``, spill ``copies``) beside the program's own
    operations, the oracle's count of the copies (``spill_copies``) and
    the state bytes. ``pf`` (a ``ProbedFunction`` of ``fn`` already
    captured for ``args``) is retargeted to ``cfg`` and reused."""
    from repro_torch.core.incremental import capture_ops
    base_eqns = len(capture_ops(fn, args))
    if pf is None:
        pf = probe(fn, cfg, device=device)
    else:
        pf.retarget(cfg)
    pf(*args)
    run = pf.last_run
    extra = run["launches"] + run["folds"] + run["copies"]
    n = pf.assignment.n
    sites = count_sites(pf, args)
    return dict(
        base_eqns=base_eqns,
        inst_eqns=base_eqns + extra,
        extra_eqns=extra,
        n_probes=n,
        depth=cfg.buffer_depth,
        event_sites=sites["event_sites"],
        transitions=sites["transitions"],
        cf_sites=sites["cf_sites"],
        copies=run["copies"],
        spill_copies=(pf.oracle(*args).copies if any(pf.assignment.spill)
                      else 0),
        state_bytes=state_bytes(n, cfg.buffer_depth),
    )


@dataclass
class OverheadModel:
    """extra_eqns ~ c0 + c1*n_probes + c2*event_sites + c3*transitions
    + c4*cf_sites + spill_copies (the JAX package's model and fit, with
    the oracle's spill copies added as they stand, not fitted).

    ``cf_sites`` prices control-flow-heavy configs; ``n_probes`` is the
    paper's per-probe term (Σ_i C_1 + C_2·D_i).
    """
    coefs: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)

    @staticmethod
    def features(sample: Dict[str, Any]) -> List[float]:
        return [1.0, float(sample.get("n_probes", 0)),
                float(sample["event_sites"]),
                float(sample.get("transitions",
                                 sample["event_sites"])),
                float(sample.get("cf_sites", 0))]

    @classmethod
    def fit(cls, samples: Sequence[Dict[str, Any]]) -> "OverheadModel":
        X = np.array([cls.features(s) for s in samples])
        y = np.array([s["extra_eqns"] - s.get("spill_copies", 0)
                      for s in samples], dtype=float)
        coefs, *_ = np.linalg.lstsq(X, y, rcond=None)
        return cls(coefs=tuple(float(c) for c in coefs))

    def predict_eqns(self, sample: Dict[str, Any]) -> float:
        return float(np.dot(self.coefs, self.features(sample))) \
            + sample.get("spill_copies", 0)

    @staticmethod
    def predict_state_bytes(n_probes: int, depth: int) -> int:
        return state_bytes(n_probes, depth)


def adapt_allocation(n_candidates: int, depth: int, budget_bytes: int
                     ) -> Tuple[int, int]:
    """Paper §IV-D resource-allocation adaptation: fit (N, D) under a
    state-byte budget, preferring to keep probes and shrink depth."""
    d = depth
    while d > 1 and state_bytes(n_candidates, d) > budget_bytes:
        d //= 2
    n = n_candidates
    while n > 1 and state_bytes(n, d) > budget_bytes:
        n -= 1
    return n, d
