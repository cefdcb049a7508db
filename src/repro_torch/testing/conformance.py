"""Single-call conformance harness: every exactness contract, one graph.

Port of ``repro.testing.conformance``. ``run_conformance(spec)`` drives
one :class:`~repro_torch.testing.graphgen.GraphSpec` through the port's
full probe pipeline and asserts five invariants the suite otherwise
enforces piecemeal:

1. **bit-identity**: probed outputs equal the unprobed function's
   outputs bit for bit, on the same device with the same kernels (the
   paper's non-intrusiveness claim).
2. **telescoping**: decoded intervals nest: ``0 <= start <= end <=
   cycle``, every ring row has ``s <= e``, fully observed histories sum
   exactly to the probe's total, ancestors bound descendants.
3. **oracle equality**: device counters equal the independent host
   re-run (``pf.oracle``) integer for integer (Table II, 100%
   accuracy), and a kernel graph's grid probes are entered.
4. **session exactness**: N identical ``ProbeSession`` steps aggregate
   to exactly N x the one-shot counters.
5. **overhead bound**: the fitted :class:`~repro_torch.core.overhead.
   OverheadModel` predicts the instrumented run's extra launches within
   the JAX package's tolerance (there: extra HLO equations), and the
   run's copies of spilled rows equal the oracle's count exactly.

The JAX package's sixth invariant, ``packed_vs_legacy`` (both state
layouts decode to the same record), has no counterpart: the port has
one int64 state layout, and ``ProbeConfig(layout="legacy")`` raises.

Failures raise :class:`ConformanceError` carrying the spec JSON and a
ready-to-paste repro command, so a CI line is a full reproduction.

CLI (the repro command format printed on failure; ``--device`` defaults
to the GPU)::

    PYTHONPATH=src python -m repro_torch.testing.conformance --seed 1234
    PYTHONPATH=src python -m repro_torch.testing.conformance --spec '<json>'
    PYTHONPATH=src python -m repro_torch.testing.conformance --seed 7 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.testing.graphgen import GraphSpec, build, random_spec

INVARIANTS = ("bit_identity", "telescoping", "oracle_equality",
              "session_exactness", "overhead_bound")

# overhead-model tolerance: relative to the measured delta with an
# absolute floor (tiny graphs have single-digit extra-launch counts)
OVERHEAD_REL_TOL = 0.15
OVERHEAD_ABS_TOL = 8.0
SESSION_STEPS = 3


def repro_command(spec: GraphSpec) -> str:
    return ("PYTHONPATH=src python -m repro_torch.testing.conformance "
            f"--seed {spec.seed}")


class ConformanceError(AssertionError):
    """One invariant failed; message embeds seed, spec and repro cmd."""

    def __init__(self, spec: GraphSpec, invariant: str, detail: str):
        self.spec = spec
        self.invariant = invariant
        super().__init__(
            f"conformance invariant {invariant!r} failed for seed "
            f"{spec.seed}\n  detail: {detail}\n  spec: {spec.to_json()}\n"
            f"  repro: {repro_command(spec)}")


def _check(spec: GraphSpec, invariant: str, ok: bool, detail: str):
    if not ok:
        raise ConformanceError(spec, invariant, detail)


# ----------------------------------------------------------- invariants

def _full_durations(pf, dec, pid: int) -> Optional[List[int]]:
    """Per-call durations for probe ``pid`` when every call was observed
    (spilled rings reassembled from the sink + in-ring remainder; else
    only when the ring never wrapped). None = partially observed."""
    asg = pf.assignment
    calls = int(dec["calls"][pid])
    ring = np.asarray(dec["ring"][pid])
    if asg.spill[pid]:
        durs = [int(e) - int(s) for s, e in pf.sink.records(pid)]
        rem = calls % asg.depth
        durs += [int(e) - int(s) for s, e in ring[:rem]]
        return durs
    if calls <= asg.depth:
        return [int(e) - int(s) for s, e in ring[:calls]]
    return None


def check_bit_identity(spec: GraphSpec, fn, args, out) -> None:
    out0 = fn(*args)
    _check(spec, "bit_identity", out.shape == out0.shape
           and out.dtype == out0.dtype,
           f"output {tuple(out.shape)} {out.dtype} != unprobed "
           f"{tuple(out0.shape)} {out0.dtype}")
    _check(spec, "bit_identity", torch.equal(out, out0),
           f"output differs: probed={out!r} unprobed={out0!r}")


def check_telescoping(spec: GraphSpec, pf, dec) -> None:
    cycle = int(dec["cycle"])
    paths = pf.probe_paths()
    _check(spec, "telescoping", cycle >= 0, f"negative cycle {cycle}")
    for i, p in enumerate(paths):
        calls = int(dec["calls"][i])
        s, e, t = int(dec["starts"][i]), int(dec["ends"][i]), \
            int(dec["totals"][i])
        if calls == 0:
            _check(spec, "telescoping", (s, e, t) == (0, 0, 0),
                   f"{p}: uncalled probe has nonzero counters {(s, e, t)}")
            continue
        _check(spec, "telescoping", 0 <= s <= e <= cycle,
               f"{p}: interval [{s}, {e}] outside [0, {cycle}]")
        _check(spec, "telescoping", 0 <= t <= cycle,
               f"{p}: total {t} outside [0, {cycle}]")
        durs = _full_durations(pf, dec, i)
        ring = np.asarray(dec["ring"][i])
        for rs, re_ in ring[:min(calls, pf.assignment.depth)]:
            _check(spec, "telescoping", int(rs) <= int(re_),
                   f"{p}: ring row [{int(rs)}, {int(re_)}] reversed")
        if durs is not None:
            _check(spec, "telescoping", len(durs) == calls,
                   f"{p}: {len(durs)} observed durations != {calls} calls")
            _check(spec, "telescoping", sum(durs) == t,
                   f"{p}: observed durations sum {sum(durs)} != total {t}")
        # ancestors bound descendants (same clock, nested scopes)
        for j, q in enumerate(paths):
            if q.startswith(p + "/") and int(dec["calls"][j]) > 0:
                _check(spec, "telescoping",
                       int(dec["totals"][j]) <= t,
                       f"{q}: child total {int(dec['totals'][j])} > "
                       f"parent {p} total {t}")
                _check(spec, "telescoping",
                       int(dec["starts"][j]) >= s and
                       int(dec["ends"][j]) <= e,
                       f"{q}: child interval escapes parent {p}")


def check_oracle_equality(spec: GraphSpec, pf, dec, args) -> None:
    oc = pf.oracle(*args)
    for i, p in enumerate(pf.probe_paths()):
        for key, ov in (("totals", oc.totals[i]), ("calls", oc.calls[i]),
                        ("starts", oc.starts[i]), ("ends", oc.ends[i])):
            _check(spec, "oracle_equality", int(dec[key][i]) == ov,
                   f"{p}: device {key}={int(dec[key][i])} != oracle {ov}")
    _check(spec, "oracle_equality", int(dec["cycle"]) == oc.cycle,
           f"cycle: device {int(dec['cycle'])} != oracle {oc.cycle}")
    if spec.has_kernel:
        # grid rows must cover their kernel scope. A saturated probe
        # budget may legitimately prune the grid candidate (the
        # allocator prefers outer scopes); only when slots remained free
        # is a missing grid probe an instrumenter gap rather than an
        # allocation decision.
        grid_pids = [i for i, p in enumerate(pf.probe_paths())
                     if p.endswith("/grid")]
        budget_full = pf.assignment.n >= spec.max_probes
        _check(spec, "oracle_equality", bool(grid_pids) or budget_full,
               "kernel graph produced no grid probes despite free slots")
        for i in grid_pids:
            _check(spec, "oracle_equality", oc.calls[i] > 0,
                   f"{pf.probe_paths()[i]}: grid probe never entered")


def check_session_exactness(spec: GraphSpec, fn, args, dec, device,
                            steps: int = SESSION_STEPS) -> None:
    from repro_torch.core import ProbeSession
    with ProbeSession(fn, spec.probe_config().replace(offload=1.0),
                      device=device) as s:
        for _ in range(steps):
            s.step(*args)
        snap = s.snapshot()
    for pid, path in enumerate(snap.paths):
        row = snap.rows[pid]
        want_calls = steps * int(dec["calls"][pid])
        want_total = steps * int(dec["totals"][pid])
        _check(spec, "session_exactness", row.calls == want_calls,
               f"{path}: session calls {row.calls} != "
               f"{steps} x one-shot {int(dec['calls'][pid])}")
        _check(spec, "session_exactness", row.total_cycles == want_total,
               f"{path}: session total {row.total_cycles} != "
               f"{steps} x one-shot {int(dec['totals'][pid])}")


def check_overhead_bound(spec: GraphSpec, fn, args, device) -> int:
    from repro_torch.core.overhead import OverheadModel, measure_overhead
    from repro_torch.core.pragma import probe
    base = spec.probe_config()
    variants = [base.replace(max_probes=m) for m in (2, 3, 4, 6)]
    variants.append(base.replace(max_probes=50, buffer_depth=2))
    variants.append(base)
    # one capture serves every variant (retargeted, as incremental
    # synthesis reuses it)
    opf = probe(fn, base, device=device)
    samples = [measure_overhead(fn, args, v, device=device, pf=opf)
               for v in variants]
    for v, smp in zip(variants, samples):
        _check(spec, "overhead_bound", smp["copies"] == smp["spill_copies"],
               f"max_probes={v.max_probes} depth={v.buffer_depth}: "
               f"{smp['copies']} copies of spilled rows, the oracle's "
               f"{smp['spill_copies']}")
    model = OverheadModel.fit(samples)
    for v, smp in zip(variants, samples):
        pred = model.predict_eqns(smp)
        actual = float(smp["extra_eqns"])
        tol = max(OVERHEAD_REL_TOL * abs(actual), OVERHEAD_ABS_TOL)
        _check(spec, "overhead_bound", abs(pred - actual) <= tol,
               f"max_probes={v.max_probes} depth={v.buffer_depth}: "
               f"predicted {pred:.1f} vs measured {actual:.0f} "
               f"(tol {tol:.1f})")
    return len(samples)


# -------------------------------------------------------------- harness

def run_conformance(spec: GraphSpec,
                    invariants: Sequence[str] = INVARIANTS,
                    device=None) -> Dict[str, Any]:
    """Assert the selected invariants for one graph on ``device`` (the
    GPU unless 'cpu' is asked); returns summary stats (probe count,
    cycle span, invariants checked) on success."""
    from repro_torch.core import decode_record, probe

    unknown = set(invariants) - set(INVARIANTS)
    if unknown:
        raise ValueError(f"unknown invariants: {sorted(unknown)}")
    dev = resolve_device(device)
    fn, args = build(spec, device=dev)
    pf = probe(fn, spec.probe_config(), device=dev)
    out, rec = pf(*args)
    dec = decode_record(rec)
    checked: List[str] = []
    if "bit_identity" in invariants:
        check_bit_identity(spec, fn, args, out)
        checked.append("bit_identity")
    if "telescoping" in invariants:
        check_telescoping(spec, pf, dec)
        checked.append("telescoping")
    if "oracle_equality" in invariants:
        check_oracle_equality(spec, pf, dec, args)
        checked.append("oracle_equality")
    if "session_exactness" in invariants:
        check_session_exactness(spec, fn, args, dec, dev)
        checked.append("session_exactness")
    if "overhead_bound" in invariants:
        check_overhead_bound(spec, fn, args, dev)
        checked.append("overhead_bound")
    return {
        "seed": spec.seed,
        "n_probes": pf.assignment.n,
        "cycle": int(dec["cycle"]),
        "has_kernel": spec.has_kernel,
        "invariants": tuple(checked),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--seed", type=int, help="run random_spec(seed)")
    g.add_argument("--spec", type=str, help="run an explicit GraphSpec "
                                            "JSON document")
    ap.add_argument("--invariants", type=str, default=",".join(INVARIANTS),
                    help="comma-separated subset to check")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, which must exist)")
    args = ap.parse_args(argv)
    spec = (GraphSpec.from_json(args.spec) if args.spec is not None
            else random_spec(args.seed))
    inv = tuple(s for s in args.invariants.split(",") if s)
    try:
        stats = run_conformance(spec, inv, device=args.device)
    except ConformanceError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"seed {stats['seed']}: OK — {stats['n_probes']} probes, "
          f"{stats['cycle']} cycles, "
          f"invariants: {', '.join(stats['invariants'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
