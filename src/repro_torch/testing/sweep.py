"""Seeded conformance sweep runner (the nightly 200-graph corpus).

Port of ``repro.testing.sweep``. Runs ``run_conformance`` over a
contiguous seed range and prints one line per graph; every failure ends
with a ready-to-paste repro command so a red nightly log is a complete
bug report (``--device`` defaults to the GPU)::

    PYTHONPATH=src python -m repro_torch.testing.sweep --start 0 --count 200
    PYTHONPATH=src python -m repro_torch.testing.sweep --count 8 \\
        --invariants bit_identity,oracle_equality --device cpu

Exit status is the number of failing seeds (capped at 99), so CI can
gate directly on the process result.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch import resolve_device
from repro_torch.testing.conformance import (INVARIANTS, ConformanceError,
                                             repro_command, run_conformance)
from repro_torch.testing.graphgen import random_spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--start", type=int, default=0,
                    help="first seed (default 0)")
    ap.add_argument("--count", type=int, default=200,
                    help="number of consecutive seeds (default 200)")
    ap.add_argument("--invariants", type=str, default=",".join(INVARIANTS),
                    help="comma-separated invariant subset")
    ap.add_argument("--max-blocks", type=int, default=5,
                    help="max blocks per generated graph")
    ap.add_argument("--keep-going", action="store_true", default=True,
                    help="run every seed even after failures (default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, which must exist)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inv = tuple(s for s in args.invariants.split(",") if s)
    failures = []
    t0 = time.time()
    for seed in range(args.start, args.start + args.count):
        spec = random_spec(seed, max_blocks=args.max_blocks)
        t = time.time()
        try:
            stats = run_conformance(spec, inv, device=dev)
            print(f"seed {seed}: OK — {stats['n_probes']} probes, "
                  f"{stats['cycle']} cycles ({time.time() - t:.1f}s)",
                  flush=True)
        except ConformanceError as e:
            failures.append(seed)
            print(f"seed {seed}: FAIL [{e.invariant}]\n{e}", flush=True)
    n = args.count
    print(f"\n{n - len(failures)}/{n} graphs passed "
          f"({time.time() - t0:.1f}s total)")
    if failures:
        print("failing seeds and repro commands:")
        for seed in failures:
            print(f"  seed {seed}: {repro_command(random_spec(seed))}")
    return min(len(failures), 99)


if __name__ == "__main__":
    sys.exit(main())
