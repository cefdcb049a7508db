"""Intra-kernel grid-step probing: the probe layer below the scope markers.

Port of ``repro.core.kernelprobe``. A hand kernel's call is one region
to the scope markers (``scope.kernel_region``); behind
``ProbeConfig(kernel_probes=...)`` each matched region gets the
reference's subtree ``<scope>/kernel/<body>#i/grid`` (the grid node a
loop whose trip count is the TPU kernel's grid-step product) and the
body's named inner scopes (flash ``init``/``kv_block``/``finalize``,
SSD ``init``/``sub_chunk``, paged ``copy_pages``/``attend``).

The JAX package walks the Pallas body's jaxpr per grid step with a
scalar environment, so that a ``pl.when`` whose predicate depends on the
grid prices the branch the step takes (``walk_step``). A CUDA kernel has
no such body to walk, so each kernel wrapper declares a ``GridPlan``:

- the body name (``flash_kernel``, ``ssd_kernel``, ``paged_kernel``:
  the Pallas body names without their leading ``_``, as
  ``pallas_kernel_name`` intends);
- the TPU kernel's logical grid at the port's tiles, sequential in the
  TPU kernel's order (last axis fastest, ``unravel``);
- the per-step transfer term at the grid node (``costmodel.
  transfer_cycles`` of the step's blocks: one definition, read by the
  capture, the run and the oracle alike);
- the inner scopes in body order, each with a *rule* that picks, per
  step, one entry of its cost table from the step's grid coordinates
  and the kernel's counter block, as the reference resolves ``pl.when``:

  ========  ====================================================
  CONST     entry 0 at every step
  FIRST     entry 1 at the first step of the last axis, else 0
  LAST      entry 1 at the last step of the last axis, else 0
  BELOW     entry 1 while the last coordinate is below the row's
            count (counter block (..., 2), column 1), else 0
  AT_END    entry 1 at the row's last counted step, else 0
  COUNT     entry ``counters[step]``
  SLOTS     entry = the slots read inside the step's slot range,
            summed over the counter block's (row, head, tile)
            counts of slots read from each tile's start
  ========  ====================================================

  (entries clamped into the table). Every step enters every scope, as
  the reference's walk does; a scope whose branch is not taken costs
  its table's entry 0.

The counter block comes from the kernel on the card (the plain version
writes the same counts on the CPU), and one ``probe_grid`` launch
(``kernels.probe_events``) folds the grid's steps into the probe state.
The oracle (``core.oracle``) takes the counts the plan implies from the
*inputs* instead (``GridPlan.expected``), never the device's counter
block, so device record == oracle checks that the kernel skipped what
the plan says. The run's host mirror of the clock takes the same counts
from values the host already holds (``GridPlan.mirror``), so a run
reads nothing back from the device.

Only ``cycle_source="model"`` is supported, as in the reference: grid
steps inside one kernel launch have no timestamps of their own.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

KERNEL_SEG = "kernel"          # path segment grouping kernels per scope
GRID_SEG = "grid"              # the per-kernel grid loop node

# a scope's rule (the codes of csrc/probe_events.cu)
CONST, FIRST, LAST, BELOW, AT_END, COUNT, SLOTS = range(7)


def matches(kernel_probes: Sequence[str], name: str) -> bool:
    return any(p == "*" or p == name for p in kernel_probes)


def unravel(it: int, grid: Tuple[int, ...]) -> List[int]:
    """Grid coordinates of sequential step ``it`` (last axis fastest:
    the Pallas sequential-grid order)."""
    idxs: List[int] = []
    rem = it
    for g in reversed(grid):
        idxs.append(rem % g)
        rem = rem // g
    return list(reversed(idxs))


@dataclass(frozen=True)
class GridScope:
    """One named scope of a kernel body: its rule, its cycles per rule
    entry, and the TPU body's stores and products under it (its
    ``n_eqns``, which the inlining policies read)."""
    name: str
    rule: int
    table: Tuple[int, ...]
    ops: int = 1


@dataclass(frozen=True, eq=False)
class GridPlan:
    """What a kernel wrapper declares for grid-step probing (see the
    module docstring). ``expected()`` is the counter block the inputs
    imply (it may read an input from the device: the oracle's view);
    ``mirror()`` is the same block from values the host already holds
    (the run's view: it never reads the device, and raises where the
    caller gave it nothing to read). ``geom`` is the SLOTS rule's
    (heads, tiles, slots per tile, slots per step)."""
    body: str
    grid: Tuple[int, ...]
    transfer: int
    scopes: Tuple[GridScope, ...]
    counter_shape: Tuple[int, ...]
    expected: Callable[[], np.ndarray]
    mirror: Callable[[], np.ndarray]
    geom: Tuple[int, int, int, int] = (0, 0, 0, 0)

    @functools.cached_property
    def steps(self) -> int:
        return int(np.prod(self.grid))

    def variants(self, counters) -> np.ndarray:
        """(steps, scopes) int64: each step's table entry per scope."""
        steps, last = self.steps, self.grid[-1]
        s = np.arange(steps, dtype=np.int64)
        row, col = s // last, s % last
        cnt = np.asarray(counters, np.int64).reshape(-1)
        out = np.zeros((steps, len(self.scopes)), np.int64)
        for j, sc in enumerate(self.scopes):
            if sc.rule == CONST:
                v = np.zeros(steps, np.int64)
            elif sc.rule == FIRST:
                v = col == 0
            elif sc.rule == LAST:
                v = col == last - 1
            elif sc.rule == BELOW:
                v = col < cnt[row * 2 + 1]
            elif sc.rule == AT_END:
                v = col == cnt[row * 2 + 1] - 1
            elif sc.rule == COUNT:
                v = cnt[s]
            elif sc.rule == SLOTS:
                v = self._slots(cnt, row, col)
            else:
                raise ValueError(f"unknown rule {sc.rule}")
            out[:, j] = np.clip(np.asarray(v, np.int64), 0, len(sc.table) - 1)
        return out

    def _slots(self, cnt, row, col) -> np.ndarray:
        kv, nt, tile, sps = self.geom
        rows = self.steps // self.grid[-1]
        c = np.clip(cnt[:rows * kv * nt].reshape(rows, kv, nt)[row], 0,
                    tile)                                 # (steps, kv, nt)
        t0 = np.arange(nt, dtype=np.int64) * tile
        lo, hi = (col * sps)[:, None, None], (col * sps + sps)[:, None, None]
        read = np.minimum(hi, t0 + c) - np.maximum(lo, t0)
        return np.clip(read, 0, None).sum(axis=(1, 2))

    def step_cycles(self, counters) -> np.ndarray:
        """(steps, scopes) int64: each scope's cycles at each step."""
        v = self.variants(counters)
        out = np.empty_like(v)
        for j, sc in enumerate(self.scopes):
            out[:, j] = np.asarray(sc.table, np.int64)[v[:, j]]
        return out

    def cycles(self, counters) -> int:
        """Model cycles of the whole grid for this counter block."""
        return int(self.steps * self.transfer
                   + self.step_cycles(counters).sum())

    def signature(self) -> Tuple[Any, ...]:
        """What the capture holds of a plan: a later visit of the same
        kernel region must declare the same."""
        return (self.body, self.grid, self.transfer, self.scopes,
                self.counter_shape, self.geom)


def kernel_path(parent: str, body: str, index: int) -> str:
    base = f"{parent}/{KERNEL_SEG}" if parent else KERNEL_SEG
    return f"{base}/{body}#{index}"


def grid_paths(kpath: str, plan: GridPlan) -> Tuple[str, ...]:
    """The grid node's path, then each inner scope's, in body order."""
    gpath = f"{kpath}/{GRID_SEG}"
    return (gpath,) + tuple(f"{gpath}/{sc.name}" for sc in plan.scopes)
