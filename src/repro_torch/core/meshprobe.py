"""Mesh-aware probing: per-device cycle records for sharded programs.

Port of ``repro.core.meshprobe``. ``probe()`` observes ONE device; a
sharded program is trustworthy only when every parallel instance is
observed (a straggler is invisible in one device's record, and
communication is invisible in a compute-only cost model).

A JAX ``shard_map`` over N devices is N processes here, one a device,
over ``torch.distributed`` (``launch.mesh.spawn``): each rank runs the
per-shard body on its own shard of the global arguments, and the body's
collectives go through ``distributed.compat`` (functional collectives a
capture sees and prices). So:

- ``mesh_probe(fn, mesh, in_specs, out_specs)`` captures the per-shard
  body ONCE on every rank, all ranks in lockstep (the capture runs the
  real collectives), and runs it instrumented on each rank's shard. The
  ``ProbeState`` of a rank has a leading device axis of 1: row 0 is this
  device's counters. Counters never touch model values, so outputs stay
  bitwise the ``unprobed()`` run's, per shard.
- cycle counts use the model clock with the **collective term**
  (``costmodel.collective_axis_sizes``): an all-reduce over a G-device
  axis costs its ring-model wire bytes, so per-device cycles respond to
  the mesh shape.
- ``CycleRecord`` is the device-major record: each rank's row
  all-gathered (so ``decode``, ``report`` and a session's windows are
  collective calls that every rank makes together) and decoded row by
  row through ``decode_record``, with cross-device reductions
  (``max`` / ``mean`` / ``per-device``) and the straggler signal
  ``skew = max - min``.
- ``MeshProbedFunction.collectives()`` joins the capture's collectives
  against the ring wire-byte model (``launch.collectives``).
- ``ShardOracle`` replays one device's shard with Python integer
  counters, live-priced as the single-device ``Oracle``. Collectives are
  stubbed shape-faithfully (all-reduce and permute pass their operands
  through, the others return zeros) and ``axis_index`` is the replayed
  device's coordinate (``compat.replay_context``), so one rank, or a
  process with no process group at all (``shard_oracle``), can replay
  any device without its peers. Device rows must equal it EXACTLY.
- ``MeshProbeSession`` keeps the per-device counters running across a
  loop (one capture for its life, constant memory), feeding per-window
  per-device deltas into a device-major ``StreamAggregator`` published
  on the bus.

Spills are off under a mesh (``offload=0``, as in JAX), so per-call
history is each probe's ring; the counters stay exact. Only
``cycle_source="model"`` is supported.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import report as report_mod
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.instrument import TOTALS, ProbeAssignment, decode_record
from repro_torch.core.oracle import Oracle, OracleCounters
from repro_torch.core.pragma import ProbeConfig, ProbedFunction
from repro_torch.core.streaming import StreamAggregator
from repro_torch.distributed import compat
from repro_torch.distributed.compat import (P, flat_specs, shard_slice,
                                            tree_leaves, tree_unflatten)
from repro_torch.launch.collectives import (PRIMITIVE_KINDS, WAIT,
                                            CollectiveSite,
                                            captured_collectives, op_name)

__all__ = ["P", "CycleRecord", "decode_mesh_record", "ShardOracle",
           "shard_oracle", "MeshProbedFunction", "mesh_probe", "MeshReport",
           "MeshSnapshot", "MeshProbeSession"]


# ------------------------------------------------------- decoded record

@dataclass
class CycleRecord:
    """Per-device decoded counter state of one mesh-probed program.

    Row ``d`` of every array belongs to the device at mesh coordinate
    ``np.unravel_index(d, mesh_shape)`` (mesh axes in order): rank d.
    """
    mesh_axes: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    paths: Tuple[str, ...]
    cycle: np.ndarray             # (D,)      global span per device
    starts: np.ndarray            # (D, n)
    ends: np.ndarray              # (D, n)
    totals: np.ndarray            # (D, n)
    calls: np.ndarray             # (D, n)
    ring: np.ndarray              # (D, n, depth, 2)

    REDUCTIONS = ("per-device", "max", "mean")

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh_shape))

    def coords(self, device: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in
                     np.unravel_index(device, self.mesh_shape))

    def device(self, device: int) -> Dict[str, Any]:
        """Single-device view, shaped like ``decode_record``'s output."""
        return {"cycle": int(self.cycle[device]),
                "starts": self.starts[device], "ends": self.ends[device],
                "totals": self.totals[device], "calls": self.calls[device],
                "ring": self.ring[device]}

    def reduce(self, mode: str = "max") -> np.ndarray:
        """Cross-device reduction of per-probe total cycles."""
        if mode == "per-device":
            return self.totals
        if mode == "max":
            return self.totals.max(axis=0)
        if mode == "mean":
            return self.totals.mean(axis=0)
        raise ValueError(f"unknown reduction {mode!r}; "
                         f"expected one of {self.REDUCTIONS}")

    def skew(self) -> np.ndarray:
        """Per-probe max−min total cycles across devices — the
        straggler signal (0 everywhere = perfectly balanced)."""
        return self.totals.max(axis=0) - self.totals.min(axis=0)

    def straggler(self) -> Tuple[int, str]:
        """(device, probe path) of the worst cell by total cycles.
        ``(0, "")`` when no probes were selected."""
        if self.totals.size == 0:
            return 0, ""
        d, p = np.unravel_index(int(self.totals.argmax()),
                                self.totals.shape)
        return int(d), self.paths[int(p)]

    def row(self, path: str, device: Optional[int] = None):
        pid = self.paths.index(path)
        col = self.totals[:, pid]
        return col if device is None else int(col[device])


def decode_mesh_record(state: Dict[str, Any], mesh_axes: Sequence[str],
                       mesh_shape: Sequence[int],
                       paths: Sequence[str]) -> CycleRecord:
    """Decode a device-major ProbeState (leading device axis, on the
    host) into a :class:`CycleRecord`, row by row through
    ``decode_record`` — the single place that knows the counter layout."""
    n_dev = int(np.prod(tuple(mesh_shape)))
    per_dev = [decode_record({k: np.asarray(v)[d] for k, v in state.items()})
               for d in range(n_dev)]
    return CycleRecord(
        mesh_axes=tuple(mesh_axes), mesh_shape=tuple(mesh_shape),
        paths=tuple(paths),
        cycle=np.array([r["cycle"] for r in per_dev], np.int64),
        starts=np.stack([r["starts"] for r in per_dev]),
        ends=np.stack([r["ends"] for r in per_dev]),
        totals=np.stack([r["totals"] for r in per_dev]),
        calls=np.stack([r["calls"] for r in per_dev]),
        ring=np.stack([r["ring"] for r in per_dev]))


def _all_rows(t: torch.Tensor, env: compat.MeshEnv) -> np.ndarray:
    """Every device's ``t`` (leading axis 1 on each), device-major, on
    the host: one gather over the whole mesh."""
    if env.replay or int(np.prod(env.shape)) == 1:
        return t.detach().cpu().numpy()
    with compat.mesh_context(env):
        return compat.host_gather(t, env.axes, 0).cpu().numpy()


# ------------------------------------------------------- shard oracle

class ShardOracle(Oracle):
    """Replay ONE device's shard with Python integer counters.

    Collectives cannot run without their peers, so they are stubbed
    shape-faithfully: all-reduce, a permute and ``wait_tensor`` pass
    their operand through, the others return zeros of the output's
    shape, and ``axis_index`` is the replayed device's mesh coordinate.
    Each operation is priced live on its real shapes (the collective
    term with the mesh's axis sizes), so the replayed counters are exact
    as long as control flow does not branch on collective *values*."""

    _PASSTHROUGH = {"all-reduce", "collective-permute"}

    def __init__(self, assignment: ProbeAssignment,
                 mesh_axes: Sequence[str], mesh_shape: Sequence[int],
                 coords: Sequence[int], kernel_probes: Sequence[str] = (),
                 device=None):
        super().__init__(assignment, kernel_probes)
        self.mesh_axes = tuple(mesh_axes)
        self.mesh_shape = tuple(int(s) for s in mesh_shape)
        self.coords = tuple(int(c) for c in coords)
        self.device = device

    def run(self, fn, *args, **kwargs) -> OracleCounters:
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        env = compat.current()
        if env is not None and env.mesh is not None and any(
                compat.is_dtensor(a)
                for a in compat.tree_leaves((args, kwargs))):
            # DTensor arguments hold this device's blocks: the replay is
            # of this device, on its mesh, so the program places its
            # values as it did (collectives still stubbed, in ``_bind``)
            if tuple(env.coords) != self.coords:
                raise ValueError("a program over DTensors replays the "
                                 "device it runs on only")
            ctx = compat.mesh_context(env)
        else:
            ctx = compat.replay_context(self.mesh_axes, self.mesh_shape,
                                        self.coords, self.device)
        with ctx, cm.collective_axis_sizes(sizes):
            return super().run(fn, *args, **kwargs)

    def _bind(self, func, args, kwargs):
        if func.namespace not in ("_c10d_functional", "c10d"):
            return func(*args, **kwargs)
        name = op_name(func)
        x = args[0]
        if name == WAIT:
            return x.clone()
        if name == "_c10d_functional._wrap_tensor_autograd":
            return func(*args, **kwargs)     # autograd's wrapper, no peer
        kind = PRIMITIVE_KINDS.get(name)
        if kind == "all-to-all" and compat.is_permute():
            kind = "collective-permute"
        if kind in self._PASSTHROUGH:
            return x.clone()
        if name == "_c10d_functional.all_gather_into_tensor":
            return x.new_zeros((x.shape[0] * int(args[1]),) +
                               tuple(x.shape[1:]))
        if name == "_c10d_functional.reduce_scatter_tensor":
            return x.new_zeros((x.shape[0] // int(args[2]),) +
                               tuple(x.shape[1:]))
        if name == "_c10d_functional.all_to_all_single":
            return x.new_zeros((int(sum(args[1])),) + tuple(x.shape[1:]))
        raise NotImplementedError(f"ShardOracle cannot stub {name}")


def _coords(device: int, shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(c) for c in np.unravel_index(device, tuple(shape)))


def _shard_args(args, in_specs, axes, shape, coords):
    specs = flat_specs(in_specs, args, "in_specs")
    sizes = dict(zip(axes, shape))
    where = dict(zip(axes, coords))
    return tree_unflatten(args, [shard_slice(a, s, sizes, where)
                                 for a, s in zip(tree_leaves(args), specs)])


def shard_oracle(fn: Callable, args: tuple, in_specs,
                 mesh_axes: Sequence[str], mesh_shape: Sequence[int],
                 paths: Sequence[str], *, device: int = 0, depth: int = 4,
                 kernel_probes: Sequence[str] = (),
                 torch_device=None) -> OracleCounters:
    """Replay device ``device`` of ``fn`` over the global ``args`` with
    no process group: the probes ``paths`` (a rank's
    ``probe_paths()``), ring ``depth``, and the device's shard."""
    asg = ProbeAssignment(paths=tuple(paths), depth=int(depth),
                          spill=(False,) * len(paths))
    coords = _coords(device, mesh_shape)
    shard = _shard_args(tuple(args), in_specs, tuple(mesh_axes),
                        tuple(mesh_shape), coords)
    return ShardOracle(asg, mesh_axes, mesh_shape, coords, kernel_probes,
                       device=torch_device).run(fn, *shard)


# ------------------------------------------------- mesh-probed function

class MeshProbedFunction:
    """Instrumented wrapper around a per-shard (shard_map-style) body.

    Mirrors ``ProbedFunction``'s surface — ``__call__`` returns
    ``(outputs, state)``, ``stateful_call`` threads the caller's state,
    ``report``/``oracle`` verify — with every counter kept once a device
    (this rank's row; ``decode`` gathers the others). Positional
    arguments only (the shard_map convention). Arguments are global:
    each rank slices its shard (a view), and the outputs an ``out_specs``
    entry shards are gathered back; the rest are this rank's values.
    Every rank calls every method that reads the others' rows
    (``decode``, ``report``, a session's windows) together."""

    def __init__(self, fn: Callable, mesh, in_specs, out_specs,
                 config: ProbeConfig = ProbeConfig(), *, device=None):
        if config.cycle_source != "model":
            raise ValueError("mesh_probe supports cycle_source='model' only "
                             "(a wall clock per rank would time the host's "
                             "launches, not the collective's wait)")
        if config.offload:
            config = config.replace(offload=0.0)   # no host spill in-mesh
        self.fn = fn
        self.mesh = mesh
        self.env = compat.env_of(mesh, device)
        self.config = config
        self.in_specs = in_specs
        self.out_specs = out_specs
        self.mesh_axes: Tuple[str, ...] = self.env.axes
        self.axis_sizes: Dict[str, int] = self.env.sizes
        self.mesh_shape: Tuple[int, ...] = self.env.shape
        self.n_devices = int(np.prod(self.mesh_shape))
        self.device = self.env.device
        self.pf = ProbedFunction(fn, config, device=self.device)
        self._checked = False
        self.timings: Dict[str, float] = {}

    def _ctx(self):
        stack = contextlib.ExitStack()
        stack.enter_context(compat.mesh_context(self.env))
        stack.enter_context(cm.collective_axis_sizes(self.axis_sizes))
        return stack

    def _shard(self, args):
        return _shard_args(tuple(args), self.in_specs, self.mesh_axes,
                           self.mesh_shape, self.env.coords)

    def _gather(self, out):
        specs = flat_specs(self.out_specs, out, "out_specs")
        return tree_unflatten(out, [compat.gather_shard(o, s) for o, s in
                                    zip(tree_leaves(out), specs)])

    # -- capture (stage 2) and probe selection --------------------------
    @property
    def hierarchy(self) -> Hierarchy:
        return self.pf.hierarchy

    def ensure_built(self, *args) -> "MeshProbedFunction":
        if self.pf._assignment is None:
            t0 = time.perf_counter()
            with self._ctx():
                self.pf.ensure_built(*self._shard(args))
            self.timings["build_s"] = time.perf_counter() - t0
            self.timings["capture_s"] = self.pf.capture_seconds
        if not self._checked:
            self._check_paths()
            self._checked = True
        return self

    def _check_paths(self) -> None:
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, self.pf.assignment.paths)
        if any(g != got[0] for g in got):
            raise RuntimeError(
                f"the ranks selected different probes (a per-shard body "
                f"whose scopes differ by device): {got}")

    @property
    def capture_seconds(self) -> float:
        return self.pf.capture_seconds

    # -- public ----------------------------------------------------------
    def __call__(self, *args):
        self.ensure_built(*args)
        return self._run(self.init_state(), args,
                         calls=[0] * self.assignment.n)

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Fresh zeroed counter state: this device's row, leading axis 1."""
        return {k: v[None] for k, v in self.pf.init_state().items()}

    def stateful_call(self, state, *args):
        """One step with caller-owned counter state (the
        ``MeshProbeSession`` substrate; one capture for every step)."""
        self.ensure_built(*args)
        return self._run(state, args)

    def _run(self, state, args, calls=None):
        with self._ctx():
            out, _ = self.pf._run({k: v[0] for k, v in state.items()},
                                  self._shard(args), {}, calls=calls)
            return self._gather(out), state

    def unprobed(self) -> Callable:
        """The reference: the same shards and gathers, no
        instrumentation (for bitwise checks and overhead measurement)."""
        def run(*args):
            with self._ctx():
                return self._gather(self.fn(*self._shard(args)))
        return run

    @property
    def assignment(self) -> ProbeAssignment:
        return self.pf.assignment

    def probe_paths(self) -> Tuple[str, ...]:
        return self.assignment.paths

    # -- verification / reporting ---------------------------------------
    def decode(self, state) -> CycleRecord:
        """The device-major record (a collective call: every rank)."""
        rows = {k: _all_rows(v, self.env) for k, v in state.items()}
        return decode_mesh_record(rows, self.mesh_axes, self.mesh_shape,
                                  self.assignment.paths)

    def oracle(self, *args, device: int = 0) -> OracleCounters:
        """Independent per-shard replay for one device (the ILA check):
        that device's shard of each global argument, replayed with its
        mesh coordinate bound and its collectives stubbed (no peer
        takes part)."""
        self.ensure_built(*args)
        coords = _coords(device, self.mesh_shape)
        shard = _shard_args(tuple(args), self.in_specs, self.mesh_axes,
                            self.mesh_shape, coords)
        return ShardOracle(self.assignment, self.mesh_axes, self.mesh_shape,
                           coords, self.config.kernel_probes,
                           device=self.device).run(self.fn, *shard)

    def collectives(self) -> List[CollectiveSite]:
        """Collective sites of the per-shard program, joined to scope
        paths (the hierarchy ↔ wire-byte model join)."""
        return captured_collectives(self.hierarchy, self.axis_sizes)

    def report(self, state) -> "MeshReport":
        rec = state if isinstance(state, CycleRecord) else self.decode(state)
        return MeshReport(record=rec, hierarchy=self.hierarchy,
                          comm=self.collectives())


def mesh_probe(fn: Callable, mesh, in_specs, out_specs,
               config: ProbeConfig = ProbeConfig(), *,
               device=None) -> MeshProbedFunction:
    """Single-directive activation for sharded programs (the pragma,
    per device): ``fn`` is the per-shard body you would hand to
    ``compat.shard_map(fn, mesh=, in_specs=, out_specs=)``. ``device`` is
    where this rank's state and ``axis_index`` live (default: the mesh's
    device type, this process's card)."""
    return MeshProbedFunction(fn, mesh, in_specs, out_specs, config,
                              device=device)


# ------------------------------------------------------------- report

@dataclass
class MeshReport:
    """Per-device result view: device table, mesh heat map, reductions,
    and the compute-vs-communication split per module."""
    record: CycleRecord
    hierarchy: Hierarchy
    comm: List[CollectiveSite] = field(default_factory=list)

    def device_table(self) -> str:
        return report_mod.mesh_device_table(self.record)

    def heat(self, path: Optional[str] = None) -> str:
        return report_mod.mesh_heat(self.record, path)

    def comm_table(self) -> str:
        return report_mod.mesh_comm_table(self.record, self.hierarchy,
                                          self.comm)

    def reduce(self, mode: str = "max") -> np.ndarray:
        return self.record.reduce(mode)

    def skew(self) -> np.ndarray:
        return self.record.skew()


# ------------------------------------------------------------- session

@dataclass
class MeshSnapshot:
    """Point-in-time view of a live mesh session (constant-size)."""
    steps: int
    wall_s: float
    record: CycleRecord
    stats: StreamAggregator       # device-major rows: (device, probe)
    state_nbytes: int

    @property
    def span(self) -> int:
        """Worst-device cumulative cycle span since session start."""
        return int(self.record.cycle.max(initial=0))

    def table(self, reduce: str = "max") -> str:
        return report_mod.mesh_session_table(self, reduce=reduce)

    def device_table(self) -> str:
        return report_mod.mesh_device_table(self.record)

    def heat(self, path: Optional[str] = None) -> str:
        return report_mod.mesh_heat(self.record, path)

    def skew(self) -> np.ndarray:
        return self.record.skew()


class MeshProbeSession:
    """Continuous mesh-wide profiling over a sharded step function.

    Each rank threads its counter row across steps (``stateful_call``:
    one capture, totals accumulate per device); at window boundaries the
    ranks all-gather their totals and fold the per-window per-device
    deltas into a device-major :class:`StreamAggregator` (every rank
    holds the same one), whose ``reduce``/``skew`` expose the
    cross-device modes. Memory is constant in step count. Every rank
    steps, snapshots and closes together."""

    def __init__(self, fn, mesh=None, in_specs=None, out_specs=None,
                 config: Optional[ProbeConfig] = None, *,
                 window_steps: int = 16, ema_alpha: float = 0.1,
                 bus=None, source: str = "mesh", device=None):
        if isinstance(fn, MeshProbedFunction):
            self.mpf = fn
        else:
            if mesh is None:
                raise ValueError("MeshProbeSession(fn, mesh, in_specs, "
                                 "out_specs) needs a mesh for a plain fn")
            self.mpf = mesh_probe(fn, mesh, in_specs, out_specs,
                                  config or ProbeConfig(), device=device)
        self.window_steps = int(window_steps)
        self.ema_alpha = float(ema_alpha)
        self.bus = bus
        self.source = source
        self._stream = None
        self.stats: Optional[StreamAggregator] = None
        self._state = None
        self._steps = 0
        self._closed = False
        self._t0 = 0.0
        self._prev_totals: Optional[np.ndarray] = None
        self._win_start = 0

    def __enter__(self) -> "MeshProbeSession":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def paths(self) -> Tuple[str, ...]:
        return self.mpf.assignment.paths

    @property
    def n_devices(self) -> int:
        return self.mpf.n_devices

    def step(self, *args):
        if self._closed:
            raise RuntimeError("session is closed")
        if self._state is None:
            self.mpf.ensure_built(*args)
            self._state = self.mpf.init_state()
            n = self.mpf.assignment.n
            from repro_torch.telemetry.bus import ProbeStream
            paths = self.mpf.assignment.paths
            if self.bus is not None:
                self._stream = self.bus.stream(
                    self.source, paths, n_devices=self.mpf.n_devices,
                    ema_alpha=self.ema_alpha)
            else:
                self._stream = ProbeStream(
                    self.source, paths, n_devices=self.mpf.n_devices,
                    ema_alpha=self.ema_alpha)
            self.stats = self._stream.agg
            self._prev_totals = np.zeros(self.mpf.n_devices * n, np.int64)
            self._t0 = time.perf_counter()
        out, self._state = self.mpf.stateful_call(self._state, *args)
        self._steps += 1
        if self._steps - self._win_start >= self.window_steps:
            self._roll_window()
        return out

    def _read_totals(self) -> np.ndarray:
        t = _all_rows(self._state["cnt"][:, TOTALS], self.mpf.env)  # (D, n)
        return t.astype(np.int64).reshape(-1)            # device-major

    def _roll_window(self):
        totals = self._read_totals()
        delta = totals - self._prev_totals
        for row in np.nonzero(delta)[0]:
            self._stream.add(int(row), np.array([delta[row]]))
        self._stream.roll(self._win_start, self._steps,
                          exact_totals=delta)
        self._prev_totals = totals
        self._win_start = self._steps

    def snapshot(self) -> MeshSnapshot:
        if self._state is None:
            raise RuntimeError("no steps executed yet")
        if self._steps > self._win_start:
            self._roll_window()                    # fold the partial window
        rec = self.mpf.decode(self._state)
        return MeshSnapshot(steps=self._steps,
                            wall_s=time.perf_counter() - self._t0,
                            record=rec, stats=self.stats.copy(),
                            state_nbytes=self.state_nbytes())

    def state_nbytes(self) -> int:
        host = self.stats.nbytes if self.stats is not None else 0
        if self._prev_totals is not None:
            host += self._prev_totals.nbytes
        from repro_torch.core.buffer import state_bytes
        dev = (self.mpf.n_devices *
               state_bytes(self.mpf.assignment.n,
                           self.mpf.config.buffer_depth)
               if self._state is not None else 0)
        return host + dev

    def close(self) -> Optional[MeshSnapshot]:
        if self._closed:
            return None
        snap = self.snapshot() if self._state is not None else None
        self._closed = True
        return snap
