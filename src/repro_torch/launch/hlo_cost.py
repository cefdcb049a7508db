"""Per-device step accounting: FLOPs, bytes, collectives and memory of one
call, counted as it runs, on any device (``meta`` included).

Port of ``repro.launch.hlo_cost``. JAX parses a compiled per-device HLO
module, multiplies while bodies by their trip counts and reads XLA's
memory analysis. Eager PyTorch compiles nothing, so ``analyze`` runs the
function once under a counting ``TorchDispatchMode``:

- **Pricing.** Each aten operation is priced by ``core.costmodel.op_cost``,
  the one pricing table the model clock uses: matrix products 2 M N K,
  transcendentals 8 FLOPs an element, reductions their input's size,
  views nothing; bytes every tensor read plus every tensor written.
- **Kernel regions.** A hand-kernel region (``scope.kernel_region``)
  counts once, at the (FLOPs, bytes) its wrapper states, and the
  operations inside it are not counted, as the model clock prices a
  region. So a step counts the same integers whichever route runs its
  kernels: the CUDA kernel on the card, the plain version on the CPU, or
  nothing on ``meta`` (the dry run, ``launch.dryrun``).
- **Per device.** Under DTensor (``distributed.sharding``) an operation
  on DTensors reaches the mode at its global shape; the mode hands it on
  (``NotImplemented``), and DTensor's dispatch runs the rank's local
  operations and the collectives of its redistributions, which the mode
  counts. The operations DTensor's sharding propagation runs on fake
  tensors are not counted.
  Sharding propagation runs operations of its own: on fake tensors
  (skipped as such), and, for an operation DTensor has no rule for, its
  decomposition on a one-rank mesh (torch 2.13's
  ``DecompShardingStrategy``), once per decision it has not cached. Those
  run quiet (``compat.quiet_propagation``): counted, they would make a count
  depend on what ran before it in the process.
- **Collectives** (the counterpart of ``collectives.parse_collective_bytes``,
  which reads them from HLO text): each functional collective
  (``_c10d_functional``, and the in-place ``c10d`` ones) is priced by
  ``collectives.ring_wire_bytes`` from its result bytes and the size G of
  its process group.
- **All-to-all.** DTensor moves a dimension's shards to another
  dimension (``Shard(i)`` -> ``Shard(j)``) by one all-to-all
  (``_collective_utils.shard_dim_alltoall``); on a mesh of device type
  cpu (gloo, and the dry run's fake world) it falls back to an
  all-gather of the whole dimension and a chunk of it, about G times the
  all-to-all's wire bytes. ``analyze`` recognises the call, whichever
  route it takes: what runs inside is not counted, and the call counts
  as the one ``all-to-all`` a card mesh runs (its block's bytes in and
  out, ring wire bytes ``bytes * (G-1)/G``), so the fake world, a gloo
  world and a card mesh count it alike.
- **Loops.** Eager loops run every iteration, so JAX's multiplication by
  ``known_trip_count`` is built in. With ``fold_scans`` (the dry run's,
  on ``meta``, where nothing is computed) a ``scope.scan(n,
  same_shapes=True)`` runs two iterations and counts the second for the
  other n - 1: the optimizer's row scans of large leaves, tens of
  thousands of identical small updates. The counts and the peak equal
  the full walk's.
- **Memory** (JAX's ``memory_analysis``): the bytes of live storages,
  each counted once however many views it has, from the arguments on;
  ``peak_estimate_bytes`` is the most that was live at once.
- **Raw count** (``raw_flops``): ``torch.utils.flop_counter``'s formulas
  (what ``FlopCounterMode`` counts: products and convolutions) over every
  operation that ran, inside kernel regions too; independent of
  ``op_cost``, where JAX keeps XLA's ``cost_analysis``.

``analyze`` returns JAX's keys, ``flops``, ``bytes``, ``collectives``
({kind: {"count", "wire_bytes"}}) and ``collective_wire_bytes``, plus
``matmul_flops`` (the products' share of ``flops``), ``raw_flops``,
``memory`` and ``kernel_regions`` ({wrapper name: calls}: the kernel
launches the same step makes on the card, where each call launches).
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import costmodel as cm
from repro_torch.distributed.compat import quiet_propagation
from repro_torch.launch.collectives import (PRIMITIVE_KINDS, op_name,
                                            ring_wire_bytes)


def _leaves(x: Any):
    """The tensors of a tree (dicts, lists, tuples, named tuples); a
    DTensor gives its local block."""
    if isinstance(x, torch.Tensor):
        yield getattr(x, "_local_tensor", x)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


class _Live:
    """Bytes of the live storages, each once (views share one), and the
    most live at once. A storage leaves when its last reference dies
    (a weak reference's callback)."""

    def __init__(self):
        self.live = self.peak = 0
        self._refs: Dict[int, Tuple[weakref.ref, int]] = {}

    def _gone(self, key: int):
        ref_n = self._refs.pop(key, None)
        if ref_n is not None:
            self.live -= ref_n[1]

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        held = self._refs.get(key)
        if held is not None and held[0]() is st:
            return
        n = st.nbytes()
        self._refs[key] = (weakref.ref(st, lambda _, k=key: self._gone(k)), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    @staticmethod
    def storages(tree) -> Dict[int, int]:
        """id -> bytes of the distinct storages of a tree's tensors."""
        out = {}
        for t in _leaves(tree):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
        return out


def _group_size(args, kwargs) -> int:
    """The size G of the process group a functional collective runs over
    (its ``group_name``); the world's for an in-place ``c10d`` one."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = kwargs.get("group_name", args[-1] if args else None)
    if isinstance(group, str):
        return _resolve_process_group(group).size()
    return dist.get_world_size() if dist.is_initialized() else 1


class _Counter(TorchDispatchMode):
    """The counting mode (see the module docstring); also the kernel
    listener that prices each region once, found on the mode stack
    (``scope._listener``), which autograd's device threads inherit."""
    kernel_listener = True

    def __init__(self, fold_scans: bool = False):
        super().__init__()
        self.flops = self.bytes = self.matmul_flops = self.raw_flops = 0
        self.mult = 1                    # iterations one run stands for
        self.scan = self._fold_scan if fold_scans else None
        self.coll: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "wire_bytes": 0.0})
        self.depth = 0                   # inside a kernel region
        self.quiet = False               # inside an all-to-all: no count
        self.live = _Live()
        self.regions: Dict[str, int] = defaultdict(int)   # kernel calls
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor, self._fake, self._raw = DTensor, FakeTensor, \
            flop_registry

    def alltoall(self, x: torch.Tensor, out: torch.Tensor,
                 group_size: int) -> None:
        """One all-to-all of this rank's block ``x`` into ``out``."""
        self.live.add(out)
        if self.depth:
            return
        n_in, n_out = (t.numel() * t.element_size() for t in (x, out))
        self.flops += self.mult * out.numel()
        self.bytes += self.mult * (n_in + n_out)
        rec = self.coll["all-to-all"]
        rec["count"] += self.mult
        rec["wire_bytes"] += self.mult * ring_wire_bytes(
            "all-to-all", n_out, group_size)

    def kernel(self, name, cost, plan=None):
        if not self.depth:
            self.regions[name] += self.mult
        return _Region(self, cost)

    def _fold_scan(self, n: int):
        """A ``scope.scan(n, same_shapes=True)`` in two iterations: the
        first, and the second counted for the other n - 1 (what one
        iteration leaves alive into the next is in the peak)."""
        if n <= 0:
            return
        yield 0
        if n > 1:
            self.mult *= n - 1
            try:
                yield 1
            finally:
                self.mult //= n - 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented        # DTensor runs the local ops
        out = func(*args, **kwargs)
        outs = list(_leaves(out))
        if any(isinstance(t, self._fake) for t in outs) or \
                any(issubclass(t, self._fake) for t in types):
            return out                   # sharding propagation
        for t in outs:
            self.live.add(t)
        packet = func.overloadpacket
        if packet in self._raw:
            self.raw_flops += self.mult * int(
                self._raw[packet](*args, **kwargs, out_val=out))
        name = packet.__name__
        if self.depth or name in cm.SKIP:
            return out
        c = cm.op_cost(func, args, kwargs, out)
        self.flops += self.mult * c.flops
        self.bytes += self.mult * c.bytes
        if name in cm._MATMUL:
            self.matmul_flops += self.mult * c.flops
        kind = PRIMITIVE_KINDS.get(op_name(func)) \
            if func.namespace in ("_c10d_functional", "c10d") else None
        if kind is not None:
            from repro_torch.distributed import compat
            if kind == "all-to-all" and compat.is_permute():
                kind = "collective-permute"
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            rec = self.coll[kind]
            rec["count"] += self.mult
            rec["wire_bytes"] += self.mult * ring_wire_bytes(
                kind, nbytes, _group_size(args, kwargs))
        return out


class _Region:
    """One kernel region: its stated cost, once; nothing inside."""
    probed = False

    def __init__(self, counter: _Counter, cost: Callable):
        self.counter, self.cost = counter, cost

    def __enter__(self):
        c = self.counter
        if not c.depth:
            c.depth += 1
            flops, nbytes = self.cost()
            c.flops += c.mult * int(flops)
            c.bytes += c.mult * int(nbytes)
        else:
            c.depth += 1
        return self

    def fold(self, counters) -> None:
        """No counter block is asked for."""

    def __exit__(self, *exc):
        self.counter.depth -= 1
        return False


@contextlib.contextmanager
def _one_alltoall(counter: _Counter):
    """DTensor's ``shard_dim_alltoall``, wherever it is bound, counted as
    one all-to-all (the module docstring)."""
    from torch.distributed.tensor import _collective_utils as cu
    orig = cu.shard_dim_alltoall

    def counted(*args, **kwargs):
        # (input, gather_dim, shard_dim, mesh, mesh_dim), by position or
        # by name
        x = kwargs.get("input", args[0] if args else None)
        mesh = kwargs.get("mesh", args[3] if len(args) > 3 else None)
        mesh_dim = kwargs.get("mesh_dim", args[4] if len(args) > 4 else None)
        quiet, counter.quiet = counter.quiet, True
        try:
            out = orig(*args, **kwargs)
            if out.untyped_storage().nbytes() > \
                    out.numel() * out.element_size():
                out = out.clone()    # the fallback's chunk of its gather:
        finally:                     # the card's output holds its block
            counter.quiet = quiet
        if not quiet:
            counter.alltoall(x, out, mesh.size(mesh_dim))
        return out

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("torch.distributed.tensor")
            and getattr(m, "shard_dim_alltoall", None) is orig]
    for m in mods:
        m.shard_dim_alltoall = counted
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig


def analyze(fn: Callable, *args, fold_scans: bool = False,
            **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count it, per device (see the
    module docstring; ``fold_scans`` there). Returns {"flops", "bytes", "collectives",
    "collective_wire_bytes", "matmul_flops", "raw_flops",
    "kernel_regions", "memory":
    {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
    "peak_estimate_bytes"}, "result"}: ``result`` is what ``fn``
    returned."""
    counter = _Counter(fold_scans)
    arg_st = _Live.storages((args, kwargs))
    for t in _leaves((args, kwargs)):
        counter.live.add(t)
    with counter, _one_alltoall(counter), quiet_propagation(counter):
        result = fn(*args, **kwargs)
    out_st = _Live.storages(result)
    argument = sum(arg_st.values())
    output = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    peak = max(counter.live.peak, argument + output - alias)
    coll = {k: dict(v) for k, v in sorted(counter.coll.items())}
    return {
        "flops": int(counter.flops),
        "bytes": int(counter.bytes),
        "collectives": coll,
        "collective_wire_bytes": float(sum(v["wire_bytes"]
                                           for v in coll.values())),
        "matmul_flops": int(counter.matmul_flops),
        "raw_flops": int(counter.raw_flops),
        "kernel_regions": dict(sorted(counter.regions.items())),
        "memory": {
            "argument_bytes": int(argument),
            "output_bytes": int(output),
            "temp_bytes": int(peak - argument - output + alias),
            "alias_bytes": int(alias),
            "peak_estimate_bytes": int(peak),
        },
        "result": result,
    }
