"""Scope-hierarchy capture from one eager run (the C-to-RTL analogue).

Port of ``repro.core.hierarchy``. JAX extracts the hierarchy from a
traced jaxpr; eager PyTorch has no trace, so ``capture`` runs the
function ONCE under a recording ``TorchDispatchMode`` with the scope
markers (``core.scope``) live, and records:

- a ``ScopeNode`` tree with the JAX package's kinds (``root``, ``scope``,
  ``loop``, ``while``, ``cond``), ``trip_count``, ``dynamic``,
  ``n_eqns`` (aten operations of one visit), ``own_cycles``,
  ``static_cycles`` and ``source`` (file:line of the first user frame
  outside ``repro_torch.core``, the kernel wrappers and torch, taken
  once per scope: the mapping-table payload);
- the segment table in place of ``EqnInfo``: for each (site, ordinal)
  (``core.scope``) the cycles and the number of operations of that
  stretch of one visit, and the event that ends it. The instrumented run
  (``core.instrument``) advances its clock from this table alone.

The capture leaves no trace of its run (JAX's trace has no side
effects): the first in-place write of the run to a storage that existed
before it (an argument, a cache, a tensor the function closes over)
first copies that storage, and the copies are put back when the run
ends, so the caller's tensors hold what they held before. The oracle's
run (``core.oracle``) is kept free of side effects the same way. Writes
the dispatcher does not see (a kernel writing through a raw pointer, or
numpy through ``.numpy()``) are not restored.

The backward of a gradient taken with ``scope.grad`` is recorded like
the forward: autograd carries the dispatch mode to the threads that run
the backward, and the node hooks move the frames (``core.scope``).

Every aten operation is priced by ``core.costmodel``. A collective
(``distributed.compat``) is also recorded, once a site as a jaxpr
equation, with its scope path and the mesh axes of its process group
(``Hierarchy.collectives``, read by ``launch.collectives``). A hand kernel's
region is ONE operation; nothing inside it is recorded. A region that
declares a grid plan (``core.kernelprobe``) is also a marker event of
its own, and the capture keeps both views of it: ``Captured.view(
kernel_probes)`` builds the hierarchy for a set of kernel probes without
running the function again (a retarget that flips them reuses the
capture, as the JAX package re-extracts its cached trace). In a view
whose ``kernel_probes`` match the region's body, the region is the
reference's subtree ``kernel/<body>#i`` (kind ``kernel``) / ``grid``
(kind ``loop``, ``trip_count`` the grid's steps, ``grid`` the grid) /
the body's inner scopes; otherwise it is the one operation it always
was, and the tree is the one it was before kernel probing existed. A
visit that repeats a site (a loop iteration, a scope in a loop) must
repeat its segments exactly; one that does not (data-dependent shapes)
raises, since the table could not price it. A capture runs every branch of a
``scope.switch``/``cond`` (the taken one's result is returned), so the
tree holds every branch, as the jaxpr does.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import costmodel as cm
from repro_torch.core import kernelprobe as kp
from repro_torch.core import scope as sc

_CORE_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
_KERNELS_DIR = os.path.join(os.path.dirname(_CORE_DIR[:-1]), "kernels") + os.sep
_TORCH_DIR = os.sep + "torch" + os.sep
_LOOP_KINDS = ("scan", "while", "cond")
_TRIGGERS = _LOOP_KINDS + ("kernel",)
_PLACEHOLDER = "\0kernel:"         # a kernel site's slot among children


@dataclass
class ScopeNode:
    name: str
    path: str
    kind: str = "scope"               # scope | loop | while | cond | root
                                      # | kernel
    trip_count: Optional[int] = None  # scan loops, kernel grids
    grid: Optional[Tuple[int, ...]] = None   # a kernel's grid node
    dynamic: bool = False             # subtree contains while/cond
    n_eqns: int = 0                   # aten ops directly here, one visit
    own_cycles: int = 0               # direct-op cycles per single visit
    static_cycles: int = 0            # subtree cycles per single visit
    source: str = ""                  # file:line of the first op
    children: "Dict[str, ScopeNode]" = field(default_factory=dict)

    def walk(self):
        yield self
        for c in self.children.values():
            yield from c.walk()

    def find(self, path: str) -> Optional["ScopeNode"]:
        if path in ("", "/"):
            return self
        node = self
        for seg in path.strip("/").split("/"):
            node = node.children.get(seg)
            if node is None:
                return None
        return node


@dataclass(frozen=True)
class Segment:
    """One stretch of a visit between two marker events."""
    cycles: int                       # priced cycles of its operations
    n_ops: int                        # operations (views included)
    nxt: tuple                        # the event that ends it

    @property
    def triggers(self) -> bool:
        """Does the stretch run anything at its path (an operation, or a
        loop / branch point or kernel call, which JAX counts as an
        equation)?"""
        return self.n_ops > 0 or self.nxt[0] in _TRIGGERS


@dataclass(frozen=True)
class KernelSite:
    """A kernel region that declares a grid plan, at one site: its
    parent's path, its flat cycles (the region priced as one operation)
    and its plan's signature; ``path`` is its ``kernel/<body>#i`` node in
    a view whose kernel probes match it, else None."""
    body: str
    parent: str
    flat: int
    plan: Tuple[Any, ...]             # GridPlan.signature()
    source: str = ""
    op_index: Optional[int] = None    # its entry in ``ops[parent]``
    path: Optional[str] = None


@dataclass
class Hierarchy:
    root: ScopeNode
    sites: sc.SiteTable
    segments: Dict[Tuple[int, int], Segment]
    ops: Dict[str, List[Tuple[str, int]]]   # path -> (op, cycles), one visit
    kernels: Dict[int, KernelSite] = field(default_factory=dict)
    kernel_probes: Tuple[str, ...] = ()
    captured: "Optional[Captured]" = None
    # kernel path -> (its last host counter block, as bytes; the grid's
    # cycles for it): the runs' clock mirror, priced once per block
    grid_cycles: Dict[str, Tuple[bytes, int]] = field(default_factory=dict)
    # the collectives of one visit of each site, with their scope paths
    # and mesh axes (``launch.collectives.captured_collectives``)
    collectives: Tuple[cm.CollectiveOp, ...] = ()

    def with_kernel_probes(self, kernel_probes) -> "Hierarchy":
        """The view of the same capture for other kernel probes."""
        kernel_probes = tuple(kernel_probes)
        if kernel_probes == self.kernel_probes or self.captured is None:
            return self
        return self.captured.view(kernel_probes)

    def node(self, path: str) -> Optional[ScopeNode]:
        return self.root.find(path)

    def all_paths(self) -> List[str]:
        return [n.path for n in self.root.walk() if n.path]

    def mapping_table(self) -> List[Dict[str, Any]]:
        """The C-to-RTL mapping table: scope -> source, kind, static cost."""
        return [dict(path=n.path or "/", kind=n.kind, source=n.source,
                     n_eqns=n.n_eqns, static_cycles=n.static_cycles,
                     trip_count=n.trip_count, dynamic=n.dynamic)
                for n in self.root.walk()]


def user_source() -> str:
    """file:line of the innermost frame outside ``repro_torch.core``,
    the kernel wrappers (``repro_torch.kernels``) and torch."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_CORE_DIR) or fn.startswith(_KERNELS_DIR)
                or _TORCH_DIR in fn):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return ""


class _WriteGuard:
    """Undoes a run's in-place writes to storages it did not create.

    Before an operation writes (its schema marks the argument as
    written), the storage it writes is copied once, unless the run made
    it; ``restore`` copies every saved storage back. ``copies`` counts
    the storages copied by every guard of the process (a functional step,
    such as the train step, makes none)."""
    copies = 0

    def __init__(self):
        self.fresh: set = set()            # data_ptr of storages made here
        self.saved: Dict[int, Tuple[Any, Any]] = {}
        self._writes: Dict[Any, Tuple[Tuple[int, str], ...]] = {}

    def _written(self, func) -> Tuple[Tuple[int, str], ...]:
        hit = self._writes.get(func)
        if hit is None:
            hit = self._writes[func] = tuple(
                (i, a.name) for i, a in enumerate(func._schema.arguments)
                if a.alias_info is not None and a.alias_info.is_write)
        return hit

    def before(self, func, args, kwargs) -> None:
        for i, name in self._written(func):
            val = args[i] if i < len(args) else kwargs.get(name)
            for t in (val if isinstance(val, (list, tuple)) else (val,)):
                if isinstance(t, torch.Tensor):
                    self._save(t)

    def _save(self, t: torch.Tensor) -> None:
        ptr = _data_ptr(t)
        if ptr is None:
            return
        st = t.untyped_storage()
        if st.nbytes() == 0 or ptr in self.fresh or ptr in self.saved:
            return
        view = torch.empty(0, dtype=torch.uint8, device=t.device).set_(st)
        self.saved[ptr] = (view, view.clone())
        _WriteGuard.copies += 1

    def after(self, func, out) -> None:
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for r, t in zip(func._schema.returns, outs):
            if r.alias_info is None and isinstance(t, torch.Tensor):
                ptr = _data_ptr(t)
                if ptr is not None and ptr not in self.saved:
                    self.fresh.add(ptr)

    def restore(self) -> None:
        for view, copy in self.saved.values():
            view.copy_(copy)
        self.saved.clear()
        self.fresh.clear()


def _data_ptr(t: torch.Tensor):
    """The address of ``t``'s storage; None for a wrapper subclass with
    no storage of its own (a DTensor, which ``_OpMode`` hands on to
    DTensor's dispatch, made by an operation it sees)."""
    try:
        return t.untyped_storage().data_ptr()
    except RuntimeError:
        return None


try:
    from torch.distributed.tensor import DTensor as _DTENSOR
except ImportError:                      # a torch built without distributed
    _DTENSOR = None


class _OpMode(TorchDispatchMode):
    """Runs every aten operation through ``rec._bind`` and hands it, after
    it ran, to ``rec.op``; its ``guard`` keeps the run free of side
    effects."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec
        self.guard = _WriteGuard()
        self.quiet = False       # inside DTensor's sharding propagation

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            # a DTensor operation: DTensor's dispatch runs this rank's
            # local operations (and its redistributions' collectives),
            # which come back here to be recorded
            return NotImplemented
        self.guard.before(func, args, kwargs)
        out = self.rec._bind(func, args, kwargs)
        self.guard.after(func, out)
        self.rec.op(func, args, kwargs, out)
        return out


class _Region:
    """A kernel region: one priced operation, nothing inside recorded."""
    __slots__ = ("rec", "name", "cost")
    probed = False

    def __init__(self, rec, name, cost):
        self.rec, self.name, self.cost = rec, name, cost

    def __enter__(self):
        self.rec.priced(self.name, cm.kernel_cost(*self.cost()))
        self.rec.in_kernel = True
        return self

    def __exit__(self, *exc):
        self.rec.in_kernel = False
        return False

    def fold(self, counters) -> None:
        """No counter block is asked for here."""


class _KernelEvent:
    """A kernel region with a grid plan, in a capture or an oracle run: a
    marker event of its own (``scope.kernel_region``). The kernel runs as
    it runs unprobed (no counter block is asked for); the tracker's
    ``kernel_enter`` prices it."""
    probed = False

    def __init__(self, rec, name, cost, plan):
        self.rec, self.name, self.cost, self.plan = rec, name, cost, plan
        self.parent = self.sid = None

    def __enter__(self):
        self.parent, self.sid = self.rec.kernel_event(self.name)
        # what the pricing reads (a device input brought to the host)
        # is not an operation of the program
        self.rec.in_kernel = True
        self.rec.kernel_enter(self)
        return self

    def fold(self, counters) -> None:
        """The capture and the oracle never read a counter block."""

    def __exit__(self, exc_type, exc, tb):
        self.rec.in_kernel = False
        if exc_type is None:
            self.rec.kernel_done(self.parent)
        return False


class OpTracker(sc.Tracker):
    """A tracker that sees every operation (capture and oracle)."""

    def __enter__(self):
        super().__enter__()
        from repro_torch.distributed.compat import quiet_propagation
        self._mode = _OpMode(self)
        self._quiet = quiet_propagation(self._mode)
        self._quiet.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._mode.__exit__(exc_type, exc, tb)
        self._quiet.__exit__(exc_type, exc, tb)
        self._mode.guard.restore()
        return super().__exit__(exc_type, exc, tb)

    def _bind(self, func, args, kwargs):
        """Execute one operation (``ShardOracle`` stubs collectives here,
        as the JAX oracle's ``_bind``)."""
        return func(*args, **kwargs)

    def op(self, func, args, kwargs, out) -> None:
        if self.in_kernel or func.overloadpacket.__name__ in cm.SKIP:
            return
        c = cm.collective_of(func, args, kwargs, out)
        if c is not None:
            self.collective(c)
        self.priced(func.overloadpacket.__name__,
                    cm.op_cost(func, args, kwargs, out))

    def collective(self, c: cm.CollectiveOp) -> None:
        """A collective is about to be priced at the frame on top."""

    def kernel(self, name, cost, plan=None):
        if self.in_kernel:
            return sc._NULL
        if plan is None:
            return _Region(self, name, cost)
        return _KernelEvent(self, name, cost, plan)

    def priced(self, name: str, cost: cm.OpCost) -> None: ...
    def kernel_enter(self, ev: _KernelEvent) -> None: ...


class Capture(OpTracker):
    def __init__(self):
        super().__init__()
        self.tree = ScopeNode(name="", path="", kind="root")
        self.segments: Dict[Tuple[int, int], Segment] = {}
        self.ops: Dict[str, List[Tuple[str, int]]] = {}
        self._acc: Dict[int, list] = {}
        self._touched: set = {""}
        self._first: set = set()       # sites whose first visit is done
        self.kernels: Dict[int, KernelSite] = {}
        self.collectives: List[cm.CollectiveOp] = []

    # -- tree ------------------------------------------------------------
    def _ensure(self, path: str, kind: str = "scope",
                source: Optional[str] = None) -> ScopeNode:
        node = self.tree
        cur = ""
        for seg in path.split("/"):
            cur = f"{cur}/{seg}" if cur else seg
            nxt = node.children.get(seg)
            if nxt is None:
                nxt = node.children[seg] = ScopeNode(name=seg, path=cur)
                nxt.source = user_source() if source is None else source
            node = nxt
        if kind != "scope":
            node.kind = kind
        return node

    def _touch(self, path: str) -> None:
        if path not in self._touched:
            self._ensure(path)
            self._touched.add(path)

    def nodes(self, path, kind, children):
        node = self._ensure(path, kind)
        node.dynamic = kind in ("while", "cond")
        for c in children:
            self._ensure(f"{path}/{c}", source="")
        self._touched.add(path)

    def iteration(self, loop_path, length):
        self.tree.find(loop_path).trip_count = length

    # -- segments --------------------------------------------------------
    def seg_begin(self, f):
        self._acc[id(f)] = [0, 0, f.site in self._first]

    def priced(self, name, cost):
        f = self.top
        acc = self._acc[id(f)]
        acc[0] += cost.cycles
        acc[1] += 1
        self._touch(f.path)
        if not acc[2]:
            self.ops.setdefault(f.path, []).append((name, cost.cycles))

    def trigger(self, f):
        self._touch(f.path)

    def collective(self, c):
        f = self.top
        if not self._acc[id(f)][2]:      # one site, as a jaxpr equation
            self.collectives.append(dataclasses.replace(c, path=f.path))

    def seg_end(self, f, nxt):
        cyc, n_ops, _ = self._acc[id(f)]
        seg = Segment(cycles=cyc, n_ops=n_ops, nxt=nxt)
        key = (f.site, f.ord)
        old = self.segments.get(key)
        if old is None:
            self.segments[key] = seg
            if n_ops:
                node = self.tree.find(f.path)
                node.n_eqns += n_ops
                node.own_cycles += cyc
        elif old != seg:
            raise RuntimeError(
                f"two visits of {f.path or '/'} differ at segment {f.ord} "
                f"({old} then {seg}): shapes or control flow that depend "
                f"on data cannot be priced from one capture")

    def frame_close(self, f):
        self._first.add(f.site)
        self._acc.pop(id(f), None)

    # -- kernel regions with a plan: both views kept ---------------------
    def kernel_enter(self, ev):
        plan = ev.plan()
        flat = cm.kernel_cost(*ev.cost(), body=plan.body).cycles
        sig = plan.signature()
        old = self.kernels.get(ev.sid)
        if old is not None:
            if (old.plan, old.flat) != (sig, flat):
                raise RuntimeError(
                    f"two visits of kernel {plan.body} at "
                    f"{ev.parent.path or '/'} differ ({old.plan}, "
                    f"{old.flat} cycles, then {sig}, {flat}): shapes that "
                    f"depend on data cannot be priced from one capture")
            return
        f = ev.parent
        op_index = None
        if not self._acc[id(f)][2]:
            lst = self.ops.setdefault(f.path, [])
            op_index = len(lst)
            lst.append((ev.name, flat))
        self.kernels[ev.sid] = KernelSite(
            body=plan.body, parent=f.path, flat=flat, plan=sig,
            source=user_source(), op_index=op_index)
        node = self.tree.find(f.path)
        node.children[f"{_PLACEHOLDER}{ev.sid}"] = ScopeNode(
            name="", path="", kind="placeholder")

    # -- branches: every branch runs once, the taken one's result counts -
    def switch(self, index, branches, operands):
        parent = self.top
        sid, path = self._loop_site(parent, "cond")
        self.nodes(path, "cond", tuple(f"branch{i}"
                                       for i in range(len(branches))))
        out = None
        for i, fn in enumerate(branches):
            res = self.run_branch(sid, path, i, fn, operands, parent)
            if i == index:
                out = res
        self._resume(parent)
        return out

    # -- result ------------------------------------------------------------
    def result(self) -> "Captured":
        return Captured(tree=self.tree, sites=self.sites,
                        segments=self.segments, ops=self.ops,
                        kernels=self.kernels,
                        collectives=tuple(self.collectives))


def _finalize(node: ScopeNode) -> Tuple[int, bool]:
    total, dyn = node.own_cycles, node.dynamic
    for c in node.children.values():
        sub, d = _finalize(c)
        mult = c.trip_count if (c.kind == "loop" and c.trip_count) else 1
        total += sub * mult
        dyn = dyn or d or c.kind in ("while", "cond")
    node.static_cycles, node.dynamic = total, dyn
    return total, dyn


@dataclass
class Captured:
    """What one capture run recorded, before kernel probes are chosen:
    the tree with a placeholder where each kernel site with a plan was
    first seen, the segment table, the operations, and the kernel
    sites. ``view`` resolves the placeholders for a set of kernel
    probes."""
    tree: ScopeNode
    sites: sc.SiteTable
    segments: Dict[Tuple[int, int], Segment]
    ops: Dict[str, List[Tuple[str, int]]]
    kernels: Dict[int, KernelSite]
    collectives: Tuple[cm.CollectiveOp, ...] = ()

    def view(self, kernel_probes=()) -> Hierarchy:
        kernel_probes = tuple(kernel_probes)
        tree = copy.deepcopy(self.tree)
        ops = {p: list(v) for p, v in self.ops.items()}
        kernels: Dict[int, KernelSite] = {}
        index: Dict[str, int] = {}
        dropped: Dict[str, set] = {}

        def resolve(node: ScopeNode) -> None:
            kids: Dict[str, ScopeNode] = {}
            for key, child in node.children.items():
                if not key.startswith(_PLACEHOLDER):
                    kids[key] = child
                    resolve(child)
                    continue
                sid = int(key[len(_PLACEHOLDER):])
                ks = self.kernels[sid]
                if not kp.matches(kernel_probes, ks.body):
                    node.n_eqns += 1
                    node.own_cycles += ks.flat
                    kernels[sid] = ks
                    continue
                root = kids.get(kp.KERNEL_SEG)
                if root is None:
                    root = kids[kp.KERNEL_SEG] = ScopeNode(
                        name=kp.KERNEL_SEG, source=ks.source,
                        path=sc._join(node.path, kp.KERNEL_SEG))
                i = index.get(node.path, 0)
                index[node.path] = i + 1
                knode = _kernel_subtree(ks, kp.kernel_path(node.path,
                                                           ks.body, i))
                root.children[knode.name] = knode
                kernels[sid] = dataclasses.replace(ks, path=knode.path)
                if ks.op_index is not None:
                    dropped.setdefault(ks.parent, set()).add(ks.op_index)
            node.children = kids

        resolve(tree)
        for path, idx in dropped.items():
            ops[path] = [o for i, o in enumerate(ops[path]) if i not in idx]
            if not ops[path]:
                del ops[path]
        _finalize(tree)
        return Hierarchy(root=tree, sites=self.sites,
                         segments=self.segments, ops=ops, kernels=kernels,
                         kernel_probes=kernel_probes, captured=self,
                         collectives=self.collectives)


def _kernel_subtree(ks: KernelSite, kpath: str) -> ScopeNode:
    """``<body>#i`` / ``grid`` / the inner scopes, priced per step from
    the plan: the grid node holds the transfer term, each scope its most
    expensive table entry (the widest branch, as the JAX package's
    static column prices a ``pl.when``)."""
    body, grid, transfer, scopes = ks.plan[:4]
    knode = ScopeNode(name=kpath.rsplit("/", 1)[-1], path=kpath,
                      kind="kernel", source=ks.source)
    gpath = f"{kpath}/{kp.GRID_SEG}"
    steps = 1
    for g in grid:
        steps *= g
    gnode = knode.children[kp.GRID_SEG] = ScopeNode(
        name=kp.GRID_SEG, path=gpath, kind="loop", trip_count=steps,
        grid=tuple(grid), n_eqns=1, own_cycles=transfer, source=ks.source)
    for scp in scopes:
        gnode.children[scp.name] = ScopeNode(
            name=scp.name, path=f"{gpath}/{scp.name}", n_eqns=scp.ops,
            own_cycles=max(scp.table), source=ks.source)
    return knode


def write_copies() -> int:
    """Storages the capture and oracle runs of this process have copied
    to undo in-place writes (see ``_WriteGuard``)."""
    return _WriteGuard.copies


def capture(fn, *args, **kwargs) -> Tuple[Hierarchy, Any]:
    """Run ``fn`` once under the capture; returns (hierarchy, outputs).
    The hierarchy is the view without kernel probes;
    ``with_kernel_probes`` gives the others from the same run."""
    cap = Capture()
    with cap:
        out = fn(*args, **kwargs)
    return cap.result().view(), out
