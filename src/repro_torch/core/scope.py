"""Scope and loop markers: the port's ``jax.named_scope``, ``lax.scan``,
``lax.while_loop``, ``lax.cond`` / ``lax.switch``, and the kernel region.

The JAX package reads scopes and loops from a traced jaxpr: name stacks
give the scopes, ``scan``/``while``/``cond`` equations give the loop and
branch nodes. Eager PyTorch leaves no such trace (a Python ``for`` over
layers is invisible), so the program marks them::

    with scope.named_scope("layers"):
        for i in scope.scan(n_layers):          # node "layers/scan#0"
            with scope.named_scope("layer"):
                x = block(params[i], x)

With no capture, probe or oracle active every marker costs one
context-variable read and does nothing on the device: ``scan`` returns
``range(n)``, ``while_loop`` and ``switch`` run a plain Python loop or
branch, ``kernel_region`` returns a shared null context.

While a ``Tracker`` is active (``core.hierarchy.Capture``,
``core.instrument.Runner``, ``core.oracle.Oracle``) the markers drive its
frame stack. Each marker event is either a *child event* of the frame on
top (a named scope, a loop, a branch point) or the end of that frame.
The stretch of a frame between two events is a *segment*; it is keyed
by the frame's static *site* and its ordinal within the visit, so the
iterations of a loop and the repeated visits of one scope resolve to
the same keys, as one jaxpr equation does in JAX. Paths follow the JAX
package's rules exactly:

- a named scope's path is its parent's plus its name; a node exists only
  once an operation ran in it (or below it);
- the k-th static loop of a kind under one path is ``scan#k``,
  ``while#k`` (children ``cond`` and ``body``) or ``cond#k`` (children
  ``branch{i}``); the loop or branch point itself counts as an operation
  of the enclosing path, as the equation does;
- a scan iteration, a while body and a taken branch run as *entry
  frames*: their own path is the starting point of the scope changes
  inside them, so the probes of ``while#k/body``, ``cond#k`` and
  ``cond#k/branch{i}`` are never entered (JAX's ``_eval`` starts there),
  while a scan's or while loop's node is entered once per iteration;
- a while loop's condition runs in a *transparent* frame: its
  operations count toward the clock but change no scope, as JAX adds
  the condition's cycles between iterations.

Branch predicates and while conditions are read on the host (``bool``),
which waits for the device: eager PyTorch cannot branch on the device.

Gradients (``grad``, ``remat``; JAX's ``value_and_grad`` and
``jax.checkpoint``). JAX's trace holds the backward as equations whose
name stacks wrap the forward's (``transpose(jvp(loss))/layers/...``),
which its hierarchy turns into ``loss~bwd/layers/...``: the first
segment below the point where the gradient was taken gets ``~bwd``, the
rest keep the forward's names, loops run backwards under their own
``scan#k``, and a rematerialised forward runs first in each transposed
loop body, under ``rematted_computation``. Eager autograd runs the
backward as a graph of nodes, so the tracker records, as the forward
runs, which frame stack each stretch of autograd sequence numbers was
created under; ``grad`` puts a pre-hook on every node of the graph, and
the hook moves the frame stack to the backward mirror of the node's
forward frames before the node runs. ``remat`` is
``torch.utils.checkpoint`` whose region ends in an identity that saves a
tensor, so the recompute is the first thing the region's backward runs,
and it runs under ``rematted_computation``. The backward of CUDA tensors
runs on autograd's device thread, which does not inherit the caller's
context variables: the hook makes the tracker active on whatever thread
runs it, and a tracker no longer live (its run ended) is ignored by the
markers.
"""
from __future__ import annotations

import bisect
import contextvars
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

_ACTIVE: "contextvars.ContextVar[Optional[Tracker]]" = contextvars.ContextVar(
    "repro_torch_probe_tracker", default=None)
# what sees kernel regions when no probe runs (``kernel_listener``)
_LISTENER: "contextvars.ContextVar[Optional[Any]]" = contextvars.ContextVar(
    "repro_torch_kernel_listener", default=None)

END = ("end",)                     # the event that closes a frame
_SEQ = torch._C._autograd._get_sequence_nr   # next autograd node's number


def _live() -> "Optional[Tracker]":
    """The active tracker, unless its run has ended (a stale one left on
    autograd's device thread by an earlier backward)."""
    rec = _ACTIVE.get()
    return rec if rec is not None and rec.live else None


class _Null:
    __slots__ = ()
    probed = False              # a kernel region: no counter block wanted

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fold(self, counters) -> None:
        """A kernel region's counter block: nothing to fold here."""


_NULL = _Null()


class named_scope:
    """``jax.named_scope``: ``with named_scope("attn"): ...``."""
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name
        self.rec = None

    def __enter__(self):
        rec = self.rec = _live()
        if rec is not None:
            rec.push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.rec is not None and exc_type is None:
            self.rec.pop(self.name)
        return False


def scan(length: int, same_shapes: bool = False):
    """``lax.scan`` over ``length`` steps: ``for i in scan(n): body``.
    Each iteration is one visit of node ``<path>/scan#k``. Leaving the
    loop early (``break``) is not allowed while probed.

    ``same_shapes``: every iteration runs the same operations on tensors
    of the same shapes, so a kernel listener that counts shapes alone (a
    dry run's ``launch.hlo_cost.analyze(..., fold_scans=True)``) may run
    two iterations and count the second ``length - 1`` times."""
    rec = _live()
    if rec is None:
        lis = _listener() if same_shapes else None
        if getattr(lis, "scan", None) is not None:
            return lis.scan(int(length))
        return range(length)
    return rec.scan(int(length))


def while_loop(cond_fn: Callable[[Any], Any], body_fn: Callable[[Any], Any],
               init: Any) -> Any:
    """``lax.while_loop``: ``val = body_fn(val)`` while ``cond_fn(val)``."""
    rec = _live()
    if rec is None:
        val = init
        while bool(cond_fn(val)):
            val = body_fn(val)
        return val
    return rec.while_loop(cond_fn, body_fn, init)


def switch(index, branches: Sequence[Callable], *operands) -> Any:
    """``lax.switch``: ``branches[index](*operands)``, index clamped.
    The branches should not mutate their operands: a capture runs every
    branch once, to know each branch's scopes and costs."""
    rec = _live()
    i = min(max(int(index), 0), len(branches) - 1)
    if rec is None:
        return branches[i](*operands)
    return rec.switch(i, tuple(branches), operands)


def cond(pred, true_fn: Callable, false_fn: Callable, *operands) -> Any:
    """``lax.cond``: branch 0 is ``false_fn``, branch 1 ``true_fn``."""
    return switch(1 if bool(pred) else 0, (false_fn, true_fn), *operands)


def kernel_region(name: str, cost: Callable[[], Tuple[float, float]],
                  plan: Optional[Callable[[], Any]] = None):
    """The region of one hand-written kernel call (CUDA kernel or its
    plain version): a capture or oracle prices it as ONE operation named
    ``name`` from ``cost() -> (flops, bytes)`` and prices nothing inside
    it, so the record does not depend on which route ran.

    ``plan() -> kernelprobe.GridPlan`` declares the kernel's grid for
    ``ProbeConfig(kernel_probes=...)``. A region with a plan is a marker
    event of its own (the end of a segment), whose node
    ``kernel/<body>#i`` exists only when the probe's ``kernel_probes``
    match its body. The wrapper asks the region whether it wants the
    kernel's counter block (``region.probed``) and hands it over with
    ``region.fold(counters)``; a probed region that gets none raises::

        with scope.kernel_region(name, cost, plan) as region:
            out, counts = launch(..., with_counts=region.probed)
            region.fold(counts)
    """
    rec = _live()
    if rec is None:
        lis = _listener()
        return _NULL if lis is None else lis.kernel(name, cost, plan)
    return rec.kernel(name, cost, plan)


def _listener():
    """The kernel listener: the context's (``kernel_listener``), else a
    ``TorchDispatchMode`` on this thread's mode stack that is one (its
    ``kernel_listener`` attribute true). Autograd runs a CUDA backward on
    a device thread of its own, which inherits the caller's dispatch
    modes but not its context variables: a counting mode there still
    sees the kernels of a rematerialised forward."""
    lis = _LISTENER.get()
    if lis is not None:
        return lis
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "kernel_listener", False):
            return mode
    return None


class kernel_listener:
    """While no probe runs, hand every kernel region to ``listener``'s
    ``kernel(name, cost, plan)``, which returns the region's context (its
    ``probed`` False, its ``fold`` a no-op): the DSE's fingerprint of a
    candidate (``core.incremental.capture_fingerprint``) sees each kernel
    call as one event with its plan, as a jaxpr shows a ``pallas_call``."""

    def __init__(self, listener):
        self.listener = listener

    def __enter__(self):
        self._token = _LISTENER.set(self.listener)
        return self.listener

    def __exit__(self, *exc):
        _LISTENER.reset(self._token)
        return False


def grad(outputs, inputs) -> Tuple[torch.Tensor, ...]:
    """``torch.autograd.grad(outputs, inputs)``: the backward of JAX's
    ``value_and_grad``. While a probe runs, its operations land under the
    backward scopes (see the module docstring)."""
    rec = _live()
    if rec is None:
        return torch.autograd.grad(outputs, inputs)
    return rec.grad(outputs, inputs)


class _RematEnd(torch.autograd.Function):
    """Identity at the end of a checkpointed region that saves a tensor:
    it is the region's first node in the backward, and unpacking that
    tensor runs the recompute before any other node of the region."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(xs[0])
        return xs if len(xs) > 1 else xs[0]

    @staticmethod
    def backward(ctx, *gs):
        ctx.saved_tensors                   # the recompute runs here
        return gs


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable():
    """``remat``'s ``context_fn`` for JAX's
    ``dots_with_no_batch_dims_saveable``: the forward keeps the outputs of
    the matrix products with no batch dimensions (``aten.mm``,
    ``aten.addmm``) in order, and the recompute takes each from there
    instead of running it; every other operation, batched products and
    kernels included, is recomputed. Only the products are intercepted,
    so a probe's own operations in the recompute change nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    saved: List[Any] = []

    class Keep(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in _DOTS:
                saved.append((out.detach(), out._version))
            return out

    class Reuse(TorchDispatchMode):
        i = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func not in _DOTS:
                return func(*args, **(kwargs or {}))
            out, version = saved[self.i]
            if out._version != version:
                raise RuntimeError("a saved matmul output was written in "
                                   "place before the recompute")
            saved[self.i] = None               # held until used once
            self.i += 1
            return out
    return Keep(), Reuse()


def remat(fn: Callable, *args, policy: Optional[str] = None) -> Any:
    """``jax.checkpoint(fn)(*args)``: ``torch.utils.checkpoint``
    (non-reentrant, no early stop, no RNG state) whose recompute runs first
    in the region's backward and, while a probe runs, under
    ``rematted_computation`` at the backward frame of the call. ``fn``
    returns a tensor or a tuple of tensors. ``policy="dots"`` keeps the
    unbatched matmul outputs (``_dots_saveable``), so the recompute runs
    everything but them; None keeps nothing."""
    import torch.utils.checkpoint as tc
    if policy not in (None, "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {"context_fn": _dots_saveable} if policy == "dots" else {}
    first = [True]

    def body(*a):
        rec = None if first[0] else _live()
        first[0] = False
        if rec is None:
            out = fn(*a)
        else:
            with named_scope("rematted_computation"):
                out = fn(*a)
        return _RematEnd.apply(*out) if isinstance(out, tuple) \
            else _RematEnd.apply(out)

    with tc.set_checkpoint_early_stop(False):
        return tc.checkpoint(body, *args, use_reentrant=False,
                             preserve_rng_state=False, **kw)


# --------------------------------------------------------------- tracker

class Frame:
    """One visit of a site: a named scope, a scan iteration, a while
    condition or body, a branch, or the root."""
    __slots__ = ("site", "path", "ord", "kind", "entry", "cur",
                 "transparent", "loop_path", "length")

    def __init__(self, site: int, path: str, kind: str, entry: "Frame" = None,
                 transparent: bool = False, loop_path: Optional[str] = None):
        self.site = site
        self.path = path
        self.ord = 0
        self.kind = kind
        # the frame whose ``cur`` (effective scope path) this visit moves:
        # itself for entry frames, else the enclosing entry frame's
        self.entry = entry if entry is not None else self
        self.cur = path
        self.transparent = transparent
        self.loop_path = loop_path
        self.length = 0                # a scan iteration: the trip count


class SiteTable:
    """Static sites: (parent site, ordinal, tag) -> id, with each site's
    path. A capture grows it; a run reads it."""

    def __init__(self):
        self.ids: Dict[Tuple[int, int, str], int] = {}
        self.paths: List[str] = [""]
        self._loops: Dict[Tuple[str, str], int] = {}

    def child(self, parent: int, ordinal: int, tag: str, path: str,
              grow: bool) -> int:
        key = (parent, ordinal, tag)
        sid = self.ids.get(key)
        if sid is None:
            if not grow:
                raise KeyError(key)
            sid = self.ids[key] = len(self.paths)
            self.paths.append(path)
        return sid

    def loop_name(self, parent_path: str, kind: str) -> str:
        """JAX's numbering: the k-th static loop of ``kind`` under a path."""
        k = self._loops.get((parent_path, kind), 0)
        self._loops[(parent_path, kind)] = k + 1
        return f"{kind}#{k}"


def _join(path: str, name: str) -> str:
    return f"{path}/{name}" if path else name


class Tracker:
    """The frame stack the markers drive. Subclasses fill the hooks:

    ``seg_begin(f)`` / ``seg_end(f, nxt)``  a segment of frame ``f``
        starts / ends; ``nxt`` is the event that ends it (a child key
        or ``END``);
    ``trigger(f)``   a loop or branch point ran at ``f`` (an operation of
        ``f``'s path that costs nothing);
    ``frame_open(f)`` / ``frame_close(f)``  a visit starts / ends;
    ``nodes(path, kind, children)``  a loop node and its fixed children
        (``cond``/``body``, ``branch{i}``) were reached.
    """
    grow_sites = True

    def __init__(self, sites: Optional[SiteTable] = None):
        self.sites = sites if sites is not None else SiteTable()
        self.root = Frame(0, "", "root")
        self.stack: List[Frame] = [self.root]
        self.in_kernel = False
        self.live = False
        self._token = None
        # forward frame stacks by autograd sequence number (see ``grad``)
        self._tag_seq: List[int] = []
        self._tag_stack: List[Tuple[Frame, ...]] = []
        self._bwd = 0                  # > 0 while a backward runs

    # -- activation ------------------------------------------------------
    def __enter__(self):
        self._token = _ACTIVE.set(self)
        self.live = True
        self.frame_open(self.root)
        self.seg_begin(self.root)
        self._tag()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.live = False
        _ACTIVE.reset(self._token)
        if exc_type is None:
            if len(self.stack) != 1:
                raise RuntimeError(
                    f"scope {self.stack[-1].path!r} still open at the end "
                    f"of the run (a loop left early?)")
            self.seg_end(self.root, END)
            self.frame_close(self.root)
        return False

    @property
    def top(self) -> Frame:
        return self.stack[-1]

    # -- hooks (no-ops here) ---------------------------------------------
    def seg_begin(self, f: Frame) -> None: ...
    def seg_end(self, f: Frame, nxt: tuple) -> None: ...
    def trigger(self, f: Frame) -> None: ...
    def frame_open(self, f: Frame) -> None: ...
    def frame_close(self, f: Frame) -> None: ...
    def nodes(self, path: str, kind: str, children: Tuple[str, ...]) -> None: ...

    # -- frame mechanics ---------------------------------------------------
    def _site(self, parent: Frame, tag: str, path: str) -> int:
        return self._sub(parent.site, parent.ord, tag, path, parent.path)

    def _sub(self, site: int, ordinal: int, tag: str, path: str,
             where: str) -> int:
        try:
            return self.sites.child(site, ordinal, tag, path,
                                    self.grow_sites)
        except KeyError:
            raise RuntimeError(
                f"the run left the captured scope sequence: {tag!r} at "
                f"{where or '/'} (segment {ordinal}) was never "
                f"captured") from None

    def _open(self, f: Frame) -> Frame:
        self.stack.append(f)
        self.frame_open(f)
        self.seg_begin(f)
        self._tag()
        return f

    def _close(self, f: Frame) -> None:
        if self.stack[-1] is not f:
            raise RuntimeError(f"scope {f.path!r} closed out of order")
        self.seg_end(f, END)
        self.stack.pop()
        self.frame_close(f)
        self._tag()

    def _tag(self) -> None:
        """Autograd nodes made from here on were made under this stack."""
        if not self._bwd and torch.is_grad_enabled():
            self._tag_seq.append(_SEQ())
            self._tag_stack.append(tuple(self.stack))

    def _resume(self, parent: Frame) -> None:
        parent.ord += 1
        self.seg_begin(parent)

    def _loop_site(self, parent: Frame, kind: str) -> Tuple[int, str]:
        """Site and path of the loop / branch point starting at ``parent``."""
        key = (parent.site, parent.ord, kind)
        sid = self.sites.ids.get(key)
        if sid is None:
            name = self.sites.loop_name(parent.path, kind)
            sid = self._site(parent, kind, _join(parent.path, name))
        path = self.sites.paths[sid]
        nxt = (kind, path.rsplit("/", 1)[-1])
        self.seg_end(parent, nxt)
        self.trigger(parent)
        return sid, path

    # -- markers -----------------------------------------------------------
    def push(self, name: str) -> None:
        parent = self.top
        nxt = ("scope", name)
        path = _join(parent.path, name)
        sid = self._site(parent, "scope:" + name, path)
        self.seg_end(parent, nxt)
        self._open(Frame(sid, path, "scope", parent.entry,
                         parent.transparent))

    def pop(self, name: str) -> None:
        f = self.top
        if f.kind != "scope" or f.path.rsplit("/", 1)[-1] != name:
            raise RuntimeError(f"named_scope({name!r}) closed out of order "
                               f"(open: {f.path!r})")
        self._close(f)
        self._resume(self.top)

    def scan(self, length: int):
        parent = self.top
        sid, path = self._loop_site(parent, "scan")
        self.nodes(path, "loop", ())
        for i in range(length):
            f = Frame(sid, path, "iter", None, parent.transparent,
                      loop_path=path)
            f.length = length
            self._open(f)
            self.iteration(path, length)
            yield i
            self._close(f)
        self._resume(parent)

    def iteration(self, loop_path: str, length: int) -> None:
        """A scan iteration starts (``Capture`` notes the trip count)."""

    def while_loop(self, cond_fn, body_fn, init):
        parent = self.top
        sid, path = self._loop_site(parent, "while")
        self.nodes(path, "while", ("cond", "body"))
        cond_path, body_path = _join(path, "cond"), _join(path, "body")
        val = init
        while True:
            cid = self._sub(sid, 0, "cond", cond_path, path)
            f = self._open(Frame(cid, cond_path, "cond", parent.entry, True))
            go = bool(cond_fn(val))
            self._close(f)
            if not go:
                break
            bid = self._sub(sid, 1, "body", body_path, path)
            f = self._open(Frame(bid, body_path, "body", None,
                                 parent.transparent, loop_path=path))
            val = body_fn(val)
            self._close(f)
        self._resume(parent)
        return val

    def switch(self, index: int, branches, operands):
        parent = self.top
        sid, path = self._loop_site(parent, "cond")
        self.nodes(path, "cond", tuple(f"branch{i}"
                                       for i in range(len(branches))))
        out = self.run_branch(sid, path, index, branches[index], operands,
                              parent)
        self._resume(parent)
        return out

    def run_branch(self, sid: int, path: str, i: int, fn, operands,
                   parent: Frame):
        bpath = _join(path, f"branch{i}")
        bid = self._sub(sid, i, f"branch{i}", bpath, path)
        f = self._open(Frame(bid, bpath, "branch", None, parent.transparent))
        out = fn(*operands)
        self._close(f)
        return out

    def kernel(self, name: str, cost, plan=None):
        return _NULL

    def kernel_event(self, name: str) -> Tuple[Frame, int]:
        """A kernel region with a plan starts at the top frame: it ends
        the frame's segment (an operation of the frame's path, as the
        ``pallas_call`` equation is one) and has a site of its own.
        Returns (frame, site)."""
        parent = self.top
        sid = self._site(parent, "kernel:" + name, parent.path)
        self.seg_end(parent, ("kernel", name))
        self.trigger(parent)
        return parent, sid

    def kernel_done(self, parent: Frame) -> None:
        self._resume(parent)

    # -- backward ------------------------------------------------------------
    def grad(self, outputs, inputs):
        """``torch.autograd.grad`` with every node of the graph hooked so
        that it runs at the backward mirror of its forward frames."""
        outs = [outputs] if isinstance(outputs, torch.Tensor) else \
            list(outputs)
        mirror = _Mirror(self)
        hooks, seen = [], set()
        todo = [o.grad_fn for o in outs]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            hooks.append(node.register_prehook(
                functools.partial(mirror.enter, node)))
            todo.extend(n for n, _ in node.next_functions)
        self._bwd += 1
        try:
            grads = torch.autograd.grad(outs, inputs)
        finally:
            self._bwd -= 1
            for h in hooks:
                h.remove()
        mirror.close()
        return grads


class _Mirror:
    """The backward's frames: for each node, the mirror of the forward
    frames it was made under, below the frame ``grad`` was called at
    (the base). The first named scope gets ``~bwd``; a forward scan's
    iterations run as iterations of a backward loop of its own, kept
    open from one iteration to the next; a while loop or a branch has no
    backward here (the train step has none)."""

    def __init__(self, rec: Tracker):
        self.rec = rec
        self.prefix = tuple(rec.stack)
        self.cur: List[Tuple[Frame, Frame]] = []   # (forward, backward)
        self.loop = None      # (depth, forward site, backward site, path)

    def enter(self, node, grad_outputs):
        rec = self.rec
        if _ACTIVE.get() is not rec:     # autograd's device thread
            _ACTIVE.set(rec)
        i = bisect.bisect_right(rec._tag_seq, node._sequence_nr()) - 1
        fwd = rec._tag_stack[i] if i >= 0 else ()
        n = len(self.prefix)
        rel = fwd[n:] if fwd[:n] == self.prefix else ()
        j = 0
        while j < len(self.cur) and j < len(rel) and self.cur[j][0] is rel[j]:
            j += 1
        if j == len(self.cur) == len(rel):
            return None
        self._close_to(j, rel)
        for f in rel[j:]:
            self._open(f)
        return None

    def close(self) -> None:
        self._close_to(0, ())

    def _close_to(self, j: int, rel) -> None:
        rec = self.rec
        while len(self.cur) > j:
            f, b = self.cur.pop()
            rec._close(b)
            k = len(self.cur)
            if (b.kind == "iter" and k == j and k < len(rel)
                    and rel[k].kind == "iter" and rel[k].site == f.site):
                self.loop = (k, f.site, b.site, b.path)   # next iteration
            else:
                rec._resume(rec.top)

    def _open(self, f: Frame) -> None:
        rec = self.rec
        parent = rec.top
        if f.kind == "scope":
            name = f.path.rsplit("/", 1)[-1]
            if not any(b.kind == "scope" for _, b in self.cur):
                name += "~bwd"
            rec.push(name)
        elif f.kind == "iter":
            loop, self.loop = self.loop, None
            if loop is not None and loop[:2] == (len(self.cur), f.site):
                sid, path = loop[2], loop[3]
            else:
                sid, path = rec._loop_site(parent, "scan")
                rec.nodes(path, "loop", ())
            b = Frame(sid, path, "iter", None, parent.transparent,
                      loop_path=path)
            b.length = f.length
            rec._open(b)
            rec.iteration(path, f.length)
        else:
            raise NotImplementedError(
                f"no backward through a {f.kind} frame ({f.path!r}): the "
                f"port's gradients follow scans and named scopes only")
        self.cur.append((f, rec.top))
