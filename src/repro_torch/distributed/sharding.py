"""Logical-axis sharding over DTensor: rules mapping logical axes to mesh
axes.

Port of ``repro.distributed.sharding``. Model code annotates activations
with ``shard(x, "batch", "seq", "ff")`` and parameters carry logical axes
in their schema (``models.layers.Param``). A *rule set* (a dict
``logical -> mesh axis | tuple | None``) resolves those names. With no
rule set active everything is a no-op and no DTensor exists, so the
model code is mesh-agnostic and a probe's capture sees the plain ops.

JAX's GSPMD is a compiler pass; PyTorch's counterpart is DTensor, which
propagates placements op by op at run time. The mesh is the ambient
``DeviceMesh`` of ``compat.mesh_context`` (its ``mesh_dim_names`` are
the JAX axis names), one process a device (``launch.mesh.spawn``).
``to_pspec`` keeps JAX's rules (a mesh axis shards at most one
dimension; a dimension its axes do not divide is replicated) and
``placements`` maps a spec onto the mesh: a dimension sharded over a
tuple of axes is ``Shard(i)`` on each of them, the first the outermost
(JAX's ``("pod", "data")`` is pod-major, and so is DTensor's order of
mesh dims when the tuple follows the mesh's order).

A tuple against the mesh's order, ``SERVE_LONG_RULES``' ``kv_seq:
("model", "data")`` on a ``("data", "model")`` mesh, is model-major in
JAX: the sequence's block ``m * n_data + d`` sits at (data d, model m).
DTensor orders a dimension's shards by mesh dim, so ``mesh_for`` gives
such a rule set a mesh over the same ranks with its dims reordered
(``compat.ordered_mesh``: ("model", "data"), or ("pod", "model",
"data")), and the step runs there: every rank keeps its coordinate on
each named axis, so every other spec places each block where it was.
What it costs: one more set of process groups (one a mesh dim, over the
same rank sets as the mesh's own; made once, by every rank together),
and the step's DTensors live on that mesh alone, so its parameters,
cache and batch are placed there, not on the mesh of the training rules.
(DTensor's ``_StridedShard`` describes the same layout on the mesh as it
is, but few of its operations' rules take it; ``placements`` still
raises for a tuple against the order of the mesh it is given.)

Plain tensors meet DTensors everywhere in the model (positions, masks,
index tensors, the zeros of a cache): the port treats every plain tensor
made under active rules as replicated (``implicit_replication``, entered
once by ``axis_rules`` with a mesh). A plain tensor is the same value on
every rank by construction (the batch is given whole to every rank, the
rest is made from shapes), which is exactly JAX's contract for an
unannotated value inside ``jit``.

``shard`` redistributes a DTensor to the resolved placements (a plain
tensor becomes a replicated DTensor first), as
``with_sharding_constraint`` moves a value's sharding; the value is the
same. Kernels are custom ops DTensor has no sharding strategy for:
``kernels.ops`` runs them per rank through ``local_map``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import compat
from repro_torch.distributed.compat import P, is_dtensor

_ACTIVE_RULES: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("repro_torch_axis_rules", default=None)


# Rule sets (the JAX package's, verbatim). ``pod`` only exists on the
# multi-pod mesh; resolution drops mesh axes that are absent from the
# active mesh.
TRAIN_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    # FSDP: weight embed-dim sharded over data AND pod (ZeRO-3 across
    # pods — param/optimizer state halves again on the multi-pod mesh;
    # the cross-DCI gathers are the price, and what int8_ef compression
    # and microbatch overlap are for). Single-pod meshes filter "pod"
    # out automatically.
    "embed": ("pod", "data"),
    "vocab": "model",
    "ff": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "q_per_kv": None,
    "head_dim": None,
    "expert": None,           # experts replicated; expert d_ff TP-sharded
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_head_dim": None,
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "kv_seq": None,
    # Megatron-style sequence parallelism for the residual stream: the
    # between-layer carry (what remat stashes per layer!) is sharded over
    # the model axis on seq; GSPMD inserts the all-gather before attention
    # and the reduce-scatter after per-token blocks. 16x smaller stash.
    "act_seq": "model",
}

# Serving: batch over (pod, data); KV cache sequence-sharded over the
# model axis (distributed split-KV decode — always divisible, unlike
# kv_heads which is < 16 on most assigned archs).
SERVE_RULES: Dict[str, Any] = dict(TRAIN_RULES)
SERVE_RULES.update({"batch": ("pod", "data"), "embed": "data",
                    "kv_seq": "model"})

# long_500k (global_batch=1): batch can't shard — spread the KV/state
# sequence over BOTH axes (524288 / 256 = 2048 per device).
SERVE_LONG_RULES: Dict[str, Any] = dict(SERVE_RULES)
SERVE_LONG_RULES.update({"batch": "pod", "kv_seq": ("model", "data")})


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        names = getattr(mesh, "axes", ())
    return tuple(names)


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, a ``compat.MeshEnv`` or a
    mapping."""
    if isinstance(mesh, dict):
        return {k: int(v) for k, v in mesh.items()}
    if isinstance(mesh, compat.MeshEnv):
        return mesh.sizes
    return {n: int(s) for n, s in zip(_axis_names(mesh), mesh.shape)}


@contextlib.contextmanager
def _replicating():
    """Plain tensors count as replicated DTensors inside (re-entrant)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with implicit_replication():
        yield


@contextlib.contextmanager
def axis_rules(rules: Optional[Dict[str, Any]], mesh=None):
    """Activate a rule set (filtered to ``mesh``'s axis names when given).
    With a ``DeviceMesh``, plain tensors count as replicated inside."""
    if rules is not None and mesh is not None:
        rules = filter_rules(rules, mesh)
    tok = _ACTIVE_RULES.set(rules)
    try:
        if rules is not None and mesh is not None and \
                not isinstance(mesh, (dict, compat.MeshEnv)):
            with _replicating():
                yield
        else:
            yield
    finally:
        _ACTIVE_RULES.reset(tok)


def filter_rules(rules: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Drop mesh axes that don't exist on ``mesh`` from every rule."""
    names = set(_axis_names(mesh) if not isinstance(mesh, dict) else mesh)

    def fix(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        v = tuple(a for a in v if a in names)
        return v if len(v) > 1 else (v[0] if v else None)

    return {k: fix(v) for k, v in rules.items()}


def current_rules() -> Optional[Dict[str, Any]]:
    return _ACTIVE_RULES.get()


def to_pspec(axes: Sequence[Any], rules: Dict[str, Any],
             shape: Optional[Sequence[int]] = None, mesh=None,
             manual: Sequence[str] = ()) -> P:
    """Resolve logical axis names to a ``compat.P``.

    - a mesh axis may shard at most one dimension (later dup dropped);
    - with ``shape`` + ``mesh``: any dimension NOT divisible by its mesh
      axes' size is replicated (e.g. kv_heads=8 or q_heads=36 on a
      model=16 mesh);
    - ``manual`` axes (those a ``compat.shard_map`` body already splits)
      are implicit and dropped."""
    sizes = _mesh_axis_sizes(mesh) if mesh is not None else None
    used: set = set()
    parts = []
    for i, a in enumerate(axes):
        r = rules.get(a) if a is not None else None
        if r is None:
            parts.append(None)
            continue
        rt = (r,) if isinstance(r, str) else tuple(r)
        rt = tuple(x for x in rt if x not in used and x not in manual)
        if sizes is not None and shape is not None and rt:
            total = 1
            for x in rt:
                total *= sizes.get(x, 1)
            if total == 0 or shape[i] % total != 0:
                parts.append(None)
                continue
        used.update(rt)
        parts.append(rt if len(rt) > 1 else (rt[0] if rt else None))
    return P(*parts)


def mesh_for(mesh, rules: Optional[Dict[str, Any]]):
    """``mesh`` (a ``DeviceMesh``) with its dims in an order every
    multi-axis rule of ``rules`` follows (the module docstring): ``mesh``
    itself when its own order does, or without rules or a mesh."""
    if mesh is None or rules is None or isinstance(mesh, (dict,
                                                          compat.MeshEnv)):
        return mesh
    names = _axis_names(mesh)
    order = list(names)
    for v in rules.values():
        if isinstance(v, (tuple, list)):
            axes = [a for a in v if a in names]
            for i, a in zip(sorted(order.index(a) for a in axes), axes):
                order[i] = a
    return compat.ordered_mesh(mesh, order)


def placements(spec: Optional[P], mesh, ndim: Optional[int] = None):
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): per
    mesh dim, ``Shard(i)`` for the tensor dim ``i`` its axis shards, else
    (an axis of size 1 too) ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    n = len(spec or ()) if ndim is None else ndim
    out = [Replicate()] * len(names)
    for i, axes in enumerate(compat.spec_axes(spec, n)):
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"dimension {i} sharded over {axes}, against the mesh's "
                f"order {names}: DTensor orders a dimension's shards by "
                f"mesh dim (place it on sharding.mesh_for's mesh)")
        for j in idx:
            if mesh.size(j) > 1:    # a size-1 axis splits nothing, and a
                out[j] = Shard(i)   # Shard there blocks DTensor's views
    return tuple(out)


def as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor (the same value on
    every rank) becomes a replicated one."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local(x):
    """This rank's block of a DTensor (the tensor itself otherwise)."""
    return x.to_local() if is_dtensor(x) else x


def shard(x, *axes):
    """Constrain ``x``'s sharding by logical axis names (no-op without
    rules, without a ``DeviceMesh``, or in a ``compat.shard_map`` body
    whose every axis is manual)."""
    rules = _ACTIVE_RULES.get()
    if rules is None:
        return x
    if x.dim() != len(axes):
        raise ValueError(f"rank {x.dim()} vs axes {axes}")
    mesh = compat.placement_mesh()
    if mesh is None:
        return x
    spec = to_pspec(axes, rules, shape=tuple(x.shape), mesh=mesh,
                    manual=compat.manual_axes())
    x = as_dtensor(x, mesh)
    want = placements(spec, mesh, x.dim())
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def splittable(x, dim: int, n: int):
    """``x`` with dimension ``dim`` replicated on each mesh dim whose
    shards would not hold whole groups of ``x.shape[dim] // n``, so that
    the dimension can be unflattened to (n, ...): DTensor refuses to
    split a dimension its shards cut unevenly (JAX's GSPMD reshards
    there by itself). A plain tensor, or a DTensor whose shards hold
    whole groups, is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.dim()
    mesh = x.device_mesh
    want = [Replicate() if p.is_shard(dim) and n % mesh.size(j) else p
            for j, p in enumerate(x.placements)]
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)


def pad(x, pads):
    """``F.pad(x, pads)`` with zeros. A DTensor is padded a block a rank:
    the padded dims replicated first (a gather where one is sharded),
    then each rank pads its block, the other placements kept. (Torch
    2.11's DTensor rule for a pad plans a redistribution past the mesh's
    dims and fails; a zero pad of a ``Partial`` block sums to the zero
    pad of the sum.)"""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return F.pad(x, pads)
    from torch.distributed.tensor import DTensor, Replicate
    shape = list(x.shape)
    for i in range(0, len(pads), 2):
        shape[x.dim() - 1 - i // 2] += pads[i] + pads[i + 1]
    shape = torch.Size(shape)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard() and shape[p.dim] != x.shape[p.dim]
          else p for p in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    return DTensor.from_local(F.pad(x.to_local(), pads), mesh, pl,
                              run_check=False, shape=shape,
                              stride=compat.contiguous_stride(shape))


def split_leading(x, k: int):
    """``x`` (b, ...) as (k, b // k, ...): JAX's microbatch split, each
    microbatch spread over the mesh dims that spread the batch (as GSPMD
    spreads it), so a microbatch's rows are split as the batch's were
    and picking one moves nothing. A DTensor whose dim-0 shards hold
    whole microbatches is resharded from the microbatch dim to the row
    dim (an all-to-all); one whose shards cut microbatches is gathered
    first (``splittable``) and each rank keeps its rows of every
    microbatch (a slice, no communication)."""
    b = x.shape[0]
    shape = (k, b // k) + tuple(x.shape[1:])
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    y = splittable(x, 0, k).reshape(shape)
    want = [Shard(1) if p.is_shard(0) and (b // k) % mesh.size(j) == 0
            else yp
            for j, (p, yp) in enumerate(zip(x.placements, y.placements))]
    if tuple(want) == tuple(y.placements):
        return y
    return y.redistribute(mesh, want)


def foldable(x):
    """``x`` with its leading dimensions foldable into one, as a matrix
    product of an (..., K) tensor folds them: each of them but the first
    replicated on the mesh dims that shard it. DTensor (torch 2.11)
    refuses a view that merges a sharded dimension into an outer one;
    JAX's GSPMD gathers there by itself (the sequence-parallel residual's
    seq before attention and the MLP). A plain tensor, or one with
    nothing to gather, is returned as it is."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1 else p
            for p in x.placements]
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _FoldableGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient ``foldable``: the
    gradient of a product's output is folded as its output was."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return foldable(g)


def fold_matmul(x, w):
    """``x @ w`` for an (..., K) ``x`` and a (K, N) ``w``; on DTensors
    with ``x`` made ``foldable``, and the product's gradient too."""
    if not is_dtensor(x) and not is_dtensor(w):
        return x @ w
    return _FoldableGrad.apply(foldable(x) @ w)


class _PlacedGrad(torch.autograd.Function):
    """Identity whose backward places the gradient as the value was."""

    @staticmethod
    def forward(ctx, y):
        ctx.pl = (y.device_mesh, y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.pl
        g = as_dtensor(g, mesh)
        if tuple(g.placements) == tuple(pl):
            return g
        if all(p.is_replicate() for p in g.placements):
            return place(g.to_local(), mesh, pl)    # its block alone, copied
        return g.redistribute(mesh, pl)


def placed_grad(y):
    """``y``, whose gradient (a DTensor's) comes back placed as ``y`` is:
    a reduction's gradient is its output's broadcast, replicated on the
    mesh dims the reduction summed over, and DTensor would otherwise
    make what it meets whole there (the loss's label pick over a sharded
    vocab: a (B, chunk, V) f32 block a rank)."""
    return _PlacedGrad.apply(y) if is_dtensor(y) else y


def gather_rows(table, ids):
    """``table[ids]`` (rows of a (V, d) table). For a DTensor table whose
    gradient is taken, each rank looks its own ids up in the table made
    whole, and the table's gradient is the sum of the ranks'
    (``Partial`` over the mesh dims that split the ids), as JAX's
    sharded gather: DTensor's own rules for an index or an embedding
    over a sharded table fail in the backward (torch 2.11's
    ``index_put`` strategy; the embedding's mask-partial gradient).
    Without a gradient, DTensor's index runs as it is."""
    if not is_dtensor(table) or not (torch.is_grad_enabled()
                                     and table.requires_grad):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    ids = as_dtensor(ids, mesh)
    id_pl = list(ids.placements)
    grad_pl = [Partial() if p.is_shard() else Replicate() for p in id_pl]
    run = local_map(lambda t, i: t[i], out_placements=id_pl,
                    in_placements=([Replicate()] * mesh.ndim, id_pl),
                    in_grad_placements=(grad_pl, id_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(table, ids)


def _is_param(x) -> bool:
    from repro_torch.models.layers import Param
    return isinstance(x, Param)


def _map_schema(fn, schema):
    if _is_param(schema):
        return fn(schema)
    return {k: _map_schema(fn, v) for k, v in schema.items()}


def schema_pspecs(schema: Any, rules: Dict[str, Any], mesh) -> Any:
    """Param-schema tree -> divisibility-resolved ``P`` tree. ``mesh`` is
    a ``DeviceMesh``, a ``compat.MeshEnv`` or ``{axis: size}``."""
    rules = filter_rules(rules, mesh)
    return _map_schema(
        lambda p: to_pspec(p.axes, rules, shape=p.shape, mesh=mesh), schema)


def param_shardings(schema: Any, mesh, rules: Dict[str, Any]) -> Any:
    """Param-schema tree -> the DTensor placements of every leaf."""
    return _map_schema(
        lambda p: placements(to_pspec(p.axes, filter_rules(rules, mesh),
                                      shape=p.shape, mesh=mesh),
                             mesh, len(p.shape)), schema)


def distribute_params(params: Any, schema: Any, mesh,
                      rules: Dict[str, Any]) -> Any:
    """A parameter tree (whole on every rank) as DTensors placed by
    ``param_shardings`` on ``compat.sub_mesh`` of ``mesh`` (the mesh
    ``shard`` places on): each rank keeps its block, nothing moves."""
    mesh = compat.sub_mesh(mesh, _axis_names(mesh))
    places = param_shardings(schema, mesh, rules)

    def put(x, pl):
        if isinstance(x, dict):
            return {k: put(x[k], pl[k]) for k in x}
        return place(x, mesh, pl)
    return put(params, places)


def place(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """``x`` (whole on every rank) as a DTensor with placements ``pl`` on
    ``mesh``: this rank keeps a copy of its block, nothing moves."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    idx = tuple(slice(o, o + s) for o, s in zip(offset, shape))
    return DTensor.from_local(x[idx].clone(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def gather(tree: Any) -> Any:
    """Every DTensor leaf of a tree gathered whole (``full_tensor``); the
    other leaves as they are. Every rank calls it together."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[gather(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v) for v in tree)
    return tree.full_tensor() if is_dtensor(tree) else tree


def put(dst: torch.Tensor, index: tuple, value: torch.Tensor) -> None:
    """``dst[index] = value`` in place, for a DTensor ``dst`` too: each
    rank writes the part of its block that ``index`` (ints and unit-step
    slices over leading dims) covers, from ``value`` made whole. A plain
    ``dst`` takes the plain assignment."""
    if not is_dtensor(dst):
        dst[index] = value
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    if is_dtensor(value):
        value = value.redistribute(mesh, [Replicate()] * mesh.ndim) \
            .to_local()
    shape, off = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    idx = tuple(index) + (slice(None),) * (dst.dim() - len(index))
    at, of_value = [], []
    for d, (e, o, n) in enumerate(zip(idx, off, shape)):
        if isinstance(e, int):
            if not o <= e < o + n:
                return                       # another rank's rows
            at.append(e - o)
            continue
        a, b, step = e.indices(dst.shape[d])
        if step != 1:
            raise ValueError("put takes unit-step slices")
        lo, hi = max(a, o), min(b, o + n)
        if lo >= hi:
            return
        at.append(slice(lo - o, hi - o))
        of_value.append(slice(lo - a, hi - a))
    dst.to_local()[tuple(at)] = value[tuple(of_value)].to(dst.dtype)
