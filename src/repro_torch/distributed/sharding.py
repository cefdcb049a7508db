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
import math
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


def zeros(shape, *axes, dtype, device):
    """``shard(torch.zeros(shape), *axes)`` made a block a rank: each rank
    allocates its own block only (the whole tensor first would be the
    whole cache on every rank, however it is split after)."""
    rules = _ACTIVE_RULES.get()
    mesh = compat.placement_mesh() if rules is not None else None
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = torch.Size(shape)
    spec = to_pspec(axes, rules, shape=tuple(shape), mesh=mesh,
                    manual=compat.manual_axes())
    pl = placements(spec, mesh, len(shape))
    local_shape, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(
        torch.zeros(local_shape, dtype=dtype, device=device), mesh, pl,
        run_check=False, shape=shape, stride=compat.contiguous_stride(shape))


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
    g = 1
    for j, p in enumerate(want):
        if p.is_shard(dim):
            g *= mesh.size(j)
    if n % g:            # mesh dims that divide alone but cut together
        want = [Replicate() if p.is_shard(dim) else p for p in want]
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
    dim (an all-to-all); one whose shards cut microbatches but split
    each of them evenly has its rows sent to the ranks that own them in
    the split (``_MovedRows``, one all-to-all); any other is gathered
    first (``splittable``) and each rank keeps its rows of every
    microbatch (a slice, no communication). Microbatch i is always the
    rows i * b // k .. (i + 1) * b // k - 1, as in JAX: which rows share
    a microbatch decides the tokens a MoE drops at capacity and its aux
    loss."""
    b = x.shape[0]
    shape = (k, b // k) + tuple(x.shape[1:])
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    dims = [j for j, p in enumerate(x.placements)
            if p.is_shard(0) and mesh.size(j) > 1]
    g = math.prod(mesh.size(j) for j in dims)
    if k % g and b % (k * g) == 0 and \
            not any(p.is_partial() for p in x.placements):
        # gathering the batch first would hold all of it on every rank
        return _MovedRows.apply(x, k, tuple(dims))
    y = splittable(x, 0, k).reshape(shape)
    want = [Shard(1) if p.is_shard(0) and (b // k) % mesh.size(j) == 0
            else yp
            for j, (p, yp) in enumerate(zip(x.placements, y.placements))]
    if tuple(want) == tuple(y.placements):
        return y
    return y.redistribute(mesh, want)



def _row_plan(r: int, g: int, k: int):
    """Rank ``r`` of the ``g`` that split a batch of k microbatches,
    each rank's block k units of b // (k g) rows: unit t = r k + c of
    the batch lies in microbatch t // g, and there on rank t % g.
    Returns this rank's units in the
    order it sends them (by the rank they go to), the units it sends to
    each rank and the units it receives from each, which arrive in
    microbatch order."""
    to = [(r * k + c) % g for c in range(k)]
    order = sorted(range(k), key=lambda c: (to[c], c))
    send = [to.count(s) for s in range(g)]
    recv = [sum((q * k + c) % g == r for c in range(k)) for q in range(g)]
    return order, send, recv


def _exchange(units, out_units, in_units, group: str):
    """One all-to-all of (n, u, ...) ``units`` over ``group``: ``in_units``
    of them to each rank in turn, ``out_units`` from each."""
    f = torch.ops._c10d_functional
    u, rest = units.shape[1], tuple(units.shape[2:])
    y = f.wait_tensor(f.all_to_all_single(
        units.reshape((-1,) + rest).contiguous(),
        [n * u for n in out_units], [n * u for n in in_units], group))
    return y.reshape((-1, u) + rest)


class _MovedRows(torch.autograd.Function):
    """``split_leading`` of a DTensor whose dim-0 shards cut its k
    microbatches (over mesh dims ``dims``, g ranks in all) but split
    each evenly: each rank sends every unit of b // (k g) rows to the
    rank that holds it in the microbatch split (``_row_plan``), one
    all-to-all over the flattened group of ``dims``, and holds b / g
    rows throughout; the gradient goes back the same way."""

    @staticmethod
    def forward(ctx, x, k: int, dims: Tuple[int, ...]):
        from torch.distributed.tensor import DTensor, Shard
        mesh = x.device_mesh
        coord = mesh.get_coordinate()
        r = 0
        for j in dims:
            r = r * mesh.size(j) + coord[j]
        order, send, recv = _row_plan(r, math.prod(mesh.size(j)
                                                   for j in dims), k)
        if len(dims) == 1:
            group = mesh.get_group(dims[0]).group_name
        else:
            group = mesh[tuple(mesh.mesh_dim_names[j] for j in dims)] \
                ._flatten().get_group().group_name
        local = x.to_local()
        units = local.reshape((k, local.shape[0] // k) +
                              tuple(local.shape[1:]))
        idx = torch.tensor(order, device=local.device)
        y = _exchange(units.index_select(0, idx), recv, send, group)
        pl = tuple(Shard(p.dim + 1) if p.is_shard() else p
                   for p in x.placements)
        shape = torch.Size((k, x.shape[0] // k) + tuple(x.shape[1:]))
        ctx.back = (mesh, tuple(x.placements), pl, x.shape, x.stride(),
                    torch.argsort(idx), send, recv, group)
        return DTensor.from_local(y, mesh, pl, run_check=False, shape=shape,
                                  stride=compat.contiguous_stride(shape))

    @staticmethod
    def backward(ctx, gy):
        from torch.distributed.tensor import DTensor
        mesh, x_pl, pl, shape, stride, inv, send, recv, group = ctx.back
        units = _exchange(_placed(gy, mesh, pl).to_local(), send, recv,
                          group).index_select(0, inv)
        gx = units.reshape((-1,) + tuple(units.shape[2:]))
        return DTensor.from_local(gx, mesh, x_pl, run_check=False,
                                  shape=shape, stride=stride), None, None

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
    """Identity whose backward places the gradient of a product's output
    as the output was (``foldable`` with it)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is its broadcast: replicated there
        ctx.pl = (y.device_mesh, tuple(Replicate() if p.is_partial() else p
                                       for p in y.placements))
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return foldable(_placed(g, *ctx.pl))


def fsdp_weight(x, w):
    """``w`` (K, N) gathered over each mesh dim that splits both its K
    rows and ``x``'s leading (row) dim, as FSDP gathers a weight before
    its product, so the product keeps ``x``'s rows split. DTensor picks
    the strategy that moves the fewest bytes, which for a wide product
    (the loss's logits) can be to move ``x`` and contract over the split
    K instead: every rank then holds an output partial over all the
    rows, the batch's worth of f32 logits."""
    if not is_dtensor(x) or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard(0) and xp.is_shard(0) else p
            for p, xp in zip(w.placements, x.placements)]
    if tuple(want) == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def fold_matmul(x, w):
    """``x @ w`` for an (..., K) ``x`` and a (K, N) ``w``; on DTensors
    with ``x`` made ``foldable``, and the product's gradient placed as
    the product (a gradient that came back replicated where the product
    was split would make DTensor run the weight's gradient whole on
    every rank)."""
    if not is_dtensor(x) and not is_dtensor(w):
        return x @ w
    return _FoldableGrad.apply(foldable(x) @ w)


def _placed(g, mesh, pl):
    """``g`` as a DTensor with placements ``pl`` on ``mesh``: a replicated
    one keeps its block (a copy, nothing moves)."""
    g = as_dtensor(g, mesh)
    if tuple(g.placements) == tuple(pl):
        return g
    if all(p.is_replicate() for p in g.placements):
        return place(g.to_local(), mesh, pl)        # its block alone, copied
    return g.redistribute(mesh, pl)


class _PlacedGrad(torch.autograd.Function):
    """Identity whose backward places the gradient as the value was."""

    @staticmethod
    def forward(ctx, y):
        ctx.pl = (y.device_mesh, y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _placed(g, *ctx.pl)


def placed_grad(y):
    """``y``, whose gradient (a DTensor's) comes back placed as ``y`` is:
    a reduction's gradient is its output's broadcast, replicated on the
    mesh dims the reduction summed over, and DTensor would otherwise
    make what it meets whole there (the loss's label pick over a sharded
    vocab: a (B, chunk, V) f32 block a rank)."""
    return _PlacedGrad.apply(y) if is_dtensor(y) else y


def gather_rows(table, ids):
    """``table[ids]`` (rows of a (V, d) table). For a DTensor table split
    over its vocab on mesh dims the ids are whole on, each rank looks up
    the ids its block holds, zeros for the others, and the rows are the
    sum over those dims (``Partial``; Megatron's vocab-parallel
    embedding, where making the table whole would hold all of it on
    every rank). For one whose gradient is taken otherwise, each rank
    looks its own ids up in the table made whole. Either way the table's
    gradient is the sum of the ranks' (``Partial`` over the mesh dims
    that split the ids), as JAX's sharded gather: DTensor's own rules
    for an index or an embedding over a sharded table fail in the
    backward (torch 2.11's ``index_put`` strategy; the embedding's
    mask-partial gradient). Without a gradient or a vocab split,
    DTensor's index runs as it is."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    id_pl = list(as_dtensor(ids, mesh).placements)
    vocab = [j for j, p in enumerate(table.placements)
             if p.is_shard(0) and mesh.size(j) > 1 and id_pl[j].is_replicate()]
    if not vocab and not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids]
    ids = as_dtensor(ids, mesh)
    grad_pl = [Partial() if p.is_shard() else Replicate() for p in id_pl]
    if not vocab:
        run = local_map(lambda t, i: t[i], out_placements=id_pl,
                        in_placements=([Replicate()] * mesh.ndim, id_pl),
                        in_grad_placements=(grad_pl, id_pl),
                        device_mesh=mesh, redistribute_inputs=True)
        return run(table, ids)
    # the embed dim stays split where the ids are whole too: each rank
    # looks up its columns
    cols = [j for j, p in enumerate(table.placements)
            if p.is_shard(1) and j not in vocab and id_pl[j].is_replicate()]
    tab_pl = [Shard(0) if j in vocab else Shard(1) if j in cols else
              Replicate() for j in range(mesh.ndim)]
    tab_grad = [p if j in vocab or j in cols else g
                for j, (p, g) in enumerate(zip(tab_pl, grad_pl))]
    out_pl = [Partial() if j in vocab else Shard(ids.dim()) if j in cols
              else p for j, p in enumerate(id_pl)]
    (nv, _), (v0, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, tab_pl)

    def look(t, i):
        at = i.long() - v0
        hit = (at >= 0) & (at < nv)
        rows = t[at.clamp(0, nv - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=t.dtype,
                                                             device=t.device))
    run = local_map(look, out_placements=out_pl,
                    in_placements=(tab_pl, id_pl),
                    in_grad_placements=(tab_grad, id_pl),
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
    shape, off = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    if _put_block(dst, index, value, off):
        return
    if is_dtensor(value):
        value = value.redistribute(mesh, [Replicate()] * mesh.ndim) \
            .to_local()
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


def _put_block(dst, index: tuple, value, off) -> bool:
    """``put`` of a DTensor ``value`` split as ``dst`` is at ``index``
    (a layer's state or K/V rows into a stacked cache): each rank copies
    its own block, nothing moves. It needs every dimension ``dst`` splits
    to be taken whole by ``index`` and split alike in ``value`` (or, an
    int index's, kept whole in ``value``). False where the blocks do not
    line up (the caller makes ``value`` whole)."""
    if not is_dtensor(value) or value.device_mesh != dst.device_mesh:
        return False
    idx = tuple(index) + (slice(None),) * (dst.dim() - len(index))
    vdim: Dict[int, Tuple[int, int, int]] = {}
    for d, e in enumerate(idx):
        if isinstance(e, int):
            continue
        a, b, step = e.indices(dst.shape[d])
        if step != 1 or len(vdim) >= value.dim() or \
                value.shape[len(vdim)] != b - a:
            return False
        vdim[d] = (len(vdim), a, b)
    if len(vdim) != value.dim():
        return False
    for p, vp in zip(dst.placements, value.placements):
        if p.is_shard() and p.dim in vdim:
            vd, a, b = vdim[p.dim]
            if (a, b) != (0, dst.shape[p.dim]) or \
                    not (vp.is_shard() and vp.dim == vd):
                return False
        elif p.is_partial() or not vp.is_replicate():
            return False
    block = dst.to_local()
    at = []
    for d, (e, o, n) in enumerate(zip(idx, off, block.shape)):
        if isinstance(e, int):
            if not o <= e < o + n:
                return True                      # another rank's rows
            at.append(e - o)
        else:
            a, b = vdim[d][1:]
            at.append(slice(max(a, o) - o, min(b, o + n) - o))
    block[tuple(at)] = value.to_local().to(dst.dtype)
    return True
