"""The ambient mesh, per-device collectives and ``shard_map``, eagerly.

Port of ``repro.distributed.compat``. A JAX ``shard_map`` over a mesh of
N devices in one process becomes N processes here, one a device (see
``launch.mesh.spawn``): each runs the per-shard body on its own shard,
and the body's collectives go over ``torch.distributed``. Only what has
an eager meaning is ported:

- ``mesh_context`` / ``get_mesh``: the ambient ``DeviceMesh`` (a context
  variable), whose ``mesh_dim_names`` are the JAX axis names;
- ``axis_index(axis)``: this device's coordinate on ``axis``, a 0-d
  int64 tensor (``lax.axis_index``), so device-varying control flow goes
  through ``scope.cond`` / ``scope.while_loop`` as data, as in JAX;
- the collectives ``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
  ``all_to_all`` and ``ppermute`` over named axes. Each is one
  functional dispatcher operation (``_c10d_functional``: what
  ``torch.distributed._functional_collectives`` calls) and its
  ``wait_tensor``, so a capture sees it, prices it and writes nothing in
  place. The operation names its process group, and ``group_axes`` maps
  the group back to the mesh axes (the collective's G);
- ``shard_map(f, mesh=, in_specs=, out_specs=[, axis_names=])``: each
  global argument sliced to this device's shard, ``f`` run, and the
  outputs a spec shards gathered back; ``P`` is the port's
  ``PartitionSpec``. With DTensor arguments (``distributed.sharding``)
  the manual axes (``axis_names``, default all) are sliced from each
  DTensor's placement and the others stay DTensor placements on the
  sub-mesh of the auto axes (``placement_mesh`` inside the body), as
  JAX's partial-manual ``shard_map`` keeps them auto-sharded; the
  outputs come back as DTensors on the whole mesh. A collective over
  manual axes acts on each rank's block of a DTensor; ``psum`` and
  ``all_gather`` carry gradients (their transposes: identity for the
  replicated sum, ``psum_scatter`` for the gather). A DTensor
  argument's cotangent is summed over the manual axes its spec leaves
  it replicated on, as JAX's transpose (``check_vma=False``) psums it.
  JAX also divides an output's cotangent by the size of the manual axes
  it is replicated over and transposes psum to psum; here both are the
  identity. The gradients are the same where a body makes every output
  replicated over a manual axis so by a psum or pmean over that axis,
  as the sharded MoE does.

Backends: NCCL takes the card's tensors for every kind. gloo takes host
tensors for every kind; on an H100 under torch 2.11.0+cu128 it runs
all-reduce, reduce-scatter, all-to-all and permute on the card's tensors
too, but its all-gather crashes the rank (SIGSEGV; ``chip_smoke.py``
step 17 reports each kind). So the gathers this module makes outside a
body (``gather_shard``: outputs a spec shards) go through the host under
gloo, and a body's ``all_gather`` over gloo wants host tensors.

``replay_context`` makes a mesh that has no process group: the mesh's
axes and this replay's device coordinates. ``core.meshprobe.ShardOracle``
replays one device's shard under it, with every collective stubbed, so a
process with no process group at all can replay any device.

No counterpart: the jax-0.4 shims (``supports_partial_manual``, the
full-manual fallback, ``extend_axis_env``) bridge JAX versions; eager
PyTorch has one API and traces nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Union[str, Sequence[str]]


class P(tuple):
    """``PartitionSpec``: per dimension an axis name, a tuple of names, or
    None (replicated); missing trailing dimensions are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshEnv:
    """The ambient mesh as the port's collectives see it."""
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]           # this device's (or the replayed one's)
    device: Optional[torch.device]    # where ``axis_index`` lives
    mesh: Any = None                  # the DeviceMesh; None in a replay
    manual: Tuple[str, ...] = ()      # inside a DTensor shard_map body:
    auto: Any = None                  # its manual axes, the auto sub-mesh

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))

    @property
    def replay(self) -> bool:
        return self.mesh is None


_ENV: "contextvars.ContextVar[Optional[MeshEnv]]" = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_PERMUTE: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "repro_torch_permute", default=False)
# process-group name -> the mesh axes it spans (filled as groups are named)
_GROUP_AXES: Dict[str, Tuple[str, ...]] = {}


def env_of(mesh, device=None) -> MeshEnv:
    """The ``MeshEnv`` of a ``DeviceMesh`` on this process."""
    axes = tuple(mesh.mesh_dim_names)
    if device is None:
        device = (torch.device("cpu") if mesh.device_type == "cpu" else
                  torch.device(mesh.device_type,
                               torch.cuda.current_device()))
    return MeshEnv(axes=axes, shape=tuple(int(s) for s in mesh.shape),
                   coords=tuple(int(c) for c in mesh.get_coordinate()),
                   device=torch.device(device), mesh=mesh)


@contextlib.contextmanager
def mesh_context(mesh, device=None):
    """Enter ``mesh`` (a ``DeviceMesh`` or a ``MeshEnv``) as the ambient
    mesh; ``None`` is a no-op. ``device`` is where ``axis_index`` puts
    its tensor (default: the mesh's device type, this process's card)."""
    if mesh is None:
        yield
        return
    env = mesh if isinstance(mesh, MeshEnv) else env_of(mesh, device)
    tok = _ENV.set(env)
    try:
        yield env
    finally:
        _ENV.reset(tok)


def replay_context(axes: Sequence[str], shape: Sequence[int],
                   coords: Sequence[int], device=None):
    """A mesh with no process group, seen from the device at ``coords``."""
    return mesh_context(MeshEnv(tuple(axes), tuple(int(s) for s in shape),
                                tuple(int(c) for c in coords),
                                torch.device(device or "cpu")))


def current() -> Optional[MeshEnv]:
    return _ENV.get()


def get_mesh():
    """The ambient ``DeviceMesh``, or None (no mesh, or a replay)."""
    env = _ENV.get()
    return env.mesh if env is not None else None


_SUBMESHES: Dict[Tuple[Any, Tuple[str, ...]], Any] = {}


def sub_mesh(mesh, axes: Sequence[str]):
    """The ``DeviceMesh`` of ``axes`` (mesh order) of ``mesh``, without
    its axes of size 1 unless every one is: a size-1 axis splits nothing,
    and each mesh dim multiplies the placements DTensor weighs for every
    op (on a (2, 1, 2) mesh the first step's sharding propagation takes
    minutes, on (2, 2) seconds)."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in set(axes))
    big = tuple(a for a in axes if mesh.size(names.index(a)) > 1)
    axes = big or axes
    if axes == names:
        return mesh
    key = (mesh, axes)
    if key not in _SUBMESHES:
        _SUBMESHES[key] = mesh[axes]
    return _SUBMESHES[key]


# (mesh, axes) -> (mesh, the mesh with its dims in that order)
_ORDERED: Dict[Tuple[Any, Tuple[str, ...]], Tuple[Any, Any]] = {}


def ordered_mesh(mesh, axes: Sequence[str]):
    """A ``DeviceMesh`` over the same ranks as ``mesh`` with its dims in
    the order ``axes`` (a permutation of its names): rank r keeps its
    coordinate on every named axis, and each dim's process groups span
    the ranks they span on ``mesh``. Built once (every rank together:
    it creates process groups) and cached."""
    names, axes = tuple(mesh.mesh_dim_names), tuple(axes)
    if axes == names:
        return mesh
    if sorted(axes) != sorted(names):
        raise ValueError(f"{axes} is no order of the mesh axes {names}")
    key = (mesh, axes)
    held = _ORDERED.get(key)
    if held is None or held[0] is not mesh:  # an equal mesh of a world gone
        from torch.distributed.device_mesh import DeviceMesh
        perm = [names.index(a) for a in axes]
        held = _ORDERED[key] = (mesh, DeviceMesh(
            mesh.device_type, mesh.mesh.permute(perm), mesh_dim_names=axes))
    return held[1]


def forget_dtensor_plans() -> None:
    """Drop DTensor's cached sharding decisions (its Python caches and
    its C++ dispatch's). They are keyed by op schemas whose meshes
    compare equal across worlds, so a later world of the same shape
    would get a gone world's mesh and process groups; and a decision
    cached for one op is reused for a later op whose key is equal but
    for which a fresh decision differs, so what a step runs (and a dry
    run counts) would depend on what ran before it in the process."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for cached in (getattr(prop, "propagate_op_sharding", None),
                   getattr(prop, "_propagate_tensor_meta_cached", None),
                   getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(cached, "cache_clear"):
            cached.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


def forget_mesh(mesh) -> None:
    """Drop ``sub_mesh``'s cached sub-meshes of ``mesh`` (its process
    group is going away)."""
    for cache in (_SUBMESHES, _ORDERED):
        for key in [k for k in cache if k[0] is mesh]:
            del cache[key]


def placement_mesh():
    """The ``DeviceMesh`` DTensor placements live on: the ambient mesh's
    axes (``sub_mesh``), or inside a DTensor ``shard_map`` body its auto
    axes (None when every axis is manual)."""
    env = _ENV.get()
    if env is None or env.mesh is None:
        return None
    if env.manual:
        return env.auto
    return sub_mesh(env.mesh, env.axes)


def manual_axes() -> Tuple[str, ...]:
    env = _ENV.get()
    return env.manual if env is not None else ()


def _env() -> MeshEnv:
    env = _ENV.get()
    if env is None:
        raise RuntimeError("no ambient mesh: run inside compat.mesh_context "
                           "(or a mesh-probed function)")
    return env


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: Axes) -> int:
    sizes = _env().sizes
    n = 1
    for a in _axes(axis):
        if a not in sizes:
            raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                             f"{tuple(sizes)}")
        n *= sizes[a]
    return n


def axis_index(axis: Axes) -> torch.Tensor:
    """This device's coordinate on ``axis`` (row-major over a tuple of
    axes), a 0-d int64 tensor."""
    return torch.full((), _rank_in(axis), dtype=torch.int64,
                      device=_env().device)


def group_name(axis: Axes) -> str:
    """The process group over ``axis`` (registered for ``group_axes``)."""
    env = _env()
    axes = _axes(axis)
    for a in axes:
        if a not in env.axes:
            raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                             f"{env.axes}")
    if env.replay:
        name = "replay:" + "/".join(axes)
    elif len(axes) == 1:
        name = env.mesh.get_group(axes[0]).group_name
    elif sorted(axes, key=env.axes.index) == list(env.axes):
        import torch.distributed as dist
        if env.mesh.size() != dist.get_world_size():
            raise NotImplementedError(
                f"a collective over {axes} needs a mesh that covers the "
                f"world")
        name = dist.group.WORLD.group_name
    else:
        # some, not all, of the mesh's axes (a psum over ("pod", "data")
        # on the 2x16x16 mesh): the group of the sub-mesh of those axes
        # flattened into one (made once, every rank together), its ranks
        # in the mesh's order, as the whole world's are above
        sub = tuple(a for a in env.axes if a in axes)
        name = env.mesh[sub]._flatten().get_group().group_name
    _GROUP_AXES[name] = axes
    return name


def group_axes(name: Any) -> Tuple[str, ...]:
    """The mesh axes of a process group named by ``group_name``; () for
    a group this module did not name."""
    return _GROUP_AXES.get(str(name), ())


def is_permute() -> bool:
    """Is the all_to_all_single being dispatched a ``ppermute``?"""
    return _PERMUTE.get()


# ----------------------------------------------------------- collectives

def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor? (Without importing ``torch.distributed``.)"""
    return type(x) is not torch.Tensor and hasattr(x, "placements")


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (worked out, not
    allocated: an allocation would be counted by a dry run)."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(n)
    return tuple(reversed(out))


def zeros_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``x``'s shape in ``dtype`` on its device; a DTensor's keep
    its placements (each rank makes its block)."""
    if is_dtensor(x):
        return torch.zeros_like(x, dtype=dtype)
    return torch.zeros(x.shape, dtype=dtype, device=x.device)


def _blockwise(fn):
    """A collective over manual axes on a DTensor (auto axes): it acts on
    this rank's block, and the result keeps the placements."""
    @functools.wraps(fn)
    def run(x, *args, **kwargs):
        if not is_dtensor(x):
            return fn(x, *args, **kwargs)
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(fn(x.to_local(), *args, **kwargs),
                                  x.device_mesh, x.placements,
                                  run_check=False)
    return run


def _all_reduce(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(x, "sum", group_name(axis)))


class _Psum(torch.autograd.Function):
    """psum whose result is used replicated: the cotangent passes as is."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """all_gather (tiled); its transpose sums the blocks (psum_scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.axis, ctx.dim), None, None


def _wants_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


@_blockwise
def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    if _wants_grad(x):
        return _Psum.apply(x, axis)
    return _all_reduce(x, axis)


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """psum / G, as ``lax.pmean`` (gloo has no average reduction)."""
    return psum(x, axis) / axis_size(axis)


@_blockwise
def all_gather(x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
    """Concatenate every device's ``x`` along ``dim`` (``tiled=True``)."""
    if _wants_grad(x):
        return _AllGather.apply(x, axis, dim)
    return _all_gather(x, axis, dim)


def _all_gather(x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    y = x.movedim(dim, 0).contiguous() if dim else x.contiguous()
    out = f.wait_tensor(f.all_gather_into_tensor(y, g, group_name(axis)))
    return out.movedim(0, dim) if dim else out


@_blockwise
def psum_scatter(x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
    """Sum over devices, each keeping its block of ``dim`` (tiled)."""
    return _psum_scatter(x, axis, dim)


def _psum_scatter(x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    y = x.movedim(dim, 0).contiguous() if dim else x.contiguous()
    out = f.wait_tensor(f.reduce_scatter_tensor(y, "sum", g,
                                                group_name(axis)))
    return out.movedim(0, dim) if dim else out


@_blockwise
def all_to_all(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Block i of dim 0 goes to device i; dim 0 of the result is the
    blocks received, in device order."""
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    split = [x.shape[0] // g] * g
    return f.wait_tensor(f.all_to_all_single(x.contiguous(), split, split,
                                             group_name(axis)))


@_blockwise
def ppermute(x: torch.Tensor, axis: Axes,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` to the devices ``perm`` pairs this one with (src, dst);
    a device that receives nothing gets zeros, as in JAX."""
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    me = _rank_in(axis)
    n = x.numel()
    send = [0] * g
    recv = [0] * g
    for src, dst in perm:
        if src == me:
            send[dst] = n
        if dst == me:
            recv[src] = n
    tok = _PERMUTE.set(True)
    try:
        out = f.wait_tensor(f.all_to_all_single(
            x.reshape(-1).contiguous(), recv, send, group_name(axis)))
    finally:
        _PERMUTE.reset(tok)
    if sum(recv) == 0:
        return torch.zeros_like(x)
    return out.reshape(x.shape)


def _rank_in(axis: Axes) -> int:
    """This device's index over ``axis`` (row-major over a tuple)."""
    env = _env()
    idx = 0
    for a in _axes(axis):
        i = env.axes.index(a)
        idx = idx * env.shape[i] + env.coords[i]
    return idx


# ------------------------------------------------------- specs and shards

def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, P)


def tree_leaves(tree) -> List[Any]:
    """Leaves of a dict / list / tuple tree, dict keys in sorted order
    (the JAX package's pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves: Sequence[Any]):
    """``template``'s structure filled with ``leaves`` (tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)) and not isinstance(t, P):
            kids = [build(x) for x in t]
            return type(t)(*kids) if hasattr(t, "_fields") else type(t)(kids)
        return next(it)
    return build(template)


def flat_specs(spec_tree, arg_tree, what: str) -> List[Optional[P]]:
    """Broadcast a (possibly prefix) spec tree over ``arg_tree``: one spec
    per argument leaf, the shard_map convention."""
    out: List[Optional[P]] = []

    def walk(spec, arg, where):
        if _is_spec_leaf(spec):
            out.extend([spec] * len(tree_leaves(arg)))
        elif isinstance(spec, dict):
            if not isinstance(arg, dict) or set(spec) != set(arg):
                raise ValueError(f"{what} is not a prefix of the argument "
                                 f"structure at {where or '/'}")
            for k in sorted(arg):
                walk(spec[k], arg[k], f"{where}/{k}")
        elif isinstance(spec, (list, tuple)):
            if not isinstance(arg, (list, tuple)) or len(spec) != len(arg):
                raise ValueError(f"{what} is not a prefix of the argument "
                                 f"structure at {where or '/'}")
            for i, (s, a) in enumerate(zip(spec, arg)):
                walk(s, a, f"{where}/{i}")
        else:
            raise ValueError(f"{what}: bad spec {spec!r} at {where or '/'}")
    walk(spec_tree, arg_tree, "")
    return out


def spec_axes(spec: Optional[P], ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """Per-dimension mesh axes of a spec, padded to ``ndim``."""
    entries = tuple(spec) if spec is not None else ()
    out = []
    for i in range(ndim):
        e = entries[i] if i < len(entries) else None
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    return tuple(out)


def shard_shape(shape: Tuple[int, ...], spec: Optional[P],
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    out = []
    for dim, axes in zip(shape, spec_axes(spec, len(shape))):
        k = 1
        for a in axes:
            k *= int(sizes.get(a, 1))
        if k > 1 and dim % k != 0:
            raise ValueError(f"dimension {dim} not divisible by mesh axes "
                             f"{axes} (size {k}) — spec {spec} on {shape}")
        out.append(dim // k)
    return tuple(out)


def shard_slice(x, spec: Optional[P], sizes: Dict[str, int],
                coords: Dict[str, int]):
    """The shard of global ``x`` owned by the device at ``coords`` (a view
    of a tensor; numpy arrays and Python scalars alike)."""
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    shard_shape(tuple(x.shape), spec, sizes)       # divisibility check
    idx: List[slice] = []
    for dim, axes in zip(x.shape, spec_axes(spec, x.ndim)):
        k = 1
        block = 0
        for a in axes:
            k *= int(sizes.get(a, 1))
            block = block * int(sizes.get(a, 1)) + int(coords.get(a, 0))
        bs = dim // max(k, 1)
        idx.append(slice(block * bs, (block + 1) * bs))
    return x[tuple(idx)]


def gather_shard(x, spec: Optional[P]):
    """The global value of an output whose shard on this device is ``x``
    (``spec`` shards it): every sharded dimension gathered over its axes,
    outside any capture (gloo takes host tensors, so the gather goes
    through the host there)."""
    if not isinstance(x, torch.Tensor):
        return x
    for dim, axes in enumerate(spec_axes(spec, x.dim())):
        if axes and axis_size(axes) > 1:
            x = host_gather(x, axes, dim)
    return x


def host_gather(x: torch.Tensor, axes: Tuple[str, ...], dim: int):
    """Every device's ``x`` over ``axes``, concatenated along ``dim``,
    outside any capture: NCCL gathers on the card, gloo through the
    host (it takes host tensors)."""
    import torch.distributed as dist
    env = _env()
    if env.replay:
        raise RuntimeError("a replay has no process group to gather over")
    if dist.get_backend() == "nccl":
        return all_gather(x, axes, dim)
    group_name(axes)                      # checks the axes
    grp = (env.mesh.get_group(axes[0]) if len(axes) == 1 else
           dist.group.WORLD)
    parts = [torch.empty_like(x, device="cpu") for _ in range(axis_size(axes))]
    dist.all_gather(parts, x.detach().cpu().contiguous(), group=grp)
    return torch.cat(parts, dim=dim).to(x.device)


@contextlib.contextmanager
def quiet_propagation(mode):
    """``mode.quiet`` is True while DTensor's sharding propagation runs
    operations of its own (the output's tensor meta; torch 2.13's
    decomposition-based rules, on a one-rank mesh, once per decision it
    has not cached), so a dispatch mode that records operations can
    leave them out: they are no operation of the rank's, and recorded,
    the first call of a placement would differ from the next."""
    import importlib
    sites = []
    for mod, cls, name in (
            ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
             "_propagate_tensor_meta_non_cached"),
            ("torch.distributed.tensor._decompositions",
             "DecompShardingStrategy", "propagate_strategy")):
        try:
            owner = getattr(importlib.import_module(mod), cls)
        except (ImportError, AttributeError):
            continue                         # not in this torch
        orig = owner.__dict__.get(name)
        if orig is None:
            continue

        def quiet(*args, _orig=orig, **kwargs):
            was, mode.quiet = mode.quiet, True
            try:
                return _orig(*args, **kwargs)
            finally:
                mode.quiet = was
        setattr(owner, name, quiet)
        sites.append((owner, name, orig))
    try:
        yield
    finally:
        for owner, name, orig in sites:
            setattr(owner, name, orig)


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    """``f`` run on this device's shard of its global arguments; the
    outputs ``out_specs`` shard are gathered, the rest are this device's
    (replicated by contract). ``axis_names`` restricts the manual axes;
    the others are auto-sharded, which takes DTensor arguments (see the
    module docstring): then every tensor output comes back a DTensor on
    the whole mesh, its manual axes placed by ``out_specs``. An output
    replicated over a manual axis that takes a gradient must be psum'd,
    pmean'd or all-gathered over it in the body; otherwise the call
    raises (``_check_replicated``)."""
    env = (current() if mesh is None else
           mesh if isinstance(mesh, MeshEnv) else env_of(mesh))
    if env is None:
        raise RuntimeError("shard_map needs a mesh (or an ambient one)")
    manual = tuple(a for a in env.axes
                   if axis_names is None or a in set(axis_names))

    def run(*args):
        specs = flat_specs(in_specs, args, "in_specs")
        flat = tree_leaves(args)
        if any(is_dtensor(a) for a in flat):
            return _dtensor_shard_map(f, env, manual, args, flat, specs,
                                      out_specs)
        auto = [a for a in env.axes if a not in manual and env.sizes[a] > 1]
        if auto:
            raise ValueError(
                f"shard_map with auto-sharded axes {auto} takes DTensor "
                f"arguments (distributed.sharding.distribute_params under "
                f"sharding.axis_rules)")
        coords = dict(zip(env.axes, env.coords))
        leaves = [shard_slice(a, s, env.sizes, coords)
                  for a, s in zip(flat, specs)]
        with mesh_context(env):
            out = f(*tree_unflatten(args, leaves))
            ospecs = flat_specs(out_specs, out, "out_specs")
            _check_replicated(out, ospecs, manual,
                              _sources(leaves, specs, manual))
            return tree_unflatten(out, [
                gather_shard(o, s)
                for o, s in zip(tree_leaves(out), ospecs)])
    return run


def _varies(t: torch.Tensor, axis: str, sources) -> bool:
    """Whether ``t`` (an output of a ``shard_map`` body, in an autograd
    graph) may differ across the devices of manual ``axis``: some path
    back from it reaches an argument split over ``axis`` (``sources``:
    an argument's autograd node -> the manual axes it is split over)
    without passing a psum or all-gather over ``axis`` (pmean is a
    psum), whose result every device of the axis shares."""
    stack, seen = [t.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node in sources:
            if axis in sources[node]:
                return True
            continue
        reduced = getattr(node, "axis", None)
        if reduced is not None and axis in _axes(reduced):
            continue
        stack.extend(f for f, _ in node.next_functions)
    return False


def _check_replicated(out, ospecs, manual, sources) -> None:
    """Raise where an output ``out_specs`` replicates over a manual axis
    takes a gradient but is not reduced over that axis. The cotangent of
    such an output passes into the body as it is on every device (the
    transpose of a psum), which is JAX's gradient only where the output
    is the same on every device of the axis (JAX's ``check_vma``)."""
    for o, spec in zip(tree_leaves(out), ospecs):
        if not isinstance(o, torch.Tensor) or not o.requires_grad:
            continue
        split = {a for axes in spec_axes(spec, o.dim()) for a in axes}
        for a in manual:
            if a not in split and _varies(o, a, sources):
                raise ValueError(
                    f"shard_map: an output of shape {tuple(o.shape)} is "
                    f"replicated over manual axis {a!r} by out_specs "
                    f"({spec}) but varies over it: psum or pmean it over "
                    f"{a!r}, or shard it there")


def _sources(leaves, specs, manual):
    """The autograd nodes of the body's arguments that take a gradient ->
    the manual axes their specs split them over."""
    out = {}
    for loc, spec in zip(leaves, specs):
        if isinstance(loc, torch.Tensor) and loc.grad_fn is not None:
            axes = {a for ax in spec_axes(spec, loc.dim()) for a in ax
                    if a in manual}
            if axes:
                out[loc.grad_fn] = axes
    return out


def _manual_placements(x, spec: Optional[P], manual: Tuple[str, ...]):
    """A DTensor's placements with each manual axis of its mesh set by
    ``spec`` (``Shard`` of the dim it names, else ``Replicate``) and each
    auto axis kept, unless it shards a dim a manual axis also shards."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(x.device_mesh.mesh_dim_names)
    out = list(x.placements)
    by_axis = {a: i for i, axes in enumerate(spec_axes(spec, x.dim()))
               for a in axes}
    for j, a in enumerate(names):
        if a in manual:
            out[j] = Shard(by_axis[a]) if a in by_axis else Replicate()
    split = {by_axis[m] for m in manual if m in by_axis}
    for j, a in enumerate(names):
        if a not in manual and out[j].is_shard() and out[j].dim in split:
            out[j] = Replicate()
    return out


def _cotangent_placements(pl, names: Tuple[str, ...],
                          manual: Tuple[str, ...]):
    """The placements of an argument's cotangent: each rank's is its
    part alone on the manual axes the argument is replicated over
    (``Partial``, summed as it leaves the body), as JAX's ``shard_map``
    transpose psums such cotangents over the axes their spec omits."""
    from torch.distributed.tensor import Partial
    return [Partial() if a in manual and p.is_replicate() else p
            for a, p in zip(names, pl)]


def _dtensor_shard_map(f, env: MeshEnv, manual, args, flat, specs,
                       out_specs):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if env.mesh is None:
        raise RuntimeError("a DTensor shard_map needs a DeviceMesh")
    outer = sub_mesh(env.mesh, env.axes)
    onames = tuple(outer.mesh_dim_names)
    auto = tuple(a for a in onames if a not in manual)
    sub = sub_mesh(env.mesh, auto) if auto else None
    coords = dict(zip(env.axes, env.coords))
    leaves = []
    for x, spec in zip(flat, specs):
        if not is_dtensor(x):
            leaves.append(shard_slice(x, spec, env.sizes, {
                a: c for a, c in coords.items() if a in manual}))
            continue
        if x.device_mesh != outer:
            raise ValueError("a DTensor argument of shard_map lies on "
                             "another mesh than the ambient one")
        pl = _manual_placements(x, spec, manual)
        loc = x.redistribute(outer, pl).to_local(
            grad_placements=_cotangent_placements(pl, onames, manual))
        if sub is not None:
            loc = DTensor.from_local(
                loc, sub, [pl[onames.index(a)] for a in auto],
                run_check=False)
        leaves.append(loc)
    body_env = dataclasses.replace(env, manual=manual, auto=sub)
    with mesh_context(body_env):
        out = f(*tree_unflatten(args, leaves))
    ospecs = flat_specs(out_specs, out, "out_specs")
    _check_replicated(out, ospecs, manual, _sources(leaves, specs, manual))

    def back(o, spec):
        if not isinstance(o, torch.Tensor):
            return o
        pl = [Replicate()] * len(onames)
        for i, axes in enumerate(spec_axes(spec, o.dim())):
            for a in axes:
                if a in onames:
                    pl[onames.index(a)] = Shard(i)
        if is_dtensor(o):
            for a, p in zip(o.device_mesh.mesh_dim_names, o.placements):
                pl[onames.index(a)] = p
            o = o.to_local()
        return DTensor.from_local(o, outer, pl, run_check=False)
    return tree_unflatten(out, [back(o, s) for o, s in
                                zip(tree_leaves(out), ospecs)])
