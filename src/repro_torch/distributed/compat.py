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
- ``shard_map(f, mesh=, in_specs=, out_specs=)``: each global argument
  sliced to this device's shard, ``f`` run, and the outputs a spec shards
  gathered back; ``P`` is the port's ``PartitionSpec``.

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
        raise NotImplementedError(
            f"a collective over the mesh axes {axes} (some, not all, of "
            f"{env.axes}) needs a flattened sub-mesh group; not ported")
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

def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(x, "sum", group_name(axis)))


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """psum / G, as ``lax.pmean`` (gloo has no average reduction)."""
    return psum(x, axis) / axis_size(axis)


def all_gather(x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
    """Concatenate every device's ``x`` along ``dim`` (``tiled=True``)."""
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    y = x.movedim(dim, 0).contiguous() if dim else x.contiguous()
    out = f.wait_tensor(f.all_gather_into_tensor(y, g, group_name(axis)))
    return out.movedim(0, dim) if dim else out


def psum_scatter(x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
    """Sum over devices, each keeping its block of ``dim`` (tiled)."""
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    y = x.movedim(dim, 0).contiguous() if dim else x.contiguous()
    out = f.wait_tensor(f.reduce_scatter_tensor(y, "sum", g,
                                                group_name(axis)))
    return out.movedim(0, dim) if dim else out


def all_to_all(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Block i of dim 0 goes to device i; dim 0 of the result is the
    blocks received, in device order."""
    f = torch.ops._c10d_functional
    g = axis_size(axis)
    split = [x.shape[0] // g] * g
    return f.wait_tensor(f.all_to_all_single(x.contiguous(), split, split,
                                             group_name(axis)))


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


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    """``f`` run on this device's shard of its global arguments; the
    outputs ``out_specs`` shard are gathered, the rest are this device's
    (replicated by contract). ``axis_names`` restricts the manual axes:
    the others must have size 1 until ``distributed/sharding.py`` is
    ported (ROADMAP Queue 1 item 4)."""
    env = (current() if mesh is None else
           mesh if isinstance(mesh, MeshEnv) else env_of(mesh))
    if env is None:
        raise RuntimeError("shard_map needs a mesh (or an ambient one)")
    if axis_names is not None:
        rest = [a for a in env.axes if a not in set(axis_names)
                and env.sizes[a] > 1]
        if rest:
            raise NotImplementedError(
                f"shard_map with auto-sharded axes {rest} of size > 1 needs "
                f"distributed/sharding.py (ROADMAP Queue 1 item 4)")

    def run(*args):
        specs = flat_specs(in_specs, args, "in_specs")
        coords = dict(zip(env.axes, env.coords))
        leaves = [shard_slice(a, s, env.sizes, coords)
                  for a, s in zip(tree_leaves(args), specs)]
        with mesh_context(env):
            out = f(*tree_unflatten(args, leaves))
            ospecs = flat_specs(out_specs, out, "out_specs")
            return tree_unflatten(out, [
                gather_shard(o, s)
                for o, s in zip(tree_leaves(out), ospecs)])
    return run
