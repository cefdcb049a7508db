"""AdamW with dtype policies + global-norm clipping.

Port of ``repro.optim.adamw``. Moments are stored in ``moment_dtype``
(float32, bfloat16, or int8 with a scale per row, ``optim.quantized``);
the math is always float32. Master params follow ``param_dtype``.

The update is functional, as JAX's is: it returns new params and
moments and writes nothing it was given, so a probe's capture, which
undoes in-place writes to tensors that existed before its run, copies
nothing. Leaves are the JAX tree's leaves in the JAX tree's order
(dict keys sorted), so the global norm sums in the same order.

A leaf of two or more dimensions over 128 MiB is updated one slice of
its leading axis at a time under ``scope.scan`` (JAX's ``lax.scan``),
which bounds the f32 working set to one slice and gives the probe tree
JAX's ``optimizer/adamw/scan#k`` nodes. At full width that is every
stacked layer weight (a slice a layer) and also the 2-D embedding and
unembedding (a slice a row), whose loops of small eager updates cost
launches rather than bytes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import scope
from repro_torch.distributed import compat
from repro_torch.optim.quantized import (QTensor, dequantize, quantize,
                                         scale_placements, scales_of,
                                         zeros_like_q)

SCAN_THRESHOLD_BYTES = 128 * 2**20


class AdamWState(NamedTuple):
    step: torch.Tensor             # int32 scalar
    mu: Any                        # tree like params (tensors or QTensor)
    nu: Any


def tree_leaves(tree) -> List[Any]:
    """Leaves in the JAX tree's order: dict keys sorted, tuples in order;
    a ``QTensor`` is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]) -> Any:
    """``leaves`` (in ``tree_leaves`` order) into the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_map(fn, tree) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def init(params, moment_dtype: str = "float32") -> AdamWState:
    if moment_dtype == "int8":
        zeros = zeros_like_q
    else:
        md = getattr(torch, moment_dtype)

        def zeros(p):
            return compat.zeros_like(p, md)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _load_moment(m):
    if isinstance(m, QTensor):
        return dequantize(m)
    return m.to(torch.float32)


def _store_moment(m32, like, row_max=None):
    if isinstance(like, QTensor):
        return quantize(m32, row_max)
    return m32.to(like.dtype)


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in tree_leaves(tree):
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def _blockwise(upd, p, g, m, v):
    """AdamW on a DTensor leaf, rank by rank: the update is elementwise,
    so each rank updates its own block of p, g, m and v laid out alike
    (scanning its block's leading axis when the whole leaf is over the
    threshold, as the one-device rule says), and the blocks are the new
    leaf's. A slice of a sharded dimension would be a gather.

    int8 moments: a block's values are placed as p, its scales (one a
    row) with the last dim replicated (``quantized.scale_placements``).
    A row of a leaf whose last dim is sharded spans ranks, so each
    block's max |m| a row is all-reduced (max) over the mesh dims that
    shard that dim before it becomes the scale, as XLA's sharded
    reduction does: every rank holds the whole row's scale."""
    from torch.distributed.tensor import DTensor
    mesh, pl = p.device_mesh, p.placements
    spl = scale_placements(p)

    def block(t):
        if isinstance(t, QTensor):
            return QTensor(t.q.redistribute(mesh, pl).to_local(),
                           t.s.redistribute(mesh, spl).to_local())
        return t.redistribute(mesh, pl).to_local()

    def whole(t):
        if isinstance(t, QTensor):
            return QTensor(whole(t.q), scales_of(p, t.s))
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=p.shape, stride=p.stride())

    row_dims = [j for j, q in enumerate(pl)
                if p.dim() and q.is_shard(p.dim() - 1)]

    def row_max(amax):
        from torch.distributed import _functional_collectives as funcol
        for j in row_dims:
            amax = funcol.wait_tensor(funcol.all_reduce(amax, "max",
                                                        (mesh, j)))
        return amax

    big = p.dim() >= 2 and p.numel() * p.element_size() > \
        SCAN_THRESHOLD_BYTES
    return tuple(whole(t) for t in upd(
        *[block(t) for t in (p, g, m, v)], scanned=big,
        row_max=row_max if row_dims else None))


def update(params, grads, state: AdamWState, cfg: TrainConfig,
           schedule: Callable) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    with torch.no_grad():
        with scope.named_scope("clip"):
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        step = state.step + 1
        lr = schedule(step)
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
        step32 = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, step32)
        bc2 = 1.0 - torch.pow(b2, step32)

        def upd(p, g, m, v, row_max=None):
            g32 = g.to(torch.float32)
            m32 = b1 * _load_moment(m) + (1 - b1) * g32
            v32 = b2 * _load_moment(v) + (1 - b2) * torch.square(g32)
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = p.to(torch.float32)
            p_new = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32)
            return (p_new.to(p.dtype), _store_moment(m32, m, row_max),
                    _store_moment(v32, v, row_max))

        def empty_like(x):
            if isinstance(x, QTensor):
                return QTensor(torch.empty_like(x.q), torch.empty_like(x.s))
            return torch.empty_like(x)

        def put(dst, i, src):
            if isinstance(dst, QTensor):
                dst.q[i], dst.s[i] = src.q, src.s
            else:
                dst[i] = src

        def at(x, i):
            return QTensor(x.q[i], x.s[i]) if isinstance(x, QTensor) else x[i]

        def upd_maybe_scanned(p, g, m, v):
            if compat.is_dtensor(p):
                return _blockwise(upd_leaf, p, g, m, v)
            return upd_leaf(p, g, m, v, p.dim() >= 2 and p.numel() *
                            p.element_size() > SCAN_THRESHOLD_BYTES)

        def upd_leaf(p, g, m, v, scanned, row_max=None):
            if scanned:
                out = (torch.empty_like(p), empty_like(m), empty_like(v))
                for i in scope.scan(p.shape[0], same_shapes=True):
                    for dst, src in zip(out, upd(p[i], g[i], at(m, i),
                                                 at(v, i), row_max)):
                        put(dst, i, src)
                return out
            return upd(p, g, m, v, row_max)

        with scope.named_scope("adamw"):
            flat_p = tree_leaves(params)
            out = [upd_maybe_scanned(p, g, m, v) for p, g, m, v in
                   zip(flat_p, tree_leaves(grads), tree_leaves(state.mu),
                       tree_leaves(state.nu))]
            new_p = tree_unflatten(params, [o[0] for o in out])
            new_m = tree_unflatten(params, [o[1] for o in out])
            new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), {
        "lr": lr, "grad_norm": gnorm}
