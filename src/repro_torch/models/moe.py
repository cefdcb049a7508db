"""Mixture-of-Experts FFN: top-k routing + sort-based expert dispatch.

Port of ``repro.models.moe`` (the local path). Tokens are flattened, the
(token, expert) assignments sorted by expert (a stable sort, as
``jnp.argsort``), and then either:

- ``impl="capacity"`` (the default): the sorted rows are gathered into
  capacity-padded (E, C, d) blocks, the experts run as batched GEMMs,
  and the outputs are gathered back; an expert's assignments past its
  capacity C are dropped (GShard-style, ``capacity_factor``), and the
  Switch auxiliary loss keeps routing balanced;
- ``impl="ragged"``: dropless, every expert's rows as one segment of a
  grouped GEMM (``grouped_matmul``, with the reference's sparse VJP).

Sharding (the JAX package's): with logical-axis rules active
(``distributed.sharding``) the interior runs under ``compat.shard_map``
over every mesh axis. Expert weights keep all experts on every rank,
TP-sharded on the expert d_ff (``ff`` -> model) and FSDP-sharded on
d_model (``embed`` -> data); the body all-gathers the FSDP shards (their
gradient is reduce-scattered back), sorts its own tokens (no global
sort), and sums the down-projection partials over the model axis, the
collectives of the dense TP MLP. The scopes are the JAX package's:
``moe`` > ``router``, ``dispatch``, ``dispatch_pad`` / ``expert_gemm``,
``combine``, ``reduce``, then ``dense_residual``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import P
from repro_torch.models.layers import Param, mlp_apply


def moe_schema(cfg: ModelConfig) -> Dict[str, Param]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    s = {
        "router": Param((d, E), (None, None)),
        "wi": Param((E, d, ff), ("expert", "embed", "ff")),
        "wg": Param((E, d, ff), ("expert", "embed", "ff")),
        "wo": Param((E, ff, d), ("expert", "ff", "embed")),
    }
    if cfg.moe.dense_residual:
        rff = cfg.moe.residual_d_ff or ff
        s["res_wi"] = Param((d, rff), ("embed", "ff"))
        s["res_wg"] = Param((d, rff), ("embed", "ff"))
        s["res_wo"] = Param((rff, d), ("ff", "embed"))
    return s


def _route(x_flat, router_w, cfg: ModelConfig):
    """x_flat: (T, d) -> (weights (T,k), expert_idx (T,k), aux_loss):
    an f32 router, softmax, top-k, the top-k probabilities renormalised,
    and the Switch load-balance loss [arXiv:2101.03961]."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # (T, k)
    weights = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    T = x_flat.shape[0]
    assign = _counts(top_i.reshape(-1), E).float()
    frac_assign = assign / (T * k)
    frac_prob = probs.mean(dim=0)
    aux = E * torch.sum(frac_assign * frac_prob)
    return weights, top_i, aux


def _counts(idx, E: int):
    """``torch.bincount(idx, minlength=E)`` for ids in [0, E), as a
    scatter-add, which has a ``meta`` kernel (a dry run traces it)."""
    return torch.zeros(E, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, idx.long(), torch.ones_like(idx, dtype=torch.int64))


class _GroupedMatmul(torch.autograd.Function):
    """``jax.lax.ragged_dot`` with the reference's sparse VJP: rows of x
    in consecutive segments of ``group_sizes``, segment e times w[e]. The
    forward is a plain loop of products over the segments (``ragged_dot``
    is no Pallas kernel); the backward is two grouped products of the
    same kind, dx = dy w[e]^T and dw[e] = x_e^T dy_e (f32, then w's
    dtype); nothing dense over (rows, E) is formed."""

    @staticmethod
    def forward(ctx, x, w, sizes):
        ctx.save_for_backward(x, w)
        ctx.sizes = sizes
        if sizes is None:           # meta: one segment of all the rows
            return x @ w[0]
        out = x.new_empty((x.shape[0], w.shape[2]))
        r = 0
        for e, n in enumerate(sizes):
            out[r:r + n] = x[r:r + n] @ w[e]
            r += n
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        if ctx.sizes is None:       # meta: the walk's products, in one
            dw[0] = x.float().transpose(0, 1) @ dy.float()
            return ((dy @ w[0].transpose(0, 1)).to(x.dtype), dw.to(w.dtype),
                    None)
        dx = torch.empty_like(x)
        r = 0
        for e, n in enumerate(ctx.sizes):
            dx[r:r + n] = (dy[r:r + n] @ w[e].transpose(0, 1)).to(x.dtype)
            dw[e] = x[r:r + n].float().transpose(0, 1) @ dy[r:r + n].float()
            r += n
        return dx, dw.to(w.dtype), None


def grouped_matmul(x, w, group_sizes):
    """x: (rows, d) sorted by group; w: (E, d, f); group_sizes: (E,) int
    summing to rows -> (rows, f). Differentiable in x and w.

    On ``meta`` (a dry run) the sizes are unknown: the products run as
    one segment of all the rows against ``w[0]``, which has the walk's
    shapes and its FLOPs, ``sum_e 2 n_e d f = 2 rows d f`` (and the
    backward's), and computes nothing."""
    if x.device.type == "meta":
        return _GroupedMatmul.apply(x, w, None)
    sizes = [int(n) for n in group_sizes.tolist()]
    if sum(sizes) != x.shape[0]:
        raise ValueError(f"group sizes sum to {sum(sizes)}, not the "
                         f"{x.shape[0]} rows")
    return _GroupedMatmul.apply(x, w, sizes)


def _expert_gemms_ragged(xs, wi, wg, wo, group_sizes):
    """Grouped SwiGLU over expert-sorted rows. xs: (T*k, d)."""
    h = grouped_matmul(xs, wi, group_sizes)
    g = grouped_matmul(xs, wg, group_sizes)
    return grouped_matmul(F.silu(g) * h, wo, group_sizes)


def _dispatch(top_i, E: int):
    """The (token, expert) assignments sorted by expert (stable, as
    ``jnp.argsort``): (sort order, sorted expert ids, assignments an
    expert)."""
    flat_expert = top_i.reshape(-1)                              # (T*k,)
    sort_idx = torch.argsort(flat_expert, stable=True)
    return (sort_idx, flat_expert[sort_idx], _counts(flat_expert, E))


def _slot(expert_sorted, starts):
    """Each sorted assignment's position within its expert's rows; the
    capacity path keeps it where this is below C."""
    return torch.arange(expert_sorted.shape[0],
                        device=expert_sorted.device) - starts[expert_sorted]


def _capacity(cfg: ModelConfig, T: int) -> int:
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    c = int(math.ceil(T * k / E * cfg.moe.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def _moe_local(x, router_w, wi, wg, wo, cfg: ModelConfig, fsdp_axis=None,
               model_axis=None, batch_axes=()):
    """The MoE body on one device, or per shard inside ``shard_map`` (the
    collectives run only for the mesh axes given). x: (B, S, d) -> (out,
    aux)."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    if fsdp_axis is not None:    # FSDP all-gather of the embed shards
        wi = compat.all_gather(wi, fsdp_axis, dim=1)
        wg = compat.all_gather(wg, fsdp_axis, dim=1)
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    T = B * S
    with scope.named_scope("router"):
        weights, top_i, aux = _route(x_flat, router_w, cfg)
    with scope.named_scope("dispatch"):
        sort_idx, expert_sorted, group_sizes = _dispatch(top_i, E)
        token_of = sort_idx // k
    if cfg.moe.impl == "ragged":
        with scope.named_scope("expert_gemm"):
            xs = x_flat[token_of]                                # (T*k, d)
            out_sorted = _expert_gemms_ragged(xs, wi, wg, wo, group_sizes)
        with scope.named_scope("combine"):
            inv = torch.argsort(sort_idx, stable=True)
            out = out_sorted[inv].reshape(T, k, D)
            out = torch.einsum("tkd,tk->td", out, weights.to(out.dtype))
    else:
        C = _capacity(cfg, T)
        with scope.named_scope("dispatch_pad"):
            # gather-only dispatch: rows are expert-sorted, so block (e, c)
            # reads sorted row starts[e] + c
            starts = torch.cumsum(group_sizes, 0) - group_sizes  # (E,)
            c_iota = torch.arange(C, device=x.device)
            blk_valid = c_iota[None, :] < group_sizes[:, None]   # (E, C)
            blk_sorted_idx = torch.clamp_max(
                starts[:, None] + c_iota[None, :], T * k - 1)
            blk_token = token_of[blk_sorted_idx]                 # (E, C)
            xs = x_flat[blk_token.reshape(-1)]
            xs = xs.reshape(E, C, D) * blk_valid[..., None].to(x_flat.dtype)
        with scope.named_scope("expert_gemm"):
            h = torch.bmm(xs, wi)
            g = torch.bmm(xs, wg)
            out_blocks = torch.bmm(F.silu(g) * h, wo)
        with scope.named_scope("combine"):
            pos = _slot(expert_sorted, starts)
            keep = pos < C
            flat_blk = expert_sorted * C + torch.clamp_max(pos, C - 1)
            gathered = out_blocks.reshape(E * C, D)[flat_blk]
            gathered = torch.where(keep[:, None], gathered,
                                   torch.zeros((), dtype=gathered.dtype,
                                               device=x.device))
            inv = torch.argsort(sort_idx, stable=True)
            out = gathered[inv].reshape(T, k, D)
            out = torch.einsum("tkd,tk->td", out, weights.to(out.dtype))
    with scope.named_scope("reduce"):
        if model_axis is not None:   # partial d_ff contributions
            out = compat.psum(out, model_axis)
        if batch_axes:
            aux = compat.pmean(aux, batch_axes)
        if model_axis is not None:
            aux = compat.pmean(aux, model_axis)
    return out.reshape(B, S, D), aux


def routing(params, x, cfg: ModelConfig):
    """What the router decides for x (B, S, d), for checks and reports:
    (expert ids (T, k), kept (T, k) bool: the assignment fits in its
    expert's capacity (all True on the ragged path), capacity C)."""
    B, S, D = x.shape
    T, k = B * S, cfg.moe.top_k
    _, top_i, _ = _route(x.reshape(T, D), params["router"], cfg)
    if cfg.moe.impl == "ragged":
        return top_i, torch.ones_like(top_i, dtype=torch.bool), None
    C = _capacity(cfg, T)
    sort_idx, expert_sorted, sizes = _dispatch(top_i, cfg.moe.num_experts)
    kept = torch.empty_like(sort_idx, dtype=torch.bool)
    kept[sort_idx] = _slot(expert_sorted, torch.cumsum(sizes, 0) - sizes) < C
    return top_i, kept.reshape(T, k), C


def moe_apply(params, x, cfg: ModelConfig, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) -> (out, aux_loss x ``aux_loss_weight``).

    With active sharding rules (``sharding.axis_rules``) the interior
    runs under ``compat.shard_map`` on ``mesh`` (default: the ambient
    one): local sort, TP-sharded d_ff, FSDP-gathered weights; otherwise
    the plain local path."""
    rules = shd.current_rules()
    env = compat.current() if mesh is None else (
        mesh if isinstance(mesh, compat.MeshEnv) else compat.env_of(mesh))
    with scope.named_scope("moe"):
        if rules is None or env is None or env.mesh is None:
            if mesh is not None:
                raise ValueError("the sharded MoE runs under sharding."
                                 "axis_rules (logical-axis rules)")
            out, aux = _moe_local(x, params["router"], params["wi"],
                                  params["wg"], params["wo"], cfg)
        else:
            pmesh = compat.sub_mesh(env.mesh, env.axes)
            rules = shd.filter_rules(rules, env.mesh)
            batch = rules.get("batch")
            batch_axes = ((batch,) if isinstance(batch, str) else
                          tuple(batch) if batch else ())
            fsdp = rules.get("embed")
            model = rules.get("ff")
            x_spec = P(batch, None, None)
            w_spec = P(None, fsdp, model)       # (E, d, ff)
            wo_spec = P(None, model, fsdp)      # (E, ff, d): embed FSDP

            def wrapped(x_, rw, wi_, wg_, wo_):
                # wo's embed-dim FSDP shards, gathered inside
                if fsdp is not None:
                    wo_ = compat.all_gather(wo_, fsdp, dim=2)
                return _moe_local(x_, rw, wi_, wg_, wo_, cfg,
                                  fsdp_axis=fsdp, model_axis=model,
                                  batch_axes=batch_axes)
            x = shd.as_dtensor(x, pmesh)
            out, aux = compat.shard_map(
                wrapped, mesh=env,
                in_specs=(x_spec, P(None, None), w_spec, w_spec, wo_spec),
                out_specs=(x_spec, P()),
            )(x, params["router"], params["wi"], params["wg"], params["wo"])
        if cfg.moe.dense_residual:
            with scope.named_scope("dense_residual"):
                res = mlp_apply({"wi": params["res_wi"],
                                 "wg": params["res_wg"],
                                 "wo": params["res_wo"]}, x)
            out = out + res
    return out, aux * cfg.moe.aux_loss_weight
