"""Decoder blocks and layer stacks (training, prefill, decode).

Port of ``repro.models.transformer``: the dense, MoE, ``ssm`` and
``hybrid`` families. Layer parameters stay stacked along a leading layer
axis, as the JAX schema has them; a Python loop over ``scope.scan``
takes the place of ``lax.scan``, under the JAX package's scope names
(``layers``, ``layer``, ``attn``/``ssm``, ``mlp``/``moe``,
``final_norm``; the hybrid stack's ``groups``, ``ssm_layer`` and
``shared_attn``), so a probe sees the same tree.

The hybrid family (zamba2) runs groups of ``shared_attn_every`` SSM
layers, each group followed by one attention + MLP block whose weights
all groups share (``params["shared"]``); its serving cache holds the
SSM layers' conv and SSD states and one KV cache per shared-block call.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.distributed.sharding import (current_rules, placed_grad,
                                              put, shard, zeros)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (index_tree, mlp_apply, mlp_schema,
                                       rmsnorm, rmsnorm_schema, stack_schema)


def block_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Schema of ONE layer of the homogeneous stack."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": rmsnorm_schema(cfg.d_model),
                "ssm": ssm_mod.ssm_schema(cfg)}
    s: Dict[str, Any] = {
        "ln1": rmsnorm_schema(cfg.d_model),
        "attn": attn.attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model),
    }
    if cfg.moe is not None:
        s["moe"] = moe_mod.moe_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg.d_model, cfg.d_ff, cfg.use_bias)
    return s


def shared_attn_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Zamba2's weight-shared transformer block (attn + MLP)."""
    return {
        "ln1": rmsnorm_schema(cfg.d_model),
        "attn": attn.attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model),
        "mlp": mlp_schema(cfg.d_model, cfg.d_ff, cfg.use_bias),
    }


def stack_schemas(cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter schema for the layer stack of one architecture."""
    out: Dict[str, Any] = {"layers": stack_schema(block_schema(cfg),
                                                  cfg.num_layers)}
    if cfg.family == "hybrid":
        out["shared"] = shared_attn_schema(cfg)
    out["ln_f"] = rmsnorm_schema(cfg.d_model)
    return out


def n_groups(cfg: ModelConfig) -> int:
    """The hybrid stack's groups: one shared-block call after each."""
    if cfg.num_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"groups of {cfg.shared_attn_every}")
    return cfg.num_layers // cfg.shared_attn_every


def unbind_tree(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views: one
    ``unbind`` a leaf, so the backward stacks each leaf's gradients once
    (indexing layer by layer would add a full-size gradient per layer).
    A DTensor layer's gradient comes back placed as the layer is
    (``sharding.placed_grad``): reduce-scattered layer by layer, as JAX's
    transposed scan does, where the stacked gradient would otherwise
    hold every layer's partial sums whole over the FSDP axes."""
    if isinstance(tree, torch.Tensor):
        return tuple(placed_grad(t) for t in tree.unbind(0))
    parts = {k: unbind_tree(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


# ------------------------------------------------------- train forward

def _attn_mlp_block(lp, x, positions, cfg: ModelConfig):
    """Returns x + attn + FFN; with MoE layers (x, aux loss)."""
    with scope.named_scope("attn"):
        h = attn.attn_train(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            positions, cfg)
    x = x + h
    if cfg.moe is not None:
        h, aux = moe_mod.moe_apply(lp["moe"],
                                   rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
        return shard(x + h, "batch", "act_seq", None), aux
    with scope.named_scope("mlp"):
        h = mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return shard(x + h, "batch", "act_seq", None)


def _ssm_block(lp, x, cfg: ModelConfig):
    with scope.named_scope("ssm"):
        h = ssm_mod.ssm_apply(lp["ssm"], rmsnorm(x, lp["ln"], cfg.norm_eps),
                              cfg, use_kernel=False)
    return shard(x + h, "batch", "act_seq", None)


def _remat(fn, cfg: ModelConfig):
    """JAX's ``_remat``: ``"full"`` keeps nothing of the layer for the
    backward (``scope.remat``: ``torch.utils.checkpoint``), ``"dots"``
    keeps the outputs of the unbatched matmuls (the projections and MLP
    products; selective checkpointing, JAX's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest,
    flash included, ``"none"`` keeps everything."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return lambda *a: scope.remat(fn, *a, policy="dots")
    return lambda *a: scope.remat(fn, *a)


def stack_apply(params, x, positions, cfg: ModelConfig):
    """Run the full layer stack (training forward). Returns (x,
    aux_loss_sum): the MoE layers' auxiliary losses, zero for the other
    families."""
    # placed as every layer leaves the residual, so that each iteration
    # of the layer loop runs the same operations (as a scan's carry is
    # one layout; the first layer would otherwise meet another)
    x = shard(x, "batch", "act_seq", None)
    if cfg.family in ("ssm", "hybrid"):
        return _stack_apply_ssm(params, x, cfg, positions)

    def body(lp, h):
        with scope.named_scope("layer"):
            return _attn_mlp_block(lp, h, positions, cfg)

    body = _remat(body, cfg)
    L = cfg.num_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with scope.named_scope("layers"):
        layers = unbind_tree(params["layers"], L)
        for li in scope.scan(L):
            if cfg.moe is None:
                x = body(layers[li], x)
            else:
                x, aux_i = body(layers[li], x)
                aux = aux + aux_i
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, aux


def _shared_views(shared, n: int):
    """``n`` views of the shared block's weights, one a group: each
    group's gradient lands in its own slot, summed once after the loop
    (a tensor used by several iterations of one ``scope.scan`` would get
    its gradient summed inside the loop, which a probe's capture
    refuses)."""
    if isinstance(shared, torch.Tensor):
        return tuple(placed_grad(t) for t in
                     shared.expand((n,) + tuple(shared.shape)).unbind(0))
    parts = {k: _shared_views(v, n) for k, v in shared.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


def _stack_apply_ssm(params, x, cfg: ModelConfig, positions):
    L = cfg.num_layers
    layers = unbind_tree(params["layers"], L)
    if cfg.family == "ssm":
        def body(lp, h):
            with scope.named_scope("layer"):
                return _ssm_block(lp, h, cfg)
        body = _remat(body, cfg)
        with scope.named_scope("layers"):
            for li in scope.scan(L):
                x = body(layers[li], x)
    else:  # hybrid: groups of SSM layers + the weight-shared attn block
        every, ng = cfg.shared_attn_every, n_groups(cfg)
        shared = _shared_views(params["shared"], ng)
        plain = cfg.replace(moe=None)

        def inner(lp, h2):
            with scope.named_scope("ssm_layer"):
                return _ssm_block(lp, h2, cfg)
        # nested remat: without it the group's recompute keeps every SSM
        # layer's SSD intermediates
        inner = _remat(inner, cfg)

        def group_body(sp, h, *gp):
            for j in scope.scan(every):
                h = inner(gp[j], h)
            with scope.named_scope("shared_attn"):
                return _attn_mlp_block(sp, h, positions, plain)

        group_body = _remat(group_body, cfg)
        with scope.named_scope("groups"):
            for g in scope.scan(ng):
                x = group_body(shared[g], x,
                               *layers[g * every:(g + 1) * every])
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------ serving

def mlp_residual(lp, h, cfg: ModelConfig, moe_scope: bool = False):
    """h + the layer's FFN of ``rmsnorm(h)``: the MLP under ``mlp``, or
    the MoE layer (its aux loss dropped), wrapped in one more ``moe``
    scope where the JAX engine's steps add one (``moe_scope``)."""
    if cfg.moe is not None:
        hn = rmsnorm(h, lp["ln2"], cfg.norm_eps)
        if moe_scope:
            with scope.named_scope("moe"):
                m, _ = moe_mod.moe_apply(lp["moe"], hn, cfg)
        else:
            m, _ = moe_mod.moe_apply(lp["moe"], hn, cfg)
        return h + m
    with scope.named_scope("mlp"):
        m = mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps))
    return h + m


_CACHE_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def kv_cache(cfg: ModelConfig, n: int, B: int, cache_len: int, device):
    """Zero K and V caches (n, B, cache_len, kv, hd) in kv_cache_dtype,
    sharded by the active rules (sequence-sharded for serving)."""
    shape = (n, B, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    kvd = getattr(torch, cfg.kv_cache_dtype)
    return (zeros(shape, *_CACHE_AXES, dtype=kvd, device=device),
            zeros(shape, *_CACHE_AXES, dtype=kvd, device=device))


def stack_prefill(params, x, positions, cfg: ModelConfig, cache_len: int):
    """Forward pass that also builds the serving cache.

    Returns (x, {"k", "v"}) with cache leaves (L, B, cache_len, kv, hd)
    in ``kv_cache_dtype``; rows past the prompt are zero. The ssm family
    returns {"conv": (L, B, K-1, conv_dim) in the compute dtype, "ssd":
    (L, B, h, p, n) f32}, the decode caches after the prompt; the hybrid
    family those and {"k", "v"} of (L // shared_attn_every, B,
    cache_len, kv, hd), one a shared-block call."""
    if cfg.family in ("ssm", "hybrid"):
        return _stack_prefill_ssm(params, x, positions, cfg, cache_len)
    B, S, _ = x.shape
    L = cfg.num_layers
    ck, cv = kv_cache(cfg, L, B, cache_len, x.device)
    with scope.named_scope("layers"):
        for li in scope.scan(L):
            with scope.named_scope("layer"):
                lp = index_tree(params["layers"], li)
                with scope.named_scope("attn"):
                    a, (k, v) = attn.attn_prefill(
                        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                        positions, cfg)
                    put(ck, (li, slice(None), slice(0, S)), k)
                    put(cv, (li, slice(None), slice(0, S)), v)
                x = shard(mlp_residual(lp, x + a, cfg), "batch", "act_seq",
                          None)
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, {"k": ck, "v": cv}


def decode_block_attn(lp, x, ck, cv, pos: int, cfg: ModelConfig):
    """One attention + FFN block of a decode step; ck/cv (B, S_max, kv,
    hd) are updated in place."""
    with scope.named_scope("attn"):
        a, _, _ = attn.attn_decode(lp["attn"],
                                   rmsnorm(x, lp["ln1"], cfg.norm_eps),
                                   ck, cv, pos, cfg)
    return mlp_residual(lp, x + a, cfg)


def stack_decode(params, cache, x, pos: int, cfg: ModelConfig):
    """One decode step through the stack; the cache is updated in place.
    Returns (x, cache)."""
    if cfg.family in ("ssm", "hybrid"):
        return _stack_decode_ssm(params, cache, x, pos, cfg)
    if current_rules() is not None:
        cache = dict(cache, k=shard(cache["k"], *_CACHE_AXES),
                     v=shard(cache["v"], *_CACHE_AXES))
    with scope.named_scope("layers"):
        for li in scope.scan(cfg.num_layers):
            with scope.named_scope("layer"):
                lp = index_tree(params["layers"], li)
                x = decode_block_attn(lp, x, cache["k"][li], cache["v"][li],
                                      pos, cfg)
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, cache


def _ssm_layer_prefill(lp, x, cfg: ModelConfig):
    # no "ssm" scope here: the JAX package's prefill has none either
    y, conv_s, ssd_s = ssm_mod.ssm_apply(
        lp["ssm"], rmsnorm(x, lp["ln"], cfg.norm_eps), cfg,
        return_state=True)
    return x + y, conv_s, ssd_s


def _stack_prefill_ssm(params, x, positions, cfg: ModelConfig,
                       cache_len: int):
    convs, ssds = [], []
    cache: Dict[str, Any] = {}
    if cfg.family == "ssm":
        with scope.named_scope("layers"):
            for li in scope.scan(cfg.num_layers):
                with scope.named_scope("layer"):
                    lp = index_tree(params["layers"], li)
                    x, conv_s, ssd_s = _ssm_layer_prefill(lp, x, cfg)
                    convs.append(conv_s)
                    ssds.append(ssd_s)
    else:
        every, ng = cfg.shared_attn_every, n_groups(cfg)
        sp = params["shared"]
        B, S, _ = x.shape
        ck, cv = kv_cache(cfg, ng, B, cache_len, x.device)
        with scope.named_scope("groups"):
            for g in scope.scan(ng):
                for j in scope.scan(every):
                    with scope.named_scope("ssm_layer"):
                        lp = index_tree(params["layers"], g * every + j)
                        x, conv_s, ssd_s = _ssm_layer_prefill(lp, x, cfg)
                        convs.append(conv_s)
                        ssds.append(ssd_s)
                with scope.named_scope("shared_attn"):
                    a, (k, v) = attn.attn_prefill(
                        sp["attn"], rmsnorm(x, sp["ln1"], cfg.norm_eps),
                        positions, cfg)
                    put(ck, (g, slice(None), slice(0, S)), k)
                    put(cv, (g, slice(None), slice(0, S)), v)
                    x = shard(mlp_residual(sp, x + a, cfg.replace(moe=None)),
                              "batch", "seq", None)
        cache.update(k=ck, v=cv)
    cache = {"conv": torch.stack(convs), "ssd": torch.stack(ssds), **cache}
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, cache


def _decode_block_ssm(lp, x, cache, li: int, cfg: ModelConfig):
    with scope.named_scope("ssm"):
        y, conv_s, ssd_s = ssm_mod.ssm_decode(
            lp["ssm"], rmsnorm(x, lp["ln"], cfg.norm_eps),
            cache["conv"][li], cache["ssd"][li], cfg)
    put(cache["conv"], (li,), conv_s)
    put(cache["ssd"], (li,), ssd_s)
    return x + y


def _stack_decode_ssm(params, cache, x, pos: int, cfg: ModelConfig):
    if cfg.family == "ssm":
        with scope.named_scope("layers"):
            for li in scope.scan(cfg.num_layers):
                with scope.named_scope("layer"):
                    lp = index_tree(params["layers"], li)
                    x = _decode_block_ssm(lp, x, cache, li, cfg)
    else:
        every, ng = cfg.shared_attn_every, n_groups(cfg)
        with scope.named_scope("groups"):
            for g in scope.scan(ng):
                for j in scope.scan(every):
                    with scope.named_scope("ssm_layer"):
                        li = g * every + j
                        lp = index_tree(params["layers"], li)
                        x = _decode_block_ssm(lp, x, cache, li, cfg)
                with scope.named_scope("shared_attn"):
                    x = decode_block_attn(params["shared"], x,
                                          cache["k"][g], cache["v"][g], pos,
                                          cfg.replace(moe=None))
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, cache
