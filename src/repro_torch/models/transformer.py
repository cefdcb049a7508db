"""Decoder blocks and layer stacks (training, prefill, decode).

Port of the dense and ``ssm`` branches of ``repro.models.transformer``
(training: the dense family only).
Layer parameters stay stacked along a leading layer axis, as the JAX
schema has them; a Python loop over ``scope.scan`` takes the place of
``lax.scan``, under the JAX package's scope names (``layers``,
``layer``, ``attn``/``ssm``, ``mlp``, ``final_norm``), so a probe sees
the same tree. The hybrid and MoE families are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (index_tree, mlp_apply, mlp_schema,
                                       rmsnorm, rmsnorm_schema, stack_schema)


def block_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Schema of ONE layer of the homogeneous stack."""
    if cfg.family == "ssm":
        return {"ln": rmsnorm_schema(cfg.d_model),
                "ssm": ssm_mod.ssm_schema(cfg)}
    return {
        "ln1": rmsnorm_schema(cfg.d_model),
        "attn": attn.attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model),
        "mlp": mlp_schema(cfg.d_model, cfg.d_ff, cfg.use_bias),
    }


def stack_schemas(cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter schema for the layer stack of one architecture."""
    return {"layers": stack_schema(block_schema(cfg), cfg.num_layers),
            "ln_f": rmsnorm_schema(cfg.d_model)}


def unbind_tree(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views: one
    ``unbind`` a leaf, so the backward stacks each leaf's gradients once
    (indexing layer by layer would add a full-size gradient per layer)."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    parts = {k: unbind_tree(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


# ------------------------------------------------------- train forward

def _attn_mlp_block(lp, x, positions, cfg: ModelConfig):
    with scope.named_scope("attn"):
        h = attn.attn_train(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            positions, cfg)
    x = x + h
    with scope.named_scope("mlp"):
        h = mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return x + h


def _remat(fn, cfg: ModelConfig):
    """JAX's ``_remat``: ``"full"`` keeps nothing of the layer for the
    backward (``scope.remat``: ``torch.utils.checkpoint``), ``"none"``
    keeps everything."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs) is not ported yet "
            "(ROADMAP Queue 1); no shipped config uses it")
    return lambda *a: scope.remat(fn, *a)


def stack_apply(params, x, positions, cfg: ModelConfig):
    """Run the full layer stack (training forward). Returns (x,
    aux_loss_sum); the dense family has no auxiliary loss."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"training the {cfg.family} family is not ported yet (ROADMAP "
            f"Queue 1: the ssm training branch, _stack_apply_ssm)")

    def body(lp, h):
        with scope.named_scope("layer"):
            return _attn_mlp_block(lp, h, positions, cfg)

    body = _remat(body, cfg)
    L = cfg.num_layers
    with scope.named_scope("layers"):
        layers = unbind_tree(params["layers"], L)
        for li in scope.scan(L):
            x = body(layers[li], x)
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------ serving

def mlp_residual(lp, h, cfg: ModelConfig):
    with scope.named_scope("mlp"):
        m = mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps))
    return h + m


def stack_prefill(params, x, positions, cfg: ModelConfig, cache_len: int):
    """Forward pass that also builds the serving cache.

    Returns (x, {"k", "v"}) with cache leaves (L, B, cache_len, kv, hd)
    in ``kv_cache_dtype``; rows past the prompt are zero. The ssm family
    returns {"conv": (L, B, K-1, conv_dim) in the compute dtype, "ssd":
    (L, B, h, p, n) f32}, the decode caches after the prompt."""
    if cfg.family == "ssm":
        return _stack_prefill_ssm(params, x, cfg)
    B, S, _ = x.shape
    L = cfg.num_layers
    shape = (L, B, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    kvd = getattr(torch, cfg.kv_cache_dtype)
    ck = torch.zeros(shape, dtype=kvd, device=x.device)
    cv = torch.zeros(shape, dtype=kvd, device=x.device)
    with scope.named_scope("layers"):
        for li in scope.scan(L):
            with scope.named_scope("layer"):
                lp = index_tree(params["layers"], li)
                with scope.named_scope("attn"):
                    a, (k, v) = attn.attn_prefill(
                        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                        positions, cfg)
                    ck[li, :, :S] = k
                    cv[li, :, :S] = v
                x = mlp_residual(lp, x + a, cfg)
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, {"k": ck, "v": cv}


def stack_decode(params, cache, x, pos: int, cfg: ModelConfig):
    """One decode step through the stack; the cache is updated in place.
    Returns (x, cache)."""
    if cfg.family == "ssm":
        return _stack_decode_ssm(params, cache, x, cfg)
    with scope.named_scope("layers"):
        for li in scope.scan(cfg.num_layers):
            with scope.named_scope("layer"):
                lp = index_tree(params["layers"], li)
                with scope.named_scope("attn"):
                    a, _, _ = attn.attn_decode(
                        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                        cache["k"][li], cache["v"][li], pos, cfg)
                x = mlp_residual(lp, x + a, cfg)
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, cache


def _stack_prefill_ssm(params, x, cfg: ModelConfig):
    convs, ssds = [], []
    # no "ssm" scope here: the JAX package's prefill has none either
    with scope.named_scope("layers"):
        for li in scope.scan(cfg.num_layers):
            with scope.named_scope("layer"):
                lp = index_tree(params["layers"], li)
                y, conv_s, ssd_s = ssm_mod.ssm_apply(
                    lp["ssm"], rmsnorm(x, lp["ln"], cfg.norm_eps), cfg,
                    return_state=True)
                x = x + y
                convs.append(conv_s)
                ssds.append(ssd_s)
    cache = {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, cache


def _stack_decode_ssm(params, cache, x, cfg: ModelConfig):
    with scope.named_scope("layers"):
        for li in scope.scan(cfg.num_layers):
            with scope.named_scope("layer"):
                lp = index_tree(params["layers"], li)
                with scope.named_scope("ssm"):
                    y, conv_s, ssd_s = ssm_mod.ssm_decode(
                        lp["ssm"], rmsnorm(x, lp["ln"], cfg.norm_eps),
                        cache["conv"][li], cache["ssd"][li], cfg)
                x = x + y
                cache["conv"][li] = conv_s
                cache["ssd"][li] = ssd_s
    with scope.named_scope("final_norm"):
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, cache
