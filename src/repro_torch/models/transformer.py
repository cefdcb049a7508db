"""Dense decoder blocks and layer stacks (prefill, decode).

Port of the dense branches of ``repro.models.transformer``. Layer
parameters stay stacked along a leading layer axis, as the JAX schema
has them; a Python loop over layers takes the place of ``lax.scan``.
The ssm/hybrid/MoE families are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (index_tree, mlp_apply, mlp_schema,
                                       rmsnorm, rmsnorm_schema, stack_schema)


def block_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Schema of ONE layer of the homogeneous stack."""
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


def mlp_residual(lp, h, cfg: ModelConfig):
    return h + mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps))


def stack_prefill(params, x, positions, cfg: ModelConfig, cache_len: int):
    """Forward pass that also builds the serving cache.

    Returns (x, {"k", "v"}) with cache leaves (L, B, cache_len, kv, hd)
    in ``kv_cache_dtype``; rows past the prompt are zero."""
    B, S, _ = x.shape
    L = cfg.num_layers
    shape = (L, B, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    kvd = getattr(torch, cfg.kv_cache_dtype)
    ck = torch.zeros(shape, dtype=kvd, device=x.device)
    cv = torch.zeros(shape, dtype=kvd, device=x.device)
    for li in range(L):
        lp = index_tree(params["layers"], li)
        a, (k, v) = attn.attn_prefill(
            lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), positions, cfg)
        ck[li, :, :S] = k
        cv[li, :, :S] = v
        x = mlp_residual(lp, x + a, cfg)
    return rmsnorm(x, params["ln_f"], cfg.norm_eps), {"k": ck, "v": cv}


def stack_decode(params, cache, x, pos: int, cfg: ModelConfig):
    """One decode step through the stack; the cache is updated in place.
    Returns (x, cache)."""
    for li in range(cfg.num_layers):
        lp = index_tree(params["layers"], li)
        a, _, _ = attn.attn_decode(
            lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
            cache["k"][li], cache["v"][li], pos, cfg)
        x = mlp_residual(lp, x + a, cfg)
    return rmsnorm(x, params["ln_f"], cfg.norm_eps), cache
