"""GQA attention: prefill (flash kernel) + single-token decode.

Port of ``repro.models.attention``. Prefill runs through the port's flash
kernel wrapper (``kernels.flash_attention``): the CUDA kernel for CUDA
tensors, its plain version (the port of ``_flash_row``/``_flash_fwd``)
for CPU tensors. The JAX package computes the same function with XLA ops
(``causal_flash_xla``). Decode keeps the compact grouped layout (the KV
cache is not repeated) and one global softmax, operation for operation
as ``attn_decode``.

Padded q heads (``padded_heads``) carry dead weights whose outputs JAX
masks to zero (``_head_mask``); here attention runs over the real heads
only and the pad heads' outputs are zeros, the same values. The kernel
maps q head h to kv head h // q_per_kv, so nothing repeats kv
(``_repeat_kv``) outside the flash kernel's plain version.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Param, apply_rope


def attention_schema(cfg: ModelConfig) -> Dict[str, Param]:
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    Hp = cfg.resolved_padded_heads
    s = {
        "wq": Param((d, Hp, hd), ("embed", "q_heads", "head_dim")),
        "wk": Param((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Param((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Param((Hp, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        s["bq"] = Param((Hp, hd), ("q_heads", "head_dim"), init="zeros")
        s["bk"] = Param((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = Param((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def _proj(x, w):
    """einsum('bsd,dnh->bsnh', x, w)."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).unflatten(-1, (n, h))


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """x: (B,S,d) -> q (B,S,Hp,hd), k,v (B,S,kv,hd) with RoPE applied."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def causal_attend(q, k, v, cfg: ModelConfig, q_offset: int = 0):
    """Causal GQA attention of q rows at positions ``q_offset + i``.

    q: (B,Sq,Hp,hd); k, v: (B,Skv,kv,hd), not repeated. Returns
    (B,Sq,Hp,hd) in q.dtype, pad heads zero."""
    H, Hp = cfg.num_heads, q.shape[2]
    o = flash_attention(q[:, :, :H].transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        causal=True, q_offset=q_offset).transpose(1, 2)
    if Hp != H:
        o = F.pad(o, (0, 0, 0, Hp - H))
    return o


def out_proj(o, wo):
    """einsum('bsnh,nhd->bsd', o, wo)."""
    n, h, d = wo.shape
    return o.flatten(-2) @ wo.reshape(n * h, d)


# ----------------------------------------------------------- public ops

def attn_prefill(params, x, positions, cfg: ModelConfig):
    """Full-sequence causal self-attention that also returns the layer's
    (unrepeated) K/V rows in ``kv_cache_dtype``; the caller places them
    in its cache."""
    with scope.named_scope("qkv"):
        q, k, v = _project_qkv(params, x, cfg, positions)
    with scope.named_scope("flash"):
        o = causal_attend(q, k, v, cfg)
    with scope.named_scope("out_proj"):
        out = out_proj(o.to(x.dtype), params["wo"])
    kvd = getattr(torch, cfg.kv_cache_dtype)
    return out, (k.to(kvd), v.to(kvd))


def attn_decode(params, x, cache_k, cache_v, pos: int, cfg: ModelConfig):
    """Single-token decode against a dense KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, kv, hd), updated in place at
    ``pos`` (JAX's dynamic_update_slice returns a new cache instead).
    Returns (out (B,1,d), cache_k, cache_v)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    with scope.named_scope("qkv"):
        q, k_new, v_new = _project_qkv(params, x, cfg, positions)
        Hp, HD = q.shape[2], q.shape[3]
        H, kv = cfg.num_heads, cfg.num_kv_heads
        qg = q[:, :, :H].reshape(B, 1, kv, cfg.q_per_kv, HD)
    with scope.named_scope("cache_update"):
        cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
    with scope.named_scope("attend"):
        scale = 1.0 / math.sqrt(HD)
        bf = torch.bfloat16
        s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(bf).float(),
                         cache_k.to(bf).float()) * scale
        S_max = cache_k.shape[1]
        mask = torch.arange(S_max, device=x.device) <= pos
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskh->bkgqh", (p / l).to(bf).float(),
                         cache_v.to(bf).float())
    with scope.named_scope("out_proj"):
        o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, H, HD).to(x.dtype)
        if Hp != H:
            o = F.pad(o, (0, 0, 0, Hp - H))
        out = out_proj(o, params["wo"])
    return out, cache_k, cache_v
