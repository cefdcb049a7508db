"""GQA attention: training and prefill (flash kernel) + single-token decode.

Port of ``repro.models.attention``. Training and prefill run through
the port's flash kernel wrapper (``kernels.flash_attention``): the CUDA
kernel for CUDA tensors, its plain version (the port of
``_flash_row``/``_flash_fwd``) for CPU tensors. The JAX package computes
the same function with XLA ops (``causal_flash_xla``). Decode keeps the
compact grouped layout (the KV cache is not repeated) and one global
softmax, operation for operation as ``attn_decode``.

Padded q heads (``padded_heads``) carry dead weights whose outputs JAX
masks to zero (``_head_mask``); here attention runs over the real heads
only and the pad heads' outputs are zeros, the same values. The kernel
maps q head h to kv head h // q_per_kv, so nothing repeats kv
(``_repeat_kv``) outside the flash kernel's plain version and the
backward.

Training (``attn_train``) takes the gradient through a hand-written
flash VJP, as the JAX package's ``causal_flash_xla`` does: the forward
is the flash wrapper with its row statistics (``with_stats``: the CUDA
kernel on the card, the plain ``_flash_row`` path on the CPU), and the
backward is ``_flash_bwd`` in PyTorch ops, recomputing p chunk by chunk
from the saved (m, l), so nothing O(S^2) is kept. No Pallas kernel of
the JAX package has a backward, so neither has the port's kernel.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import is_dtensor, put, shard
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import _bf16
from repro_torch.models.layers import Param, apply_mrope, apply_rope


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


class _FlatHeads(torch.autograd.Function):
    """(d, n, h) -> (d, n h) for a DTensor weight whose gradient's shards
    may cut the heads: the backward makes them whole
    (``sharding.splittable``) before it unflattens."""

    @staticmethod
    def forward(ctx, w):
        ctx.shape = tuple(w.shape)
        d, n, h = ctx.shape
        return w.reshape(d, n * h)

    @staticmethod
    def backward(ctx, g):
        d, n, h = ctx.shape
        return shd.splittable(g, 1, n).reshape(d, n, h)


def _proj(x, w):
    """einsum('bsd,dnh->bsnh', x, w)."""
    d, n, h = w.shape
    w2 = _FlatHeads.apply(w) if is_dtensor(w) else w.reshape(d, n * h)
    return shd.splittable(shd.fold_matmul(x, w2), -1, n).unflatten(-1, (n, h))


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """x: (B,S,d) -> q (B,S,Hp,hd), k,v (B,S,kv,hd) with RoPE applied
    (M-RoPE: positions (3, B, S), one stream a rotary section)."""
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
    elif cfg.pos_emb == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def causal_attend(q, k, v, cfg: ModelConfig, q_offset: int = 0):
    """Causal GQA attention of q rows at positions ``q_offset + i``.

    q: (B,Sq,Hp,hd); k, v: (B,Skv,kv,hd), not repeated. Returns
    (B,Sq,Hp,hd) in q.dtype, pad heads zero."""
    H, Hp = cfg.num_heads, q.shape[2]
    o = kops.flash_attention(q[:, :, :H].transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(),
                             causal=True, q_offset=q_offset).transpose(1, 2)
    if Hp != H:
        o = shd.pad(o, (0, 0, 0, Hp - H))
    return o


def out_proj(o, wo):
    """einsum('bsnh,nhd->bsd', o, wo)."""
    n, h, d = wo.shape
    return shd.fold_matmul(o.flatten(-2), wo.reshape(n * h, d))


# --------------------------------------------- flash VJP (training)

def _row_plan(S: int, q_block: int, kv_chunk: int
              ) -> Tuple[int, List[Tuple[int, int, int]]]:
    """JAX's q-block plan: (q block, [(row offset, causal kv context,
    kv chunk)])."""
    q_block = min(q_block, S)
    if S % q_block:
        q_block = math.gcd(S, q_block) or S
    rows = []
    for i in range(S // q_block):
        ctx = (i + 1) * q_block
        chunk = min(kv_chunk, ctx)
        chunk = math.gcd(ctx, chunk) if ctx % chunk else chunk
        rows.append((i * q_block, ctx, chunk))
    return q_block, rows


def _flash_row_bwd(q_blk, k_ctx, v_ctx, o_blk, do_blk, m, l,
                   q_offset: int, kv_chunk: int, scale: float):
    """Flash backward for one q block row (FA-2 style), operation for
    operation as the JAX package's: p is recomputed chunk by chunk from
    the saved (m, l); products take bf16 inputs and accumulate in f32.
    q_blk, o_blk, do_blk: (B, Sq, H, hd); k_ctx, v_ctx: (B, Skv, H, hd),
    kv repeated per q head; m, l: (B, H, Sq). Returns (dq_blk f32,
    dk_ctx f32, dv_ctx f32)."""
    B, Sq, H, HD = q_blk.shape
    Skv = k_ctx.shape[1]
    dev = q_blk.device
    qb = _bf16(q_blk)
    do = do_blk.transpose(1, 2).float()                     # (B,H,Sq,hd)
    o = o_blk.transpose(1, 2).float()
    delta = torch.sum(do * o, dim=-1)                       # (B,H,Sq)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    do_b = _bf16(do)
    dq = torch.zeros((B, Sq, H, HD), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for c in scope.scan(Skv // kv_chunk):
        k_c = _bf16(k_ctx[:, c * kv_chunk:(c + 1) * kv_chunk])
        v_c = _bf16(v_ctx[:, c * kv_chunk:(c + 1) * kv_chunk])
        s = torch.einsum("bqhd,bkhd->bhqk", qb, k_c) * scale
        k_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = q_pos[:, None] >= k_pos[None, :]
        p = torch.where(mask, torch.exp(s - m_safe[..., None]) / l[..., None],
                        0.0)
        p_b = _bf16(p)
        dvs.append(torch.einsum("bhqk,bhqd->bkhd", p_b, do_b))
        dp = torch.einsum("bhqd,bkhd->bhqk", do_b, v_c)
        ds = _bf16(p * (dp - delta[..., None]) * scale)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_c)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qb))
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _flash_bwd(q_block: int, kv_chunk: int, res, dout):
    """JAX's ``_flash_bwd``: q (B,S,H,hd), k/v repeated to H heads, out,
    and the (B,H,S) statistics m, l; dk/dv accumulate over the q block
    rows in the input dtype, as the JAX package's do (each element takes
    at most one addition a row)."""
    q, k, v, out, m, l = res
    B, S, H, HD = q.shape
    scale = 1.0 / math.sqrt(HD)
    qb, rows = _row_plan(S, q_block, kv_chunk)
    dq_rows = []
    dk = torch.zeros((B, S, H, HD), dtype=k.dtype, device=k.device)
    dv = torch.zeros((B, S, H, HD), dtype=v.dtype, device=v.device)
    for off, ctx, chunk in rows:
        with scope.named_scope("qblk_bwd"):
            dq_r, dk_r, dv_r = _flash_row_bwd(
                q[:, off:off + qb], k[:, :ctx], v[:, :ctx],
                out[:, off:off + qb], dout[:, off:off + qb],
                m[..., off:off + qb], l[..., off:off + qb], off, chunk, scale)
            dq_rows.append(dq_r.to(q.dtype))
            pad = (0, 0, 0, 0, 0, S - ctx)
            dk = dk + F.pad(dk_r.to(k.dtype), pad)
            dv = dv + F.pad(dv_r.to(v.dtype), pad)
    return torch.cat(dq_rows, dim=1), dk, dv


def _sum_groups(g, n_kv: int):
    """(B,S,H,hd) cotangent of kv repeated to H heads -> (B,S,n_kv,hd):
    the sum over each kv head's q heads, in f32, in ascending q head
    order, rounded once to g's dtype (the transpose of ``_repeat_kv``)."""
    B, S, H, HD = g.shape
    grp = g.view(B, S, n_kv, H // n_kv, HD)
    acc = grp[:, :, :, 0].float()
    for j in range(1, H // n_kv):
        acc = acc + grp[:, :, :, j].float()
    return acc.to(g.dtype)


class _CausalFlash(torch.autograd.Function):
    """Causal GQA flash attention with the JAX package's flash VJP.

    q: (B,S,H,hd) (real heads only); k, v: (B,S,kv,hd), not repeated.
    Returns (B,S,H,hd) in q.dtype. The forward is the flash wrapper
    (kernel on the card, plain version on the CPU) with its row
    statistics; the backward repeats kv per q head, runs ``_flash_bwd``
    and sums each kv head's gradient over its q heads (``_sum_groups``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_block: int, kv_chunk: int):
        out, m, l = kops.flash_attention(q.transpose(1, 2).contiguous(),
                                         k.transpose(1, 2).contiguous(),
                                         v.transpose(1, 2).contiguous(),
                                         causal=True, with_stats=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.plan = (q_block, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        rep = q.shape[2] // k.shape[2]
        kr = k.repeat_interleave(rep, dim=2)
        vr = v.repeat_interleave(rep, dim=2)
        dq, dk, dv = _flash_bwd(*ctx.plan, (q, kr, vr, out, m, l),
                                dout.to(q.dtype))
        n_kv = k.shape[2]
        return dq, _sum_groups(dk, n_kv), _sum_groups(dv, n_kv), None, None


def causal_flash(q, k, v, q_block: int, kv_chunk: int):
    """Differentiable causal GQA flash attention (see ``_CausalFlash``);
    DTensors run it per rank on their own rows and heads
    (``kops.local_call``)."""
    return kops.local_call(
        lambda q, k, v: _CausalFlash.apply(q, k, v, q_block, kv_chunk),
        (q, k, v), ((0, 2, False), (0, 2, True), (0, 2, True)), ((0, 2),),
        ratio=q.shape[2] // k.shape[2])


# ----------------------------------------------------------- public ops

def attn_train(params, x, positions, cfg: ModelConfig):
    """Full-sequence causal self-attention (training forward), with the
    flash VJP. The kernel runs whatever ``cfg.attn_impl`` says, as in
    prefill: it is the port's one route."""
    with scope.named_scope("qkv"):
        q, k, v = _project_qkv(params, x, cfg, positions)
    with scope.named_scope("flash"):
        H, Hp = cfg.num_heads, q.shape[2]
        o = causal_flash(q[:, :, :H], k, v, cfg.attn_chunk, cfg.attn_chunk)
        if Hp != H:
            o = shd.pad(o, (0, 0, 0, Hp - H))
    with scope.named_scope("out_proj"):
        o = shard(o.to(x.dtype), "batch", "seq", "q_heads", "head_dim")
        out = out_proj(o, params["wo"])
    return shard(out, "batch", "seq", None)


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
    return shard(out, "batch", "seq", None), (k.to(kvd), v.to(kvd))


def attn_decode(params, x, cache_k, cache_v, pos: int, cfg: ModelConfig):
    """Single-token decode against a dense KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, kv, hd), updated in place at
    ``pos`` (JAX's dynamic_update_slice returns a new cache instead); a
    cache sharded on ``kv_seq`` is written by the rank that holds ``pos``
    (``sharding.put``). Returns (out (B,1,d), cache_k, cache_v)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    if cfg.pos_emb == "mrope":
        positions = positions.expand((3,) + positions.shape)
    with scope.named_scope("qkv"):
        q, k_new, v_new = _project_qkv(params, x, cfg, positions)
        Hp, HD = q.shape[2], q.shape[3]
        H, kv = cfg.num_heads, cfg.num_kv_heads
        qg = shd.splittable(q[:, :, :H], 2, kv).reshape(B, 1, kv,
                                                        cfg.q_per_kv, HD)
    with scope.named_scope("cache_update"):
        put(cache_k, (slice(None), pos), k_new[:, 0].to(cache_k.dtype))
        put(cache_v, (slice(None), pos), v_new[:, 0].to(cache_v.dtype))
        if is_dtensor(cache_k):
            cache_k = shard(cache_k, "batch", "kv_seq", "kv_heads",
                            "head_dim")
            cache_v = shard(cache_v, "batch", "kv_seq", "kv_heads",
                            "head_dim")
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
            o = shd.pad(o, (0, 0, 0, Hp - H))
        out = out_proj(o, params["wo"])
    return shard(out, "batch", "seq", None), cache_k, cache_v
