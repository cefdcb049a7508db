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
backward. Under a mesh that splits the padded heads (``q_heads`` on
``model``), q and the output stay split: each rank runs the flash over
its own real heads alone, against the kv heads they read (picked to
them), writes zeros for its pad heads, and a rank of pad heads computes
nothing (``_rank_heads``; the flash VJP likewise, ``_CausalFlash``'s
``heads``), where JAX's layout repeats and pads kv to every padded head
and attends over the pad heads too. The decode attends against a cache
split over its sequence on ``model``, so its q is made whole there
(a (B, 1, Hp, hd) gather), as JAX's decode drops the pad heads.

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
from typing import Dict, List, Optional, Tuple

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
    if is_dtensor(q) and any(p.is_partial() for p in q.placements):
        # DTensor may contract over the FSDP-split embed dim, leaving q
        # a partial sum over the batch's mesh dims: summed into its rows
        # here, so RoPE and what follows run a block of rows a rank
        q = shard(q, "batch", "seq", "q_heads", "head_dim")
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
    j = _head_mesh_dim(q) if Hp != H else None
    if j is not None:
        return _rank_heads(
            lambda ql, kl, vl, first: _attend_real(
                ql, kl, vl, (first, H, cfg.q_per_kv), q_offset=q_offset)[0],
            q, k, v, j)
    o = kops.flash_attention(q[:, :, :H].transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(),
                             causal=True, q_offset=q_offset).transpose(1, 2)
    if Hp != H:
        o = shd.pad(o, (0, 0, 0, Hp - H))
    return o


def _real_heads(q, k, v, first: int, real: int, q_per_kv: int):
    """The real heads of a block of padded q heads (B,S,n,hd), those of
    index ``first ..`` in the padded set (the ones below ``real``), and
    kv (B,S,kv,hd) picked to them, q head ``first + i`` reading kv head
    ``(first + i) // q_per_kv``: (q, k, v, the kv head each reads), or
    None for a block of pad heads."""
    nr = max(0, min(q.shape[2], real - first))
    if not nr:
        return None
    kv_of = [(first + i) // q_per_kv for i in range(nr)]
    idx = torch.tensor(kv_of, device=k.device)
    return q[:, :, :nr], k.index_select(2, idx), v.index_select(2, idx), \
        kv_of


def _attend_real(q, k, v, heads: Tuple[int, int, int], q_offset: int = 0,
                 with_stats: bool = False):
    """The flash over one block of padded q heads (B,S,n,hd), ``heads`` =
    (first, real, q_per_kv) as ``_real_heads`` takes them: its real heads
    against the kv heads they read, pad heads zero, nothing computed for
    a block of pad heads. Returns (B,S,n,hd) in q.dtype, ``_real_heads``'
    pick (None for pad heads) and, ``with_stats``, the (B,nr,S) row
    statistics (m, l)."""
    picked = _real_heads(q, k, v, *heads)
    if picked is None:
        return torch.zeros_like(q), None, None
    qr, kr, vr, _ = picked
    o = kops.flash_attention(qr.transpose(1, 2).contiguous(),
                             kr.transpose(1, 2).contiguous(),
                             vr.transpose(1, 2).contiguous(), causal=True,
                             q_offset=q_offset, with_stats=with_stats)
    o, stats = (o[0], o[1:]) if with_stats else (o, None)
    o = o.transpose(1, 2)
    return F.pad(o, (0, 0, 0, q.shape[2] - qr.shape[2])), picked, stats


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


def _sum_heads(g, kv_of: List[int], n_kv: int):
    """(B,S,n,hd) cotangent of kv picked per q head (q head i read kv head
    ``kv_of[i]``, ascending) -> (B,S,n_kv,hd): each kv head's sum over
    its q heads in f32, in ascending q head order, rounded once to g's
    dtype; a kv head no q head read gets zeros (the transpose of
    ``_repeat_kv`` and of ``_real_heads``' pick). Where every kv head
    has its r q heads in a row (kv repeated to n heads), all kv heads
    are summed at once: the same values in r - 1 additions."""
    B, S, n, HD = g.shape
    r = n // n_kv
    if n == r * n_kv and list(kv_of) == [i // r for i in range(n)]:
        grp = g.view(B, S, n_kv, r, HD)
        acc = grp[:, :, :, 0].float()
        for j in range(1, r):
            acc = acc + grp[:, :, :, j].float()
        return acc.to(g.dtype)
    heads = []
    for c in range(n_kv):
        members = [i for i, h in enumerate(kv_of) if h == c]
        if not members:
            heads.append(g.new_zeros(g.shape[:2] + g.shape[3:]))
            continue
        acc = g[:, :, members[0]].float()
        for i in members[1:]:
            acc = acc + g[:, :, i].float()
        heads.append(acc.to(g.dtype))
    return torch.stack(heads, dim=2)


class _CausalFlash(torch.autograd.Function):
    """Causal GQA flash attention with the JAX package's flash VJP.

    q: (B,S,H,hd); k, v: (B,S,kv,hd), not repeated. Returns (B,S,H,hd)
    in q.dtype. The forward is the flash wrapper (kernel on the card,
    plain version on the CPU) with its row statistics; the backward
    repeats kv per q head, runs ``_flash_bwd`` and sums each kv head's
    gradient over its q heads (``_sum_heads``).

    ``heads`` = (first, real, q_per_kv) makes q a block of padded heads
    (``_attend_real``): its real heads attend against the kv heads they
    read (picked to them, so the kernel runs them as one kv head each),
    its pad heads give zeros and take no gradient, and a block of pad
    heads computes nothing."""

    @staticmethod
    def forward(ctx, q, k, v, q_block: int, kv_chunk: int, heads=None):
        ctx.plan = (q_block, kv_chunk)
        ctx.heads = heads
        if heads is not None:
            ctx.like = (q.new_zeros(()).expand(q.shape),
                        k.new_zeros(()).expand(k.shape))
            out, picked, stats = _attend_real(q, k, v, heads,
                                              with_stats=True)
            ctx.kv_of = picked[3] if picked is not None else []
            if picked is not None:
                ctx.save_for_backward(*picked[:3], out, *stats)
            return out
        out, m, l = kops.flash_attention(q.transpose(1, 2).contiguous(),
                                         k.transpose(1, 2).contiguous(),
                                         v.transpose(1, 2).contiguous(),
                                         causal=True, with_stats=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.heads is not None and not ctx.kv_of:
            q0, k0 = ctx.like
            return (torch.zeros_like(q0), torch.zeros_like(k0),
                    torch.zeros_like(k0), None, None, None)
        q, k, v, out, m, l = ctx.saved_tensors
        if ctx.heads is not None:
            nr = len(ctx.kv_of)
            res = (q, k, v, out[:, :, :nr], m, l)
            dq, dk, dv = _flash_bwd(*ctx.plan, res,
                                    dout[:, :, :nr].to(q.dtype))
            q0, k0 = ctx.like
            n_kv = k0.shape[2]
            return (F.pad(dq, (0, 0, 0, q0.shape[2] - nr)),
                    _sum_heads(dk, ctx.kv_of, n_kv),
                    _sum_heads(dv, ctx.kv_of, n_kv), None, None, None)
        rep = q.shape[2] // k.shape[2]
        kr = k.repeat_interleave(rep, dim=2)
        vr = v.repeat_interleave(rep, dim=2)
        dq, dk, dv = _flash_bwd(*ctx.plan, (q, kr, vr, out, m, l),
                                dout.to(q.dtype))
        n_kv, kv_of = k.shape[2], [i // rep for i in range(q.shape[2])]
        return (dq, _sum_heads(dk, kv_of, n_kv), _sum_heads(dv, kv_of, n_kv),
                None, None, None)


def causal_flash(q, k, v, q_block: int, kv_chunk: int):
    """Differentiable causal GQA flash attention (see ``_CausalFlash``);
    DTensors run it per rank on their own rows and heads
    (``kops.local_call``)."""
    return kops.local_call(
        lambda q, k, v: _CausalFlash.apply(q, k, v, q_block, kv_chunk),
        (q, k, v), ((0, 2, False), (0, 2, True), (0, 2, True)), ((0, 2),),
        ratio=q.shape[2] // k.shape[2])


def _head_mesh_dim(q) -> Optional[int]:
    """The mesh dim that splits the heads of a (B,S,Hp,hd) DTensor q, or
    None (a plain tensor, or heads whole on every rank)."""
    if not is_dtensor(q):
        return None
    for j, p in enumerate(q.placements):
        if p.is_shard(2) and q.device_mesh.size(j) > 1:
            return j
    return None


def _rank_heads(fn, q, k, v, j: int):
    """``fn(q_l, k_l, v_l, first)`` per rank on its own block of q's
    padded heads (split over mesh dim ``j``; ``first`` the block's first
    head), against every kv head, on its batch rows: q and the
    output stay split over the heads, nothing gathers them. kv is
    replicated over ``j`` (a gather where it is split there) and its
    gradient summed over the ranks of ``j`` (``Partial``), as JAX's
    repeated and padded kv is a reshard of kv and its gradient the sum
    over the heads; every other dimension is made whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    k = shd.as_dtensor(k, mesh)
    q_pl, kv_pl, kv_grad = [], [], []
    for m, p in enumerate(q.placements):
        if m == j:
            q_pl.append(Shard(2))
            kv_pl.append(Replicate())
            kv_grad.append(Partial())
        elif p.is_shard(0) or p.is_partial() or k.placements[m].is_shard(0):
            # rows split where q's or kv's are (a partial q, the product
            # of an FSDP-split weight, is summed into its rows' ranks)
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            kv_grad.append(Shard(0))
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    first = mesh.get_local_rank(j) * (q.shape[2] // mesh.size(j))
    run = local_map(lambda ql, kl, vl: fn(ql, kl, vl, first),
                    out_placements=q_pl,
                    in_placements=(q_pl, kv_pl, kv_pl),
                    in_grad_placements=(q_pl, kv_grad, kv_grad),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, shd.as_dtensor(v, mesh))


# ----------------------------------------------------------- public ops

def attn_train(params, x, positions, cfg: ModelConfig):
    """Full-sequence causal self-attention (training forward), with the
    flash VJP. The kernel runs whatever ``cfg.attn_impl`` says, as in
    prefill: it is the port's one route."""
    with scope.named_scope("qkv"):
        q, k, v = _project_qkv(params, x, cfg, positions)
    with scope.named_scope("flash"):
        H, Hp = cfg.num_heads, q.shape[2]
        j = _head_mesh_dim(q) if Hp != H else None
        if j is not None:
            plan = (cfg.attn_chunk, cfg.attn_chunk)
            o = _rank_heads(
                lambda ql, kl, vl, first: _CausalFlash.apply(
                    ql, kl, vl, *plan, (first, H, cfg.q_per_kv)), q, k, v, j)
        else:
            o = causal_flash(q[:, :, :H], k, v, cfg.attn_chunk,
                             cfg.attn_chunk)
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
