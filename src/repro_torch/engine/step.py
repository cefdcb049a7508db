"""Engine step builders: bucketed prefill / scatter / chunk prefill /
paged decode.

Port of ``repro.engine.step``. Each builder returns a plain function of
tensors; PyTorch runs eagerly, so a "step" is built once per (phase,
shape) and nothing is traced.

- **prefill**: batch-1 forward over the page-aligned padded prompt; the
  logits are gathered at the *real* last token. Causal attention makes
  every real row independent of the padding after it.
- **scatter**: copies the prefill's page-major K/V blocks into the pool
  at the request's page-table entries, in place (``index_copy_``), the
  analogue of JAX's donated pool buffers.
- **chunkpf**: continuation prefill of one page-aligned prompt chunk
  against K/V context gathered from the pool. The flash kernel takes the
  chunk's rows at ``q_offset = ctx_len`` and walks the same kv blocks
  for each row as the whole-prompt call (see
  ``kernels.flash_attention``), so the chunk's attention rows equal the
  whole prompt's bit for bit.
- **decode**: batched single-token step over the paged pool, through the
  paged-attention kernel (``use_kernel``) or its plain dense-gather
  version (the same function ``paged_attention_plain``).

Padded lanes of a decode bucket run token 0 at position 0 against the
null page; every dummy lane writes identical values to the same slot,
so no real page is touched.

The steps carry the JAX steps' scopes, with the same names, nesting and
layer loop (``scope.scan``): ``embed``, ``layers/scan#0/layer`` with
``attn`` (prefill: ``qkv``, ``flash``, ``out_proj``; chunkpf:
``ctx_gather``, ``flash``, ``out_proj``; decode: ``cache_update``, then
``attend`` on the plain path, the kernel at ``attn`` on the kernel
path, then ``out_proj``) and ``mlp`` (MoE layers: ``moe``, and in the
chunk and decode steps one more ``moe`` around it, as the JAX steps
have it), ``final_norm``, ``last_logits``;
the scatter step's ``page_scatter``. A probed engine bills each step's
cycles to these scopes as the JAX engine does.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import scope
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import _project_qkv, causal_attend, out_proj
from repro_torch.models.layers import index_tree, rmsnorm
from repro_torch.models.model import unsupported


def engine_compatible(cfg) -> bool:
    """Token-in/token-out attention stacks only (dense and MoE): the paged
    KV layout has no analogue for SSM/hybrid recurrent state or frontend
    embeds."""
    return (cfg.family not in ("ssm", "hybrid") and cfg.frontend == "none"
            and not unsupported(cfg))


def _gather_last(model, p, x, last_idx):
    """Final-norm output rows at ``last_idx`` -> (B, V) f32 logits."""
    last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
    return model._logits(p, last)


def build_engine_prefill(model, n_pages: int, page_size: int) -> Callable:
    """Batch-1 prefill over ``n_pages * page_size`` padded tokens.

    fn(params, batch) with batch = {"tokens": (1, n_pages*page_size),
    "last_idx": (1,)} -> (logits (1, V) at last_idx, k, v) where k/v are
    (L, n_pages, page_size, kv_heads, head_dim) page-major cache blocks.
    """
    cfg = model.cfg
    seq = n_pages * page_size

    def prefill(params, batch):
        p = model._compute_cast(params)
        x = model._embed_in(p, batch)
        B, S, _ = x.shape
        if S != seq:
            raise ValueError(f"prefill step for {seq} tokens got {S}")
        positions = model._positions(batch, S, B, x.device)
        x, cache = tfm.stack_prefill(p["stack"], x, positions, cfg, seq)
        with scope.named_scope("last_logits"):
            logits = _gather_last(model, p, x, batch["last_idx"])
        L = cfg.num_layers
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        k = cache["k"].reshape(L, n_pages, page_size, kv, hd)
        v = cache["v"].reshape(L, n_pages, page_size, kv, hd)
        return logits, k, v

    return prefill


def build_page_scatter(n_pages: int) -> Callable:
    """Cache-management step: write ``n_pages`` prefilled page blocks
    into the pool at the request's page-table entries, in place.

    fn(pool_k, pool_v, k, v, page_ids (n_pages,)) -> (pool_k, pool_v).
    Re-writing a prefix-shared page stores the same values (same token
    prefix -> same KV rows), so sharing never perturbs readers.
    """

    def scatter(pool_k, pool_v, k, v, page_ids):
        if page_ids.shape[0] != n_pages:
            raise ValueError(f"scatter of {n_pages} pages got "
                             f"{page_ids.shape[0]} ids")
        with scope.named_scope("page_scatter"):
            ids = page_ids.long()
            pool_k.index_copy_(1, ids, k.to(pool_k.dtype))
            pool_v.index_copy_(1, ids, v.to(pool_v.dtype))
        return pool_k, pool_v

    return scatter


def build_chunk_prefill(model, ctx_pages: int, chunk_pages: int,
                        page_size: int) -> Callable:
    """Continuation prefill: one page-aligned prompt chunk against the
    request's already-written context pages in the pool.

    fn(params, pool_k, pool_v, batch) with batch = {"tokens":
    (1, chunk_pages*page_size), "ctx_pages": (ctx_pages,) int32,
    "last_idx": (1,)} -> (logits (1, V) at last_idx *within the chunk*,
    k, v) where k/v are (L, chunk_pages, page_size, kv, hd) page-major
    cache blocks for the chunk's own rows.

    Context K/V gathered from the pool equals the freshly computed K/V
    the whole-prompt step would attend: attention rounds K/V to bf16, and
    the pool's ``kv_cache_dtype`` round-trip commutes with that rounding
    (exact for bf16 and f32 caches).
    """
    cfg = model.cfg
    ctx_len = ctx_pages * page_size
    Sq = chunk_pages * page_size
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def chunkpf(params, pool_k, pool_v, batch):
        p = model._compute_cast(params)
        x = model._embed_in(p, batch)
        if x.shape[1] != Sq:
            raise ValueError(f"chunk step for {Sq} tokens got {x.shape[1]}")
        cd = x.dtype
        positions = torch.arange(ctx_len, ctx_len + Sq, device=x.device)[None]
        ctx_ids = batch["ctx_pages"].long()
        ks, vs = [], []
        stack = p["stack"]
        with scope.named_scope("layers"):
            for li in scope.scan(cfg.num_layers):
                with scope.named_scope("layer"):
                    lp = index_tree(stack["layers"], li)
                    with scope.named_scope("attn"):
                        qn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
                        q, k_new, v_new = _project_qkv(lp["attn"], qn, cfg,
                                                       positions)
                        with scope.named_scope("ctx_gather"):
                            kc = pool_k[li][ctx_ids].reshape(
                                1, ctx_len, kv, hd).to(cd)
                            vc = pool_v[li][ctx_ids].reshape(
                                1, ctx_len, kv, hd).to(cd)
                            k_full = torch.cat([kc, k_new], dim=1)
                            v_full = torch.cat([vc, v_new], dim=1)
                        with scope.named_scope("flash"):
                            o = causal_attend(q, k_full, v_full, cfg,
                                              q_offset=ctx_len).to(cd)
                        with scope.named_scope("out_proj"):
                            a = out_proj(o, lp["attn"]["wo"])
                    x = tfm.mlp_residual(lp, x + a, cfg, moe_scope=True)
                    ks.append(k_new[0])
                    vs.append(v_new[0])
        with scope.named_scope("final_norm"):
            x = rmsnorm(x, stack["ln_f"], cfg.norm_eps)
        with scope.named_scope("last_logits"):
            logits = _gather_last(model, p, x, batch["last_idx"])
        L = cfg.num_layers
        k = torch.stack(ks).reshape(L, chunk_pages, page_size, kv, hd)
        v = torch.stack(vs).reshape(L, chunk_pages, page_size, kv, hd)
        return logits, k, v

    return chunkpf


def _paged_attend(lp, x, kp, vp, pages, pos, cfg, page_size: int,
                  use_kernel: bool, pages_per_step: int, pos_host=None):
    """Write this token's K/V into the pool (in place), then attend over
    the row's pages. Returns (B, kv, g, hd) f32."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(lp, x, cfg, pos.long()[:, None])
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qg = q[:, 0, :H].reshape(B, kv, cfg.q_per_kv, hd)
    with scope.named_scope("cache_update"):
        pos_l = pos.long()
        pidx = pages.long().gather(1, (pos_l // page_size)[:, None])[:, 0]
        slot = pos_l % page_size
        kp[pidx, slot] = k_new[:, 0].to(kp.dtype)
        vp[pidx, slot] = v_new[:, 0].to(vp.dtype)
    if use_kernel:
        return kops.paged_attention(qg, kp, vp, pages, pos,
                                    pages_per_step=pages_per_step,
                                    pos_host=pos_host)
    with scope.named_scope("attend"):
        return paged_attention_plain(qg, kp, vp, pages, pos)


def build_paged_decode(model, batch_size: int, n_pages: int,
                       page_size: int, *, use_kernel: bool = True,
                       pages_per_step: int = 1) -> Callable:
    """Batched single-token decode over the paged pool.

    fn(params, pool_k, pool_v, batch) with batch = {"tokens": (B, 1),
    "pos": (B,) int32, "pages": (B, n_pages) int32} ->
    (logits (B, V), pool_k, pool_v, next_tokens (B,)); the pools are
    updated in place. The batch may also hold "pos_host", the positions
    as a tuple of host ints, which a probe of the paged kernel's grid
    steps needs (``paged_attention``); the engine always passes them.
    """
    cfg = model.cfg

    def decode(params, pool_k, pool_v, batch):
        p = model._compute_cast(params)
        x = model._embed_in(p, batch)
        pos, pages = batch["pos"], batch["pages"]
        if x.shape[0] != batch_size or pages.shape[1] != n_pages:
            raise ValueError(f"decode step for ({batch_size}, {n_pages}) "
                             f"got {tuple(pages.shape)}")
        B = x.shape[0]
        H, hd = cfg.num_heads, cfg.resolved_head_dim
        stack = p["stack"]
        with scope.named_scope("layers"):
            for li in scope.scan(cfg.num_layers):
                with scope.named_scope("layer"):
                    lp = index_tree(stack["layers"], li)
                    with scope.named_scope("attn"):
                        o = _paged_attend(
                            lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            pool_k[li], pool_v[li], pages, pos, cfg,
                            page_size, use_kernel, pages_per_step,
                            batch.get("pos_host"))
                        with scope.named_scope("out_proj"):
                            ow = o.reshape(B, 1, H, hd).to(x.dtype)
                            Hp = lp["attn"]["wo"].shape[0]
                            if Hp != H:
                                ow = torch.nn.functional.pad(
                                    ow, (0, 0, 0, Hp - H))
                            a = out_proj(ow, lp["attn"]["wo"])
                    x = tfm.mlp_residual(lp, x + a, cfg, moe_scope=True)
        with scope.named_scope("final_norm"):
            x = rmsnorm(x, stack["ln_f"], cfg.norm_eps)
        with scope.named_scope("last_logits"):
            logits = model._logits(p, x[:, -1])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, pool_k, pool_v, next_tok

    return decode
