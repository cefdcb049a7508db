"""Declarative DSE search spaces for the port's CUDA kernels.

Port of ``repro.kernels.search_spaces``. Each factory builds a
``repro_torch.core.dse.SearchSpace`` over the axes that change the CUDA
kernel's work, at a concrete problem shape (tuning is shape-specific,
like the paper's per-design DSE). The JAX package's axes map so:

- flash attention: ``block_q`` and ``block_k`` are the CUDA kernel's q
  tile and kv block (``kernels.flash_attention.BLOCKS_Q`` /
  ``BLOCKS_K``); ``pipeline`` (kv blocks a TPU grid step fetches) has no
  counterpart: the kernel double-buffers every kv block by ``cp.async``,
  so it would change no work and is not an axis;
- paged attention: ``pages_per_step`` is validated by the port but
  changes no work (the kernel stages no page groups); the axis that does
  is the kernel's own ``tile_slots`` (slots a CTA, ``TILES``);
- SSD scan: ``chunk``, a run-time argument of the CUDA kernels already;
  ``pipeline`` (sub-chunks of a chunk) stays 1, the sub-chunk being the
  chunk the axis spans.

Each space states its candidates' resources where the kernel declares
them (``flash_resources``, ``paged_resources``, ``ssd_resources``), so
the budget prunes a tile (an SSD chunk) the card cannot hold before it
is ever launched. The ``bind``
closures call the kernel wrappers with explicit tiles (not the ``ops``
wrappers' tuned defaults). Inputs come from a seeded ``torch.Generator``
on the space's device (the GPU unless ``device="cpu"``).

``chunked_prefill`` tunes a *schedule* (the engine's prefill chunk
quantum) rather than kernel tiles: its bind runs the engine's steps,
whose flash calls take the default tiles; it declares no resources and
is never pruned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import scope
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def flash_attention_space(*, B: int = 1, H: int = 2, S: int = 256,
                          D: int = 64, Hkv: Optional[int] = None,
                          causal: bool = True, dtype=torch.bfloat16,
                          blocks_q: Tuple[int, ...] = _fa.BLOCKS_Q,
                          blocks_k: Tuple[int, ...] = _fa.BLOCKS_K,
                          seed: int = 0, device=None):
    """Tile space of the causal GQA flash kernel: q (B, H, S, D), k, v
    (B, Hkv, S, D), unit normal."""
    from repro_torch.core.dse import SearchSpace
    dev = resolve_device(device)
    Hkv = Hkv or H
    g = _gen(dev, seed)
    q = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dtype)
    shapes = ((B, H, S, D), (B, Hkv, S, D), 0, causal)

    def is_valid(cfg):
        return cfg["block_q"] <= max(S, _fa.BLOCK_Q) and \
            cfg["block_k"] <= max(S, _fa.BLOCK_K)

    def bind(cfg):
        bq, bk = cfg["block_q"], cfg["block_k"]

        def fn(q, k, v):
            with scope.named_scope("flash_attention"):
                return _fa.flash_attention(q, k, v, causal=causal,
                                           block_q=bq, block_k=bk)
        return fn

    return SearchSpace(
        kernel_id="flash_attention",
        axes={"block_q": tuple(blocks_q), "block_k": tuple(blocks_k)},
        bind=bind, args=(q, k, v),
        default={"block_q": _fa.BLOCK_Q, "block_k": _fa.BLOCK_K},
        is_valid=is_valid,
        resources=lambda cfg: _fa.flash_resources(
            D, cfg["block_q"], cfg["block_k"], shapes=shapes,
            itemsize=q.element_size()))


def ssd_scan_space(*, B: int = 1, H: int = 4, G: int = 2, L: int = 256,
                   P: int = 16, N: int = 32,
                   chunks: Tuple[int, ...] = (32, 64, 128, 256),
                   dtype=torch.float32, seed: int = 0, device=None):
    """Chunk space of the Mamba-2 SSD scan, in the model layout: x (B, L,
    H, P) * 0.5, a = -|n| * 0.3 (B, L, H) f32, b, c (B, L, G, N) * 0.5."""
    from repro_torch.core.dse import SearchSpace
    dev = resolve_device(device)
    g = _gen(dev, seed)
    x = (torch.randn((B, L, H, P), generator=g, device=dev) * 0.5).to(dtype)
    a = -torch.randn((B, L, H), generator=g, device=dev).abs() * 0.3
    b = (torch.randn((B, L, G, N), generator=g, device=dev) * 0.5).to(dtype)
    c = (torch.randn((B, L, G, N), generator=g, device=dev) * 0.5).to(dtype)

    def is_valid(cfg):
        ch = cfg["chunk"]
        return ch <= L and L % ch == 0 and ch >= 8

    def bind(cfg):
        ch = cfg["chunk"]

        def fn(x, a, b, c):
            with scope.named_scope("ssd_scan"):
                return _ssd.ssd_scan(x, a, b, c, chunk=ch, h_per_g=H // G)
        return fn

    return SearchSpace(
        kernel_id="ssd_scan", axes={"chunk": tuple(chunks)},
        bind=bind, args=(x, a, b, c), default={"chunk": min(256, L)},
        is_valid=is_valid,
        resources=lambda cfg: _ssd.ssd_resources(x.element_size(), N,
                                                 cfg["chunk"]))


def paged_attention_space(*, B: int = 4, KV: int = 4, G: int = 2,
                          HD: int = 64, page_size: int = 16,
                          n_pages: int = 8, pool_pages: Optional[int] = None,
                          kv_dtype=torch.bfloat16,
                          q_dtype=torch.float32,
                          tiles: Tuple[int, ...] = _pa.TILES,
                          pos: Optional[Tuple[int, ...]] = None,
                          seed: int = 0, device=None):
    """Tile space of the paged-attention decode kernel.

    The workload is a randomly permuted page table (the serving engine's
    steady state: pages are scattered by alloc/free churn), with the
    positions spread across the cache range, as the JAX space's, unless
    ``pos`` gives them (the engine's decode shape has every row at one
    position). The pool holds ``pool_pages`` pages, by default 64 or the
    rows' pages if more (the JAX space's fixed 64 cannot give 8 rows 32
    distinct pages each). The queries are f32, as the JAX space's,
    unless ``q_dtype`` gives another type (the engine's decode passes its
    compute type).
    """
    from repro_torch.core.dse import SearchSpace
    dev = resolve_device(device)
    if pool_pages is None:
        pool_pages = max(64, B * n_pages)
    g = _gen(dev, seed)
    q = torch.randn((B, KV, G, HD), generator=g, device=dev).to(q_dtype)
    pool_k = torch.randn((pool_pages, page_size, KV, HD), generator=g,
                         device=dev).to(kv_dtype)
    pool_v = torch.randn((pool_pages, page_size, KV, HD), generator=g,
                         device=dev).to(kv_dtype)
    perm = torch.randperm(pool_pages, generator=g, device=dev)
    pages = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
    s_max = page_size * n_pages
    if pos is None:
        pos = tuple((i * (s_max // max(B, 1)) + page_size - 1) % s_max
                    for i in range(B))
    pos_host = tuple(int(p) for p in pos)
    pos_t = torch.tensor(pos_host, dtype=torch.int32, device=dev)
    shapes = ((B, KV, G, HD), tuple(pool_k.shape), (B, n_pages))

    def bind(cfg):
        ts = cfg["tile_slots"]

        def fn(q, pool_k, pool_v, pages, pos):
            with scope.named_scope("paged_attention"):
                return _pa.paged_attention(q, pool_k, pool_v, pages, pos,
                                           pos_host=pos_host, tile_slots=ts)
        return fn

    return SearchSpace(
        kernel_id="paged_attention", axes={"tile_slots": tuple(tiles)},
        bind=bind, args=(q, pool_k, pool_v, pages, pos_t),
        default={"tile_slots": _pa.TILE_SLOTS},
        resources=lambda cfg: _pa.paged_resources(
            HD, G, cfg["tile_slots"], shapes=shapes))


def chunked_prefill_space(*, arch: str = "tinyllama-1.1b",
                          prompt_pages: int = 4, page_size: int = 16,
                          chunks: Optional[Tuple[int, ...]] = None,
                          full: bool = False, seed: int = 0, device=None):
    """Chunk-size space for the engine's chunked-prefill schedule.

    The tunable axis is ``chunk_pages``: how many pages of prompt one
    scheduler quantum prefills (``EngineConfig.prefill_chunk_pages``).
    Each candidate binds the whole chain the engine runs for a
    ``prompt_pages`` prompt: an opening prefill step, then continuation
    chunks against the pool (``build_chunk_prefill``), each followed by
    its page scatter. Every candidate computes the same logits (chunking
    is a schedule change), so the engine prices pure overhead: context
    re-gather and per-chunk dispatch against head-of-line latency. The
    model is the smoke config of ``arch`` (``full``: its full width and
    depth), random weights from ``seed``, cast once to the compute type.
    """
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core.dse import SearchSpace
    from repro_torch.engine.step import (build_chunk_prefill,
                                         build_engine_prefill,
                                         build_page_scatter)
    from repro_torch.models import Model

    dev = resolve_device(device)
    cfg = get_config(arch) if full else smoke_config(arch)
    model = Model(cfg)
    params = model._compute_cast(model.init(seed, device=dev))
    pp, ps = prompt_pages, page_size
    if chunks is None:   # pow2 quanta plus the whole-prompt baseline
        chunks = tuple(sorted(set(_pow2_range(1, pp)) | {pp}))
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kvd = getattr(torch, cfg.kv_cache_dtype)
    # identity page table: prompt page i lives at pool slot i+1 (slot 0
    # is the engine's pinned null page)
    pool_shape = (cfg.num_layers, pp + 2, ps, kv, hd)
    tokens = torch.randint(0, cfg.vocab_size, (1, pp * ps),
                           generator=_gen(dev, seed + 1), device=dev,
                           dtype=torch.int32)

    def is_valid(c):
        return 1 <= c["chunk_pages"] <= pp

    def bind(c):
        K = c["chunk_pages"]
        plan = []                        # (cs, n, step_fn, scatter_fn)
        cs = 0
        while cs < pp:
            n = min(K, pp - cs)
            step = (build_engine_prefill(model, n, ps) if cs == 0
                    else build_chunk_prefill(model, cs, n, ps))
            plan.append((cs, n, step, build_page_scatter(n)))
            cs += n

        def fn(params, pool_k, pool_v, tokens):
            with scope.named_scope("chunked_prefill"):
                logits = None
                for cs, n, step, scatter in plan:
                    batch = {
                        "tokens": tokens[:, cs * ps:(cs + n) * ps],
                        "last_idx": torch.tensor([n * ps - 1],
                                                 dtype=torch.int32,
                                                 device=tokens.device),
                    }
                    if cs == 0:
                        logits, k, v = step(params, batch)
                    else:
                        batch["ctx_pages"] = torch.arange(
                            1, cs + 1, dtype=torch.int32,
                            device=tokens.device)
                        logits, k, v = step(params, pool_k, pool_v, batch)
                    ids = torch.arange(cs + 1, cs + n + 1, dtype=torch.int32,
                                       device=tokens.device)
                    pool_k, pool_v = scatter(pool_k, pool_v, k, v, ids)
                return logits, pool_k, pool_v
        return fn

    return SearchSpace(
        kernel_id="chunked_prefill",
        axes={"chunk_pages": tuple(chunks)},
        bind=bind,
        args=(params, torch.zeros(pool_shape, dtype=kvd, device=dev),
              torch.zeros(pool_shape, dtype=kvd, device=dev), tokens),
        default={"chunk_pages": pp},
        is_valid=is_valid)


SPACES = {
    "flash_attention": flash_attention_space,
    "ssd_scan": ssd_scan_space,
    "paged_attention": paged_attention_space,
    "chunked_prefill": chunked_prefill_space,
}


# ------------------------------------------------- sweep-farm variants

def _pow2_range(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    v = 1
    while v <= hi:
        if v >= lo:
            out.append(v)
        v *= 2
    return tuple(out)


def sweep_space(kernel_id: str, **shape):
    """Dense sweep-farm variant of a registered space: same ``bind`` /
    validity / default. The flash and paged tiles are the kernels' whole
    instantiated sets already; the SSD chunk widens to every power of
    two from ``max(8, L // 32)`` to ``L``, the prefill chunk to every
    power of two up to the prompt. Rebuilt by name inside sweep workers:
    ``bind`` closures do not pickle across the spawn boundary."""
    if kernel_id in ("flash_attention", "paged_attention"):
        return SPACES[kernel_id](**shape)
    if kernel_id == "ssd_scan":
        L = int(shape.get("L", 256))
        return ssd_scan_space(chunks=_pow2_range(max(8, L // 32), L),
                              **shape)
    if kernel_id == "chunked_prefill":
        pp = int(shape.get("prompt_pages", 4))
        chunks = tuple(sorted(set(_pow2_range(1, pp)) | {pp}))
        return chunked_prefill_space(chunks=chunks, **shape)
    raise KeyError(f"no sweep space for kernel {kernel_id!r}; "
                   f"known: {tuple(SPACES)}")


def sweep_shapes(kernel_id: str, *, seqs: Tuple[int, ...] = (),
                 heads: Tuple[int, ...] = ()) -> list:
    """Default (sequence x heads) shape grid a sweep iterates, as the JAX
    package's (head dim 64: the kernel's smallest)."""
    if kernel_id == "flash_attention":
        return [{"S": s, "H": h, "D": 64}
                for s in (seqs or (128, 256, 512))
                for h in (heads or (2,))]
    if kernel_id == "ssd_scan":
        return [{"L": s, "H": h, "G": 1}
                for s in (seqs or (128, 256, 512))
                for h in (heads or (2,))]
    if kernel_id == "paged_attention":
        return [{"n_pages": n} for n in (seqs or (8, 16))]
    if kernel_id == "chunked_prefill":
        return [{"prompt_pages": n} for n in (seqs or (2, 4))]
    raise KeyError(f"no sweep shapes for kernel {kernel_id!r}; "
                   f"known: {tuple(SPACES)}")
