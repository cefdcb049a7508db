"""Paged single-token GQA decode attention: a CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``,
function ``paged_attention`` (body ``_paged_kernel``). The CUDA source
is ``src/repro_torch/csrc/paged_attention.cu``.

What bounds it on an H100: memory. Each visible K/V slot is read once
and used for ``g = H / Hkv`` query rows with a few FLOPs per byte (at 8
rows of 544 slots, 4 kv heads, head dim 64: about 4.5 MB of K/V, a bound
near 1.3 us, far below the ~295 FLOP/byte where the tensor cores would
matter), and at the serving shape the call is short enough that launch
latency and the length of each CTA's chain of dependent loads count as
much as the bytes. What the design does about it: each row's visible
slots are cut into tiles of ``TILE_SLOTS`` slots from slot 0 and each
launch takes one CTA per (slot tile, kv head, batch row), 288 CTAs at the
serving shape on 132 SMs; inside a CTA each warp reads whole K/V rows as
16-byte vectors, ``head_dim / 8`` lanes to a row, so every load of a warp
is coalesced, and all ``g`` query rows of the group use each row once it
is read. Only slots ``<= pos[b]`` are read, which is exact because the
TPU kernel gives the masked slots exp(-inf) = 0; each CTA walks its own
page-table entries (there is no scalar prefetch).

It keeps the TPU kernel's exact *global* softmax, not flash:
s = (bf16 q . bf16 k) * scale in f32; m = max, p = exp(s - m),
l = sum p; o = sum bf16(p / l) * bf16 v in f32, in two launches. The
first writes each tile's m_i = max s and l_i = sum exp(s - m_i); the
second, launched as a programmatic dependent launch, reads its K/V rows
and recomputes its tile's scores while the first runs, then takes
m = max_i m_i and l = sum_i exp(m_i - m) l_i, forms its tile's partial
sum of bf16(exp(s - m) / l) * bf16 v, and the last CTA of a (row, kv
head) to arrive (an integer counter) sums the partials in tile order.

Determinism contract: no floating-point atomics, and every reduction runs
in an order fixed by ``pos[b]`` alone, so the output for row b is
bit-identical whatever the batch size, the padding lanes and where the
pages sit in the pool.

``pages_per_step`` is the TPU kernel's DMA-group depth (a DSE axis). It
must divide the page-table width, as there; this kernel does not stage
pages in groups, so it does not change the work.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import scope
from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
MAX_GROUP = 16                 # query rows per kv head the kernel serves
TILE_SLOTS = 64                # slots per CTA (TS in the CUDA source)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _I, ctypes.c_float,
                                       _I, _P]}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def paged_attention_plain(q, pool_k, pool_v, pages, pos):
    """The kernel's function in plain PyTorch: the dense-gather attend of
    ``repro.engine.step._paged_attn_xla`` (gather every page of the row,
    mask slots past ``pos``, one global softmax). Same arguments and
    result as ``paged_attention``."""
    B, kv, g, hd = q.shape
    s_max = pages.shape[1] * pool_k.shape[1]
    idx = pages.long()
    kd = pool_k[idx].reshape(B, s_max, kv, hd)
    vd = pool_v[idx].reshape(B, s_max, kv, hd)
    s = torch.einsum("bkgh,bskh->bkgs", _bf16(q), _bf16(kd)) * (
        1.0 / math.sqrt(hd))
    mask = (torch.arange(s_max, device=q.device)[None, :]
            <= pos.long()[:, None])
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskh->bkgh", _bf16(p / l), _bf16(vd))


def _check(q, pool_k, pool_v, pages, pos, pages_per_step: int):
    if q.dim() != 4 or pool_k.dim() != 4 or pages.dim() != 2 or pos.dim() != 1:
        raise ValueError("want q (B, kv, g, hd), pools (P, page, kv, hd), "
                         "pages (B, n_pages), pos (B,)")
    B, kv, g, hd = q.shape
    if pool_k.shape != pool_v.shape or pool_k.shape[2:] != (kv, hd):
        raise ValueError(f"pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if pages.shape[0] != B or pos.shape[0] != B:
        raise ValueError("pages / pos batch does not match q")
    n_pages = pages.shape[1]
    if pages_per_step < 1 or n_pages % pages_per_step:
        raise ValueError(f"pages_per_step {pages_per_step} must divide "
                         f"page-table width {n_pages}")
    if len({t.device for t in (q, pool_k, pool_v, pages, pos)}) != 1:
        raise ValueError("inputs lie on different devices")


def paged_attention(q, pool_k, pool_v, pages, pos, *,
                    pages_per_step: int = 1):
    """Paged single-token GQA decode attention.

    q:       (B, kv_heads, q_per_kv, head_dim), cast to bf16 inside
    pool_k:  (num_pool_pages, page_size, kv_heads, head_dim) bf16
    pool_v:  same shape as pool_k
    pages:   (B, n_pages) int32 page-table rows into the pool
    pos:     (B,) int32 current position (slots > pos are masked)

    Returns (B, kv_heads, q_per_kv, head_dim) float32. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise. The
    kernel clamps page ids into the pool.
    """
    _check(q, pool_k, pool_v, pages, pos, pages_per_step)
    with scope.kernel_region(
            "paged_attention",
            lambda: paged_cost(q, pool_k, pool_v, pages, pos)):
        return _paged(q, pool_k, pool_v, pages, pos)


def paged_cost(q, pool_k, pool_v, pages, pos):
    """(FLOPs, bytes) of one call priced from the shapes alone, every
    slot of every row's pages visible (the most the data can ask; the
    TPU kernel is priced statically too): 4 kv g hd per visible slot;
    q (bf16) read once, each visible K/V row once, the page table and
    positions once, the f32 output written once."""
    B, kv, g, hd = q.shape
    slots = B * pages.shape[1] * pool_k.shape[1]
    nbytes = (2 * q.numel() + 2 * 2 * slots * kv * hd + 4 * pages.numel()
              + 4 * pos.numel() + 4 * q.numel())
    return 4.0 * kv * g * hd * slots, float(nbytes)


def _paged(q, pool_k, pool_v, pages, pos):
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, pages, pos)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    B, kv, g, hd = q.shape
    P, page_size = pool_k.shape[:2]
    n_pages = pages.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if g > MAX_GROUP:
        raise ValueError(f"{g} query rows per kv head > {MAX_GROUP}")
    for name, t, dt in (("pool_k", pool_k, torch.bfloat16),
                        ("pool_v", pool_v, torch.bfloat16),
                        ("pages", pages, torch.int32),
                        ("pos", pos, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (K rows are read "
                         "as 16-byte vectors)")
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:          # q rows are read as 16-byte vectors
        qb = qb.clone()
    s_max = n_pages * page_size
    nt = -(-s_max // TILE_SLOTS)
    # partial outputs, tile maxima and sums, arrival counters
    scratch = torch.empty(B * kv * (g * (nt * hd + 2 * nt) + 1),
                          dtype=torch.float32, device=q.device)
    out = torch.empty((B, kv, g, hd), dtype=torch.float32, device=q.device)
    lib = _build.load("paged_attention", _SIGNATURES)
    code = lib.paged_attention_fwd(
        qb.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pages.data_ptr(),
        pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, kv, g, hd, page_size, n_pages, P, 1.0 / math.sqrt(hd),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_attention_fwd")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
