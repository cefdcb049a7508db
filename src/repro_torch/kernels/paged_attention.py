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
pages in groups, so it does not change the work. ``tile_slots`` (in
``TILES``; default ``TILE_SLOTS`` = 64) is this kernel's own tile, the
axis that does change it: slots a CTA, so the CTAs a row and the length
of each CTA's chain of loads (each (head dim, g <= 8 or 16, tile) an
instantiation of ``csrc/paged_attention.cuh``; 64 has its translation
unit, the others ``paged_attention_tiles.cu``). The tile changes the
order of the output's sum over tiles, so a tile's bits are its own; the
plain version's global softmax does not depend on it.
``paged_resources`` states a tile's shared memory by the source's
layout.

Counter block (grid-step probing, ``paged_plan``): asked for by a probed
region, launch 2 writes the slots each CTA reads, int32 (B, kv, tiles)
(0 for a tile past ``pos``). Without it the launches are the unprobed
ones.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import kernelprobe as kp
from repro_torch.core import scope
from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
MAX_GROUP = 16                 # query rows per kv head the kernel serves
TILE_SLOTS = 64                # the default slots per CTA (TS in the source)
TILES = (32, 64, 128)
LIBRARIES = {64: "paged_attention", 32: "paged_attention_tiles",
             128: "paged_attention_tiles"}
WARPS = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _I,
                                       ctypes.c_float, _I, _P],
               "paged_attention_attrs": [_I, _I, _I, _I, _P]}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def slot_counts(pos, n_pages: int, page_size: int, kv: int,
                tile_slots: int = TILE_SLOTS) -> np.ndarray:
    """The counter block the kernel writes for these positions (host
    ints or an array): slots read per (row, kv head, tile), the row's
    slots 0 .. pos taken in tiles of ``tile_slots``."""
    s_max = n_pages * page_size
    nt = -(-s_max // tile_slots)
    n = np.clip(np.asarray(pos, np.int64) + 1, 0, s_max)
    c = np.clip(n[:, None] - tile_slots * np.arange(nt), 0, tile_slots)
    return np.broadcast_to(c[:, None, :], (len(n), kv, nt)).astype(np.int32)


def _group(g: int) -> int:
    """The instantiation's query rows per kv head: 8 or 16."""
    return 8 if g <= 8 else MAX_GROUP


def paged_resources(hd: int, g: int, tile_slots: int = TILE_SLOTS,
                    shapes=None):
    """What one CTA of this tile needs of the card
    (``costmodel.KernelResources``): the larger of the two launches'
    static shared memory (``paged_smem_bytes``; at head dim 128, 16 rows
    a kv head and 128-slot tiles it is over the 48 KB a block may have
    statically, and that instantiation is not built), 128 threads, and the
    registers ``__launch_bounds__(128)`` lets it take. With ``shapes``
    ((q shape, pool shape, page-table shape)) the call's bytes, FLOPs,
    grid steps and flat cycles are filled in too."""
    threads = WARPS * 32
    hbm = flops = steps = cycles = 0
    if shapes is not None:
        qs, ps, pgs = shapes
        B, kv, gq, _ = qs
        slots = B * pgs[1] * ps[1]
        flops = 4 * kv * gq * hd * slots
        hbm = (2 * B * kv * gq * hd + 2 * 2 * slots * kv * hd
               + 4 * B * pgs[1] + 4 * B + 4 * B * kv * gq * hd)
        steps = B * kv * -(-pgs[1] * ps[1] // tile_slots)
        cycles = cm.kernel_cost(flops, hbm).cycles
    return cm.KernelResources(
        static_smem_bytes=max(paged_smem_bytes(hd, g, tile_slots)),
        threads=threads, registers=threads * 255, hbm_bytes=hbm,
        flops=flops, grid_steps=steps, static_cycles=cycles)


def paged_smem_bytes(hd: int, g: int, tile_slots: int = TILE_SLOTS):
    """Static shared memory of the (statistics, output) launches: the
    C layouts of ``StatsSmem`` (scores, pool rows) and ``OutputSmem``
    (scores, the row's max and sum, the weights, each warp's partial
    output, pool rows and a flag, aligned to 16 bytes) at the
    instantiation's group of 8 or 16 rows."""
    G, TS = _group(g), tile_slots
    stats = 4 * G * TS + 4 * TS
    out = 4 * G * TS + 2 * 4 * G + 4 * TS * G + 4 * WARPS * G * hd \
        + 4 * TS + 1
    return stats, -(-out // 16) * 16


def paged_library(tile_slots: int) -> str:
    """The ``csrc/`` translation unit that builds this tile."""
    if tile_slots not in TILES:
        raise ValueError(f"tile_slots {tile_slots} not in {TILES}")
    return LIBRARIES[tile_slots]


def paged_attrs(hd: int, g: int, tile_slots: int = TILE_SLOTS,
                device=None) -> dict:
    """The two launches' attributes as CUDA reports them
    (``cudaFuncGetAttributes``): static shared bytes, registers and local
    (spill) bytes a thread, of the statistics and the output kernel."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    out = (ctypes.c_int * 6)()
    lib = _build.load(paged_library(tile_slots), _SIGNATURES)
    code = lib.paged_attention_attrs(hd, g, tile_slots, dev.index,
                                     ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, code, "paged_attention_attrs")
    return dict(stats_smem=out[0], stats_registers=out[1],
                stats_local_bytes=out[2], output_smem=out[3],
                output_registers=out[4], output_local_bytes=out[5])


def paged_attention_plain(q, pool_k, pool_v, pages, pos,
                          with_counts: bool = False,
                          tile_slots: int = TILE_SLOTS):
    """The kernel's function in plain PyTorch: the dense-gather attend of
    ``repro.engine.step._paged_attn_xla`` (gather every page of the row,
    mask slots past ``pos``, one global softmax). Same arguments and
    result as ``paged_attention``; ``with_counts`` also returns the
    counter block the kernel writes at ``tile_slots``."""
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
    out = torch.einsum("bkgs,bskh->bkgh", _bf16(p / l), _bf16(vd))
    if not with_counts:
        return out
    nt = -(-s_max // tile_slots)
    n = (pos.long() + 1).clamp(0, s_max)
    c = (n[:, None] - tile_slots * torch.arange(nt, device=q.device)).clamp(
        0, tile_slots)
    return out, c[:, None, :].expand(B, kv, nt).to(torch.int32).contiguous()


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
                    pages_per_step: int = 1,
                    pos_host: Optional[Sequence[int]] = None,
                    tile_slots: int = TILE_SLOTS):
    """Paged single-token GQA decode attention.

    q:       (B, kv_heads, q_per_kv, head_dim), cast to bf16 inside
    pool_k:  (num_pool_pages, page_size, kv_heads, head_dim) bf16
    pool_v:  same shape as pool_k
    pages:   (B, n_pages) int32 page-table rows into the pool
    pos:     (B,) int32 current position (slots > pos are masked)

    ``pos_host``: the same positions as host ints. A run that probes
    ``paged_kernel``'s grid steps needs them (it prices the steps from
    them, never reading ``pos`` from the device) and raises without.

    ``tile_slots``: the kernel's tile (see the module docstring;
    ``kernels.ops.paged_attention`` resolves a tuned one).

    Returns (B, kv_heads, q_per_kv, head_dim) float32. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise; ``meta``
    tensors (a dry run) get the kernel's outputs, empty, and launch
    nothing. The kernel clamps page ids into the pool.
    """
    _check(q, pool_k, pool_v, pages, pos, pages_per_step)
    paged_library(tile_slots)
    with scope.kernel_region(
            "paged_attention",
            lambda: paged_cost(q, pool_k, pool_v, pages, pos),
            lambda: paged_plan(q, pool_k, pages, pos, pages_per_step,
                               pos_host, tile_slots)) as region:
        res = _paged(q, pool_k, pool_v, pages, pos, region.probed,
                     tile_slots)
        if not region.probed:
            return res
        region.fold(res[1])
        return res[0]


def paged_plan(q, pool_k, pages, pos, pages_per_step: int = 1,
               pos_host: Optional[Sequence[int]] = None,
               tile_slots: int = TILE_SLOTS):
    """The TPU kernel's grid for grid-step probing (``core.kernelprobe``):
    (B, n_pages / pages_per_step), the page axis sequential, as
    ``_paged_kernel``. Per step: the q and output blocks move at the grid
    node; ``copy_pages`` moves the K and V rows of the step's slots that
    this kernel reads (slots ``<= pos``, from the counter block: data,
    where the TPU kernel copies every page); ``attend`` runs the dense
    softmax over the row's slots at the last step."""
    B, kv, g, hd = q.shape
    page_size, n_pages = pool_k.shape[1], pages.shape[1]
    es = pool_k.element_size()
    s_max = n_pages * page_size
    nt, sps = -(-s_max // tile_slots), pages_per_step * page_size
    skip = cm.roofline_cycles(1, 0)
    copy = tuple(cm.roofline_cycles(0, 2 * es * hd * v)
                 for v in range(kv * sps + 1))
    attend = cm.roofline_cycles(
        4 * kv * g * hd * s_max + 14 * kv * g * s_max,
        2 * es * s_max * kv * hd + 2 * 4 * kv * g * hd)

    def expected():
        return slot_counts(pos.tolist(), n_pages, page_size, kv, tile_slots)

    def mirror():
        if pos_host is None or len(pos_host) != B:
            raise ValueError(f"a probed paged_attention needs pos_host, "
                             f"the {B} positions as host ints: the run "
                             f"prices the grid steps without reading pos "
                             f"from the device")
        return slot_counts(pos_host, n_pages, page_size, kv, tile_slots)

    return kp.GridPlan(
        body="paged_kernel", grid=(B, n_pages // pages_per_step),
        transfer=cm.transfer_cycles(kv * g * hd * (q.element_size() + 4)
                                    + 4 * pages_per_step),
        scopes=(kp.GridScope("copy_pages", kp.SLOTS, copy,
                             ops=2 * pages_per_step),
                kp.GridScope("attend", kp.LAST, (skip, attend), ops=6)),
        counter_shape=(B, kv, nt), expected=expected, mirror=mirror,
        geom=(kv, nt, tile_slots, sps))


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


def _paged(q, pool_k, pool_v, pages, pos, with_counts: bool = False,
           tile_slots: int = TILE_SLOTS):
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, pages, pos,
                                     with_counts, tile_slots)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no paged-attention kernel for {q.device}")
    B, kv, g, hd = q.shape
    P, page_size = pool_k.shape[:2]
    n_pages = pages.shape[1]
    if q.device.type == "cuda":
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
        smem = max(paged_smem_bytes(hd, g, tile_slots))
        if smem > cm.STATIC_SMEM_BYTES:
            raise ValueError(f"tile_slots {tile_slots} at head dim {hd} and "
                             f"{g} query rows a kv head needs {smem} bytes of "
                             f"static shared memory, over the "
                             f"{cm.STATIC_SMEM_BYTES} a block may have")
    qb = q.to(torch.bfloat16).contiguous()
    if q.device.type == "cuda" and qb.data_ptr() % 16:   # 16-byte rows
        qb = qb.clone()
    s_max = n_pages * page_size
    nt = -(-s_max // tile_slots)
    # partial outputs, tile maxima and sums, arrival counters
    scratch = torch.empty(B * kv * (g * (nt * hd + 2 * nt) + 1),
                          dtype=torch.float32, device=q.device)
    out = torch.empty((B, kv, g, hd), dtype=torch.float32, device=q.device)
    counts = (torch.empty((B, kv, nt), dtype=torch.int32, device=q.device)
              if with_counts else None)
    if q.device.type == "meta":     # a dry run: the outputs, no launch
        return (out, counts) if with_counts else out
    lib = _build.load(paged_library(tile_slots), _SIGNATURES)
    code = lib.paged_attention_fwd(
        qb.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pages.data_ptr(),
        pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        counts.data_ptr() if with_counts else None,
        B, kv, g, hd, page_size, n_pages, P, tile_slots, 1.0 / math.sqrt(hd),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_attention_fwd")
    paged_attention.launches += 1
    paged_attention.tile_launches[tile_slots] += 1
    return (out, counts) if with_counts else out


paged_attention.launches = 0
# the same launches by tile_slots
paged_attention.tile_launches = collections.Counter()
