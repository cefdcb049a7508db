"""Causal GQA flash-attention forward: a CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``,
function ``flash_attention`` (body ``_flash_kernel``). The CUDA source is
``src/repro_torch/csrc/flash_attention.cu``.

What bounds it on an H100: at the serving shapes (S = 512, D = 64, 32 q
heads over 4 kv heads) the work is about 1.07 GFLOP against about
4.7 MB moved, some 230 operations per byte, just under the ~295 where
the bf16 tensor cores take over: memory bounds it (about 1.4 us) and
the tensor cores nearly do (about 1.1 us). What the design does about
it: both products run on the tensor cores (``mma.sync`` m16n8k16, bf16
operands fed by ``ldmatrix``, f32 accumulators); a 64-row q tile has two
groups of four warps of 16 q rows, one on the even kv blocks and one on
the odd, merged at the end in a fixed order, which halves the longest
chain of blocks (the causal tail); p stays in registers between the two
products (the score accumulator, rounded to bf16, is the A operand of
PV); each group double-buffers its K/V blocks in shared memory by
``cp.async``, so its next block loads while one computes; every kv block
past the tile's last causal row is skipped, and the heaviest tiles
launch first. At the serving shape it is latency-bound, not bound by
bytes or operations: each block is a chain of dependent tensor-core
products, shuffles and exponentials.

Differences from the TPU kernel, all deliberate:

- q and kv lengths are separate and q row ``i`` sits at absolute
  position ``q_offset + i`` (Sq <= Skv): chunked prefill runs one
  chunk's rows against the whole context. The TPU kernel takes one
  square S.
- The kv walk is fixed: blocks of ``block_k`` keys from key 0, up to the
  block of the tile's last row. A block that is fully masked for a row
  is an exact no-op for it (p = 0, corr = 1), so every row's result
  depends only on that row and its visible keys, whatever Sq, q_offset
  or q tile it falls in. Chunked prefill therefore reproduces the
  whole-prompt rows bit for bit.
- q and k are rounded to bf16 for the scores and p is rounded to bf16
  before the PV product, as the XLA flash path (``_flash_row``) does;
  the TPU kernel multiplies in f32.

Tiles (the TPU kernel's ``block_q`` / ``block_k``, a DSE axis): q tiles
of ``block_q`` in ``BLOCKS_Q`` rows and kv blocks of ``block_k`` in
``BLOCKS_K`` keys, each (head dim, block_q, block_k) an instantiation of
``csrc/flash_attention.cuh``, at head dims 64, 80 (zamba2's shared
attention: 10 16-byte vectors a row, so a tile's copy has a guarded last
pass; rows of 176 bytes keep ``ldmatrix`` free of bank conflicts) and
128. 64 / 64 (``BLOCK_Q`` / ``BLOCK_K``) is the default and the launch
of every untuned call; the others are built by their own translation
units (``LIBRARIES``). A 128-row q tile runs 512
threads, one CTA an SM. ``flash_resources`` states what a tile needs of
the card (the source's shared-memory formula); at head dim 128, kv blocks
of 128 keys need more shared memory than a block may have and are not
built. The plain version walks the same kv blocks, so a tile's output is
held against the plain version at that tile: the kv block size changes
the online softmax's order of sums, the q tile only the grid (each row's
bits depend on its row and the kv blocks alone).

The probe output counts, per (b, h, q tile), kv blocks visited and
computed, with the TPU kernel's block-plan semantics (the causal skip is
decided by the tile's last row). It is also the kernel's counter block
for grid-step probing (``flash_plan``): a probed region asks for it and
folds it into the probe state; an unprobed call's launch is unchanged.

The statistics output (``with_stats``, for the training backward,
``models.attention``) is each row's softmax maximum m and sum l in f32,
(B, H, Sq) each, in the convention of the XLA path's ``_flash_row``: m
in natural units (-inf for a row that saw no key), l = sum exp(s - m),
at least 1e-37. The kernel writes them after its two warp groups merge;
without them the launch is the serving launch, unchanged.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import costmodel as cm
from repro_torch.core import kernelprobe as kp
from repro_torch.core import scope
from repro_torch.kernels import _build

BLOCK_Q = 64                   # the default tiles
BLOCK_K = 64
BLOCKS_Q = (64, 128)
BLOCKS_K = (32, 64, 128)
HEAD_DIMS = (64, 80, 128)
# the translation unit (csrc/<name>.cu) that builds each 64-row or 128-row
# q tile's instantiations; the default tiles have one of their own
LIBRARIES = {(64, 64): "flash_attention", 64: "flash_attention_q64",
             128: "flash_attention_q128"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _I, _I,
                                       ctypes.c_float, _I, _P],
               "flash_attention_attrs": [_I, _I, _I, _I, _P]}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bf16(x):
    """Round to bf16 and compute on in f32: a bf16-input, f32-accumulate
    product, as ``einsum(..., preferred_element_type=f32)`` in JAX."""
    return x.to(torch.bfloat16).float()


def _row_plan(Sq: int, Skv: int, q_offset: int, causal: bool,
              block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K) -> List[Tuple[int, int, int]]:
    """The kernel's block plan: (first row, end row, kv blocks computed)
    for each q tile. The causal skip is decided by the tile's last row."""
    nk = _cdiv(Skv, block_k)
    rows = []
    for r0 in range(0, Sq, block_q):
        r1 = min(r0 + block_q, Sq)
        n = min(nk, (q_offset + r1 - 1) // block_k + 1) if causal else nk
        rows.append((r0, r1, n))
    return rows


def flash_smem_bytes(D: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` of the source):
    the q tile and each warp group's two K and two V blocks, rows padded
    to D + 8 bf16."""
    return (block_q + 2 * 4 * block_k) * (D + 8) * 2


def flash_min_blocks(D: int, block_q: int, block_k: int) -> int:
    """The CTAs an SM the tile is compiled for (``MinBlocks`` of the
    source's ``__launch_bounds__``): 2 at head dim 64 with 64-row q tiles
    and kv blocks of at most 64 keys, else 1."""
    return 2 if (D == 64 and block_q == 64 and block_k <= 64) else 1


def flash_resources(D: int, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                    shapes=None, itemsize: int = 2):
    """What one CTA of these tiles needs of the card
    (``costmodel.KernelResources``): the source's shared memory, its
    threads (a warp per 16 q rows in each of two groups), and the
    registers ``__launch_bounds__`` lets it take (255 a thread at most,
    or the SM's 65,536 over the CTAs it asks to fit). With ``shapes`` ((q
    shape, kv shape, q_offset, causal)) the call's bytes (``itemsize``
    bytes an element, as ``flash_cost`` counts them), FLOPs, grid steps
    and flat cycles are filled in too."""
    threads = 2 * block_q // 16 * 32
    regs = threads * min(255, 65536 // (threads * flash_min_blocks(
        D, block_q, block_k)))
    hbm = flops = steps = cycles = 0
    if shapes is not None:
        qs, kvs, q_offset, causal = shapes
        B, H, Sq, _ = qs
        Skv = kvs[2]
        pairs = (Sq * q_offset + Sq * (Sq + 1) // 2) if causal else Sq * Skv
        flops = 4 * B * H * D * pairs
        hbm = itemsize * (2 * B * H * Sq * D + 2 * B * kvs[1] * Skv * D)
        steps = B * H * _cdiv(Sq, block_q) * _cdiv(Skv, block_k)
        cycles = cm.kernel_cost(flops, hbm).cycles
    return cm.KernelResources(
        smem_bytes=flash_smem_bytes(D, block_q, block_k), threads=threads,
        registers=regs, hbm_bytes=hbm, flops=flops, grid_steps=steps,
        static_cycles=cycles)


def flash_library(block_q: int, block_k: int) -> str:
    """The ``csrc/`` translation unit that builds these tiles."""
    if block_q not in BLOCKS_Q or block_k not in BLOCKS_K:
        raise ValueError(f"tiles ({block_q}, {block_k}) not in {BLOCKS_Q} x "
                         f"{BLOCKS_K}")
    return LIBRARIES.get((block_q, block_k), LIBRARIES[block_q])


def flash_attrs(D: int, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                device=None) -> dict:
    """The instantiation's attributes as CUDA reports them
    (``cudaFuncGetAttributes`` after the shared-memory opt-in): static and
    dynamic shared bytes, registers and local (spill) bytes a thread, the
    most threads a block may have, and the CTAs an SM holds at the
    launch's threads and shared memory (the driver's occupancy, which
    ``flash_min_blocks`` says it must reach)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    out = (ctypes.c_int * 6)()
    lib = _build.load(flash_library(block_q, block_k), _SIGNATURES)
    code = lib.flash_attention_attrs(D, block_q, block_k, dev.index,
                                     ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, code, "flash_attention_attrs")
    return dict(static_smem=out[0], dynamic_smem=out[1], registers=out[2],
                local_bytes=out[3], max_threads=out[4], ctas_per_sm=out[5])


def _flash_row(q_blk, k_ctx, v_ctx, q_offset: int, kv_chunk: int,
               scale: float, causal: bool, kv_len: int):
    """One q tile against its kv context, in whole ``kv_chunk`` blocks.

    Port of ``repro.models.attention._flash_row``; keys at or past
    ``kv_len`` are padding and masked. q_blk: (B, Sq, H, hd); k_ctx,
    v_ctx: (B, Skv, H, hd), Skv % kv_chunk == 0. Returns (out
    (B,Sq,H,hd) f32, m (B,H,Sq), l (B,H,Sq))."""
    B, Sq, H, HD = q_blk.shape
    dev = q_blk.device
    qb = _bf16(q_blk)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, H, Sq), device=dev)
    acc = torch.zeros((B, H, Sq, HD), device=dev)
    for c0 in range(0, k_ctx.shape[1], kv_chunk):
        k_c = _bf16(k_ctx[:, c0:c0 + kv_chunk])
        v_c = _bf16(v_ctx[:, c0:c0 + kv_chunk])
        s = torch.einsum("bqhd,bkhd->bhqk", qb, k_c) * scale
        k_pos = c0 + torch.arange(kv_chunk, device=dev)
        mask = (k_pos < kv_len)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     float("-inf")))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", _bf16(p), v_c)
        acc = acc * corr[..., None] + pv
        m = m_new
    l_safe = l.clamp_min(1e-37)
    return (acc / l_safe[..., None]).transpose(1, 2), m, l_safe


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          with_probe: bool = False, with_stats: bool = False,
                          block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """The kernel's function in plain PyTorch (port of ``_flash_fwd`` over
    the kernel's row plan at these tiles). Same arguments and results as
    ``flash_attention``; kv is repeated per q head as ``_repeat_kv``
    does."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    pad = _cdiv(Skv, block_k) * block_k - Skv
    # (B, S, H, D) with kv repeated to every q head, zero-padded to whole
    # kv blocks (the padding is masked)
    kr = F.pad(k.repeat_interleave(rep, dim=1), (0, 0, 0, pad)).transpose(1, 2)
    vr = F.pad(v.repeat_interleave(rep, dim=1), (0, 0, 0, pad)).transpose(1, 2)
    qt = q.transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    plan = _row_plan(Sq, Skv, q_offset, causal, block_q, block_k)
    outs, ms, ls = [], [], []
    for (r0, r1, n) in plan:
        o, m, l = _flash_row(qt[:, r0:r1], kr[:, :n * block_k],
                             vr[:, :n * block_k], q_offset + r0, block_k,
                             scale, causal, Skv)
        outs.append(o.to(q.dtype))
        ms.append(m)
        ls.append(l)
    # the kernel's layout: callers then run the same operations after it
    res = [torch.cat(outs, dim=1).transpose(1, 2).contiguous()]
    if with_probe:
        nk = _cdiv(Skv, block_k)
        counts = torch.tensor([[nk, n] for (_, _, n) in plan],
                              dtype=torch.int32, device=q.device)
        res.append(counts.expand(B, H, len(plan), 2).contiguous())
    if with_stats:
        res += [torch.cat(ms, dim=2), torch.cat(ls, dim=2)]
    return res[0] if len(res) == 1 else tuple(res)


def _check(q, k, v, q_offset: int, causal: bool):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H {H} is not a multiple of Hkv {Hkv}")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty sequence")
    if causal and not (0 <= q_offset and q_offset + Sq <= Skv):
        raise ValueError(f"q rows [{q_offset}, {q_offset + Sq}) lie outside "
                         f"the {Skv} keys")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    with_probe: bool = False, with_stats: bool = False,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """Causal GQA flash attention.

    q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D), H % Hkv == 0, kv head
    ``h // (H // Hkv)``; q row ``i`` sits at position ``q_offset + i``.
    Returns (B, H, Sq, D) in q.dtype [, probe (B, H, ceil(Sq/block_q), 2)
    int32 if with_probe] [, m, l (B, H, Sq) f32 if with_stats (see the
    module docstring)]; a tuple when more than the output is asked for.
    ``block_q`` / ``block_k``: the tiles (see the module docstring;
    ``kernels.ops.flash_attention`` resolves tuned ones).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, D in ``HEAD_DIMS``, contiguous) or raise; ``meta`` tensors (a
    dry run, ``launch.dryrun``) get the kernel's outputs, empty, and
    launch nothing. Whatever the route, the region states one cost.
    """
    _check(q, k, v, q_offset, causal)
    flash_library(block_q, block_k)
    with scope.kernel_region(
            "flash_attention",
            lambda: flash_cost(q, k, v, q_offset, causal, with_stats),
            lambda: flash_plan(q, k, v, q_offset, causal, block_q,
                               block_k)) as region:
        res = _flash(q, k, v, causal, q_offset, with_probe or region.probed,
                     with_stats, block_q, block_k)
        if not region.probed:
            return res
        parts = list(res)
        region.fold(parts[1])
        if not with_probe:
            del parts[1]
        return parts[0] if len(parts) == 1 else tuple(parts)


def flash_plan(q, k, v, q_offset: int = 0, causal: bool = True,
               block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """The TPU kernel's grid at the port's tiles, for grid-step probing
    (``core.kernelprobe``): (B, H, ceil(Sq/block_q), ceil(Skv/block_k)),
    the kv axis sequential, as ``_flash_kernel`` at these ``block_q`` /
    ``block_k`` and ``pipeline = 1``. Per step: the q, k, v and output tiles move at
    the grid node; ``init`` zeroes the accumulators at the first kv
    block; ``kv_block`` computes while the kv block is below the row's
    computed count (column 1 of the probe counts: the causal skip by the
    tile's last row, past ``q_offset``); ``finalize`` writes the tile at
    the last computed block. A step whose branch is not taken costs its
    predicate, one cycle."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    es = q.element_size()
    nq, nk = _cdiv(Sq, block_q), _cdiv(Skv, block_k)
    bq, bk = block_q, block_k
    skip = cm.roofline_cycles(1, 0)
    init = cm.roofline_cycles(bq * D + 2 * bq, 4 * (bq * D + 2 * bq))
    block = cm.roofline_cycles(
        4 * bq * bk * D + 14 * bq * bk,
        es * (bq * D + 2 * bk * D) + 4 * (2 * bq * D + 4 * bq))
    final = cm.roofline_cycles(bq * D, 4 * (bq * D + bq) + es * bq * D)

    def expected():
        rows = _row_plan(Sq, Skv, q_offset, causal, block_q, block_k)
        counts = np.array([[nk, n] for (_, _, n) in rows], np.int32)
        return np.broadcast_to(counts, (B, H, nq, 2)).copy()

    return kp.GridPlan(
        body="flash_kernel", grid=(B, H, nq, nk),
        transfer=cm.transfer_cycles(es * 2 * (bq + bk) * D),
        scopes=(kp.GridScope("init", kp.FIRST, (skip, init), ops=3),
                kp.GridScope("kv_block", kp.BELOW, (skip, block), ops=9),
                kp.GridScope("finalize", kp.AT_END, (skip, final), ops=3)),
        counter_shape=(B, H, nq, 2), expected=expected, mirror=expected)


def flash_cost(q, k, v, q_offset: int = 0, causal: bool = True,
               with_stats: bool = False):
    """(FLOPs, bytes) of one call, as its bound counts them: 4 B H D per
    visible (q, k) pair; q, k, v read once, the output (and the f32
    statistics, if asked for) written once."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if causal:       # row i sees keys 0 .. q_offset + i (< Skv)
        pairs = Sq * q_offset + Sq * (Sq + 1) // 2
    else:
        pairs = Sq * Skv
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    if with_stats:
        nbytes += 2 * 4 * B * H * Sq
    return 4.0 * B * H * D * pairs, float(nbytes)


def _flash(q, k, v, causal: bool, q_offset: int, with_probe: bool,
           with_stats: bool, block_q: int, block_k: int):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, with_probe=with_probe,
                                     with_stats=with_stats, block_q=block_q,
                                     block_k=block_k)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash-attention kernel for {q.device}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q.device.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.dtype != torch.bfloat16:
                raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous and 16-byte "
                                 f"aligned")
        if D not in HEAD_DIMS:
            raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
        smem = flash_smem_bytes(D, block_q, block_k)
        if smem > _build.SMEM_OPTIN_BYTES:
            raise ValueError(f"tiles ({block_q}, {block_k}) at head dim {D} "
                             f"need {smem} bytes of shared memory, over the "
                             f"{_build.SMEM_OPTIN_BYTES} a block may have")
    out = torch.empty_like(q)
    probe = (torch.empty((B, H, _cdiv(Sq, block_q), 2), dtype=torch.int32,
                         device=q.device) if with_probe else None)
    stats = (torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
             if with_stats else None)
    if q.device.type == "cuda":     # meta: the outputs, nothing launched
        lib = _build.load(flash_library(block_q, block_k), _SIGNATURES)
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            probe.data_ptr() if with_probe else None,
            stats.data_ptr() if with_stats else None,
            B, H, Hkv, Sq, Skv, D, block_q, block_k, q_offset, int(causal),
            1.0 / math.sqrt(D), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, code, "flash_attention_fwd")
        flash_attention.launches += 1
        flash_attention.tile_launches[(block_q, block_k)] += 1
    res = [out]
    if with_probe:
        res.append(probe)
    if with_stats:
        res += [stats[0], stats[1]]
    return res[0] if len(res) == 1 else tuple(res)


flash_attention.launches = 0
# the same launches by tiles (block_q, block_k)
flash_attention.tile_launches = collections.Counter()
