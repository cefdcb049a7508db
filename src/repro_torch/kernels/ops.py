"""The kernels as the model calls them: tuned defaults resolved.

Port of ``repro.kernels.ops``. Each wrapper here takes the kernel's
tunable axes as ``None`` by default and resolves them in one order:
explicit argument > tuned value (``kernels.tuning``, filled by
``python -m repro_torch.tune`` or ``--autotune``) > static default. So a
tuning run transparently re-tiles the model's kernels, at the shapes it
tuned: a call takes the value tuned at its own input shapes, else one
installed for any shape, else the static default. The JAX package
fits a tuned Pallas block to a shape it was not tuned at (the gcd with
the axis); the port's kernels take any length at any tile (the ragged
edge is masked), so a tuned tile only needs to exist for the head dim:
one the card cannot hold (kv blocks of 128 keys at head dim 128) falls
back to the static default. Explicit arguments pass through untouched,
so an invalid one still fails loudly in the kernel.

On the CPU the kernels' plain versions run (see each kernel module), as
the JAX wrappers run Pallas in interpret mode off the TPU.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.costmodel import DeviceBudget
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tuning


def flash_tiles(D: int, block_q: Optional[int] = None,
                block_k: Optional[int] = None, args=None):
    """(block_q, block_k) for head dim ``D`` by the resolution order, for
    a call on ``args`` (q, k, v)."""
    if block_q is not None and block_k is not None:
        return block_q, block_k
    cfg = tuning.tuned("flash_attention", args)
    bq = block_q if block_q is not None else cfg.get("block_q", _fa.BLOCK_Q)
    bk = block_k if block_k is not None else cfg.get("block_k", _fa.BLOCK_K)
    if bq not in _fa.BLOCKS_Q or bk not in _fa.BLOCKS_K or \
            DeviceBudget().violations(_fa.flash_resources(D, bq, bk)):
        # a tuned tile this head dim cannot take: the static default for
        # each axis the caller left open
        bq = _fa.BLOCK_Q if block_q is None else block_q
        bk = _fa.BLOCK_K if block_k is None else block_k
    return bq, bk


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    with_probe: bool = False, with_stats: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """``kernels.flash_attention.flash_attention`` at the resolved tiles."""
    bq, bk = flash_tiles(q.shape[-1], block_q, block_k, (q, k, v))
    return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               with_probe=with_probe, with_stats=with_stats,
                               block_q=bq, block_k=bk)


def paged_attention(q, pool_k, pool_v, pages, pos, *,
                    pages_per_step: int = 1, pos_host=None,
                    tile_slots: Optional[int] = None):
    """``kernels.paged_attention.paged_attention`` at the resolved
    ``tile_slots``. ``pages_per_step`` passes through: it changes no work
    in the port, so no search space tunes it."""
    if tile_slots is None:
        tile_slots = tuning.tuned_value("paged_attention", "tile_slots",
                                        _pa.TILE_SLOTS,
                                        (q, pool_k, pool_v, pages, pos))
        if tile_slots not in _pa.TILES:
            tile_slots = _pa.TILE_SLOTS
    return _pa.paged_attention(q, pool_k, pool_v, pages, pos,
                               pages_per_step=pages_per_step,
                               pos_host=pos_host, tile_slots=tile_slots)


def resolve_ssd_chunk(L: int, default: int = 256, args=None) -> int:
    """Tuned-registry resolution for ``ssd_scan``'s chunk for a call on
    ``args`` (x, a, b, c), clamped to the sequence: the one place the
    'explicit > tuned > default' policy lives for it. The model pads the
    sequence to a multiple of the result."""
    return min(tuning.tuned_value("ssd_scan", "chunk", default, args), L)


def ssd_scan(x, a, b, c, *, chunk: Optional[int] = None, h_per_g: int,
             pipeline: int = 1, return_final_state: bool = False):
    """``kernels.ssd_scan.ssd_scan`` at the resolved chunk: a tuned chunk
    that does not divide ``L`` falls back to the gcd with it.
    ``pipeline`` passes through: it changes no work in the port."""
    L = x.shape[1]
    if chunk is None:
        chunk = resolve_ssd_chunk(L, args=(x, a, b, c))
        if L % chunk:
            chunk = math.gcd(L, chunk)
    return _ssd.ssd_scan(x, a, b, c, chunk=chunk, h_per_g=h_per_g,
                         pipeline=pipeline,
                         return_final_state=return_final_state)
