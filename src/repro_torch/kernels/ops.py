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

Under a mesh (``distributed.sharding``) the inputs are DTensors, and
DTensor has no sharding strategy for a custom op. ``local_call`` runs a
kernel per rank through ``local_map``: each rank hands the kernel its
own batch rows and heads, the same wrapper on the card and on the CPU.
A grouped input (GQA's kv heads, the SSD's B/C groups) follows the heads
that read it: sharded with them where its head count divides, else
replicated, with each rank passing its kernel the groups its heads read
(global head ``h`` reads group ``h // ratio``). Where neither divides,
the heads are replicated, as XLA does around a custom call it cannot
partition; every other dimension (sequence, head dim) is made whole.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core.costmodel import DeviceBudget
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tuning


Dims = Tuple[Optional[int], Optional[int], bool]   # batch, head, grouped


def local_call(fn: Callable, args: Sequence, dims: Sequence[Dims],
               out_dims: Sequence[Tuple[Optional[int], Optional[int]]], *,
               ratio: int = 1):
    """``fn(*args)`` per rank when an argument is a DTensor (else as is).

    ``dims[i]`` = (batch dim, head dim, grouped) of ``args[i]`` (None:
    none); a grouped input's head ``j`` is read by heads ``j * ratio ..
    (j + 1) * ratio - 1``. ``out_dims`` = (batch dim, head dim) of each
    output of ``fn``, its heads indexed as ``args[0]``'s. A grouped input
    replicated beside sharded heads gets a partial gradient (summed over
    the heads' ranks)."""
    from repro_torch.distributed import sharding as shd
    mesh = next((a.device_mesh for a in args if shd.is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    args = [shd.as_dtensor(a, mesh) for a in args]
    lead = args[0]
    bdim0, hdim0, _ = dims[0]
    H = lead.shape[hdim0] if hdim0 is not None else 0
    n_in = len(args)
    in_pl = [[Replicate()] * mesh.ndim for _ in range(n_in)]
    grad_pl = [[Replicate()] * mesh.ndim for _ in range(n_in)]
    out_pl = [[Replicate()] * mesh.ndim for _ in out_dims]
    select = None                      # (mesh dim, local heads): groups cut
    head_mesh_dim = None
    for j, pl in enumerate(lead.placements):
        g = mesh.size(j)
        if g == 1 or not pl.is_shard():
            continue
        if pl.dim == bdim0 and lead.shape[bdim0] % g == 0:
            for i, (b, _, _) in enumerate(dims):
                if b is not None:
                    in_pl[i][j] = grad_pl[i][j] = Shard(b)
            for o, (b, _) in enumerate(out_dims):
                if b is not None:
                    out_pl[o][j] = Shard(b)
        elif pl.dim == hdim0 and head_mesh_dim is None and H % g == 0:
            n = H // g
            groups_whole = [a.shape[h] % g == 0 and n % ratio == 0
                            for a, (_, h, grp) in zip(args, dims) if grp]
            if not all(groups_whole) and ratio % n:
                continue                       # not a whole head group
            head_mesh_dim = j
            for i, (_, h, grp) in enumerate(dims):
                if h is None:
                    continue
                if grp and not all(groups_whole):
                    grad_pl[i][j] = Partial()
                    select = (j, n)
                else:
                    in_pl[i][j] = grad_pl[i][j] = Shard(h)
            for o, (_, h) in enumerate(out_dims):
                if h is not None:
                    out_pl[o][j] = Shard(h)

    def body(*local):
        if select is not None:
            j, n = select
            first = mesh.get_local_rank(j) * n // ratio
            local = [a.narrow(h, first, 1) if grp else a
                     for a, (_, h, grp) in zip(local, dims)]
        return fn(*local)

    # local_map: an output's placements are a list, several outputs a
    # tuple of lists
    run = local_map(body,
                    out_placements=(out_pl[0] if len(out_pl) == 1 else
                                    tuple(out_pl)),
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(*args)


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

    def run(q, k, v):
        return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   with_probe=with_probe,
                                   with_stats=with_stats,
                                   block_q=bq, block_k=bk)
    if with_probe:
        return run(q, k, v)          # per-rank counts: no global layout
    return local_call(run, (q, k, v),
                      ((0, 1, False), (0, 1, True), (0, 1, True)),
                      ((0, 1),) * (3 if with_stats else 1),
                      ratio=q.shape[1] // k.shape[1])


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

    def run(q, pool_k, pool_v, pages, pos):
        return _pa.paged_attention(q, pool_k, pool_v, pages, pos,
                                   pages_per_step=pages_per_step,
                                   pos_host=pos_host, tile_slots=tile_slots)
    # the pools hold every row's pages: batch-sharded rows read them whole
    return local_call(run, (q, pool_k, pool_v, pages, pos),
                      ((0, 1, False), (None, 2, False), (None, 2, False),
                       (0, None, False), (0, None, False)), ((0, 1),))


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

    def run(x, a, b, c):          # a rank's heads over its groups
        return _ssd.ssd_scan(x, a, b, c, chunk=chunk,
                             h_per_g=x.shape[2] // b.shape[2],
                             pipeline=pipeline,
                             return_final_state=return_final_state)
    return local_call(run, (x, a, b, c),
                      ((0, 2, False), (0, 2, False), (0, 2, True),
                       (0, 2, True)),
                      ((0, 2), (0, 1)) if return_final_state else ((0, 2),),
                      ratio=h_per_g)
