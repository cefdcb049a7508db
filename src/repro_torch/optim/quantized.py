"""Row-wise int8 quantized optimizer state (bitsandbytes-flavored).

Port of ``repro.optim.quantized``: int8 values with one float32 scale
per row of the last dimension, for ``moment_dtype="int8"``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor       # int8, shape = orig shape
    s: torch.Tensor       # f32 scales, shape = (*orig[:-1], 1)


def quantize(x, row_max=None) -> QTensor:
    """x -> rowwise int8 along the last dim. ``row_max`` (a block of a
    sharded leaf) takes this block's max |x| a row to the whole row's."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        amax = row_max(amax)
    scale = amax / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, s=scale)


def dequantize(qt: QTensor) -> torch.Tensor:
    return qt.q.to(torch.float32) * qt.s


def scale_placements(p):
    """The placements of a DTensor leaf's scales: ``p``'s, its last dim
    (1 wide in the scales) replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if pl.is_shard(p.dim() - 1) else pl
                 for pl in p.placements)


def _scale_shape(shape) -> tuple:
    return (tuple(shape[:-1]) + (1,)) if len(shape) else (1,)


def scales_of(p, s_block):
    """A DTensor leaf ``p``'s scales from this rank's block of them."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(_scale_shape(p.shape))
    from repro_torch.distributed.compat import contiguous_stride
    return DTensor.from_local(s_block, p.device_mesh, scale_placements(p),
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def zeros_like_q(p) -> QTensor:
    """Zero moments of ``p``; a DTensor's are DTensors, the values placed
    as ``p`` and the scales by ``scale_placements``."""
    sshape = _scale_shape(p.shape)
    if type(p) is not torch.Tensor and hasattr(p, "placements"):
        blk = p.to_local()
        s = torch.zeros(_scale_shape(blk.shape), dtype=torch.float32,
                        device=blk.device)
        return QTensor(q=torch.zeros_like(p, dtype=torch.int8),
                       s=scales_of(p, s))
    return QTensor(q=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                   s=torch.zeros(sshape, dtype=torch.float32,
                                 device=p.device))
