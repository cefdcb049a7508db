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


def quantize(x) -> QTensor:
    """x -> rowwise int8 along the last dim."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, s=scale)


def dequantize(qt: QTensor) -> torch.Tensor:
    return qt.q.to(torch.float32) * qt.s


def zeros_like_q(p) -> QTensor:
    sshape = (tuple(p.shape[:-1]) + (1,)) if p.dim() else (1,)
    return QTensor(q=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                   s=torch.zeros(sshape, dtype=torch.float32,
                                 device=p.device))
