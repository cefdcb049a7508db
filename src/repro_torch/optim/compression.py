"""int8 error-feedback gradient compression for the cross-pod exchange.

Port of ``repro.optim.compression``. Quantize (grad + residual) to int8
with a per-tensor scale before the cross-pod reduce, and keep the
quantization error as residual state for the next step (error feedback
is unbiased over time): 1 byte an element on the wire instead of 4.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
payload is bitwise the JAX package's on the same inputs.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import compat
from repro_torch.optim import adamw


def init_residual(params) -> Any:
    return adamw.tree_map(lambda p: compat.zeros_like(p, torch.float32),
                          params)


def _q(g: torch.Tensor, r: torch.Tensor):
    g32 = g.to(torch.float32) + r
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_r = g32 - q8.to(torch.float32) * scale
    return q8, scale, new_r


def compress(grads, residual) -> Tuple[Any, Any, Any]:
    """Returns (int8 payload, scales, new residual): the compression
    error is the pre-quantization value minus the dequantized one."""
    out = [_q(g, r) for g, r in zip(adamw.tree_leaves(grads),
                                    adamw.tree_leaves(residual))]
    return tuple(adamw.tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def decompress(payload, scales, dtype=torch.float32) -> Any:
    return adamw.tree_unflatten(payload, [
        (q.to(torch.float32) * s).to(dtype)
        for q, s in zip(adamw.tree_leaves(payload),
                        adamw.tree_leaves(scales))])
