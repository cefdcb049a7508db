"""Plain-torch oracle for the flash-attention kernel.

Port of ``repro.kernels.ref.flash_attention_ref``: naive softmax
attention with f32 statistics, the ground truth the kernel and its plain
version are both held against.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Naive softmax attention.

    q: (B, H, S, D); k, v: (B, Hkv, S, D) with H % Hkv == 0.
    Returns (B, H, S, D) in q.dtype; f32 softmax internally.
    """
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)
