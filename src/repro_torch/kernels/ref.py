"""Plain-torch oracles for the flash-attention and SSD-scan kernels.

Ports of ``repro.kernels.ref``: naive softmax attention with f32
statistics, and the exact sequential SSD recurrence. They are the ground
truth the kernels and their plain versions are both held against.
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


def ssd_ref(x, a, b, c):
    """Sequential (exact) SSD recurrence.

    x: (B, H, L, P) — discretized inputs (x * dt)
    a: (B, H, L)    — discretized log decay (A * dt)
    b, c: (B, G, L, N) with H % G == 0
    Returns y (B, H, L, P) f32, final_state (B, H, P, N) f32.
    """
    B, H, L, P = x.shape
    rep = H // b.shape[1]
    b = b.repeat_interleave(rep, dim=1).float()         # (B, H, L, N)
    c = c.repeat_interleave(rep, dim=1).float()
    x, a = x.float(), a.float()
    state = torch.zeros((B, H, P, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(L):
        da = torch.exp(a[:, :, t])[..., None, None]
        state = state * da + torch.einsum("bhp,bhn->bhpn", x[:, :, t],
                                          b[:, :, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, :, t]))
    return torch.stack(ys, dim=2), state
