"""Mamba-2 (SSD — state-space duality) block. [arXiv:2405.21060]

Port of ``repro.models.ssm``: ``ssm_apply`` with its decode caches,
``ssm_decode``, and the chunked SSD scan in PyTorch ops
(``ssd_chunked``, the port of ``ssd_chunked_xla``). With ``use_kernel``
(the default, every serving prefill) the SSD step of ``ssm_apply`` goes
through ``kernels.ssd_scan``: the CUDA kernel on the card, which also
returns the final state; its plain version, ``ssd_chunked_xla`` op for
op, on the CPU. The JAX package reaches its Pallas kernel only with
``use_kernel=True``, which no entry point passes and which cannot return
the state. Training passes ``use_kernel=False``, as the JAX package's
training does: ``ssd_chunked`` is differentiable, with JAX's scopes
(``intra``, ``chunk_states``, ``state_pass``, ``inter``); no Pallas
kernel of the reference has a backward.

Layout:
    x (b, l, h, p)   h = heads, p = head_dim
    A (b, l, h)      discretized log-decay (dt * A)
    B (b, l, g, n)   g = groups (GQA-style shared B/C), n = d_state
    C (b, l, g, n)
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.distributed.sharding import (axis_rules, fold_matmul,
                                              is_dtensor, pad, placed_grad,
                                              shard)
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Param, rmsnorm


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + heads
    return dict(d_inner=d_inner, heads=heads, conv_dim=conv_dim,
                d_in_proj=d_in_proj, d_state=s.d_state, groups=s.n_groups,
                head_dim=s.head_dim, conv_kernel=s.conv_kernel,
                chunk=s.chunk_size)


def ssm_schema(cfg: ModelConfig) -> Dict[str, Param]:
    d = ssm_dims(cfg)
    return {
        "in_proj": Param((cfg.d_model, d["d_in_proj"]), ("embed", "ssm_inner")),
        "conv_w": Param((d["conv_kernel"], d["conv_dim"]), ("conv", "ssm_inner")),
        "conv_b": Param((d["conv_dim"],), ("ssm_inner",), init="zeros"),
        "a_log": Param((d["heads"],), ("ssm_heads",), init="ssm_a"),
        "d_skip": Param((d["heads"],), ("ssm_heads",), init="ones"),
        "dt_bias": Param((d["heads"],), ("ssm_heads",), init="ssm_dt"),
        "norm": Param((d["d_inner"],), ("ssm_inner",), init="zeros"),
        "out_proj": Param((d["d_inner"], cfg.d_model), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq via K static shifts.

    x: (B, S, C); w: (K, C); b: (C,)."""
    K = w.shape[0]
    out = x * w[-1]
    for k in range(1, K):
        shifted = pad(x, (0, 0, k, 0))[:, :-k]
        out = out + shifted * w[-1 - k]
    return out + b


def _segsum_exp(a_cs):
    """a_cs: (..., q) inclusive cumsum -> exp lower-tri decay (..., q, q).
    The exponent is masked before ``exp``, not after: the values are
    JAX's, and the gradient stays finite where the upper triangle's
    exponent (a sum of -a > 0) overflows, where 0 x inf would give NaN."""
    q = a_cs.shape[-1]
    seg = a_cs[..., :, None] - a_cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a_cs.device).tril()
    return torch.exp(seg.masked_fill(~mask, float("-inf")))


def _dot(eq: str, *ops, dtype):
    """An einsum accumulated in f32 and rounded once to ``dtype``, as an
    XLA dot_general of these operands gives it."""
    return torch.einsum(eq, *(o.float() for o in ops)).to(dtype)


class _StatePass(torch.autograd.Function):
    """The inter-chunk recurrence, ``prev[c] = state; state = state *
    decay[c] + states[c]`` from a zero f32 state, and its transpose: one
    autograd node whose forward and backward each walk the chunks under
    ``scope.scan``, as JAX's scan and its transposed scan do. (Left to
    autograd, each chunk's state feeds both the next chunk and the
    stacked ``prev``, so its gradient would be summed inside the next
    iteration's backward, in every iteration but the last: iterations a
    probe could not price alike.)

    states: (B, C, G, E, P, N) f32; decay: (B, G, E, C) f32. Returns
    (prev (B, C, G, E, P, N), final state (B, G, E, P, N))."""

    @staticmethod
    def forward(ctx, states, decay):
        carry = torch.zeros_like(states[:, 0])
        prev = []
        for ci in scope.scan(states.shape[1]):
            prev.append(carry)
            carry = carry * decay[..., ci, None, None] + states[:, ci]
        prev = torch.stack(prev, dim=1)
        ctx.save_for_backward(prev, decay)
        return prev, carry

    @staticmethod
    def backward(ctx, g_prev, g_final):
        prev, decay = ctx.saved_tensors
        C = prev.shape[1]
        g_states = torch.empty_like(prev)
        g_decay = torch.empty_like(decay)
        g = g_final
        for i in scope.scan(C):
            ci = C - 1 - i
            g_states[:, ci] = g
            g_decay[..., ci] = (g * prev[:, ci]).sum(dim=(-2, -1))
            g = g * decay[..., ci, None, None] + g_prev[:, ci]
        return g_states, g_decay


def ssd_chunked(x, a, b, c, chunk: int, h_per_g: int):
    """Chunked SSD scan in PyTorch ops (port of ``ssd_chunked_xla``,
    differentiable; the training path).

    x: (B, L, h, p), already discretized (x * dt); a: (B, L, h) f32, <= 0;
    b, c: (B, L, g, n) with h = g * h_per_g. Returns (y (B, L, h, p) in
    x's dtype, final state (B, g, e, p, n) f32)."""
    y, final = _ssd_heads(x, a, b, c, chunk, h_per_g)
    return y, final.reshape(x.shape[0], b.shape[2], h_per_g,
                            *final.shape[2:])


def _ssd_heads(x, a, b, c, chunk: int, h_per_g: int):
    """``ssd_chunked`` with the final state as (B, h, p, n). On DTensors
    (under sharding rules) it runs per rank through ``kernels.ops.
    local_call``, batch and heads sharded as the inputs are, each rank
    passed the B / C groups its heads read: the scan's math is
    independent across sequences and heads, and DTensor's einsum cannot
    view the head dimension its shards cut (JAX's GSPMD keeps it sharded
    through all four products)."""
    if not any(is_dtensor(t) for t in (x, a, b, c)):
        return _ssd_local(x, a, b, c, chunk, h_per_g)
    # heads split over their axis as JAX's constraints split them (DTensor
    # may bring them here whole: torch 2.11 gathers the in_proj's split)
    x = shard(x, "batch", "seq", "ssm_heads", "ssm_head_dim")
    a = shard(a, "batch", "seq", "ssm_heads")

    def body(x, a, b, c):
        with axis_rules(None):               # plain blocks: no placements
            return _ssd_local(x, a, b, c, chunk, x.shape[2] // b.shape[2])
    return kops.local_call(body, (x, a, b, c),
                           [(0, 2, False), (0, 2, False), (0, 2, True),
                            (0, 2, True)], [(0, 2), (0, 1)], ratio=h_per_g)


def _ssd_local(x, a, b, c, chunk: int, h_per_g: int):
    B, L, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    E, dt = h_per_g, x.dtype
    if L % chunk:
        raise ValueError(f"L {L} % chunk {chunk}")
    C_ = L // chunk
    xe = x.reshape(B, C_, chunk, G, E, Pd)
    ae = a.reshape(B, C_, chunk, G, E).permute(0, 3, 4, 1, 2)   # (B,G,E,C,Q)
    be = b.reshape(B, C_, chunk, G, N)
    ce = c.reshape(B, C_, chunk, G, N)
    a_cs = torch.cumsum(ae.float(), dim=-1)                      # (B,G,E,C,Q)

    with scope.named_scope("intra"):
        cb = _dot("bcqgn,bckgn->bcgqk", ce, be, dtype=torch.float32)
        decay = _segsum_exp(a_cs)                                # (B,G,E,C,Q,Q)
        decay = shard(decay, "batch", None, "ssm_heads", None, None, None)
        cbl = cb[:, :, :, None] * decay.permute(0, 3, 1, 2, 4, 5)
        cbl = shard(cbl, "batch", None, None, "ssm_heads", None, None)
        y_diag = _dot("bcgeqk,bckgep->bcqgep", cbl.to(dt), xe, dtype=dt)

    with scope.named_scope("chunk_states"):
        decay_states = torch.exp(a_cs[..., -1:] - a_cs)          # (B,G,E,C,Q)
        states = _dot("bckgn,bgeck,bckgep->bcgepn", be,
                      decay_states.to(dt), xe, dtype=dt)
        states = shard(states, "batch", None, None, "ssm_heads", None, None)

    with scope.named_scope("state_pass"):
        chunk_decay = torch.exp(a_cs[..., -1])                   # (B,G,E,C)
        prev_states, final = _StatePass.apply(states.float(), chunk_decay)

    with scope.named_scope("inter"):
        state_decay_out = torch.exp(a_cs)                        # (B,G,E,C,Q)
        y_off = _dot("bcqgn,bcgepn,bgecq->bcqgep", ce, prev_states.to(dt),
                     state_decay_out.to(dt), dtype=dt)

    return (y_diag + y_off).reshape(B, L, H, Pd), final.reshape(B, H, Pd, N)


def _width_split(w) -> bool:
    """Whether the in_proj's output columns are split over a mesh dim."""
    return is_dtensor(w) and any(p.is_shard(1) and w.device_mesh.size(j) > 1
                                 for j, p in enumerate(w.placements))


def _split_front(params, x, d):
    """The in_proj and the conv by column blocks (z, x, B, C, dt), for an
    in_proj split over the model axis: each block's weight is cut from
    the weight gathered over that axis once and split over it again, so
    every product and the depthwise conv keep their columns split there.
    (DTensor cannot split a dimension its shards cut, so splitting the
    whole product would gather it, a (B, S, d_in_proj) block a rank, and
    the conv would run at full width on every rank.) The weights'
    gradients come back placed as the weights are. Returns (z, the
    conv's input's (x, B, C), dt, its silu'd output's (x, B, C))."""
    from torch.distributed.tensor import Replicate
    di, gn, h = d["d_inner"], d["groups"] * d["d_state"], d["heads"]

    def blocks(w, axes, sizes):
        w = placed_grad(w)
        w = w.redistribute(w.device_mesh, [
            Replicate() if p.is_shard(w.dim() - 1) else p
            for p in w.placements])
        out, at = [], 0
        for size in sizes:
            out.append(shard(w[..., at:at + size], *axes))
            at += size
        return out

    with scope.named_scope("in_proj"):
        ws = blocks(params["in_proj"], ("embed", "ssm_inner"),
                    (di, di, gn, gn, h))
        z, xr, br, cr, dt = [shard(fold_matmul(x, w), "batch", "seq",
                                   "ssm_inner") for w in ws]
    with scope.named_scope("conv"):
        sizes = (di, gn, gn)
        convs = [F.silu(_causal_conv(r, w, bias)) for r, w, bias in zip(
            (xr, br, cr), blocks(params["conv_w"], ("conv", "ssm_inner"),
                                 sizes),
            blocks(params["conv_b"], ("ssm_inner",), sizes))]
    return z, (xr, br, cr), dt, convs


def ssm_apply(params, x, cfg: ModelConfig, *, use_kernel: bool = True,
              return_state: bool = False):
    """Full-sequence Mamba2 block forward. x: (B, S, d_model).

    ``use_kernel``: the SSD step through ``kernels.ssd_scan`` (serving);
    else through ``ssd_chunked`` at chunk ``min(chunk_size, S)``, as the
    JAX package's training path (differentiable). With ``return_state``
    also returns (conv_state (B,K-1,conv_dim), ssd_state (B,h,p,n)) —
    the decode caches after consuming the prefix.
    """
    d = ssm_dims(cfg)
    B, S, _ = x.shape
    di, g, n, h = d["d_inner"], d["groups"], d["d_state"], d["heads"]
    if _width_split(params["in_proj"]):
        z, xbc_raw, dt, (xs, b, c) = _split_front(params, x, d)
    else:
        with scope.named_scope("in_proj"):
            # the gradient comes back split as the product is (torch 2.11
            # would take the in_proj's gradient from a whole one)
            zxbcdt = placed_grad(shard(fold_matmul(x, params["in_proj"]),
                                       "batch", "seq", "ssm_inner"))
        z, xbc_raw, dt = torch.split(zxbcdt, [di, d["conv_dim"], h],
                                     dim=-1)
        with scope.named_scope("conv"):
            xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"],
                                      params["conv_b"]))
        xs, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(B, S, h, d["head_dim"])
    b = b.reshape(B, S, g, n)
    c = c.reshape(B, S, g, n)
    with scope.named_scope("discretize"):
        dt = F.softplus(dt.float() + params["dt_bias"])
        a = -torch.exp(params["a_log"].float())                 # (h,)
        a_disc = (dt * a).float()                               # (B,S,h)
        x_disc = xs * dt[..., None].to(xs.dtype)
    with scope.named_scope("ssd"):
        chunk = (kops.resolve_ssd_chunk(S, d["chunk"],
                                        args=(x_disc, a_disc, b, c))
                 if use_kernel else min(d["chunk"], S))
        n_pad = (-S) % chunk
        if n_pad:
            # zero-pad: a=0 (decay 1) with x=0 leaves state/output intact
            x_disc = pad(x_disc, (0, 0, 0, 0, 0, n_pad))
            a_disc = pad(a_disc, (0, 0, 0, n_pad))
            b = pad(b, (0, 0, 0, 0, 0, n_pad))
            c = pad(c, (0, 0, 0, 0, 0, n_pad))
        if use_kernel:
            y, final_state = kops.ssd_scan(x_disc, a_disc, b, c,
                                           chunk=chunk, h_per_g=h // g,
                                           return_final_state=True)
        else:
            y, final_state = _ssd_heads(x_disc, a_disc, b, c, chunk, h // g)
        if n_pad:
            y = y[:, :S]
    with scope.named_scope("out"):
        y = y + params["d_skip"][:, None].to(xs.dtype) * xs
        y = y.reshape(B, S, di)
        y = rmsnorm(y, params["norm"], cfg.norm_eps) * F.silu(z)
        out = fold_matmul(y, params["out_proj"])
    out = shard(out, "batch", "seq", None)
    if return_state:
        K = d["conv_kernel"]
        # the last K-1 conv inputs; a prompt shorter than that is
        # preceded by the conv's zero history
        if isinstance(xbc_raw, tuple):
            # column blocks: their last K - 1 rows joined (a small gather)
            xbc_raw = torch.cat([r[:, max(0, S - (K - 1)):]
                                 for r in xbc_raw], dim=-1)
        hist = pad(xbc_raw, (0, 0, max(0, K - 1 - S), 0))
        conv_state = hist[:, hist.shape[1] - (K - 1):]
        return out, conv_state, final_state
    return out


def ssm_decode(params, x, conv_state, ssd_state, cfg: ModelConfig):
    """Single-token decode. x: (B,1,d); conv_state: (B,K-1,conv_dim);
    ssd_state: (B,h,p,n). Returns (out, new_conv_state, new_ssd_state)."""
    d = ssm_dims(cfg)
    B = x.shape[0]
    di, g, n, h, p = (d["d_inner"], d["groups"], d["d_state"], d["heads"],
                      d["head_dim"])
    zxbcdt = (x @ params["in_proj"])[:, 0]
    z, xbc, dt = torch.split(zxbcdt, [di, d["conv_dim"], h], dim=-1)
    with scope.named_scope("conv_step"):
        w = params["conv_w"]                                    # (K, C)
        hist = torch.cat([conv_state, xbc[:, None]], dim=1)     # (B,K,C)
        y_conv = torch.einsum("bkc,kc->bc", hist.float(), w.float()).to(
            hist.dtype) + params["conv_b"]
        new_conv_state = hist[:, 1:]
        xbc = F.silu(y_conv)
    xs, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(B, h, p)
    with scope.named_scope("state_update"):
        e = h // g
        # head h reads group h // e, as in the prefill scan
        b = b.reshape(B, g, n).repeat_interleave(e, dim=1)      # (B,h,n)
        c = c.reshape(B, g, n).repeat_interleave(e, dim=1)
        dt = F.softplus(dt.float() + params["dt_bias"])         # (B,h)
        a = -torch.exp(params["a_log"].float())
        da = torch.exp(dt * a)                                  # (B,h)
        bx = torch.einsum("bhn,bhp->bhpn", b.float(),
                          xs.float() * dt[..., None])
        new_state = ssd_state * da[..., None, None] + bx        # (B,h,p,n)
        y = torch.einsum("bhpn,bhn->bhp", new_state, c.float())
        y = y.to(xs.dtype) + params["d_skip"][:, None].to(xs.dtype) * xs
    with scope.named_scope("out"):
        y = y.reshape(B, di)
        y = rmsnorm(y, params["norm"], cfg.norm_eps) * F.silu(z)
        out = (y @ params["out_proj"])[:, None]
    # summed over the model axis here, as after the prefill's out_proj: a
    # residual left partial makes the next layer's in_proj run at full
    # width on every rank
    out = shard(out, "batch", "seq", None)
    return out, new_conv_state, new_state
