"""Parameter schema machinery + core layers (RMSNorm, RoPE/M-RoPE, SwiGLU MLP).

Port of ``repro.models.layers``. Parameters are described by a nested-dict
*schema* of ``Param`` records (shape, logical axes, initializer);
``materialize`` turns a schema into a nested dict of tensors on one
device, drawing from a ``torch.Generator``. Layouts are the JAX
package's, so a parameter tree converted from ``repro`` (see
``convert.params_from_numpy``) drops in unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import fold_matmul, shard


class Param(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Any, ...]          # logical axis names (len == len(shape))
    init: str = "normal"           # normal | zeros | ones | embed | ssm_a | ssm_dt
    scale: float = 1.0             # fan-in scaling multiplier


def map_schema(fn, schema):
    """Map ``fn`` over every Param leaf of a nested-dict schema."""
    if isinstance(schema, Param):
        return fn(schema)
    return {k: map_schema(fn, v) for k, v in schema.items()}


def _init_leaf(p: Param, gen: torch.Generator, dtype, device):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "ssm_a":
        # A_log init: log of uniform [1, 16] (mamba2 convention)
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32,
                       device=device)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if p.init == "ssm_dt":
        # dt bias: inverse softplus of uniform-log [1e-3, 1e-1]
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if p.init not in ("normal", "embed"):
        raise ValueError(f"initializer {p.init!r} is not ported")
    fan_in = p.shape[0] if p.init == "embed" else (
        math.prod(p.shape[:-1]) if len(p.shape) > 1 else p.shape[0])
    std = p.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)      # in place: one f32 copy, not two


def materialize(schema, gen: torch.Generator, dtype, device) -> Any:
    """Concrete parameters for ``schema``; leaves are drawn in sorted-key
    order (the JAX tree order), so one seed always gives one tree."""
    if isinstance(schema, Param):
        return _init_leaf(schema, gen, dtype, device)
    return {k: materialize(schema[k], gen, dtype, device)
            for k in sorted(schema)}


def abstract(schema, dtype, device="meta") -> Any:
    """Empty tensors of ``schema``'s shapes in ``dtype`` (JAX's
    ``abstract``: on ``meta``, shapes and dtypes only), in
    ``materialize``'s key order."""
    if isinstance(schema, Param):
        return torch.empty(schema.shape, dtype=dtype, device=device)
    return {k: abstract(schema[k], dtype, device) for k in sorted(schema)}


def stack_schema(schema, n: int, axis_name="layers"):
    """Prepend a stacked layer dimension to every Param in a schema."""
    return map_schema(
        lambda p: Param((n,) + p.shape, (axis_name,) + p.axes, p.init, p.scale),
        schema)


def index_tree(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: index_tree(v, i) for k, v in tree.items()}


# ---------------------------------------------------------------- layers

def rmsnorm(x, scale, eps: float):
    """RMSNorm with f32 statistics but an input-dtype multiply path."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def rmsnorm_schema(d: int) -> Param:
    return Param((d,), ("embed",), init="zeros")


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, n_heads, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]                   # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """Qwen2-VL M-RoPE. x: (..., seq, n, hd); positions3: (3, ..., seq).

    The rotary half-dim is partitioned into (temporal, h, w) sections;
    each section rotates by its own position stream. JAX selects each
    frequency's stream by a one-hot product, which adds exact zeros: the
    same values as the selection here."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = rope_freqs(hd, theta, x.device)                 # (half,)
    section_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)                                   # (half,)
    angles = positions3[..., None].float() * freqs          # (3, ..., seq, half)
    angles = torch.where(section_id == 0, angles[0],
                         torch.where(section_id == 1, angles[1], angles[2]))
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP

def mlp_schema(d: int, ff: int, use_bias: bool) -> Dict[str, Param]:
    s: Dict[str, Param] = {
        "wi": Param((d, ff), ("embed", "ff")),
        "wg": Param((d, ff), ("embed", "ff")),
        "wo": Param((ff, d), ("ff", "embed")),
    }
    if use_bias:
        s["bi"] = Param((ff,), ("ff",), init="zeros")
        s["bg"] = Param((ff,), ("ff",), init="zeros")
        s["bo"] = Param((d,), ("embed",), init="zeros")
    return s


def mlp_apply(params, x):
    """SwiGLU MLP. x: (..., d)."""
    h = fold_matmul(x, params["wi"])
    g = fold_matmul(x, params["wg"])
    if "bi" in params:
        h = h + params["bi"]
        g = g + params["bg"]
    h = F.silu(g) * h
    if h.dim() == 3:
        h = shard(h, "batch", "seq", "ff")
    out = fold_matmul(h, params["wo"])
    if "bo" in params:
        out = out + params["bo"]
    return out
