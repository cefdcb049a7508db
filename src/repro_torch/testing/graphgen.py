"""Seeded random model-graph generator (the SPRING-style sweep subject).

Port of ``repro.testing.graphgen``. One integer seed becomes an eager
PyTorch function whose structure is drawn from the port's real model
blocks (``models/ssm.py``, ``models/moe.py``, ``models/layers.py``, and
the flash forward of ``kernels/flash_attention.py``) composed under
randomized control flow marked by
``core.scope`` (``scope.scan``, ``scope.remat``, ``scope.cond``,
``scope.while_loop``) and, for the kernel kinds, the hand kernels of
``kernels/ops.py``.

The spec draw is the JAX package's, line for line (``random.Random``,
not torch), so ``random_spec(s).to_json()`` is the same string in both
packages and a failing seed reproduces in either::

    spec = random_spec(1234)
    fn, args = build(spec, device="cpu")
    assert GraphSpec.from_json(spec.to_json()) == spec

What differs from the JAX builder:

- ``jit`` has no eager counterpart and is a plain call. JAX's hierarchy
  descends into ``pjit`` without a path of its own, so the probe paths
  are the same.
- The params and ``x0`` come from a ``torch.Generator`` seeded by
  ``spec.seed`` (drawn on the CPU, then moved), not from JAX's PRNG;
  ``args_from_numpy`` carries another package's values across.
- The kernel widths. The spec draws ``d_model`` 16 or 32, so flash sees
  head dim 8 or 16 and the SSD scan P 8 or 16 with N 8; the CUDA kernels
  take head dims 64, 80 and 128 in bf16 (flash) and P 64 with N 64 or
  128 (SSD). The kernel calls zero-pad to the kernels' smallest widths
  on every device and slice the result back: flash pads D to 64, casts
  q, k, v to bf16 and scales q by ``sqrt(64 / HD)`` so that the
  kernel's ``1/sqrt(64)`` gives the graph's ``1/sqrt(HD)``; SSD pads P
  to 64 in x and N to 64 in b and c. Zeros leave the function unchanged
  in exact arithmetic, and the CPU's plain versions and the card's
  kernels compute the same padded function. The flash kernel's tiles
  are the port's (``kernels.ops.flash_tiles``), not JAX's ``S // 2``
  blocks, which the CUDA kernel does not have.
- The ``attn`` block is JAX's ``causal_flash_xla`` forward in PyTorch
  ops: ``kernels.flash_attention.flash_attention_plain`` (the port of
  ``_flash_fwd``, the same bf16 roundings) at JAX's ``S // 2`` q blocks
  and kv chunks, f32 in, on every device. It is not
  ``models.attention.causal_flash``, whose forward in the port is the
  flash kernel: that would put a kernel region (and, in a kernel graph,
  grid probes) where JAX's attn block has none, and a grid probe under
  a cond branch not taken is never entered, which the oracle check
  forbids. JAX's ``qblk`` scopes of that forward have no counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import scope
from repro_torch.core.pragma import ProbeConfig

# block families drawn from the real model code (KERNEL_KINDS call a
# hand kernel and force kernel grid-step probing)
BLOCK_KINDS = ("mlp", "attn", "ssm", "moe", "elementwise")
KERNEL_KINDS = ("flash_kernel", "ssd_kernel")
WRAPPERS = ("none", "scan", "remat", "cond", "jit", "while", "scan_cond")
# wrappers safe around a kernel call (kept as JAX's: the kernel body is
# itself a grid loop; scan/while around it multiply interpret cost)
KERNEL_WRAPPERS = ("none", "jit")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One randomly drawn block: a building-block kind plus the control
    flow construct wrapped around it (``length`` = scan/while trips)."""
    kind: str
    wrapper: str = "none"
    length: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Complete, JSON-serializable description of one random graph.

    ``seed`` drives both the structure draw (``random_spec``) and the
    parameter/input values (``build``), so the spec alone reproduces the
    exact program AND the exact data of a failing conformance run.
    """
    seed: int
    batch: int = 2
    seq: int = 16
    d_model: int = 16
    blocks: Tuple[BlockSpec, ...] = ()
    buffer_depth: int = 4
    offload: float = 0.0
    max_probes: int = 50

    @property
    def has_kernel(self) -> bool:
        return any(b.kind in KERNEL_KINDS for b in self.blocks)

    def probe_config(self) -> ProbeConfig:
        return ProbeConfig(inline="off_all",
                           buffer_depth=self.buffer_depth,
                           offload=self.offload,
                           max_probes=self.max_probes,
                           kernel_probes=("*",) if self.has_kernel else ())

    # ------------------------------------------------- JSON round-trip
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["blocks"] = [b.to_dict() for b in self.blocks]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GraphSpec":
        d = dict(d)
        d["blocks"] = tuple(BlockSpec(**b) for b in d.get("blocks", ()))
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "GraphSpec":
        return cls.from_dict(json.loads(s))


def random_spec(seed: int, *, max_blocks: int = 5,
                allow_kernels: bool = True) -> GraphSpec:
    """Deterministically draw a GraphSpec from an integer seed.

    Uses ``random.Random`` (not numpy / torch) so structure draws are
    stable across library versions and equal to the JAX package's. At
    most one kernel block per graph.
    """
    rng = random.Random(int(seed))
    batch = rng.choice((1, 2))
    seq = rng.choice((16, 32))
    d_model = rng.choice((16, 32))
    n_blocks = rng.randint(2, max_blocks)
    blocks: List[BlockSpec] = []
    kernel_used = False
    for _ in range(n_blocks):
        if allow_kernels and not kernel_used and rng.random() < 0.2:
            kind = rng.choice(KERNEL_KINDS)
            kernel_used = True
            wrapper = rng.choice(KERNEL_WRAPPERS)
            length = 1
        else:
            kind = rng.choice(BLOCK_KINDS)
            wrapper = rng.choice(WRAPPERS)
            length = rng.randint(2, 3) if wrapper in ("scan", "while",
                                                      "scan_cond") else 1
        blocks.append(BlockSpec(kind=kind, wrapper=wrapper, length=length))
    return GraphSpec(
        seed=int(seed), batch=batch, seq=seq, d_model=d_model,
        blocks=tuple(blocks),
        buffer_depth=rng.choice((2, 4)),
        offload=rng.choice((0.0, 1.0)),
        max_probes=rng.choice((16, 50)),
    )


# ------------------------------------------------------------ builders

def _moe_cfg(d_model: int):
    """Tiny MoE ModelConfig for the standalone ``_moe_local`` body (the
    capacity impl with generous capacity so no token is dropped)."""
    from repro_torch.configs.registry import smoke_config
    cfg = smoke_config("granite-moe-1b-a400m")
    return cfg.replace(
        d_model=d_model,
        moe=dataclasses.replace(cfg.moe, impl="capacity",
                                capacity_factor=8.0, dense_residual=False))


def _block_params(spec: GraphSpec, kind: str,
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
    D = spec.d_model
    F_ = 2 * D
    s = 1.0 / math.sqrt(D)

    def w(shape, scale=None):
        sc = s if scale is None else scale
        return torch.randn(shape, generator=gen, dtype=torch.float32) * sc

    if kind == "mlp":
        return {"wi": w((D, F_)), "wg": w((D, F_)),
                "wo": w((F_, D), 1.0 / math.sqrt(F_))}
    if kind in ("attn", "flash_kernel"):
        return {"wq": w((D, D)), "wk": w((D, D)), "wv": w((D, D)),
                "wo": w((D, D))}
    if kind in ("ssm", "ssd_kernel"):
        N = 8
        return {"wx": w((D, D)), "wa": w((D, 2)), "wb": w((D, N)),
                "wc": w((D, N)), "wo": w((D, D))}
    if kind == "moe":
        E, FF = 4, 16
        return {"router": w((D, E)), "wi": w((E, D, FF)),
                "wg": w((E, D, FF)), "wo": w((E, FF, D), 1.0 / math.sqrt(FF))}
    if kind == "elementwise":
        return {"scale": torch.zeros((D,), dtype=torch.float32),
                "gate": w((D, D))}
    raise ValueError(f"unknown block kind {kind!r}")


def _pad_last(t, width: int):
    return F.pad(t, (0, width - t.shape[-1])) if t.shape[-1] < width else t


def _heads_first(*ts):
    return tuple(t.transpose(1, 2).contiguous() for t in ts)


def _attn(q, k, v):
    """JAX's ``causal_flash_xla(q, k, v, S // 2, S // 2)`` forward on
    (B, S, H, HD) f32 q, k, v (see the module docstring)."""
    from repro_torch.kernels import flash_attention as fa
    S = q.shape[1]
    return fa.flash_attention_plain(*_heads_first(q, k, v), causal=True,
                                    block_q=S // 2,
                                    block_k=S // 2).transpose(1, 2)


def _flash(q, k, v, plain: bool):
    """The flash kernel on (B, S, H, HD) f32 q, k, v at its padded width
    (see the module docstring); returns (B, S, H, HD) f32."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    HD, D = q.shape[-1], min(fa.HEAD_DIMS)
    qp, kp, vp = _heads_first(
        _pad_last(q * math.sqrt(D / HD), D).to(torch.bfloat16),
        _pad_last(k, D).to(torch.bfloat16),
        _pad_last(v, D).to(torch.bfloat16))
    if plain:
        bq, bk = kops.flash_tiles(D, args=(qp, kp, vp))
        o = fa.flash_attention_plain(qp, kp, vp, causal=True, block_q=bq,
                                     block_k=bk)
    else:
        o = kops.flash_attention(qp, kp, vp, causal=True)
    return o.transpose(1, 2)[..., :HD].float()


def _ssd(xs, a, b, c, chunk: int, h_per_g: int, plain: bool):
    """The SSD kernel at its padded widths (see the module docstring):
    xs (B, S, H, P), b and c (B, S, 1, N), f32; returns y (B, S, H, P)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssd
    P = xs.shape[-1]
    xp = _pad_last(xs, min(ssd.HEAD_DIMS)).contiguous()
    bp = _pad_last(b, min(ssd.STATE_DIMS)).contiguous()
    cp = _pad_last(c, min(ssd.STATE_DIMS)).contiguous()
    if plain:
        y = ssd.ssd_scan_plain(xp, a, bp, cp, chunk=chunk, h_per_g=h_per_g)
    else:
        y = kops.ssd_scan(xp, a, bp, cp, chunk=chunk, h_per_g=h_per_g)
    return y[..., :P]


def _apply_block(kind: str, p: Dict[str, torch.Tensor], x, plain: bool):
    """x: (B, S, D) -> (B, S, D), contractive (bounded activations +
    damped residual) so stacked/looped blocks stay numerically tame."""
    B, S, D = x.shape
    if kind == "mlp":
        from repro_torch.models.layers import mlp_apply
        return x + 0.5 * mlp_apply(p, torch.tanh(x))
    if kind in ("attn", "flash_kernel"):
        H, HD = 2, D // 2
        q = (x @ p["wq"]).reshape(B, S, H, HD)
        k = (x @ p["wk"]).reshape(B, S, H, HD)
        v = (x @ p["wv"]).reshape(B, S, H, HD)
        o = _attn(q, k, v) if kind == "attn" else _flash(q, k, v, plain)
        return x + 0.5 * (o.reshape(B, S, D) @ p["wo"])
    if kind in ("ssm", "ssd_kernel"):
        H, P = 2, D // 2
        xs = torch.tanh(x @ p["wx"]).reshape(B, S, H, P)
        a = -torch.abs(x @ p["wa"]) * 0.2                    # (B, S, H)
        b = (x @ p["wb"])[:, :, None, :] * 0.5               # (B, S, 1, N)
        c = (x @ p["wc"])[:, :, None, :] * 0.5
        if kind == "ssm":
            from repro_torch.models.ssm import ssd_chunked
            y = ssd_chunked(xs, a, b, c, chunk=S // 2, h_per_g=H)[0]
        else:
            y = _ssd(xs, a, b, c, S // 2, H, plain)
        return x + 0.5 * (y.reshape(B, S, D) @ p["wo"])
    if kind == "moe":
        from repro_torch.models.moe import _moe_local
        out, aux = _moe_local(torch.tanh(x), p["router"], p["wi"], p["wg"],
                              p["wo"], _moe_cfg(D))
        return x + 0.5 * out + 0.0 * aux
    if kind == "elementwise":
        from repro_torch.models.layers import rmsnorm
        y = rmsnorm(x, p["scale"], 1e-6)
        return x + 0.5 * torch.tanh(y @ p["gate"]) * torch.sigmoid(y)
    raise ValueError(f"unknown block kind {kind!r}")


def _apply_wrapped(blk: BlockSpec, p: Dict[str, torch.Tensor], x,
                   plain: bool):
    def body(v):
        return _apply_block(blk.kind, p, v, plain)

    def heavy(v):
        with scope.named_scope("heavy"):
            return body(v)

    def light(v):
        with scope.named_scope("light"):
            return v * 1.01

    if blk.wrapper in ("none", "jit"):
        return body(x)
    if blk.wrapper == "scan":
        for _ in scope.scan(blk.length):
            with scope.named_scope("step"):
                x = body(x)
        return x
    if blk.wrapper == "remat":
        return scope.remat(body, x)
    if blk.wrapper == "cond":
        return scope.cond(torch.sum(x) > 0, heavy, light, x)
    if blk.wrapper == "while":
        def wbody(s):
            with scope.named_scope("iter"):
                return body(s[0]), s[1] + 1
        y, _ = scope.while_loop(
            lambda s: s[1] < blk.length, wbody,
            (x, torch.zeros((), dtype=torch.int32, device=x.device)))
        return y
    if blk.wrapper == "scan_cond":
        # a per-iteration data-dependent branch inside a probed loop
        for _ in scope.scan(blk.length):
            with scope.named_scope("step"):
                x = scope.cond(torch.sum(x) > 0, heavy, light, x)
        return x
    raise ValueError(f"unknown wrapper {blk.wrapper!r}")


def args_from_numpy(x0, params: Sequence[Dict[str, Any]], device=None):
    """``(x0, params)`` as tensors on ``device`` from numpy arrays (another
    package's ``build`` args, e.g. the JAX graph's, carried across)."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    return t(x0), [{k: t(v) for k, v in p.items()} for p in params]


def build(spec: GraphSpec, device=None, *, plain: bool = False):
    """Materialize ``spec`` into ``(fn, args)``: an eager function plus
    deterministic concrete inputs on ``device`` (the GPU unless 'cpu' is
    asked). ``fn(x, params)`` returns a scalar so probed-vs-unprobed
    bit-identity is a one-tensor compare of the full dataflow.

    ``plain=True`` routes the kernel calls through the kernels' plain
    versions on any device (the padded function the kernels compute): a
    twin to hold the kernels' graph against on the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(spec.seed))
    params = [_block_params(spec, b.kind, gen) for b in spec.blocks]
    x0 = torch.randn((spec.batch, spec.seq, spec.d_model), generator=gen,
                     dtype=torch.float32) * 0.1
    x0, params = x0.to(dev), [{k: v.to(dev) for k, v in p.items()}
                              for p in params]

    def fn(x, params):
        for i, blk in enumerate(spec.blocks):
            with scope.named_scope(f"b{i}_{blk.kind}"):
                x = _apply_wrapped(blk, params[i], x, plain)
        with scope.named_scope("head"):
            return torch.sum(x * x)

    return fn, (x0, params)
