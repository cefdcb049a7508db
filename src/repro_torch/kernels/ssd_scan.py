"""Mamba-2 SSD chunked scan: a CUDA kernel for Hopper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py``, function
``ssd_scan`` (body ``_ssd_kernel``); the CUDA source is
``src/repro_torch/csrc/ssd_scan.cu``. Per chunk of ``Q`` steps, with
``a_cs = cumsum(a)`` over the chunk:

    y[q]   = sum_{k<=q} exp(a_cs[q]-a_cs[k]) (c_q . b_k) x_k
             + exp(a_cs[q]) c_q . state
    state <- exp(a_cs[-1]) state + sum_k exp(a_cs[-1]-a_cs[k]) x_k b_k^T

Head ``h`` reads group ``h // h_per_g`` of b and c. Unlike the TPU
kernel, which keeps the running (P, N) state in scratch and drops it,
this one can also write the f32 state after the last chunk
(``return_final_state``), so the serving prefill takes the decode cache
from the kernel.

What bounds it on an H100: memory. At the serving shape (B=8, L=1024,
H=32, P=64, G=1, N=128, chunk 256, bf16) x and y are 33.5 MB each, b and
c 4.2 MB, a 1 MB and the final state 8.4 MB: ~80 MB, ~24 us at
3.35 TB/s; the least work (c.b once per group and chunk, causal triangle
only) is ~13 GFLOP, ~13 us on the bf16 tensor cores. What the design does
about it: one CTA per (b, h) walks its chunks in order, carrying the
state in shared memory, so every x, a, y element and the state cross
device memory once; b and c are read once per head from the 50 MB L2.
This first kernel runs its products on the CUDA cores in f32 and
recomputes c.b for every head of a group, so it sits far above the
bound; tensor-core tiles and sharing c.b across heads are later work.

Layout: the wrapper hands the kernel the model layout, x (B, L, H, P),
a (B, L, H), b/c (B, L, G, N), through their strides (the last dim must
be unit-stride). It does not transpose to (B, H, L, P) as the JAX adapter
(``ops._ssd_jit``) does: that would move x and y through device memory
once more (67 MB at the serving shape, more than the kernel's own
traffic), and b/c arrive as strided views of the conv output.

Rounding contract. The kernel casts x, b, c to f32 and keeps every
intermediate in f32, as the TPU kernel does; y is rounded once to x's
dtype and the state stays f32. The plain version is the JAX serving
path's ``ssd_chunked_xla`` op for op, which rounds ``cbl``,
``decay_states``, the chunk states and ``prev_states`` to x's dtype. In
bf16 the two therefore differ by a few bf16 ulps of those intermediates
(``chip_smoke.py`` allows 2e-2 of max|y| on y and 1e-2 of max|state| on
the state); against the plain version run on f32 copies of the same
inputs, only f32 summation order and y's final rounding separate them
(1 bf16 ulp of max|y|, 2e-5 of max|state| at L=1024).

Determinism contract: one CTA per (b, h), fixed loop orders and no
atomics, so row b of a batched call is bitwise equal to a batch-1 call
on row b.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64,)              # P the kernel takes (mamba2, zamba2)
STATE_DIMS = (64, 128)         # N the kernel takes (zamba2, mamba2)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # x / b / c / y
TILE = 64                      # rows per shared-memory tile (csrc TILE)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"ssd_scan_fwd": [_P] * 6 + [_I] * 8 + [_L] * 12
               + [_I, _I, _P]}


def _check(x, a, b, c, chunk: int, pipeline: int, h_per_g: int) -> int:
    """Validates the model-layout arguments; returns the sub-chunk length
    ``chunk // pipeline``."""
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4:
        raise ValueError("want x (B, L, H, P), a (B, L, H), b/c (B, L, G, N)")
    B, L, H, _ = x.shape
    if tuple(a.shape) != (B, L, H):
        raise ValueError(f"a {tuple(a.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if b.shape != c.shape or tuple(b.shape[:2]) != (B, L):
        raise ValueError(f"b {tuple(b.shape)} / c {tuple(c.shape)} do not "
                         f"match x {tuple(x.shape)}")
    G = b.shape[2]
    if h_per_g < 1 or G * h_per_g != H:
        raise ValueError(f"H {H} != G {G} x h_per_g {h_per_g}")
    if chunk < 1 or L % chunk:
        raise ValueError(f"L {L} % chunk {chunk}")
    if pipeline < 1 or chunk % pipeline:
        raise ValueError(f"chunk {chunk} % pipeline {pipeline}")
    if len({t.device for t in (x, a, b, c)}) != 1:
        raise ValueError("inputs lie on different devices")
    return chunk // pipeline


def _segsum_exp(a_cs):
    """a_cs: (..., q) inclusive cumsum -> exp lower-tri decay (..., q, q)."""
    q = a_cs.shape[-1]
    seg = a_cs[..., :, None] - a_cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a_cs.device).tril()
    return torch.where(mask, torch.exp(seg), torch.zeros((), device=a_cs.device))


def _dot(eq: str, u, v, dtype):
    """An einsum of two operands in x's dtype, accumulated in f32 and
    rounded once to ``dtype``, as XLA's dot_general does."""
    return torch.einsum(eq, u.float(), v.float()).to(dtype)


def ssd_scan_plain(x, a, b, c, *, chunk: int, h_per_g: int,
                   pipeline: int = 1, return_final_state: bool = False):
    """The kernel's function in plain PyTorch: ``repro.models.ssm.
    ssd_chunked_xla`` op for op, over sub-chunks of ``chunk // pipeline``
    (the SSD function does not depend on the chunking). Same arguments
    and results as ``ssd_scan``."""
    Q = _check(x, a, b, c, chunk, pipeline, h_per_g)
    B, L, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    E, C, dt = h_per_g, L // Q, x.dtype
    xe = x.reshape(B, C, Q, G, E, Pd)
    ae = a.reshape(B, C, Q, G, E).permute(0, 3, 4, 1, 2)       # (B,G,E,C,Q)
    be = b.reshape(B, C, Q, G, N)
    ce = c.reshape(B, C, Q, G, N)
    a_cs = torch.cumsum(ae.float(), dim=-1)

    # intra-chunk
    cb = torch.einsum("bcqgn,bckgn->bcgqk", ce.float(), be.float())
    decay = _segsum_exp(a_cs)                                   # (B,G,E,C,Q,Q)
    cbl = cb[:, :, :, None] * decay.permute(0, 3, 1, 2, 4, 5)
    y_diag = _dot("bcgeqk,bckgep->bcqgep", cbl.to(dt), xe, dt)

    # chunk states: (decay_states * x) in x's dtype, then . b
    decay_states = torch.exp(a_cs[..., -1:] - a_cs).to(dt)      # (B,G,E,C,Q)
    dx = decay_states.permute(0, 3, 4, 1, 2)[..., None] * xe    # (B,C,Q,G,E,P)
    states = _dot("bckgep,bckgn->bcgepn", dx, be, dt)

    # state pass, f32 carry
    chunk_decay = torch.exp(a_cs[..., -1])                      # (B,G,E,C)
    state = torch.zeros((B, G, E, Pd, N), dtype=torch.float32, device=x.device)
    prev = []
    for ci in range(C):
        prev.append(state)
        state = state * chunk_decay[..., ci, None, None] + states[:, ci].float()
    prev_states = torch.stack(prev, dim=1)                      # (B,C,G,E,P,N)

    # inter-chunk: (prev_states . c) in x's dtype, times exp(a_cs)
    cs = _dot("bcgepn,bcqgn->bcgepq", prev_states.to(dt), ce, dt)
    y_off = torch.exp(a_cs).to(dt).permute(0, 3, 4, 1, 2)[..., None] * \
        cs.permute(0, 1, 5, 2, 3, 4)                           # (B,C,Q,G,E,P)

    y = (y_diag + y_off).reshape(B, L, H, Pd)
    if return_final_state:
        return y, state.reshape(B, H, Pd, N)
    return y


def ssd_scan(x, a, b, c, *, chunk: int, h_per_g: int, pipeline: int = 1,
             return_final_state: bool = False):
    """Mamba-2 SSD chunked scan in the model layout.

    x: (B, L, H, P) discretized inputs (x * dt), f32 or bf16
    a: (B, L, H) f32 discretized log decay (A * dt), <= 0
    b, c: (B, L, G, N) in x's dtype, H = G * h_per_g

    ``L % chunk`` and ``chunk % pipeline`` must be 0; the scan runs over
    sub-chunks of ``chunk // pipeline`` with the state carried, as the
    TPU kernel's ``pipeline`` does. Returns y (B, L, H, P) in x's dtype
    and, with ``return_final_state``, the f32 state after the last step,
    (B, H, P, N). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    """
    Q = _check(x, a, b, c, chunk, pipeline, h_per_g)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, b, c, chunk=chunk, h_per_g=h_per_g,
                              pipeline=pipeline,
                              return_final_state=return_final_state)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD-scan kernel for {x.device}")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not in {STATE_DIMS}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"x, b, c must share one of {list(DTYPES)}; got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"a must be torch.float32, got {a.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be unit-stride in its last dim")
    smem = 4 * (P * (N + 1) + 2 * TILE * (N + 1) + TILE * P
                + TILE * (TILE + 1) + Q)
    if smem > _build.SMEM_OPTIN_BYTES:
        raise ValueError(f"sub-chunk of {Q} steps does not fit in shared "
                         f"memory")
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if return_final_state else None)
    lib = _build.load("ssd_scan", _SIGNATURES)
    code = lib.ssd_scan_fwd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None,
        B, L, H, G, P, N, Q, DTYPES[x.dtype],
        *x.stride()[:3], *a.stride(), *b.stride()[:3], *c.stride()[:3],
        smem, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return (y, state) if return_final_state else y


ssd_scan.launches = 0
