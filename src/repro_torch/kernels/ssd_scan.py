"""Mamba-2 SSD chunked scan: CUDA kernels for Hopper and their plain
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
only) is ~13 GFLOP, ~13 us on the bf16 tensor cores.

The design: two launches (``KERNELS``), so that only the f32 carry runs
in chunk order and the rest spreads over 256-1024 CTAs.

1. ``ssd_state_kernel``, a CTA per (half of the state rows, pair of heads
   of one group, batch row), 256 at the serving shape, streams the
   sequence in tiles of 64 steps: a_cs over each chunk (taken here only,
   by one routine, and written to scratch for the scan), the chunk's own
   state ``S = sum_k exp(a_cs[-1]-a_cs[k]) x_k b_k^T`` on the tensor
   cores (one b tile for both heads), and at each chunk's end the f32
   carry in chunk order, ``prev[c] = state; state = exp(a_cs[-1]) state
   + S``, kept in registers, as the old single kernel carried it. prev is
   written in x's dtype, the final state in f32. (The chunk states and
   the carry were two passes in a first version; fused, S never goes to
   device memory.)
2. ``ssd_chunk_scan_kernel``, a CTA per (64-row q tile, chunk, batch row,
   group, block of 4 heads of the group), 1024 at the serving shape,
   heaviest q tiles first, two CTAs an SM: the c . b^T tile once per key
   tile for every head of the block (8x per group and chunk at
   mamba2-370m, not 32x), masked by the decay for k <= q only, then
   ``y = exp(a_cs[q]) c_q . prev^T + (c.b^T o decay) x``. The decay is
   taken per element only on each warp's diagonal block of 16 keys (the
   exponent clamped to <= 0, so the value the select discards above the
   diagonal cannot overflow); below it, it is ``exp(a_cs[q]-a_cs[kend])
   exp(a_cs[kend]-a_cs[k])`` (kend the 16-key block's last step), two
   factors <= 1 for a <= 0 taken once a tile; above it the products are
   skipped. y leaves through shared memory in 16-byte rows.

bf16 products run on the tensor cores (``mma.sync.m16n8k16``, bf16
operands by ``ldmatrix``, f32 accumulators) over 64-row tiles staged by
16-byte ``cp.async`` (rows past the chunk zero-filled, so any Q works).
x, b, c must be unit-stride in their last dim with 16-byte aligned rows
(base pointer and strides); a view that is not raises ``ValueError``.
The f32 instantiation runs the same kernels with every product as f32
FMAs on the CUDA cores. Scratch per call (allocated here): a_cs
(B, H, L) f32 and prev (B, H, nc-1, P, N) in x's dtype.

Layout: the wrapper hands the kernels the model layout, x (B, L, H, P),
a (B, L, H), b/c (B, L, G, N), through their strides. It does not
transpose to (B, H, L, P) as the JAX adapter (``ops._ssd_jit``) does:
that would move x and y through device memory once more, and b/c arrive
as strided views of the conv output.

Rounding contract (bf16 inputs). x, b, c are exact in bf16, so c . b^T,
c . prev^T and the products into S are exact products summed in f32.
Where bf16 rounds:
- ``v = exp(a_cs[-1]-a_cs[k]) x_k`` (f32) is split into three bf16 parts
  (``p1 = bf16(v)``, ``p2 = bf16(v - p1)``, ``p3 = bf16(v - p1 - p2)``,
  together v exactly) and S takes the three products: S and the f32
  carry meet 2e-5 of max|state| against the plain version on f32 copies
  (two parts, hi/lo, also meet it at the serving shape, but not 1e-5 in
  every case of ``tests/test_torch_cuda.py``);
- ``L = (c . b^T) o decay`` is rounded once to bf16 for the L x product,
  and prev once to bf16 (stored so) for the c . prev^T product; the
  plain version rounds both (``cbl``, ``prev_states``) as well;
- y is rounded once to bf16 from its f32 accumulator.
y then meets 8e-3 of max|y| against f32 copies and ``ssd_ref``
(``tests/test_torch_ssm.py`` emulates this arithmetic on the CPU and
holds it to those bounds). Against the plain version on the same bf16
inputs, which also rounds the decay, the decayed x and the chunk states
to bf16, ``chip_smoke.py`` allows 2e-2 (y) and 1e-2 (state). f32 inputs
stay in f32 throughout (1e-5 against the plain version on the card).

Determinism contract: every CTA works on one batch row, in fixed loop
orders, with no atomics on the data path, and a_cs is taken by one
routine and read by both kernels; so row b of a batched call is bitwise
equal to a batch-1 call on row b.

Counter block (grid-step probing, ``ssd_plan``): asked for by a probed
region, the chunk-scan kernel adds one, per (b, h), for each sub-chunk
of ``chunk // pipeline`` steps it scans, into an int32 (B, H, L/chunk)
count of the TPU kernel's chunk it belongs to (an integer atomic, so the
count does not depend on the CTAs' order). Without it the launches are
the unprobed ones.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import kernelprobe as kp
from repro_torch.core import scope
from repro_torch.kernels import _build

HEAD_DIMS = (64,)              # P the kernel takes (mamba2, zamba2)
STATE_DIMS = (64, 128)         # N the kernel takes (zamba2, mamba2)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # x / b / c / y
# the kernels one call launches, in order (csrc/ssd_scan.cu)
KERNELS = ("ssd_state_kernel", "ssd_chunk_scan_kernel")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"ssd_scan_fwd": [_P] * 9 + [_I] * 9 + [_L] * 12 + [_I, _P],
               "ssd_scan_smem": [_I, _I, _I]}


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
                   pipeline: int = 1, return_final_state: bool = False,
                   with_counts: bool = False):
    """The kernel's function in plain PyTorch: ``repro.models.ssm.
    ssd_chunked_xla`` op for op, over sub-chunks of ``chunk // pipeline``
    (the SSD function does not depend on the chunking). Same arguments
    and results as ``ssd_scan``; ``with_counts`` appends the counter
    block the kernel writes (every sub-chunk scanned)."""
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
    res = [y]
    if return_final_state:
        res.append(state.reshape(B, H, Pd, N))
    if with_counts:
        res.append(torch.full((B, H, L // chunk), pipeline,
                              dtype=torch.int32, device=x.device))
    return res[0] if len(res) == 1 else tuple(res)


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
    the two kernels of ``KERNELS`` or raise; ``meta`` tensors (a dry run)
    get the kernels' outputs, empty, and launch nothing. ``launches``
    counts calls that launched them.
    """
    Q = _check(x, a, b, c, chunk, pipeline, h_per_g)
    with scope.kernel_region(
            "ssd_scan",
            lambda: ssd_cost(x, a, b, c, chunk, return_final_state),
            lambda: ssd_plan(x, b, chunk, pipeline)) as region:
        res = _ssd(x, a, b, c, Q, chunk, h_per_g, pipeline,
                   return_final_state, region.probed)
        if not region.probed:
            return res
        region.fold(res[-1])
        return res[0] if len(res) == 2 else res[:-1]


def ssd_plan(x, b, chunk: int, pipeline: int):
    """The TPU kernel's grid for grid-step probing (``core.kernelprobe``):
    (B, H, L/chunk), the chunk axis sequential, as ``_ssd_kernel``. Per
    step: the x, a, b, c and y blocks of the chunk move at the grid node;
    ``init`` zeroes the (P, N) state at the first chunk; ``sub_chunk``
    costs one sub-chunk's scan (its c.b, decayed products, state update)
    for each sub-chunk the kernel counts in that chunk (``pipeline`` of
    them)."""
    B, L, H, P = x.shape
    N = b.shape[3]
    es, nc, Q = x.element_size(), L // chunk, chunk // pipeline
    skip = cm.roofline_cycles(1, 0)
    init = cm.roofline_cycles(P * N, 4 * P * N)
    sub = cm.roofline_cycles(
        2 * Q * Q * (N + P) + 4 * Q * P * N + 8 * (Q * Q + 2 * Q)
        + 4 * Q * Q + 3 * P * N,
        es * (2 * Q * P + 2 * Q * N) + 4 * Q + 2 * 4 * P * N)

    def expected():
        return np.full((B, H, nc), pipeline, np.int32)

    return kp.GridPlan(
        body="ssd_kernel", grid=(B, H, nc),
        transfer=cm.transfer_cycles(es * (2 * chunk * P + 2 * chunk * N)
                                    + 4 * chunk),
        scopes=(kp.GridScope("init", kp.FIRST, (skip, init), ops=1),
                kp.GridScope("sub_chunk", kp.COUNT,
                             tuple(i * sub for i in range(pipeline + 1)),
                             ops=7 * pipeline)),
        counter_shape=(B, H, nc), expected=expected, mirror=expected)


def _ld(width: int, itemsize: int) -> int:
    """A staged row's padded length (``ld<E, W>`` of the source)."""
    return width + 16 // itemsize


def ssd_smem_bytes(itemsize: int, N: int, Q: int) -> int:
    """Dynamic shared memory of the larger of the two kernels' CTAs for
    sub-chunks of ``Q`` steps (``ssd_scan_smem`` of the source, term for
    term): 0 for a (dtype, N) the kernels do not take. The state kernel
    stages two tiles of b and of two heads' x halves (bf16 inputs also
    three bf16 parts of the decayed x) and four chunks of a for its two
    heads; the scan kernel a c tile, the union of the prev states and a
    stage of b and x tiles, the decay block and a for its four heads."""
    if N not in STATE_DIMS or itemsize not in (2, 4):
        return 0
    T, P, PH, SH, HB, NKB = 64, 64, 32, 2, 4, 4
    tiles = -(-Q // T) * T
    state = (2 * T * (_ld(N, itemsize) + SH * _ld(PH, itemsize)) * itemsize
             + (0 if itemsize == 4 else SH * 3 * T * _ld(PH, 2) * 2)
             + SH * 4 * tiles * 4)
    stage = T * (_ld(N, itemsize) + HB * _ld(P, itemsize))
    scan = ((T * _ld(N, itemsize) + max(HB * P * _ld(N, itemsize), stage))
            * itemsize + (T * (T + 4) + HB * tiles + HB * T * (NKB + 1)) * 4)
    return max(state, scan)


def ssd_resources(itemsize: int, N: int, chunk: int, pipeline: int = 1):
    """What one CTA of the kernels needs of the card at this chunk
    (``costmodel.KernelResources``): ``ssd_smem_bytes`` of its
    sub-chunk and the kernels' 256 threads."""
    return cm.KernelResources(
        smem_bytes=ssd_smem_bytes(itemsize, N, chunk // pipeline),
        threads=256)


def ssd_cost(x, a, b, c, chunk: int, return_final_state: bool):
    """(FLOPs, bytes) of one call, as its bound counts them: c . b once
    per group and chunk and (L o decay) x over the causal triangle of
    each chunk, c . state and the state update per step; x, b, c, a read
    once, y (and the f32 state) written once."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc, tri = L // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * (B * G * nc * tri * N + B * H * nc * tri * P
                   + 2 * B * H * L * P * N)
    nbytes = (x.element_size() * (2 * x.numel() + b.numel() + c.numel())
              + 4 * a.numel() + (4 * B * H * P * N if return_final_state
                                 else 0))
    return flops, float(nbytes)


def _ssd(x, a, b, c, Q: int, chunk: int, h_per_g: int, pipeline: int,
         return_final_state: bool, with_counts: bool = False):
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, b, c, chunk=chunk, h_per_g=h_per_g,
                              pipeline=pipeline,
                              return_final_state=return_final_state,
                              with_counts=with_counts)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD-scan kernel for {x.device}")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if x.device.type == "cuda":
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
            if (t.data_ptr() % 16 or any(
                    st * t.element_size() % 16
                    for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)):
                raise ValueError(f"rows of {name} are not 16-byte aligned "
                                 f"(strides {t.stride()}): the kernels copy "
                                 f"them by 16-byte cp.async")
        lib = _build.load("ssd_scan", _SIGNATURES)
        if lib.ssd_scan_smem(DTYPES[x.dtype], N, Q) > _build.SMEM_OPTIN_BYTES:
            raise ValueError(f"sub-chunk of {Q} steps does not fit in shared "
                             f"memory")
    nc = L // Q
    dev = x.device
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
             if return_final_state else None)
    acs = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    prev = torch.empty((B, H, max(nc - 1, 1), P, N), dtype=x.dtype,
                       device=dev)
    counts = (torch.zeros((B, H, L // chunk), dtype=torch.int32, device=dev)
              if with_counts else None)
    res = [y] + ([state] if return_final_state else []) + (
        [counts] if with_counts else [])
    if dev.type == "meta":          # a dry run: the outputs, no launch
        return res[0] if len(res) == 1 else tuple(res)
    code = lib.ssd_scan_fwd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None, acs.data_ptr(),
        prev.data_ptr(), counts.data_ptr() if with_counts else None,
        B, L, H, G, P, N, Q, DTYPES[x.dtype], pipeline,
        *x.stride()[:3], *a.stride(), *b.stride()[:3], *c.stride()[:3],
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return res[0] if len(res) == 1 else tuple(res)


ssd_scan.launches = 0
