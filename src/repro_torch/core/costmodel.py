"""Deterministic H100 analytical cycle model (the profiler's model clock).

Port of ``repro.core.costmodel`` for eager PyTorch: every aten operation
that reaches the dispatcher gets an integer cycle cost from its FLOPs
and bytes against the constants below, the same formula
(``roofline_cycles``) as the JAX package. The same table drives the
capture's segment cycles (``core.hierarchy``), the oracle's live count
(``core.oracle``) and the static estimate of each scope.

Constants: the NVIDIA H100 SXM data sheet, as ``chip_smoke.py`` prices
each kernel's bound: 989e12 dense bf16 tensor-core FLOP/s, 3.35e12 B/s
HBM3, a 1.98 GHz boost clock, NVLink at 450e9 B/s per direction for
the interconnect term.

Collectives (the JAX package's collective term): a functional collective
(``_c10d_functional``, see ``launch.collectives``) over mesh axes of
sizes in context (``collective_axis_sizes``, set by ``core.meshprobe``)
costs ``ceil(ring_wire_bytes(kind, out_bytes, G))`` comm bytes at
``LINK_BYTES_PER_CYCLE``, G the product of its group's axis sizes
(``distributed.compat.group_axes``); outside that context it costs its
input bytes, as JAX's fallback does. Its FLOPs are its output's size.
``wait_tensor`` is no operation of the device (0 cycles). A program with
no collective prices as it did before the term existed.

Pricing of an aten operation (``op_cost``), as ``eqn_cost`` prices a
jaxpr primitive:

- ``mm``/``bmm``/``addmm``/``baddbmm``/``addbmm``/``linear``: 2 M N K
  FLOPs (times the batch);
- transcendentals (exp, log, tanh, sigmoid, silu, softplus, rsqrt, ...):
  8 FLOPs per output element;
- reductions (sum, mean, amax, argmax, cumsum, ...): the input's size;
- anything else: its output's size;
- bytes: every tensor read plus every tensor written (an in-place
  operation counts its target on both sides).

Views (``view``, ``t``, ``transpose``, ``expand``, ``select``, ``slice``,
``_unsafe_view``, ...) cost 0 cycles: in PyTorch they move no bytes and
only change a tensor's metadata. (JAX prices a reshape by its bytes,
since XLA may copy; the two clocks differ there on purpose.) A hand
kernel's region (``scope.kernel_region``) is priced once from the FLOPs
and bytes its wrapper states, whatever route runs it. With grid-step
probing (``core.kernelprobe``) a matched region is priced step by step
instead: each inner scope's per-step work through ``roofline_cycles``
from its per-block FLOPs and bytes, and the step's block transfer at the
grid node through ``transfer_cycles``, the one definition of that term.

Host read-outs (``_local_scalar_dense``: ``.item()``, ``bool(t)``) are
not device operations here: the markers read branch predicates with
them, which a jaxpr does not.

For design-space exploration (``core.dse``): ``KernelResources`` is what
one candidate kernel configuration needs of the card, and
``DeviceBudget`` the H100's ceilings in place of the TPU's VMEM: shared
memory a block may have (232,448 bytes dynamic, opted in; 49,152
static), threads a block (1024) and registers an SM (65,536). A CUDA kernel's footprint cannot
be walked from a jaxpr, so each kernel wrapper states it by the formula
of its source (``flash_resources``, ``paged_resources``). The kernel
calibration (``set_kernel_calibration``) scales a kernel body's flat
cycles by a measured ratio, as the JAX package scales its Pallas body
term; a region is flat-priced as one operation here, so the whole flat
term is scaled.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

# -------------------------------------------------- hardware constants
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
LINK_BW = 450e9                   # NVLink bytes/s per direction
CLOCK_HZ = 1.98e9                 # boost clock

FLOPS_PER_CYCLE = PEAK_FLOPS_BF16 / CLOCK_HZ      # ~499495
HBM_BYTES_PER_CYCLE = HBM_BW / CLOCK_HZ           # ~1692
LINK_BYTES_PER_CYCLE = LINK_BW / CLOCK_HZ         # ~227

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "linear", "matmul"}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh",
    "sigmoid", "silu", "gelu", "softplus", "erf", "erfc", "erfinv", "sin",
    "cos", "tan", "pow", "rsqrt", "sqrt", "atan2", "digamma", "lgamma",
    "_softmax", "_log_softmax", "logit", "mish", "elu", "selu",
}
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "aminmax", "argmax",
    "argmin", "prod", "var", "var_mean", "std", "std_mean", "norm",
    "linalg_vector_norm", "any", "all", "cumsum", "cumprod", "cummax",
    "cummin", "logcumsumexp", "logsumexp", "nansum", "count_nonzero",
}
_SORT = {"sort", "topk", "argsort", "kthvalue", "median"}
# aliases the schema does not mark as views
_FREE = {"_unsafe_view", "_reshape_alias", "lift_fresh_copy"}
# host read-outs: not device operations (see the module docstring)
SKIP = {"_local_scalar_dense"}


def roofline_cycles(flops: int, total_bytes: int, comm_bytes: int = 0) -> int:
    """The model's single cycle formula: the max of the compute, memory
    and interconnect terms, never below one cycle."""
    return max(1, int(math.ceil(max(flops / FLOPS_PER_CYCLE,
                                    total_bytes / HBM_BYTES_PER_CYCLE,
                                    comm_bytes / LINK_BYTES_PER_CYCLE))))


@dataclass(frozen=True)
class OpCost:
    flops: int
    bytes: int
    comm_bytes: int
    cycles: int


FREE = OpCost(0, 0, 0, 0)


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> int:
    if name in ("addmm", "baddbmm", "addbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if name == "linear":                 # x (..., K) @ w (N, K)^T
        return 2 * a.numel() * b.shape[0]
    # (..., M, K) @ (..., K, N): 2 * batch * M * N * K
    return 2 * a.numel() * b.shape[-1]


# Mesh axis sizes for the collective term (``collective_axis_sizes``);
# None: the operand-bytes fallback.
_AXIS_SIZES: "contextvars.ContextVar[Optional[Dict[str, int]]]" = \
    contextvars.ContextVar("repro_torch_collective_axis_sizes", default=None)


@contextlib.contextmanager
def collective_axis_sizes(sizes: Optional[Dict[str, int]]):
    """Cost collectives against these mesh axis sizes (ring wire model)."""
    tok = _AXIS_SIZES.set(dict(sizes) if sizes is not None else None)
    try:
        yield
    finally:
        _AXIS_SIZES.reset(tok)


def current_axis_sizes() -> Optional[Dict[str, int]]:
    return _AXIS_SIZES.get()


def collective_comm_bytes(kind: str, axes: Tuple[str, ...],
                          in_bytes: int, out_bytes: int) -> int:
    """Comm bytes of one collective under the CURRENT axis-size context:
    the ring wire model when mesh axis sizes are in context, the
    operand-bytes fallback otherwise. Keyed by ring-model kind (the JAX
    package keys by primitive; a permute here is an all_to_all_single,
    told apart by its caller)."""
    sizes = _AXIS_SIZES.get()
    if sizes is None:
        return in_bytes
    from repro_torch.launch.collectives import ring_wire_bytes
    g = 1
    for a in axes:
        g *= int(sizes.get(a, 1))
    return int(math.ceil(ring_wire_bytes(kind, out_bytes, g)))


@dataclass(frozen=True)
class CollectiveOp:
    """One collective as a capture records it (``launch.collectives``)."""
    path: str
    primitive: str
    kind: str
    axes: Tuple[str, ...]
    in_bytes: int
    out_bytes: int


def collective_of(func, args, kwargs, out) -> Optional[CollectiveOp]:
    """The collective a dispatcher operation is (path left empty), or
    None for any other operation, ``wait_tensor`` included."""
    if func.namespace not in ("_c10d_functional", "c10d"):
        return None
    from repro_torch.distributed import compat
    from repro_torch.launch.collectives import PRIMITIVE_KINDS, op_name
    name = op_name(func)
    kind = PRIMITIVE_KINDS.get(name)
    if kind is None:
        return None
    if kind == "all-to-all" and compat.is_permute():
        kind = "collective-permute"
    group = kwargs.get("group_name", args[-1] if args else None)
    axes = compat.group_axes(group) if isinstance(group, str) else ()
    ins = list(_tensors(args)) + list(_tensors(kwargs))
    outs = list(_tensors(out))
    return CollectiveOp(path="", primitive=name, kind=kind, axes=axes,
                        in_bytes=sum(_nbytes(t) for t in ins),
                        out_bytes=sum(_nbytes(t) for t in outs))


def collective_cost(c: CollectiveOp, out) -> OpCost:
    comm = collective_comm_bytes(c.kind, c.axes, c.in_bytes, c.out_bytes)
    flops = max((t.numel() for t in _tensors(out)), default=0)
    total = c.in_bytes + c.out_bytes
    return OpCost(flops=int(flops), bytes=int(total), comm_bytes=int(comm),
                  cycles=roofline_cycles(int(flops), int(total), int(comm)))


def is_view(func) -> bool:
    return bool(getattr(func, "is_view", False)) or (
        func.overloadpacket.__name__ in _FREE)


def op_cost(func, args, kwargs, out) -> OpCost:
    """Flat cost of one aten operation (``func`` an ``OpOverload``)."""
    if is_view(func):
        return FREE
    if func.namespace in ("_c10d_functional", "c10d"):
        c = collective_of(func, args, kwargs, out)
        return FREE if c is None else collective_cost(c, out)
    name = func.overloadpacket.__name__
    ins = list(_tensors(args)) + list(_tensors(kwargs))
    outs = list(_tensors(out))
    total_bytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    if name in _MATMUL:
        flops = _matmul_flops(name, args)
    elif name in _TRANSCENDENTAL:
        flops = 8 * max((t.numel() for t in outs), default=0)
    elif name in _REDUCTION:
        flops = max((t.numel() for t in ins), default=0)
    elif name in _SORT:
        n = max((t.numel() for t in ins), default=1)
        flops = int(n * max(1, math.log2(max(n, 2))))
    else:
        flops = max((t.numel() for t in outs), default=0)
    return OpCost(flops=int(flops), bytes=int(total_bytes), comm_bytes=0,
                  cycles=roofline_cycles(int(flops), int(total_bytes)))


# Measured calibration of a kernel body's flat cycles (``DSEEngine.
# calibrate``), keyed by body name ('flash_kernel'); process-wide, like the
# tuned-config registry (``kernels.tuning``).
_KERNEL_CALIB: Dict[str, float] = {}


def set_kernel_calibration(kernel: str, scale: float) -> None:
    """Scale the flat cycles of kernel body ``kernel`` by measured /
    static."""
    _KERNEL_CALIB[kernel] = float(scale)


def clear_kernel_calibration(kernel: Optional[str] = None) -> None:
    if kernel is None:
        _KERNEL_CALIB.clear()
    else:
        _KERNEL_CALIB.pop(kernel, None)


def kernel_calibration(kernel: str) -> float:
    return _KERNEL_CALIB.get(kernel, 1.0)


def kernel_calibration_state() -> Tuple[Tuple[str, float], ...]:
    """The installed calibration, canonically ordered: DSE cache keys
    include it, so calibrated and uncalibrated model-clock cycles never
    share a key."""
    return tuple(sorted(_KERNEL_CALIB.items()))


def flat_kernel_cycles(kernel: Optional[str], cycles: int) -> int:
    """A kernel region's flat cycles under the installed calibration of
    its body (the one definition the capture, the oracle and
    ``tracesim.price`` share)."""
    scale = kernel_calibration(kernel) if kernel else 1.0
    if scale != 1.0:
        return max(1, int(round(cycles * scale)))
    return int(cycles)


# ------------------------------------------- kernel resource footprints
SMEM_BYTES = 232448               # dynamic shared memory a block may opt in to
STATIC_SMEM_BYTES = 49152         # static shared memory a block may have
THREADS_PER_BLOCK = 1024
REGISTERS_PER_SM = 65536


@dataclass(frozen=True)
class KernelResources:
    """What one candidate kernel configuration needs of the card (the
    analogue of the paper's post-synthesis LUT/FF/BRAM report): a CTA's
    dynamic and static shared memory, threads and registers, and the
    call's modeled traffic, FLOPs, grid steps and flat cycles."""
    smem_bytes: int = 0
    static_smem_bytes: int = 0
    threads: int = 0
    registers: int = 0
    hbm_bytes: int = 0
    flops: int = 0
    grid_steps: int = 0
    static_cycles: int = 0


@dataclass(frozen=True)
class DeviceBudget:
    """Hard per-candidate ceilings (``None`` disables one): the H100's
    dynamic and static shared memory a block, threads a block and
    registers an SM, and optional traffic and FLOP ceilings."""
    smem_bytes: Optional[int] = SMEM_BYTES
    static_smem_bytes: Optional[int] = STATIC_SMEM_BYTES
    threads: Optional[int] = THREADS_PER_BLOCK
    registers: Optional[int] = REGISTERS_PER_SM
    hbm_bytes: Optional[int] = None
    flops: Optional[int] = None

    def violations(self, r: KernelResources) -> Tuple[str, ...]:
        out = []
        for name, unit in (("smem_bytes", "B"), ("static_smem_bytes", "B"),
                           ("threads", ""),
                           ("registers", ""), ("hbm_bytes", "B"),
                           ("flops", "")):
            cap, got = getattr(self, name), getattr(r, name)
            if cap is not None and got > cap:
                label = name[:-6] if name.endswith("_bytes") else name
                out.append(f"{label} {got}{unit} > {cap}{unit}")
        return tuple(out)

    def fits(self, r: KernelResources) -> bool:
        return not self.violations(r)


def transfer_cycles(block_bytes: int) -> int:
    """Cycles of one grid step's block transfer (the HBM term alone),
    the port's ``pallas_dma_cycles``: the grid-step plans price their
    grid node with it, and the capture, the run and the oracle all read
    the plan's value."""
    return int(math.ceil(int(block_bytes) / HBM_BYTES_PER_CYCLE))


def kernel_cost(flops: float, nbytes: float,
                body: Optional[str] = None) -> OpCost:
    """Cost of one hand-kernel region from its stated FLOPs and bytes,
    under the calibration of its ``body`` (if named)."""
    f, b = int(flops), int(nbytes)
    return OpCost(flops=f, bytes=b, comm_bytes=0,
                  cycles=flat_kernel_cycles(body, roofline_cycles(f, b)))
