"""Collective wire bytes under the ring model, and the captured view.

Port of ``repro.launch.collectives``. Every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute contributes per-device
*wire bytes* under the standard ring model, from its result size and the
participating group size G (:func:`ring_wire_bytes`):

    all-gather          out_bytes * (G-1)/G
    reduce-scatter      out_bytes * (G-1)
    all-reduce          2 * bytes * (G-1)/G
    all-to-all          bytes * (G-1)/G
    collective-permute  bytes                        (point-to-point)

The JAX package walks a traced per-shard jaxpr (``jaxpr_collectives``);
here :func:`captured_collectives` reads the collectives that a capture
(``core.hierarchy``) recorded, each with its scope path and the mesh
axes of its process group (``distributed.compat.group_axes``). The
operations are PyTorch's functional collectives (``_c10d_functional``:
what ``torch.distributed._functional_collectives`` dispatches) and, for
completeness, the in-place ``c10d`` ones. ``wait_tensor`` is no
collective and costs nothing.

Not ported: ``parse_collective_bytes`` and its replica-group parser read
a compiled TPU HLO module; they go with the lowering tooling (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# dispatcher operation name -> ring-model kind. A permute is an
# all_to_all_single with one nonzero split a side, so it is told apart by
# the caller (``compat.ppermute`` marks it; see ``collective_kind``).
PRIMITIVE_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "all-gather",
}
WAIT = "_c10d_functional.wait_tensor"


def op_name(func) -> str:
    """``namespace.name`` of an ``OpOverload`` (the PRIMITIVE_KINDS key)."""
    return f"{func.namespace}.{func.overloadpacket.__name__}"


def ring_wire_bytes(kind: str, nbytes: float, group_size: int) -> float:
    """Per-device wire bytes of one collective under the ring model.

    ``nbytes`` is the op's *result* size; ``group_size`` the number of
    participating devices. G == 1 collectives move nothing (except a
    self-permute, which still copies its payload).
    """
    g = max(int(group_size), 1)
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}; "
                     f"expected one of {COLLECTIVE_KINDS}")


@dataclass(frozen=True)
class CollectiveSite:
    """One collective operation in a captured per-shard program."""
    path: str                 # scope path (hierarchy join key)
    primitive: str            # dispatcher operation name
    kind: str                 # ring-model kind
    axes: Tuple[str, ...]     # mesh axes it runs over
    group_size: int           # participating devices G
    result_bytes: int         # per-shard result size
    wire_bytes: float         # ring-model per-device wire bytes


def captured_collectives(hierarchy, axis_sizes: Dict[str, int]
                         ) -> List[CollectiveSite]:
    """Every collective site the capture recorded (one per site, as a
    jaxpr equation: a collective in a loop body counts once), priced by
    the ring model for ``axis_sizes``."""
    sites = []
    for c in hierarchy.collectives:
        g = 1
        for a in c.axes:
            g *= int(axis_sizes.get(a, 1))
        sites.append(CollectiveSite(
            path=c.path, primitive=c.primitive, kind=c.kind, axes=c.axes,
            group_size=g, result_bytes=c.out_bytes,
            wire_bytes=ring_wire_bytes(c.kind, c.out_bytes, g)))
    return sites
