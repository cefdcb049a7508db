"""Inlining policies (paper §IV-F) mapped to scope selection.

Port of ``repro.core.inline`` (the port keeps its own copy; it imports
nothing of ``repro``). Vitis HLS inlines small functions, destroying
probe targets; RealProbe counters this with three policies. Here a scope
too small to be worth a probe is one with few aten operations:

- ``default``:  scopes with fewer than ``SMALL_SCOPE_EQNS`` operations in
  their subtree are attributed to their parent (not probeable).
- ``off_all``:  every scope is probeable (most detailed view).
- ``off_top``:  full detail inside the pragma targets' subtrees, default
  collapsing elsewhere.

The JAX package counts jaxpr equations and this port counts aten
operations, so a scope near the threshold can fall on different sides
of it in the two packages; ``off_all`` selects the same paths in both.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.hierarchy import Hierarchy, ScopeNode

SMALL_SCOPE_EQNS = 3


def _subtree_eqns(node: ScopeNode) -> int:
    return sum(n.n_eqns for n in node.walk())


def selectable_paths(h: Hierarchy, policy: str,
                     targets: Tuple[str, ...]) -> List[str]:
    """Scope paths eligible for probes under an inlining policy."""
    if policy not in ("default", "off_all", "off_top"):
        raise ValueError(f"unknown inline policy {policy!r}")
    tset = [t.strip("/") for t in targets]

    def in_target(path: str) -> bool:
        return any(path == t or path.startswith(t + "/") or t == ""
                   for t in tset)

    out: List[str] = []
    for node in h.root.walk():
        if not node.path:
            continue
        if policy == "off_all":
            out.append(node.path)
            continue
        keep_detail = policy == "off_top" and in_target(node.path)
        if keep_detail or node.kind in ("loop", "while", "cond"):
            out.append(node.path)
            continue
        if _subtree_eqns(node) >= SMALL_SCOPE_EQNS:
            out.append(node.path)
    return out
