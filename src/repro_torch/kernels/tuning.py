"""Tuned kernel defaults: the bridge from DSE results to production.

Port of ``repro.kernels.tuning`` (a copy: the JAX module imports no JAX;
its cache is ``repro_torch.core.incremental.EvalCache``). The autotuner
(``repro_torch.core.dse.DSEEngine`` / ``python -m repro_torch.tune``)
keeps winning configurations in the on-disk evaluation cache; this
module holds the process-wide "active" tuned configurations that the
``ops`` wrappers consult when the caller does not pin a value::

    from repro_torch.kernels import ops, tuning
    tuning.load_cache("flash_attention")     # or serve / train --autotune
    ops.flash_attention(q, k, v)             # runs at the tuned tiles

Explicit keyword arguments always win over tuned defaults, and tuned
defaults win over the static module defaults, as RealProbe's DSE feeds
resource reallocations back into the next synthesis run. Unlike the
JAX registry, a tuned config is kept at the input shapes it was tuned
at (``shape_key``) and applied only to calls of those shapes: a tile
that wins at one shape can be the slowest at another.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

# kernel id -> {shape key ("" for any shape): {axis name: value}}
_TUNED: Dict[str, Dict[str, Dict[str, Any]]] = {}

KERNEL_IDS = ("flash_attention", "ssd_scan", "paged_attention")


def shape_key(kernel_id: str, args: Sequence[Any]) -> str:
    """The input shapes a tuned configuration belongs to: each tensor
    argument's (shape, dtype) in order, the paged pools without their
    page count (the pool's size is not the call's work). A tile tuned at
    one shape is only applied to calls of that shape."""
    dims = []
    for i, t in enumerate(args):
        if not hasattr(t, "shape"):
            continue
        shape = tuple(t.shape)
        if kernel_id == "paged_attention" and i in (1, 2):
            shape = shape[1:]
        dims.append((shape, str(t.dtype)))
    return str(dims)


def set_tuned(kernel_id: str, config: Dict[str, Any],
              shape: str = "") -> None:
    """Install ``config`` as the tuned defaults for ``kernel_id`` at the
    calls of ``shape`` (a ``shape_key``; "" for calls of any shape)."""
    _TUNED.setdefault(kernel_id, {})[shape] = dict(config)


def clear_tuned(kernel_id: Optional[str] = None) -> None:
    if kernel_id is None:
        _TUNED.clear()
    else:
        _TUNED.pop(kernel_id, None)


def tuned(kernel_id: str, args: Optional[Sequence[Any]] = None
          ) -> Dict[str, Any]:
    """The tuned config for a call on ``args``: the one installed at
    their shape, else the one for any shape, else {}."""
    by_shape = _TUNED.get(kernel_id)
    if not by_shape:
        return {}
    cfg = None
    if args is not None and len(by_shape) > ("" in by_shape):
        cfg = by_shape.get(shape_key(kernel_id, args))
    return dict(cfg if cfg is not None else by_shape.get("", {}))


def tuned_value(kernel_id: str, axis: str, default,
                args: Optional[Sequence[Any]] = None):
    """Resolve one axis for a call on ``args``: explicit caller value
    (pass it, not this) > tuned default > static default."""
    return tuned(kernel_id, args).get(axis, default)


def load_cache(kernel_id: Optional[str] = None, *,
               cache_dir: Optional[str] = None, device: Optional[str] = None,
               verbose: bool = False) -> Dict[str, Dict[str, Any]]:
    """Pull the cached winners into the registry, each at the shape it
    was tuned at. Returns what loaded (kernel id -> {shape key: config};
    "" keys a hand-written cache's config, which has no shape); kernels
    with no cache entries are left on static defaults. ``device`` is the
    device kind the winners were tuned on (``incremental.device_kind``;
    default: this process's card, or "cpu"). ``verbose`` prints what
    happened (the --autotune banner shared by serve / train)."""
    from repro_torch.core.incremental import EvalCache
    cache = EvalCache(cache_dir)
    loaded = {}
    for kid in ([kernel_id] if kernel_id else KERNEL_IDS):
        won = cache.winners(kid, device)
        if not won:
            best = cache.best_config(kid, device)
            won = {"": best} if best is not None else {}
        for shape, cfg in won.items():
            set_tuned(kid, cfg, shape)
        if won:
            loaded[kid] = won
    if verbose:
        for kid, won in loaded.items():
            for shape, cfg in won.items():
                print(f"[autotune] {kid}: {cfg}"
                      + (f" at {shape}" if shape else ""))
        if not loaded:
            print("[autotune] no cached configs — run `python -m "
                  "repro_torch.tune` first; using static defaults")
    return loaded
