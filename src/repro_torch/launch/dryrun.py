"""Dry run: trace every (architecture x input shape) cell on the
production meshes with no card, and keep the roofline's raw material.

Port of ``repro.launch.dryrun``. JAX lowers and compiles each cell's step
for 256 or 512 fake host devices and reads XLA's per-device cost and
memory analyses. Here each cell's step runs once on the ``meta`` device
(shapes and dtypes, no data, nothing computed) as rank 0 of a fake world
of 256 or 512 ranks (``launch.mesh.make_production_mesh``): parameters,
optimizer state, batch and cache are DTensors placed by
``distributed.sharding``'s rule sets, whose local blocks are meta
tensors, and ``launch.hlo_cost.analyze`` counts what the rank runs.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
                                        [--mesh 16x16|2x16x16|1] [--force]

Per cell it records the per-device FLOPs and bytes (``core.costmodel``
pricing, each kernel region at its stated cost), the collectives by kind
with their ring-model wire bytes, the live-bytes memory record and the
trace time. Mesh ``"1"`` is one device with no process group (the card
check in ``chip_smoke.py`` step 19 runs the same step on an H100 under
the same counter).

The record keys are JAX's, but for two: ``trace_s`` stands for
``lower_s`` / ``compile_s`` (nothing is compiled), and
``raw_cost_analysis`` holds ``torch.utils.flop_counter``'s count (torch's
own count of the products, independent of the pricing table;
``bytes_accessed`` None: torch counts no bytes), where JAX keeps XLA's
``cost_analysis``, which does not multiply loops by their trip counts.

Results are cached as JSON under ``build/dryrun/`` keyed by (arch, shape,
mesh); completed cells are skipped on re-runs, so the sweep resumes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs.registry import CONFIGS, get_config
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import P
from repro_torch.distributed.steps import (build_decode_step,
                                           build_prefill_step,
                                           build_train_step)
from repro_torch.launch.hlo_cost import analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.quantized import QTensor

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = ("16x16", "2x16x16", "1")
CHIPS = {"16x16": 256, "2x16x16": 512, "1": 1}
SKIP_TEXT = ("full-attention arch at 500k ctx (sub-quadratic required; "
             "DESIGN.md)")


def _rules_for(shape_name: str, kind: str):
    if kind == "train" or kind == "prefill":
        return shd.TRAIN_RULES
    if shape_name == "long_500k":
        return shd.SERVE_LONG_RULES
    return shd.SERVE_RULES


def _batch_pspec(specs, rules, cfg, mesh):
    """The batch's specs: the batch dim over the batch axes (the M-RoPE
    (3, B, S) positions on their second dim)."""
    def spec(s):
        if len(s.shape) == 0:
            return P()
        if cfg.pos_emb == "mrope" and len(s.shape) == 3 and s.shape[0] == 3:
            return shd.to_pspec((None, "batch", "seq"), rules,
                                shape=s.shape, mesh=mesh)
        parts = ["batch"] + [None] * (len(s.shape) - 1)
        return shd.to_pspec(tuple(parts), rules, shape=s.shape, mesh=mesh)
    return {k: spec(v) for k, v in specs.items()
            if isinstance(v, torch.Tensor)}


def abstract_opt_state(model: Model, params_abs):
    """The AdamW state of ``params_abs`` (on their device: meta)."""
    return adamw.init(params_abs, model.cfg.moment_dtype)


def opt_shardings(mesh, pspecs, moment_dtype: str):
    """AdamWState of placements mirroring the param pspecs (an int8
    moment's scales, (..., 1), unsharded on their last dim); the step
    count None: it stays a plain tensor (replicated)."""
    def pl(spec, ndim):
        return shd.placements(spec, mesh, ndim)

    def per_param(ps):
        if moment_dtype == "int8":
            parts = list(ps)
            s_spec = P(*(parts[:-1] + [None])) if parts else P()
            return QTensor(q=pl(ps, len(parts)), s=pl(s_spec, len(parts)))
        return pl(ps, len(ps))

    tree = _map_specs(per_param, pspecs)
    # the step count stays a plain tensor, which counts as replicated
    return adamw.AdamWState(step=None, mu=tree, nu=tree)


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def _place_tree(tree, places, mesh):
    """Every tensor of ``tree`` placed by the matching leaf of
    ``places`` (``sharding.place``)."""
    if places is None:
        return tree
    if isinstance(tree, QTensor):
        return QTensor(q=shd.place(tree.q, mesh, places.q),
                       s=shd.place(tree.s, mesh, places.s))
    if isinstance(tree, dict):
        return {k: _place_tree(tree[k], places[k], mesh) for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*[_place_tree(t, p, mesh)
                            for t, p in zip(tree, places)])
    return shd.place(tree, mesh, places)


def cell_inputs(model: Model, shape: ShapeConfig, device, seed: int = 0
                ) -> Dict[str, Any]:
    """The batch of a cell: ``input_specs`` on meta, else drawn from
    ``seed`` on ``device`` (token ids in the vocabulary, embeddings
    N(0, 0.02^2), M-RoPE positions 0..S-1 on all three streams). A
    decode's ``pos`` is the host int the card path takes: the cache's
    last row."""
    specs = model.input_specs(shape)
    out: Dict[str, Any] = {}
    if torch.device(device).type == "meta":
        out = dict(specs)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        for k, t in specs.items():
            if k in ("tokens", "labels"):
                out[k] = torch.randint(0, model.cfg.vocab_size, t.shape,
                                       generator=gen, device=device,
                                       dtype=t.dtype)
            elif k == "embeds":
                out[k] = (torch.randn(t.shape, generator=gen, device=device)
                          * 0.02).to(t.dtype)
            elif k == "positions":
                pos = torch.arange(t.shape[-1], dtype=t.dtype, device=device)
                out[k] = pos.expand(t.shape).contiguous()
    if shape.kind == "decode":
        out["pos"] = shape.seq_len - 1
    return out


def build_cell(model: Model, shape: ShapeConfig, mesh=None, rules=None,
               device="meta", seed: int = 0) -> Tuple[Any, tuple]:
    """(step, args) of one cell: the step builder's function of the
    cell's kind and its arguments (params, optimizer state, batch, cache)
    on ``device`` (meta: nothing drawn; else random from ``seed``). With
    a ``DeviceMesh`` and rules, every argument is a DTensor placed as
    JAX's ``in_shardings`` place it."""
    cfg = model.cfg
    meta = torch.device(device).type == "meta"
    params = model.abstract_params(device) if meta else \
        model.init(seed, device)
    batch = cell_inputs(model, shape, device, seed)
    pmesh = None
    if mesh is not None:
        pmesh = compat.sub_mesh(mesh, tuple(mesh.mesh_dim_names))
        pspecs = shd.schema_pspecs(model.schema(), rules, mesh)
        places = _map_specs(lambda s: shd.placements(s, pmesh, len(s)),
                            pspecs)
        bspecs = _batch_pspec(batch, rules, cfg, mesh)
        batch = {k: shd.place(v, pmesh, shd.placements(bspecs[k], pmesh,
                                                        v.dim()))
                 if isinstance(v, torch.Tensor) else v
                 for k, v in batch.items()}
    if shape.kind == "train":
        step = build_train_step(model, TrainConfig(
            microbatches=cfg.train_microbatches))
        opt = abstract_opt_state(model, params)
        if pmesh is not None:
            opt = _place_tree(opt, opt_shardings(pmesh, pspecs,
                                                 cfg.moment_dtype), pmesh)
            params = _place_tree(params, places, pmesh)
        return step, (params, opt, batch)
    if pmesh is not None:
        params = _place_tree(params, places, pmesh)
    if shape.kind == "prefill":
        return build_prefill_step(model, shape), (params, batch)
    cache, axes = model.cache_specs(shape, device)
    if not meta:
        cache = model.init_cache(shape, device)
    if pmesh is not None:
        cache = {k: shd.place(v, pmesh, shd.placements(
            shd.to_pspec(axes[k], rules, shape=tuple(v.shape), mesh=mesh),
            pmesh, v.dim())) for k, v in cache.items()}
    return build_decode_step(model), (params, cache, batch)


def _mesh_of(name: str):
    if name == "1":
        return contextlib.nullcontext(None)
    if name not in CHIPS:
        raise ValueError(f"unknown mesh {name!r}; expected one of {MESHES}")
    return make_production_mesh(multi_pod=name == "2x16x16")


def analyze_cell(model: Model, shape: ShapeConfig, mesh=None,
                 device="meta", seed: int = 0) -> Dict[str, Any]:
    """``build_cell`` on ``device`` under the cell's rule set on ``mesh``
    (none without one), counted by ``hlo_cost.analyze`` (on meta with
    ``fold_scans``: nothing is computed there)."""
    rules = (shd.filter_rules(_rules_for(shape.name, shape.kind), mesh)
             if mesh is not None else None)
    mesh = shd.mesh_for(mesh, rules)
    if mesh is not None:
        # a cell's count must not depend on the cells traced before it
        compat.forget_dtensor_plans()
    step, args = build_cell(model, shape, mesh, rules, device, seed)
    meta = torch.device(device).type == "meta"
    with compat.mesh_context(mesh, device=device if meta else None), \
            shd.axis_rules(rules, mesh):
        return analyze(step, *args, fold_scans=meta)


def lower_cell(arch: str, shape, mesh: str = "16x16",
               remat: Optional[str] = None,
               extra_cfg: Optional[dict] = None) -> Dict[str, Any]:
    """Trace one cell on meta and count it; returns the result record.
    ``shape`` is a ``SHAPES`` name or a ``ShapeConfig``; ``mesh`` is
    ``"16x16"``, ``"2x16x16"`` or ``"1"`` (one device, no process
    group)."""
    cfg = get_config(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    if extra_cfg:
        cfg = cfg.replace(**extra_cfg)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    model = Model(cfg)
    with _mesh_of(mesh) as dmesh:
        t0 = time.time()
        cost = analyze_cell(model, shape, dmesh)
        trace_s = time.time() - t0
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh, "kind": shape.kind,
        "trace_s": round(trace_s, 2),
        "flops_per_device": float(cost["flops"]),
        "bytes_per_device": float(cost["bytes"]),
        "collectives": cost["collectives"],
        "collective_bytes_per_device": float(cost["collective_wire_bytes"]),
        "raw_cost_analysis": {"flops": float(cost["raw_flops"]),
                              "bytes_accessed": None},
        "memory": cost["memory"],
        "kernel_regions": cost["kernel_regions"],
        "param_count": model.param_count(),
    }


def run(arch=None, shape=None, meshes=("16x16", "2x16x16"), force=False,
        results_dir: Path = RESULTS_DIR):
    """Every cell of the registry (or of ``arch`` / ``shape``) on each of
    ``meshes``: cached records are read, not traced again."""
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for a, cfg in CONFIGS.items():
        if arch and a != arch:
            continue
        for s in SHAPES.values():
            if shape and s.name != shape:
                continue
            skip = s.name == "long_500k" and not cfg.supports_long_context
            for mesh_name in meshes:
                key = f"{a}__{s.name}__{mesh_name}"
                out = results_dir / f"{key}.json"
                if out.exists() and not force:
                    results.append(json.loads(out.read_text()))
                    print(f"[cached] {key}")
                    continue
                if skip:
                    rec = {"arch": a, "shape": s.name, "mesh": mesh_name,
                           "skipped": SKIP_TEXT}
                    out.write_text(json.dumps(rec, indent=1))
                    results.append(rec)
                    print(f"[skip]   {key}")
                    continue
                print(f"[run]    {key} ...", flush=True)
                try:
                    rec = lower_cell(a, s.name, mesh_name)
                    out.write_text(json.dumps(rec, indent=1))
                    mem = rec["memory"]["peak_estimate_bytes"] / 2**30
                    print(f"         ok: trace {rec['trace_s']}s, "
                          f"flops/dev {rec['flops_per_device']:.3e}, "
                          f"mem/dev {mem:.2f} GiB", flush=True)
                except Exception as e:       # a failed cell is a record
                    rec = {"arch": a, "shape": s.name, "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    out.write_text(json.dumps(rec, indent=1))
                    print(f"         FAILED: {type(e).__name__}: {e}",
                          flush=True)
                results.append(rec)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, *MESHES])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    meshes = (args.mesh,) if args.mesh else ("16x16", "2x16x16")
    results = run(args.arch, args.shape, meshes, args.force)
    n_ok = sum(1 for r in results if "error" not in r and "skipped" not in r)
    n_err = sum(1 for r in results if "error" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    print(f"\ndry-run: {n_ok} ok, {n_err} failed, {n_skip} skipped")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
