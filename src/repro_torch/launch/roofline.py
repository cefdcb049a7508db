"""Roofline analysis from the dry-run records, on the H100.

Port of ``repro.launch.roofline``. Per (arch x shape x mesh) cell, from
the per-device counts recorded by ``launch.dryrun``:

    compute term    = FLOPs / peak FLOP/s        (989 TF/s dense bf16)
    memory term     = bytes / HBM bandwidth      (3.35 TB/s HBM3)
    collective term = collective wire bytes / link bandwidth
                                                 (450 GB/s NVLink)

The constants are ``core.costmodel``'s (NVIDIA's H100 SXM data sheet),
the one definition the model clock and ``chip_smoke.py`` use. Plus
MODEL_FLOPS (6 N D for training, 2 N D for inference; N_active for MoE),
the useful-compute ratio, the dominant bottleneck and a one-line
recommendation. ``python -m repro_torch.launch.roofline [--mesh M]
[--arch A --shape S]`` prints the table or one cell's report.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core.costmodel import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.dryrun import CHIPS, RESULTS_DIR
from repro_torch.models.model import Model


def active_param_count(arch: str) -> int:
    """N_active: MoE expert params scaled by top_k/E."""
    cfg = get_config(arch)
    model = Model(cfg)
    total = model.param_count()
    if cfg.moe is None:
        return total
    expert_total = 0
    moe_schema = model.schema()["stack"]["layers"].get("moe", {})
    for k in ("wi", "wg", "wo"):
        if k in moe_schema:
            expert_total += math.prod(moe_schema[k].shape)
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return total - expert_total + int(expert_total * frac)


def model_flops(arch: str, shape) -> float:
    """6 N D (training) or 2 N D (prefill; decode: one token a sequence),
    N the active parameters; ``shape`` a ``SHAPES`` name or a
    ``ShapeConfig``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    n = active_param_count(arch)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def cell_terms(rec: Dict, chips: int, shape=None) -> Dict:
    """The roofline terms of one record (``shape``: the ``ShapeConfig``
    of a cell not in ``SHAPES``)."""
    compute = rec["flops_per_device"] / PEAK_FLOPS_BF16
    memory = rec["bytes_per_device"] / HBM_BW
    collective = rec["collective_bytes_per_device"] / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"] if shape is None else shape)
    counted_total = rec["flops_per_device"] * chips
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_total": counted_total,
        "useful_ratio": mf / counted_total if counted_total else 0.0,
        "bound_step_s": max(terms.values()),
        "roofline_fraction": (compute / max(terms.values())
                              if max(terms.values()) else 0.0),
    }


_ADVICE = {
    "compute": "compute-bound: keep the products on the tensor cores "
               "(bf16 wgmma tiles, fewer f32 passes); already near the "
               "useful roofline.",
    "memory": "HBM3-bound: cut activation round-trips (fuse the "
              "elementwise and softmax chains into the kernels, bf16 "
              "intermediates, larger attention blocks).",
    "collective": "NVLink-bound: overlap collectives with compute, "
                  "reshard to cut all-gathers (sequence-parallel "
                  "boundaries), or compress payloads.",
}


def load_cells(mesh: str = "16x16", results_dir: Path = RESULTS_DIR
               ) -> List[Dict]:
    return [json.loads(f.read_text())
            for f in sorted(Path(results_dir).glob(f"*__{mesh}.json"))]


def table(mesh: str = "16x16", results_dir: Path = RESULTS_DIR) -> str:
    chips = CHIPS[mesh]
    rows = [f"{'arch':<22}{'shape':<13}{'comp_s':>9}{'mem_s':>9}"
            f"{'coll_s':>9}{'domin':>7}{'useful':>8}{'mem_GiB':>9}"]
    for rec in load_cells(mesh, results_dir):
        name = f"{rec['arch']:<22}{rec['shape']:<13}"
        if rec.get("skipped"):
            rows.append(name + "  SKIP (sub-quadratic-only shape)")
            continue
        if rec.get("error"):
            rows.append(name + f"  ERROR {rec['error'][:60]}")
            continue
        t = cell_terms(rec, chips)
        mem = rec["memory"]["peak_estimate_bytes"] / 2**30
        rows.append(
            f"{name}{t['compute_s']:>9.4f}{t['memory_s']:>9.4f}"
            f"{t['collective_s']:>9.4f}{t['dominant']:>7}"
            f"{t['useful_ratio']:>8.3f}{mem:>9.2f}")
    return "\n".join(rows)


def cell_report(arch: str, shape: str, mesh: str = "16x16",
                results_dir: Path = RESULTS_DIR) -> str:
    f = Path(results_dir) / f"{arch}__{shape}__{mesh}.json"
    rec = json.loads(f.read_text())
    if rec.get("skipped") or rec.get("error"):
        return json.dumps(rec, indent=1)
    chips = CHIPS[mesh]
    t = cell_terms(rec, chips)
    lines = [
        f"{arch} x {shape} on {mesh} ({chips} H100s)",
        f"  compute term    {t['compute_s']:.4f} s "
        f"({rec['flops_per_device']:.3e} flops/dev @"
        f"{PEAK_FLOPS_BF16 / 1e12:.0f}TF/s)",
        f"  memory term     {t['memory_s']:.4f} s "
        f"({rec['bytes_per_device']:.3e} B/dev @{HBM_BW / 1e9:.0f}GB/s)",
        f"  collective term {t['collective_s']:.4f} s "
        f"({rec['collective_bytes_per_device']:.3e} B/dev @"
        f"{LINK_BW / 1e9:.0f}GB/s)",
        f"  dominant: {t['dominant']}   roofline fraction "
        f"(compute/bound): {t['roofline_fraction']:.3f}",
        f"  MODEL_FLOPS {t['model_flops']:.3e}  /  counted FLOPS "
        f"{t['hlo_flops_total']:.3e}  =  useful ratio "
        f"{t['useful_ratio']:.3f}",
        f"  -> {_ADVICE[t['dominant']]}",
    ]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16", choices=sorted(CHIPS))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)
    if args.arch and args.shape:
        print(cell_report(args.arch, args.shape, args.mesh))
    else:
        print(table(args.mesh))


if __name__ == "__main__":
    main()
