"""``repro_torch.tune``: probe-guided kernel autotuning from the command
line (port of ``repro.launch.tune``).

    PYTHONPATH=src python -m repro_torch.tune --kernel flash_attention
    PYTHONPATH=src python -m repro_torch.tune --kernel all --seq 512 \\
        --cache-dir .repro_cache/dse --json tune.json
    PYTHONPATH=src python -m repro_torch.tune --device cpu --kernel all \\
        --seq 64 --max-steps 2
    PYTHONPATH=src python -m repro_torch.tune --arch tinyllama-1.1b \\
        --kernel flash_attention --batch 1 --seq 512

Runs the DSE engine (enumerate -> budget prune -> successive-halving
ProbeSession measurement -> incremental eval cache) for each requested
kernel at the given shapes, prints the leaderboard, and leaves the
winners in the on-disk cache where ``serve --autotune`` / ``train
--autotune`` (and ``repro_torch.kernels.tuning.load_cache``) pick them
up, each at the input shapes it was tuned at: a winner is applied only
to calls of its own shapes. ``--arch`` tunes at a model's shapes (its
heads, kv heads and head dims; the SSD scan at its Mamba-2 layer), so
that its serve and train calls meet the winners: the engine prefills one
prompt at a time (``--batch 1 --seq <prompt>``) and decodes its whole
batch over the prompt's and the new tokens' pages (``--batch <batch>
--seq <prompt + new>``). Without it the kernels are tuned at
``--heads``/``--dim``, shapes no model of the repo calls. It runs on the
GPU unless ``--device cpu``; on the card a candidate
is measured on the ``%globaltimer`` clock with the stream held (the
model clock cannot rank tiles: a kernel's bytes and FLOPs are the same
at every tile), on the CPU on the model clock.

``--sweep`` switches to the trace-once sweep farm (``core.dse.
run_sweep``): candidates x shapes captured once as ``KernelTrace``
artifacts, priced in microseconds, with device measurement reserved for
the per-shape finalists:

    PYTHONPATH=src python -m repro_torch.tune --kernel ssd_scan --sweep \\
        --sweep-seqs 128,256,512 --workers 2 --top-k 8
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

from repro_torch import resolve_device
from repro_torch.core.costmodel import DeviceBudget
from repro_torch.core.dse import DSEEngine, run_sweep
from repro_torch.core.incremental import EvalCache
from repro_torch.kernels import search_spaces

KERNELS = tuple(search_spaces.SPACES)


def _int_tuple(spec: str) -> tuple:
    return tuple(int(v) for v in spec.split(",") if v.strip())


def _budget(args: argparse.Namespace) -> DeviceBudget:
    return DeviceBudget(smem_bytes=args.budget_smem,
                        hbm_bytes=args.budget_hbm, flops=args.budget_flops)


def sweep_kernel(kernel: str, args: argparse.Namespace,
                 cache: EvalCache) -> Dict[str, Any]:
    shapes = None
    if args.sweep_seqs or args.sweep_heads:
        shapes = search_spaces.sweep_shapes(
            kernel, seqs=_int_tuple(args.sweep_seqs or ""),
            heads=_int_tuple(args.sweep_heads or ""))
    result = run_sweep(
        kernel, shapes, workers=args.workers, top_k=args.top_k,
        steps=args.max_steps, budget=_budget(args), cache=cache,
        calibrate=not args.no_calibrate, walk=args.walk,
        cycle_source=args.cycle_source, reuse_traces=not args.no_reuse,
        device=args.device)
    print(result.summary())
    return result.to_dict()


def arch_shapes(kernel: str, arch: str) -> Optional[Dict[str, Any]]:
    """The space arguments of ``kernel`` at model ``arch``'s widths (None
    where the model does not call the kernel)."""
    import torch

    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    dtype = getattr(torch, cfg.compute_dtype)
    if kernel == "ssd_scan":
        if cfg.ssm is None:
            return None
        from repro_torch.models.ssm import ssm_dims
        d = ssm_dims(cfg)
        return dict(H=d["heads"], G=d["groups"], P=d["head_dim"],
                    N=d["d_state"], dtype=dtype)
    if cfg.is_attention_free:
        return None
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    if kernel == "flash_attention":
        return dict(H=cfg.num_heads, Hkv=kv, D=hd, dtype=dtype)
    from repro_torch.engine.step import engine_compatible
    if not engine_compatible(cfg):      # no paged decode: the legacy loop
        return None
    return dict(KV=kv, G=cfg.q_per_kv, HD=hd, q_dtype=dtype,
                kv_dtype=getattr(torch, cfg.kv_cache_dtype))


def build_space(kernel: str, args: argparse.Namespace):
    dev = args.device
    if kernel == "chunked_prefill":
        from repro_torch.configs.registry import get_config
        from repro_torch.engine.step import engine_compatible
        arch = args.arch or "tinyllama-1.1b"
        if not engine_compatible(get_config(arch)):
            return None
        # the smoke config's head dim 16 is not one the CUDA kernels take:
        # on the card the full-width model
        return search_spaces.chunked_prefill_space(
            arch=arch, prompt_pages=max(1, args.seq // 64),
            full=dev.startswith("cuda"), seed=args.seed, device=dev)
    if kernel not in KERNELS:
        raise SystemExit(f"unknown kernel {kernel!r}; choose from "
                         f"{KERNELS + ('all',)}")
    if args.arch is not None:
        widths = arch_shapes(kernel, args.arch)
        if widths is None:
            return None
    elif kernel == "flash_attention":
        widths = dict(H=args.heads, D=args.dim)
    elif kernel == "ssd_scan":     # N 64: a state width the kernel takes
        widths = dict(H=args.heads, G=1, P=args.dim, N=64)
    else:
        widths = dict(HD=args.dim)
    if kernel == "flash_attention":
        return search_spaces.flash_attention_space(
            B=args.batch, S=args.seq, seed=args.seed, device=dev, **widths)
    if kernel == "ssd_scan":
        return search_spaces.ssd_scan_space(
            B=args.batch, L=args.seq, seed=args.seed, device=dev, **widths)
    return search_spaces.paged_attention_space(
        B=args.batch, n_pages=max(1, -(-args.seq // 16)), seed=args.seed,
        device=dev, **widths)
    raise SystemExit(f"unknown kernel {kernel!r}; choose from "
                     f"{KERNELS + ('all',)}")


def tune_kernel(kernel: str, args: argparse.Namespace,
                cache: EvalCache) -> Dict[str, Any]:
    space = build_space(kernel, args)
    if space is None:
        print(f"# {args.arch} calls no {kernel}: not tuned")
        return {}
    engine = DSEEngine(space, budget=_budget(args), cache=cache,
                       cycle_source=args.cycle_source, r0=args.r0,
                       eta=args.eta, max_steps=args.max_steps)
    result = engine.tune()
    print(result.leaderboard(top=args.top))
    best = result.best
    if best is not None and best.measured:
        print(f"-> best {kernel} config: {best.config} "
              f"({best.cycles_per_step:.0f} cyc/step, "
              f"{result.speedup:.2f}x vs default); cached for --autotune")
    return result.to_dict()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tune",
        description="probe-guided CUDA kernel autotuning (DSE engine)")
    ap.add_argument("--kernel", default="flash_attention",
                    help=f"one of {KERNELS} or 'all'")
    ap.add_argument("--arch", default=None,
                    help="tune at this model's widths (heads, kv heads, "
                         "head dim; its Mamba-2 layer for ssd_scan); "
                         "--heads and --dim are then unused")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' tunes the "
                         "kernels' plain versions on the model clock)")
    ap.add_argument("--seq", type=int, default=256,
                    help="sequence length to tune at (S / L; paged: the "
                         "cache length, 16 slots a page; chunked_prefill: "
                         "64 tokens a prompt page)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--dim", type=int, default=64,
                    help="head dim (flash, paged, SSD)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dir", default=None,
                    help="eval cache dir (default .repro_cache/dse or "
                         "$REPRO_DSE_CACHE)")
    ap.add_argument("--clear-cache", action="store_true",
                    help="drop cached measurements for the kernel(s) first")
    ap.add_argument("--cycle-source", default=None,
                    choices=("model", "wallclock"),
                    help="default: wallclock on the GPU, model on the CPU")
    ap.add_argument("--r0", type=int, default=1,
                    help="successive-halving starting steps per candidate")
    ap.add_argument("--eta", type=int, default=2,
                    help="halving keep-fraction / step-growth factor")
    ap.add_argument("--max-steps", type=int, default=4,
                    help="steps the finalists run")
    ap.add_argument("--budget-smem", type=int,
                    default=DeviceBudget().smem_bytes,
                    help="dynamic shared memory budget per CTA, bytes")
    ap.add_argument("--budget-hbm", type=int, default=None,
                    help="HBM traffic budget per call, bytes")
    ap.add_argument("--budget-flops", type=int, default=None)
    ap.add_argument("--top", type=int, default=10,
                    help="leaderboard rows to print")
    ap.add_argument("--json", default=None,
                    help="write the full tune result(s) to this path")
    ap.add_argument("--sweep", action="store_true",
                    help="run the trace-once sweep farm instead of "
                         "successive halving")
    ap.add_argument("--workers", type=int, default=2,
                    help="sweep worker processes (<=1 runs inline)")
    ap.add_argument("--top-k", type=int, default=16,
                    help="sweep: total device-measured finalists across "
                         "shapes (>=2 per shape)")
    ap.add_argument("--sweep-seqs", default=None,
                    help="sweep: comma-separated sequence lengths "
                         "(S / L / n_pages / prompt pages)")
    ap.add_argument("--sweep-heads", default=None,
                    help="sweep: comma-separated head counts")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="sweep: skip the grid-step calibration run")
    ap.add_argument("--walk", action="store_true",
                    help="sweep: also capture walked (sim-mode) grid "
                         "totals per candidate")
    ap.add_argument("--no-reuse", action="store_true",
                    help="sweep: ignore stored trace artifacts")
    args = ap.parse_args(argv)
    args.device = str(resolve_device(args.device))

    kernels = list(KERNELS) if args.kernel == "all" else [args.kernel]
    cache = EvalCache(args.cache_dir)
    results = {}
    for kernel in kernels:
        if args.clear_cache:
            n = cache.clear(kernel)
            print(f"# cleared {n} cached entries for {kernel}")
        results[kernel] = (sweep_kernel(kernel, args, cache) if args.sweep
                           else tune_kernel(kernel, args, cache))
        print()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        print(f"# wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
