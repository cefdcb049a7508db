#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves on the GPU.

    python3 tools/profile_torch_serve.py [--chunk N] [--dense] [--probe]
    python3 tools/profile_torch_serve.py --arch mamba2-370m \
        [--src DIR] [--save-tokens PATH] [--compare-tokens PATH]

Serves tinyllama-1.1b at full width through the port's engine (8
requests of 512 prompt tokens, 32 new tokens each, random weights from
seed 0), or mamba2-370m at full width through the legacy lock-step loop
(8 x 1024 prompt tokens, 32 new tokens; the engine takes attention
models only), once to warm up, once timed on the host clock, then once
under ``torch.profiler``, and reads the device timeline of the last run:
device busy time (the union of kernel, memcpy and memset intervals),
its share of the unprofiled wall time (the profiler slows the host, not
the device), device time by kernel name, and the time of each of the
port's own kernels. The Chrome trace is
written to build/profile/. ``--src`` imports ``repro_torch`` from another
tree (e.g. the parent commit unpacked under build/), and
``--save-tokens`` writes the sampled token ids (.npy) and
``--compare-tokens`` prints how many of them equal a saved run's, so that
two trees' serves can be compared. ``--probe`` profiles the probed serve
too (``profile=True``: every engine step, or the legacy loop's decode
step, in a ``ProbeSession``), after the unprobed one and the same way,
and prints the two side by side: walls, device busy share and host ops
per step, so that the probe's overhead splits into host and device
time. Needs a CUDA device; fails if the trace holds no device activity.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel names from src/repro_torch/csrc
PORT_KERNELS = ("flash_fwd_kernel", "paged_stats_kernel",
                "paged_output_kernel", "paged_attention_kernel",
                "ssd_state_kernel", "ssd_chunk_scan_kernel")
PROMPT_LEN = {"tinyllama-1.1b": 512, "mamba2-370m": 1024}


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy


def measure(torch, profile, activity, run, arch, path_name, note=""):
    """Warm up, time one unprofiled run, then one under the profiler;
    prints the run's line and returns (result, device time by kernel
    name, device busy us)."""
    run()                                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6    # the profiler slows the host
    with profile(activities=[activity.CPU, activity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    n_ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    ph = (res.stats["phases"] if res.stats else
          {"prefill": {"steps": 1}, "decode": {"steps": 31}})
    steps = sum(v["steps"] for v in ph.values())
    print(f"serve {arch} ({path_name}): wall {plain_us / 1e3:.1f} ms "
          f"unprofiled, "
          f"{wall_us / 1e3:.1f} ms profiled; device busy {busy / 1e3:.1f} ms "
          f"= {100 * busy / plain_us:.1f} % of the unprofiled wall (idle "
          f"{100 * (1 - busy / plain_us):.1f} %); {len(dev)} device "
          f"activities, {n_ops} host ops over {steps} steps = "
          f"{n_ops / steps:.1f} a step "
          f"({json.dumps({k: v['steps'] for k, v in ph.items()})})"
          f"{note}", flush=True)
    return res, by_name, busy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=sorted(PROMPT_LEN))
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill chunk quantum in pages (0 = whole prompt)")
    ap.add_argument("--dense", action="store_true",
                    help="decode through the plain version, not the kernel")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree to import repro_torch from")
    ap.add_argument("--save-tokens", default=None,
                    help="write the sampled token ids here (.npy)")
    ap.add_argument("--compare-tokens", default=None,
                    help="token ids (.npy) of another run to compare with")
    ap.add_argument("--probe", action="store_true",
                    help="also profile the probed serve, beside the "
                         "unprobed one")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    import numpy as np
    from repro_torch.engine import (EngineConfig, InferenceEngine,
                                    engine_compatible)
    from repro_torch.launch.serve import ServeResult, _legacy_serve
    from repro_torch.models import Model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    model = Model(cfg)
    params = model.init(0)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (8, PROMPT_LEN[args.arch]),
                            generator=gen, dtype=torch.int32).numpy()
    dense = engine_compatible(cfg)
    engines = {}

    def run(probe=False):
        # the probe arguments only when probing: --src trees may predate them
        if not dense:           # a profiled serve captures its session
            return _legacy_serve(model, params, prompts, max_new=32,
                                 device=torch.device("cuda", 0),
                                 **(dict(profile=True) if probe else {}))
        # one engine per mode, kept across runs as a server keeps it: a
        # probed engine captures each step once, in the warm-up run
        eng = engines.get(probe)
        if eng is None:
            eng = engines[probe] = InferenceEngine(model, params, EngineConfig(
                page_size=16, pool_pages=8 * 34 + 2, max_pages=34,
                buckets=(1, 8), use_kernel=not args.dense,
                prefill_chunk_pages=args.chunk,
                **(dict(probe=True) if probe else {})))
        before = {k: v["steps"] for k, v in eng.phase_stats.items()}
        for row in prompts:
            eng.submit(row.tolist(), 32)
        done = eng.run()
        eng.drain()
        phases = {k: {"steps": v["steps"] - before.get(k, 0)}
                  for k, v in eng.phase_stats.items()}
        return ServeResult(np.array([r.out_tokens for r in done], np.int32),
                           None, 0.0, {"phases": phases})
    path_name = (f"engine, decode {'plain' if args.dense else 'kernel'}, "
                 f"chunk {args.chunk}" if dense else "legacy loop")
    prefill_note = ""
    if not dense:
        cparams = model._compute_cast(params)
        tokens = torch.as_tensor(prompts, device="cuda")
        model.prefill(cparams, {"tokens": tokens}, prompts.shape[1] + 31)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(cparams, {"tokens": tokens}, prompts.shape[1] + 31)
        torch.cuda.synchronize()
        prefill_note = (f"; the prefill alone {(time.perf_counter() - t0) * 1e3:.1f}"
                        f" ms unprofiled")
        del cparams
    print(f"card: {smi}")
    res = None
    for probe in ((False, True) if args.probe else (False,)):
        res, by_name, busy = measure(torch, profile, ProfilerActivity,
                                     lambda: run(probe), args.arch,
                                     f"{path_name}{', probed' if probe else ''}",
                                     prefill_note)
    print("device time by kernel (ms, share of busy, calls), last run:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.2f}  {100 * us / busy:5.1f} %  {n:6d}  "
              f"{name[:110]}")
    print("the port's own kernels (ms, share of busy, calls, us per call):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if any(k in name for k in PORT_KERNELS):
            print(f"  {us / 1e3:9.2f}  {100 * us / busy:5.1f} %  {n:6d}  "
                  f"{us / n:8.2f}  {name[:90]}")
    tokens = np.asarray(res.tokens)
    if args.save_tokens:
        np.save(args.save_tokens, tokens)
    if args.compare_tokens:
        other = np.load(args.compare_tokens)
        same = tokens == other
        first = [int(np.argmin(r)) if not r.all() else r.size for r in same]
        print(f"token ids equal to {args.compare_tokens}: {int(same.sum())}/"
              f"{same.size}; first step equal in {int(same[:, 0].sum())}/"
              f"{len(same)} rows; first differing step per row {first} "
              f"({same.shape[1]} = none)")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
