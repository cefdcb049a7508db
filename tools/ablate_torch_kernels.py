#!/usr/bin/env python3
"""Where the attention kernels' time goes: time cut-down copies of them.

    python3 tools/ablate_torch_kernels.py

Each variant is a copy of ``src/repro_torch/csrc/<kernel>.cu`` with one
early return inserted after an anchor line of the source, so that the
kernel skips everything after that point. The copies are built with
nvcc (the port's flags, one process each, in parallel) into
``build/ablate/`` and swapped, one at a time, into the wrapper's library
cache (``_build._LIBS``); the wrapper then launches them as it launches
the real kernel. A variant's outputs are wrong by design: only its times
are read. Shapes: flash for the whole tinyllama-1.1b prefill (B=1, 32 q
heads over 4 kv heads, S=512, D=64), paged decode with all 8 rows at pos
543 (34 pages of 16, 4 kv heads x 8 q rows, head dim 64). For each
variant: the median device time of one call with the stream held
(``chip_smoke.time_ms``, which includes the ~4 us that events and the
launch add to any call) and each kernel's own duration under
``torch.profiler``; beside them one SDPA call (flash backend) and an
empty PyTorch op, for the floor. Prints the card, then one JSON line.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablate")
RETURN = "  if (threadIdx.x < 0xffffffffu) return;  // ablation\n"

# kernel source -> variant -> anchor lines after which the return goes
VARIANTS = {
    "flash_attention": {
        "full": [],
        "empty": ["  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);\n"],
    },
    "paged_attention": {
        "full": [],
        "stats launch empty": [
            "  if (t == 0 && threadIdx.x == 0) sc.arrived[bh] = 0;  // for launch 2\n"],
        "stats stops after its page walk": [
            "  if (tl.nv <= 0) return;\n  __syncthreads();\n"],
        "stats stops after its scores": [
            "  tile_scores<HD, G>(sS, qraw, kraw, g, tl.nv, scale);\n"
            "  __syncthreads();\n"],
        "output launch empty": [
            "  const Scratch sc = carve(scratch, B, kv, g, HD, nt);\n"
            "  const size_t bh = (size_t)b * kv + h;\n"
            "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
            "  const int c = lane % LPR, r = lane / LPR;\n"],
        "both launches empty": [
            "  if (t == 0 && threadIdx.x == 0) sc.arrived[bh] = 0;  // for launch 2\n",
            "  const Scratch sc = carve(scratch, B, kv, g, HD, nt);\n"
            "  const size_t bh = (size_t)b * kv + h;\n"
            "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
            "  const int c = lane % LPR, r = lane / LPR;\n"],
        "output stops at its wait": [
            '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'],
        "output without the last-CTA sum": [
            "    part[idx] = s;\n  }\n"],
    },
}


def _variant_source(kernel: str, anchors) -> str:
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                            f"{kernel}.cu")).read()
    for anchor in anchors:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{kernel}: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + RETURN)
    return src


def _build_all(build):
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for kernel, variants in VARIANTS.items():
        for name, anchors in variants.items():
            stem = f"{kernel}-{name.replace(' ', '_')}"
            cu, so = os.path.join(OUT, stem + ".cu"), os.path.join(OUT, stem + ".so")
            with open(cu, "w") as f:
                f.write(_variant_source(kernel, anchors))
            jobs[(kernel, name)] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        libs[key] = so
    return libs


def _load(build, kernel, so, signatures):
    lib = ctypes.CDLL(so)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    build._LIBS[kernel] = lib


def _kernel_us(torch, fn, n=30):
    """Device time of each kernel a call launches, summed by name, per
    call (mean over n calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    res = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        if total and e.count:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0][:48]
            res[name] = res.get(name, 0.0) + total / n
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    libs = _build_all(_build)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((1, 32, 512, 64), (1, 4, 512, 64),
                             (1, 4, 512, 64)))
    B, kv, g, hd, ps, npg, P = 8, 4, 8, 64, 16, 34, 274
    qd = torch.randn((B, kv, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    pool_k, pool_v = (torch.randn((P, ps, kv, hd), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
    pages = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(1)
                            )[:B * npg] + 1).reshape(B, npg).to(
        torch.int32).to(dev)
    pos = torch.full((B,), ps * npg - 1, dtype=torch.int32, device=dev)
    calls = {
        "flash_attention": (lambda: fa.flash_attention(q, k, v),
                            fa._SIGNATURES),
        "paged_attention": (lambda: pa.paged_attention(qd, pool_k, pool_v,
                                                       pages, pos),
                            pa._SIGNATURES),
    }
    res = {}
    for (kernel, name), so in libs.items():
        fn, signatures = calls[kernel]
        _load(_build, kernel, so, signatures)
        res[f"{kernel}: {name}"] = dict(
            held_us=chip_smoke.time_ms(fn, reps=50) * 1e3,
            kernel_us=_kernel_us(torch, fn))
    for kernel in calls:
        _build._LIBS.pop(kernel, None)     # the real kernels again
    sdpa, how = chip_smoke.sdpa_flash(torch, F, q, k, v, 0)
    res[f"SDPA ({how})"] = dict(held_us=chip_smoke.time_ms(sdpa, reps=50) * 1e3,
                                kernel_us=_kernel_us(torch, sdpa))
    x = torch.zeros(1, device=dev)
    res["empty PyTorch op (x.add_(1))"] = dict(
        held_us=chip_smoke.time_ms(lambda: x.add_(1), reps=50) * 1e3,
        kernel_us=_kernel_us(torch, lambda: x.add_(1)))
    smi = chip_smoke.nvidia_smi()
    print(f"card: {smi}")
    print(json.dumps({"card": smi, "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
