#!/usr/bin/env python3
"""Where the kernels' time goes: time cut-down copies of them.

    python3 tools/ablate_torch_kernels.py [--only flash_attention,paged_attention,ssd_scan]

Each variant is a copy of ``src/repro_torch/csrc/<kernel>.cu`` (the
default tiles' translation unit, with the ``csrc/`` header it includes
inlined) with edits:
an anchor line of the source after which an early return is inserted,
so that the kernel skips everything after that point, or an (old, new)
pair of source text replaced once (a product removed, a loop cut). The
copies are built with
nvcc (the port's flags, one process each, in parallel) into
``build/ablate/`` and swapped, one at a time, into the wrapper's library
cache (``_build._LIBS``); the wrapper then launches them as it launches
the real kernel. A variant's outputs are wrong by design: only its times
are read. Shapes: flash for the whole tinyllama-1.1b prefill (B=1, 32 q
heads over 4 kv heads, S=512, D=64), paged decode with all 8 rows at pos
543 (34 pages of 16, 4 kv heads x 8 q rows, head dim 64), the SSD scan of
one mamba2-370m prefill layer (B=8, L=1024, 32 heads of 64, N=128, chunk
256, bf16, with the final state). For each
variant: the median device time of one call with the stream held
(``chip_smoke.time_ms``, which includes the ~4 us that events and the
launch add to any call) and each kernel's own duration under
``torch.profiler``; beside them one SDPA call (flash backend) and an
empty PyTorch op, for the floor. Prints the card, then one JSON line.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablate")
RETURN = "  if (threadIdx.x < 0xffffffffu) return;  // ablation\n"

# kernel source -> variant -> edits: anchor lines after which the return
# goes, or (old, new) source text replaced once
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
            "  tile_scores<HD, G, TS>(sS, qraw, kraw, g, tl.nv, scale);\n"
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
    "ssd_scan": {
        "full": [],
        "state kernel without its products": [(
            "              mma_bf16(acc[2 * np], xa[q], r[0], r[1]);\n"
            "              mma_bf16(acc[2 * np + 1], xa[q], r[2], r[3]);\n", "")],
        "state kernel without split and products": [
            ("      for (int i = tid; i < nh * T * PH / 2; i += THREADS) {",
             "      for (int i = tid; i < 0; i += THREADS) {"),
            ("              mma_bf16(acc[2 * np], xa[q], r[0], r[1]);\n"
             "              mma_bf16(acc[2 * np + 1], xa[q], r[2], r[3]);\n", "")],
        "scan without c.prev^T": [(
            "  // y = exp(a_cs[q]) c_q . prev^T (prev is 0 for the first chunk)\n"
            "  if (ci > 0) {", "  if (ci < 0) {")],
        "scan without c.b^T": [(
            "            mma_bf16(cb[2 * np], ca, r[0], r[1]);\n"
            "            mma_bf16(cb[2 * np + 1], ca, r[2], r[3]);\n", "")],
        "scan without L x": [(
            "            mma_bf16(acc[w][2 * dp], la, r[0], r[1]);\n"
            "            mma_bf16(acc[w][2 * dp + 1], la, r[2], r[3]);\n", "")],
        "scan without its key-tile loop": [(
            "  for (int kt = 0; kt <= qt; ++kt) {\n"
            "    const int k0 = kt * T;\n",
            "  for (int kt = 0; kt < 0; ++kt) {\n"
            "    const int k0 = kt * T;\n")],
    },
}


def _variant_source(kernel: str, edits) -> str:
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    src = open(os.path.join(csrc, f"{kernel}.cu")).read()
    for head in re.findall(r'#include "([^"]+)"', src):
        src = src.replace(f'#include "{head}"',
                          open(os.path.join(csrc, head)).read())
    for edit in edits:
        old, new = (edit, edit + RETURN) if isinstance(edit, str) else edit
        if src.count(old) != 1:
            raise RuntimeError(f"{kernel}: edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def _build_all(build, kernels):
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for kernel in kernels:
        variants = VARIANTS[kernel]
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated kernels to ablate")
    kernels = ap.parse_args().only.split(",")
    import torch
    if not torch.cuda.is_available():
        print("ablate_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd

    libs = _build_all(_build, kernels)
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
    sx, sa, sb, sc = chip_smoke.ssd_inputs(torch, dev, 8, 1024, 32, 64, 1,
                                           128, seed=2)
    calls = {
        "ssd_scan": (lambda: ssd.ssd_scan(sx, sa, sb, sc, chunk=256,
                                          h_per_g=32, return_final_state=True),
                     ssd._SIGNATURES),
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
