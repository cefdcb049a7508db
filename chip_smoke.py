#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
2. builds the port's CUDA kernels from src/repro_torch/csrc (nvcc,
   sm_90a, one process per source, in parallel);
3. holds the flash-attention kernel against its plain PyTorch version
   and the naive oracle at the serving shapes, checks that rows taken at
   a q offset equal the whole call's rows bitwise, and that the probe
   counts equal the plain version's;
4. holds the paged-attention kernel against its plain version and checks
   that each row is bitwise invariant to batching and page placement;
5. serves tinyllama-1.1b at full width (random weights from a seed)
   through the engine: whole-prompt prefill with the decode kernel,
   chunked prefill, dense decode, and the legacy loop; the launch
   counters are zeroed before each run and must equal 22 x the steps;
6. times each kernel (CUDA events, median) beside its plain version, a
   library call where one computes the same function, and its bound.

Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits 1 before printing any result. The last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain version, bf16 outputs of |x| <~ 3: a few bf16 ulps
# (2^-8 relative), since both round p to bf16 after maxima and sums
# taken in different orders
FLASH_ATOL = 3e-2
# kernel vs the naive f32 oracle: bf16 rounding of p on top of that
FLASH_REF_ATOL = 6e-2
# paged kernel vs plain version, f32 outputs: summation order, and a
# rare bf16 flip of p / l (weights ~1/544 each)
PAGED_ATOL = 1e-3

ARCH, BATCH, PROMPT, MAX_NEW, CHUNK = "tinyllama-1.1b", 8, 512, 32, 8


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash(torch, fa, flash_attention_ref, dev):
    """Serving shapes of one prefill: B=1, 32 q heads over 4 kv heads,
    head dim 64, S=512, bf16."""
    B, H, Hkv, S, D = 1, 32, 4, 512, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, probe = fa.flash_attention(q, k, v, with_probe=True)
    plain, probe_plain = fa.flash_attention_plain(q, k, v, with_probe=True)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    err_ref = (out.float() - flash_attention_ref(q, k, v).float()
               ).abs().max().item()
    print(f"flash (a) S=512: max |kernel - plain| {err:.3e} "
          f"(atol {FLASH_ATOL}), max |kernel - ref| {err_ref:.3e} "
          f"(atol {FLASH_REF_ATOL})")
    assert torch.isfinite(out.float()).all()
    assert err <= FLASH_ATOL and err_ref <= FLASH_REF_ATOL
    part = fa.flash_attention(q[:, :, 384:].contiguous(), k, v, q_offset=384)
    same = torch.equal(part, out[:, :, 384:])
    print(f"flash (b) Sq=128 at q_offset 384 == rows 384-511 bitwise: {same}")
    assert same
    same = torch.equal(probe, probe_plain)
    print(f"flash (c) probe counts == plain: {same} "
          f"(tile 7 visited/computed {probe[0, 0, 7].tolist()})")
    assert same
    pairs = S * (S + 1) // 2                       # visible (q, k) pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    return dict(inputs=(q, k, v), err=err,
                bound=bound(nbytes, 4.0 * B * H * D * pairs))


def check_paged(torch, pa, dev):
    """Serving shapes of one decode round: 8 rows, 4 kv heads x 8 q rows,
    head dim 64, pages of 16, 34 pages per row, a pool of 274 pages."""
    B, kv, g, hd, ps, npg, P = 8, 4, 8, 64, 16, 34, 274
    s_max = ps * npg
    gen = torch.Generator(device=dev).manual_seed(1)
    cpu = torch.Generator().manual_seed(1)
    q = torch.randn((B, kv, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    pool_k, pool_v = (torch.randn((P, ps, kv, hd), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
    pages = (torch.randperm(P - 1, generator=cpu)[:B * npg] + 1).reshape(
        B, npg).to(torch.int32)
    pos = torch.randint(0, s_max, (B,), generator=cpu, dtype=torch.int32)
    pos[0], pos[1] = 0, s_max - 1
    pages[B - 1], pos[B - 1] = 0, 0                # a padding lane
    pages, pos = pages.to(dev), pos.to(dev)
    out = pa.paged_attention(q, pool_k, pool_v, pages, pos)
    plain = pa.paged_attention_plain(q, pool_k, pool_v, pages, pos)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    print(f"paged: max |kernel - plain| {err:.3e} (atol {PAGED_ATOL})")
    assert torch.isfinite(out).all() and err <= PAGED_ATOL
    rows = all(torch.equal(pa.paged_attention(q[b:b + 1], pool_k, pool_v,
                                              pages[b:b + 1], pos[b:b + 1]),
                           out[b:b + 1]) for b in range(B))
    print(f"paged: row b of the B=8 call == B=1 call on row b bitwise: {rows}")
    assert rows
    perm = torch.randperm(P, generator=cpu).to(dev)
    moved_k, moved_v = torch.empty_like(pool_k), torch.empty_like(pool_v)
    moved_k[perm], moved_v[perm] = pool_k, pool_v
    moved = torch.equal(pa.paged_attention(
        q, moved_k, moved_v, perm[pages.long()].to(torch.int32), pos), out)
    print(f"paged: permuted pool placement gives a bitwise-equal output: "
          f"{moved}")
    assert moved
    visible = int((pos.long() + 1).clamp(max=s_max).sum())
    nbytes = (2 * q.numel() + 2 * 2 * visible * kv * hd + 4 * pages.numel()
              + 4 * pos.numel() + 4 * out.numel())
    return dict(inputs=(q, pool_k, pool_v, pages, pos), err=err,
                bound=bound(nbytes, 4.0 * kv * g * hd * visible))


def serve_runs(torch, fa, pa, serve):
    """Full-width serving through the port's entry point. Returns the
    launch counts of the main path (whole prefill + decode kernel)."""
    L = 22
    t0 = time.perf_counter()
    serve(ARCH, smoke=False, batch=2, prompt_len=32, max_new=2,
          engine_kernel=True)
    print(f"warm-up serve (2 x 32 tokens): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms incl. weight init")
    runs = {}
    for name, kw in (("kernel", dict(engine_kernel=True)),
                     ("chunked", dict(engine_kernel=True,
                                      prefill_chunk=CHUNK)),
                     ("dense", dict(engine_kernel=False)),
                     ("legacy", dict(engine=False))):
        fa.flash_attention.launches = 0
        pa.paged_attention.launches = 0
        res = serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
                    max_new=MAX_NEW, **kw)
        torch.cuda.synchronize()
        flash, paged = fa.flash_attention.launches, pa.paged_attention.launches
        assert res.tokens.shape == (BATCH, MAX_NEW)
        assert ((res.tokens >= 0) & (res.tokens < 32000)).all()
        assert torch.isfinite(res.first_logits[:, :32000]).all()
        if res.stats:
            ph = res.stats["phases"]
            prefill = ph["prefill"]["steps"] + ph.get("chunkpf",
                                                      {"steps": 0})["steps"]
            decode = ph["decode"]["steps"]
            want = (L * prefill, L * decode if kw["engine_kernel"] else 0)
            assert res.stats["retraces"] == 0
        else:
            prefill, decode = 1, MAX_NEW - 1
            want = (L, 0)
        print(f"serve [{name}]: {res.seconds * 1e3:.1f} ms, "
              f"{BATCH * MAX_NEW / res.seconds:.1f} tokens/s; "
              f"{prefill} prefill steps, {decode} decode rounds; launches "
              f"flash {flash}, paged {paged} (want {want[0]}, {want[1]})")
        assert (flash, paged) == want
        runs[name] = (res, flash, paged)
    base = runs["kernel"][0]
    for name in ("chunked", "dense", "legacy"):
        res = runs[name][0]
        same = int((res.tokens == base.tokens).sum())
        dl = (res.first_logits - base.first_logits).abs().max().item()
        print(f"token ids shared with [kernel]: [{name}] {same}/"
              f"{base.tokens.size}; first-step max |logit diff| {dl:.3e}")
    return runs["kernel"][1], runs["kernel"][2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.serve import serve

    smi = nvidia_smi()
    print(f"card: {smi} ({torch.cuda.get_device_name(0)}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    flash = check_flash(torch, fa, flash_attention_ref, dev)
    paged = check_paged(torch, pa, dev)
    flash_launches, paged_launches = serve_runs(torch, fa, pa, serve)

    q, k, v = flash["inputs"]
    fl_ms = time_ms(lambda: fa.flash_attention(q, k, v))
    fl_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=5)
    fl_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pin = paged["inputs"]
    pg_ms = time_ms(lambda: pa.paged_attention(*pin))
    pg_plain = time_ms(lambda: pa.paged_attention_plain(*pin), reps=5)
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:121",
             launches=flash_launches, max_abs_err=flash["err"], ms=fl_ms,
             plain_ms=fl_plain, bound_ms=flash["bound"][0],
             bound_by=flash["bound"][1], library_ms=fl_lib),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:94",
             launches=paged_launches, max_abs_err=paged["err"], ms=pg_ms,
             plain_ms=pg_plain, bound_ms=paged["bound"][0],
             bound_by=paged["bound"][1], library_ms=None),
    ]
    for kn in kernels:
        print(f"{kn['name']}: {kn['ms'] * 1e3:.1f} us (bound "
              f"{kn['bound_ms'] * 1e3:.2f} us by {kn['bound_by']}), plain "
              f"{kn['plain_ms'] * 1e3:.1f} us, library "
              f"{'-' if kn['library_ms'] is None else round(kn['library_ms'] * 1e3, 1)}"
              f" us, {kn['launches']} launches on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
