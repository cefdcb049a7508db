#!/usr/bin/env python3
"""Time the port's kernels at the serving paths' shapes.

    python3 tools/bench_torch_kernels.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two versions of the kernels can be held against each other in
one run on one card, e.g. the parent commit unpacked under ``build/``:

    for s in build/parent/src src src build/parent/src; do
        python3 tools/bench_torch_kernels.py --src $s; done

Shapes (tinyllama-1.1b, the main path of ``chip_smoke.py``):
flash for the whole prefill (B=1, 32 q heads over 4 kv heads, S=512,
D=64) and for a chunked step (Sq=128 at q offset 384, Skv=512); paged
decode with all 8 rows at pos 543 and with random positions (34 pages of
16, a pool of 274 pages, 4 kv heads x 8 q rows, head dim 64); the SSD
scan of one mamba2-370m prefill layer (B=8, L=1024, 32 heads of 64, one
group, N=128, chunk 256, bf16, with the final state); and zamba2-2.7b's
two (``flash_d80``: the shared-attention prefill, B=4, 32 q heads over
32 kv heads, S=512, D=80; ``ssd_zamba2``: one SSM layer's scan, B=4,
L=512, 80 heads of 64, one group, N=64, chunk 256); ``flash_d128``, the
default launch at head dim 128 (qwen2-vl-72b's prefill shape: B=2, 64 q
heads over 8 kv heads, S=512). A call a tree's
kernels do not take (head dim 80 before it was built) reads null. For each:
the median device time of one call with the stream held (the host's cost
per call stays out, ``chip_smoke.time_ms``) and the host time of one
wrapper call (``chip_smoke.host_us``). Prints the card, then one JSON
line. Needs a CUDA device.

``--save FILE`` also writes every call's outputs (and those of the
flash kernel with its probe counts, and with its row statistics at the
training shape, B 8 x S 2048, and of the paged kernel with its counter
block), and ``--compare FILE`` holds them against a file another tree
saved, so that a change that must not move a bit of the default launches
can show it (the JSON line gains ``bitwise``: call -> equal)::

    python3 tools/bench_torch_kernels.py --src build/parent/src --save build/parent.pt
    python3 tools/bench_torch_kernels.py --compare build/parent.pt
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--save", default=None,
                    help="write each call's outputs here (torch.save)")
    ap.add_argument("--compare", default=None,
                    help="a file --save wrote: are the outputs bitwise "
                         "equal to its?")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(args.src))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((1, 32, 512, 64), (1, 4, 512, 64),
                             (1, 4, 512, 64)))
    qc = q[:, :, 384:].contiguous()
    B, kv, g, hd, ps, npg, P = 8, 4, 8, 64, 16, 34, 274
    cpu = torch.Generator().manual_seed(1)
    qd = torch.randn((B, kv, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    pool_k, pool_v = (torch.randn((P, ps, kv, hd), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
    pages = (torch.randperm(P - 1, generator=cpu)[:B * npg] + 1).reshape(
        B, npg).to(torch.int32).to(dev)
    full = torch.full((B,), ps * npg - 1, dtype=torch.int32, device=dev)
    rand = torch.randint(0, ps * npg, (B,), generator=cpu,
                         dtype=torch.int32).to(dev)
    sx, sa, sb, sc = chip_smoke.ssd_inputs(torch, dev, 8, 1024, 32, 64, 1,
                                           128, seed=2)
    qz, kz, vz = (torch.randn((4, 32, 512, 80), generator=gen, device=dev
                              ).to(torch.bfloat16) for _ in range(3))
    zx, za, zb, zc = chip_smoke.ssd_inputs(torch, dev, 4, 512, 80, 64, 1, 64,
                                           seed=3)
    qh, kh, vh = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((2, 64, 512, 128), (2, 8, 512, 128),
                                      (2, 8, 512, 128)))
    calls = {
        "flash_prefill": lambda: fa.flash_attention(q, k, v),
        "flash_chunk": lambda: fa.flash_attention(qc, k, v, q_offset=384),
        "paged_pos543": lambda: pa.paged_attention(qd, pool_k, pool_v, pages,
                                                   full),
        "paged_random_pos": lambda: pa.paged_attention(qd, pool_k, pool_v,
                                                       pages, rand),
        "ssd_prefill": lambda: ssd.ssd_scan(sx, sa, sb, sc, chunk=256,
                                            h_per_g=32,
                                            return_final_state=True),
        "flash_d80": lambda: fa.flash_attention(qz, kz, vz),
        "ssd_zamba2": lambda: ssd.ssd_scan(zx, za, zb, zc, chunk=256,
                                           h_per_g=80,
                                           return_final_state=True),
        "flash_d128": lambda: fa.flash_attention(qh, kh, vh),
    }
    res = {}
    for name, fn in list(calls.items()):
        try:
            fn()
        except ValueError as e:         # a shape this tree does not take
            print(f"{name}: {e}")
            res[name] = None
            del calls[name]
            continue
        res[name] = dict(us=chip_smoke.time_ms(fn, reps=50) * 1e3,
                         host_us=chip_smoke.host_us(fn))
    smi = chip_smoke.nvidia_smi()
    print(f"card: {smi}")
    line = {"label": args.label or args.src, "card": smi, "kernels": res}
    if args.save or args.compare:
        qt, kt, vt = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((8, 32, 2048, 64), (8, 4, 2048, 64),
                                          (8, 4, 2048, 64)))
        outs = dict(calls)
        outs["flash_prefill_probe"] = lambda: fa.flash_attention(
            q, k, v, with_probe=True)
        outs["flash_train_stats"] = lambda: fa.flash_attention(
            qt, kt, vt, with_stats=True)
        outs["paged_random_pos_counts"] = lambda: pa._paged(
            qd, pool_k, pool_v, pages, rand, True)
        got = {}
        for name, fn in outs.items():
            o = fn()
            got[name] = [t.cpu() for t in (o if isinstance(o, tuple)
                                           else (o,))]
        if args.save:
            torch.save(got, args.save)
        if args.compare:
            want = torch.load(args.compare)
            line["bitwise"] = {
                name: name in want and len(want[name]) == len(ts) and all(
                    torch.equal(a, b) for a, b in zip(ts, want[name]))
                for name, ts in got.items()}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
