"""Serving entry point, routed through the continuous-batching engine.

Port of ``repro.launch.serve`` (engine path and the legacy unbatched
loop). Each batch row becomes one request of the engine; decode runs at
a batch bucket over the paged KV pool. ``--no-engine`` runs the legacy
lock-step loop (``Model.prefill`` + ``Model.decode_step`` over a dense
cache). The model runs on the GPU unless ``device="cpu"`` is passed.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 2 --max-new 8
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.engine import EngineConfig, InferenceEngine, engine_compatible
from repro_torch.models.model import Model


@dataclass
class ServeResult:
    tokens: np.ndarray                # (batch, max_new) int32 token ids
    first_logits: torch.Tensor        # (batch, V) f32, first sampled step
    seconds: float                    # submit to last token (host clock)
    stats: Dict[str, Any] = field(default_factory=dict)  # engine only


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine_serve(model, params, prompts, *, max_new: int,
                  engine_kernel: bool, prefill_chunk: int = 0) -> ServeResult:
    """Serve every prompt row as one request (decode bucketed at the batch
    size)."""
    batch, prompt_len = prompts.shape
    page = 16
    max_pages = max(1, math.ceil((prompt_len + max_new - 1) / page))
    eng = InferenceEngine(model, params, EngineConfig(
        page_size=page, pool_pages=batch * max_pages + 2,
        max_pages=max_pages,
        buckets=(1, batch) if batch > 1 else (1,),
        use_kernel=engine_kernel, prefill_chunk_pages=prefill_chunk))
    _sync(eng.device)
    t0 = time.perf_counter()
    for b in range(batch):
        eng.submit(prompts[b].tolist(), max_new)
    done = eng.run()
    _sync(eng.device)
    seconds = time.perf_counter() - t0
    st = eng.stats()
    print(f"engine: {batch} requests x {max_new} tokens in "
          f"{seconds * 1e3:.1f} ms (pages peak {st['pages_peak']}, "
          f"retraces {st['retraces']})")
    eng.drain()
    return ServeResult(np.array([r.out_tokens for r in done], np.int32),
                       torch.stack([r.first_logits for r in done]),
                       seconds, st)


def _legacy_serve(model, params, prompts, *, max_new: int,
                  device) -> ServeResult:
    """The unbatched lock-step loop: one prefill over the whole batch,
    then one decode step per token against a dense cache."""
    batch, prompt_len = prompts.shape
    cparams = model._compute_cast(params)   # one compute-dtype copy
    tokens = torch.as_tensor(prompts, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(cparams, {"tokens": tokens},
                                  prompt_len + max_new - 1)
    first = logits
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [next_tok]
    for i in range(max_new - 1):
        logits, cache, next_tok = model.decode_step(
            cparams, cache, {"tokens": next_tok[:, None],
                             "pos": prompt_len + i})
        out.append(next_tok)
    toks = torch.stack(out, dim=1).cpu().numpy()
    seconds = time.perf_counter() - t0
    print(f"prefill {prompt_len} tokens x{batch} + decode {max_new} steps: "
          f"{seconds * 1e3:.1f} ms")
    return ServeResult(toks, first, seconds)


def serve(arch: str = "tinyllama-1.1b", *, smoke: bool = True,
          batch: int = 4, prompt_len: int = 32, max_new: int = 16,
          engine: bool | None = None, engine_kernel: bool = False,
          prefill_chunk: int = 0, device=None) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens, ``max_new``
    tokens each, with random weights from seed 0 (prompts from seed 1)."""
    device = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg)
    params = model.init(0, device)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, dtype=torch.int32).numpy()
    if engine is None:
        engine = engine_compatible(cfg)
    if engine:
        return _engine_serve(model, params, prompts, max_new=max_new,
                             engine_kernel=engine_kernel,
                             prefill_chunk=prefill_chunk)
    return _legacy_serve(model, params, prompts, max_new=max_new,
                         device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the smoke config, "
                         "whose head dim 16 the CUDA kernels do not take)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "the plain versions of the kernels)")
    ap.add_argument("--no-engine", action="store_true",
                    help="force the legacy lock-step loop instead of the "
                         "continuous-batching engine")
    ap.add_argument("--engine-kernel", action="store_true",
                    help="decode through the paged-attention CUDA kernel")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk quantum in pages (0 = whole-prompt "
                         "prefill; >0 interleaves prefill chunks with "
                         "decode rounds)")
    args = ap.parse_args()
    res = serve(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, max_new=args.max_new,
                engine=False if args.no_engine else None,
                engine_kernel=args.engine_kernel,
                prefill_chunk=args.prefill_chunk, device=args.device)
    print("sampled token ids (first sequence):", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
