"""Engine soak: waves of random requests with flat-memory assertions.

Port of ``repro.engine.soak`` (``python -m repro_torch.engine.soak``): a
long random request trace (mixed prompt lengths, decode budgets, and
shared prefixes, in randomized arrival order; the JAX package's numpy
stream for the same ``seed``) served wave after wave through one
:class:`~repro_torch.engine.InferenceEngine`. After every wave the
driver asserts the steady-state invariants a long-lived server depends
on:

- zero retraces: every step was built (and, probed, captured) during
  ``warmup()`` and no step is built or captured again;
- page accounting balances: after ``drain()`` the table returns to
  all-free (no leaked or double-freed pages);
- flat host memory: Python-side traced allocations after the last wave
  stay within a fixed slack of the first wave's (finished requests are
  ``reap()``-ed per wave, aggregates are constant-size);
- flat device memory, in place of JAX's ``jax.live_arrays()`` count: the
  live tensors ``gc`` finds after the last wave match the first wave's
  count within ``buffer_slack`` (16, as JAX's), and on the card
  ``torch.cuda.memory_allocated()``, read after a synchronize, matches
  the first wave's within ``DEVICE_SLACK_BYTES`` (8 MiB). The pools are
  updated in place and each step's outputs are dropped, so nothing
  should grow (each mark holds its own wave's finished requests, alike
  in every wave). The slack leaves room for a tensor of a size the first
  wave did not leave behind; a leak a step is over it within two waves
  at tinyllama-1.1b's full width (decode logits: 512 KB a round at 4
  rows; a prefill's caches: up to 1.4 MB), and the card read no growth
  at all (``chip_smoke.py`` step 16).

``--pressure`` shrinks the page pool to ~60% of the trace's working set
so every wave must reclaim prefix-tree pages: the run additionally
asserts nonzero evictions, a prefix hit-rate floor (LRU keeps the hot
prefixes resident), and that ``PagePoolExhausted`` never fires: the
evictor alone absorbs the pressure. ``--chunk N`` serves the same trace
through the chunked-prefill scheduler (one more step per chunk shape,
still zero retraces after warm-up).

``cfg`` (not in the JAX package) soaks a given model config in place of
``smoke_config(arch)``, and ``--full`` the arch's full config:
``chip_smoke.py`` soaks full-width tinyllama-1.1b on the card, whose
head dim the kernels take (the smoke config's 16 they do not). On the
CPU the kernels' plain versions run; ``--device`` defaults to the GPU.
"""
from __future__ import annotations

import argparse
import gc
import time
import tracemalloc
from typing import List

import numpy as np
import torch

from repro_torch import resolve_device

# growth of the card's allocated bytes the soak allows from the first
# wave to the last (see the module docstring): room for one tensor of a
# size the first wave did not leave behind, under what a leak a step
# adds within two full-width waves
DEVICE_SLACK_BYTES = 8 << 20


def _wave(rng: np.random.Generator, eng, n_requests: int,
          vocab: int, prefixes: List[List[int]]) -> List[int]:
    ps = eng.config.page_size
    cap = eng.config.max_pages * ps
    rids = []
    for _ in range(n_requests):
        prompt: List[int] = []
        if rng.random() < 0.5:
            prompt += prefixes[int(rng.integers(len(prefixes)))]
        prompt += rng.integers(0, vocab,
                               int(rng.integers(1, 2 * ps))).tolist()
        max_new = int(rng.integers(1, ps))
        if len(prompt) + max_new - 1 > cap:
            prompt = prompt[:cap - max_new + 1 - ps]
        rids.append(eng.submit(prompt, max_new))
    return rids


def _live_tensors() -> int:
    """Tensors the garbage collector can see (``type`` is read directly:
    ``isinstance`` would touch lazy module attributes)."""
    return sum(1 for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor))


def soak(*, arch: str = "tinyllama-1.1b", waves: int = 3,
         requests_per_wave: int = 8, seed: int = 0,
         use_kernel: bool = False, probe: bool = False,
         pressure: bool = False, chunk: int = 0,
         min_hit_rate: float = 0.15,
         mem_slack_bytes: int = 512 * 1024,
         buffer_slack: int = 16, verbose: bool = True, device=None,
         cfg=None) -> dict:
    from repro_torch.configs.registry import smoke_config
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models import Model

    dev = resolve_device(device)
    cfg = smoke_config(arch) if cfg is None else cfg
    model = Model(cfg)
    params = model.init(seed, device=dev)
    # a wave's working set is ~4 pages per request (prefix + tail +
    # decode budget); under --pressure the pool holds ~60% of that, so
    # steady state is only reachable by evicting finished prefix pages
    pool = (max(12, int(0.6 * requests_per_wave * 4)) if pressure
            else 48)
    eng = InferenceEngine(model, params, EngineConfig(
        page_size=16, pool_pages=pool, max_pages=8, buckets=(1, 2, 4),
        use_kernel=use_kernel, pages_per_step=2, probe=probe,
        prefill_chunk_pages=chunk))
    rng = np.random.default_rng(seed)
    # one full page each, so later waves hit the prefix cache
    prefixes = [rng.integers(0, cfg.vocab_size, 16).tolist()
                for _ in range(3)]
    on_card = dev.type == "cuda"

    eng.warmup()                     # every step built before wave 0
    tracemalloc.start()
    marks, bufs, dmem, walls, served, tokens = [], [], [], [], 0, 0
    for w in range(waves):
        t0 = time.perf_counter()
        rids = _wave(rng, eng, requests_per_wave, cfg.vocab_size, prefixes)
        eng.run()
        done = eng.reap()
        if on_card:
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        assert sorted(r.rid for r in done) == sorted(rids), \
            f"wave {w}: starved requests"
        assert all(len(r.out_tokens) == r.max_new for r in done)
        served += len(done)
        tokens += sum(len(r.out_tokens) for r in done)
        st = eng.stats()
        assert st["retraces"] == 0, f"wave {w}: retraced: {st}"
        mem = tracemalloc.get_traced_memory()[0]
        marks.append(mem)
        bufs.append(_live_tensors())
        if on_card:
            dmem.append(torch.cuda.memory_allocated(dev))
        if verbose:
            extra = (f", device_mem={dmem[-1] / 2**20:.1f}MiB" if on_card
                     else "")
            print(f"wave {w}: {len(done)} served, "
                  f"pages_peak={st['pages_peak']}, "
                  f"hit_rate={st['prefix_hit_rate']:.2f}, "
                  f"evictions={st['evictions']}, "
                  f"host_mem={mem / 1024:.0f}KiB, "
                  f"buffers={bufs[-1]}{extra}, "
                  f"wall={walls[-1] * 1e3:.1f}ms", flush=True)
    tracemalloc.stop()
    eng.drain()
    assert eng.table.balanced(), "page accounting out of balance at drain"
    assert marks[-1] <= marks[0] + mem_slack_bytes, \
        f"host memory grew {marks[-1] - marks[0]}B over " \
        f"{waves} waves (> {mem_slack_bytes}B slack)"
    assert bufs[-1] <= bufs[0] + buffer_slack, \
        f"live tensors grew {bufs[0]} -> {bufs[-1]} over {waves} waves"
    if on_card:
        assert dmem[-1] <= dmem[0] + DEVICE_SLACK_BYTES, \
            f"device memory grew {dmem[0]} -> {dmem[-1]} bytes over " \
            f"{waves} waves (> {DEVICE_SLACK_BYTES}B slack)"
    st = eng.stats()
    if pressure:
        assert st["evictions"] > 0, \
            "pressure pool never forced an eviction (pool too large?)"
        assert st["prefix_hit_rate"] >= min_hit_rate, \
            f"prefix hit rate {st['prefix_hit_rate']:.2f} fell below " \
            f"{min_hit_rate} under pressure (evictor dropping hot pages?)"
    eng.close()
    out = {"served": served, "mem_first": marks[0], "mem_last": marks[-1],
           "buffers_first": bufs[0], "buffers_last": bufs[-1],
           "tokens": tokens, "wave_seconds": walls, **st}
    if on_card:
        out.update(device_mem_first=dmem[0], device_mem_last=dmem[-1])
    if verbose:
        print(f"soak OK: {served} requests over {waves} waves, "
              f"mem {marks[0]} -> {marks[-1]} bytes")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--requests-per-wave", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", action="store_true",
                    help="decode through the paged-attention CUDA kernel")
    ap.add_argument("--probe", action="store_true",
                    help="run every phase under a ProbeSession")
    ap.add_argument("--pressure", action="store_true",
                    help="shrink the page pool to ~60%% of the working "
                         "set; asserts evictions happen and the prefix "
                         "hit rate holds its floor")
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill chunk quantum in pages (0 = whole)")
    ap.add_argument("--min-hit-rate", type=float, default=0.15,
                    help="prefix hit-rate floor under --pressure")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, which must exist)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config, not its smoke config "
                         "(on the card: the kernels do not take the smoke "
                         "config's head dim 16)")
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import get_config
    soak(arch=args.arch, waves=args.waves,
         requests_per_wave=args.requests_per_wave, seed=args.seed,
         use_kernel=args.kernel, probe=args.probe,
         pressure=args.pressure, chunk=args.chunk,
         min_hit_rate=args.min_hit_rate, device=args.device,
         cfg=get_config(args.arch) if args.full else None)


if __name__ == "__main__":
    main()
