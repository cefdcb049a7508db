"""Probe-attributed continuous-batching inference engine.

Port of ``repro.engine.engine``. Scheduling is the JAX engine's, all
host-side:

- **FCFS admission.** Requests wait in arrival order; the head of the
  queue is admitted as soon as its pages fit and a decode slot is open.
  Later requests never jump the head, so no request starves.
- **All pages up front.** Admission allocates every page the request
  will ever touch (prompt + ``max_new`` growth), so decode can never
  fail mid-request. Full prompt pages found in the prefix tree are
  shared by refcount instead of allocated.
- **Bucketed batching.** Decode runs at the smallest configured batch
  bucket covering the runnable set; padded lanes point at the null
  page. Each (phase, shape) step is built (and, probed, captured) once;
  ``retraces()`` counts builds and captures beyond that and must stay 0.
- **Per-phase attribution.** With ``probe=True`` each (phase, shape)
  step runs inside a :class:`~repro_torch.core.streaming.ProbeSession`
  (source ``engine/{phase}x{tag}``); the engine takes model-clock
  deltas around every call (host reads: the session keeps the clock on
  the host). Prefill and cache cycles are exclusive to one request; a
  decode delta is shared by its batch (each rider logs the bucket width
  in ``decode_batches``). With a ``TelemetryBus`` the phase steps and
  finished requests' bills are published to it (``bus=``).
- **Chunked prefill.** With ``prefill_chunk_pages=K`` a prompt wider
  than ``K`` pages prefills one page-aligned chunk per scheduler round,
  interleaved with decode rounds, so a long prompt never head-of-line
  blocks the running decode batch (``hol_blocked_steps`` counts the
  decode rounds a whole-prompt prefill *would* have displaced beyond
  one chunk quantum).
- **Prefix-aware eviction.** Under pool pressure admission reclaims
  prefix-cache pages through :meth:`PrefixTree.evict` — leaf-first,
  least-recently-matched first, never a page a live request still
  references. ``evict_policy="clear"`` keeps the all-or-nothing policy.
- **In-place pool.** The scatter and decode steps update the paged KV
  pool in place, which is what JAX's ``donate`` option buys; the port
  has nothing to donate and no such option. A probed step's capture
  undoes its writes (``core.hierarchy``), so the pool is written once.

The engine runs on the device its parameters live on.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import report
from repro_torch.core.pragma import ProbeConfig
from repro_torch.core.streaming import ProbeSession
from repro_torch.engine.pagetable import PagePoolExhausted, PageTable, PrefixTree
from repro_torch.engine.step import (build_chunk_prefill, build_engine_prefill,
                                     build_page_scatter, build_paged_decode,
                                     engine_compatible)

PHASES = ("prefill", "cache", "decode")


@dataclass
class Request:
    """One serving request and its lifetime accounting."""
    rid: int
    prompt: List[int]
    max_new: int
    out_tokens: List[int] = field(default_factory=list)
    first_logits: Optional[torch.Tensor] = None   # (V,) f32, first token
    phase_cycles: Dict[str, int] = field(
        default_factory=lambda: {p: 0 for p in PHASES})
    decode_batches: List[int] = field(default_factory=list)
    shared_pages: int = 0
    # scheduler-internal
    pages: List[int] = field(default_factory=list)
    pos: int = -1                     # last cache position written
    last_tok: int = -1
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass
class _PrefillJob:
    """An admitted request mid chunked-prefill: pages are allocated,
    ``next_page`` is the first prompt page the next chunk will write."""
    req: Request
    page_tokens: List[Tuple[int, ...]]
    pp: int                           # total prompt pages
    next_page: int


@dataclass(frozen=True)
class EngineConfig:
    """Engine shape / bucket / probe knobs."""
    page_size: int = 16
    pool_pages: int = 64              # device pool size incl. null page
    max_pages: int = 8                # page-table width per request
    buckets: Tuple[int, ...] = (1, 2, 4)
    use_kernel: bool = False          # paged-attention CUDA kernel
    pages_per_step: int = 1           # TPU kernel's DMA depth (DSE axis)
    probe: bool = False
    probe_targets: Tuple[str, ...] = ("",)
    probe_max_probes: int = 16
    prefix_cache: bool = True
    prefill_chunk_pages: int = 0      # 0 = whole-prompt prefill
    evict_policy: str = "lru"         # "lru" | "clear"


class InferenceEngine:
    """Continuous-batching engine over one model + parameter set.

    Usage::

        eng = InferenceEngine(model, params, EngineConfig(probe=True))
        eng.submit([1, 2, 3], max_new=8)
        done = eng.run()          # list of finished Requests, rid order
        print(eng.phase_table()); print(eng.request_table(done))
        eng.drain()               # release prefix-cache pages
        eng.close()               # close the probe sessions
    """

    def __init__(self, model, params, config: EngineConfig = EngineConfig(),
                 *, bus=None):
        cfg = model.cfg
        # optional telemetry bus: phase/request bills (and, with
        # probe=True, each step family's duration stream) publish to it
        self.bus = bus
        if not engine_compatible(cfg):
            raise ValueError(
                f"engine requires an attention-family token model; got "
                f"family={cfg.family!r} frontend={cfg.frontend!r}")
        if tuple(sorted(config.buckets)) != tuple(config.buckets) \
                or not config.buckets:
            raise ValueError(f"buckets must be sorted non-empty, "
                             f"got {config.buckets}")
        if config.max_pages > config.pool_pages - 1:
            raise ValueError(f"max_pages {config.max_pages} exceeds pool "
                             f"capacity {config.pool_pages - 1}")
        if config.use_kernel and config.max_pages % config.pages_per_step:
            raise ValueError(f"max_pages {config.max_pages} not divisible "
                             f"by pages_per_step {config.pages_per_step}")
        if config.prefill_chunk_pages < 0:
            raise ValueError(f"prefill_chunk_pages must be >= 0, "
                             f"got {config.prefill_chunk_pages}")
        if config.prefill_chunk_pages and cfg.moe is not None \
                and cfg.moe.impl != "ragged":
            raise ValueError(
                "chunked prefill requires dropless (ragged) MoE routing; "
                f"impl={cfg.moe.impl!r} drops tokens by total count, which "
                "breaks chunk/whole-prompt bit-identity")
        if config.evict_policy not in ("lru", "clear"):
            raise ValueError(f"evict_policy must be 'lru' or 'clear', "
                             f"got {config.evict_policy!r}")
        self.model, self.config = model, config
        # one compute-dtype copy for every step (see models/model.py)
        self.params = model._compute_cast(params)
        self.device = self.params["embed"].device
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = (cfg.num_layers, config.pool_pages, config.page_size, kv, hd)
        kvd = getattr(torch, cfg.kv_cache_dtype)
        self.pool_k = torch.zeros(shape, dtype=kvd, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=kvd, device=self.device)
        self.table = PageTable(config.pool_pages, config.page_size)
        self.tree: Optional[PrefixTree] = \
            PrefixTree(self.table) if config.prefix_cache else None
        self._steps: Dict[Tuple[str, Any], Any] = {}
        self._builds: Dict[Tuple[str, Any], int] = {}
        self._waiting: deque = deque()
        self._active: List[Request] = []
        self._prefilling: deque = deque()     # _PrefillJob, FCFS
        self._finished: List[Request] = []
        self._next_rid = 0
        self.phase_stats: Dict[str, Dict[str, int]] = {
            p: {"steps": 0, "cycles": 0} for p in PHASES}
        self.bucket_hist: Dict[int, int] = {}
        self.chunk_stats: Dict[Tuple[int, int], Dict[str, int]] = {}
        self.evictions = 0                    # pages reclaimed from tree
        self.hol_blocked_steps = 0            # decode rounds displaced
        self.tokens_out = 0

    # -- step registry ---------------------------------------------------
    def _build(self, phase: str, size):
        c = self.config
        self._builds[(phase, size)] = self._builds.get((phase, size), 0) + 1
        if phase == "prefill":
            fn = build_engine_prefill(self.model, size, c.page_size)
        elif phase == "cache":
            fn = build_page_scatter(size)
        elif phase == "chunkpf":
            fn = build_chunk_prefill(self.model, size[0], size[1],
                                     c.page_size)
        else:
            fn = build_paged_decode(
                self.model, size, c.max_pages, c.page_size,
                use_kernel=c.use_kernel, pages_per_step=c.pages_per_step)
        if not c.probe:
            return fn
        tag = size if isinstance(size, int) else "x".join(map(str, size))
        return ProbeSession(fn, ProbeConfig(
            targets=c.probe_targets, offload=1.0,
            max_probes=c.probe_max_probes),
            bus=self.bus, source=f"engine/{phase}x{tag}", device=self.device)

    def _entry(self, phase: str, size):
        entry = self._steps.get((phase, size))
        if entry is None:
            entry = self._steps[(phase, size)] = self._build(phase, size)
        return entry

    def _invoke(self, entry, *args):
        return entry.step(*args) if self.config.probe else entry(*args)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _chunk_shapes(self) -> List[Tuple[int, int]]:
        """Every (ctx_pages, chunk_pages) continuation shape the chunked
        scheduler can reach: chunk starts are multiples of K, the final
        chunk covers the remainder."""
        K = self.config.prefill_chunk_pages
        shapes = set()
        if K:
            for pp in range(K + 1, self.config.max_pages + 1):
                for cs in range(K, pp, K):
                    shapes.add((cs, min(K, pp - cs)))
        return sorted(shapes)

    def warmup(self):
        """Build and run every (phase, shape) step once ahead of serving
        (kernel builds, library handles, allocator pools). Warmup writes
        only into the null page, which no real request reads unmasked."""
        c, ps = self.config, self.config.page_size
        def zero(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        for pp in range(1, c.max_pages + 1):
            _, k, v = self._invoke(
                self._entry("prefill", pp), self.params,
                {"tokens": zero(1, pp * ps), "last_idx": zero(1)})
            self._invoke(self._entry("cache", pp), self.pool_k, self.pool_v,
                         k, v, zero(pp))
        for (cs, n) in self._chunk_shapes():
            self._invoke(
                self._entry("chunkpf", (cs, n)), self.params, self.pool_k,
                self.pool_v,
                {"tokens": zero(1, n * ps), "ctx_pages": zero(cs),
                 "last_idx": zero(1)})
        for b in c.buckets:
            self._invoke(
                self._entry("decode", b), self.params, self.pool_k,
                self.pool_v,
                {"tokens": zero(b, 1), "pos": zero(b),
                 "pages": zero(b, c.max_pages), "pos_host": (0,) * b})

    def _step(self, phase: str, size, *args):
        """Run one step, return (outputs, model-clock cycle delta)."""
        entry = self._entry(phase, size)
        if self.config.probe:
            c0 = entry.clock()
            out = entry.step(*args)
            delta = entry.clock() - c0
        else:
            out = entry(*args)
            delta = 0
        st = self.phase_stats.setdefault(phase, {"steps": 0, "cycles": 0})
        st["steps"] += 1
        st["cycles"] += delta
        if self.bus is not None:
            self.bus.publish_phase(phase, cycles=delta,
                                   batch=size if phase == "decode"
                                   else None)
        return out, delta

    def retraces(self) -> int:
        """Step builds beyond the one each (phase, shape) owns, and, when
        probed, captures beyond the one each step's session makes."""
        total = sum(max(0, n - 1) for n in self._builds.values())
        if self.config.probe:
            total += sum(max(0, e.pf.captures - 1)
                         for e in self._steps.values())
        return total

    # -- request lifecycle ----------------------------------------------
    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        # positions 0..prompt_len-1 (prefill) plus max_new-1 decode writes
        return max(1, math.ceil((prompt_len + max_new - 1)
                                / self.config.page_size))

    def submit(self, prompt: Sequence[int], max_new: int = 8) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if self._pages_needed(len(prompt), max_new) > self.config.max_pages:
            raise ValueError(
                f"request needs {self._pages_needed(len(prompt), max_new)} "
                f"pages; page table holds {self.config.max_pages}")
        r = Request(rid=self._next_rid, prompt=prompt, max_new=max_new)
        self._next_rid += 1
        self._waiting.append(r)
        return r.rid

    def _page_tokens(self, r: Request) -> List[Tuple[int, ...]]:
        ps = self.config.page_size
        return [tuple(r.prompt[i * ps:(i + 1) * ps])
                for i in range(len(r.prompt) // ps)]

    def _reclaim(self, n_pages: int, n_shared: int,
                 page_tokens: List[Tuple[int, ...]]) -> int:
        """Evict prefix-cache pages until the head request's fresh-page
        need fits, per ``evict_policy``; returns the updated shared-page
        count (a "clear" drops the head's own match too)."""
        if self.tree is None or not self.tree.nodes:
            return n_shared
        if self.config.evict_policy == "clear":
            # all-or-nothing: only safe once serving is idle
            if not self._active and not self._prefilling:
                self.evictions += len(self.tree.clear())
                n_shared = 0
            return n_shared
        while n_pages - n_shared > self.table.free_pages:
            shortfall = (n_pages - n_shared) - self.table.free_pages
            freed = self.tree.evict(shortfall, protect=page_tokens)
            if not freed:
                break                 # every remaining leaf is in use
            self.evictions += len(freed)
            n_shared = self.tree.lookup(page_tokens)
        return n_shared

    def _try_admit(self, r: Request) -> bool:
        n_pages = self._pages_needed(len(r.prompt), r.max_new)
        page_tokens = self._page_tokens(r)
        n_shared = self.tree.lookup(page_tokens) if self.tree else 0
        if n_pages - n_shared > self.table.free_pages:
            # prefix-cache pages are the only reclaimable slack: evict
            # when the pool alone is the blocker, else wait for drains
            n_shared = self._reclaim(n_pages, n_shared, page_tokens)
            if n_pages - n_shared > self.table.free_pages:
                return False
        shared = self.tree.match(page_tokens) if self.tree else []
        assert len(shared) == n_shared, (len(shared), n_shared)
        fresh = self.table.alloc(n_pages - len(shared))
        r.pages = shared + fresh
        r.shared_pages = len(shared)
        self._start_prefill(r, page_tokens)
        return True

    def _start_prefill(self, r: Request,
                       page_tokens: List[Tuple[int, ...]]):
        K = self.config.prefill_chunk_pages
        pp = math.ceil(len(r.prompt) / self.config.page_size)
        if not K or pp <= K:
            self._prefill(r, page_tokens)
            return
        # chunks start at multiples of K; fully prefix-shared leading
        # chunks are skipped (their pages already hold these exact KV
        # rows), but the final chunk always runs for the first token
        start = min((r.shared_pages // K) * K, ((pp - 1) // K) * K)
        self._prefilling.append(_PrefillJob(r, page_tokens, pp, start))

    def _prefill(self, r: Request, page_tokens: List[Tuple[int, ...]]):
        c = self.config
        P = len(r.prompt)
        pp = math.ceil(P / c.page_size)
        if self._active:
            # decode rounds this whole-prompt prefill displaces beyond
            # the one chunk quantum any prefill step costs
            q = max(c.prefill_chunk_pages, 1)
            self.hol_blocked_steps += max(0, math.ceil(pp / q) - 1)
        toks = np.zeros((1, pp * c.page_size), np.int32)
        toks[0, :P] = r.prompt
        (logits, k, v), d = self._step(
            "prefill", pp, self.params,
            {"tokens": self._tensor(toks), "last_idx": self._tensor([P - 1])})
        r.phase_cycles["prefill"] += d
        _, d = self._step("cache", pp, self.pool_k, self.pool_v, k, v,
                          self._tensor(r.pages[:pp]))
        r.phase_cycles["cache"] += d
        if self.tree is not None and page_tokens:
            self.tree.insert(page_tokens, r.pages[:len(page_tokens)])
        self._emit_first_token(r, logits)

    def _emit_first_token(self, r: Request, logits):
        r.first_logits = logits[0]
        tok = int(torch.argmax(logits[0]))
        r.out_tokens.append(tok)
        self.tokens_out += 1
        r.last_tok = tok
        r.pos = len(r.prompt) - 1
        if len(r.out_tokens) >= r.max_new:
            self._complete(r)
        else:
            self._active.append(r)

    def _chunk_step(self):
        """Prefill the head job's next chunk (one scheduler quantum)."""
        c = self.config
        job = self._prefilling[0]
        r, ps = job.req, c.page_size
        P, pp, cs = len(r.prompt), job.pp, job.next_page
        n = min(c.prefill_chunk_pages, pp - cs)
        final = cs + n >= pp
        toks = np.zeros((1, n * ps), np.int32)
        seg = r.prompt[cs * ps:min(P, (cs + n) * ps)]
        toks[0, :len(seg)] = seg
        li = (P - 1 - cs * ps) if final else (n * ps - 1)
        batch = {"tokens": self._tensor(toks), "last_idx": self._tensor([li])}
        if cs == 0:
            (logits, k, v), d = self._step("prefill", n, self.params, batch)
        else:
            batch["ctx_pages"] = self._tensor(r.pages[:cs])
            (logits, k, v), d = self._step("chunkpf", (cs, n), self.params,
                                           self.pool_k, self.pool_v, batch)
        r.phase_cycles["prefill"] += d
        _, dc = self._step("cache", n, self.pool_k, self.pool_v, k, v,
                           self._tensor(r.pages[cs:cs + n]))
        r.phase_cycles["cache"] += dc
        cst = self.chunk_stats.setdefault((cs, n),
                                          {"steps": 0, "cycles": 0})
        cst["steps"] += 1
        cst["cycles"] += d + dc
        job.next_page = cs + n
        # publish fully-written prompt pages incrementally so requests
        # arriving mid-prefill can already share the finished chunks
        if self.tree is not None and job.page_tokens:
            done_pages = min(cs + n, len(job.page_tokens))
            self.tree.insert(job.page_tokens[:done_pages],
                             r.pages[:done_pages])
        if final:
            self._prefilling.popleft()
            self._emit_first_token(r, logits)

    def _complete(self, r: Request):
        for p in r.pages:
            self.table.free(p)
        r.pages = []
        r.done = True
        self._finished.append(r)
        if self.bus is not None:
            self.bus.publish_request({
                "rid": r.rid, "prompt_len": r.prompt_len,
                "tokens": len(r.out_tokens),
                "shared_pages": r.shared_pages,
                "decode_batches": list(r.decode_batches),
                "phase_cycles": dict(r.phase_cycles)})

    def _admit(self):
        while self._waiting and (len(self._active) + len(self._prefilling)
                                 < self.config.buckets[-1]):
            if not self._try_admit(self._waiting[0]):
                break                   # FCFS: the head blocks the line
            self._waiting.popleft()

    def _decode_round(self):
        c = self.config
        sel = self._active[:c.buckets[-1]]
        bucket = next(b for b in c.buckets if b >= len(sel))
        self.bucket_hist[bucket] = self.bucket_hist.get(bucket, 0) + 1
        pages = np.zeros((bucket, c.max_pages), np.int32)
        pos = np.zeros(bucket, np.int32)
        toks = np.zeros((bucket, 1), np.int32)
        for i, r in enumerate(sel):
            pages[i, :len(r.pages)] = r.pages
            pos[i] = r.pos + 1
            toks[i, 0] = r.last_tok
        (_, _, _, next_tok), d = self._step(
            "decode", bucket, self.params, self.pool_k, self.pool_v,
            {"tokens": self._tensor(toks), "pos": self._tensor(pos),
             "pages": self._tensor(pages),
             "pos_host": tuple(int(p) for p in pos)})
        next_tok = next_tok.cpu().numpy()
        finished = []
        for i, r in enumerate(sel):
            r.pos += 1
            tok = int(next_tok[i])
            r.out_tokens.append(tok)
            self.tokens_out += 1
            r.last_tok = tok
            r.decode_batches.append(bucket)
            r.phase_cycles["decode"] += d
            if len(r.out_tokens) >= r.max_new:
                finished.append(r)
        for r in finished:
            self._active.remove(r)
            self._complete(r)

    def run(self) -> List[Request]:
        """Serve until every submitted request has finished; returns the
        requests completed by this call, in submission order."""
        start = len(self._finished)
        while self._waiting or self._active or self._prefilling:
            self._admit()
            progressed = False
            if self._prefilling:         # one chunk quantum per round,
                self._chunk_step()       # interleaved with decode below
                progressed = True
            if self._active:
                self._decode_round()
                progressed = True
            if not progressed and self._waiting:
                # head unadmittable with an otherwise idle engine
                r = self._waiting[0]
                raise PagePoolExhausted(
                    f"request {r.rid} needs "
                    f"{self._pages_needed(len(r.prompt), r.max_new)} pages "
                    f"with only {self.table.free_pages} free")
        return sorted(self._finished[start:], key=lambda r: r.rid)

    def reap(self) -> List[Request]:
        """Pop every finished request. Long-lived servers call this per
        wave so engine-held state stays constant-size."""
        out, self._finished = self._finished, []
        return out

    # -- teardown / reporting -------------------------------------------
    def drain(self):
        """Release prefix-cache page references through the evictor;
        with no requests in flight the page table must then balance —
        checked here so drain can't mask a refcount leak."""
        if self.tree is not None:
            self.tree.evict_all()
        if not (self._waiting or self._active or self._prefilling) \
                and not self.table.balanced():
            raise RuntimeError(f"page table unbalanced after drain: "
                               f"{self.table.used_pages} pages still "
                               f"referenced")

    def close(self):
        """Close the probe sessions (restores each step's original sink;
        their final snapshots are dropped)."""
        if self.config.probe:
            for entry in self._steps.values():
                entry.close()

    def stats(self) -> Dict[str, Any]:
        hits = self.tree.hits if self.tree else 0
        misses = self.tree.misses if self.tree else 0
        return {
            "requests": len(self._finished),
            "phases": {p: dict(v) for p, v in self.phase_stats.items()},
            "retraces": self.retraces(),
            "pages_peak": self.table.peak_used,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": hits / (hits + misses) if hits + misses
            else 0.0,
            "buckets": dict(self.bucket_hist),
            "steps_traced": len(self._steps),
            "evictions": self.evictions,
            "hol_blocked_steps": self.hol_blocked_steps,
            "tokens_out": self.tokens_out,
        }

    def phase_table(self) -> str:
        return report.engine_phase_table(self.phase_stats)

    def chunk_table(self) -> str:
        return report.engine_chunk_table(self.chunk_stats)

    def request_table(self, requests: List[Request]) -> str:
        return report.engine_request_table(requests)
