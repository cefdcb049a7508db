"""The port's continuous-batching engine against the JAX package.

- the mixed trace of ``tests/test_engine.py`` served by the port's
  ``InferenceEngine`` (dense and kernel decode, whole and chunked
  prefill) gives the token ids of the port's own unbatched loop and of
  JAX's unbatched reference serving path, with zero retraces, a prefix
  hit and balanced pages after ``drain``;
- the step-level chunked prefill equals the whole-prompt prefill;
- probed (``probe=True``), the engine serves the same trace with the
  unprobed engine's token ids and KV pools and JAX's probed engine's ids,
  decode batches, shared pages, phase steps and chunk shapes; each
  request's phase bill is exact (prefill and cache cycles sum to the
  phase totals, every decode round's delta is billed to each of its
  riders), retraces stay 0, and a bus sees the engine's phase totals;
  cycles are compared only within the port (the two packages price on
  different chips' constants);
- ``serve(profile=True)`` gives ``profile=False``'s ids, engine (whole
  and chunked prefill) and the mamba2 legacy loop, with a status server;
- the page-table / prefix-tree unit cases of ``tests/test_engine.py``
  hold for the port's copy of the module.

JAX comparisons run at float32 compute, where both packages make the
same explicit bf16 roundings (see ``test_torch_model.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.distributed.steps import build_decode_step, build_prefill_step
from repro.engine import EngineConfig as JaxEngineConfig
from repro.engine import InferenceEngine as JaxInferenceEngine
from repro.models import Model as JaxModel
from repro_torch.configs.registry import smoke_config
from repro_torch.engine import (NULL_PAGE, EngineConfig, InferenceEngine,
                                PagePoolExhausted, PageTable, PrefixTree,
                                build_chunk_prefill, build_engine_prefill,
                                build_page_scatter)
from repro_torch.launch.serve import serve
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.telemetry import TelemetryBus

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")


def _mixed_trace(vocab, seed=7):
    """tests/test_engine.py::_mixed_trace: two prompts share a 16-token
    (one-page) prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16).tolist()
    prompts = [prefix + rng.integers(0, vocab, 5).tolist(),
               rng.integers(0, vocab, 7).tolist(),
               prefix + rng.integers(0, vocab, 9).tolist()]
    return prompts, [5, 3, 4]


def _jax_reference_serve(model, params, prompt, max_new):
    """tests/test_engine.py::_reference_serve: batch-1 dense-cache JAX."""
    P = len(prompt)
    pf = jax.jit(build_prefill_step(model, ShapeConfig("r", 128, 1,
                                                       "prefill")))
    dec = jax.jit(build_decode_step(model))
    lg, cache = pf(params, {"tokens": jnp.array([prompt], jnp.int32)})
    nt = jnp.argmax(lg, -1).astype(jnp.int32)
    out = [int(nt[0])]
    for i in range(max_new - 1):
        lg, cache, nt = dec(params, cache, {"tokens": nt[:, None],
                                            "pos": jnp.int32(P + i)})
        out.append(int(nt[0]))
    return out


def _port_reference_serve(model, params, prompt, max_new):
    """The port's unbatched loop: Model.prefill + decode_step, batch 1."""
    P = len(prompt)
    cp = model._compute_cast(params)
    lg, cache = model.prefill(cp, {"tokens": torch.tensor([prompt])}, 128)
    nt = torch.argmax(lg, -1).to(torch.int32)
    out = [int(nt[0])]
    for i in range(max_new - 1):
        lg, cache, nt = model.decode_step(cp, cache, {"tokens": nt[:, None],
                                                      "pos": P + i})
        out.append(int(nt[0]))
    return out


@pytest.fixture(scope="module")
def f32_pair():
    """(port model, port params, JAX reference tokens) at f32 compute."""
    jm = JaxModel(jax_smoke_config("tinyllama-1.1b").replace(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config("tinyllama-1.1b").replace(**F32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    prompts, max_new = _mixed_trace(257)
    refs = [_jax_reference_serve(jm, jp, p, m)
            for p, m in zip(prompts, max_new)]
    return tm, tp, refs, (jm, jp)


def _serve_trace(model, params, **over):
    prompts, max_new = _mixed_trace(model.cfg.vocab_size)
    kw = dict(page_size=16, pool_pages=16, max_pages=2, buckets=(1, 2, 4))
    eng = InferenceEngine(model, params, EngineConfig(**{**kw, **over}))
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    done = eng.run()
    st = eng.stats()
    eng.drain()
    assert eng.table.balanced()
    return [r.out_tokens for r in done], st


@pytest.mark.parametrize("over", [
    dict(),
    dict(use_kernel=True, pages_per_step=2),
    # two decode slots: the third request waits until the first has
    # published its prefix page, so the chunked run also takes a hit
    dict(use_kernel=True, prefill_chunk_pages=1, buckets=(1, 2)),
])
def test_engine_matches_unbatched_and_jax(f32_pair, over):
    model, params, refs, _ = f32_pair
    prompts, max_new = _mixed_trace(257)
    own = [_port_reference_serve(model, params, p, m)
           for p, m in zip(prompts, max_new)]
    toks, st = _serve_trace(model, params, **over)
    assert toks == own
    assert toks == refs
    assert st["retraces"] == 0
    assert st["prefix_hits"] >= 1                  # third request reuses
    if over.get("prefill_chunk_pages"):
        assert st["phases"]["chunkpf"]["steps"] >= 1


def test_engine_bf16_matches_own_unbatched_loop():
    """At bf16 compute the engine (paged pool, padded prefill, batched
    decode) still gives the port's unbatched loop's token ids."""
    model = Model(smoke_config("tinyllama-1.1b"))
    params = model.init(0, "cpu")
    prompts, max_new = _mixed_trace(257)
    own = [_port_reference_serve(model, params, p, m)
           for p, m in zip(prompts, max_new)]
    toks, st = _serve_trace(model, params, use_kernel=True,
                            prefill_chunk_pages=1)
    assert toks == own and st["retraces"] == 0


def test_warmup_builds_every_step_and_leaves_serving_unchanged(f32_pair):
    """warmup() builds each (phase, shape) once and writes only the null
    page; serving afterwards builds nothing new and gives the same ids."""
    model, params, refs, _ = f32_pair
    prompts, max_new = _mixed_trace(257)
    eng = InferenceEngine(model, params, EngineConfig(
        page_size=16, pool_pages=16, max_pages=2, buckets=(1, 2, 4),
        use_kernel=True, prefill_chunk_pages=1))
    eng.warmup()
    built = len(eng._steps)
    assert eng.pool_k[:, 1:].abs().sum() == 0          # only the null page
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    assert [r.out_tokens for r in eng.run()] == refs
    assert len(eng._steps) == built and eng.retraces() == 0
    assert len(eng.reap()) == 3 and not eng.reap()


@pytest.mark.parametrize("policy", ["lru", "clear"])
def test_engine_evicts_under_pool_pressure(f32_pair, policy):
    """Two usable pages, one decode slot: the prefix tree holds both
    finished requests' prompt pages, so admitting the third request
    reclaims a page (LRU: the second request's, sparing the third's
    shared prefix; clear: all of them) and the ids still equal the
    unbatched loop's."""
    model, params, _, _ = f32_pair
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 257, 16).tolist()
    prompts = [prefix + rng.integers(0, 257, 5).tolist(),
               rng.integers(0, 257, 16).tolist(),
               prefix + rng.integers(0, 257, 9).tolist()]
    max_new = [3, 1, 3]
    own = [_port_reference_serve(model, params, p, m)
           for p, m in zip(prompts, max_new)]
    eng = InferenceEngine(model, params, EngineConfig(
        page_size=16, pool_pages=3, max_pages=2, buckets=(1,),
        evict_policy=policy))
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    assert [r.out_tokens for r in eng.run()] == own
    st = eng.stats()
    assert st["evictions"] >= 1
    assert st["prefix_hits"] == (1 if policy == "lru" else 0)
    eng.drain()
    assert eng.table.balanced()


def test_chunk_prefill_step_equals_whole(f32_pair):
    """Step level, as tests/test_engine.py does: a 2-page prompt prefilled
    page 0 whole + page 1 via chunkpf equals the one-shot 2-page prefill,
    logits at the real last token and the page-major KV blocks, bit for
    bit (each attention row walks the same kv blocks either way, and the
    CPU matmuls here are row-independent)."""
    model, params, _, _ = f32_pair
    cfg = model.cfg
    ps, P = 16, 27
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (1, 2 * ps)).astype(np.int32)
    toks[0, P:] = 0
    toks = torch.from_numpy(toks)
    lg_w, k_w, v_w = build_engine_prefill(model, 2, ps)(
        params, {"tokens": toks, "last_idx": torch.tensor([P - 1])})
    lg0, k0, v0 = build_engine_prefill(model, 1, ps)(
        params, {"tokens": toks[:, :ps], "last_idx": torch.tensor([ps - 1])})
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    pool_k = torch.zeros((cfg.num_layers, 8, ps, kv, hd))
    pool_v = torch.zeros_like(pool_k)
    build_page_scatter(1)(pool_k, pool_v, k0, v0, torch.tensor([3]))
    lg_c, k_c, v_c = build_chunk_prefill(model, 1, 1, ps)(
        params, pool_k, pool_v,
        {"tokens": toks[:, ps:], "ctx_pages": torch.tensor([3]),
         "last_idx": torch.tensor([P - 1 - ps])})
    assert torch.equal(lg_w, lg_c)
    assert torch.equal(k_w[:, :1], k0) and torch.equal(v_w[:, :1], v0)
    assert torch.equal(k_w[:, 1:], k_c) and torch.equal(v_w[:, 1:], v_c)


PROBED = {
    "whole_dense": dict(),
    "whole_kernel": dict(use_kernel=True, pages_per_step=2),
    "chunked_kernel": dict(use_kernel=True, prefill_chunk_pages=1,
                           buckets=(1, 2)),
}
_KW = dict(page_size=16, pool_pages=16, max_pages=2, buckets=(1, 2, 4))


def _serve_engine(eng, prompts, max_new):
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    return eng.run()


def _jax_probed_serve(jm, jp, over):
    prompts, max_new = _mixed_trace(257)
    eng = JaxInferenceEngine(jm, jp, JaxEngineConfig(
        **{**_KW, **over}, probe=True, interpret=True))
    done = _serve_engine(eng, prompts, max_new)
    out = dict(tokens=[r.out_tokens for r in done],
               batches=[r.decode_batches for r in done],
               shared=[r.shared_pages for r in done],
               steps={p: v["steps"] for p, v in eng.phase_stats.items()},
               chunks={k: v["steps"] for k, v in eng.chunk_stats.items()})
    eng.close()
    return out


@pytest.mark.parametrize("name", sorted(PROBED))
def test_probed_engine_bills_and_matches_unprobed_and_jax(f32_pair, name):
    model, params, refs, (jm, jp) = f32_pair
    over = PROBED[name]
    prompts, max_new = _mixed_trace(257)
    plain = InferenceEngine(model, params, EngineConfig(**{**_KW, **over}))
    want = [r.out_tokens for r in _serve_engine(plain, prompts, max_new)]
    bus = TelemetryBus()
    eng = InferenceEngine(model, params,
                          EngineConfig(**{**_KW, **over}, probe=True),
                          bus=bus)
    rounds = []                       # (decode delta, riders' rids)
    step = eng._step

    def spy(phase, size, *args):
        riders = [r.rid for r in eng._active[:eng.config.buckets[-1]]]
        out, d = step(phase, size, *args)
        if phase == "decode":
            rounds.append((d, riders))
        return out, d
    eng._step = spy
    done = _serve_engine(eng, prompts, max_new)
    toks = [r.out_tokens for r in done]
    assert toks == want == refs
    assert torch.equal(eng.pool_k, plain.pool_k)
    assert torch.equal(eng.pool_v, plain.pool_v)
    assert eng.retraces() == 0
    jax_run = _jax_probed_serve(jm, jp, over)
    assert toks == jax_run["tokens"]
    assert [r.decode_batches for r in done] == jax_run["batches"]
    assert [r.shared_pages for r in done] == jax_run["shared"]
    assert {p: v["steps"] for p, v in eng.phase_stats.items()} == \
        jax_run["steps"]
    assert {k: v["steps"] for k, v in eng.chunk_stats.items()} == \
        jax_run["chunks"]
    ph = eng.phase_stats
    for r in done:
        assert r.phase_cycles["prefill"] > 0 and r.phase_cycles["cache"] > 0
        assert r.phase_cycles["decode"] > 0
        assert r.phase_cycles["decode"] == sum(
            d for d, riders in rounds if r.rid in riders)
    assert sum(r.phase_cycles["prefill"] for r in done) == \
        ph["prefill"]["cycles"] + ph.get("chunkpf", {"cycles": 0})["cycles"]
    assert sum(r.phase_cycles["cache"] for r in done) == ph["cache"]["cycles"]
    assert len(rounds) == ph["decode"]["steps"]
    assert sum(d for d, _ in rounds) == ph["decode"]["cycles"]
    K = over.get("prefill_chunk_pages", 0)
    if K:       # the chunk bill covers the requests wider than K pages
        wide = [r for r in done if -(-len(r.prompt) // 16) > K]
        assert sum(v["cycles"] for v in eng.chunk_stats.values()) == sum(
            r.phase_cycles["prefill"] + r.phase_cycles["cache"]
            for r in wide)
    assert bus.engine.phases == eng.phase_stats
    assert bus.engine.requests_done == len(done)
    tags = {f"engine/{p}x{z if isinstance(z, int) else 'x'.join(map(str, z))}"
            for p, z in eng._steps}
    assert set(bus.streams()) == tags
    assert "per-phase" not in eng.phase_table()
    assert len(eng.request_table(done).splitlines()) == len(done) + 1
    eng.drain()
    eng.close()
    for entry in eng._steps.values():
        assert entry._closed


@pytest.mark.parametrize("kw", [
    dict(),
    dict(engine_kernel=True, prefill_chunk=1),
    dict(arch="mamba2-370m", profile_every=2),
])
def test_serve_profile_gives_the_unprofiled_ids(kw, capsys):
    base = dict(batch=2, prompt_len=20, max_new=4, device="cpu")
    plain = serve(**base, **kw)
    res = serve(**base, **kw, profile=True, status_port=0)
    assert (res.tokens == plain.tokens).all()
    out = capsys.readouterr().out
    assert "[telemetry] status server on http://127.0.0.1:" in out
    if kw.get("arch"):
        assert res.snapshot is not None and res.snapshot.steps == 3
        assert "[probe] decode step    2: span=" in out
        assert "# bottleneck drift across windows" in out
    else:
        assert res.stats["retraces"] == 0
        assert "# per-request phase bill" in out
        assert ("# per-chunk-shape prefill bill" in out) == \
            bool(kw.get("prefill_chunk"))


def test_engine_refuses_unported_families():
    """As JAX's engine: recurrent state (ssm, hybrid) and frontend embeds
    have no paged-KV analogue; MoE runs (``test_torch_moe.py``)."""
    for arch in ("mamba2-370m", "zamba2-2.7b", "musicgen-large",
                 "qwen2-vl-72b"):
        cfg = smoke_config(arch)
        model = Model.__new__(Model)
        model.cfg = cfg
        with pytest.raises(ValueError, match="attention-family"):
            InferenceEngine(model, {})


# ------------------------------------------------- page table / trie
# the unit cases of tests/test_engine.py, against the port's copy

def test_pagetable_alloc_share_free_roundtrip():
    t = PageTable(8, 16)
    assert t.free_pages == 7 and t.balanced()
    a = t.alloc(3)
    assert len(set(a)) == 3 and NULL_PAGE not in a
    assert t.used_pages == 3 and t.peak_used == 3
    t.share(a[0])
    t.free(a[0])
    assert t.used_pages == 3
    for p in a:
        t.free(p)
    assert t.balanced() and t.peak_used == 3


def test_pagetable_errors():
    t = PageTable(4, 16)
    with pytest.raises(PagePoolExhausted):
        t.alloc(4)
    p = t.alloc(1)[0]
    t.free(p)
    with pytest.raises(ValueError):
        t.free(p)
    with pytest.raises(ValueError):
        t.share(p)
    with pytest.raises(ValueError):
        PageTable(1, 16)


def test_prefix_tree_match_insert_clear():
    t = PageTable(16, 4)
    tree = PrefixTree(t)
    pages = t.alloc(3)
    keys = [(1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12)]
    assert tree.insert(keys, pages) == 3
    got = tree.match(keys[:2])
    assert got == pages[:2] and tree.hits == 2
    assert tree.match([keys[0], (0, 0, 0, 0)]) == pages[:1]
    assert tree.misses == 1
    assert tree.lookup(keys) == 3
    for p in got + pages[:1]:
        t.free(p)
    for p in pages:
        t.free(p)
    assert not t.balanced()
    tree.clear()
    assert t.balanced() and tree.nodes == 0


def test_prefix_tree_lru_victim_order_deterministic():
    t = PageTable(16, 4)
    tree = PrefixTree(t)
    pages = t.alloc(3)
    keys = [(i, i, i, i) for i in range(3)]
    for k, p in zip(keys, pages):
        tree.insert([k], [p])
        t.free(p)
    for p in tree.match([keys[1]]):
        t.free(p)
    assert tree.evict(2) == [pages[0], pages[2]]
    assert tree.evict(5) == [pages[1]]
    assert tree.nodes == 0 and t.balanced()
    assert tree.evicted == 3


def test_prefix_tree_evict_leaf_first_cascade():
    t = PageTable(16, 4)
    tree = PrefixTree(t)
    pages = t.alloc(3)
    keys = [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3)]
    tree.insert(keys, pages)
    for p in pages:
        t.free(p)
    assert tree.evict(3) == pages[::-1]
    assert t.balanced()


def test_prefix_tree_evict_spares_in_use_and_protected():
    t = PageTable(16, 4)
    tree = PrefixTree(t)
    pages = t.alloc(3)
    keys = [(i, i, i, i) for i in range(3)]
    for k, p in zip(keys, pages):
        tree.insert([k], [p])
    t.free(pages[1])
    t.free(pages[2])
    assert tree.evict(3, protect=[keys[2]]) == [pages[1]]
    assert t.refcount[pages[0]] == 2 and t.refcount[pages[2]] == 1
    freed = tree.evict_all()
    assert freed == [pages[2]]
    assert t.refcount[pages[0]] == 1
    t.free(pages[0])
    assert t.balanced()
