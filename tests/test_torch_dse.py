"""The port's DSE (``repro_torch.core.dse``, ``incremental``,
``overhead``, ``kernels.tuning`` / ``ops`` / ``search_spaces``, the tune
CLI) against ``repro.core``'s, on the CPU.

- The engine: the JAX package's toy space (``tests/test_dse_engine.py``)
  and the same toy in torch, each on its own model clock, give the same
  winner, leaderboard order, survivors at each successive-halving rung,
  ``n_measurements`` and ``measured_steps``. Cycles are compared only
  within a framework (the two clocks price different chips).
- The cache: hit, miss, longer-run requirement, invalidation when the
  fingerprint changes (an edited program or kernel source), the latest
  run's winner, entry keys byte-equal to JAX's for the same key fields,
  and no lost entries across processes.
- Budget pruning: the flash tiles the H100 cannot hold (kv blocks of 128
  keys at head dim 128) are rejected, before any launch.
- ``run_dse`` on a small program: each point's probes, state bytes and
  offloaded bytes, and the Pareto front over those deterministic
  metrics, against JAX's ``run_dse`` on the same program (the port's
  state has int64 call counts where JAX's has uint32: 4 bytes a probe
  more; the rows offloaded have the same 16 bytes a slot).
- The overhead model's coefficients equal JAX's on the same samples.
- Tuning precedence (explicit > tuned > default) through ``kernels.ops``
  and the model paths, ``load_cache``, ``python -m repro_torch.tune
  --device cpu`` and ``measure_incremental``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DSEEngine as JaxDSEEngine
from repro.core import EvalCache as JaxEvalCache
from repro.core import OverheadModel as JaxOverheadModel
from repro.core import ProbeConfig as JaxProbeConfig
from repro.core import SearchSpace as JaxSearchSpace
from repro.core import run_dse as jax_run_dse
from repro.core.buffer import state_bytes as jax_state_bytes
from repro_torch.core import (DeviceBudget, DSEEngine, EvalCache,
                              OverheadModel, ProbeConfig, SearchSpace,
                              adapt_allocation, measure_incremental,
                              measure_overhead, run_dse, scope)
from repro_torch.core import costmodel as cm
from repro_torch.core.buffer import state_bytes
from repro_torch.core.incremental import capture_fingerprint
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, tuning
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import search_spaces as ss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_space(scale: float = 1.0, values=(1, 2, 4)) -> SearchSpace:
    """The JAX test's toy, in torch: model cycles grow with cfg['n']."""
    x = torch.ones((8, 16)) * 0.1
    w = torch.eye(16) * 0.5

    def bind(cfg):
        def fn(x, w):
            y = x
            for _ in range(cfg["n"]):
                y = torch.tanh(y @ w) * scale
            return y
        return fn

    return SearchSpace(kernel_id="toy", axes={"n": tuple(values)},
                       bind=bind, args=(x, w), default={"n": max(values)})


def jax_toy_space(values=(1, 2, 4)) -> JaxSearchSpace:
    x = jnp.ones((8, 16)) * 0.1
    w = jnp.eye(16) * 0.5

    def bind(cfg):
        def fn(x, w):
            y = x
            for _ in range(cfg["n"]):
                y = jnp.tanh(y @ w)
            return y
        return fn

    return JaxSearchSpace(kernel_id="toy", axes={"n": tuple(values)},
                          bind=bind, args=(x, w),
                          default={"n": max(values)})


class _Rungs:
    """Records (config, steps) of every evaluation, rung by rung."""

    def __init__(self, engine):
        self.log = []
        inner = engine.evaluate

        def evaluate(t, steps):
            self.log.append((t.config["n"], steps))
            return inner(t, steps)
        engine.evaluate = evaluate


@pytest.fixture()
def cache(tmp_path):
    return EvalCache(str(tmp_path / "dse"))


# ------------------------------------------------------ engine vs JAX

@pytest.mark.parametrize("values,r0,eta,max_steps", [
    ((1, 2, 4), 1, 2, 4),
    ((2, 4), 1, 2, 2),
    ((1, 2, 3, 4, 5), 1, 3, 9),
])
def test_toy_engine_agrees_with_jax(tmp_path, values, r0, eta, max_steps):
    kw = dict(r0=r0, eta=eta, max_steps=max_steps)
    te = DSEEngine(toy_space(values=values),
                   cache=EvalCache(str(tmp_path / "t")), **kw)
    je = JaxDSEEngine(jax_toy_space(values=values),
                      cache=JaxEvalCache(str(tmp_path / "j")), **kw)
    tr, jr = _Rungs(te), _Rungs(je)
    t, j = te.tune(), je.tune()
    assert tr.log == jr.log                      # survivors at each rung
    assert t.best.config == j.best.config
    rank = lambda r: [x.config for x in sorted(  # noqa: E731
        (x for x in r.trials if x.measured), key=lambda x: x.cycles_per_step)]
    assert rank(t) == rank(j)
    assert (t.n_measurements, t.measured_steps, t.n_candidates) == \
        (j.n_measurements, j.measured_steps, j.n_candidates)
    assert "DSE leaderboard: toy on cpu" in t.leaderboard()
    # warm: no new measurement, the same winner, in both
    t2 = DSEEngine(toy_space(values=values),
                   cache=EvalCache(str(tmp_path / "t")), **kw).tune()
    j2 = JaxDSEEngine(jax_toy_space(values=values),
                      cache=JaxEvalCache(str(tmp_path / "j")), **kw).tune()
    assert t2.n_measurements == j2.n_measurements == 0
    # the port also reads the default's run at the finalists' rung
    assert t2.n_cache_hits >= j2.n_cache_hits
    assert t2.best.config == t.best.config


# ------------------------------------------------------------- cache

def test_cache_hit_miss_and_fingerprint_invalidation(cache):
    cfg = {"block_q": 64, "block_k": 64}
    assert cache.get("flash_attention", cfg, "aaaa", "cpu") is None
    cache.put("flash_attention", cfg, "aaaa", "cpu", cycles_per_step=123.0,
              steps=4)
    assert cache.get("flash_attention", cfg, "aaaa", "cpu")[
        "cycles_per_step"] == 123.0
    assert cache.get("flash_attention", cfg, "aaaa", "cpu",
                     min_steps=8) is None
    assert cache.get("flash_attention", cfg, "bbbb", "cpu") is None
    assert cache.get("flash_attention", {**cfg, "block_q": 128}, "aaaa",
                     "cpu") is None
    again = EvalCache(cache.root)
    assert again.best_config("flash_attention", "cpu") == cfg
    # a shorter re-measure never downgrades a longer one
    kept = cache.put("flash_attention", cfg, "aaaa", "cpu",
                     cycles_per_step=9.0, steps=1)
    assert kept["steps"] == 4 and kept["cycles_per_step"] == 123.0


def test_warm_run_and_edits_through_the_engine(cache):
    cold = DSEEngine(toy_space(), cache=cache, max_steps=2).tune()
    warm = DSEEngine(toy_space(), cache=cache, max_steps=2).tune()
    assert cold.n_measurements > 0 and warm.n_measurements == 0
    assert warm.best.config == cold.best.config
    # an edited program (another constant) changes every fingerprint
    edited = DSEEngine(toy_space(scale=2.0), cache=cache, max_steps=2).tune()
    assert edited.n_measurements == cold.n_measurements
    # the latest run decides the served winner
    DSEEngine(toy_space(values=(2, 4)), cache=cache, max_steps=2).tune()
    assert cache.best_config("toy", "cpu") == {"n": 2}
    cache.clear("toy")
    assert cache.best_config("toy", "cpu") is None


def test_a_kernel_source_edit_changes_exactly_its_fingerprints(
        monkeypatch, tmp_path):
    """The fingerprint hashes the CUDA sources of the kernels a
    candidate reaches: editing the flash sources changes a flash
    candidate's, not a paged one's."""
    from repro_torch.kernels import _build
    fsp = ss.flash_attention_space(S=64, D=64, device="cpu")
    psp = ss.paged_attention_space(device="cpu")
    before = [capture_fingerprint(sp.bind(sp.default), sp.args)
              for sp in (fsp, psp)]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    (csrc / "flash_attention.cuh").write_bytes(
        (csrc / "flash_attention.cuh").read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    after = [capture_fingerprint(sp.bind(sp.default), sp.args)
             for sp in (fsp, psp)]
    assert after[0] != before[0] and after[1] == before[1]


@pytest.mark.parametrize("kernel_id,config,fp,device", [
    ("flash_attention", {"block_q": 64, "block_k": 64}, "aaaa", "cpu"),
    ("toy", {"n": 3}, "0123456789abcdef", "cuda:NVIDIA H100 80GB HBM3"),
    ("paged_attention", {"tile_slots": 32, "pages_per_step": 2}, "f|x",
     "cpu:cpu"),
])
def test_entry_keys_equal_jax(kernel_id, config, fp, device):
    assert EvalCache.entry_key(kernel_id, config, fp, device) == \
        JaxEvalCache.entry_key(kernel_id, config, fp, device)


_WRITER = """
import sys
from repro_torch.core import EvalCache
root, tag = sys.argv[1], sys.argv[2]
cache = EvalCache(root)
for i in range(40):
    cache.put("toy", {"n": i}, "f" + tag, "cpu",
              cycles_per_step=float(i), steps=4)
cache.set_winner("toy_" + tag, "cpu", {"n": int(tag)}, cycles_per_step=1.0)
print("done")
"""


def test_concurrent_writers_lose_no_entries(tmp_path):
    root = str(tmp_path / "shared")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, root, tag],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for tag in "01"]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
        assert b"done" in out
    merged = EvalCache(root)
    for tag in "01":
        assert len([e for e in merged.entries("toy")
                    if e["fingerprint"] == f"f{tag}"]) == 40
        assert merged.best_config(f"toy_{tag}", "cpu") == {"n": int(tag)}


# ---------------------------------------------------------- pruning

def test_budget_rejects_the_tiles_the_card_cannot_hold(cache):
    sp = ss.flash_attention_space(S=128, D=128, device="cpu")
    eng = DSEEngine(sp, cache=cache)
    trials = [eng.analyze(c) for c in sp.candidates()]
    alive = eng.prune(trials)
    assert sorted((t.config["block_q"], t.config["block_k"])
                  for t in trials if t.pruned) == [(64, 128), (128, 128)]
    assert all("smem" in t.pruned for t in trials if t.pruned)
    assert len(alive) == 4 and not any(t.fingerprint for t in trials)
    sp64 = ss.flash_attention_space(S=128, D=64, device="cpu")
    assert not DSEEngine(sp64, cache=cache).prune(
        [eng.analyze(c) for c in sp64.candidates()]) == []
    # a tighter ceiling prunes what exceeds it and nothing else
    tight = DeviceBudget(smem_bytes=100_000)
    eng = DSEEngine(sp64, budget=tight, cache=cache)
    trials = [eng.analyze(c) for c in sp64.candidates()]
    alive = eng.prune(trials)
    assert 0 < len(alive) < len(trials)
    assert all(t.resources.smem_bytes <= 100_000 for t in alive)


def test_tune_over_the_kernel_spaces(cache):
    for sp in (ss.flash_attention_space(S=128, D=128, device="cpu"),
               ss.paged_attention_space(device="cpu"),
               ss.ssd_scan_space(L=128, chunks=(32, 64, 128), device="cpu")):
        res = DSEEngine(sp, cache=cache, max_steps=2).tune()
        assert res.best is not None and res.best.measured
        assert res.default.measured and res.speedup >= 1.0
        assert cache.best_config(sp.kernel_id, "cpu") == res.best.config
        assert cache.winners(sp.kernel_id, "cpu") == {
            tuning.shape_key(sp.kernel_id, sp.args): res.best.config}
        warm = DSEEngine(sp, cache=cache, max_steps=2).tune()
        assert warm.n_measurements == 0
        assert warm.best.config == res.best.config


def test_measure_tiles_and_calibrate():
    sp = ss.flash_attention_space(S=128, D=64, device="cpu")
    eng = DSEEngine(sp, budget=None, cache=EvalCache(os.devnull + "_x"))
    t = eng.measure_tiles(eng.analyze({"block_q": 64, "block_k": 32}))
    assert t.tile_measured > 0 and t.tile_static > 0 and t.tile_dma > 0
    assert t.tile_residual == t.tile_static - t.tile_measured
    cm.clear_kernel_calibration()
    try:
        scale = eng.calibrate([t])
        assert scale == t.tile_measured / t.tile_static
        assert cm.kernel_calibration_state() == (("flash_kernel", scale),)
    finally:
        cm.clear_kernel_calibration()


# ------------------------------------------------------- run_dse vs JAX

def _t_fn(x, w):
    with scope.named_scope("layers"):
        for _ in scope.scan(6):
            with scope.named_scope("layer"):
                with scope.named_scope("attn"):
                    x = torch.tanh(x @ w) @ w.T + x
                with scope.named_scope("mlp"):
                    x = torch.nn.functional.silu(x @ w) @ w.T + x
    with scope.named_scope("head"):
        return torch.sum(x * x)


def _j_fn(x, w):
    import jax

    def body(c, _):
        with jax.named_scope("layer"):
            with jax.named_scope("attn"):
                c = jnp.tanh(c @ w) @ w.T + c
            with jax.named_scope("mlp"):
                c = jax.nn.silu(c @ w) @ w.T + c
        return c, None
    with jax.named_scope("layers"):
        x, _ = jax.lax.scan(body, x, None, length=6)
    with jax.named_scope("head"):
        return jnp.sum(x * x)


def _front(points):
    """The Pareto front over the deterministic metrics (state bytes,
    offloaded bytes), as (storage, ratio) pairs."""
    def dom(a, b):
        return (a.state_bytes <= b.state_bytes and a.dram_bytes <=
                b.dram_bytes and (a.state_bytes, a.dram_bytes) !=
                (b.state_bytes, b.dram_bytes))
    return sorted((p.storage, p.offload_ratio) for p in points
                  if not any(dom(o, p) for o in points))


def test_run_dse_points_match_jax():
    X = np.ones((8, 32), np.float32) * 0.1
    W = np.full((32, 32), 0.05, np.float32)
    kw = dict(storages=("registers", "bram"), offload_ratios=(0.0, 0.5),
              repeats=1)
    t = run_dse(_t_fn, (torch.from_numpy(X), torch.from_numpy(W)),
                ProbeConfig(inline="off_all"), device="cpu", **kw)
    j = jax_run_dse(_j_fn, (jnp.asarray(X), jnp.asarray(W)),
                    JaxProbeConfig(inline="off_all"), **kw)
    assert len(t.points) == len(j.points) == 4
    for a, b in zip(t.points, j.points):
        assert (a.storage, a.depth, a.offload_ratio, a.n_probes) == \
            (b.storage, b.depth, b.offload_ratio, b.n_probes)
        assert a.state_bytes == state_bytes(a.n_probes, a.depth) == \
            jax_state_bytes(b.n_probes, b.depth) + 4 * b.n_probes
        assert a.dram_bytes == b.dram_bytes
        assert a.extra_eqns > 0
    assert any(p.dram_bytes > 0 for p in t.points if p.offload_ratio > 0)
    assert _front(t.points) == _front(j.points)
    assert 1 <= len(t.pareto) <= 4 and t.best() is not None
    assert all(not any(o.dominates(p) for o in t.points) for p in t.pareto)
    assert t.table()


# --------------------------------------------------- overhead model

def _samples():
    rng = np.random.default_rng(5)
    return [dict(n_probes=int(rng.integers(1, 40)),
                 event_sites=int(rng.integers(2, 200)),
                 transitions=int(rng.integers(1, 100)),
                 cf_sites=int(rng.integers(0, 6)),
                 extra_eqns=int(rng.integers(10, 900))) for _ in range(12)]


def test_overhead_model_coefficients_equal_jax():
    s = _samples()
    t, j = OverheadModel.fit(s), JaxOverheadModel.fit(s)
    np.testing.assert_array_equal(np.asarray(t.coefs), np.asarray(j.coefs))
    assert [t.predict_eqns(x) for x in s] == [j.predict_eqns(x) for x in s]


def test_measured_overhead_fits_and_allocation_adapts():
    X, W = torch.ones((8, 32)) * 0.1, torch.full((32, 32), 0.05)
    samples = [measure_overhead(_t_fn, (X, W), ProbeConfig(
        targets=tgt, buffer_depth=d, inline="off_all"), device="cpu")
        for tgt, d in [(("",), 4), (("layers",), 8),
                       (("layers/scan#0/layer",), 4), (("head",), 4)]]
    m = OverheadModel.fit(samples)
    for s in samples:
        assert abs(m.predict_eqns(s) - s["extra_eqns"]) <= \
            0.25 * max(s["extra_eqns"], 1)
        assert m.predict_state_bytes(s["n_probes"], s["depth"]) == \
            s["state_bytes"]
    few, many = samples[3], samples[0]
    assert many["n_probes"] > few["n_probes"]
    assert many["extra_eqns"] > few["extra_eqns"]
    n, d = adapt_allocation(50, 64, budget_bytes=state_bytes(50, 8))
    assert state_bytes(n, d) <= state_bytes(50, 8) and n == 50 and d <= 8
    n2, _ = adapt_allocation(50, 4, budget_bytes=state_bytes(10, 1))
    assert n2 < 50


def test_incremental_reuse():
    X, W = torch.ones((8, 32)) * 0.1, torch.full((32, 32), 0.05)
    t = measure_incremental(
        _t_fn, (X, W), ProbeConfig(targets=("layers",), inline="off_all"),
        ProbeConfig(targets=("layers/scan#0/layer/mlp",), inline="off_all"),
        device="cpu")
    assert t.base_compile_reused
    assert t.retarget_total_s < t.cold_total_s
    assert 0 < t.reuse_fraction < 1 and t.table()


# ---------------------------------------------------- tuned registry

def test_tuning_precedence_through_ops_and_the_model():
    tuning.clear_tuned()
    try:
        assert ops.flash_tiles(64) == (64, 64)
        tuning.set_tuned("flash_attention", {"block_q": 128, "block_k": 32})
        assert ops.flash_tiles(64) == (128, 32)
        assert ops.flash_tiles(64, block_q=64) == (64, 32)    # explicit wins
        assert ops.flash_tiles(64, 64, 64) == (64, 64)
        tuning.set_tuned("flash_attention", {"block_q": 64, "block_k": 128})
        assert ops.flash_tiles(64) == (64, 128)
        assert ops.flash_tiles(128) == (64, 64)   # the card cannot hold it
        # tuned tiles change the tiling, not the function
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, 2, 96, 16)).astype(np.float32)) for _ in range(3))
        tuned, probe_c = ops.flash_attention(q, k, v, with_probe=True)
        assert probe_c.shape[2] == 2                   # 96 rows in 64s
        np.testing.assert_allclose(tuned.numpy(), fa.flash_attention(
            q, k, v).numpy(), atol=5e-3)
        tuning.set_tuned("paged_attention", {"tile_slots": 32})
        calls = []
        real = pa.paged_attention

        def spy(*a, **kw):
            calls.append((kw["tile_slots"], kw["pages_per_step"]))
            return real(*a, **kw)
        pa_mod = ops._pa
        pa_mod.paged_attention = spy
        try:
            qp = torch.zeros((1, 1, 1, 8))
            pool = torch.zeros((3, 4, 1, 8))
            ops.paged_attention(qp, pool, pool, torch.zeros((1, 2),
                                dtype=torch.int32), torch.zeros(
                                (1,), dtype=torch.int32))
            ops.paged_attention(qp, pool, pool, torch.zeros((1, 2),
                                dtype=torch.int32), torch.zeros(
                                (1,), dtype=torch.int32), tile_slots=64,
                                pages_per_step=2)
        finally:
            pa_mod.paged_attention = real
        assert calls == [(32, 1), (64, 2)]
        tuning.set_tuned("ssd_scan", {"chunk": 64})
        assert ops.resolve_ssd_chunk(1024) == 64
        assert ops.resolve_ssd_chunk(40) == 40
    finally:
        tuning.clear_tuned()
    assert ops.flash_tiles(64) == (64, 64)
    assert ops.resolve_ssd_chunk(1024) == 256


def test_load_cache_into_the_registry(cache):
    cfg = {"block_q": 128, "block_k": 64}
    cache.put("flash_attention", cfg, "ffff", "cpu", cycles_per_step=10.0,
              steps=4)
    tuning.clear_tuned()
    try:
        loaded = tuning.load_cache("flash_attention", cache_dir=cache.root,
                                   device="cpu")
        assert loaded == {"flash_attention": {"": cfg}}
        assert tuning.tuned_value("flash_attention", "block_q", 64) == 128
        assert tuning.load_cache("flash_attention", cache_dir=cache.root,
                                 device="cuda:other") == {}
    finally:
        tuning.clear_tuned()


def test_tune_cli_on_the_cpu(tmp_path, capsys):
    """Every kernel through the CLI, at a batch whose rows need more
    pages than the paged space's 64-page pool default."""
    from repro_torch.launch.tune import main
    cache_dir = str(tmp_path / "cli")
    rc = main(["--device", "cpu", "--kernel", "all", "--seq", "256",
               "--batch", "5", "--dim", "64", "--heads", "1",
               "--cache-dir", cache_dir, "--max-steps", "2",
               "--json", str(tmp_path / "tune.json")])
    assert rc == 0
    out = capsys.readouterr().out
    for k in ("flash_attention", "ssd_scan", "paged_attention",
              "chunked_prefill"):
        assert f"DSE leaderboard: {k} on cpu" in out
        assert EvalCache(cache_dir).best_config(k, "cpu") is not None
    assert (tmp_path / "tune.json").exists()
    tuning.clear_tuned()


def test_serve_autotune_loads_the_tuned_tiles_on_the_cpu(tmp_path, capsys):
    """``serve --autotune``: the [autotune] banner, and the serve runs at
    the tuned flash and paged tiles (the model's calls go through
    ``kernels.ops``)."""
    from repro_torch.launch.serve import serve
    cache = EvalCache(str(tmp_path / "dse"))
    cache.set_winner("flash_attention", "cpu",
                     {"block_q": 128, "block_k": 32}, cycles_per_step=1.0)
    cache.set_winner("paged_attention", "cpu", {"tile_slots": 32},
                     cycles_per_step=1.0)
    seen = []
    real = fa.flash_attention

    def spy(*a, **kw):
        seen.append((kw["block_q"], kw["block_k"]))
        return real(*a, **kw)
    tuning.clear_tuned()
    ops._fa.flash_attention = spy
    try:
        kw = dict(batch=2, prompt_len=20, max_new=3, device="cpu",
                  engine_kernel=True)
        res = serve(**kw, autotune=True, tune_cache=cache.root)
        out = capsys.readouterr().out
        assert "[autotune] flash_attention: {'block_k': 32, 'block_q': 128}" \
            in out
        assert "[autotune] paged_attention: {'tile_slots': 32}" in out
        assert seen and set(seen) == {(128, 32)}
        assert tuning.tuned("paged_attention") == {"tile_slots": 32}
    finally:
        ops._fa.flash_attention = real
        tuning.clear_tuned()
    assert res.tokens.shape == (2, 3)


class _NoisyToy(DSEEngine):
    """The toy on a clock that reads differently each run (a wall clock)."""
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.rng = np.random.default_rng(len(self.space.axes["n"]))

    def _measure(self, config, steps):
        super()._measure(config, steps)
        return float(config["n"] * 10 + self.rng.normal(0.0, 25.0)), 0.0


def test_warm_run_repeats_a_noisy_cold_run_from_the_cache(cache):
    """A rung reads the cached run of exactly its steps: the warm run takes
    the cold run's path, with no new measurement and the same winner."""
    sp = toy_space(values=(1, 2, 3, 4, 5, 6))
    cold = _NoisyToy(sp, cache=cache, max_steps=4).tune()
    warm = _NoisyToy(sp, cache=cache, max_steps=4).tune()
    assert cold.n_measurements > 0 and warm.n_measurements == 0
    assert warm.best.config == cold.best.config
    assert warm.best.cycles_per_step == cold.best.cycles_per_step
    e = cache.get("toy", cold.best.config, cold.best.fingerprint, "cpu", 1)
    assert set(e["history"]) >= {"1", "4"}


class _SpreadToy(DSEEngine):
    """The toy on a clock whose readings carry a fixed spread: the default
    (n 4) reads 100 a step, n 1 reads 97, n 2 reads 120."""
    SPREAD = 0.0

    def _measure(self, config, steps):
        super()._measure(config, steps)
        return {1: 97.0, 2: 120.0, 4: 100.0}[config["n"]], self.SPREAD


@pytest.mark.parametrize("spread,winner", [(0.05, 4), (0.01, 1)])
def test_a_candidate_must_beat_the_default_by_the_measured_spread(
        cache, spread, winner):
    """3 % faster than the default wins only when the readings spread by
    less than 3 %; the spread is kept in the cache, so a warm re-run
    decides alike."""
    eng = type("E", (_SpreadToy,), {"SPREAD": spread})
    res = eng(toy_space(), cache=cache, max_steps=2).tune()
    assert res.best.config == {"n": winner}
    assert res.default.spread == spread
    warm = eng(toy_space(), cache=cache, max_steps=2).tune()
    assert warm.n_measurements == 0 and warm.best.config == {"n": winner}
    assert warm.default.spread == spread


def test_autotune_applies_a_winner_only_at_its_own_shape(cache):
    """Winners tuned at two flash shapes are each applied at their own
    shape and at no other; a paged winner holds at any pool size."""
    rng = np.random.default_rng(0)

    def qkv(B, S):
        return tuple(torch.from_numpy(rng.standard_normal(
            (B, 2, S, 64)).astype(np.float32)) for _ in range(3))
    a, b, other = qkv(1, 96), qkv(2, 96), qkv(1, 64)
    cache.set_winner("flash_attention", "cpu", {"block_q": 128,
                     "block_k": 32}, cycles_per_step=1.0,
                     shape=tuning.shape_key("flash_attention", a))
    cache.set_winner("flash_attention", "cpu", {"block_q": 64,
                     "block_k": 128}, cycles_per_step=1.0,
                     shape=tuning.shape_key("flash_attention", b))
    qp = torch.zeros((1, 1, 1, 8))
    pages = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    pool = torch.zeros((3, 4, 1, 8))
    cache.set_winner("paged_attention", "cpu", {"tile_slots": 32},
                     cycles_per_step=1.0, shape=tuning.shape_key(
                         "paged_attention", (qp, pool, pool, pages, pos)))
    tuning.clear_tuned()
    try:
        loaded = tuning.load_cache(cache_dir=cache.root, device="cpu")
        assert len(loaded["flash_attention"]) == 2
        assert ops.flash_tiles(64, args=a) == (128, 32)
        assert ops.flash_tiles(64, args=b) == (64, 128)
        assert ops.flash_tiles(64, args=other) == (64, 64)
        assert tuning.shape_key("flash_attention", other) not in \
            cache.winners("flash_attention", "cpu")
        big = torch.zeros((9, 4, 1, 8))
        assert tuning.tuned_value("paged_attention", "tile_slots", 64,
                                  (qp, big, big, pages, pos)) == 32
        assert tuning.tuned_value("paged_attention", "tile_slots", 64,
                                  (qp, big, big, pages[:, :1], pos)) == 64
    finally:
        tuning.clear_tuned()
