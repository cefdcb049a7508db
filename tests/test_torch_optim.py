"""The port's optimizer, schedules and data pipeline against the JAX
package's (``repro.optim``, ``repro.data``).

Inputs are made with numpy from a seed and handed to both packages.

- Schedules (wsd, cosine): every step of a short run, rel 1e-6: both
  compute in float32 in one order; ``pow``/``cos`` of two libraries may
  differ in the last bit.
- AdamW, three updates on the same gradients, with clipping: float32
  moments rel 1e-5 (the update divides by sqrt(v) + eps, so one-ulp
  differences of pow in the bias corrections grow a little); bfloat16
  moments 1e-2 relative to each leaf's largest value (a moment rounded to
  bf16 one ulp apart after a one-bit f32 difference); int8 moments with a
  scale per row: the dequantized moments within one quantization step
  of the row's scale, params rel 1e-5.
- A (2, 4096, 4097) float32 leaf, just over the 128 MiB threshold, is
  updated one layer at a time: the values equal the whole-leaf update
  exactly (elementwise math, same order), and the probe tree has
  ``optimizer/adamw/scan#0`` with two calls, as JAX's has.
- A tree with a (4097, 8192) float32 leaf (2-D, just over the
  threshold: an embedding's shape) beside small leaves: the 2-D leaf is
  updated one row at a time, and the probe paths and calls equal those
  of ``repro.core.probe`` over JAX's update of the same tree; values as
  the three-update test (rel 1e-5).
- ``TokenPipeline`` batches equal JAX's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.configs.base import TrainConfig
from repro_torch.core import ProbeConfig, decode_record, probe, scope
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim import adamw, schedule


@pytest.mark.parametrize("name", ["wsd", "cosine"])
def test_schedules_match_jax_at_every_step(name):
    kw = dict(warmup_steps=3, total_steps=17, stable_ratio=0.6,
              learning_rate=3e-4)
    jfn = jschedule.make_schedule(name, JaxTrainConfig(**kw))
    tfn = schedule.make_schedule(name, TrainConfig(**kw))
    for step in range(0, 20):
        want = float(jfn(jnp.int32(step)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        np.testing.assert_allclose(float(tfn(step)), want, rtol=1e-6)


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"b": (5,), "w": (6, 7), "stack": (2, 3, 9)}


def _leaves_np(tree):
    """numpy leaves in JAX's order (a QTensor is two leaves)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _leaves_t(tree):
    out = []
    for x in adamw.tree_leaves(tree):
        out += list(x) if isinstance(x, tuple) else [x]
    return [t.float().numpy() for t in out]


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_three_updates_match_jax(moments):
    rng = np.random.default_rng(5)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(3)]
    for g in grads:                      # big enough that clipping bites
        for k in g:
            g[k] *= 3.0
    cfg = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
               grad_clip=1.0)
    jcfg, tcfg = JaxTrainConfig(**cfg), TrainConfig(**cfg)
    jsched = jschedule.make_schedule("cosine", jcfg)
    tsched = schedule.make_schedule("cosine", tcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jadamw.init(jp, moments), adamw.init(tp, moments)
    for g in grads:
        jp, js, jm = jadamw.update(jp, {k: jnp.asarray(v) for k, v in
                                        g.items()}, js, jcfg, jsched)
        old, before = tp, {k: v.clone() for k, v in tp.items()}
        tp, ts, tm = adamw.update(tp, {k: torch.from_numpy(v) for k, v in
                                       g.items()}, ts, tcfg, tsched)
        # functional: the params it was given are left as they were
        assert all(torch.equal(before[k], old[k]) for k in old)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(_leaves_np(jp), _leaves_t(tp)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    for jmom, tmom in ((js.mu, ts.mu), (js.nu, ts.nu)):
        if moments == "int8":
            for k in SHAPES:
                jq, tq = jmom[k], tmom[k]
                want = np.asarray(jq.q, np.float32) * np.asarray(jq.s)
                got = (tq.q.float() * tq.s).numpy()
                step = np.asarray(jq.s)
                assert (np.abs(got - want) <= step * 1.0001).all(), k
                np.testing.assert_allclose(tq.s.numpy(), np.asarray(jq.s),
                                           rtol=1e-5)
        else:
            for a, b in zip(_leaves_np(jmom), _leaves_t(tmom)):
                a = a.astype(np.float32)
                tol = 1e-5 if moments == "float32" else 1e-2
                np.testing.assert_allclose(b, a, rtol=0,
                                           atol=tol * np.abs(a).max())


def test_big_leaf_is_updated_layer_by_layer():
    """(2, 4096, 4097) f32 is just over 128 MiB: two scan iterations."""
    shape = (2, 4096, 4097)
    assert 4 * np.prod(shape) > adamw.SCAN_THRESHOLD_BYTES > 4 * 4096 * 4097
    gen = torch.Generator().manual_seed(3)
    p = {"big": torch.randn(shape, generator=gen)}
    g = {"big": torch.randn(shape, generator=gen)}
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    sched = schedule.make_schedule("cosine", tcfg)
    state = adamw.init(p)

    def step(p, g, state):
        with scope.named_scope("optimizer"):
            return adamw.update(p, g, state, tcfg, sched)

    pf = probe(step, ProbeConfig(inline="off_all", max_probes=50),
               device="cpu")
    (np_, ns, _), rec = pf(p, g, state)
    calls = dict(zip(pf.probe_paths(), decode_record(rec)["calls"]))
    assert calls["optimizer/adamw/scan#0"] == 2
    assert pf.hierarchy.node("optimizer/adamw/scan#0").trip_count == 2
    # the whole-leaf update, computed as one: equal to the last bit
    thr = adamw.SCAN_THRESHOLD_BYTES
    try:
        adamw.SCAN_THRESHOLD_BYTES = 1 << 62
        wp, ws, _ = adamw.update(p, g, state, tcfg, sched)
    finally:
        adamw.SCAN_THRESHOLD_BYTES = thr
    assert torch.equal(np_["big"], wp["big"])
    assert torch.equal(ns.mu["big"], ws.mu["big"])
    assert torch.equal(ns.nu["big"], ws.nu["big"])
    # and against JAX, which scans the same leaf
    jcfg = JaxTrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jb = {"big": jnp.asarray(p["big"].numpy())}
    jn, js, _ = jadamw.update(jb, {"big": jnp.asarray(g["big"].numpy())},
                              jadamw.init(jb), jcfg,
                              jschedule.make_schedule("cosine", jcfg))
    np.testing.assert_allclose(np_["big"].numpy(), np.asarray(jn["big"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ns.nu["big"].numpy(), np.asarray(js.nu["big"]),
                               rtol=1e-5, atol=1e-12)


def test_two_dim_leaf_is_scanned_by_rows_as_in_jax():
    from repro.core import ProbeConfig as JaxProbeConfig
    from repro.core import probe as jax_probe
    from repro.core.instrument import decode_record as jax_decode_record
    shape = (4097, 8192)
    assert 4 * np.prod(shape) > adamw.SCAN_THRESHOLD_BYTES
    rng = np.random.default_rng(4)
    p = {"emb": rng.standard_normal(shape, dtype=np.float32),
         "norm": rng.standard_normal((64,), dtype=np.float32),
         "w": rng.standard_normal((3, 8, 16), dtype=np.float32)}
    g = {k: rng.standard_normal(v.shape, dtype=np.float32)
         for k, v in p.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    tcfg, jcfg = TrainConfig(**kw), JaxTrainConfig(**kw)
    sched = schedule.make_schedule("cosine", tcfg)
    jsched = jschedule.make_schedule("cosine", jcfg)

    def step(p, g, state):
        with scope.named_scope("optimizer"):
            return adamw.update(p, g, state, tcfg, sched)

    def jstep(p, g, state):
        with jax.named_scope("optimizer"):
            return jadamw.update(p, g, state, jcfg, jsched)

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    pf = probe(step, ProbeConfig(inline="off_all", max_probes=50),
               device="cpu")
    (np_, ns, _), rec = pf(tp, tg, adamw.init(tp))
    got = list(zip(pf.probe_paths(), decode_record(rec)["calls"].tolist()))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jpf = jax_probe(jstep, JaxProbeConfig(inline="off_all", max_probes=50))
    (jn, js, _), jrec = jpf(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           jadamw.init(jp))
    want = list(zip(jpf.probe_paths(),
                    [int(c) for c in jax_decode_record(jrec)["calls"]]))
    assert ("optimizer/adamw/scan#0", shape[0]) in got
    assert got == want
    for k in p:
        np.testing.assert_allclose(np_[k].numpy(), np.asarray(jn[k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ns.nu[k].numpy(), np.asarray(js.nu[k]),
                                   rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(num_hosts=2, host_index=1)])
def test_token_pipeline_batches_equal_jax(kw):
    cfg = dict(vocab_size=257, seq_len=33, global_batch=4, seed=7, **kw)
    jp, tp = JaxTokenPipeline(JaxDataConfig(**cfg)), TokenPipeline(
        DataConfig(**cfg))
    for step in (0, 1, 5):
        a, b = jp.batch_at(step), tp.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert np.array_equal(next(jp)["tokens"], next(tp)["tokens"])
