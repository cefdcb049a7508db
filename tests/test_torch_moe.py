"""The port's MoE family (granite-moe-1b-a400m, arctic-480b) against the
JAX package, on the CPU.

Same parameters (``repro`` ``Model.init`` carried over with
``params_from_numpy``), same inputs (numpy from a seed). Tolerances,
each with its reason (as ``PERF.md`` section 2):

- routing: the expert ids of every token, and which (token, expert)
  assignments the capacity path keeps and which it drops, exactly (the
  router is f32 on both sides, and the test asserts its top-k margins
  are far above f32 rounding); the renormalised routing weights atol
  1e-5 and the Switch aux loss rel 1e-5 (f32 sums in another order; the
  skewed router's logits reach ~30, so the softmax carries a few ulps of
  them).
- ``moe_apply`` (capacity and ragged) and its VJP at f32: 1e-5 of the
  largest value (f32 products in another order); ``grouped_matmul``
  against ``ragged_dot`` and its sparse VJP the same.
- prefill and decode logits at f32 compute: atol 2e-3 (rare bf16 flips
  of p in attention), KV caches 1e-4; greedy ids equal; the engine's ids
  equal JAX's engine's on the same trace (decode kernel and dense).
- ``Model.loss_fn`` loss and grads: f32 compute 1e-4 / 5e-3 of the
  largest value; bf16 compute 1e-2 / 6e-2 (every activation rounded to
  bf16, each side in its own order); the aux loss rel 1e-5 at f32
  compute, 1e-2 at bf16 (there the router reads activations each side
  rounded to bf16 in its own order; measured 4.1e-4). At bf16 compute a
  token whose top-k margin lies within that rounding may pick another
  expert on one side (arctic-480b's smoke config: one token of 64 in the
  second layer, top-2 probability margin 2.3e-4), which moves the
  gradients of the router and of the two experts involved by that
  token's share: there the MoE leaves are held to 2e-1 of their largest
  value (measured 0.145 on the router, 0.065 on ``wo``), every other
  leaf to the 6e-2 of the row. arctic-480b
  keeps bf16 parameters (``param_dtype``), so its gradients come back
  rounded to bf16 even at f32 compute: there the f32 row's grads are
  held to 1e-2 of the largest value, two bf16 ulps (2^-8 each; measured
  one ulp, 2.4e-4 at 0.03, on one element of 131,072).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.engine import EngineConfig as JaxEngineConfig
from repro.engine import InferenceEngine as JaxInferenceEngine
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro_torch.configs.registry import smoke_config
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.models import Model
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
GRANITE, ARCTIC = "granite-moe-1b-a400m", "arctic-480b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **over):
    """(JAX model, JAX params, port model, port params) of ``arch``'s
    smoke config with ``over`` (compute and cache dtypes, which change no
    parameter), the parameters drawn once a module per arch."""
    jp, tp = _params(arch)
    return (JaxModel(jax_smoke_config(arch).replace(**over)), jp,
            Model(smoke_config(arch).replace(**over)), tp)


@functools.lru_cache(maxsize=None)
def _params(arch):
    jp = JaxModel(jax_smoke_config(arch)).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


@pytest.fixture(scope="module")
def granite_f32():
    return _pair(GRANITE, **F32)


def _skewed(cfg, T, seed):
    """Tokens (1, T, d) and a router (d, E) that sends most tokens to
    experts 0 and 1, so the capacity path drops assignments; a router
    column scaled per expert keeps the top-k margins far from ties."""
    rng = np.random.default_rng(seed)
    d, E = cfg.d_model, cfg.moe.num_experts
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    w = rng.standard_normal((d, E)).astype(np.float32) * 0.05
    w[:, :2] += x.mean(axis=(0, 1))[:, None] * 4.0
    return x, w


def _jax_kept(top_i, C, E, k):
    """Which assignments JAX's capacity path keeps: the lines of
    ``_moe_local``'s combine (sorted position within the expert < C),
    scattered back to assignment order."""
    flat = top_i.reshape(-1)
    sort_idx = jnp.argsort(flat)
    gs = jnp.bincount(flat, length=E)
    starts = jnp.cumsum(gs) - gs
    pos = jnp.arange(flat.shape[0]) - starts[flat[sort_idx]]
    kept = jnp.zeros(flat.shape, bool).at[sort_idx].set(pos < C)
    return np.asarray(kept).reshape(top_i.shape)


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_routing_and_drops_match_jax_exactly(arch):
    cfg = smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    E, k, T = cfg.moe.num_experts, cfg.moe.top_k, 64
    x, w = _skewed(cfg, T, seed=11)
    jw, jidx, jaux = jax_moe._route(jnp.asarray(x[0]), jnp.asarray(w), jcfg)
    tw, tidx, taux = moe._route(torch.from_numpy(x[0]), torch.from_numpy(w),
                                cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    assert abs(taux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))
    # the top-k choice is no tie: the k-th and (k+1)-th probabilities of
    # every token lie well apart
    probs = np.sort(np.asarray(jax.nn.softmax(x[0] @ w, -1)), -1)[:, ::-1]
    assert (probs[:, k - 1] - probs[:, k]).min() > 1e-5
    C = moe._capacity(cfg, T)
    assert C == jax_moe._capacity(jcfg, T)
    ids, kept, Ct = moe.routing({"router": torch.from_numpy(w)},
                                torch.from_numpy(x), cfg)
    assert Ct == C
    want = _jax_kept(jidx, C, E, k)
    np.testing.assert_array_equal(kept.numpy(), want)
    assert (~want).sum() > 0, "the skewed router drops nothing"


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_moe_apply_and_its_vjp_match_jax(arch, impl):
    """The MoE FFN (dense residual for arctic) and the gradients of its
    input and every weight, at f32, with drops on the capacity path."""
    jm, jp, tm, tp = _pair(arch)
    jcfg = jm.cfg.replace(moe=jm.cfg.moe.__class__(
        **{**jm.cfg.moe.__dict__, "impl": impl}))
    tcfg = tm.cfg.replace(moe=tm.cfg.moe.__class__(
        **{**tm.cfg.moe.__dict__, "impl": impl}))
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)[0],
                                _np(jp["stack"]["layers"]["moe"]))
    x, w = _skewed(tcfg, 48, seed=3)
    lp["router"] = w
    gy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jf(p, x):
        out, aux = jax_moe.moe_apply(p, x, jcfg)
        return jnp.sum(out * gy) + aux, (out, aux)

    (_, (jo, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
    tp_ = {n: torch.from_numpy(np.array(a)).requires_grad_(True)
           for n, a in lp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    to, taux = moe.moe_apply(tp_, tx, tcfg)
    loss = torch.sum(to * torch.from_numpy(gy)) + taux
    names = sorted(tp_)
    grads = torch.autograd.grad(loss, [tp_[n] for n in names] + [tx])
    for want, got in [(jo, to), (jaux, taux), (jgx, grads[-1])] + [
            (jgp[n], g) for n, g in zip(names, grads)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-6))


def test_grouped_matmul_matches_ragged_dot_and_its_vjp():
    rng = np.random.default_rng(9)
    sizes = np.array([3, 0, 5, 2], np.int32)
    x = rng.standard_normal((10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6, 7)).astype(np.float32)
    gy = rng.standard_normal((10, 7)).astype(np.float32)

    def jf(x, w):
        return jnp.sum(jax_moe.grouped_matmul(x, w, jnp.asarray(sizes)) * gy)

    jy = jax_moe.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(sizes))
    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = moe.grouped_matmul(tx, tw, torch.from_numpy(sizes))
    tgx, tgw = torch.autograd.grad(torch.sum(ty * torch.from_numpy(gy)),
                                   [tx, tw])
    for want, got in ((jy, ty), (jgx, tgx), (jgw, tgw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="sum"):
        moe.grouped_matmul(tx, tw, torch.tensor([1, 1, 1, 1]))


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_prefill_and_decode_match_jax(arch):
    jm, jp, tm, tp = _pair(arch, **F32)
    B, P = 2, 20
    toks = np.random.default_rng(6).integers(0, 257, (B, P)).astype(np.int32)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, 24))(
        jp, {"tokens": jnp.asarray(toks)})
    cp = tm._compute_cast(tp)
    tl, tc = tm.prefill(cp, {"tokens": torch.from_numpy(toks)}, 24)
    np.testing.assert_allclose(tl.numpy()[:, :257], np.asarray(jl)[:, :257],
                               atol=2e-3)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-4)
    jdec = jax.jit(jm.decode_step)
    nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(3):
        jl, jc, jt = jdec(jp, jc, {"tokens": jnp.asarray(nt[:, None]),
                                   "pos": jnp.int32(P + i)})
        tl, tc, tt = tm.decode_step(cp, tc, {
            "tokens": torch.from_numpy(nt[:, None]), "pos": P + i})
        np.testing.assert_allclose(tl.numpy()[:, :257],
                                   np.asarray(jl)[:, :257], atol=2e-3)
        assert tt.tolist() == np.asarray(jt).tolist(), i
        nt = np.asarray(jt)


def _trace(vocab, seed=7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16).tolist()
    return ([prefix + rng.integers(0, vocab, 5).tolist(),
             rng.integers(0, vocab, 7).tolist(),
             prefix + rng.integers(0, vocab, 9).tolist()], [5, 3, 4])


_KW = dict(page_size=16, pool_pages=16, max_pages=2, buckets=(1, 2, 4))


def _serve(eng, prompts, max_new):
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    done = eng.run()
    assert eng.stats()["retraces"] == 0
    eng.drain()
    return [r.out_tokens for r in done]


@pytest.fixture(scope="module")
def jax_engine_ids(granite_f32):
    jm, jp, _, _ = granite_f32
    prompts, max_new = _trace(257)
    eng = JaxInferenceEngine(jm, jp, JaxEngineConfig(**_KW, use_kernel=False))
    return _serve(eng, prompts, max_new)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_serves_moe_with_jax_engine_ids(granite_f32, jax_engine_ids,
                                               use_kernel):
    """The engine takes MoE (as JAX's does): the mixed trace of
    ``test_torch_engine.py`` (whole-prompt prefill, decode buckets 1, 2,
    4, a shared prefix page) gives JAX's engine's ids, through the dense
    decode and the paged kernel's plain version; chunked prefill is
    refused for the token-dropping capacity path, as in JAX."""
    _, _, tm, tp = granite_f32
    prompts, max_new = _trace(257)
    eng = InferenceEngine(tm, tp, EngineConfig(**_KW, use_kernel=use_kernel))
    assert _serve(eng, prompts, max_new) == jax_engine_ids
    assert eng.table.balanced()
    with pytest.raises(ValueError, match="ragged"):
        InferenceEngine(tm, tp, EngineConfig(**_KW, prefill_chunk_pages=1))


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
@pytest.mark.parametrize("over,loss_atol,grad_rel", [
    (dict(compute_dtype="float32"), 1e-4, 5e-3),
    (dict(), 1e-2, 6e-2)])
def test_loss_and_grads_match_jax(arch, over, loss_atol, grad_rel):
    """``stack_apply`` trains MoE layers; ``loss_fn`` adds the layers'
    aux losses, as JAX's."""
    jm, jp, tm, tp = _pair(arch, **over)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 257, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 257, (2, 32)).astype(np.int32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tl, tmet = tm.loss_fn(leaves, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    tg = torch.autograd.grad(tl, adamw.tree_leaves(leaves))
    if tm.cfg.param_dtype == "bfloat16":     # grads rounded to bf16
        grad_rel = max(grad_rel, 1e-2)
    assert abs(tl.item() - float(jl)) <= loss_atol
    ja = float(jmet["aux_loss"])
    aux_rel = 1e-5 if tm.cfg.compute_dtype == "float32" else 1e-2
    assert ja > 0 and abs(tmet["aux_loss"].item() - ja) <= aux_rel * ja
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for path, a, b in zip(paths, jax.tree_util.tree_leaves(jg), tg):
        a = np.asarray(a, np.float32)
        rel = grad_rel
        if "'moe'" in path and tm.cfg.compute_dtype == "bfloat16":
            rel = 2e-1                  # a near-tie token may re-route
        np.testing.assert_allclose(
            b.float().numpy(), a, rtol=0,
            atol=rel * max(np.abs(a).max(), 1e-30), err_msg=path)
