"""The port's hybrid family (zamba2-2.7b) and ssm training (mamba2-370m)
against the JAX package, on the CPU.

Same parameters (``repro`` ``Model.init`` carried over with
``params_from_numpy``), same inputs (numpy from a seed), through both
packages. Tolerances, each with its reason (as ``PERF.md`` section 2):

- prefill and decode logits at f32 compute: atol 2e-3 (f32 summation
  order, rare bf16 flips of p in the flash and decode attention); the
  conv, SSD and shared-attention KV caches 1e-3: the layers after the
  first shared block take its attention output, with those flips in it
  (measured 1.5e-4 on the second group's conv cache; the mamba2 caches,
  with no attention before them, meet 1e-4 in ``test_torch_ssm.py``);
  greedy ids equal, over the prefill and three decode steps and through
  ``serve``.
- ``Model.loss_fn`` loss and grads: f32 compute loss atol 1e-4, each
  grad leaf within 5e-3 of its largest value; bf16 compute 1e-2 and
  6e-2 of the largest value (every activation rounded to bf16, each side
  in its own order).
- ``ssd_chunked`` (the training SSD path) against ``ssd_chunked_xla`` at
  f32, y, final state and the VJP: 5e-6 of the largest value (f32
  summation order).
- the flash plain version at head dim 80 (zamba2's shared attention)
  against the Pallas kernel in interpret mode: atol 3e-2 (bf16 outputs;
  the Pallas kernel keeps p in f32, the port rounds it to bf16).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.distributed.steps import build_decode_step, build_prefill_step
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import Model as JaxModel
from repro.models import ssm as jax_ssm
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.distributed.steps import build_train_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
HYBRID, SSM = "zamba2-2.7b", "mamba2-370m"
B, S = 2, 32


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
def hybrid_f32():
    return _pair(HYBRID, **F32)


def _close_tree(jtree, ttree, atol, what):
    for k in jtree:
        np.testing.assert_allclose(
            ttree[k].float().numpy(), np.asarray(jtree[k], np.float32),
            atol=atol, err_msg=f"{what} {k}")


def test_schema_is_the_jax_schema():
    jm, jp, tm, tp = _pair(HYBRID)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jp))
    got = adamw.tree_map(lambda t: tuple(t.shape), tm.init(0, "cpu"))
    assert got == shapes
    assert "shared" in got["stack"] and tfm.n_groups(tm.cfg) == 2


def test_prefill_and_decode_match_jax(hybrid_f32):
    """The hybrid prefill (groups of SSM layers, the shared block after
    each) and three decode steps, logits and every cache, against JAX."""
    jm, jp, tm, tp = hybrid_f32
    toks = np.random.default_rng(3).integers(0, 257, (B, 20)).astype(
        np.int32)
    cache_len = 24
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len))(
        jp, {"tokens": jnp.asarray(toks)})
    cp = tm._compute_cast(tp)
    tl, tc = tm.prefill(cp, {"tokens": torch.from_numpy(toks)}, cache_len)
    assert sorted(tc) == ["conv", "k", "ssd", "v"]
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    np.testing.assert_allclose(tl.numpy()[:, :257],
                               np.asarray(jl)[:, :257], atol=2e-3)
    _close_tree(jc, tc, 1e-3, "prefill cache")
    jdec = jax.jit(jm.decode_step)
    nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert torch.argmax(tl, -1).tolist() == nt.tolist()
    for i in range(3):
        pos = 20 + i
        jl, jc, jt = jdec(jp, jc, {"tokens": jnp.asarray(nt[:, None]),
                                   "pos": jnp.int32(pos)})
        tl, tc, tt = tm.decode_step(cp, tc, {
            "tokens": torch.from_numpy(nt[:, None]), "pos": pos})
        np.testing.assert_allclose(tl.numpy()[:, :257],
                                   np.asarray(jl)[:, :257], atol=2e-3)
        _close_tree(jc, tc, 1e-3, f"decode {i} cache")
        assert tt.tolist() == np.asarray(jt).tolist(), i
        nt = np.asarray(jt)


def test_serve_matches_jax_greedy_ids(monkeypatch, hybrid_f32):
    """serve(zamba2-2.7b, device="cpu") runs the legacy lock-step loop
    (the engine refuses the hybrid family in both packages) and gives
    JAX's greedy ids at f32."""
    jm, jp, tm, tp = hybrid_f32
    monkeypatch.setattr(serve_mod, "smoke_config",
                        lambda arch: smoke_config(arch).replace(**F32))
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None: tp)
    batch, prompt_len, max_new = 2, 20, 4
    res = serve_mod.serve(HYBRID, batch=batch, prompt_len=prompt_len,
                          max_new=max_new, device="cpu")
    assert not res.stats                          # the legacy loop ran
    prompts = torch.randint(0, tm.cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).numpy()
    pf = jax.jit(build_prefill_step(jm, ShapeConfig(
        "r", prompt_len + max_new, batch, "prefill")))
    dec = jax.jit(build_decode_step(jm))
    lg, cache = pf(jp, {"tokens": jnp.asarray(prompts)})
    nt = jnp.argmax(lg, -1).astype(jnp.int32)
    want = [np.asarray(nt)]
    for i in range(max_new - 1):
        lg, cache, nt = dec(jp, cache, {"tokens": nt[:, None],
                                        "pos": jnp.int32(prompt_len + i)})
        want.append(np.asarray(nt))
    np.testing.assert_array_equal(res.tokens, np.stack(want, axis=1))


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 257, (B, S)).astype(np.int32)
    labels = rng.integers(0, 257, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _loss_and_grads(tm, tp, tb):
    leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, metrics = tm.loss_fn(leaves, tb)
    grads = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    return loss, metrics, grads


@pytest.mark.parametrize("arch", [SSM, HYBRID])
@pytest.mark.parametrize("over,loss_atol,grad_rel", [
    (dict(compute_dtype="float32"), 1e-4, 5e-3),
    (dict(), 1e-2, 6e-2)])
def test_loss_and_grads_match_jax(arch, over, loss_atol, grad_rel):
    """``stack_apply`` trains the ssm family (the plain SSD path, as JAX's
    training) and the hybrid family (nested remat, the shared block's
    gradient summed over its calls)."""
    jm, jp, tm, tp = _pair(arch, **over)
    jb, tb = _batch()
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jb)
    tl, metrics, tg = _loss_and_grads(tm, tp, tb)
    assert float(metrics["aux_loss"]) == 0.0
    assert abs(tl.item() - float(jl)) <= loss_atol
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (a, b) in enumerate(zip(jleaves, tg)):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(
            b.float().numpy(), a, rtol=0,
            atol=grad_rel * max(np.abs(a).max(), 1e-30), err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_train_step_runs_and_moves_every_leaf(arch):
    """One ``build_train_step`` step of each family at f32: finite loss,
    every parameter leaf that has a gradient updated."""
    _, _, tm, tp = _pair(arch, compute_dtype="float32")
    step = build_train_step(tm, TrainConfig(total_steps=10, warmup_steps=1))
    _, tb = _batch()
    new, _, metrics = step(tp, adamw.init(tp, tm.cfg.moment_dtype), tb)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    moved = [not torch.equal(a, b) for a, b in zip(adamw.tree_leaves(tp),
                                                   adamw.tree_leaves(new))]
    assert sum(moved) >= len(moved) - 2      # norms may start at zero grad


def test_ssd_chunked_matches_jax_xla_forward_and_vjp():
    """The training path's SSD scan (with JAX's scopes and a state pass
    whose backward is one node) against ``ssd_chunked_xla``: y, the
    final state, and the gradients of x, a, b, c, at f32."""
    rng = np.random.default_rng(5)
    Bq, L, H, P, G, N, Q = 2, 48, 4, 8, 2, 16, 16
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (Bq, L, H)))
    x = (rng.standard_normal((Bq, L, H, P)) * dt[..., None]).astype(
        np.float32)
    a = (-rng.uniform(1, 16, H) * dt).astype(np.float32)
    b = rng.standard_normal((Bq, L, G, N)).astype(np.float32)
    c = rng.standard_normal((Bq, L, G, N)).astype(np.float32)
    wy = rng.standard_normal((Bq, L, H, P)).astype(np.float32)
    ws = rng.standard_normal((Bq, G, H // G, P, N)).astype(np.float32)

    def jf(x, a, b, c):
        y, st = jax_ssm.ssd_chunked_xla(x, a, b, c, Q, H // G,
                                        return_final_state=True)
        return jnp.sum(y * wy) + jnp.sum(st * ws), (y, st)

    (_, (jy, js)), jgr = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(x, a, b, c)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, a, b, c)]
    ty, tst = tssm.ssd_chunked(*ts, Q, H // G)
    loss = torch.sum(ty * torch.from_numpy(wy)) + \
        torch.sum(tst * torch.from_numpy(ws))
    tgr = torch.autograd.grad(loss, ts)
    for want, got in [(jy, ty), (js, tst)] + list(zip(jgr, tgr)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=5e-6 * np.abs(want).max())


def test_flash_plain_at_head_dim_80_matches_pallas_interpret():
    """zamba2's shared attention: head dim 80, q heads over as many kv
    heads (MHA) and over half as many, bf16, at the port's 64 x 64
    blocks."""
    rng = np.random.default_rng(80)
    for Hkv in (4, 2):
        q = rng.standard_normal((1, 4, 128, 80)).astype(np.float32)
        k = rng.standard_normal((1, Hkv, 128, 80)).astype(np.float32)
        v = rng.standard_normal((1, Hkv, 128, 80)).astype(np.float32)
        o_j = jax_flash(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                        causal=True, block_q=fa.BLOCK_Q, block_k=fa.BLOCK_K,
                        interpret=True)
        o_t = fa.flash_attention(*(torch.from_numpy(t).to(torch.bfloat16)
                                   for t in (q, k, v)))
        np.testing.assert_allclose(o_t.float().numpy(),
                                   np.asarray(o_j, np.float32), atol=3e-2)
    assert 80 in fa.HEAD_DIMS


def test_ssd_chunked_gradient_stays_finite_where_the_exponent_overflows():
    """A chunk of 256 steps at the inits' largest decay (A 16, dt 0.1:
    a = -1.6 a step) puts exponents up to 408 in the masked upper
    triangle of the decay. The port masks them before ``exp``, so its
    gradients are finite: x's equal ``ssd_chunked_xla``'s, and a's, which
    JAX gives as NaN here (0 x inf through the ``where`` after ``exp``;
    ROADMAP Queue 3), equal the gradient through the exact sequential
    recurrence (``kernels.ref.ssd_ref``), within 1e-4 of the largest
    value (f32 sums in another order over 256 steps)."""
    from repro_torch.kernels.ref import ssd_ref
    rng = np.random.default_rng(0)
    Bq, L, H, P, G, N = 1, 256, 2, 4, 1, 4
    x = (rng.standard_normal((Bq, L, H, P)) * 0.1).astype(np.float32)
    a = np.full((Bq, L, H), -1.6, np.float32)
    b = rng.standard_normal((Bq, L, G, N)).astype(np.float32)
    c = rng.standard_normal((Bq, L, G, N)).astype(np.float32)
    jgx, jga = jax.jit(jax.grad(lambda x, a: jnp.sum(jax_ssm.ssd_chunked_xla(
        x, a, b, c, L, H // G) ** 2), argnums=(0, 1)))(x, a)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, a)]
    y, _ = tssm.ssd_chunked(ts[0], ts[1], torch.from_numpy(b),
                            torch.from_numpy(c), L, H // G)
    tgx, tga = torch.autograd.grad((y ** 2).sum(), ts)
    assert torch.isfinite(tgx).all() and torch.isfinite(tga).all()
    assert not np.isfinite(np.asarray(jga)).all()
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tgx.numpy(), jgx, rtol=0,
                               atol=5e-6 * np.abs(jgx).max())
    rs = [torch.from_numpy(t).requires_grad_(True) for t in (x, a)]
    ry, _ = ssd_ref(rs[0].permute(0, 2, 1, 3), rs[1].permute(0, 2, 1),
                    torch.from_numpy(b).permute(0, 2, 1, 3),
                    torch.from_numpy(c).permute(0, 2, 1, 3))
    _, rga = torch.autograd.grad((ry ** 2).sum(), rs)
    np.testing.assert_allclose(tga.numpy(), rga.numpy(), rtol=0,
                               atol=1e-4 * rga.abs().max().item())
