"""The port's frontend archs (musicgen-large: audio embeddings;
qwen2-vl-72b: vision embeddings with M-RoPE and qkv biases) against the
JAX package, on the CPU.

The frontends are stubs in both packages: the model takes precomputed
embeddings (B, S, d_model) and, for M-RoPE, 3-stream positions
(3, B, S). Here they come from numpy with a seed, and the M-RoPE streams
differ from each other (t, h // 2, w % 5), so every rotary section is
exercised. Tolerances, each with its reason (as ``PERF.md`` section 2):

- ``apply_mrope`` at f32: atol 1e-6 (the same f32 products; JAX selects
  each frequency's stream by a one-hot product, which adds exact zeros).
- prefill and decode logits at f32 compute: atol 2e-3 (rare bf16 flips
  of p in attention), KV caches 1e-4; the legacy loop's greedy ids
  equal, over the prefill and three decode steps fed with embeddings.
- ``Model.loss_fn`` loss and grads: f32 compute 1e-4 / 5e-3 of the
  largest value; bf16 compute 1e-2 / 6e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro.models.frontends import frontend_input_specs as jax_specs
from repro.models.layers import apply_mrope as jax_mrope
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.frontends import (frontend_input_specs,
                                          synth_frontend_batch)
from repro_torch.models.layers import apply_mrope
from repro_torch.optim import adamw

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
AUDIO, VISION = "musicgen-large", "qwen2-vl-72b"


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


def _inputs(cfg, B, S, seed):
    """numpy embeddings (and M-RoPE positions) of one batch."""
    rng = np.random.default_rng(seed)
    out = {"embeds": (rng.standard_normal((B, S, cfg.d_model)) * 0.02
                      ).astype(np.float32)}
    if cfg.pos_emb == "mrope":
        t = np.arange(S, dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 2, t % 5])[:, None], (3, B, S)).copy()
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_mrope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (3, 2, 12)).astype(np.int32)
    want = jax_mrope(jnp.asarray(x), jnp.asarray(pos), 10000.0, (2, 3, 3))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                      (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                    (2, 3, 4))


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_input_specs_and_synthetic_batch_match_jax(arch):
    """The frontend's input contract (names, shapes) and the model's
    inputs of each call, as JAX's ``frontend_input_specs`` /
    ``input_specs`` give them; the synthetic batch is drawn on the
    generator's device with the contract's shapes."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    want = {k: tuple(v.shape) for k, v in
            jax_specs(jcfg, 2, 8, jnp.bfloat16).items()}
    got = frontend_input_specs(cfg, 2, 8, torch.bfloat16)
    assert {k: s for k, (s, _) in got.items()} == want
    b = synth_frontend_batch(cfg, 2, 8, torch.bfloat16,
                             torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in b.items()} == want
    assert b["embeds"].dtype == torch.bfloat16
    from repro.configs.base import ShapeConfig
    jm = JaxModel(jcfg)
    for kind in ("train", "prefill", "decode"):
        js = jm.input_specs(ShapeConfig("t", 8, 2, kind))
        ts = Model(cfg).input_shapes(kind, 2, 8)
        assert {k: s for k, (s, _) in ts.items()} == \
            {k: tuple(v.shape) for k, v in js.items()}, kind
    assert "embed" not in Model(cfg).init(0, "cpu")


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_prefill_decode_and_greedy_ids_match_jax(arch):
    """The legacy loop on embeddings: prefill, then three decode steps,
    each fed a new embedding row (the frontend stub's contract: sampled
    ids do not feed back), logits, KV caches and greedy ids."""
    jm, jp, tm, tp = _pair(arch, **F32)
    B, P = 2, 16
    jb, tb = _both(_inputs(tm.cfg, B, P, seed=4))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, 24))(jp, jb)
    cp = tm._compute_cast(tp)
    tl, tc = tm.prefill(cp, tb, 24)
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V],
                               atol=2e-3)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-4)
    assert torch.argmax(tl, -1).tolist() == \
        np.asarray(jnp.argmax(jl, -1)).tolist()
    jdec = jax.jit(jm.decode_step)
    for i in range(3):
        e = _inputs(tm.cfg, B, 1, seed=10 + i)["embeds"]
        jl, jc, jt = jdec(jp, jc, {"embeds": jnp.asarray(e),
                                   "pos": jnp.int32(P + i)})
        tl, tc, tt = tm.decode_step(cp, tc, {"embeds": torch.from_numpy(e),
                                             "pos": P + i})
        np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V],
                                   atol=2e-3)
        assert tt.tolist() == np.asarray(jt).tolist(), i


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_serve_runs_the_legacy_loop_on_synthetic_embeddings(arch):
    """serve() takes a frontend arch through the legacy loop (the engine
    refuses frontend embeddings in both packages), and its ids are those
    of the model's own prefill and decode steps on the same synthetic
    embeddings."""
    res = serve_mod.serve(arch, batch=2, prompt_len=12, max_new=3,
                          device="cpu")
    assert not res.stats and res.tokens.shape == (2, 3)
    cfg = smoke_config(arch)
    m = Model(cfg)
    p = m._compute_cast(m.init(0, "cpu"))
    gen = torch.Generator().manual_seed(1)
    lg, cache = m.prefill(p, synth_frontend_batch(
        cfg, 2, 12, torch.bfloat16, gen), 14)
    want = [torch.argmax(lg, -1)]
    for i in range(2):
        e = synth_frontend_batch(cfg, 2, 1, torch.bfloat16, gen)["embeds"]
        _, cache, nt = m.decode_step(p, cache, {"embeds": e, "pos": 12 + i})
        want.append(nt)
    np.testing.assert_array_equal(
        res.tokens, torch.stack(want, 1).numpy())


@pytest.mark.parametrize("arch", [AUDIO, VISION])
@pytest.mark.parametrize("over,loss_atol,grad_rel", [
    (dict(compute_dtype="float32"), 1e-4, 5e-3),
    (dict(), 1e-2, 6e-2)])
def test_loss_and_grads_match_jax(arch, over, loss_atol, grad_rel):
    jm, jp, tm, tp = _pair(arch, **over)
    batch = _inputs(tm.cfg, 2, 32, seed=1)
    batch["labels"] = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (2, 32)).astype(np.int32)
    jb, tb = _both(batch)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jb)
    leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tl, _ = tm.loss_fn(leaves, tb)
    tg = torch.autograd.grad(tl, adamw.tree_leaves(leaves))
    assert abs(tl.item() - float(jl)) <= loss_atol
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (a, b) in enumerate(zip(jleaves, tg)):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(
            b.float().numpy(), a, rtol=0,
            atol=grad_rel * max(np.abs(a).max(), 1e-30), err_msg=f"leaf {i}")
