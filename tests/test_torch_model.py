"""The port's Model against ``repro.models.Model`` on the same params.

Prefill logits and KV cache, then several teacher-forced decode steps,
on the tinyllama smoke config. At float32 compute both packages make the
same explicit bf16 roundings (flash and decode einsum inputs, p), so
what separates them is f32 summation order, plus the rare bf16 rounding
that order flips (one bf16 ulp of one p term): atol 2e-3 on logits of
|x| <~ 3, 1e-4 on cache rows. The bf16 case rounds every activation,
each side in its own order, so it allows a few bf16 ulps at |x| <~ 4
(atol 5e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.configs.registry import smoke_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")


def _pair(**over):
    jcfg = jax_smoke_config("tinyllama-1.1b").replace(**over)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config("tinyllama-1.1b").replace(**over))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("over,atol,cache_atol", [
    (F32, 2e-3, 1e-4),
    ({}, 5e-2, 5e-2),
])
def test_prefill_and_decode_match_jax(over, atol, cache_atol):
    jm, jp, tm, tp = _pair(**over)
    B, S, cache_len, steps = 2, 21, 32, 4
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 257, (B, S)).astype(np.int32)
    forced = rng.integers(0, 257, (steps, B)).astype(np.int32)

    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, cache_len)
    tl, tcache = tm.prefill(tm._compute_cast(tp),
                            {"tokens": torch.from_numpy(toks)}, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   atol=cache_atol)

    jdec = jax.jit(jm.decode_step)
    cp = tm._compute_cast(tp)
    for i in range(steps):
        pos = S + i
        jl, jcache, jt = jdec(jp, jcache, {
            "tokens": jnp.asarray(forced[i][:, None]), "pos": jnp.int32(pos)})
        tl, tcache, tt = tm.decode_step(cp, tcache, {
            "tokens": torch.from_numpy(forced[i][:, None]), "pos": pos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
        assert tt.tolist() == np.asarray(jt).tolist(), i


def test_unsupported_families_refused():
    """Every registry arch builds; what is refused is a config no JAX
    module takes either, and the sharded MoE path, which names its
    ROADMAP item."""
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.models import moe
    from repro_torch.models.model import unsupported
    for arch in list_archs():
        assert unsupported(get_config(arch)) == ""
        Model(smoke_config(arch))
    for over in (dict(family="rnn"), dict(pos_emb="alibi"),
                 dict(frontend="video")):
        with pytest.raises(NotImplementedError, match="not ported"):
            Model(smoke_config("tinyllama-1.1b").replace(**over))
    cfg = smoke_config("granite-moe-1b-a400m")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.moe_apply({}, torch.zeros(1, 1, cfg.d_model), cfg, mesh=object())
