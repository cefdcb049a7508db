"""The port's layers against ``repro.models.layers`` / ``attention``.

Same numpy inputs and parameters through both packages. At float32 the
only differences are summation order and libm (sin/cos/rsqrt) ulps, so
the tolerances are a few f32 ulps of the values compared; the bf16 case
allows one bf16 ulp (2^-8 relative) per rounding step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.configs.registry import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_numpy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rmsnorm_matches(dtype, rtol):
    x = _rng().standard_normal((2, 5, 64)).astype(np.float32)
    scale = 0.1 * _rng(1).standard_normal(64).astype(np.float32)
    want = jl.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype), 1e-5)
    got = tl.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(scale).to(getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol)


def test_rope_matches():
    x = _rng().standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = _rng(1).integers(0, 300, (2, 7))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    # angles up to 300 rad: sin/cos of the two libms differ by ~1e-7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_swiglu_mlp_matches():
    schema = jl.mlp_schema(64, 128, use_bias=True)
    params = _np_tree(jl.materialize(schema, jax.random.PRNGKey(2),
                                     jnp.float32))
    params["bi"] = 0.1 * _rng(3).standard_normal(128).astype(np.float32)
    x = _rng().standard_normal((2, 5, 64)).astype(np.float32)
    want = jl.mlp_apply(jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x))
    got = tl.mlp_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_project_qkv_matches():
    jcfg = jax_smoke_config("tinyllama-1.1b")
    params = _np_tree(jl.materialize(jattn.attention_schema(jcfg),
                                     jax.random.PRNGKey(4), jnp.float32))
    x = _rng().standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    want = jattn._project_qkv(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn._project_qkv(params_from_numpy(params, "cpu"),
                             torch.from_numpy(x),
                             smoke_config("tinyllama-1.1b"),
                             torch.from_numpy(np.ascontiguousarray(pos)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_materialize_schema_shapes_and_init():
    """Port's initializer: JAX's fan-in scaling and zero norm scales, one
    tree per seed."""
    cfg = smoke_config("tinyllama-1.1b")
    schema = {"attn": tattn.attention_schema(cfg),
              "ln": tl.rmsnorm_schema(cfg.d_model)}
    a = tl.materialize(schema, torch.Generator().manual_seed(0),
                       torch.float32, "cpu")
    b = tl.materialize(schema, torch.Generator().manual_seed(0),
                       torch.float32, "cpu")
    assert torch.equal(a["attn"]["wq"], b["attn"]["wq"])
    assert tuple(a["attn"]["wq"].shape) == (cfg.d_model, 4, 16)
    assert not a["ln"].any()
    fan_in = cfg.d_model * 4                   # all dims but the last
    std = a["attn"]["wq"].std().item()
    assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1
