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
    module takes either. The sharded MoE path, once refused here, runs:
    on a world-1 mesh under ``TRAIN_RULES`` (this process, gloo) it
    equals the local path bitwise, and given a mesh with no rules active
    it says what it needs."""
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
    import tempfile
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    cfg = smoke_config("granite-moe-1b-a400m").replace(
        compute_dtype="float32")
    m = Model(cfg)
    lp = {k: v[0] for k, v in m.init(0, device="cpu")["stack"]["layers"]
          ["moe"].items()}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    want, want_aux = moe.moe_apply(lp, x, cfg)
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/s", 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with pytest.raises(ValueError, match="axis_rules"):
            moe.moe_apply(lp, x, cfg, mesh=mesh)
        with compat.mesh_context(mesh), shd.axis_rules(shd.TRAIN_RULES,
                                                        mesh):
            out, aux = moe.moe_apply(lp, x, cfg, mesh=mesh)
            out, aux = shd.gather((out, aux))
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
