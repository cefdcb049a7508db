"""The port's ssm family against the JAX package, on the CPU.

On the CPU ``kernels.ssd_scan`` takes its plain version, the port of
``ssd_chunked_xla`` op for op, so these tests hold it (what the CUDA
kernel is held against on the card) against the XLA path, the Pallas
kernel in interpret mode and the exact sequential recurrence; then the
block (``ssm_apply`` / ``ssm_decode``), the model's prefill and decode,
and ``serve`` against JAX's, on the same numpy inputs and parameters.

Tolerances, relative to the largest |value| compared:

- f32 everywhere: 5e-6, f32 summation order (measured <= 1.1e-6).
- bf16 plain vs XLA: y within one bf16 ulp (2^-7 relative, 8e-3) —
  the same roundings at the same places, so y flips by at most one ulp
  where f32 sums taken in another order straddle a rounding boundary —
  and the f32 state 1e-5.
- bf16 plain vs the Pallas kernel or the exact recurrence: 2e-2, a few
  bf16 ulps, because the plain version rounds ``cbl``, the chunk states
  and ``prev_states`` to bf16 and those two stay in f32 (measured
  <= 7.9e-3).
- Model logits: as ``test_torch_model.py`` — f32 2e-3 absolute (the
  conv and SSD caches 1e-4), bf16 5e-2 absolute (cache 5e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.distributed.steps import build_decode_step, build_prefill_step
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import Model as JaxModel
from repro.models import ssm as jax_ssm
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.kernels.ref import ssd_ref
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
ARCH = "mamba2-370m"


def _inputs(B, L, H, P, G, N, seed):
    """Realistic SSD inputs: dt log-uniform in [1e-3, 1e-1], A uniform in
    [1, 16] (the mamba2 inits), x = N(0, 1) * dt, a = -A * dt."""
    r = np.random.default_rng(seed)
    dt = np.exp(r.uniform(np.log(1e-3), np.log(1e-1), (B, L, H)))
    A = r.uniform(1.0, 16.0, H)
    x = (r.standard_normal((B, L, H, P)) * dt[..., None]).astype(np.float32)
    a = (-A * dt).astype(np.float32)
    b = r.standard_normal((B, L, G, N)).astype(np.float32)
    c = r.standard_normal((B, L, G, N)).astype(np.float32)
    return x, a, b, c


def _t(v, dtype=torch.float32):
    return torch.from_numpy(np.asarray(v, np.float32)).to(dtype)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_ref(x, a, b, c):
    """repro.kernels.ref.ssd_ref in the model layout: y (B,L,H,P), state
    (B,H,P,N)."""
    y, s = jax_ref.ssd_ref(jnp.asarray(x).transpose(0, 2, 1, 3),
                           jnp.asarray(a).transpose(0, 2, 1),
                           jnp.asarray(b).transpose(0, 2, 1, 3),
                           jnp.asarray(c).transpose(0, 2, 1, 3))
    return np.asarray(y).transpose(0, 2, 1, 3), np.asarray(s)


SHAPES = [  # B, L, H, P, G, N, chunk
    (2, 64, 4, 8, 1, 16, 16),
    (2, 96, 6, 8, 2, 16, 32),
    (1, 256, 4, 16, 2, 32, 64),
]


# ------------------------------------------------------ (a) vs XLA path

@pytest.mark.parametrize("dtype,y_tol,s_tol", [
    ("float32", 5e-6, 5e-6), ("bfloat16", 8e-3, 1e-5)])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_plain_matches_xla(shape, dtype, y_tol, s_tol):
    B, L, H, P, G, N, chunk = shape
    x, a, b, c = _inputs(B, L, H, P, G, N, seed=L + G)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, js = jax_ssm.ssd_chunked_xla(
        jnp.asarray(x, jd), jnp.asarray(a), jnp.asarray(b, jd),
        jnp.asarray(c, jd), chunk=chunk, h_per_g=H // G,
        return_final_state=True)
    ty, ts = kssd.ssd_scan(_t(x, td), _t(a), _t(b, td), _t(c, td),
                           chunk=chunk, h_per_g=H // G,
                           return_final_state=True)
    assert ty.dtype == td and ts.dtype == torch.float32
    assert tuple(ts.shape) == (B, H, P, N)
    assert _rel(ty.float().numpy(), jy) <= y_tol
    assert _rel(ts.numpy(), np.asarray(js).reshape(B, H, P, N)) <= s_tol


# -------------------------------- (b) vs the Pallas kernel and the oracle

@pytest.mark.parametrize("dtype,tol", [("float32", 5e-6), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape,pipeline", [
    (SHAPES[0], 1), (SHAPES[1], 2), (SHAPES[2], 4)])
def test_ssd_plain_matches_pallas_and_ref(shape, pipeline, dtype, tol):
    B, L, H, P, G, N, chunk = shape
    x, a, b, c = _inputs(B, L, H, P, G, N, seed=7 * L + pipeline)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pallas = jax_ops.ssd_scan(jnp.asarray(x, jd), jnp.asarray(a),
                              jnp.asarray(b, jd), jnp.asarray(c, jd),
                              chunk=chunk, pipeline=pipeline, h_per_g=H // G,
                              interpret=True)
    ry, rs = _jax_ref(x, a, b, c)
    ty, ts = kssd.ssd_scan(_t(x, td), _t(a), _t(b, td), _t(c, td),
                           chunk=chunk, pipeline=pipeline, h_per_g=H // G,
                           return_final_state=True)
    assert _rel(ty.float().numpy(), pallas) <= tol
    assert _rel(ty.float().numpy(), ry) <= tol
    assert _rel(ts.numpy(), rs) <= tol


def test_ssd_plain_padded_length_matches_ref():
    """A sequence padded to a multiple of the chunk with a = 0, x = 0 (as
    ``ssm_apply`` pads) leaves the first S outputs and the state of the
    unpadded recurrence."""
    B, S, H, P, G, N, chunk = 2, 40, 4, 8, 2, 16, 16
    x, a, b, c = _inputs(B, S, H, P, G, N, seed=3)
    pad = (-S) % chunk
    padded = [np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
              for v in (x, a, b, c)]
    ty, ts = kssd.ssd_scan(*(_t(v) for v in padded), chunk=chunk,
                           h_per_g=H // G, return_final_state=True)
    ry, rs = _jax_ref(x, a, b, c)
    assert _rel(ty[:, :S].numpy(), ry) <= 5e-6
    assert _rel(ts.numpy(), rs) <= 5e-6


@pytest.mark.parametrize("G", [1, 2])
def test_port_ssd_ref_matches_jax_ref(G):
    x, a, b, c = _inputs(2, 24, 4, 8, G, 16, seed=G)
    ry, rs = _jax_ref(x, a, b, c)
    ty, ts = ssd_ref(_t(x).permute(0, 2, 1, 3), _t(a).permute(0, 2, 1),
                     _t(b).permute(0, 2, 1, 3), _t(c).permute(0, 2, 1, 3))
    assert _rel(ty.permute(0, 2, 1, 3).numpy(), ry) <= 5e-6
    assert _rel(ts.numpy(), rs) <= 5e-6


def test_ssd_scan_rejects_bad_arguments():
    x, a, b, c = (_t(v) for v in _inputs(1, 32, 4, 8, 2, 16, seed=0))
    with pytest.raises(ValueError, match="% chunk"):
        kssd.ssd_scan(x, a, b, c, chunk=24, h_per_g=2)
    with pytest.raises(ValueError, match="% pipeline"):
        kssd.ssd_scan(x, a, b, c, chunk=16, pipeline=3, h_per_g=2)
    with pytest.raises(ValueError, match="h_per_g"):
        kssd.ssd_scan(x, a, b, c, chunk=16, h_per_g=4)
    with pytest.raises(ValueError, match="does not match"):
        kssd.ssd_scan(x, a[:, :16], b, c, chunk=16, h_per_g=2)
    meta = [t.to("meta") for t in (x, a, b, c)]
    with pytest.raises(ValueError, match="% chunk"):    # checked on meta
        kssd.ssd_scan(*meta, chunk=24, h_per_g=2)
    # meta (a dry run) routes to the kernels' outputs, empty, launching
    # nothing (it raised "no SSD-scan kernel" before that route existed)
    y = kssd.ssd_scan(*meta, chunk=16, h_per_g=2)
    assert y.device.type == "meta" and y.shape == x.shape
    assert y.dtype == x.dtype
    assert kssd.ssd_scan.launches == 0       # the plain version never counts


def _emulate_cuda_rounding(x, a, b, c, chunk, h_per_g, parts=3):
    """The CUDA kernels' arithmetic on bf16 inputs, in plain f32 torch,
    with bf16 rounding exactly where the kernels take it: the chunk
    states take v = exp(a_cs[-1] - a_cs) x split into ``parts`` bf16
    parts (each the rounding of what the parts before it left) and sum
    the products of all parts; the carry is f32 and prev is stored in
    bf16; the chunk scan rounds L = (c.b^T) o decay to bf16 and y once at
    the end. Every other product is exact bf16 x bf16 summed in f32 (the
    tensor cores'); f32 summation order, and the factored form of the
    decay below the diagonal (equal up to f32 rounding), are not
    emulated."""
    def r(t):
        return t.to(torch.bfloat16).float()
    B, L, H, P = x.shape
    N, Q = b.shape[3], chunk
    nc = L // Q
    xf = x.float().reshape(B, nc, Q, H, P)
    bh, ch = (t.float().repeat_interleave(h_per_g, dim=2).reshape(
        B, nc, Q, H, N) for t in (b, c))
    acs = torch.cumsum(a.reshape(B, nc, Q, H), dim=2)
    # pass 1: the chunk states
    v = torch.exp(acs[:, :, -1:] - acs)[..., None] * xf
    S = torch.zeros(())
    for _ in range(parts):
        part = r(v)
        S = S + torch.einsum("bcqhp,bcqhn->bchpn", part, bh)
        v = v - part
    # pass 2: the f32 carry in chunk order, prev stored in bf16
    state = torch.zeros((B, H, P, N))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * torch.exp(acs[:, ci, -1])[..., None, None] + S[:, ci]
    prev = r(torch.stack(prev, dim=1))                       # (B,nc,H,P,N)
    # pass 3: y = exp(a_cs[q]) c_q . prev^T + bf16((c . b^T) o decay) x
    at = acs.permute(0, 1, 3, 2)                             # (B,nc,H,Q)
    seg = at[..., :, None] - at[..., None, :]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    decay = torch.where(causal, torch.exp(seg), torch.zeros(()))
    cb = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)
    y = torch.einsum("bchqk,bckhp->bcqhp", r(cb * decay), xf)
    y = y + torch.exp(acs)[..., None] * torch.einsum(
        "bcqhn,bchpn->bcqhp", ch, prev)
    return y.reshape(B, L, H, P).to(torch.bfloat16), state


def test_cuda_rounding_plan_meets_the_f32_contract():
    """The kernels' rounding plan, emulated on the CPU at the serving
    chunk (B=1, L=1024, H=2, N=128, chunk 256), held against the exact
    recurrence and the plain version on f32 copies of the same bf16
    inputs at chip_smoke.py's SSD_F32_RTOL: y 8e-3 (one bf16 ulp of y,
    plus L and prev rounded once), state 2e-5 (the three-part split holds
    the decayed x exactly; two parts, ~16 bits, also meet it here).
    Rounded once to bf16 instead, the state misses its bound: the split
    is needed."""
    B, L, H, P, G, N, chunk = 1, 1024, 2, 64, 1, 128, 256
    x, a, b, c = (torch.from_numpy(v) for v in _inputs(B, L, H, P, G, N,
                                                       seed=11))
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    ry, rs = _jax_ref(x.float().numpy(), a.numpy(), b.float().numpy(),
                      c.float().numpy())
    py, ps = kssd.ssd_scan_plain(x.float(), a, b.float(), c.float(),
                                 chunk=chunk, h_per_g=H // G,
                                 return_final_state=True)
    for parts in (3, 2):
        y, s = _emulate_cuda_rounding(x, a, b, c, chunk, H // G, parts)
        assert torch.isfinite(y.float()).all() and y.dtype == torch.bfloat16
        assert _rel(y.float().numpy(), ry) <= 8e-3
        assert _rel(s.numpy(), rs) <= 2e-5
        assert _rel(y.float().numpy(), py.numpy()) <= 8e-3
        assert _rel(s.numpy(), ps.numpy()) <= 2e-5
    _, s_one = _emulate_cuda_rounding(x, a, b, c, chunk, H // G, parts=1)
    assert _rel(s_one.numpy(), rs) > 2e-5


# ------------------------------------------------ (c) block vs JAX block

def _block_pair(dtype):
    jcfg = jax_smoke_config(ARCH).replace(compute_dtype=dtype)
    jm = JaxModel(jcfg)
    jp = jm._compute_cast(jm.init(jax.random.PRNGKey(0)))
    lp = jax.tree_util.tree_map(lambda t: t[0], jp["stack"]["layers"]["ssm"])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, lp), "cpu")
    return jcfg, smoke_config(ARCH).replace(compute_dtype=dtype), lp, tp


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_ssm_apply_and_decode_match_jax(dtype, atol):
    """S = 37 is not a multiple of the chunk (16): the padded path."""
    jcfg, tcfg, lp, tp = _block_pair(dtype)
    B, S = 2, 37
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S + 1, jcfg.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jo, jconv, jssd = jax.jit(lambda p, v: jax_ssm.ssm_apply(
        p, v, jcfg, return_state=True))(lp, jnp.asarray(x[:, :S], jd))
    to, tconv, tssd = tssm.ssm_apply(tp, _t(x[:, :S], td), tcfg,
                                     return_state=True)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               atol=atol)
    np.testing.assert_allclose(tconv.float().numpy(),
                               np.asarray(jconv, np.float32), atol=atol)
    np.testing.assert_allclose(tssd.numpy(), np.asarray(jssd), atol=atol)

    jo, jconv, jssd = jax.jit(lambda p, v, cs, ss: jax_ssm.ssm_decode(
        p, v, cs, ss, jcfg))(lp, jnp.asarray(x[:, S:], jd), jconv, jssd)
    to, tconv, tssd = tssm.ssm_decode(tp, _t(x[:, S:], td), tconv, tssd, tcfg)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               atol=atol)
    np.testing.assert_allclose(tconv.float().numpy(),
                               np.asarray(jconv, np.float32), atol=atol)
    np.testing.assert_allclose(tssd.numpy(), np.asarray(jssd), atol=atol)


# ------------------------------------------------ (d) model vs JAX model

def _model_pair(**over):
    jm = JaxModel(jax_smoke_config(ARCH).replace(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config(ARCH).replace(**over))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("over,atol,cache_atol", [
    (F32, 2e-3, 1e-4),
    ({}, 5e-2, 5e-2),
])
def test_model_prefill_and_decode_match_jax(over, atol, cache_atol):
    jm, jp, tm, tp = _model_pair(**over)
    V = tm.cfg.vocab_size
    B, S, steps = 2, 37, 4
    rng = np.random.default_rng(13)
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    forced = rng.integers(0, V, (steps, B)).astype(np.int32)
    cp = tm._compute_cast(tp)

    def close(tl, jl, tcache, jcache):
        np.testing.assert_allclose(tl[:, :V].numpy(), np.asarray(jl)[:, :V],
                                   atol=atol)
        for name in ("conv", "ssd"):
            assert tcache[name].dtype == getattr(torch, str(jcache[name].dtype))
            np.testing.assert_allclose(tcache[name].float().numpy(),
                                       np.asarray(jcache[name], np.float32),
                                       atol=cache_atol)

    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, S + steps)
    tl, tcache = tm.prefill(cp, {"tokens": torch.from_numpy(toks)}, S + steps)
    close(tl, jl, tcache, jcache)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    assert torch.isinf(tl[:, V:]).all()          # pad columns masked

    jdec = jax.jit(jm.decode_step)
    for i in range(steps):
        jl, jcache, jt = jdec(jp, jcache, {
            "tokens": jnp.asarray(forced[i][:, None]), "pos": jnp.int32(S + i)})
        tl, tcache, tt = tm.decode_step(cp, tcache, {
            "tokens": torch.from_numpy(forced[i][:, None]), "pos": S + i})
        close(tl, jl, tcache, jcache)
        assert tt.tolist() == np.asarray(jt).tolist(), i


# ------------------------------------- (e) prefill / decode consistency

@pytest.mark.parametrize("n_groups", [1, 2])
def test_prefill_decode_consistency(n_groups):
    """tests/test_models.py::test_prefill_decode_consistency inside the
    port: prefill(S) + decode(1) == prefill(S + 1), f32. With two groups
    it also shows that decode reads head h's own group, as the scan does."""
    import dataclasses
    cfg = smoke_config(ARCH).replace(**F32)
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, n_groups=n_groups))
    m = Model(cfg)
    params = m.init(0, "cpu")
    B, S = 2, 32
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(0))
    _, cache = m.prefill(params, {"tokens": toks[:, :S]}, 64)
    dl, _, _ = m.decode_step(params, cache, {"tokens": toks[:, S:],
                                             "pos": S})
    pl, _ = m.prefill(params, {"tokens": toks}, 64)
    V = cfg.vocab_size
    err = float((dl[:, :V] - pl[:, :V]).abs().max()
                / (pl[:, :V].abs().max() + 1e-9))
    assert err < 5e-3, err


def test_short_prompt_conv_state_is_zero_history():
    """A prompt shorter than the conv window: the conv cache is the
    conv's zero history followed by the prompt's inputs, so decoding the
    rest gives the longer prompt's logits."""
    cfg = smoke_config(ARCH).replace(**F32)
    m = Model(cfg)
    params = m.init(0, "cpu")
    toks = torch.tensor([[5, 9, 200]])
    _, cache = m.prefill(params, {"tokens": toks[:, :1]}, 8)
    assert tuple(cache["conv"].shape[2:3]) == (cfg.ssm.conv_kernel - 1,)
    for i in (1, 2):
        dl, cache, _ = m.decode_step(params, cache, {"tokens": toks[:, i:i + 1],
                                                     "pos": i})
    pl, _ = m.prefill(params, {"tokens": toks}, 8)
    V = cfg.vocab_size
    torch.testing.assert_close(dl[:, :V], pl[:, :V], atol=2e-5, rtol=0)


def test_ssm_initializers():
    """A_log = log U[1, 16]; softplus(dt_bias) = dt in [1e-3, 1e-1]."""
    p = Model(smoke_config(ARCH)).init(0, "cpu")["stack"]["layers"]["ssm"]
    a = torch.exp(p["a_log"])
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert ((a >= 1 - 1e-5) & (a <= 16 + 1e-4)).all()
    assert ((dt >= 1e-3 * (1 - 1e-4)) & (dt <= 0.1 * (1 + 1e-4))).all()
    assert a.std() > 1 and dt.std() > 1e-3       # drawn, not constant


# --------------------------------------------- (f) serve vs JAX greedy ids

def test_serve_matches_jax_greedy_ids(monkeypatch):
    """serve(mamba2-370m, device="cpu") at f32 compute, on parameters
    carried over from JAX, gives JAX's greedy ids (the legacy lock-step
    loop: the engine refuses the ssm family in both packages)."""
    jm, jp, tm, tp = _model_pair(**F32)
    monkeypatch.setattr(serve_mod, "smoke_config",
                        lambda arch: smoke_config(arch).replace(**F32))
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None: tp)
    batch, prompt_len, max_new = 2, 20, 5
    res = serve_mod.serve(ARCH, batch=batch, prompt_len=prompt_len,
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
