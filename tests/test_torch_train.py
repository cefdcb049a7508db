"""The port's training path against the JAX package's.

Same params (``repro`` ``Model.init`` converted with
``params_from_numpy``), same batches (numpy from a seed), through both
packages. Tolerances, each with its reason:

- flash VJP (``causal_flash`` vs ``causal_flash_xla`` under
  ``jax.vjp``; GQA 4 q heads over 2 kv heads, S = 128, two q blocks at
  chunk 64), f32 inputs (values up to ~5): both round q, k, p, ds to
  bf16 at the same places, but an f32 score one bit apart (another
  summation order) flips a bf16 rounding of p or ds. So out: all but 5 %
  of the elements within 1e-5 (usually all; 2.2 % once, in a whole-suite
  run, not reproduced alone), and every element within one bf16 ulp of
  p times max |v| (2^-8 max |v|); dq/dk/dv atol 2e-3. bf16 inputs: out
  and grads 2e-2, one bf16 ulp at the largest values (dk also sums each
  kv head's q heads in another order).
- ``Model.loss_fn`` loss and grads (tinyllama, granite-3-2b, minicpm-2b:
  tied embeddings, 48 padded heads, vocab 257 padded to 512): float32
  compute loss atol 1e-4, each grad leaf within 5e-3 of its largest
  value (the flash VJP's bf16 flips, above, through two layers); bf16
  compute loss atol 1e-2, grads 6e-2 of the largest value (every
  activation rounded to bf16, each side in its own order; measured
  2.5e-2).
- ``build_train_step`` after 1 and 3 steps (microbatches 1 and 2, f32
  compute): moments each within 5e-3 (mu) and 1e-2 (nu) of their largest
  value, as the grads; params: all but 0.2 % of the elements of a leaf
  within lr / 10 (measured: 0.05 %), and every element within 2 lr a
  step (AdamW's first steps move a param by ~lr m / sqrt(v) = lr sign(g)
  whatever g's size, so a near-zero gradient that the flash VJP's bf16
  flips turn over moves it by up to 2 lr); loss atol 1e-4.
- ``launch.train.train`` losses over 4 steps (bf16 compute): atol 1e-2.
- remat "full" vs "none" in the port, a checkpoint round trip, resume vs
  a straight run, probed vs unprobed: bitwise.

Probe: the tinyllama smoke train step's probe paths and calls equal
``repro.core.probe``'s under ``inline="off_all"`` apart from the JAX
paths of ``_jax_only``; JAX's raw calls are compared, and the paths
whose calls differ are listed with both counts and the reason in
``_CALLS_DIFFER``. Under the default inline policy, the golden's train
paths (``tests/golden/arch_tinyllama_1_1b.json``, ``max_probes=24``) are
the first 24 of JAX's preorder probe list, the port's at
``max_probes=24`` the first 24 of its own, and the two full lists are
equal once JAX-only paths and the scopes the two packages' inline
policies judge differently (JAX counts equations, the port aten
operations) are left out; the device record equals the oracle's; a
3-step ``ProbeSession`` gives 3 x one-shot calls.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import ProbeConfig as JaxProbeConfig
from repro.core import probe as jax_probe
from repro.core.pragma import _select_probes as jax_select_probes
from repro.core.instrument import decode_record as jax_decode_record
from repro.distributed.steps import build_train_step as jax_build_train_step
from repro.launch.train import train as jax_train
from repro.models import Model as JaxModel
from repro.models.attention import causal_flash_xla
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.core import ProbeConfig, ProbeSession, decode_record, probe
from repro_torch.core.inline import SMALL_SCOPE_EQNS
from repro_torch.core.pragma import _select_probes as select_probes
from repro_torch.distributed.steps import build_eval_step, build_train_step
from repro_torch.launch.train import train
from repro_torch.models import Model
from repro_torch.models.attention import causal_flash
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "tinyllama-1.1b"
F32 = dict(compute_dtype="float32")
B, S = 2, 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch=TINY, **over):
    jm = JaxModel(jax_smoke_config(arch).replace(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config(arch).replace(**over))
    return jm, jp, tm, params_from_numpy(_np_tree(jp), "cpu")


def _batch(seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 257, (b, s)).astype(np.int32)
    labels = rng.integers(0, 257, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _assert_leaves_close(jtree, ttree, rel, what=""):
    """Each leaf within ``rel`` of its largest |value| (QTensor: q, s)."""
    ja = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        jtree)]
    ta = []
    for x in adamw.tree_leaves(ttree):
        ta += list(x) if isinstance(x, tuple) else [x]
    assert len(ja) == len(ta), what
    for i, (a, b) in enumerate(zip(ja, ta)):
        b = b.detach().float().numpy()
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=rel * max(np.abs(a).max(), 1e-30),
                                   err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------- flash VJP

@pytest.mark.parametrize("dtype,atol_out,atol_grad", [
    ("float32", 1e-5, 2e-3), ("bfloat16", 2e-2, 2e-2)])
def test_flash_vjp_matches_jax(dtype, atol_out, atol_grad):
    rng = np.random.default_rng(0)
    Bq, Sq, H, Hkv, D = 2, 128, 4, 2, 16
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(q, k, v):
        return causal_flash_xla(q, jnp.repeat(k, H // Hkv, axis=2),
                                jnp.repeat(v, H // Hkv, axis=2), 64, 64)
    jo, vjp = jax.vjp(f, *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do).astype(jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    to = causal_flash(tq, tk, tv, 64, 64)
    tgrads = torch.autograd.grad(to, (tq, tk, tv),
                                 torch.from_numpy(do).to(tdt))
    d = np.abs(to.detach().float().numpy() - np.asarray(jo, np.float32))
    if dtype == "float32":
        assert (d > atol_out).mean() <= 0.05, (d > atol_out).mean()
        atol_out = 2.0 ** -8 * np.abs(v).max()
    assert d.max() <= atol_out, d.max()
    for name, a, b in zip("qkv", jgrads, tgrads):
        assert b.dtype == tdt and b.shape == a.shape
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=atol_grad,
                                   err_msg=f"d{name}")


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("arch", [TINY, "granite-3-2b", "minicpm-2b"])
@pytest.mark.parametrize("over,loss_atol,grad_rel", [
    (F32, 1e-4, 5e-3), ({}, 1e-2, 6e-2)])
def test_loss_and_grads_match_jax(arch, over, loss_atol, grad_rel):
    jm, jp, tm, tp = _pair(arch, **over)
    jb, tb = _batch()
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), tp)
    tl, tmet = tm.loss_fn(leaves, tb)
    tg = torch.autograd.grad(tl, adamw.tree_leaves(leaves))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=loss_atol)
    for name in ("nll", "z_loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[name].detach()),
                                   float(jmet[name]), rtol=1e-3,
                                   atol=loss_atol)
    _assert_leaves_close(jg, adamw.tree_unflatten(tp, list(tg)), grad_rel,
                         arch)


def test_remat_full_is_bitwise_remat_none():
    _, _, tm, tp = _pair()
    tn = Model(tm.cfg.replace(remat="none"))
    _, tb = _batch()
    out = []
    for model in (tm, tn):
        leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss, _ = model.loss_fn(leaves, tb)
        out.append((loss, torch.autograd.grad(loss, adamw.tree_leaves(
            leaves))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_eval_step_is_the_loss():
    _, _, tm, tp = _pair()
    _, tb = _batch()
    loss, metrics = build_eval_step(tm)(tp, tb)
    assert not loss.requires_grad
    assert torch.equal(loss, tm.loss_fn(tp, tb)[0].detach())
    assert torch.equal(metrics["loss"], loss)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax_after_1_and_3_steps(micro):
    jm, jp, tm, tp = _pair(**F32)
    kw = dict(total_steps=10, warmup_steps=1, microbatches=micro)
    jstep = jax.jit(jax_build_train_step(jm, JaxTrainConfig(**kw)))
    tstep = build_train_step(tm, TrainConfig(**kw))
    js, ts = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        jb, tb = _batch(seed=10 + i, b=4)
        jp, js, jmet = jstep(jp, js, jb)
        before = [t.clone() for t in adamw.tree_leaves(tp)]
        old = tp
        tp, ts, tmet = tstep(tp, ts, tb)
        assert all(torch.equal(a, b) for a, b in
                   zip(before, adamw.tree_leaves(old)))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   atol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-3)
        if i in (0, 2):
            lr = TrainConfig(**kw).learning_rate
            for a, b in zip(jax.tree_util.tree_leaves(jp),
                            adamw.tree_leaves(tp)):
                a, b = np.asarray(a), b.numpy()
                d = np.abs(a - b)
                assert (d > lr / 10).mean() < 2e-3
                assert d.max() <= 2 * lr * (i + 1) + 1e-6
            _assert_leaves_close(js.mu, ts.mu, 5e-3, f"mu step {i + 1}")
            _assert_leaves_close(js.nu, ts.nu, 1e-2, f"nu step {i + 1}")
    assert int(ts.step) == 3


def test_train_losses_match_jax_train(monkeypatch):
    """Both trainers start from JAX's init (the two packages' RNGs differ)."""
    jp = JaxModel(jax_smoke_config(TINY)).init(jax.random.PRNGKey(0))
    kw = dict(steps=4, batch=2, seq=32, log_every=100)
    _, _, jhist = jax_train(TINY, **kw)
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None:
                        params_from_numpy(_np_tree(jp), device))
    _, _, thist = train(TINY, **kw, device="cpu")
    assert len(thist) == 4
    np.testing.assert_allclose(thist, jhist, atol=1e-2)


# ----------------------------------------------------------- checkpoints

def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jm, jp, tm, _ = _pair()
    js = jadamw.init(jp)
    js = js._replace(step=jnp.int32(7))
    ck = JaxCheckpointer(str(tmp_path), async_save=False)
    ck.save(7, (jp, js), extra={"step": 7, "data_step": 7})
    target = (tm.init(1, "cpu"), adamw.init(tm.init(1, "cpu")))
    (tp, ts), extra = Checkpointer(str(tmp_path)).restore(7, target)
    assert extra == {"step": 7, "data_step": 7}
    assert isinstance(ts, adamw.AdamWState) and int(ts.step) == 7
    for a, b in zip(jax.tree_util.tree_leaves((jp, js)),
                    adamw.tree_leaves((tp, tuple(ts)))):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_checkpoint_round_trip_keeps_bf16_and_int8(tmp_path):
    tm = Model(smoke_config(TINY).replace(moment_dtype="int8"))
    p = tm.init(0, "cpu")
    st = adamw.init(p, "int8")
    st = st._replace(mu=adamw.tree_map(
        lambda q: q._replace(q=torch.ones_like(q.q)), st.mu))
    tree = (adamw.tree_map(lambda t: t.to(torch.bfloat16), p), st)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, tree, extra={"step": 1})
    ck.save(2, tree, extra={"step": 2})
    ck.wait()
    assert ck.all_steps() == [2]
    out, extra = ck.restore(2, tree)
    assert extra == {"step": 2}
    from repro_torch.checkpoint.checkpointer import flatten
    for a, b in zip(flatten(tree), flatten(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_resume_equals_a_straight_run_bitwise(tmp_path):
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    kw = dict(batch=2, seq=32, log_every=100, device="cpu", tcfg=tcfg)
    d = str(tmp_path / "ck")
    train(TINY, steps=2, checkpoint_dir=d, **kw)
    rp, rs, rhist = train(TINY, steps=4, checkpoint_dir=d, resume=True, **kw)
    sp, ss, shist = train(TINY, steps=4, **kw)
    assert rhist == shist[2:]
    for a, b in zip(adamw.tree_leaves((rp, tuple(rs))),
                    adamw.tree_leaves((sp, tuple(ss)))):
        for x, y in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (a, b))):
            assert torch.equal(x, y)


# ----------------------------------------------------------------- probe

def _j_remat_scan(w, x):
    def loss(w, x):
        with jax.named_scope("loss"):
            def body(c, wi):
                with jax.named_scope("layer"):
                    c = jnp.tanh(c @ wi) + c
                return c, None
            with jax.named_scope("layers"):
                c, _ = jax.lax.scan(jax.checkpoint(body), x, w)
            with jax.named_scope("head"):
                return jnp.sum(c * c)
    val, (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1))(w, x)
    with jax.named_scope("opt"):
        return val, w - 0.1 * gw, gx


def _t_remat_scan(w, x):
    from repro_torch.core import scope
    w, x = w.detach().requires_grad_(), x.detach().requires_grad_()

    def layer(wi, c):
        with scope.named_scope("layer"):
            return torch.tanh(c @ wi) + c
    with scope.named_scope("loss"):
        ws = w.unbind(0)
        with scope.named_scope("layers"):
            c = x
            for i in scope.scan(w.shape[0]):
                c = scope.remat(layer, ws[i], c)
        with scope.named_scope("head"):
            val = torch.sum(c * c)
    gw, gx = scope.grad(val, [w, x])
    val = val.detach()
    with scope.named_scope("opt"), torch.no_grad():
        return val, w - 0.1 * gw, gx


@pytest.mark.parametrize("inline", ["off_all", "default"])
def test_grad_through_a_remat_scan_matches_jax(inline):
    """``scope.grad`` and ``scope.remat`` on a small program: JAX's
    backward tree (``loss~bwd``, a backward ``scan#0`` of its own,
    ``rematted_computation`` first in each iteration), paths and calls
    equal, record == oracle, outputs those of the unprobed function."""
    rng = np.random.default_rng(0)
    w = (0.3 * rng.standard_normal((3, 8, 8))).astype(np.float32)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    jpf = jax_probe(_j_remat_scan, JaxProbeConfig(inline=inline,
                                                  max_probes=500))
    _, jrec = jpf(jnp.asarray(w), jnp.asarray(x))
    want = list(zip(jpf.probe_paths(),
                    [int(c) for c in jax_decode_record(jrec)["calls"]]))
    targs = (torch.from_numpy(w), torch.from_numpy(x))
    pf = probe(_t_remat_scan, ProbeConfig(inline=inline, max_probes=500),
               device="cpu")
    out, rec = pf(*targs)
    assert list(zip(pf.probe_paths(),
                    [int(c) for c in decode_record(rec)["calls"]])) == want
    assert ("loss~bwd/layers/scan#0/rematted_computation/layer", 3) in want
    oc = pf.oracle(*targs)
    dec = decode_record(rec)
    assert dec["cycle"] == oc.cycle and list(dec["totals"]) == oc.totals
    for a, b in zip(out, _t_remat_scan(*targs)):
        assert torch.equal(a, b)


def test_a_gradient_summed_across_iterations_raises_at_capture():
    """A tensor that needs grad and feeds every iteration gets its
    gradient summed between nodes in all but the first iteration's
    backward: the visits differ, and the capture says so (the models
    give each layer its own ``unbind`` slice)."""
    from repro_torch.core import scope

    def fn(w, x):
        w = w.detach().requires_grad_()
        with scope.named_scope("layers"):
            for _ in scope.scan(3):
                x = torch.tanh(x @ w)
        return scope.grad(x.sum(), [w])
    pf = probe(fn, ProbeConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="differ"):
        pf(torch.eye(4), torch.ones(2, 4))


def _jax_only(path: str) -> bool:
    """JAX paths the port has no counterpart for:
    - the scopes JAX generates for einsums (``qkv/bsd,dnh->bsnh``);
    - the XLA flash route's scopes under ``flash`` in the forward and the
      rematerialised forward (``qblk``, ``qblk/scan#0``): the port runs
      that forward as ONE kernel op (its backward ``qblk_bwd`` is kept);
    - top-level ``layer/...``, ``logits`` and ``xent``: JAX's partial
      evaluation hoists the remat'd scans' loop-invariant forward work
      (rope tables, masks, state initialisations) out of the ``loss``
      scope into nodes of their own; eager autograd runs that work where
      the program wrote it, inside the loop."""
    segs = path.split("/")
    if any("->" in s for s in segs):
        return True
    if segs[0] in ("layer", "logits", "xent"):
        return True
    return "flash" in segs[:-1] and "qblk_bwd" not in segs


# (JAX's calls, the port's calls, why) for each compared path whose
# calls differ
_REMAT_SPLIT = ("under remat, the XLA flash route's state initialisations "
                "lose their name stack and split each recomputed visit of "
                "layer, layer/attn and layer/attn/flash in two; the port's "
                "recompute runs each as one visit")
_CALLS_DIFFER = {
    "loss": (3, 1, "JAX's partial evaluation splits the loss scope's one "
                   "visit around the hoisted top-level layer, logits and "
                   "xent nodes (see _jax_only); the port's forward runs as "
                   "one visit"),
    "loss~bwd/layers/scan#0/rematted_computation/layer": (4, 2, _REMAT_SPLIT),
    "loss~bwd/layers/scan#0/rematted_computation/layer/attn":
        (4, 2, _REMAT_SPLIT),
    "loss~bwd/layers/scan#0/rematted_computation/layer/attn/flash":
        (4, 2, _REMAT_SPLIT),
}


@pytest.fixture(scope="module")
def train_case():
    """(jax pf, jax rec, torch step, args factory) of the tinyllama smoke
    train step, as ``tools/regen_golden.py`` probes it (total_steps 10,
    warmup 1), on a numpy batch."""
    jm, jp, tm, tp = _pair()
    tcfg = dict(total_steps=10, warmup_steps=1)
    jstep = jax_build_train_step(jm, JaxTrainConfig(**tcfg))
    jb, tb = _batch()
    jpf = jax_probe(jstep, JaxProbeConfig(inline="off_all", max_probes=500,
                                          buffer_depth=16))
    _, jrec = jpf(jp, jadamw.init(jp), jb)
    tstep = build_train_step(tm, TrainConfig(**tcfg))
    return jpf, jax_decode_record(jrec), tstep, \
        lambda: (tp, adamw.init(tp), tb)


def test_train_step_paths_and_calls_match_jax(train_case):
    jpf, jdec, tstep, args = train_case
    want = [(p, int(c)) for p, c in zip(jpf.probe_paths(), jdec["calls"])
            if not _jax_only(p)]
    pf = probe(tstep, ProbeConfig(inline="off_all", max_probes=500),
               device="cpu")
    _, rec = pf(*args())
    got = list(zip(pf.probe_paths(),
                   [int(c) for c in decode_record(rec)["calls"]]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, jc), (_, tc) in zip(want, got):
        assert (jc, tc) == _CALLS_DIFFER.get(p, (jc, jc))[:2], p
    paths = dict(got)
    assert paths["loss~bwd/layers/scan#0"] == 2
    assert "loss~bwd/layers/scan#0/rematted_computation/layer/attn/flash" \
        in paths
    # the forward's flash node holds ONE op of the kernel
    names = [op for op, _ in pf.hierarchy.ops[
        "loss/layers/scan#0/layer/attn/flash"]]
    assert names.count("flash_attention") == 1 and "exp" not in names


def test_train_step_paths_match_the_golden(train_case):
    jpf, _, tstep, args = train_case
    with open(os.path.join(REPO, "tests", "golden",
                           "arch_tinyllama_1_1b.json")) as f:
        golden = json.load(f)["train"]["paths"]
    pf = probe(tstep, ProbeConfig(max_probes=24), device="cpu")
    pf(*args())
    # every probe-worthy path under the default inline policy, in the
    # preorder both packages truncate at max_probes
    jall = list(jax_select_probes(jpf.hierarchy,
                                  JaxProbeConfig(max_probes=10**6)))
    tall = list(select_probes(pf.hierarchy, ProbeConfig(max_probes=10**6)))
    assert jall[:len(golden)] == golden
    assert list(pf.probe_paths()) == tall[:24]

    def small(node):
        return sum(n.n_eqns for n in node.walk()) < SMALL_SCOPE_EQNS

    def inline_differs(p):
        jn, tn = jpf.hierarchy.node(p), pf.hierarchy.node(p)
        return jn is not None and tn is not None and small(jn) != small(tn)
    print(f"golden: {len(golden)} paths, {sum(map(_jax_only, golden))} "
          f"JAX-only, {sum(map(inline_differs, golden))} judged small by "
          f"the port only; the port's list: "
          f"{sum(map(inline_differs, tall))} judged small by JAX only")
    want = [p for p in jall if not _jax_only(p) and not inline_differs(p)]
    got = [p for p in tall if not inline_differs(p)]
    assert got == want


def test_probed_train_step_is_exact_and_leaves_outputs_alone(train_case):
    _, _, tstep, args = train_case
    pf = probe(tstep, ProbeConfig(inline="off_all", max_probes=500,
                                  buffer_depth=2, offload=0.5), device="cpu")
    out, rec = pf(*args())
    oc = pf.oracle(*args())
    dec = decode_record(rec)
    assert dec["cycle"] == oc.cycle
    for i, p in enumerate(pf.probe_paths()):
        assert int(dec["calls"][i]) == oc.calls[i], p
        assert int(dec["totals"][i]) == oc.totals[i], p
        assert int(dec["starts"][i]) == oc.starts[i], p
        assert int(dec["ends"][i]) == oc.ends[i], p
    plain = tstep(*args())
    for a, b in zip(adamw.tree_leaves((out[0], tuple(out[1]))),
                    adamw.tree_leaves((plain[0], tuple(plain[1])))):
        assert torch.equal(a, b)
    for k in plain[2]:
        assert torch.equal(out[2][k], plain[2][k]), k


def test_session_over_three_steps_is_three_one_shots(train_case):
    _, _, tstep, args = train_case
    cfg = ProbeConfig(inline="off_all", max_probes=500, offload=1.0)
    pf = probe(tstep, cfg, device="cpu")
    _, rec = pf(*args())
    one = decode_record(rec)["calls"]
    p, s, b = args()
    with ProbeSession(tstep, cfg, device="cpu") as sess:
        for _ in range(3):
            p, s, _ = sess.step(p, s, b)
        snap = sess.snapshot()
    calls = {r.path: r.calls for r in snap.rows}
    for path, c in zip(pf.probe_paths(), one):
        assert calls[path] == 3 * int(c), path


def test_trainer_cli_runs_on_the_cpu_probed(capsys):
    _, _, hist = train(TINY, steps=4, batch=2, seq=32, device="cpu",
                       probe_targets=("",), probe_every=2, log_every=2)
    out = capsys.readouterr().out
    assert len(hist) == 4 and all(np.isfinite(hist))
    assert out.count("[probe] ") == 2 and "final streaming probe" in out
