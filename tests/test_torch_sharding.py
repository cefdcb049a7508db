"""Logical-axis sharding (``repro_torch.distributed.sharding``), the step
builders and ``remat="dots"``, held against the JAX package, with no
ranks (the spawned checks are ``tests/test_torch_sharded_ranks.py``
and ``tests/test_torch_sharded_pods.py``).

- The rule sets and ``filter_rules`` equal JAX's; ``schema_pspecs`` of
  the full-width schema of every registry arch equals JAX's under the
  three rule sets on meshes (2, 4) ``data,model``, (16, 16) and
  (2, 16, 16) ``pod,data,model`` (JAX's side on an ``AbstractMesh``,
  which needs no devices); ``placements`` maps a tuple of axes onto
  DTensor shards in mesh order and refuses one against it.
- The legacy serve's profiled decode loop records JAX's paths and calls:
  both run ``build_decode_step`` under its ``decode`` scope (the port's
  loop once probed ``Model.decode_step`` bare, with no ``decode/`` root).
- ``build_prefill_step`` with ``prefill_microbatches=2`` equals one
  chunk exactly (``tests/test_models.py::test_chunked_prefill_matches_
  plain``), and both equal JAX's logits and cache.
- ``remat="dots"``: the loss and every gradient bitwise ``"full"``'s, no
  ``aten.mm`` (nor ``addmm``) recomputed in the backward, and the probed
  train step's paths and calls equal JAX's ``remat="dots"`` step, with
  the differences of ``_CALLS_DIFFER`` listed.
- ``Model.init`` scales its normal draws in place: the same tree, bit
  for bit, as the draw times the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import list_archs
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.distributed import sharding as jshd
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import P
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim import adamw

MESHES = (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
RULE_SETS = ("TRAIN_RULES", "SERVE_RULES", "SERVE_LONG_RULES")


def _spec(p) -> tuple:
    """A spec as a tuple of per-dimension entries, trailing Nones cut."""
    e = [None if x is None else (x if isinstance(x, str) else tuple(x))
         for x in tuple(p)]
    while e and e[-1] is None:
        e.pop()
    return tuple(e)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------------ rules

def test_rule_sets_and_filter_equal_jax():
    for name in RULE_SETS:
        assert getattr(shd, name) == getattr(jshd, name), name
    from jax.sharding import AbstractMesh
    for shape, axes in MESHES + (((4,), ("model",)),):
        am = AbstractMesh(shape, axes)
        for name in RULE_SETS:
            assert shd.filter_rules(getattr(shd, name), dict(zip(axes, shape))) \
                == jshd.filter_rules(getattr(jshd, name), am), (name, axes)
    assert shd.current_rules() is None
    with shd.axis_rules(shd.TRAIN_RULES, {"data": 2}):
        assert shd.current_rules()["batch"] == "data"
        x = torch.ones(4, 3)
        assert shd.shard(x, "batch", None) is x      # no DeviceMesh: no-op
    assert shd.current_rules() is None


@pytest.mark.parametrize("arch", list_archs())
def test_schema_pspecs_equal_jax(arch):
    from jax.sharding import AbstractMesh
    tschema = Model(get_config(arch)).schema()
    jschema = JaxModel(jax_get_config(arch)).schema()
    for shape, axes in MESHES:
        am = AbstractMesh(shape, axes)
        sizes = dict(zip(axes, shape))
        for name in RULE_SETS:
            got = _flat(shd.schema_pspecs(tschema, getattr(shd, name), sizes))
            want = _flat(jax.tree_util.tree_map(
                lambda s: s, jshd.schema_pspecs(jschema, getattr(jshd, name),
                                                am),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
            assert set(got) == set(want), (arch, name)
            for k in want:
                assert isinstance(got[k], P)
                assert _spec(got[k]) == _spec(want[k]), (arch, name, axes, k)


def test_to_pspec_rules_and_placements():
    rules = shd.filter_rules(shd.TRAIN_RULES, {"data": 2, "model": 4})
    sizes = {"data": 2, "model": 4}
    # a mesh axis shards one dimension; an undivided dimension replicates
    assert _spec(shd.to_pspec(("embed", "embed"), rules, (8, 8), sizes)) \
        == ("data",)
    assert _spec(shd.to_pspec(("embed", "q_heads", None), rules, (8, 6, 4),
                              sizes)) == ("data",)
    assert _spec(shd.to_pspec(("batch", "q_heads"), rules, (8, 8), sizes,
                              manual=("data",))) == (None, "model")

    class Mesh:                      # what placements reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 4)

        def size(self, j):
            return self.shape[j]
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh()
    pl = shd.placements(P(("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(P(), mesh) == (Replicate(),) * 3
    mesh.shape = (2, 1, 4)           # a size-1 axis shards nothing
    assert shd.placements(P(("pod", "data")), mesh) == \
        (Shard(0), Replicate(), Replicate())
    with pytest.raises(NotImplementedError, match="order"):
        shd.placements(P(("model", "data")), mesh)


# -------------------------------------------- the legacy serve's paths

# JAX paths the default inline policy keeps and the port's folds
_INLINED = {
    "decode/embed": "the port's embed scope is one aten op (an index), "
                    "which the default inline policy folds into its "
                    "parent; JAX's gather is several equations",
}


def test_legacy_serve_probes_decode_under_jax_decode_root(monkeypatch,
                                                          capsys):
    """Both legacy loops probe ``build_decode_step``: the same paths (the
    ``decode/`` root included) and calls after the same steps."""
    import repro.core as jcore
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    from test_torch_probe import _jax_only
    seen = {}

    class Recording(jcore.ProbeSession):
        def close(self):
            seen["final"] = snap = super().close()
            return snap
    monkeypatch.setattr(jcore, "ProbeSession", Recording)
    kw = dict(batch=2, prompt_len=8, max_new=4, profile=True,
              profile_every=1, profile_max_probes=500, engine=False)
    jax_serve("tinyllama-1.1b", **kw)
    got = serve("tinyllama-1.1b", device="cpu", **kw).snapshot
    want = {r.path: r.calls for r in seen["final"].rows
            if not _jax_only(r.path) and r.path not in _INLINED}
    have = {r.path: r.calls for r in got.rows}
    assert any(p.startswith("decode/") for p in have)
    assert have == want
    capsys.readouterr()


# ---------------------------------------------------- prefill builder

def _serve_pair(arch="tinyllama-1.1b", **over):
    over = dict(dict(compute_dtype="float32", kv_cache_dtype="float32"),
                **over)
    jm = JaxModel(jax_smoke_config(arch).replace(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config(arch).replace(**over))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def test_prefill_microbatches_exact_and_equal_jax():
    from repro.distributed.steps import build_prefill_step as jax_prefill
    from repro_torch.distributed.steps import build_prefill_step
    jm, jp, tm, tp = _serve_pair()
    B, S = 4, 32
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    V = tm.cfg.vocab_size
    jl, jc = jax.jit(jax_prefill(jm, JaxShapeConfig("p", 64, B, "prefill")))(
        jp, {"tokens": jnp.asarray(toks)})
    out = []
    for k in (1, 2):
        m = Model(tm.cfg.replace(prefill_microbatches=k))
        with torch.no_grad():
            out.append(build_prefill_step(m, ShapeConfig("p", 64, B,
                                                         "prefill"))(
                tp, {"tokens": torch.from_numpy(toks)}))
    (l1, c1), (l2, c2) = out
    assert float((l1[:, :V] - l2[:, :V]).abs().max()) < 1e-5
    for key in c1:
        assert torch.equal(c1[key], c2[key]), key
    # tests/test_torch_model.py's f32 tolerances (its docstring says why)
    np.testing.assert_allclose(l1[:, :V].numpy(), np.asarray(jl)[:, :V],
                               atol=2e-3)
    for key in c1:
        np.testing.assert_allclose(c1[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-4)


# ------------------------------------------------------------ init

def test_init_scales_in_place_bitwise():
    import math
    from repro_torch.models.layers import Param, _init_leaf
    p = Param((64, 48), ("embed", "ff"), scale=0.5)
    out = _init_leaf(p, torch.Generator().manual_seed(3), torch.bfloat16,
                     "cpu")
    x = torch.randn(p.shape, generator=torch.Generator().manual_seed(3))
    want = (x * (0.5 / math.sqrt(64))).to(torch.bfloat16)
    assert torch.equal(out, want)
    m = Model(smoke_config("granite-moe-1b-a400m"))
    a, b = m.init(5, device="cpu"), m.init(5, device="cpu")
    from repro_torch.optim import adamw
    assert all(torch.equal(x, y) for x, y in zip(adamw.tree_leaves(a),
                                                  adamw.tree_leaves(b)))


# ------------------------------------------------------ remat="dots"

class _Ops(__import__("torch.utils._python_dispatch",
                      fromlist=["TorchDispatchMode"]).TorchDispatchMode):
    """Counts the aten operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(remat: str, monkeypatch):
    """Loss, every gradient and the backward's op counts of the tinyllama
    smoke loss at ``remat`` (f32, 2 x 32), and the flash kernel's calls
    in the backward (its recompute; the plain version counts here)."""
    from repro_torch.kernels import flash_attention as fa
    calls = [0]
    inner = fa._flash

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)
    monkeypatch.setattr(fa, "_flash", counted)
    cfg = smoke_config("tinyllama-1.1b").replace(compute_dtype="float32",
                                                  remat=remat)
    m = Model(cfg)
    leaves = adamw.tree_map(lambda t: t.requires_grad_(True),
                            m.init(0, device="cpu"))
    g = np.random.default_rng(0)
    b = {k: torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 32))
                             .astype(np.int32)) for k in ("tokens", "labels")}
    loss, _ = m.loss_fn(leaves, b)
    calls[0] = 0
    with _Ops() as ops:
        grads = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    monkeypatch.setattr(fa, "_flash", inner)
    return loss, grads, ops.n, calls[0]


def test_remat_dots_bitwise_full_and_recomputes_no_mm(monkeypatch):
    full, dots, none = (_loss_and_grads(r, monkeypatch)
                        for r in ("full", "dots", "none"))
    assert torch.equal(dots[0], full[0])
    assert all(torch.equal(a, b) for a, b in zip(dots[1], full[1]))
    # the backward's own products are the same in all three; "full" adds
    # the recomputed layer's matmuls, "dots" none of them
    assert dots[2]["aten.mm"] == none[2]["aten.mm"] < full[2]["aten.mm"]
    assert dots[2].get("aten.addmm", 0) == none[2].get("aten.addmm", 0)
    # ... while flash (a kernel, no unbatched dot) is recomputed, a launch
    # a layer
    L = smoke_config("tinyllama-1.1b").num_layers
    assert dots[3] == full[3] == L and none[3] == 0


# port paths of the remat="dots" train step JAX has no node for
_PORT_ONLY_DOTS = {
    "loss~bwd/layers/scan#0/rematted_computation/layer/attn/out_proj":
        "the out projection's product is kept, but its two reshapes are "
        "aten view ops the port recomputes; JAX's recomputed out_proj holds "
        "no equation at f32 (its cast is a no-op), so it has no node",
}


def test_remat_dots_train_step_paths_and_calls_match_jax():
    """JAX's ``remat="dots"`` step: the same paths and calls, apart from
    ``test_torch_train``'s ``_CALLS_DIFFER`` (the same under both remat
    policies) and ``_PORT_ONLY_DOTS``."""
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.core import ProbeConfig as JaxProbeConfig
    from repro.core import probe as jax_probe
    from repro.core.instrument import decode_record as jax_decode_record
    from repro.distributed.steps import build_train_step as jax_train_step
    from repro.optim import adamw as jadamw
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import ProbeConfig, decode_record, probe
    from repro_torch.distributed.steps import build_train_step
    from test_torch_train import _CALLS_DIFFER, _batch, _jax_only, _pair
    jm, jp, tm, tp = _pair(remat="dots")
    tcfg = dict(total_steps=10, warmup_steps=1)
    jb, tb = _batch()
    jpf = jax_probe(jax_train_step(jm, JaxTrainConfig(**tcfg)),
                    JaxProbeConfig(inline="off_all", max_probes=500,
                                   buffer_depth=16))
    _, jrec = jpf(jp, jadamw.init(jp), jb)
    want = [(p, int(c)) for p, c in zip(jpf.probe_paths(),
                                        jax_decode_record(jrec)["calls"])
            if not _jax_only(p)]
    pf = probe(build_train_step(tm, TrainConfig(**tcfg)),
               ProbeConfig(inline="off_all", max_probes=500), device="cpu")
    out, rec = pf(tp, adamw.init(tp), tb)
    got = list(zip(pf.probe_paths(),
                   [int(c) for c in decode_record(rec)["calls"]]))
    got = [(p, c) for p, c in got if p not in _PORT_ONLY_DOTS]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, jc), (_, tc) in zip(want, got):
        assert (jc, tc) == _CALLS_DIFFER.get(p, (jc, jc))[:2], p
    assert "loss~bwd/layers/scan#0/rematted_computation/layer/attn/flash" \
        in dict(got)
    oc = pf.oracle(tp, adamw.init(tp), tb)
    assert decode_record(rec)["cycle"] == oc.cycle
