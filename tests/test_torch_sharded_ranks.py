"""Auto-sharded (logical-axis) steps on spawned gloo ranks, held against
the port's unsharded steps and the JAX package.

The ranks run ``repro_torch.testing.sharded_ranks`` (a test module does
not import in a spawned child): a world of 4 ranks on a (2, 2) mesh,
spawned once for the file, beside ONE JAX subprocess with four forced
host devices (``tests/test_torch_mesh_ranks.py``'s isolation rule),
both started together and shared by a module-scoped fixture.
``tests/test_torch_sharded_pods.py`` holds the (2, 1, 2) world and
``train(mesh_shape=...)``. Params are the port's
(``Model.init(0)``, made alike on every rank), handed to JAX's side, so
both sides start from the same tree. Tolerances are JAX's own
``tests/test_distributed.py``'s:

- ``TRAIN_RULES`` train step on (2, 2) ``data,model`` (tinyllama smoke,
  f32): loss rel 2e-3 against the port's unsharded step and JAX's
  single-device step, and ``tests/test_torch_train.py``'s train-step row
  (loss atol 1e-4, grad norm rtol 1e-3, params: all but 0.2 % of a leaf
  within lr / 10, every element within 2 lr) against both; the moments
  within its 5e-3 (mu) and 1e-2 (nu) of their largest value against the
  unsharded port's;
- the same with AdamW scanning every 2+-D leaf by its leading axis
  (the full-width rule for leaves over 128 MiB), each rank its block;
- each rank's local blocks of the placed params equal JAX's shard of
  ``NamedSharding(mesh, schema_pspecs(...))`` at the same coordinate;
- ``SERVE_RULES`` prefill + 4 greedy decode steps of granite-3-2b smoke
  (f32, f32 cache): logits within 2e-3 of max against unsharded and
  against JAX, the same ids, the cache sequence-sharded (``kv_seq`` on
  ``model``);
- the MoE loss (granite-moe smoke) with ``moe_apply`` under
  ``compat.shard_map`` on the mesh against the local path and JAX's
  local loss: rel 5e-3 (each data shard routes its own tokens);
- the sharded MoE train step, at a capacity where no token drops, at
  the train-step row and the moments' tolerances against JAX's sharded
  step on the same mesh, and, without the aux loss (a mean of per-shard
  losses under a mesh), against the port's local step; the router,
  replicated over ``model``, the same on every rank after the step;
- ``kernels.ops``' three dispatchers on DTensors (per rank through
  ``local_map``) equal the whole call bitwise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn
from repro_torch.testing import sharded_ranks
from repro_torch.testing.sharded_ranks import load_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4                       # TrainConfig's learning rate
F32 = dict(compute_dtype="float32")
SERVE = dict(compute_dtype="float32", kv_cache_dtype="float32")

JAX_SIDE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs.registry import smoke_config
from repro.distributed import sharding as shd
from repro.distributed.compat import mesh_context
from repro.distributed.steps import (build_decode_step, build_prefill_step,
                                     build_train_step)
from repro.launch.mesh import make_mesh
from repro.models.layers import Param
from repro.models.model import Model
from repro.optim import adamw

out_dir = sys.argv[1]
b = np.load(out_dir + "/batches.npz")
leaves = jax.tree_util.tree_leaves
out = {}
tcfg = TrainConfig(total_steps=10, warmup_steps=1)

def port_params(model, name):
    # the port's Model.init(0), leaves in the tree order both packages use
    tree = jax.tree_util.tree_structure(
        model.schema(), is_leaf=lambda x: isinstance(x, Param))
    with np.load(out_dir + f"/{name}.npz") as f:
        leaves = [jnp.asarray(f[f"arr_{i}"]) for i in range(len(f.files))]
    return jax.tree_util.tree_unflatten(tree, leaves)

cfg = smoke_config("tinyllama-1.1b").replace(compute_dtype="float32")
m = Model(cfg)
params = port_params(m, "tiny")
batch = {"tokens": jnp.asarray(b["train_tokens"]),
         "labels": jnp.asarray(b["train_labels"])}
p1, _, m1 = jax.jit(build_train_step(m, tcfg))(
    params, adamw.init(params, cfg.moment_dtype), batch)
np.savez(out_dir + "/jax_train.npz", *[np.asarray(a) for a in leaves(p1)])
out["train"] = dict(loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]))

mesh = make_mesh((2, 2), ("data", "model"))
specs = shd.schema_pspecs(m.schema(), shd.TRAIN_RULES, mesh)
placed = jax.tree_util.tree_map(
    lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)
for d, dev in enumerate(mesh.devices.flat):
    np.savez(out_dir + f"/jax_shards{d}.npz", *[
        next(np.asarray(s.data) for s in a.addressable_shards
             if s.device == dev) for a in leaves(placed)])

scfg = smoke_config("granite-3-2b").replace(compute_dtype="float32",
                                            kv_cache_dtype="float32")
sm = Model(scfg)
sp = port_params(sm, "serve")
toks = jnp.asarray(b["serve_tokens"])
B, S = toks.shape
logits, cache = jax.jit(build_prefill_step(
    sm, ShapeConfig("serve", 32, B, "prefill")))(sp, {"tokens": toks})
decode = jax.jit(build_decode_step(sm))
V = scfg.vocab_size
lg = [np.asarray(logits)[:, :V]]
nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
ids = [np.asarray(nxt)]
for i in range(4):
    logits, cache, nxt = decode(sp, cache, {"tokens": nxt[:, None],
                                            "pos": jnp.int32(S + i)})
    lg.append(np.asarray(logits)[:, :V])
    ids.append(np.asarray(nxt))
np.savez(out_dir + "/jax_decode.npz", *lg)
out["decode_ids"] = [a.tolist() for a in ids]

mcfg = smoke_config("granite-moe-1b-a400m").replace(compute_dtype="float32")
mm = Model(mcfg)
mp = port_params(mm, "moe")
mb = {"tokens": jnp.asarray(b["moe_tokens"]),
      "labels": jnp.asarray(b["moe_labels"])}
out["moe_loss"] = float(jax.jit(mm.loss_fn)(mp, mb)[0])

# the sharded MoE train step at capacity C = T (no token drops)
nd = Model(mcfg.replace(moe=dataclasses.replace(
    mcfg.moe, capacity_factor=mcfg.moe.num_experts / mcfg.moe.top_k)))
with mesh_context(mesh), shd.axis_rules(
        shd.filter_rules(shd.TRAIN_RULES, mesh), mesh):
    q1, qo, mq = jax.jit(build_train_step(nd, tcfg))(
        mp, adamw.init(mp, mcfg.moment_dtype), mb)
np.savez(out_dir + "/jax_moe_train.npz", *[
    np.asarray(a) for a in leaves(q1) + leaves(qo.mu)])
out["moe_train"] = dict(loss=float(mq["loss"]),
                        grad_norm=float(mq["grad_norm"]))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, started together: JAX's subprocess and the (2, 2)
    world's checks."""
    tmp = str(tmp_path_factory.mktemp("sharded_ranks"))
    bt = sharded_ranks._batch(sharded_ranks.smoke_model().cfg, 8, 32, 1,
                              "cpu")
    st = sharded_ranks._batch(sharded_ranks.smoke_model("granite-3-2b").cfg,
                              8, 16, 7, "cpu")["tokens"]
    mb = sharded_ranks._batch(sharded_ranks.smoke_model(
        "granite-moe-1b-a400m").cfg, 8, 32, 2, "cpu")
    np.savez(os.path.join(tmp, "batches.npz"),
             train_tokens=bt["tokens"].numpy(),
             train_labels=bt["labels"].numpy(),
             serve_tokens=st.numpy(), moe_tokens=mb["tokens"].numpy(),
             moe_labels=mb["labels"].numpy())
    for name, arch, over in (("tiny", "tinyllama-1.1b", F32),
                             ("serve", "granite-3-2b", SERVE),
                             ("moe", "granite-moe-1b-a400m", F32)):
        sharded_ranks.save_params(arch, os.path.join(tmp, f"{name}.npz"),
                                  **over)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, tmp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    checks = {"train": {}, "decode": {}, "moe": {}, "kernels": {},
              # last: it lowers AdamW's scan threshold in the ranks
              "train/scan": dict(scan_bytes=0)}
    # one thread a rank (torch reads OMP_NUM_THREADS as a child starts)
    threads_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        got = {"mesh": spawn(sharded_ranks.checks_rank, (2, 2), args=(
            [((2, 2), ("data", "model"), checks)],), timeout=300)}
    finally:
        if threads_env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads_env
    stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, stderr[-3000:]
    got["jax"] = json.loads(stdout.strip().splitlines()[-1])
    got["jax_train"] = load_leaves(os.path.join(tmp, "jax_train.npz"))
    got["jax_shards"] = [load_leaves(os.path.join(tmp, f"jax_shards{d}.npz"))
                         for d in range(4)]
    got["jax_decode"] = load_leaves(os.path.join(tmp, "jax_decode.npz"))
    got["jax_moe_train"] = load_leaves(os.path.join(tmp, "jax_moe_train.npz"))
    return got


def _train_row(want, got, what):
    """``tests/test_torch_train.py``'s params row: all but 0.2 % of each
    leaf within lr / 10, every element within 2 lr."""
    for i, (a, b) in enumerate(zip(want, got)):
        d = np.abs(a.astype(np.float32) - b.astype(np.float32))
        assert d.max() <= 2 * LR, (what, i, float(d.max()))
        assert (d > LR / 10).mean() <= 2e-3, (what, i)


def _moments_row(want, got, rel, what):
    """``tests/test_torch_train.py``'s moments: within ``rel`` of each
    leaf's largest value."""
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(
            np.abs(a).max(), 1e-30), err_msg=f"{what} {i}")


def test_train_rules_step_matches_unsharded_and_jax(runs):
    r = runs["mesh"][0]["train"]
    (l1, l2), (g1, g2) = r["loss"], r["grad_norm"]
    jl, jg = runs["jax"]["train"]["loss"], runs["jax"]["train"]["grad_norm"]
    for ref, gref in ((l1, g1), (jl, jg)):
        assert abs(l2 - ref) / abs(ref) < 2e-3
        assert abs(l2 - ref) < 1e-4
        assert abs(g2 - gref) / gref < 1e-3
    _train_row(r["params"][0], r["params"][1], "vs unsharded")
    _train_row(runs["jax_train"], r["params"][1], "vs JAX")
    for name, rel in (("mu", 5e-3), ("nu", 1e-2)):
        _moments_row(*r[name], rel, name)
    # every rank computed the same gathered result
    for rank in runs["mesh"][1:]:
        assert rank["train"]["loss"] == l2


def test_row_scans_over_sharded_leaves(runs):
    """AdamW's scan over a leaf's leading axis (every 2+-D leaf here, as
    the full-width leaves over 128 MiB) updates each rank's block: the
    same row as the unscanned step, against unsharded and JAX."""
    r = runs["mesh"][0]["train/scan"]
    assert abs(r["loss"][1] - r["loss"][0]) / abs(r["loss"][0]) < 2e-3
    _train_row(r["params"][0], r["params"][1], "scanned vs unsharded")
    _train_row(runs["jax_train"], r["params"][1], "scanned vs JAX")


def test_kernel_dispatchers_run_per_rank(runs):
    """flash (4 q heads over 1 kv head), the SSD scan (4 heads over 2
    groups) and paged attention on DTensors, batch over data and heads
    over model: each rank's rows and heads are the whole call's, bit for
    bit (the plain versions compute rows and heads apart)."""
    for rank in runs["mesh"]:
        assert rank["kernels"] == {"flash": 0.0, "ssd": 0.0, "paged": 0.0}


def test_local_blocks_equal_jax_shards(runs):
    """Rank r sits at mesh coordinate unravel(r, (2, 2)), as JAX's
    ``mesh.devices`` (row-major) puts device r; its DTensor blocks are
    JAX's shards there, leaf by leaf, bitwise."""
    for rank, r in enumerate(runs["mesh"]):
        assert r["coords"] == [list(np.unravel_index(rank, (2, 2)))]
        want = runs["jax_shards"][rank]
        got = r["train"]["local"]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(want, got)):
            assert a.shape == b.shape, (rank, i)
            assert np.array_equal(a, b), (rank, i)
    # the FSDP x TP placements: wq (layers, d, Hp, hd) on (data, model)
    assert any("Shard(dim=1), Shard(dim=2)" in p
               for p in runs["mesh"][0]["train"]["placements"])


def test_serve_rules_decode_matches_unsharded_and_jax(runs):
    r = runs["mesh"][0]["decode"]
    for a, b, j in zip(r["logits"][0], r["logits"][1], runs["jax_decode"]):
        assert float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9)) < 2e-3
        assert float(np.abs(j - b).max() / (np.abs(j).max() + 1e-9)) < 2e-3
    for a, b, j in zip(r["ids"][0], r["ids"][1], runs["jax"]["decode_ids"]):
        assert (a == b).all() and (b == np.asarray(j)).all()
    assert r["cache_max_diff"] < 1e-4
    # batch over data, the cache's sequence over model
    assert r["placements"]["k"] == "(Shard(dim=1), Shard(dim=2))"


def test_sharded_moe_matches_local_and_jax(runs):
    r = runs["mesh"][0]["moe"]
    l1, l2 = r["loss"]
    for ref in (l1, runs["jax"]["moe_loss"]):
        assert abs(l1 - l2) / abs(ref) < 5e-3
        assert abs(ref - l2) / abs(ref) < 5e-3
    # the train step: x's cotangent is summed over the d_ff shards on
    # model, the router's over the token shards on data
    t = r["train"]
    (aux, local, sharded) = range(3)
    jax_t = runs["jax"]["moe_train"]
    n = len(t["params"][aux])
    jax_params, jax_mu = runs["jax_moe_train"][:n], runs["jax_moe_train"][n:]
    for want, got, gn_want, gn_got, what in (
            (jax_t["loss"], t["loss"][aux], jax_t["grad_norm"],
             t["grad_norm"][aux], "vs JAX's sharded step"),
            (t["loss"][local], t["loss"][sharded], t["grad_norm"][local],
             t["grad_norm"][sharded], "vs the local step")):
        assert abs(got - want) < 1e-4, (what, got, want)
        assert abs(gn_got - gn_want) / gn_want < 1e-3, (what, gn_got, gn_want)
    _train_row(jax_params, t["params"][aux], "vs JAX's sharded step")
    _moments_row(jax_mu, t["mu"][aux], 5e-3, "mu vs JAX's sharded step")
    _train_row(t["params"][local], t["params"][sharded], "vs local")
    for name, rel in (("mu", 5e-3), ("nu", 1e-2)):
        _moments_row(t[name][local], t[name][sharded], rel,
                     f"{name} vs local")
    for rank in runs["mesh"][1:]:
        assert np.array_equal(rank["moe"]["router"][0], r["router"][0])
