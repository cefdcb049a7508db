"""The sharded ssm and hybrid families, ``SERVE_LONG_RULES``, int8 moments
on sharded leaves and the M-RoPE microbatch split, held against the
port's unsharded steps and the JAX package.

The ranks run ``repro_torch.testing.sharded_ranks`` (a test module does
not import in a spawned child): one world of 4 gloo ranks on a (2, 2)
``data,model`` mesh, spawned once for the file, beside ONE JAX subprocess
with four forced host devices, both started together and shared by a
module-scoped fixture (``tests/test_torch_sharded_ranks.py``'s pattern).
Params are the port's (``Model.init(0)``, f32 compute), handed to JAX's
side. Tolerances are ``tests/test_torch_sharded_ranks.py``'s (JAX's own
``tests/test_distributed.py``'s):

- the mamba2-370m and zamba2-2.7b smoke ``TRAIN_RULES`` train steps (the
  chunked SSD scan per rank over its batch and head shards): loss atol
  1e-4, grad norm rtol 1e-3 and the params row (all but 0.2 % of a leaf
  within lr / 10, every element within 2 lr) against the port's
  unsharded step and JAX's sharded step, the moments within 5e-3 (mu) and
  1e-2 (nu) of their largest value;
- the zamba2 and mamba2 smoke ``SERVE_LONG_RULES`` prefill and 4 greedy
  decodes at batch 1 (the long-context shape): logits within 2e-3 of max
  and the same ids against unsharded and JAX; each rank's block of every
  cache leaf equals JAX's shard of that leaf at the rank's coordinate
  (the attention cache's sequence over ``("model", "data")``,
  model-major: a data-major placement swaps ranks (0, 1) and (1, 0));
- a tinyllama smoke step with ``moment_dtype="int8"`` (the embedding's
  and unembedding's last dims sharded) against the unsharded step:
  params at the train-step row, each moment within one quantization step
  of the unsharded one, each scale the whole row's max (a per-block max
  is shown to differ);
- the qwen2-vl smoke train step with microbatches 2 on one CPU device
  against JAX's ``build_train_step``: its (3, B, S) M-RoPE positions are
  split on the batch dim.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.distributed.steps import build_train_step
from repro_torch.launch.dryrun import cell_inputs
from repro_torch.launch.mesh import spawn
from repro_torch.optim import adamw
from repro_torch.testing import sharded_ranks
from repro_torch.testing.sharded_ranks import load_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4                       # TrainConfig's learning rate
F32 = dict(compute_dtype="float32")
TRAIN_ARCHS = ("mamba2-370m", "zamba2-2.7b")
LONG = dict(B=1, prompt=16, steps=4, cache_len=32)

JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
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
    tree = jax.tree_util.tree_structure(
        model.schema(), is_leaf=lambda x: isinstance(x, Param))
    with np.load(out_dir + f"/{name}.npz") as f:
        ls = [jnp.asarray(f[f"arr_{i}"]) for i in range(len(f.files))]
    return jax.tree_util.tree_unflatten(tree, ls)

def save(name, arrays):
    np.savez(out_dir + f"/{name}.npz", *[np.asarray(a) for a in arrays])

mesh = make_mesh((2, 2), ("data", "model"))
for arch in ("mamba2-370m", "zamba2-2.7b"):
    m = Model(smoke_config(arch).replace(compute_dtype="float32"))
    p = port_params(m, arch)
    batch = {"tokens": jnp.asarray(b[arch + "_tokens"]),
             "labels": jnp.asarray(b[arch + "_labels"])}
    with mesh_context(mesh), shd.axis_rules(
            shd.filter_rules(shd.TRAIN_RULES, mesh), mesh):
        p1, o1, m1 = jax.jit(build_train_step(m, tcfg))(
            p, adamw.init(p, m.cfg.moment_dtype), batch)
    save("jax_train_" + arch, leaves(p1) + leaves(o1.mu) + leaves(o1.nu))
    out["train_" + arch] = dict(loss=float(m1["loss"]),
                                grad_norm=float(m1["grad_norm"]))

    sm = Model(smoke_config(arch).replace(compute_dtype="float32",
                                          kv_cache_dtype="float32"))
    toks = jnp.asarray(b[arch + "_prompt"])
    B, S = toks.shape
    rules = shd.filter_rules(shd.SERVE_LONG_RULES, mesh)
    with mesh_context(mesh), shd.axis_rules(rules, mesh):
        logits, cache = jax.jit(build_prefill_step(
            sm, ShapeConfig("serve", 32, B, "prefill")))(p, {"tokens": toks})
        decode = jax.jit(build_decode_step(sm))
        V = sm.cfg.vocab_size
        lg = [np.asarray(logits)[:, :V]]
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        ids = [np.asarray(nxt).tolist()]
        for i in range(4):
            logits, cache, nxt = decode(p, cache, {"tokens": nxt[:, None],
                                                   "pos": jnp.int32(S + i)})
            lg.append(np.asarray(logits)[:, :V])
            ids.append(np.asarray(nxt).tolist())
    save("jax_long_" + arch, lg)
    out["long_" + arch] = ids
    # the attention cache's shards by the rule set (kv_seq over
    # ("model", "data")), each device's, and every leaf whole
    _, axes = sm.cache_specs(ShapeConfig("serve", 32, B, "decode"))
    saved = {k: np.asarray(v, np.float32) for k, v in cache.items()}
    for k in ("k", "v"):
        if k not in cache:
            continue
        spec = shd.to_pspec(axes[k], rules, shape=cache[k].shape, mesh=mesh)
        placed = jax.device_put(cache[k], NamedSharding(mesh, spec))
        for d, dev in enumerate(mesh.devices.flat):
            saved[f"{k}@{d}"] = next(
                np.asarray(s.data, np.float32)
                for s in placed.addressable_shards if s.device == dev)
    np.savez(out_dir + f"/jax_cache_{arch}.npz", **saved)

qm = Model(smoke_config("qwen2-vl-72b").replace(compute_dtype="float32"))
qp = port_params(qm, "qwen2-vl-72b")
qb = {k: jnp.asarray(b["qwen_" + k]) for k in ("embeds", "positions",
                                                "labels")}
q1, qo, mq = jax.jit(build_train_step(qm, TrainConfig(
    total_steps=10, warmup_steps=1, microbatches=2)))(
        qp, adamw.init(qp, qm.cfg.moment_dtype), qb)
save("jax_qwen", leaves(q1) + leaves(qo.mu))      # mu: q, s a leaf
out["qwen"] = dict(loss=float(mq["loss"]), grad_norm=float(mq["grad_norm"]))
print(json.dumps(out))
"""


def _qwen_case():
    """The qwen2-vl smoke model and its train batch (embeds, (3, B, S)
    positions, labels), B 4 x S 32."""
    model = sharded_ranks.smoke_model("qwen2-vl-72b")
    batch = cell_inputs(model, ShapeConfig("train", 32, 4, "train"), "cpu",
                        seed=3)
    return model, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, started together: JAX's subprocess and the (2, 2)
    world's checks."""
    tmp = str(tmp_path_factory.mktemp("sharded_families"))
    arrays = {}
    for arch in TRAIN_ARCHS:
        cfg = sharded_ranks.smoke_model(arch).cfg
        bt = sharded_ranks._batch(cfg, 8, 32, 1, "cpu")
        arrays[arch + "_tokens"] = bt["tokens"].numpy()
        arrays[arch + "_labels"] = bt["labels"].numpy()
        arrays[arch + "_prompt"] = sharded_ranks._batch(
            cfg, LONG["B"], LONG["prompt"], 7, "cpu")["tokens"].numpy()
        sharded_ranks.save_params(arch, os.path.join(tmp, f"{arch}.npz"))
    qm, qb = _qwen_case()
    for k, v in qb.items():
        arrays["qwen_" + k] = v.numpy()
    sharded_ranks.save_params("qwen2-vl-72b",
                              os.path.join(tmp, "qwen2-vl-72b.npz"))
    np.savez(os.path.join(tmp, "batches.npz"), **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, tmp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    checks = {f"train/{a}": dict(arch=a) for a in TRAIN_ARCHS}
    checks.update({f"decode/{a}": dict(arch=a, rules="serve_long", **LONG)
                   for a in TRAIN_ARCHS})
    checks["train/int8"] = dict(over=dict(moment_dtype="int8"))
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
    # the port's qwen2-vl step, on this process while JAX's runs
    step = build_train_step(qm, TrainConfig(total_steps=10, warmup_steps=1,
                                            microbatches=2))
    params = qm.init(0, device="cpu")
    q1, qo, mq = step(params, adamw.init(params, qm.cfg.moment_dtype), qb)
    got["qwen"] = dict(loss=float(mq["loss"]),
                       grad_norm=float(mq["grad_norm"]),
                       params=sharded_ranks._np(q1),
                       mu=sharded_ranks._np(qo.mu))
    stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, stderr[-3000:]
    got["jax"] = json.loads(stdout.strip().splitlines()[-1])
    for name in [f"train_{a}" for a in TRAIN_ARCHS] + \
            [f"long_{a}" for a in TRAIN_ARCHS] + ["qwen"]:
        got["jax_" + name] = load_leaves(os.path.join(tmp,
                                                      f"jax_{name}.npz"))
    for a in TRAIN_ARCHS:
        with np.load(os.path.join(tmp, f"jax_cache_{a}.npz")) as f:
            got["jax_cache_" + a] = {k: f[k] for k in f.files}
    return got


def _train_row(want, got, what):
    """All but 0.2 % of each leaf within lr / 10, every element within
    2 lr."""
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        d = np.abs(a.astype(np.float32) - b.astype(np.float32))
        assert d.max() <= 2 * LR, (what, i, float(d.max()))
        assert (d > LR / 10).mean() <= 2e-3, (what, i)


def _moments_row(want, got, rel, what):
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(
            np.abs(a).max(), 1e-30), err_msg=f"{what} {i}")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_rules_step_matches_unsharded_and_jax(runs, arch):
    r = runs["mesh"][0][f"train/{arch}"]
    (l1, l2), (g1, g2) = r["loss"], r["grad_norm"]
    jax_r = runs["jax"][f"train_{arch}"]
    for ref, gref in ((l1, g1), (jax_r["loss"], jax_r["grad_norm"])):
        assert abs(l2 - ref) < 1e-4, (l2, ref)
        assert abs(g2 - gref) / gref < 1e-3, (g2, gref)
    n = len(r["params"][0])
    jp = runs[f"jax_train_{arch}"]
    _train_row(r["params"][0], r["params"][1], "vs unsharded")
    _train_row(jp[:n], r["params"][1], "vs JAX")
    for name, rel, want in (("mu", 5e-3, jp[n:2 * n]),
                            ("nu", 1e-2, jp[2 * n:])):
        _moments_row(r[name][0], r[name][1], rel, name + " vs unsharded")
        _moments_row(want, r[name][1], rel, name + " vs JAX")
    # the SSD's heads stayed sharded: the in_proj is split on model
    assert any("Shard(dim=1)" in p for p in r["placements"])
    for rank in runs["mesh"][1:]:
        assert rank[f"train/{arch}"]["loss"] == l2


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_serve_long_decode_matches_unsharded_and_jax(runs, arch):
    r = runs["mesh"][0][f"decode/{arch}"]
    for a, b, j in zip(r["logits"][0], r["logits"][1],
                       runs[f"jax_long_{arch}"]):
        assert float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9)) < 2e-3
        assert float(np.abs(j - b).max() / (np.abs(j).max() + 1e-9)) < 2e-3
    for a, b, j in zip(r["ids"][0], r["ids"][1], runs["jax"][f"long_{arch}"]):
        assert (a == b).all() and (b == np.asarray(j)).all()
    if arch == "mamba2-370m":
        assert r["cache_max_diff"] < 1e-4
    else:
        # the shared attention's decode rounds q, the cache and the
        # probabilities to bf16 (JAX's MXU inputs): a sharded reduction's
        # f32 reordering (~1e-7) flips some of those roundings, so each
        # leaf is within the logits' 2e-3 of its max, not 1e-4 (with the
        # roundings taken out the sharded cache reads 1.4e-6 off)
        assert max(r["cache_rel"].values()) < 2e-3, r["cache_rel"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_serve_long_cache_blocks_are_jax_shards(runs, arch):
    """Rank r's block of each cache leaf is JAX's cache at the block's
    place, within the logits' tolerance; the hybrid's attention cache is
    split on its sequence over both axes model-major, and its block on
    rank r is JAX's shard on the device at r's (data, model) coordinate
    (device 2 d + m of JAX's row-major mesh)."""
    want = runs[f"jax_cache_{arch}"]
    for r in runs["mesh"]:
        got = r[f"decode/{arch}"]
        c = got["axis_coords"]
        d = 2 * c["data"] + c["model"]
        for k, (blk, off) in got["local_cache"].items():
            whole = want[k]
            at = whole[tuple(slice(o, o + n) for o, n in zip(off, blk.shape))]
            scale = max(float(np.abs(whole).max()), 1e-6)
            assert at.shape == blk.shape, (arch, k, d)
            assert float(np.abs(at - blk).max()) <= 2e-3 * scale, (arch, k)
            if k in ("k", "v"):
                S = whole.shape[2]
                assert off[2] == (2 * c["model"] + c["data"]) * S // 4, (
                    k, c, off)
                assert got["placements"][k].count("Shard(dim=2)") == 2
                jax_blk = want[f"{k}@{d}"]
                assert jax_blk.shape == blk.shape, (k, d)
                assert float(np.abs(jax_blk - blk).max()) <= 2e-3 * scale
    assert ("k" in want) == (arch == "zamba2-2.7b")


def test_int8_moments_on_sharded_leaves(runs):
    """The sharded int8 step against the unsharded one: params at the
    train-step row; each moment's int8 values within one quantization
    step and its scales within the moments' 5e-3; each scale the whole
    row's max |m| / 127, where a max over one rank's block of a row whose
    last dim is sharded differs from it (the all-reduce is what keeps
    them equal)."""
    r = runs["mesh"][0]["train/int8"]
    _train_row(r["params"][0], r["params"][1], "int8 vs unsharded")
    assert abs(r["loss"][1] - r["loss"][0]) < 1e-4
    sharded_last = [i for i, p in enumerate(r["placements"])
                    if f"Shard(dim={r['params'][0][i].ndim - 1})" in p]
    assert sharded_last, r["placements"]
    per_block_differs = False
    for name in ("mu", "nu"):
        one, two = r[name]
        for i in range(0, len(one), 2):
            q1, s1, q2, s2 = one[i], one[i + 1], two[i], two[i + 1]
            what = (name, i // 2)
            assert np.abs(q1.astype(np.int32) - q2).max() <= 1, what
            np.testing.assert_allclose(s2, s1, rtol=5e-3, err_msg=str(what))
            np.testing.assert_allclose(
                s2, np.maximum(np.abs(q2 * s2).max(-1, keepdims=True) / 127,
                               1e-12), rtol=1e-6, err_msg=str(what))
            if i // 2 in sharded_last:
                m1 = q1 * s1
                half = m1.shape[-1] // 2          # rank 0's block of a row
                blk = np.abs(m1[..., :half]).max(-1, keepdims=True) / 127
                per_block_differs |= bool((np.abs(blk - s1) >
                                           5e-3 * s1).any())
    assert per_block_differs


def _leaf_names(tree, pre=""):
    """Leaf paths in the trees' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             f"{pre}/{k}")]
    return [pre]


def test_mrope_microbatch_step_matches_jax(runs):
    """qwen2-vl smoke, microbatches 2, one CPU device: the (3, B, S)
    positions split on their batch dim as JAX splits them. The key bias
    ``attn/bk`` is left out of the params and moments rows: a constant
    added to every key's score leaves the softmax as it is, so its
    gradient is 0 but for rounding (~1e-9), and Adam's first step moves
    it by lr x g / (|g| + eps), any value in [-lr, lr]."""
    r, j = runs["qwen"], runs["jax"]["qwen"]
    assert abs(r["loss"] - j["loss"]) < 1e-4, (r["loss"], j["loss"])
    assert abs(r["grad_norm"] - j["grad_norm"]) / j["grad_norm"] < 1e-3
    names = _leaf_names(_qwen_case()[0].schema())
    keep = [i for i, n in enumerate(names) if not n.endswith("attn/bk")]
    assert len(keep) == len(names) - 1
    jp = runs["jax_qwen"]
    n = len(r["params"])
    assert n == len(names)
    _train_row([jp[i] for i in keep], [r["params"][i] for i in keep],
               "qwen vs JAX")
    jm = jp[n:]
    for i in keep:          # mu's row (5e-3 of max) and one int8 step
        want = jm[2 * i] * jm[2 * i + 1]
        got = r["mu"][2 * i] * r["mu"][2 * i + 1]
        step = np.maximum(jm[2 * i + 1], r["mu"][2 * i + 1])
        assert (np.abs(want - got) <= 5e-3 * np.abs(want).max() + step
                ).all(), names[i]


def test_mrope_positions_keep_their_streams():
    """Each microbatch's positions are (3, B / k, S) with the three
    streams of its own rows: a step on a batch whose streams differ
    equals the mean of the two half-batch steps' gradients."""
    model, batch = _qwen_case()
    pos = batch["positions"].clone()
    pos[1] += 3                               # streams that differ
    pos[2] *= 2
    batch = dict(batch, positions=pos)
    params = model.init(0, device="cpu")
    tc = dict(total_steps=10, warmup_steps=1)
    with torch.no_grad():
        whole = build_train_step(model, TrainConfig(microbatches=2, **tc))(
            params, adamw.init(params, model.cfg.moment_dtype), batch)[2]
    halves = []
    for h in range(2):
        part = {k: (v[:, 2 * h:2 * h + 2] if k == "positions"
                    else v[2 * h:2 * h + 2]) for k, v in batch.items()}
        loss, _ = model.loss_fn(params, part)
        halves.append(float(loss))
    assert abs(float(whole["loss"]) - sum(halves) / 2) < 1e-5
