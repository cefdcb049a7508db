"""Contracts of the sharded steps that only a mesh shows, on 4 gloo ranks
of a (2, 2) ``data, model`` mesh spawned once for the file
(``repro_torch.testing.sharded_ranks``), and the SSD scan's shared
memory declared to the DSE budget.

- padded q heads under ``TRAIN_RULES`` (arctic-480b's smoke config: 4
  real of 64 over 1 kv head; minicpm-2b's: 4 of 48 over 4): each model
  rank attends over its own real heads. The train step against the
  unsharded one: ``tests/test_torch_sharded_ranks.py``'s train-step row
  (loss rel 2e-3 and atol 1e-4, grad norm rtol 1e-3, params all but
  0.2 % of a leaf within lr / 10 and every element within 2 lr, moments
  5e-3 / 1e-2 of their largest value). f32 throughout, and arctic's MoE
  at a capacity where no token drops and without its aux loss (a mean of
  per-shard losses under a mesh), so the attention's layout is what is
  held. minicpm's ``SERVE_RULES`` prefill + 4 decodes: logits within
  2e-3 of max, the same ids, the caches within 1e-4;
- a MoE train step (granite-moe-1b-a400m's smoke config, f32) in 3
  microbatches of 4 rows, B 12 over ``data`` 2, so each rank's 6 rows
  cut microbatches and are moved to the ranks that hold them
  (``sharding.split_leading``): at capacity factor 1.0, where tokens
  drop, with the aux loss, against JAX's sharded step on the same
  (2, 2) mesh, params (the port's ``Model.init(0)``) and batch, in a
  subprocess started first (loss atol 1e-4, grad norm rtol 1e-3, the
  params row, mu 5e-3 of max): which tokens a shard drops and each
  microbatch's aux loss depend on which rows share a microbatch; and at
  a capacity where none drops, without the aux loss, against the port's
  unsharded step (the same row, nu 1e-2);
- ``core.mesh_probe`` over the ``TRAIN_RULES`` step (its DTensors placed
  by the rules, specs ``P()``): each device's record equals
  ``ShardOracle``'s replay of that device exactly, and the probed step's
  outputs are the unprobed step's, bit for bit;
- ``compat.shard_map`` with a gradient taken: an output its
  ``out_specs`` replicate over a manual axis passes when psum'd,
  pmean'd or all-gathered there, and raises when left as each device's
  own part;
- ``ssd_scan_space`` declares each chunk's shared memory
  (``ssd_scan.ssd_smem_bytes``, the kernels' ``ssd_scan_smem``), so the
  budget prunes a chunk the card cannot hold.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs.registry import smoke_config
from repro_torch.core.costmodel import DeviceBudget
from repro_torch.core.dse import DSEEngine
from repro_torch.core.incremental import EvalCache
from repro_torch.kernels import search_spaces as ss
from repro_torch.kernels import ssd_scan
from repro_torch.launch.mesh import spawn
from repro_torch.testing import sharded_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4                       # TrainConfig's learning rate
F32 = dict(compute_dtype="float32")
MOE = "granite-moe-1b-a400m"
MOE_B, MOE_S, MOE_K, MOE_SEED, MOE_CAPACITY = 12, 32, 3, 4, 1.0

JAX_MOE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.distributed import sharding as shd
from repro.distributed.compat import mesh_context
from repro.distributed.steps import build_train_step
from repro.launch.mesh import make_mesh
from repro.models.layers import Param
from repro.models.model import Model
from repro.optim import adamw

path, arch, k, cap = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    float(sys.argv[4])
leaves = jax.tree_util.tree_leaves
cfg = smoke_config(arch).replace(compute_dtype="float32")
m = Model(cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap)))
tree = jax.tree_util.tree_structure(m.schema(),
                                    is_leaf=lambda x: isinstance(x, Param))
with np.load(path + "/params.npz") as f:
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(f[f"arr_{i}"]) for i in range(len(f.files))])
with np.load(path + "/batch.npz") as f:
    batch = {key: jnp.asarray(f[key]) for key in ("tokens", "labels")}
mesh = make_mesh((2, 2), ("data", "model"))
with mesh_context(mesh), shd.axis_rules(
        shd.filter_rules(shd.TRAIN_RULES, mesh), mesh):
    p1, o1, m1 = jax.jit(build_train_step(
        m, TrainConfig(total_steps=10, warmup_steps=1, microbatches=k)))(
        params, adamw.init(params, cfg.moment_dtype), batch)
np.savez(path + "/jax_moe_mb.npz", *[
    np.asarray(a) for a in leaves(p1) + leaves(o1.mu)])
print(json.dumps(dict(loss=float(m1["loss"]),
                      grad_norm=float(m1["grad_norm"]))))
"""


def _arctic_over():
    moe = smoke_config("arctic-480b").moe
    return dict(F32, param_dtype="float32", moment_dtype="float32",
                train_microbatches=1, moe=dataclasses.replace(
                    moe, capacity_factor=moe.num_experts / moe.top_k,
                    aux_loss_weight=0.0))


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    """JAX's sharded MoE step in microbatches, its subprocess started
    before the ranks so that it runs beside them."""
    tmp = str(tmp_path_factory.mktemp("moe_mb"))
    sharded_ranks.save_params(MOE, os.path.join(tmp, "params.npz"))
    batch = sharded_ranks._batch(sharded_ranks.smoke_model(MOE).cfg, MOE_B,
                                 MOE_S, MOE_SEED, "cpu")
    np.savez(os.path.join(tmp, "batch.npz"),
             **{key: t.numpy() for key, t in batch.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_MOE, tmp, MOE, str(MOE_K),
         str(MOE_CAPACITY)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def result():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
            got["leaves"] = sharded_ranks.load_leaves(
                os.path.join(tmp, "jax_moe_mb.npz"))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def ranks(jax_moe):
    checks = {"train/arctic": dict(arch="arctic-480b", over=_arctic_over()),
              "train/minicpm": dict(arch="minicpm-2b", over=F32),
              "decode/minicpm": dict(arch="minicpm-2b", over=F32),
              "moe_mb": dict(arch=MOE, B=MOE_B, S=MOE_S, k=MOE_K,
                             seed=MOE_SEED, capacity=MOE_CAPACITY),
              "probed": {}, "contract": {}}
    threads_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return spawn(sharded_ranks.checks_rank, (2, 2), args=(
            [((2, 2), ("data", "model"), checks)],), timeout=300)
    finally:
        if threads_env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads_env


@pytest.mark.parametrize("arch", ("arctic-480b", "minicpm-2b"))
def test_padded_head_train_step_matches_unsharded(ranks, arch):
    cfg = smoke_config(arch)
    assert cfg.resolved_padded_heads > cfg.num_heads
    r = ranks[0][f"train/{arch.split('-')[0]}"]
    (l1, l2), (g1, g2) = r["loss"], r["grad_norm"]
    assert abs(l2 - l1) / abs(l1) < 2e-3 and abs(l2 - l1) < 1e-4
    assert abs(g2 - g1) / g1 < 1e-3
    for i, (a, b) in enumerate(zip(*r["params"])):
        d = np.abs(a.astype(np.float32) - b.astype(np.float32))
        assert d.max() <= 2 * LR, (arch, i, float(d.max()))
        assert (d > LR / 10).mean() <= 2e-3, (arch, i)
    for name, rel in (("mu", 5e-3), ("nu", 1e-2)):
        for i, (a, b) in enumerate(zip(*r[name])):
            np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(
                np.abs(a).max(), 1e-30), err_msg=f"{arch} {name} {i}")


def test_padded_head_decode_matches_unsharded(ranks):
    r = ranks[0]["decode/minicpm"]
    for a, b in zip(*r["logits"]):
        assert float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9)) < 2e-3
    for a, b in zip(*r["ids"]):
        assert (a == b).all()
    assert r["cache_max_diff"] < 1e-4


def _train_row(want, got, what):
    """The params row: all but 0.2 % of each leaf within lr / 10, every
    element within 2 lr."""
    for i, (a, b) in enumerate(zip(want, got)):
        d = np.abs(a.astype(np.float32) - b.astype(np.float32))
        assert d.max() <= 2 * LR, (what, i, float(d.max()))
        assert (d > LR / 10).mean() <= 2e-3, (what, i)


def _moments_row(want, got, rel, what):
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(
            np.abs(a).max(), 1e-30), err_msg=f"{what} {i}")


def test_moe_microbatches_cut_by_shards_match_jax_and_unsharded(ranks,
                                                                jax_moe):
    r = ranks[0]["moe_mb"]
    drop, no_drop, unsharded = range(3)
    want = jax_moe()
    n = len(r["params"][drop])
    assert abs(r["loss"][drop] - want["loss"]) < 1e-4, (r["loss"], want)
    assert abs(r["grad_norm"][drop] - want["grad_norm"]) / \
        want["grad_norm"] < 1e-3, (r["grad_norm"], want)
    _train_row(want["leaves"][:n], r["params"][drop], "vs JAX's sharded step")
    _moments_row(want["leaves"][n:], r["mu"][drop], 5e-3,
                 "mu vs JAX's sharded step")
    # tokens dropped at this capacity: the loss is not the no-drop one's
    assert abs(r["loss"][drop] - r["loss"][no_drop]) > 1e-4, r["loss"]
    assert abs(r["loss"][no_drop] - r["loss"][unsharded]) < 1e-4, r["loss"]
    assert abs(r["grad_norm"][no_drop] - r["grad_norm"][unsharded]) / \
        r["grad_norm"][unsharded] < 1e-3, r["grad_norm"]
    _train_row(r["params"][unsharded], r["params"][no_drop], "vs unsharded")
    for name, rel in (("mu", 5e-3), ("nu", 1e-2)):
        _moments_row(r[name][unsharded], r[name][no_drop], rel,
                     f"{name} vs unsharded")


def test_probed_sharded_step_matches_oracle_and_unprobed(ranks):
    for rank, r in enumerate(ranks):
        got = r["probed"]
        assert got["oracle_ok"], rank
        assert got["bit_ok"], rank
        assert got["n_probes"] == 16
        assert "loss/layers/scan#0/layer/attn/flash" in got["paths"]
        assert got["paths"] == ranks[0]["probed"]["paths"]


def test_shard_map_raises_on_an_unreduced_replicated_output(ranks):
    for r in ranks:
        got = r["contract"]
        assert got["psum"] == got["pmean"] == got["gather"] == "ok"
        assert "replicated over manual axis 'data'" in got["local"]
        assert "psum or pmean it" in got["local"]


def test_ssd_space_prunes_a_chunk_over_the_shared_memory_budget(tmp_path):
    # bf16 at mamba2's state dim: 113,664 bytes at chunk 256, two CTAs an
    # SM (the source's figure)
    assert ssd_scan.ssd_smem_bytes(2, 128, 256) == 113664
    assert ssd_scan.ssd_smem_bytes(4, 32, 256) == 0      # not a kernel N
    sp = ss.ssd_scan_space(H=2, G=1, L=4096, P=64, N=128,
                           chunks=(256, 1024, 4096), device="cpu")
    eng = DSEEngine(sp, cache=EvalCache(str(tmp_path)))
    trials = [eng.analyze(c) for c in sp.candidates()]
    alive = eng.prune(trials)
    # f32 at N 128: 257,024 bytes for chunks of 4096, over the opt-in
    assert [t.config["chunk"] for t in trials if t.pruned] == [4096]
    assert all("smem" in t.pruned for t in trials if t.pruned)
    assert [t.config["chunk"] for t in alive] == [256, 1024]
    assert all(DeviceBudget().fits(t.resources) for t in alive)
