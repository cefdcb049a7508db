"""The ``int8_ef`` step on a (2, 1, 2) ``pod,data,model`` mesh and
``train(mesh_shape=(2, 2))``, on spawned gloo ranks, held against the
port's uncompressed and unsharded runs and the JAX package.

The ranks run ``repro_torch.testing.sharded_ranks``. The (2, 1, 2)
world, the world ``train(mesh_shape=(2, 2))`` spawns, its unsharded
twin and ONE JAX subprocess with four forced host devices
(``tests/test_torch_mesh_ranks.py``'s isolation rule) start together
and are shared by a module-scoped fixture. The (2, 2) world is in
``tests/test_torch_sharded_ranks.py``. Tolerances are JAX's own
``tests/test_distributed.py``'s:

- ``int8_ef`` with ``data`` / ``model`` auto-sharded inside the
  pod-manual ``shard_map``: loss rel 2e-3 and params within 2 lr of the
  uncompressed sharded step, and the same against JAX's ``int8_ef``
  step on the same mesh, from the same params (the port's
  ``Model.init(0)``);
- ``train(mesh_shape=(2, 2))`` runs 2 steps, its losses within bf16
  noise of the unsharded ``train``'s.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn
from repro_torch.testing import sharded_ranks
from repro_torch.testing.sharded_ranks import load_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4                       # TrainConfig's learning rate

JAX_SIDE = r"""
import json, sys
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
from repro.optim import adamw, compression

out_dir = sys.argv[1]
b = np.load(out_dir + "/batch.npz")
cfg = smoke_config("tinyllama-1.1b").replace(compute_dtype="float32")
m = Model(cfg)
tree = jax.tree_util.tree_structure(
    m.schema(), is_leaf=lambda x: isinstance(x, Param))
with np.load(out_dir + "/tiny.npz") as f:
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(f[f"arr_{i}"]) for i in range(len(f.files))])
pods = make_mesh((2, 1, 2), ("pod", "data", "model"))
rules = shd.filter_rules(shd.TRAIN_RULES, pods)
batch = {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}
with mesh_context(pods), shd.axis_rules(rules, pods):
    step = build_train_step(m, TrainConfig(total_steps=10, warmup_steps=1,
                                           grad_compression="int8_ef"))
    q1, _, _, mq = jax.jit(step)(params, adamw.init(params, cfg.moment_dtype),
                                 batch, compression.init_residual(params))
np.savez(out_dir + "/jax_int8.npz",
         *[np.asarray(a) for a in jax.tree_util.tree_leaves(q1)])
print(json.dumps({"int8_loss": float(mq["loss"])}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's subprocess, on threads the (2, 1, 2) world's int8 and
    ``train(mesh_shape=(2, 2))``, and its unsharded twin here."""
    tmp = str(tmp_path_factory.mktemp("sharded_pods"))
    ib = sharded_ranks._batch(sharded_ranks.smoke_model().cfg, 8, 32, 3,
                              "cpu")
    np.savez(os.path.join(tmp, "batch.npz"), tokens=ib["tokens"].numpy(),
             labels=ib["labels"].numpy())
    sharded_ranks.save_params("tinyllama-1.1b", os.path.join(tmp, "tiny.npz"),
                              compute_dtype="float32")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, tmp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    from repro_torch.launch.train import train
    kw = dict(steps=2, batch=4, seq=16, device="cpu", log_every=1)
    got = {}

    def run(name, fn):
        try:
            got[name] = fn()
        except BaseException as e:          # re-raised on the main thread
            got[name] = e
    jobs = {
        "pods": lambda: spawn(sharded_ranks.checks_rank, (2, 1, 2), args=(
            [((2, 1, 2), ("pod", "data", "model"), {"int8": {}})],),
            timeout=300),
        "train_cli": lambda: train(mesh_shape=(2, 2), **kw)[2],
    }
    # one thread a rank (torch reads OMP_NUM_THREADS as a child starts):
    # 8 ranks and JAX share the host
    threads_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        threads = [threading.Thread(target=run, args=job)
                   for job in jobs.items()]
        for t in threads:
            t.start()
        got["train_plain"] = train(**kw)[2]
        for t in threads:
            t.join()
    finally:
        if threads_env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads_env
    stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, stderr[-3000:]
    for v in got.values():
        if isinstance(v, BaseException):
            raise v
    got["jax"] = json.loads(stdout.strip().splitlines()[-1])
    got["jax_int8"] = load_leaves(os.path.join(tmp, "jax_int8.npz"))
    return got


def test_int8_ef_with_auto_sharded_data_and_model(runs):
    r = runs["pods"][0]["int8"]
    l0, l1 = r["loss"]
    assert abs(l0 - l1) / abs(l0) < 2e-3
    assert abs(runs["jax"]["int8_loss"] - l1) / abs(l1) < 2e-3
    for ref in (r["params"][0], runs["jax_int8"]):
        d = max(float(np.abs(a - b).max())
                for a, b in zip(ref, r["params"][1]))
        assert d < 2 * LR + 1e-6, d
    # inside the pod-manual region the model axis stays a placement
    assert any("Shard" in p for p in r["placements"])
    assert runs["pods"][3]["coords"] == [[1, 0, 1]]


def test_train_with_mesh_shape_runs(runs):
    sharded, plain = runs["train_cli"], runs["train_plain"]
    assert len(sharded) == 2 and all(np.isfinite(sharded))
    # bf16 params: the two orders of summation differ by bf16 noise
    np.testing.assert_allclose(sharded, plain, rtol=2e-3)
