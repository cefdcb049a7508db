"""Mesh-aware probing on spawned gloo ranks, held against the JAX package.

The port runs a mesh as one process a device (``launch.mesh.spawn``,
gloo on the CPU); the rank bodies are ``repro_torch.testing.mesh_ranks``
(a test module does not import in a spawned child). JAX's side runs in
ONE subprocess for the file, with four forced host devices
(``tests/test_meshprobe.py``'s isolation rule), started before the ranks
so the two overlap; its JSON is shared by a module-scoped fixture.

Checked at world 2 ``(2,)`` and world 4 ``(4,)`` and ``(2, 2)``: every
device's record equals ``ShardOracle`` on its rank exactly, and equals a
replay in this process (no process group at all); outputs are bitwise
``unprobed()``'s; a 3-step ``MeshProbeSession`` gives 3 x one-shot
totals and calls and publishes a device-major stream on the bus; the
per-device paths and calls (the skew workload's calls grow with the
device) and every collective site (path, kind, axes, G, result bytes,
wire bytes) equal JAX's on a mesh of the same shape. At world 2: the
data-parallel train step (tinyllama smoke, f32) against JAX's
``build_dp_train_step`` on the same params and batch, at
``tests/test_torch_train.py``'s tolerances (loss atol 1e-4, grad norm
rtol 1e-3, params: all but 0.2 % of a leaf within lr / 10 and every
element within 2 lr); its probe paths equal JAX's apart from the
JAX-only paths and call counts of ``_jax_only`` / ``_CALLS_DIFFER``;
and the ``int8_ef`` step on a 2-rank ``pod`` mesh within JAX's bounds of
the uncompressed step (``tests/test_distributed.py``: loss rel 2e-3,
params within 2 lr) and against JAX's ``int8_ef`` step on a (2, 1, 1)
mesh (params and each pod's residual: all but 0.2 % of a leaf within
lr / 10), a rule that a ring skipping the peer fails.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.launch.mesh import spawn
from repro_torch.testing import mesh_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2,), (4,), (2, 2))
LR = 3e-4                       # TrainConfig's learning rate

JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.core import ProbeConfig, mesh_probe
from repro.distributed.compat import mesh_context
from repro.distributed.steps import build_dp_train_step, build_train_step
from repro.launch.mesh import make_mesh, probe_axis_names
from repro.models.model import Model
from repro.optim import adamw, compression

def workload(axes, scan_len=3):
    axis = axes[0] if len(axes) == 1 else axes
    def step(x, w):
        def body(c, _):
            with jax.named_scope("layer"):
                c = jnp.tanh(c @ w) + c
            return c, None
        with jax.named_scope("layers"):
            x, _ = jax.lax.scan(body, x, None, length=scan_len)
        with jax.named_scope("sync"):
            g = jax.lax.pmean(jnp.sum(x * x), axis)
        i = jax.lax.axis_index(axis)
        def cond(s): return s[1] < i + 1
        def grow(s):
            with jax.named_scope("grow"):
                return (s[0] * 1.1, s[1] + 1)
        with jax.named_scope("dynamic"):
            x, n = jax.lax.while_loop(cond, grow, (x, jnp.int32(0)))
        with jax.named_scope("head"):
            return jnp.sum(x * x) + g, n
    return step

def sites(mpf):
    return sorted([s.path, s.kind, list(s.axes), s.group_size,
                   s.result_bytes, float(s.wire_bytes)]
                  for s in mpf.collectives())

out = {"workload": {}}
for shape in [(2,), (4,), (2, 2)]:
    axes = probe_axis_names(shape)
    n = int(np.prod(shape))
    x = jnp.arange(8.0 * n).reshape(2 * n, 4) * 0.01
    w = jnp.full((4, 4), 0.25)
    mpf = mesh_probe(workload(axes), make_mesh(shape, axes),
                     (P(axes), P()), P(), ProbeConfig(inline="off_all"))
    _, state = mpf(x, w)
    rec = mpf.decode(state)
    out["workload"][str(shape)] = dict(paths=list(rec.paths),
                                       calls=rec.calls.tolist(),
                                       sites=sites(mpf))
cfg = smoke_config("tinyllama-1.1b").replace(compute_dtype="float32")
model = Model(cfg)
params = model.init(jax.random.PRNGKey(0))
opt = adamw.init(params, cfg.moment_dtype)
b = np.load(sys.argv[1])
batch = {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}
step = build_dp_train_step(model, TrainConfig(total_steps=10,
                                              warmup_steps=1), axis="dev")
mpf = mesh_probe(step, make_mesh((2,), ("dev",)), (P(), P(), P("dev")),
                 (P(), P(), P()),
                 ProbeConfig(inline="off_all", max_probes=500))
(p1, _, m1), state = mpf(params, opt, batch)
rec = mpf.decode(state)
np.savez(sys.argv[2], *[np.asarray(a) for a in
                        jax.tree_util.tree_leaves(p1)])
out["dp"] = dict(paths=list(rec.paths), calls=rec.calls.tolist(),
                 sites=sites(mpf), loss=float(m1["loss"]),
                 grad_norm=float(m1["grad_norm"]))
pods = make_mesh((2, 1, 1), ("pod", "data", "model"))
with mesh_context(pods):
    step = build_train_step(model, TrainConfig(
        total_steps=10, warmup_steps=1, grad_compression="int8_ef"))
    q1, _, r1, mq = jax.jit(step)(params, opt, batch,
                                  compression.init_residual(params))
def shard(a, d):        # pod d's value of an output replicated by contract
    return next(np.asarray(s.data) for s in a.addressable_shards
                if s.device == pods.devices.flat[d])
np.savez(sys.argv[3], *[np.asarray(a) for a in
                        jax.tree_util.tree_leaves(q1)])
np.savez(sys.argv[4], *[shard(a, d) for d in range(2)
                        for a in jax.tree_util.tree_leaves(r1)])
out["int8"] = dict(loss=float(mq["loss"]))
print(json.dumps(out))
"""


def _jax_only(path: str) -> bool:
    """JAX paths of the train step the port has no counterpart for (the
    reasons of ``tests/test_torch_train.py``'s ``_jax_only``): einsum
    scopes, the XLA flash route's forward scopes, and the loop-invariant
    work JAX's partial evaluation hoists to top-level ``layer``,
    ``logits`` and ``xent`` nodes."""
    segs = path.split("/")
    if any("->" in s for s in segs):
        return True
    if segs[0] in ("layer", "logits", "xent"):
        return True
    return "flash" in segs[:-1] and "qblk_bwd" not in segs


_REMAT_SPLIT = "the XLA flash route's remat split (test_torch_train.py)"
# path -> (JAX's calls, the port's calls, why): JAX's partial evaluation
# splits the grads and loss scopes' one visit around the hoisted nodes
_CALLS_DIFFER = {
    "grads": (3, 1, "partial evaluation splits the visit"),
    "grads/loss": (3, 1, "partial evaluation splits the visit"),
    "grads/loss~bwd/layers/scan#0/rematted_computation/layer":
        (4, 2, _REMAT_SPLIT),
    "grads/loss~bwd/layers/scan#0/rematted_computation/layer/attn":
        (4, 2, _REMAT_SPLIT),
    "grads/loss~bwd/layers/scan#0/rematted_computation/layer/attn/flash":
        (4, 2, _REMAT_SPLIT),
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(the JAX subprocess, the params and batch of the DP step, the npz
    path JAX writes its params to); the subprocess starts here, before
    any rank, so the two sides run at once."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 257, (4, 32)).astype(np.int32),
             "labels": rng.integers(0, 257, (4, 32)).astype(np.int32)}
    np.savez(tmp / "batch.npz", **batch)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(tmp / "batch.npz"),
         str(tmp / "jax_params.npz"), str(tmp / "jax_int8_params.npz"),
         str(tmp / "jax_int8_residual.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    cfg = jax_smoke_config("tinyllama-1.1b").replace(compute_dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    return proc, params, batch, tmp


@pytest.fixture(scope="module")
def ranks(case):
    """Every shape's rank results (the DP and int8 steps at world 2)."""
    _, params, batch, _ = case
    out = {}
    for shape in SHAPES:
        out[shape] = spawn(mesh_ranks.suite_rank, shape, args=(shape,),
                           kwargs=dict(params_np=params, batch_np=batch)
                           if shape == (2,) else {})
    return out


@pytest.fixture(scope="module")
def jax_side(case):
    proc, _, _, tmp = case
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    for key, name in (("dp", "params"), ("int8", "int8_params"),
                      ("int8", "int8_residual")):
        with np.load(tmp / f"jax_{name}.npz") as z:
            out[key][name.split("_")[-1]] = [z[f"arr_{i}"]
                                              for i in range(len(z.files))]
    n = len(out["int8"]["params"])
    res = out["int8"]["residual"]
    out["int8"]["residual"] = [res[:n], res[n:]]        # pod 0, pod 1
    return out


def _leaves_off(want, got, tol):
    """Indices of the leaves where more than 0.2 % of the elements of
    ``got`` are further than ``tol`` from ``want``
    (``tests/test_torch_train.py``'s rule for a step's params)."""
    assert len(want) == len(got)
    return [i for i, (a, b) in enumerate(zip(want, got))
            if (np.abs(np.asarray(a, np.float32) - b) > tol).mean() >= 2e-3]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_device_equals_its_shard_oracle(ranks, shape):
    res = ranks[shape]
    assert [r["workload"]["oracle_ok"] for r in res] == [True] * len(res)
    assert all(r["workload"]["bit_ok"] for r in res)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_replay_with_no_process_group_equals_every_device(ranks, shape):
    """``shard_oracle`` in this process (no process group) replays each
    device to the rank's record exactly."""
    from repro_torch.core.meshprobe import shard_oracle
    from repro_torch.distributed.compat import P
    from repro_torch.launch.mesh import probe_axis_names
    rec = ranks[shape][0]["workload"]["record"]
    axes = probe_axis_names(shape)
    n = int(np.prod(shape))
    x, w = mesh_ranks.workload_inputs(n)
    for d in range(n):
        oc = shard_oracle(mesh_ranks.workload(axes, skew=True), (x, w),
                          (P(axes), P()), axes, shape, rec["paths"],
                          device=d)
        assert oc.totals == rec["totals"][d], d
        assert oc.calls == rec["calls"][d], d
        assert (oc.starts, oc.ends) == (rec["starts"][d], rec["ends"][d])
        assert oc.cycle == rec["cycle"][d]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_paths_calls_and_sites_equal_jax(ranks, jax_side, shape):
    got = ranks[shape][0]["workload"]
    want = jax_side["workload"][str(shape)]
    assert got["record"]["paths"] == want["paths"]
    assert got["record"]["calls"] == want["calls"]
    assert [list(s) for s in got["sites"]] == want["sites"]
    # the skew workload: device d loops d + 1 times
    pid = want["paths"].index("dynamic/while#0/body/grow")
    assert [c[pid] for c in got["record"]["calls"]] == \
        list(range(1, int(np.prod(shape)) + 1))
    totals = np.asarray(got["record"]["totals"])[:, want["paths"].index(
        "dynamic")]
    assert np.all(np.diff(totals) > 0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_session_is_k_times_one_shot_and_streams_per_device(ranks, shape):
    n = int(np.prod(shape))
    for r in ranks[shape]:
        w = r["workload"]
        assert w["sess_ok"], r["rank"]
        assert w["stream"] == dict(n_devices=n, windows=2, totals_ok=True)
    views = ranks[shape][0]["workload"]
    assert f"dev{n - 1}" in views["device_table"]
    assert "sync" in views["comm_table"]
    assert "heat" in views["heat"] and "mesh session" in \
        views["session_table"]


def test_dp_train_step_matches_jax(ranks, jax_side):
    res = ranks[(2,)]
    assert all(r["dp"]["oracle_ok"] and r["dp"]["bit_ok"] for r in res)
    got, want = res[0]["dp"], jax_side["dp"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(want["params"], got["params"]):
        d = np.abs(np.asarray(a, np.float32) - b)
        assert (d > LR / 10).mean() < 2e-3
        assert d.max() <= 2 * LR + 1e-6
    assert [list(s) for s in got["sites"]] == want["sites"]
    assert any(s[0] == "grad_exchange" and s[3] == 2 and s[5] > 0
               for s in got["sites"])
    jpaths = [p for p in want["paths"] if not _jax_only(p)]
    assert got["record"]["paths"] == jpaths
    jcalls = dict(zip(want["paths"], zip(*want["calls"])))
    for p, tc in zip(got["record"]["paths"], zip(*got["record"]["calls"])):
        jc = jcalls[p]
        if p in _CALLS_DIFFER:
            jw, tw, _ = _CALLS_DIFFER[p]
            assert (jc, tc) == ((jw, jw), (tw, tw)), p
        else:
            assert tc == jc, p


def test_int8_ef_step_within_jax_bounds(ranks):
    for r in ranks[(2,)]:
        q = r["int8"]
        assert abs(q["l0"] - q["l1"]) / abs(q["l0"]) < 2e-3, q["l0"]
        assert q["abs_diff"] < 2 * LR + 1e-6, q["abs_diff"]
        assert max(np.abs(x).max() for x in q["residual"]) > 0


def _residual_leaves_off(want, got, scales, tol):
    """Indices of the residual leaves off JAX's: an element whose int8
    rounding flips between the two sides (its value within float noise
    of a half step) moves by one step, the leaf's scale. So all but
    0.2 % of a leaf must be within ``tol`` of JAX's residual or of it
    one step away, and at most 1 % of a leaf may flip (the most read
    is 0.42 %, f32 gradients of the two packages ~2e-6 apart relative
    to a leaf's largest)."""
    assert len(want) == len(got) == len(scales)
    off = []
    for i, (a, b, s) in enumerate(zip(want, got, scales)):
        d = np.abs(np.asarray(a, np.float32) - b)
        flip = np.abs(d - s) <= tol
        if ((d > tol) & ~flip).mean() >= 2e-3 or flip.mean() >= 1e-2:
            off.append(i)
    return off


def test_int8_ef_step_matches_jax(ranks, jax_side):
    """The new params (every pod's) and each pod's residual against
    JAX's ``int8_ef`` step on a (2, 1, 1) pod/data/model mesh, from the
    same params and batch: the params at the DP step's rule, the
    residual at ``_residual_leaves_off``'s, both with lr / 10."""
    want = jax_side["int8"]
    for r in ranks[(2,)]:
        q = r["int8"]
        np.testing.assert_allclose(q["l1"], want["loss"], atol=1e-4)
        assert _leaves_off(want["params"], q["params"], LR / 10) == []
        assert _residual_leaves_off(want["residual"][q["rank"]],
                                    q["residual"], q["scales"],
                                    LR / 10) == []


def test_int8_ef_rule_fails_a_ring_that_skips_the_peer(ranks, jax_side):
    """The same rule has teeth: a ring that never sends the payload to
    the peer pod (each pod trains on its half of the batch) is off in
    most leaves."""
    want = jax_side["int8"]["params"]
    for r in ranks[(2,)]:
        off = _leaves_off(want, r["int8"]["skip_peer_params"], LR / 10)
        assert len(off) > len(want) // 2, off
