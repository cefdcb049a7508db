"""Mesh-aware probing in this process, held against the JAX package.

What needs no second rank: ``parse_mesh_arg``, ``probe_axis_names`` and
the mesh-shape validation (``tests/test_meshprobe.py``); ``CycleRecord``
reductions, skew and straggler; the four mesh views byte for byte JAX's
on the same record (zero-probe records included; the comm table divides
by the bytes-per-cycle it is given, JAX's ICI rate here, the port's
NVLink rate by default); ``ring_wire_bytes`` and the collective term of
the cost model equal JAX's for every kind and G in 1..8;
``compress``/``decompress`` bitwise JAX's on the same numpy inputs. A
world-1 gloo process group in this process runs ``mesh_probe`` on JAX's
one-device workload against JAX's ``tiny_mesh`` (paths and calls equal,
record == ``ShardOracle``, outputs bitwise the unprobed run's, 3 steps
== 3 x one-shot, the ``sync`` site an all-reduce), and a body with one
collective of each kind, whose sites equal ``jaxpr_collectives``' at
G = 1. ``ShardOracle`` resolves ``axis_index`` with no process group.
``spawn`` refuses NCCL with more ranks than cards and reports a failed
rank's traceback; the unported mesh paths raise, naming ROADMAP. The
command lines ``train --mesh 2 --probe`` and ``serve --no-engine
--profile --mesh 2`` run on the CPU (two gloo ranks each) and print the
per-device tables; the mesh serve's token ids are the unprofiled
serve's.

Tolerances: none; every comparison here is exact (integers, text, or
bitwise floats).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.core import ProbeConfig as JaxProbeConfig
from repro.core import mesh_probe as jax_mesh_probe
from repro.core import report as jax_report
from repro.core.costmodel import ICI_BYTES_PER_CYCLE
from repro.core.costmodel import collective_axis_sizes as jax_axis_sizes
from repro.core.costmodel import collective_comm_bytes as jax_comm_bytes
from repro.core.meshprobe import CycleRecord as JaxCycleRecord
from repro.launch import collectives as jcol
from repro.launch import mesh as jmesh
from repro.optim import compression as jcomp
from repro_torch.core import costmodel as cm
from repro_torch.core import report, scope
from repro_torch.core.meshprobe import (CycleRecord, MeshProbeSession,
                                        mesh_probe, shard_oracle)
from repro_torch.core.pragma import ProbeConfig
from repro_torch.distributed import compat
from repro_torch.distributed.compat import P
from repro_torch.launch import collectives as tcol
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import compression
from repro_torch.testing import mesh_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


# ------------------------------------------------------------- mesh args

@pytest.mark.parametrize("arg", [None, "", "8", "2x4", "2,4", "2x2x2"])
def test_parse_mesh_arg_and_axis_names_match_jax(arg):
    got = tmesh.parse_mesh_arg(arg)
    assert got == jmesh.parse_mesh_arg(arg)
    if got:
        assert tmesh.probe_axis_names(got) == jmesh.probe_axis_names(got)
    with pytest.raises(ValueError):
        tmesh.parse_mesh_arg("2xbanana")


def test_mesh_shape_validation_lists_factorizations():
    for n in (1, 4, 6, 8, 12):
        for k in (1, 2, 3):
            assert tmesh._factorizations(n, k) == jmesh._factorizations(n, k)
    with pytest.raises(ValueError) as e:
        tmesh.validate_mesh_shape((3,), ("dev",), world=4)
    msg = str(e.value)
    assert "3" in msg and "factorization" in msg and "(4,)" in msg
    with pytest.raises(ValueError, match=r"\(2, 2\)"):
        tmesh.validate_mesh_shape((1, 3), ("a", "b"), world=4)
    with pytest.raises(ValueError):                 # arity mismatch
        tmesh.validate_mesh_shape((1, 1), ("a",), world=1)
    tmesh.validate_mesh_shape((2, 2), ("a", "b"), world=4)


# ----------------------------------------------------------- the record

def _records(totals, mesh_shape=(4,), paths=("a", "b")):
    totals = np.asarray(totals, np.int64)
    D, n = totals.shape
    kw = dict(mesh_axes=tuple(f"d{i}" for i in range(len(mesh_shape))),
              mesh_shape=tuple(mesh_shape), paths=tuple(paths),
              cycle=totals.sum(axis=1), starts=np.zeros_like(totals),
              ends=totals, totals=totals, calls=np.ones_like(totals),
              ring=np.zeros((D, n, 2, 2), np.int64))
    return CycleRecord(**kw), JaxCycleRecord(**kw)


def test_cycle_record_reductions_and_skew():
    rec, _ = _records([[10, 1], [20, 1], [30, 1], [40, 5]])
    assert np.array_equal(rec.reduce("max"), [40, 5])
    assert np.array_equal(rec.reduce("mean"), [25.0, 2.0])
    assert rec.reduce("per-device").shape == (4, 2)
    assert np.array_equal(rec.skew(), [30, 4])
    assert rec.straggler() == (3, "a")
    assert rec.coords(3) == (3,)
    assert rec.row("a", device=2) == 30
    dev = rec.device(1)
    assert dev["cycle"] == 21 and list(dev["totals"]) == [20, 1]
    with pytest.raises(ValueError):
        rec.reduce("median")
    zero, _ = _records(np.zeros((4, 0), np.int64), paths=())
    assert zero.straggler() == (0, "") and zero.skew().shape == (0,)


class _Node:
    def __init__(self, kind="scope", trip_count=None):
        self.kind, self.trip_count = kind, trip_count


class _Tree:
    """A hierarchy with a loop of 3 trips at ``layers/scan#0``."""
    def node(self, path):
        return _Node("loop", 3) if path == "layers/scan#0" else _Node()


_VIEW_CASES = {
    "1d": ([[10, 1, 7], [20, 1, 7], [30, 1, 9], [40, 5, 7]], (4,),
           ("layers", "layers/scan#0/sync", "head")),
    "2d": ([[3, 9, 1], [4, 9, 1], [5, 8, 1], [3, 12, 2]], (2, 2),
           ("sync", "layers", "layers/scan#0")),
    "zero": (np.zeros((4, 0), np.int64), (4,), ()),
}


@pytest.mark.parametrize("case", sorted(_VIEW_CASES))
def test_mesh_views_byte_equal_jax(case):
    totals, shape, paths = _VIEW_CASES[case]
    rec, jrec = _records(totals, shape, paths)
    assert report.mesh_device_table(rec) == \
        jax_report.mesh_device_table(jrec)
    assert report.mesh_device_table(rec, top=1) == \
        jax_report.mesh_device_table(jrec, top=1)
    assert report.mesh_heat(rec) == jax_report.mesh_heat(jrec)
    for p in paths:
        assert report.mesh_heat(rec, p) == jax_report.mesh_heat(jrec, p)

    class Snap:
        steps, state_nbytes = 3, 1234

    for mode in ("max", "mean", "per-device"):
        s, j = Snap(), Snap()
        s.record, j.record = rec, jrec
        assert report.mesh_session_table(s, mode) == \
            jax_report.mesh_session_table(j, mode)
    sites = [("layers/scan#0/sync", "all-reduce", ("d0",), 4, 400),
             ("sync", "all-gather", ("d0",), 2, 64),
             ("head", "collective-permute", ("d0",), 1, 32)]
    tsites = [tcol.CollectiveSite(p, "x", k, a, g, b,
                                  tcol.ring_wire_bytes(k, b, g))
              for p, k, a, g, b in sites]
    jsites = [jcol.CollectiveSite(p, "x", k, a, g, b,
                                  jcol.ring_wire_bytes(k, b, g))
              for p, k, a, g, b in sites]
    assert report.mesh_comm_table(rec, _Tree(), tsites,
                                  ICI_BYTES_PER_CYCLE) == \
        jax_report.mesh_comm_table(jrec, _Tree(), jsites)
    assert report.mesh_comm_table(rec, _Tree(), []) == \
        jax_report.mesh_comm_table(jrec, _Tree(), [])


# ---------------------------------------------------------- wire bytes

@pytest.mark.parametrize("kind", tcol.COLLECTIVE_KINDS)
def test_ring_wire_bytes_and_comm_bytes_match_jax(kind):
    prim = {"all-reduce": "psum", "all-gather": "all_gather",
            "reduce-scatter": "psum_scatter", "all-to-all": "all_to_all",
            "collective-permute": "ppermute"}[kind]
    for g in range(1, 9):
        for nbytes in (0, 4, 96, 4096 * 4, 10 ** 6 + 3):
            assert tcol.ring_wire_bytes(kind, nbytes, g) == \
                jcol.ring_wire_bytes(kind, nbytes, g)
            with cm.collective_axis_sizes({"dev": g}), \
                    jax_axis_sizes({"dev": g}):
                assert cm.collective_comm_bytes(
                    kind, ("dev",), 2 * nbytes, nbytes) == \
                    jax_comm_bytes(prim, ("dev",), 2 * nbytes, nbytes)
    # no axis sizes in context: the operand-bytes fallback
    assert cm.collective_comm_bytes(kind, ("dev",), 77, 5) == 77
    with pytest.raises(ValueError):
        tcol.ring_wire_bytes("all-of-the-above", 1, 2)


def test_compress_decompress_bitwise_jax():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(8, 16)).astype(np.float32),
             "b": {"c": (rng.normal(size=(33,)) * 1e-3).astype(np.float32),
                   "z": np.zeros((4,), np.float32)}}
    res = {"a": rng.normal(size=(8, 16)).astype(np.float32) * 1e-2,
           "b": {"c": np.zeros((33,), np.float32),
                 "z": np.zeros((4,), np.float32)}}
    # exact halves: round half to even on both sides
    grads["a"][0, :4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32)
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else  # noqa: E731
                      torch.from_numpy(v.copy()) for k, v in t.items()}
    jq, js, jr = jcomp.compress(jax.tree_util.tree_map(jnp.asarray, grads),
                                jax.tree_util.tree_map(jnp.asarray, res))
    tq, ts, tr = compression.compress(to_t(grads), to_t(res))
    for j, t in ((jq, tq), (js, ts), (jr, tr)):
        jl = jax.tree_util.tree_leaves(j)
        tl = compat.tree_leaves(t)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert np.array_equal(np.asarray(a), b.numpy())
            assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(jax.tree_util.tree_leaves(jcomp.decompress(jq, js)),
                    compat.tree_leaves(compression.decompress(tq, ts))):
        assert np.array_equal(np.asarray(a), b.numpy())
    zero = compression.init_residual(to_t(grads))
    assert all(float(z.abs().sum()) == 0 for z in compat.tree_leaves(zero))


# ------------------------------------------------------------- world 1

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process, and its mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("w1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield tmesh.make_mesh((1,), ("dev",))
    finally:
        dist.destroy_process_group()


def _jax_workload(x, w):
    def body(c, _):
        with jax.named_scope("layer"):
            c = jnp.tanh(c @ w) + c
        return c, None
    with jax.named_scope("layers"):
        x, _ = jax.lax.scan(body, x, None, length=3)
    with jax.named_scope("sync"):
        g = jax.lax.pmean(jnp.sum(x * x), "dev")
    with jax.named_scope("head"):
        return jnp.sum(x * x) + g


def test_world1_mesh_probe_matches_jax(world1, tiny_mesh):
    x = np.arange(16.0, dtype=np.float32).reshape(4, 4) * 0.1
    w = np.full((4, 4), 0.25, np.float32)
    jmpf = jax_mesh_probe(_jax_workload, tiny_mesh, (JP("dev"), JP()), JP(),
                          JaxProbeConfig(inline="off_all"))
    _, jstate = jmpf(jnp.asarray(x), jnp.asarray(w))
    jrec = jmpf.decode(jstate)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    body = mesh_ranks.workload(("dev",))
    mpf = mesh_probe(body, world1, (P("dev"), P()), P(),
                     ProbeConfig(inline="off_all"), device="cpu")
    out, state = mpf(tx, tw)
    rec = mpf.decode(state)
    assert rec.n_devices == 1 and rec.paths == jrec.paths
    assert np.array_equal(rec.calls, jrec.calls)
    assert torch.equal(out, mpf.unprobed()(tx, tw))
    oc = mpf.oracle(tx, tw, device=0)
    assert list(rec.device(0)["totals"]) == oc.totals
    assert list(rec.device(0)["calls"]) == oc.calls
    assert rec.device(0)["cycle"] == oc.cycle
    # the same replay with no process group and the rank's probe paths
    oc2 = shard_oracle(body, (tx, tw), (P("dev"), P()), ("dev",), (1,),
                       rec.paths)
    assert (oc2.totals, oc2.cycle) == (oc.totals, oc.cycle)
    sites = mpf.collectives()
    assert [(s.path, s.kind, s.group_size, s.result_bytes, s.wire_bytes)
            for s in sites] == [("sync", "all-reduce", 1, 4, 0.0)]
    assert [(s.path, s.kind, s.group_size, s.result_bytes, s.wire_bytes)
            for s in jmpf.collectives()] == \
        [("sync", "all-reduce", 1, 4, 0.0)]
    rep = mpf.report(state)
    assert "sync" in rep.comm_table() and "dev0" in rep.device_table()
    assert "skew" in rep.device_table() and "heat" in rep.heat("layers")
    st = mpf.init_state()
    for _ in range(3):
        _, st = mpf.stateful_call(st, tx, tw)
    assert np.array_equal(mpf.decode(st).totals, 3 * rec.totals)
    with MeshProbeSession(mpf, window_steps=2) as s:
        for _ in range(3):
            s.step(tx, tw)
        snap = s.snapshot()
    assert np.array_equal(snap.record.totals, 3 * rec.totals)
    assert snap.stats.n == rec.totals.size


def test_every_collective_kind_captured_as_jax_sees_it(world1):
    """One collective of each kind at G = 1: the capture's sites equal
    ``jaxpr_collectives``' (kind, axes, G, result bytes, wire bytes), the
    record equals ``ShardOracle``'s stubs, outputs bitwise."""
    def body(x):
        with scope.named_scope("sum"):
            a = compat.psum(x, "dev")
        with scope.named_scope("gather"):
            b = compat.all_gather(x, "dev")
        with scope.named_scope("scatter"):
            c = compat.psum_scatter(x, "dev")
        with scope.named_scope("a2a"):
            d = compat.all_to_all(x, "dev")
        with scope.named_scope("perm"):
            e = compat.ppermute(x, "dev", [(0, 0)])
        return a + b + c + d + e

    def jbody(x):
        with jax.named_scope("sum"):
            a = jax.lax.psum(x, "dev")
        with jax.named_scope("gather"):
            b = jax.lax.all_gather(x, "dev", tiled=True)
        with jax.named_scope("scatter"):
            c = jax.lax.psum_scatter(x, "dev", tiled=True)
        with jax.named_scope("a2a"):
            d = jax.lax.all_to_all(x, "dev", 0, 0, tiled=True)
        with jax.named_scope("perm"):
            e = jax.lax.ppermute(x, "dev", [(0, 0)])
        return a + b + c + d + e

    from repro.distributed import compat as jcompat
    with jcompat.extend_axis_env({"dev": 1}):
        closed = jax.make_jaxpr(jbody)(jnp.ones((8, 2), jnp.float32))
    want = sorted((k.kind, k.axes, k.group_size, k.result_bytes,
                   k.wire_bytes) for k in jcol.jaxpr_collectives(
                       closed.jaxpr, {"dev": 1}))
    x = torch.arange(16.0).reshape(8, 2)
    mpf = mesh_probe(body, world1, P("dev"), P("dev"),
                     ProbeConfig(inline="off_all"), device="cpu")
    out, state = mpf(x)
    got = sorted((s.kind, s.axes, s.group_size, s.result_bytes,
                  s.wire_bytes) for s in mpf.collectives())
    assert got == want
    assert {s.path for s in mpf.collectives()} == {
        "sum", "gather", "scatter", "a2a", "perm"}
    assert torch.equal(out, 5 * x)
    assert torch.equal(out, mpf.unprobed()(x))
    rec = mpf.decode(state)
    oc = mpf.oracle(x, device=0)
    assert list(rec.device(0)["totals"]) == oc.totals
    assert rec.device(0)["cycle"] == oc.cycle


def test_shard_oracle_resolves_axis_index_without_process_group():
    def fn(x):
        i = compat.axis_index("dev")

        def cond(s):
            return s[1] < i + 1

        def body(s):
            with scope.named_scope("grow"):
                return (s[0] * 1.5, s[1] + 1)
        with scope.named_scope("dynamic"):
            x, n = scope.while_loop(cond, body,
                                    (x, torch.zeros((), dtype=torch.int32)))
        return torch.sum(x), n

    totals = []
    for d in range(4):
        oc = shard_oracle(fn, (torch.ones(16),), P("dev"), ("dev",), (4,),
                          ("dynamic",), device=d)
        assert oc.calls == [1]
        totals.append(oc.totals[0])
    assert totals == sorted(totals) and len(set(totals)) == 4


# ------------------------------------------------- ranks and refusals

def test_spawn_refuses_nccl_beyond_the_cards_and_reports_a_failed_rank():
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match='backend="gloo"'):
        tmesh.spawn(mesh_ranks.failing_rank, (n,), device="cuda")
    with pytest.raises(RuntimeError) as e:
        tmesh.spawn(mesh_ranks.failing_rank, (2,), timeout=20)
    assert "rank1" in str(e.value) and "planted failure" in str(e.value)


def test_unported_mesh_paths_raise_naming_the_roadmap():
    """The paths this test once saw refused now run (the auto-sharded
    ``train(mesh_shape=...)`` and a ``shard_map`` whose auto axes have
    size > 1, over DTensor arguments); a ``shard_map`` given plain
    tensors for auto axes of size > 1 says what it takes."""
    from repro_torch.launch.train import train
    from repro_torch.testing import sharded_ranks
    _, _, losses = train(steps=1, batch=2, seq=8, device="cpu",
                         mesh_shape=(2,))
    assert len(losses) == 1 and np.isfinite(losses[0])
    got = tmesh.spawn(sharded_ranks.auto_axes_rank, (2,))
    assert all(r["ok"] for r in got), got
    env = compat.MeshEnv(("pod", "data", "model"), (1, 2, 1), (0, 0, 0),
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="DTensor"):
        compat.shard_map(lambda x: x, mesh=env, in_specs=P(),
                         out_specs=P(), axis_names={"pod"})(torch.ones(2))
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.steps import build_train_step
    model = mesh_ranks.smoke_model()
    with pytest.raises(RuntimeError, match="pod"):
        build_train_step(model, TrainConfig(grad_compression="int8_ef"))(
            {}, None, {}, {})
    with pytest.raises(ValueError, match="cycle_source"):
        mesh_probe(lambda x: x, None, P(), P(),
                   ProbeConfig(cycle_source="wallclock"))


def test_train_and_serve_mesh_command_lines_on_the_cpu():
    base = [sys.executable, "-m"]
    out = subprocess.run(
        base + ["repro_torch.launch.train", "--device", "cpu", "--steps",
                "1", "--batch", "2", "--seq", "8", "--probe", "--mesh",
                "2"], env=ENV, cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "# per-device cycle records" in out.stdout
    assert "dev1" in out.stdout and "# heat:" in out.stdout
    assert out.stdout.count("step     0 loss") == 1      # rank 0 prints
    serve = base + ["repro_torch.launch.serve", "--device", "cpu",
                    "--batch", "2", "--max-new", "2", "--no-engine"]
    prof = subprocess.run(serve + ["--profile", "--mesh", "2",
                                   "--profile-every", "1"], env=ENV,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert prof.returncode == 0, prof.stderr[-3000:]
    assert "over 2 devices" in prof.stdout
    assert "# per-device cycle records" in prof.stdout
    from repro_torch.launch.serve import serve as serve_fn
    plain = serve_fn(batch=2, max_new=2, engine=False, device="cpu")
    ids = [ln for ln in prof.stdout.splitlines() if "token ids" in ln]
    assert ids == [f"sampled token ids (first sequence): "
                   f"{plain.tokens[0].tolist()}"]
