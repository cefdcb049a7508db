"""Grid-step probing in the port (``ProbeConfig(kernel_probes=...)``)
against ``repro.core``'s, on the CPU with the kernels' plain versions.

- Paths and calls: the port's flash, SSD and paged grid subtrees equal
  the goldens' paths (``tests/golden/flash_grid.json``,
  ``ssd_grid.json``) and the paths and calls of ``repro.core.probe`` run
  live on the Pallas kernels in interpret mode. Under jax 0.9.0 the
  reference names every kernel body ``kernel`` (its ``kernel#i`` nodes:
  the naming fault of ROADMAP Queue 3), so JAX's ``kernel#i`` is mapped
  to the body name (``flash_kernel#i``, ...) before the comparison. The
  flash golden is taken at ``pipeline = 2``, which the port's flash
  kernel does not have, so it is compared on paths only; the live JAX
  run is at the port's ``block_q = block_k = 64``, ``pipeline = 1``.
- Exactness inside the port: the device record equals the port's oracle
  (which replays the grid from the plan and the inputs), integer for
  integer, with outputs ``torch.equal`` to the unprobed ones, with and
  without offload; kernel-scope totals equal grid totals and grid calls
  equal steps x kernel calls.
- The causal skew shows in the record's grid steps (the property the
  reference's own test is named for, which it fails today on the
  kernel's name): its durations differ, they sum to the grid's total,
  and offload keeps every step; without the causal mask the ``kv_block``
  durations are one value.
- The fold (``kernels.probe_events.probe_grid``) equals the same step
  events applied one transition at a time through ``probe_events``' plain
  version, and the report's grid views render JAX's text on the golden's
  record.

Everything compared is an integer or text: the tolerance is exact.
Records are never compared with JAX's cycles: the two packages price on
different chips' constants.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import ProbeConfig as JaxProbeConfig
from repro.core import kernel_grid_heat as jax_grid_heat
from repro.core import kernel_grid_table as jax_grid_table
from repro.core import probe as jax_probe
from repro.core.kernelprobe import unravel as jax_unravel
from repro.core.instrument import decode_record as jax_decode_record
from repro.engine import step as jax_step
from repro.kernels import flash_attention as jfa
from repro.kernels import paged_attention as jpa
from repro.kernels import ssd_scan as jssd
from repro.models import Model as JaxModel
from repro_torch.configs.registry import smoke_config
from repro_torch.core import (KernelOracle, ProbeConfig, ProbeSession,
                              decode_record, init_state, kernel_grid_heat,
                              kernel_grid_table, probe, scope)
from repro_torch.core import kernelprobe as kp
from repro_torch.core.hierarchy import Hierarchy, ScopeNode
from repro_torch.core.report import ProbeRow, Report
from repro_torch.engine import step as torch_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import probe_events as kpe
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
KCFG = ProbeConfig(inline="off_all", kernel_probes=("*",))
JKCFG = JaxProbeConfig(inline="off_all", kernel_probes=("*",))


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        return json.load(f)


def _body_named(path: str, body: str) -> str:
    """JAX's ``kernel#i`` node named by the kernel's body (jax 0.9.0
    names every body ``kernel``; ROADMAP Queue 3)."""
    return "/".join(f"{body}#{s.split('#')[1]}" if s.startswith("kernel#")
                    else s for s in path.split("/"))


def _jax_paths_calls(fn, args, cfg, body):
    pf = jax_probe(fn, cfg)
    _, rec = pf(*args)
    calls = jax_decode_record(rec)["calls"]
    return [(_body_named(p, body), int(c))
            for p, c in zip(pf.probe_paths(), calls)]


def _paths_calls(pf, rec):
    return list(zip(pf.probe_paths(),
                    [int(c) for c in decode_record(rec)["calls"]]))


def _assert_exact(pf, rec, oc):
    dec = decode_record(rec)
    assert dec["cycle"] == oc.cycle
    for i, p in enumerate(pf.probe_paths()):
        assert int(dec["totals"][i]) == oc.totals[i], p
        assert int(dec["calls"][i]) == oc.calls[i], p
        assert int(dec["starts"][i]) == oc.starts[i], p
        assert int(dec["ends"][i]) == oc.ends[i], p
        assert [tuple(r) for r in dec["ring"][i].tolist()] == oc.ring[i], p


def _assert_grid_invariants(pf, rec):
    """kernel totals == grid totals; grid calls == steps x kernel calls;
    inner scopes never exceed their grid."""
    dec = decode_record(rec)
    paths = list(pf.probe_paths())
    seen = 0
    for i, p in enumerate(paths):
        node = pf.hierarchy.node(p)
        if node is None or node.kind != "kernel":
            continue
        seen += 1
        gi = paths.index(p + "/grid")
        grid = pf.hierarchy.node(p + "/grid").grid
        assert int(dec["totals"][i]) == int(dec["totals"][gi]), p
        assert int(dec["calls"][gi]) == int(np.prod(grid)) * int(
            dec["calls"][i]), p
        for j, q in enumerate(paths):
            if q.startswith(p + "/grid/"):
                assert int(dec["totals"][j]) <= int(dec["totals"][gi]), q
    assert seen


# ------------------------------------------------------------ programs

def _flash_np(B=1, H=2, S=128, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, D)).astype(np.float32)
                 for _ in range(3))


def _t_flash(causal=True, q_offset=0):
    def fn(q, k, v):
        with scope.named_scope("attn"):
            return fa.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset)
    return fn


def _j_flash(pipeline=1, causal=True):
    def fn(q, k, v):
        with jax.named_scope("attn"):
            return jfa.flash_attention(q, k, v, causal=causal, block_q=64,
                                       block_k=64, pipeline=pipeline,
                                       interpret=True)
    return fn


def _ssd_np(B=1, H=2, L=128, P=16, N=32, G=2, seed=1):
    """JAX's layout: x (B, H, L, P), a (B, H, L), b / c (B, G, L, N)."""
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.standard_normal((B, H, L, P))).astype(np.float32),
            (-0.3 * np.abs(rng.standard_normal((B, H, L)))).astype(np.float32),
            (0.5 * rng.standard_normal((B, G, L, N))).astype(np.float32),
            (0.5 * rng.standard_normal((B, G, L, N))).astype(np.float32))


def _ssd_torch_args(x, a, b, c):
    """The port's model layout: x (B, L, H, P), a (B, L, H), b / c
    (B, L, G, N)."""
    t = torch.from_numpy
    return (t(x).permute(0, 2, 1, 3).contiguous(),
            t(a).permute(0, 2, 1).contiguous(),
            t(b).permute(0, 2, 1, 3).contiguous(),
            t(c).permute(0, 2, 1, 3).contiguous())


def _t_ssd(chunk=32, pipeline=2, h_per_g=1):
    def fn(x, a, b, c):
        with scope.named_scope("ssd"):
            return ssd.ssd_scan(x, a, b, c, chunk=chunk, h_per_g=h_per_g,
                                pipeline=pipeline)
    return fn


def _j_ssd(chunk=32, pipeline=2):
    def fn(x, a, b, c):
        with jax.named_scope("ssd"):
            return jssd.ssd_scan(x, a, b, c, chunk=chunk, pipeline=pipeline,
                                 interpret=True)
    return fn


def _paged_np(B=2, kv=2, g=2, hd=64, P=9, ps=16, n_pages=4, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, kv, g, hd)).astype(np.float32),
            rng.standard_normal((P, ps, kv, hd)).astype(np.float32),
            rng.standard_normal((P, ps, kv, hd)).astype(np.float32),
            rng.integers(1, P, (B, n_pages)).astype(np.int32),
            np.array([20, 50][:B], np.int32))


def _paged_torch_args(q, pk, pv, pages, pos):
    return (torch.from_numpy(q), torch.from_numpy(pk).to(torch.bfloat16),
            torch.from_numpy(pv).to(torch.bfloat16), torch.from_numpy(pages),
            torch.from_numpy(pos))


def _t_paged(pages_per_step=1, pos_host=None):
    def fn(q, pk, pv, pages, pos):
        with scope.named_scope("attn"):
            return pa.paged_attention(q, pk, pv, pages, pos,
                                      pages_per_step=pages_per_step,
                                      pos_host=pos_host)
    return fn


def _j_paged(pages_per_step=1):
    def fn(q, pk, pv, pages, pos):
        with jax.named_scope("attn"):
            return jpa.paged_attention(q, pk, pv, pages, pos,
                                       pages_per_step=pages_per_step,
                                       interpret=True)
    return fn


def _program(name):
    """(port fn, port args factory) of one small kernel program."""
    if name == "flash":
        args = _flash_np()
        return _t_flash(), lambda: tuple(torch.from_numpy(a) for a in args)
    if name == "flash_chunk":       # rows 64..127 of 192 keys
        rng = np.random.default_rng(4)
        q = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
        k, v = (rng.standard_normal((1, 1, 192, 32)).astype(np.float32)
                for _ in range(2))
        return (_t_flash(q_offset=64),
                lambda: tuple(torch.from_numpy(a) for a in (q, k, v)))
    if name == "ssd":
        args = _ssd_np()
        return _t_ssd(), lambda: _ssd_torch_args(*args)
    args = _paged_np()
    return (_t_paged(pos_host=tuple(int(p) for p in args[4])),
            lambda: _paged_torch_args(*args))


# ------------------------------------------------- paths and calls vs JAX

def test_flash_paths_match_the_golden_and_jax():
    fn, make = _program("flash")
    pf = probe(fn, KCFG, device="cpu")
    _, rec = pf(*make())
    got = _paths_calls(pf, rec)
    assert [p for p, _ in got] == _golden("flash_grid")["paths"]
    jargs = tuple(jnp.asarray(a) for a in _flash_np())
    assert got == _jax_paths_calls(_j_flash(), jargs, JKCFG, "flash_kernel")
    assert pf.hierarchy.node("attn/kernel/flash_kernel#0/grid").grid == \
        (1, 2, 2, 2)


def test_ssd_paths_and_calls_match_the_golden_and_jax():
    fn, make = _program("ssd")
    pf = probe(fn, KCFG, device="cpu")
    _, rec = pf(*make())
    got = _paths_calls(pf, rec)
    gold = _golden("ssd_grid")
    assert got == list(zip(gold["paths"], gold["record"]["calls"]))
    jargs = tuple(jnp.asarray(a) for a in _ssd_np())
    assert got == _jax_paths_calls(_j_ssd(), jargs, JKCFG, "ssd_kernel")


def test_paged_paths_and_calls_match_jax():
    args = _paged_np()
    pf = probe(_t_paged(pos_host=tuple(int(p) for p in args[4])), KCFG,
               device="cpu")
    _, rec = pf(*_paged_torch_args(*args))
    jargs = tuple(jnp.asarray(a) for a in args[:1]) + (
        jnp.asarray(args[1], jnp.bfloat16), jnp.asarray(args[2], jnp.bfloat16),
        jnp.asarray(args[3]), jnp.asarray(args[4]))
    assert _paths_calls(pf, rec) == _jax_paths_calls(
        _j_paged(), jargs, JKCFG, "paged_kernel")


F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")


def _jax_only(path: str) -> bool:
    """JAX's einsum scopes (``qkv/bsd,dnh->bsnh``), which the port has no
    counterpart for (``tests/test_torch_probe.py``)."""
    return any("->" in s for s in path.split("/"))


def test_paged_grid_inside_the_engine_decode_step_matches_jax():
    """The paged kernel's grid inside a kernel decode step of the engine
    (tinyllama smoke config at f32, pages of 16, tables of 2): its
    subtree's paths and calls equal JAX's ``paged_attention`` probed
    alone at the step's shapes, times the layers; the whole step's equal
    JAX's engine step probed with kernel probes (interpret mode)."""
    jm = JaxModel(jax_smoke_config("tinyllama-1.1b").replace(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config("tinyllama-1.1b").replace(**F32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    cfg, ps = tm.cfg, 16
    shape = (cfg.num_layers, 6, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    pool = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    batch = {"tokens": np.array([[3], [0]], np.int32),
             "pos": np.array([20, 0], np.int32),
             "pages": np.array([[2, 3], [0, 0]], np.int32)}
    cfgk = KCFG.replace(max_probes=500)
    pf = probe(torch_step.build_paged_decode(tm, 2, 2, ps, use_kernel=True),
               cfgk, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["pos_host"] = (20, 0)            # as the engine passes them
    _, rec = pf(tp, torch.from_numpy(pool.copy()),
                torch.from_numpy(pool.copy()), tb)
    got = _paths_calls(pf, rec)

    jfn = jax_step.build_paged_decode(jm, 2, 2, ps, use_kernel=True,
                                      interpret=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = [(p, c) for p, c in _jax_paths_calls(
        jfn, (jp, jnp.asarray(pool), jnp.asarray(pool), jb),
        JaxProbeConfig(inline="off_all", max_probes=500,
                       kernel_probes=("*",)), "paged_kernel")
        if not _jax_only(p)]
    assert got == want

    base = "layers/scan#0/layer/attn/"
    sub = [(p[len(base):], c // cfg.num_layers) for p, c in got
           if p.startswith(base + "kernel")]
    q = np.zeros((2, cfg.num_kv_heads, cfg.q_per_kv, cfg.resolved_head_dim),
                 np.float32)
    alone = _jax_paths_calls(
        _j_paged(), (jnp.asarray(q), jnp.asarray(pool[0]),
                     jnp.asarray(pool[0]), jb["pages"], jb["pos"]),
        JKCFG, "paged_kernel")
    assert sub == [(p[len("attn/"):], c) for p, c in alone
                   if p.startswith("attn/kernel")]
    assert any(p.endswith("/grid/copy_pages") for p, _ in sub)


# ------------------------------------------------------- exactness

@pytest.mark.parametrize("offload", [0.0, 1.0])
@pytest.mark.parametrize("name", ["flash", "flash_chunk", "ssd", "paged"])
def test_record_equals_oracle_and_outputs_unchanged(name, offload):
    fn, make = _program(name)
    pf = probe(fn, KCFG.replace(offload=offload), device="cpu")
    out, rec = pf(*make())
    want = fn(*make())
    assert all(torch.equal(a, b) for a, b in zip(
        out if isinstance(out, tuple) else (out,),
        want if isinstance(want, tuple) else (want,)))
    _assert_exact(pf, rec, pf.oracle(*make()))
    _assert_grid_invariants(pf, rec)
    assert pf.last_run["folds"] == 1
    if offload:
        assert pf.sink.dumps > 0


@pytest.mark.parametrize("name", ["flash", "ssd", "paged"])
def test_kernel_oracle_grid_totals_equal_the_record(name):
    fn, make = _program(name)
    pf = probe(fn, KCFG, device="cpu")
    _, rec = pf(*make())
    orc = KernelOracle(pf.assignment, KCFG.kernel_probes)
    gt = orc.grid_totals(orc.run(fn, *make()), pf.probe_paths())
    totals = decode_record(rec)["totals"]
    assert gt and all(
        cyc == int(totals[list(pf.probe_paths()).index(p)])
        for p, cyc in gt.items())


@pytest.mark.parametrize("block_q,block_k",
                         [(64, 32), (128, 64), (64, 128), (128, 128)])
def test_flash_tiles_grid_matches_jax_and_record_equals_oracle(block_q,
                                                               block_k):
    """The DSE's flash tiles: the port's grid at (block_q, block_k) has
    the Pallas kernel's paths and calls at the same blocks, and the
    record equals the oracle's replay of the plan at those tiles."""
    args = _flash_np()

    def fn(q, k, v):
        with scope.named_scope("attn"):
            return fa.flash_attention(q, k, v, block_q=block_q,
                                      block_k=block_k)

    def jfn(q, k, v):
        with jax.named_scope("attn"):
            return jfa.flash_attention(q, k, v, causal=True, block_q=block_q,
                                       block_k=block_k, pipeline=1,
                                       interpret=True)
    make = lambda: tuple(torch.from_numpy(a) for a in args)  # noqa: E731
    pf = probe(fn, KCFG, device="cpu")
    out, rec = pf(*make())
    assert torch.equal(out, fn(*make()))
    assert _paths_calls(pf, rec) == _jax_paths_calls(
        jfn, tuple(jnp.asarray(a) for a in args), JKCFG, "flash_kernel")
    assert pf.hierarchy.node("attn/kernel/flash_kernel#0/grid").grid == \
        (1, 2, 128 // block_q, 128 // block_k)
    _assert_exact(pf, rec, pf.oracle(*make()))
    _assert_grid_invariants(pf, rec)


@pytest.mark.parametrize("tile_slots", pa.TILES)
def test_paged_tiles_record_equals_oracle(tile_slots):
    """The paged tile changes the counter block's tiles, not the TPU
    grid: paths and calls stay JAX's, the record equals the oracle's."""
    args = _paged_np()
    host = tuple(int(p) for p in args[4])

    def fn(q, pk, pv, pages, pos):
        with scope.named_scope("attn"):
            return pa.paged_attention(q, pk, pv, pages, pos, pos_host=host,
                                      tile_slots=tile_slots)
    pf = probe(fn, KCFG, device="cpu")
    out, rec = pf(*_paged_torch_args(*args))
    assert torch.equal(out, fn(*_paged_torch_args(*args)))
    jargs = tuple(jnp.asarray(a) for a in args[:1]) + (
        jnp.asarray(args[1], jnp.bfloat16), jnp.asarray(args[2], jnp.bfloat16),
        jnp.asarray(args[3]), jnp.asarray(args[4]))
    assert _paths_calls(pf, rec) == _jax_paths_calls(
        _j_paged(), jargs, JKCFG, "paged_kernel")
    _assert_exact(pf, rec, pf.oracle(*_paged_torch_args(*args)))
    q, pk, _, pages, pos = _paged_torch_args(*args)
    plan = pa.paged_plan(q, pk, pages, pos, pos_host=host,
                         tile_slots=tile_slots)
    assert plan.geom[2] == tile_slots
    assert plan.counter_shape[2] == -(-pages.shape[1] * pk.shape[1]
                                      // tile_slots)


def test_causal_skew_shows_in_the_grid_steps():
    """Computed and skipped kv blocks cost two values of ``kv_block``;
    the computed ones are the kernel's computed counts; the grid's steps
    differ, sum to its total, and offload keeps every one."""
    fn, make = _program("flash")
    pf = probe(fn, KCFG.replace(offload=1.0, buffer_depth=4), device="cpu")
    _, rec = pf(*make())
    rep = pf.report(rec)
    grid = next(r for r in rep.rows if r.path.endswith("/grid"))
    durs = [e - s for s, e in grid.iters]
    assert len(durs) == grid.calls == 8
    assert max(durs) > min(durs)
    assert sum(durs) == grid.total_cycles
    kv = [e - s for s, e in rep.row(
        "attn/kernel/flash_kernel#0/grid/kv_block").iters]
    assert len(set(kv)) == 2
    _, counts = fa.flash_attention(*make(), with_probe=True)
    assert kv.count(max(kv)) == int(counts[..., 1].sum())
    table = kernel_grid_table(pf.hierarchy, rep)
    heat = kernel_grid_heat(pf.hierarchy, rep)
    assert "skew" in table and "flash_kernel#0/grid" in table
    assert "heat" in heat and "skew=" in heat


def test_noncausal_kv_block_steps_are_balanced():
    args = tuple(torch.from_numpy(a) for a in _flash_np())
    pf = probe(_t_flash(causal=False),
               KCFG.replace(offload=1.0, buffer_depth=4), device="cpu")
    _, rec = pf(*args)
    row = pf.report(rec).row("attn/kernel/flash_kernel#0/grid/kv_block")
    assert len({e - s for s, e in row.iters}) == 1


def test_a_foreign_counter_block_is_caught():
    """The fold given the counts of a non-causal launch: the record
    leaves the oracle's, which replays the causal plan."""
    args = tuple(torch.from_numpy(a) for a in _flash_np())

    def fn(q, k, v):
        with scope.named_scope("attn"):
            with scope.kernel_region(
                    "flash_attention", lambda: fa.flash_cost(q, k, v),
                    lambda: fa.flash_plan(q, k, v)) as region:
                out = fa.flash_attention(q, k, v)
                _, wrong = fa.flash_attention(q, k, v, causal=False,
                                              with_probe=True)
                region.fold(wrong)
            return out
    pf = probe(fn, KCFG, device="cpu")
    _, rec = pf(*args)
    oc = pf.oracle(*args)
    assert decode_record(rec)["cycle"] != oc.cycle


def test_a_region_that_folds_nothing_raises():
    def fn(q, k, v):
        with scope.named_scope("attn"):
            with scope.kernel_region(
                    "flash_attention", lambda: fa.flash_cost(q, k, v),
                    lambda: fa.flash_plan(q, k, v)):
                return fa.flash_attention(q, k, v)
    pf = probe(fn, KCFG, device="cpu")
    with pytest.raises(RuntimeError, match="handed none"):
        pf(*(torch.from_numpy(a) for a in _flash_np()))


def test_a_counter_block_of_another_shape_raises():
    plan = fa.flash_plan(*(torch.from_numpy(a) for a in _flash_np()))
    state = init_state(1, 4, device="cpu")
    with pytest.raises(ValueError, match="counter block"):
        kpe.probe_grid(state, plan, torch.zeros((1, 2, 3, 2),
                                                dtype=torch.int32),
                       [0, -1, -1, -1], [False] * 4)


# ---------------------------------------------- off, retarget, filters

def test_kernel_probes_off_gives_the_tree_without_kernel_nodes():
    fn, make = _program("flash")
    pf = probe(fn, ProbeConfig(inline="off_all"), device="cpu")
    _, rec = pf(*make())
    assert pf.probe_paths() == ("attn",)
    assert pf.last_run["folds"] == 0
    assert [op for op, _ in pf.hierarchy.ops["attn"]] == ["flash_attention"]
    _assert_exact(pf, rec, pf.oracle(*make()))


def test_retarget_flips_kernel_probes_without_a_new_capture():
    fn, make = _program("flash")
    pf = probe(fn, ProbeConfig(inline="off_all"), device="cpu")
    _, off = pf(*make())
    pf.retarget(KCFG)
    _, rec = pf(*make())
    assert pf.captures == 1
    assert any("/kernel/" in p for p in pf.probe_paths())
    _assert_grid_invariants(pf, rec)
    pf.retarget(ProbeConfig(inline="off_all"))
    _, again = pf(*make())
    assert pf.captures == 1 and pf.probe_paths() == ("attn",)
    assert decode_record(again)["cycle"] == decode_record(off)["cycle"]


def test_wallclock_is_rejected_and_the_name_filter_works():
    fn, make = _program("flash")
    pf = probe(fn, ProbeConfig(kernel_probes=("*",),
                               cycle_source="wallclock"), device="cpu")
    with pytest.raises(ValueError, match="model"):
        pf(*make())
    pf = probe(fn, ProbeConfig(inline="off_all",
                               kernel_probes=("ssd_kernel",)), device="cpu")
    pf(*make())
    assert not any("/kernel/" in p for p in pf.probe_paths())
    pf = probe(fn, ProbeConfig(inline="off_all",
                               kernel_probes=("flash_kernel",)), device="cpu")
    pf(*make())
    assert "attn/kernel/flash_kernel#0/grid" in pf.probe_paths()


@pytest.mark.parametrize("name", ["flash", "paged"])
def test_session_accumulates_grid_calls_from_its_mirrors(name):
    """Three steps of a ``ProbeSession``: grid calls are 3 x the steps,
    and the host's mirrors of the calls and the clock (kept from the
    plan, with the paged positions given as host ints) equal the
    device's at the snapshot, which checks them."""
    fn, make = _program(name)
    with ProbeSession(fn, KCFG.replace(offload=1.0), device="cpu") as s:
        for _ in range(3):
            s.step(*make())
        snap = s.snapshot()
    grid = [r for r in snap.rows if r.path.endswith("/grid")]
    steps = int(np.prod(s.pf.hierarchy.node(grid[0].path).grid))
    assert grid[0].calls == 3 * steps and grid[0].total_cycles > 0


def test_paged_plan_mirror_equals_its_inputs():
    q, pk, pv, pages, pos = _paged_torch_args(*_paged_np())
    plan = pa.paged_plan(q, pk, pages, pos, 1, pos_host=(20, 50))
    assert np.array_equal(plan.mirror(), plan.expected())
    _, counts = pa.paged_attention_plain(q, pk, pv, pages, pos,
                                         with_counts=True)
    assert np.array_equal(counts.numpy(), plan.expected())
    for host in (None, (20,)):
        with pytest.raises(ValueError, match="pos_host"):
            pa.paged_plan(q, pk, pages, pos, 1, pos_host=host).mirror()


def test_a_probed_paged_call_needs_its_host_positions():
    """The run prices the paged grid from host ints only: without
    ``pos_host`` a probed call raises instead of reading ``pos`` from
    the device; with kernel probes off it runs as before."""
    args = _paged_torch_args(*_paged_np())
    with pytest.raises(ValueError, match="pos_host"):
        probe(_t_paged(), KCFG, device="cpu")(*args)
    off = probe(_t_paged(), ProbeConfig(inline="off_all"), device="cpu")
    out, _ = off(*args)
    assert torch.equal(out, _t_paged()(*args))


@pytest.mark.parametrize("order", [(65, 128), (128, 65)])
def test_the_clock_mirror_follows_the_exact_flash_shape(order):
    """Sq 65 and 128 at q offset 32 over 192 keys share the grid
    (1, 2, 2, 3) but not the last tile's computed count: in one process,
    in either order, each run's host clock equals its record and its
    oracle."""
    rng = np.random.default_rng(6)
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, 192, 32)).astype(
        np.float32)) for _ in range(2))
    cycles = []
    for sq in order:
        q = torch.from_numpy(rng.standard_normal((1, 2, sq, 32)).astype(
            np.float32))
        pf = probe(_t_flash(q_offset=32), KCFG, device="cpu")
        _, rec = pf(q, k, v)
        assert pf.hierarchy.node("attn/kernel/flash_kernel#0/grid").grid \
            == (1, 2, 2, 3)
        dec = decode_record(rec)
        assert pf.last_run["cycles"] == dec["cycle"] == pf.oracle(
            q, k, v).cycle
        cycles.append(dec["cycle"])
    assert cycles[0] != cycles[1]


@pytest.mark.parametrize("grid", [(2, 3, 4), (1, 2, 2, 2), (5,)])
def test_unravel_matches_jax(grid):
    """Steps run in the reference's sequential order, last axis fastest."""
    steps = int(np.prod(grid))
    assert [kp.unravel(i, grid) for i in range(steps)] == \
        [[int(x) for x in jax_unravel(i, grid)] for i in range(steps)]
    assert kp.unravel(steps - 1, grid) == [g - 1 for g in grid]


# ----------------------------------------------- the fold, by transitions

def _transitions(state, plan, counters, ids, spill):
    """The fold's events one transition at a time through the plain
    ``probe_events``; returns each spilling id's full rows, in order."""
    cyc = plan.step_cycles(counters).tolist()
    depth = state["ring"].shape[1]
    rows = {k: [] for k in range(len(ids))}

    def ev(k, enter, seg):
        if ids[k] < 0:
            kpe.probe_events_plain(state, [], seg)
            return
        kpe.probe_events_plain(state, [kpe.encode(ids[k], enter, spill[k])],
                               seg)
        if not enter and spill[k] and int(state["calls"][ids[k]]) % depth == 0:
            rows[k].append(state["ring"][ids[k]].clone())
    for step in cyc:
        ev(0, True, 0)
        seg = plan.transfer
        for j, c in enumerate(step):
            ev(j + 1, True, seg)
            ev(j + 1, False, c)
            seg = 0
        ev(0, False, 0)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_probe_grid_plain_equals_transitions(seed):
    """Random plans (every rule), counter blocks, probe ids, spill flags
    and prior calls (so a spilling probe's first window starts part
    full): the fold equals the transitions, state and spilled rows."""
    rng = np.random.default_rng(seed)
    last = int(rng.integers(2, 6))
    rows_n = int(rng.integers(1, 4))
    grid = (rows_n, last)
    kv, nt, tile, sps = 2, 3, 4, int(rng.integers(1, 4))
    rules = [kp.FIRST, kp.LAST, kp.BELOW, kp.AT_END, kp.CONST]
    rng.shuffle(rules)
    scopes = [kp.GridScope(f"s{j}", r, tuple(int(x) for x in
                                             rng.integers(0, 50, 2)))
              for j, r in enumerate(rules[:int(rng.integers(1, 4))])]
    scopes.append(kp.GridScope("cnt", kp.COUNT,
                               tuple(int(x) for x in rng.integers(0, 50, 4))))
    scopes.append(kp.GridScope("slots", kp.SLOTS, tuple(
        int(x) for x in rng.integers(0, 50, kv * 6 + 1))))
    shape = (rows_n * 12,)                # enough for every rule
    counters = rng.integers(-1, last + 2, shape).astype(np.int32)
    plan = kp.GridPlan(body="k", grid=grid, transfer=int(rng.integers(0, 9)),
                       scopes=tuple(scopes), counter_shape=shape,
                       expected=lambda: counters, mirror=lambda: counters,
                       geom=(kv, nt, tile, sps))
    n, depth = len(scopes) + 3, int(rng.integers(1, 5))
    ids = [int(i) for i in rng.permutation(n)[:len(scopes) + 1]]
    ids[int(rng.integers(len(ids)))] = -1
    spill = [bool(x) for x in rng.integers(0, 2, len(ids))]
    base = init_state(n, depth, device="cpu")
    base["calls"].copy_(torch.from_numpy(rng.integers(0, 7, n)))
    base["cycle"].fill_(int(rng.integers(0, 1000)))
    base["ring"].copy_(torch.from_numpy(rng.integers(0, 99, (n, depth, 2))))
    seq = {k: v.clone() for k, v in base.items()}
    fold = {k: v.clone() for k, v in base.items()}

    want = _transitions(seq, plan, counters, ids, spill)
    rows, offs = kpe.grid_dump_rows(base["calls"].tolist(), ids, spill,
                                    plan.steps, depth)
    dump = torch.zeros((max(len(rows), 1), depth, 2), dtype=torch.int64)
    kpe.probe_grid(fold, plan, torch.from_numpy(counters), ids, spill, dump,
                   offs)
    for k in seq:
        assert torch.equal(seq[k], fold[k]), k
    got = {k: [] for k in range(len(ids))}
    for i, (pid, b) in enumerate(rows):
        got[ids.index(pid)].append(dump[i])
    for k in want:
        assert len(got[k]) == len(want[k])
        assert all(torch.equal(a, b) for a, b in zip(got[k], want[k]))


# --------------------------------------------------------- report text

def _port_node(jn) -> ScopeNode:
    node = ScopeNode(name=jn.name, path=jn.path, kind=jn.kind,
                     trip_count=jn.trip_count, grid=getattr(jn, "grid", None),
                     static_cycles=jn.static_cycles)
    node.children = {k: _port_node(c) for k, c in jn.children.items()}
    return node


@pytest.mark.parametrize("case", ["flash_grid", "ssd_grid"])
def test_grid_views_render_jax_text_on_the_golden_record(case):
    """The golden case's hierarchy (JAX's, run live) and its record (the
    golden's decoded record with its offloaded steps) rendered by both
    packages' ``kernel_grid_table`` and ``kernel_grid_heat``."""
    gold = _golden(case)
    if case == "flash_grid":
        jfn, jargs = _j_flash(pipeline=2), tuple(
            jax.random.normal(k, (1, 2, 128, 32)) for k in
            jax.random.split(jax.random.PRNGKey(0), 3))
    else:
        jfn, jargs = _j_ssd(), tuple(jnp.asarray(a) for a in _ssd_np())
    pf = jax_probe(jfn, JKCFG.replace(offload=1.0, buffer_depth=4))
    pf(*jargs)
    jh = pf.hierarchy

    def live(path):           # the golden's path as the live tree names it
        if jh.node(path) is not None:
            return path
        return "/".join("kernel#" + s.split("#")[1] if s.endswith("#0")
                        and s.split("#")[0].endswith("_kernel") else s
                        for s in path.split("/"))
    rec = gold["record"]
    rows = [dict(path=live(p), calls=rec["calls"][i],
                 total_cycles=rec["totals"][i], start=rec["starts"][i],
                 end=rec["ends"][i],
                 iters=[tuple(x) for x in gold["offloaded"][str(i)]])
            for i, p in enumerate(gold["paths"])]
    assert all(jh.node(r["path"]) is not None for r in rows)
    from repro.core.report import ProbeRow as JaxRow
    from repro.core.report import Report as JaxReport
    jrep = JaxReport(rows=[JaxRow(**r) for r in rows], span=rec["cycle"],
                     cycle_source="model")
    trep = Report(rows=[ProbeRow(**r) for r in rows], span=rec["cycle"],
                  cycle_source="model")
    th = Hierarchy(root=_port_node(jh.root), sites=None, segments={}, ops={})
    assert kernel_grid_table(th, trep) == jax_grid_table(jh, jrep)
    assert kernel_grid_heat(th, trep) == jax_grid_heat(jh, jrep)
    assert "skew" in kernel_grid_table(th, trep)
