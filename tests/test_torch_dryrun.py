"""The dry run's port (``repro_torch.launch.{dryrun,hlo_cost}``, the
model's dry specs, the meta routes) held against the JAX package and
against itself on real tensors, on the CPU at smoke sizes.

- ``param_count``, ``abstract_params``, ``logical_axes``,
  ``input_specs`` (every ``SHAPES`` cell) and ``cache_specs`` of all 10
  archs equal JAX's: shapes, dtypes and logical axes, exactly;
- ``hlo_cost.analyze`` of each family's smoke train step, prefill and
  decode step (dense, MoE, ssm, hybrid, an audio frontend) on ``meta``
  equals it on CPU tensors exactly (FLOPs, bytes, collectives): a kernel
  region counts its stated cost on either route; the products' FLOPs
  equal ``FlopCounterMode``'s on the meta run;
- a ``scope.scan`` of 8 against 1 gives a FLOP ratio in (6, 10) (JAX's
  ``tests/test_system.py`` trip-count test), and the dry run's
  ``fold_scans`` counts a 128 MiB leaf's row scan as the full walk;
- the smoke tinyllama prefill's counted FLOPs beside JAX's
  ``hlo_cost.analyze`` of its compiled step: the port's are 0.890 of
  JAX's (measured). JAX counts the XLA flash path's whole score block
  (32 x 32 pairs, the causal mask applied after the products) and its
  softmax chain at 1 FLOP an element (8 a transcendental), where the
  port's flash region states 4 B H D FLOPs per visible pair (528 of
  1024); the products outside attention are the same. Limit: 0.85-0.95;
- the kernel wrappers on ``meta`` give the kernels' outputs (shapes,
  dtypes) and launch nothing; the MoE's ``bincount`` replacement and
  ``grouped_matmul`` are bitwise the old results on the CPU, and on
  meta the grouped product counts the walk's FLOPs;
- the memory record counts a storage once however many views it has;
- ``run`` writes JAX's skip record, an error record, and reads its cache
  on a second call without tracing.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke
from repro.distributed.steps import build_prefill_step as jbuild_prefill
from repro.launch.hlo_cost import analyze as janalyze
from repro.models.model import Model as JModel

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import CONFIGS, get_config, smoke_config
from repro_torch.core import scope
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import analyze
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.optim import adamw

ARCHS = list(CONFIGS)
FAMILIES = ("tinyllama-1.1b", "granite-moe-1b-a400m", "mamba2-370m",
            "zamba2-2.7b", "musicgen-large")
KINDS = {"train": (32, 4), "prefill": (32, 4), "decode": (40, 4)}


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_specs_match_jax(arch):
    """param_count, abstract params, logical axes, input specs of the
    four shape cells and the decode caches: JAX's, exactly."""
    tm, jm = Model(get_config(arch)), JModel(jget_config(arch))
    assert tm.param_count() == jm.param_count()
    tp = _flat(tm.abstract_params())
    jp = _flat(jm.abstract_params())
    assert {k: (tuple(t.shape), _dt(t.dtype)) for k, t in tp.items()} == \
        {k: (tuple(s.shape), str(s.dtype)) for k, s in jp.items()}
    assert all(t.device.type == "meta" for t in tp.values())
    assert _flat(tm.logical_axes()) == _flat(jm.logical_axes())
    for name, shape in SHAPES.items():
        got = tm.input_specs(shape)
        want = jm.input_specs(JSHAPES[name])
        assert {k: (tuple(t.shape), _dt(t.dtype)) for k, t in got.items()} \
            == {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}, \
            name
        # the legacy view is the same definition
        assert tm.input_shapes(shape.kind, shape.global_batch,
                               shape.seq_len) == \
            {k: (tuple(t.shape), t.dtype) for k, t in got.items()}
        if shape.kind != "decode":
            continue
        tc, ta = tm.cache_specs(shape)
        jc, ja = jm.cache_specs(JSHAPES[name])
        assert {k: (tuple(t.shape), _dt(t.dtype)) for k, t in tc.items()} \
            == {k: (tuple(s.shape), str(s.dtype)) for k, s in jc.items()}
        assert ta == ja


def test_init_cache_is_zeros_of_cache_specs():
    m = Model(smoke_config("zamba2-2.7b"))
    shape = ShapeConfig("d", 16, 2, "decode")
    cache = m.init_cache(shape, "cpu")
    specs, _ = m.cache_specs(shape)
    assert set(cache) == set(specs) == {"conv", "ssd", "k", "v"}
    for k, t in cache.items():
        assert t.shape == specs[k].shape and t.dtype == specs[k].dtype
        assert t.device.type == "cpu" and not t.any()


def _count(arch, kind, device):
    S, B = KINDS[kind]
    model = Model(smoke_config(arch))
    return dryrun.analyze_cell(model, ShapeConfig(kind, S, B, kind),
                               device=device)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_count_equals_cpu_count(arch, kind):
    """The same step on meta (kernels: empty outputs) and on CPU tensors
    (kernels: their plain versions) counts the same integers; the
    products' FLOPs are FlopCounterMode's."""
    meta, cpu = _count(arch, kind, "meta"), _count(arch, kind, "cpu")
    for key in ("flops", "bytes", "matmul_flops", "collectives",
                "collective_wire_bytes"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > meta["matmul_flops"] > 0
    assert not meta["collectives"]
    S, B = KINDS[kind]
    model = Model(smoke_config(arch))
    step, args = dryrun.build_cell(model, ShapeConfig(kind, S, B, kind))
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert meta["matmul_flops"] == fc.get_total_flops() == meta["raw_flops"]


def test_scan_trip_count_multiplies():
    """JAX's trip-count test: a scan of 8 over a scan of 1."""
    def f(x, w, n):
        c = x
        for _ in scope.scan(n):
            c = torch.tanh(c @ w)
        return c.sum()

    x, w = torch.ones(64, 64), torch.ones(64, 64)
    c8 = analyze(f, x, w, 8)["flops"]
    c1 = analyze(f, x, w, 1)["flops"]
    assert 6.0 < c8 / c1 < 10.0, c8 / c1


def test_fold_scans_counts_a_row_scan_as_the_full_walk():
    """AdamW scans a leaf over 128 MiB by rows; ``fold_scans`` runs one
    row, then a second counted for every other: the walk's integers and
    its peak."""
    rows, cols = 64, 524_289                     # f32, just over 128 MiB
    assert rows * cols * 4 > adamw.SCAN_THRESHOLD_BYTES
    p = {"w": torch.empty(rows, cols, device="meta")}
    g = {"w": torch.empty(rows, cols, device="meta")}
    state = adamw.init(p)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim.schedule import make_schedule
    tcfg = TrainConfig()
    sched = make_schedule("cosine", tcfg)

    def step(p, g, s):
        return adamw.update(p, g, s, tcfg, sched)

    walk = analyze(step, p, g, state)
    once = analyze(step, p, g, state, fold_scans=True)
    for key in ("flops", "bytes", "matmul_flops", "raw_flops"):
        assert walk[key] == once[key], key
    assert walk["memory"]["peak_estimate_bytes"] == \
        once["memory"]["peak_estimate_bytes"]


def test_prefill_flops_beside_jax_hlo_cost():
    """The smoke tinyllama prefill (8 x 32): counted FLOPs against JAX's
    compiled step's (see the module docstring for the measured ratio)."""
    S, B = 32, 8
    jm = JModel(jsmoke("tinyllama-1.1b"))
    jshape = JShape("p", S, B, "prefill")
    compiled = jax.jit(jbuild_prefill(jm, jshape)).lower(
        jm.abstract_params(), jm.input_specs(jshape)).compile()
    want = janalyze(compiled.as_text())
    got = dryrun.analyze_cell(Model(smoke_config("tinyllama-1.1b")),
                              ShapeConfig("p", S, B, "prefill"))
    ratio = got["flops"] / want["flops"]
    assert 0.85 < ratio < 0.95, ratio
    assert not got["collectives"] and not want["collectives"]


def test_kernel_wrappers_on_meta_give_outputs_and_launch_nothing():
    before = (fa.flash_attention.launches, pa.paged_attention.launches,
              ssd.ssd_scan.launches)
    # flash: the output, the probe counts and the statistics
    B, H, Hkv, S, D = 2, 4, 2, 64, 16
    mk = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                   device="meta")
    q, k, v = mk(B, H, S, D), mk(B, Hkv, S, D), mk(B, Hkv, S, D)
    out, probe, m, l = fa.flash_attention(q, k, v, with_probe=True,
                                          with_stats=True)
    cq, ck, cv = (torch.randn(t.shape).to(torch.bfloat16) for t in (q, k, v))
    ref = fa.flash_attention(cq, ck, cv, with_probe=True, with_stats=True)
    for got, want in zip((out, probe, m, l), ref):
        assert got.device.type == "meta"
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.is_contiguous() == want.is_contiguous()
    cost = analyze(fa.flash_attention, q, k, v)
    assert (cost["flops"], cost["bytes"]) == tuple(
        int(c) for c in fa.flash_cost(q, k, v))
    # paged: the output
    Bp, KV, G, HD, PS, NP, POOL = 3, 2, 2, 8, 4, 4, 16
    args = (mk(Bp, KV, G, HD, dt=torch.float32),
            mk(POOL, PS, KV, HD), mk(POOL, PS, KV, HD),
            mk(Bp, NP, dt=torch.int32), mk(Bp, dt=torch.int32))
    got = pa.paged_attention(*args)
    assert got.shape == (Bp, KV, G, HD) and got.dtype == torch.float32
    # SSD: y and the final state
    Bs, L, Hs, P, Gs, N = 2, 32, 4, 8, 2, 16
    y, st = ssd.ssd_scan(mk(Bs, L, Hs, P), mk(Bs, L, Hs, dt=torch.float32),
                         mk(Bs, L, Gs, N), mk(Bs, L, Gs, N), chunk=16,
                         h_per_g=2, return_final_state=True)
    assert y.shape == (Bs, L, Hs, P) and y.dtype == torch.bfloat16
    assert st.shape == (Bs, Hs, P, N) and st.dtype == torch.float32
    assert (fa.flash_attention.launches, pa.paged_attention.launches,
            ssd.ssd_scan.launches) == before


def test_moe_counts_and_grouped_matmul_bitwise_and_on_meta():
    """The bincount replacement and the grouped product: bitwise the old
    results (the loop below is the old ``grouped_matmul``); on meta the
    product counts 2 rows d f FLOPs forward and twice that backward."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 8, 1000))
    assert torch.equal(moe._counts(idx, 8), torch.bincount(idx, minlength=8))
    E, d, f = 4, 16, 24
    sizes = torch.tensor([5, 0, 9, 2])
    rows = int(sizes.sum())
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, d, f)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((rows, f)).astype(np.float32))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = moe.grouped_matmul(xg, wg, sizes)
    out.backward(dy)
    want = torch.empty(rows, f)
    dx, dw = torch.empty_like(x), torch.zeros(E, d, f)
    r = 0
    for e, n in enumerate(sizes.tolist()):
        want[r:r + n] = x[r:r + n] @ w[e]
        dx[r:r + n] = dy[r:r + n] @ w[e].transpose(0, 1)
        dw[e] = x[r:r + n].transpose(0, 1) @ dy[r:r + n]
        r += n
    assert torch.equal(out, want) and torch.equal(xg.grad, dx)
    assert torch.equal(wg.grad, dw)

    def fwd_bwd(x, w, sizes, dy):
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_()
        y = moe.grouped_matmul(x, w, sizes)
        torch.autograd.grad(y, (x, w), dy)
        return y

    xm, wm, dym = (t.to("meta") for t in (x, w, dy))
    res = analyze(fwd_bwd, xm, wm, sizes.to("meta"), dym)
    assert res["result"].shape == (rows, f)
    assert res["matmul_flops"] == 3 * 2 * rows * d * f


def test_memory_counts_a_storage_once():
    def fn(x):
        t = x * 2                       # a temp of x's size
        v1, v2 = t.view(-1), t[1:]      # views: no new bytes
        return (v1.sum() + v2.sum()).reshape(1)

    x = torch.empty(1024, 256)          # 1 MiB
    mem = analyze(fn, x)["memory"]
    assert mem["argument_bytes"] == 2**20
    assert mem["output_bytes"] == 4
    assert 2 * 2**20 <= mem["peak_estimate_bytes"] < 2 * 2**20 + 64
    assert mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])


def test_run_caches_skips_and_records_errors(tmp_path, monkeypatch):
    """A second ``run()`` reads every record and traces nothing; a
    full-attention arch at long_500k gets JAX's skip record; a failing
    cell is an error record."""
    out = dryrun.run(arch="tinyllama-1.1b", meshes=("1",),
                     results_dir=tmp_path, shape="decode_32k")
    assert out[0]["flops_per_device"] > 0 and "error" not in out[0]
    skip = dryrun.run(arch="tinyllama-1.1b", shape="long_500k",
                      meshes=("1",), results_dir=tmp_path)
    assert skip[0]["skipped"] == ("full-attention arch at 500k ctx "
                                  "(sub-quadratic required; DESIGN.md)")

    def boom(*a, **k):
        raise AssertionError("traced a cached cell")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    again = dryrun.run(arch="tinyllama-1.1b", meshes=("1",),
                       results_dir=tmp_path, shape="decode_32k")
    assert again == out
    monkeypatch.setattr(dryrun, "lower_cell",
                        lambda *a, **k: (_ for _ in ()).throw(
                            ValueError("planted")))
    err = dryrun.run(arch="tinyllama-1.1b", meshes=("1",),
                     results_dir=tmp_path, shape="prefill_32k")
    assert err[0]["error"] == "ValueError: planted"
    rec = json.loads((tmp_path / "tinyllama-1.1b__prefill_32k__1.json")
                     .read_text())
    assert rec["error"] == "ValueError: planted"
    assert math.isclose(out[0]["param_count"],
                        Model(get_config("tinyllama-1.1b")).param_count())
