"""The port's conformance harness (``repro_torch.testing``) against the
JAX package's (``repro.testing``), on the CPU.

- The spec draw: ``random_spec(s).to_json()`` is JAX's string for seeds
  0-199; the corpus covers the generator's vocabulary; ``build`` is
  deterministic per spec.
- The port's ``run_conformance(spec, device="cpu")`` passes its five
  invariants for the fast corpus, seeds 0-7 (JAX's sixth,
  ``packed_vs_legacy``, has no counterpart: one state layout).
- Seeds 2, 6 and 7 (remat, cond and offload; an SSD kernel; a flash
  kernel): JAX's ``probe(fn, spec.probe_config())`` on JAX's graph
  against the port's graph on JAX's params and input, carried across.
  The output scalar agrees within ``OUT_RTOL``; probe paths and calls
  are equal apart from these differences, each with its reason:

  - JAX's einsum scopes (``b0_mlp/...d,df->...f``) and the ``qblk``
    scopes of its XLA flash forward have no counterpart (the port has no
    einsum scopes; its attn block is that forward without them, see
    ``graphgen``); since they count toward the probe budget, JAX's list
    without them is a prefix of the port's list.
  - JAX's ``kernel#i`` nodes are named by the kernel's body in the port
    (jax 0.9.0 names every body ``kernel``; ROADMAP Queue 3).
  - The flash grid's trip counts follow the port's 64-row tiles (one q
    tile and one kv block at S 16 or 32), not JAX's ``S // 2`` blocks.
    The SSD grid's chunk is ``S // 2`` in both.

  The output tolerance: the flash kernel block is padded to head dim 64
  and computed in bf16 (q, k, v, p rounded) where JAX's Pallas
  interpret run is f32; the other blocks differ by f32 summation order.
- The sweep's seeds that found port faults (``FOUND_SEEDS``) pass.
- The shared-body attribution case of ``tests/test_conformance_sweep.py``
  re-made eagerly: one module-level loop body under two scopes.
- One planted fault per invariant raises ``ConformanceError`` naming it.
- The CLIs (``conformance --seed 7``, ``sweep --count 8``) exit 0 on
  ``--device cpu``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import probe as jax_probe
from repro.core.instrument import decode_record as jax_decode_record
from repro.testing import build as jax_build
from repro.testing import random_spec as jax_random_spec
from repro_torch.core import ProbeConfig, decode_record, probe, scope
from repro_torch.testing import (INVARIANTS, ConformanceError, GraphSpec,
                                 build, random_spec, repro_command,
                                 run_conformance)
from repro_torch.testing import conformance
from repro_torch.testing.graphgen import args_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_SEEDS = tuple(range(8))
CORPUS = tuple(range(40))
# output scalar sum(x * x) vs JAX, relative: the flash kernel block in
# bf16 (padded) against JAX's f32 Pallas run (measured 2.3e-5, seed 7);
# the rest f32 order (measured <= 9e-7, seeds 2 and 6)
OUT_RTOL = 2e-4


def test_spec_json_equals_jax_and_roundtrips():
    for seed in range(200):
        spec = random_spec(seed)
        assert spec.to_json() == jax_random_spec(seed).to_json(), seed
        assert GraphSpec.from_json(spec.to_json()) == spec
        assert random_spec(seed) == spec         # draw is deterministic
        assert spec.blocks                       # never an empty graph


def test_corpus_covers_the_structure_space():
    """The frozen corpus exercises the generator's whole vocabulary:
    every block kind and every wrapper, kernel and non-kernel graphs."""
    kinds, wrappers, kernels = set(), set(), set()
    for seed in CORPUS:
        spec = random_spec(seed)
        for b in spec.blocks:
            kinds.add(b.kind)
            wrappers.add(b.wrapper)
        kernels.add(spec.has_kernel)
    assert kinds >= {"mlp", "attn", "ssm", "moe", "elementwise",
                     "flash_kernel", "ssd_kernel"}
    assert wrappers >= {"none", "scan", "remat", "cond", "jit", "while",
                        "scan_cond"}
    assert kernels == {True, False}


def test_build_is_deterministic_per_spec():
    spec = random_spec(7)
    fn1, (x1, p1) = build(spec, device="cpu")
    fn2, (x2, p2) = build(spec, device="cpu")
    assert torch.equal(x1, x2)
    for a, b in zip(p1, p2):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(fn1(x1, p1), fn2(x2, p2))


@pytest.mark.parametrize("seed", FAST_SEEDS)
def test_corpus_graph_conformance(seed):
    stats = run_conformance(random_spec(seed), device="cpu")
    assert stats["invariants"] == INVARIANTS     # zero skipped invariants
    assert len(INVARIANTS) == 5 and "packed_vs_legacy" not in INVARIANTS
    assert stats["n_probes"] > 0


# seeds of the 200-graph sweep that found faults in the port, each
# passing since its fix: 8, the overhead model's missing spill term
# (depth 2 doubles the spill copies, which no static feature sees);
# 42, a kernel-probed fold's spilled grid rows shipped after the unfilled
# tail of the per-probe block (durations read from garbage rows); 105,
# both at once
FOUND_SEEDS = (8, 42, 105)


@pytest.mark.parametrize("seed", FOUND_SEEDS)
def test_sweep_found_seeds(seed):
    stats = run_conformance(random_spec(seed), device="cpu")
    assert stats["invariants"] == INVARIANTS


# ------------------------------------------------- against JAX's probe

def _jax_only(path: str) -> bool:
    segs = path.split("/")
    return any("->" in s for s in segs) or "qblk" in segs


def _body_named(path: str, body: str) -> str:
    return "/".join(f"{body}#{s.split('#')[1]}" if s.startswith("kernel#")
                    else s for s in path.split("/"))


@pytest.mark.parametrize("seed", (2, 6, 7))
def test_graph_matches_jax_probe(seed):
    spec = random_spec(seed)
    jfn, (jx, jparams) = jax_build(jax_random_spec(seed))
    jpf = jax_probe(jfn, jax_random_spec(seed).probe_config())
    jout, jrec = jpf(jx, jparams)
    jdec = jax_decode_record(jax.device_get(jrec))
    body = {"flash_kernel": "flash_kernel", "ssd_kernel": "ssd_kernel"}
    kind = next((b.kind for b in spec.blocks if b.kind in body), None)
    want = [(_body_named(p, kind or ""), int(c))
            for p, c in zip(jpf.probe_paths(), jdec["calls"])
            if not _jax_only(p)]

    fn, _ = build(spec, device="cpu")
    args = args_from_numpy(
        np.asarray(jx), [{k: np.asarray(v) for k, v in p.items()}
                         for p in jparams], device="cpu")
    pf = probe(fn, spec.probe_config(), device="cpu")
    out, rec = pf(*args)
    np.testing.assert_allclose(float(out), float(jout), rtol=OUT_RTOL)
    assert torch.equal(out, fn(*args))
    got = list(zip(pf.probe_paths(),
                   [int(c) for c in decode_record(rec)["calls"]]))
    if len(jpf.probe_paths()) < spec.max_probes:    # JAX's whole tree
        assert len(got) == len(want)
    assert [p for p, _ in got[:len(want)]] == [p for p, _ in want]
    B, S = spec.batch, spec.seq
    for (p, c), (_, jc) in zip(got, want):
        if kind == "flash_kernel" and "/grid" in p:
            # one q tile and one kv block of 64 rows a (b, h) here; JAX's
            # S // 2 blocks make 2 x 2
            assert (c, jc) == (B * 2 * 1 * 1, B * 2 * 2 * 2), p
        else:
            assert c == jc, p


# ----------------------------------------------- shared body, eagerly

def _shared_scan_body(c):
    with scope.named_scope("inner"):
        return torch.tanh(c) + 0.01


def test_shared_body_per_site_attribution():
    """One module-level loop body run under two scopes (the graph of
    ``random_spec(5)`` put one flash body at two call sites): each site's
    probe counts its own iterations, and the record equals the oracle."""
    def fn(x):
        with scope.named_scope("first"):
            a = x
            for _ in scope.scan(2):
                a = _shared_scan_body(a)
        with scope.named_scope("second"):
            b = a
            for _ in scope.scan(3):
                b = _shared_scan_body(b)
        return torch.sum(a * b)

    x = torch.ones((4, 8)) * 0.1
    pf = probe(fn, ProbeConfig(inline="off_all"), device="cpu")
    out, rec = pf(x)
    assert torch.equal(out, fn(x))
    paths = pf.probe_paths()
    fi = paths.index("first/scan#0/inner")
    si = paths.index("second/scan#0/inner")
    dec = decode_record(rec)
    assert int(dec["calls"][fi]) == 2
    assert int(dec["calls"][si]) == 3
    oc = pf.oracle(x)
    for i, p in enumerate(paths):
        assert int(dec["totals"][i]) == oc.totals[i], p
        assert int(dec["calls"][i]) == oc.calls[i], p
    assert int(dec["cycle"]) == oc.cycle


# ---------------------------------------------------- planted faults

def _intrusive_build(spec, device=None):
    """A graph whose output moves when a probe runs."""
    fn, args = build(spec, device=device)

    def probed_differs(x, params):
        out = fn(x, params)
        return out + 1e-3 if scope._live() is not None else out
    return probed_differs, args


def _plant(monkeypatch, invariant):
    import repro_torch.core as core
    import repro_torch.core.overhead as ov
    if invariant == "bit_identity":
        monkeypatch.setattr(conformance, "build", _intrusive_build)
    elif invariant in ("telescoping", "oracle_equality"):
        real = core.decode_record

        def tampered(rec):
            dec = real(rec)
            if invariant == "telescoping":    # a total past the clock
                dec["totals"][0] = dec["cycle"] + 1
            else:                             # an interval one cycle late
                dec["starts"][0] += 1
            return dec
        monkeypatch.setattr(core, "decode_record", tampered)
    elif invariant == "session_exactness":
        class SkippingSession(core.ProbeSession):
            skipped = False

            def step(self, *args):            # drops its first step
                if not SkippingSession.skipped:
                    SkippingSession.skipped = True
                    return None
                return super().step(*args)
        monkeypatch.setattr(core, "ProbeSession", SkippingSession)
    else:
        real = ov.measure_overhead

        def skewed(fn, args, cfg, **kw):
            # the max_probes=50 variant off by 100 from the base variant,
            # which selects the same 9 probes (same features)
            smp = real(fn, args, cfg, **kw)
            if cfg.max_probes == 50:
                smp["extra_eqns"] += 100
            return smp
        monkeypatch.setattr(ov, "measure_overhead", skewed)


@pytest.mark.parametrize("invariant", INVARIANTS)
def test_planted_fault_names_its_invariant(monkeypatch, invariant):
    spec = random_spec(7)
    _plant(monkeypatch, invariant)
    with pytest.raises(ConformanceError) as ei:
        run_conformance(spec, (invariant,), device="cpu")
    assert ei.value.invariant == invariant
    assert repro_command(spec) in str(ei.value)
    assert spec.to_json() in str(ei.value)


def test_a_copy_a_spilled_row_fails_the_overhead_bound(monkeypatch):
    """A runner that copies a kernel call's spilled grid rows one by one
    (a copy a row, not one a call) misses the oracle's count of copies,
    which the oracle makes from its own run (seed 6: an SSD grid whose
    spilled rings fill several rows a call at depth 2)."""
    from repro_torch.core import instrument
    real = instrument.Runner._fold

    def per_row(self, *a):
        before = self.dumps
        real(self, *a)
        self.copies += max(self.dumps - before - 1, 0)
    monkeypatch.setattr(instrument.Runner, "_fold", per_row)
    with pytest.raises(ConformanceError, match="copies of spilled rows") \
            as ei:
        run_conformance(random_spec(6), ("overhead_bound",), device="cpu")
    assert ei.value.invariant == "overhead_bound"


def test_unknown_invariant_and_legacy_layout_raise():
    with pytest.raises(ValueError, match="unknown invariants"):
        run_conformance(random_spec(1), ("packed_vs_legacy",), device="cpu")
    with pytest.raises(NotImplementedError, match="legacy"):
        random_spec(1).probe_config().replace(layout="legacy")


# ------------------------------------------------------------- CLIs

def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", *argv], env=env, cwd=REPO,
                          capture_output=True, text=True)


def test_conformance_and_sweep_clis_on_the_cpu():
    r = _cli("repro_torch.testing.conformance", "--seed", "7", "--device",
             "cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("seed 7: OK")
    assert "overhead_bound" in r.stdout
    r = _cli("repro_torch.testing.sweep", "--count", "8", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "8/8 graphs passed" in r.stdout
