"""The port's trace-once cycle simulator (``repro_torch.core.tracesim``)
and sweep farm, on the CPU.

The reference's own contracts (``tests/test_tracesim.py``), re-proved
inside the port, integer for integer: ``price(mode="sim")`` equals the
kernel-probed run's model clock (``ProbeConfig(kernel_probes=("*",))``)
of the same call, and ``price(mode="flat")`` equals
``DSEEngine._measure`` under the model clock, for the flash, SSD and
paged spaces at two configs each and for the engine's chunked prefill; a
calibration installed after the capture re-prices the same artifact to
the engine's calibrated clock; artifacts round-trip canonically; the
store merges writers and keys on the space fingerprint. Cycles are never
compared with JAX's: the two clocks price different chips.
"""
import json

import pytest
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import tracesim as ts
from repro_torch.core.dse import DSEEngine, run_sweep
from repro_torch.core.incremental import EvalCache
from repro_torch.core.instrument import decode_record
from repro_torch.core.pragma import ProbeConfig, probe
from repro_torch.kernels import search_spaces as ss

CASES = {
    "flash_attention": (
        lambda: ss.flash_attention_space(S=128, D=32, device="cpu",
                                         dtype=torch.float32),
        [{"block_q": 64, "block_k": 32}, {"block_q": 128, "block_k": 64}]),
    "ssd_scan": (
        lambda: ss.ssd_scan_space(L=128, chunks=(32, 64), device="cpu"),
        [{"chunk": 32}, {"chunk": 64}]),
    "paged_attention": (
        lambda: ss.paged_attention_space(device="cpu"),
        [{"tile_slots": 32}, {"tile_slots": 128}]),
    "chunked_prefill": (
        lambda: ss.chunked_prefill_space(prompt_pages=2, device="cpu"),
        [{"chunk_pages": 1}, {"chunk_pages": 2}]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def captured(request):
    build, configs = CASES[request.param]
    space = build()
    trace = ts.capture(space, configs, walk=True,
                       space_fingerprint=ts.space_fingerprint(space))
    return space, configs, trace


def live_grid_replay_cycles(space, config) -> int:
    pc = ProbeConfig(targets=("",), max_probes=16, buffer_depth=2,
                     cycle_source="model", kernel_probes=("*",),
                     inline="off_all")
    pf = probe(space.bind(config), pc, device="cpu")
    _, rec = pf(*space.args)
    return int(decode_record(rec)["cycle"])


def test_sim_price_equals_live_kernel_probed_run(captured):
    space, configs, trace = captured
    for cfg in configs:
        assert ts.price(trace, cfg, mode="sim") == \
            live_grid_replay_cycles(space, cfg), (space.kernel_id, cfg)
        entry = trace.entries[ts.config_key(cfg)]
        assert entry.exact and entry.walked


def test_flat_price_equals_engine_measurement(captured):
    space, configs, trace = captured
    engine = DSEEngine(space, budget=None, cycle_source="model")
    for cfg in configs:
        flat = ts.price(trace, cfg, mode="flat")
        measured, spread = engine._measure(cfg, 2)
        assert flat == int(measured) == measured, (space.kernel_id, cfg)
        assert spread == 0.0


def test_calibrated_reprice_matches_measure(captured):
    space, configs, trace = captured
    cfg = configs[0]
    entry = trace.entries[ts.config_key(cfg)]
    if not entry.sites:
        pytest.skip(f"{space.kernel_id}: no kernel to calibrate")
    uncal = ts.price(trace, cfg, mode="flat")
    sim = ts.price(trace, cfg, mode="sim")
    cm.clear_kernel_calibration()
    try:
        for site in entry.sites:
            cm.set_kernel_calibration(site.kernel, 0.5)
        recal = ts.price(trace, cfg, mode="flat")
        assert recal < uncal
        assert recal == DSEEngine(space, budget=None,
                                  cycle_source="model")._measure(cfg, 2)[0]
        assert ts.price(trace, cfg, mode="sim") == sim   # calibration-free
    finally:
        cm.clear_kernel_calibration()
    assert ts.price(trace, cfg, mode="flat") == uncal


def test_trace_json_roundtrip_canonical(captured):
    space, configs, trace = captured
    s1 = ts.to_json(trace)
    back = ts.from_json(s1)
    assert ts.to_json(back) == s1
    assert json.dumps(json.loads(s1), sort_keys=True,
                      separators=(",", ":")) == s1
    for cfg in configs:
        for mode in ("sim", "flat"):
            assert ts.price(back, cfg, mode=mode) == \
                ts.price(trace, cfg, mode=mode)


def test_trace_store_merge_and_staleness_key(tmp_path, captured):
    space, configs, trace = captured
    store = ts.TraceStore(str(tmp_path))
    k0, k1 = (ts.config_key(c) for c in configs[:2])
    for k in (k0, k1):
        part = ts.KernelTrace(kernel_id=trace.kernel_id, shape=trace.shape,
                              space_fingerprint=trace.space_fingerprint)
        part.entries[k] = trace.entries[k]
        merged = store.merge(part)
    assert set(merged.entries) >= {k0, k1}
    loaded = store.load(trace.kernel_id, trace.shape,
                        trace.space_fingerprint)
    assert loaded is not None and set(loaded.entries) >= {k0, k1}
    assert store.load(trace.kernel_id, trace.shape, "deadbeef") is None


def test_price_checks_its_arguments(captured):
    space, configs, trace = captured
    with pytest.raises(ValueError):
        ts.price(trace)
    with pytest.raises(KeyError):
        ts.price(trace, {"not": "captured"})
    with pytest.raises(ValueError):
        ts.price(trace, configs[0], mode="oracle")


def test_unwalked_capture_prices_flat_in_sim_mode_and_resources():
    build, configs = CASES["flash_attention"]
    space = build()
    entry = ts.capture_entry(space, configs[0], walk=False)
    assert not entry.walked
    assert ts.price(entry, mode="sim") == ts.price(entry, mode="flat")
    live = space.resources(configs[0])
    got = ts.entry_resources(entry)
    assert (got.smem_bytes, got.threads, got.registers, got.hbm_bytes,
            got.flops, got.grid_steps) == \
        (live.smem_bytes, live.threads, live.registers, live.hbm_bytes,
         live.flops, live.grid_steps)
    assert got.static_cycles == live.static_cycles


def test_sweep_farm_two_workers_then_warm(tmp_path):
    """Two spawned workers capture and measure over one shared cache;
    the warm re-run captures and measures nothing."""
    shapes = [{"L": 64, "H": 2, "G": 1}, {"L": 128, "H": 2, "G": 1}]
    kw = dict(workers=2, top_k=4, steps=2, calibrate=False, device="cpu")
    res = run_sweep("ssd_scan", shapes,
                    cache=EvalCache(str(tmp_path / "sw")), **kw)
    assert res.n_captured == res.n_candidates
    assert res.n_measured <= res.n_finalists <= 4 < res.n_candidates
    for sh in res.shapes:
        assert sh.best_cycles <= sh.default_cycles
    res2 = run_sweep("ssd_scan", shapes,
                     cache=EvalCache(str(tmp_path / "sw")), **kw)
    assert res2.n_measured == 0 and res2.n_captured == 0
    assert res2.n_cache_hits == res.n_measured
    assert [s.best_config for s in res2.shapes] == \
        [s.best_config for s in res.shapes]
    assert EvalCache(str(tmp_path / "sw")).best_config(
        "ssd_scan", "cpu") is not None
    # each shape's winner is kept at its own shape
    won = EvalCache(str(tmp_path / "sw")).winners("ssd_scan", "cpu")
    assert sorted(map(str, won.values())) == \
        sorted(str(s.best_config) for s in res.shapes) and len(won) == 2


def test_sweep_calibration_transfers(tmp_path):
    cm.clear_kernel_calibration()
    try:
        res = run_sweep("flash_attention", [{"S": 64, "D": 64}], workers=0,
                        top_k=2, steps=2,
                        cache=EvalCache(str(tmp_path / "cal")),
                        calibrate=True, device="cpu")
    finally:
        cm.clear_kernel_calibration()
    assert res.n_calibration_runs == 1
    assert res.calibration_scale is not None and res.calibration_scale > 0
