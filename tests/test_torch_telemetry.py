"""The port's telemetry control plane (``repro_torch.telemetry``) and
fault driver (``repro_torch.testing``).

- The unit and property cases of ``tests/test_telemetry.py`` on the
  port's copies: bus streams, exact window deltas, quantiles, engine
  topics and bounded rings; the sentinel's rules under injected faults
  (zero false positives over seeds, a step fires once, a ramp re-fires,
  a straggler is named, thin windows are never judged, verdicts do not
  depend on how the samples are chunked); the fake clock; the HTTP
  server on port 0.
- Against ``repro.telemetry``: both packages' ``FaultDriver`` and
  ``DriftSentinel``, driven with the same seeds, close the same windows
  and fire the same ``DriftEvent.to_dict()`` lists; for the same bus
  inputs the servers' ``/probes``, ``/mesh/skew``, ``/engine/phases``,
  ``/alerts`` and ``/metrics`` bytes are equal, and ``/status`` but for
  ``uptime_s``; the report tables render byte-equal.
- A ``ProbeSession`` publishes its stream and windows to the bus.
"""
import json
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import pytest
import torch

import repro.core.report as jax_report
import repro.core.streaming as jax_streaming
import repro.telemetry as jtel
import repro.testing.faults as jfaults
import repro_torch.core.report as port_report
import repro_torch.core.streaming as port_streaming
import repro_torch.telemetry as ttel
import repro_torch.testing.faults as tfaults
from repro_torch.core import ProbeConfig, ProbeSession, scope
from repro_torch.core.streaming import HIST_BUCKETS, StreamAggregator
from repro_torch.telemetry import (ControlPlane, DriftSentinel, ProbeStream,
                                   SentinelConfig, StatusServer, TelemetryBus,
                                   hist_quantile, make_retune_hook,
                                   render_metrics)
from repro_torch.testing import (FakeClock, FaultDriver, RampFault, StepFault,
                                 StragglerFault)

SWEEP_SEEDS = range(10)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _get_json(url: str):
    raw = _get(url)
    return json.loads(raw), raw


# ------------------------------------------------------------- bus units

def test_stream_get_or_create_and_unknown():
    bus = TelemetryBus()
    a = bus.stream("s", ("x", "y"))
    assert bus.stream("s") is a
    assert bus.stream("s", ("x", "y")) is a
    b = bus.stream("s", ("x", "y", "z"))
    assert b is not a and b.n_rows == 3
    with pytest.raises(KeyError):
        bus.stream("nope")


def test_window_frame_exact_deltas():
    bus = TelemetryBus()
    frames = []
    bus.subscribe("window", frames.append)
    st = bus.stream("s", ("x", "y"))
    st.add(0, np.array([10, 20, 30]))
    st.add(1, np.array([5]))
    f1 = st.roll(0, 4)
    st.add(0, np.array([1000]))
    f2 = st.roll(4, 8, exact_totals=np.array([1000, 0]))
    assert frames == [f1, f2]
    assert f1.index == 0 and f2.index == 1
    assert list(f1.counts) == [3, 1] and list(f1.totals) == [60, 5]
    assert list(f2.counts) == [1, 0] and list(f2.totals) == [1000, 0]
    assert list(f2.exact_totals) == [1000, 0]
    assert np.array_equal(f1.hist + f2.hist, st.agg.hist)
    assert f2.p99(0) == hist_quantile(f2.hist[0], 0.99)


def test_rows_are_exactly_aggregator_values():
    rng = np.random.default_rng(0)
    stream = ProbeStream("s", ("a", "b", "c"))
    ref = StreamAggregator(3, ema_alpha=0.1)
    for _ in range(20):
        pid = int(rng.integers(0, 3))
        durs = rng.integers(1, 100_000, rng.integers(1, 50))
        stream.add(pid, durs)
        ref.add(pid, durs)
    for row, r in enumerate(stream.rows()):
        assert r["calls"] == int(ref.count[row])
        assert r["total_cycles"] == int(ref.total[row])
        assert r["mean"] == float(ref.total[row]) / ref.count[row]
        assert r["ema"] == float(ref.ema[row])
        assert r["min"] == int(ref.min[row])
        assert r["max"] == int(ref.max[row])
        assert r["p50"] == ref.quantile(row, 0.50)
        assert r["p99"] == ref.quantile(row, 0.99)


def test_hist_quantile_matches_aggregator_quantile():
    rng = np.random.default_rng(1)
    agg = StreamAggregator(1)
    agg.add(0, rng.integers(1, 1 << 20, 500))
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert hist_quantile(agg.hist[0], q) == agg.quantile(0, q)
    assert hist_quantile(np.zeros(HIST_BUCKETS, np.int64), 0.5) == 0


def test_engine_topics_and_bounded_rings():
    bus = TelemetryBus(max_alerts=3, max_requests=2)
    phases, requests = [], []
    bus.subscribe("phase", lambda *a: phases.append(a))
    bus.subscribe("request", requests.append)
    bus.publish_phase("decode", cycles=100, batch=4)
    bus.publish_phase("decode", cycles=50, batch=4)
    bus.publish_phase("prefill", cycles=7)
    for i in range(5):
        bus.publish_request({"rid": i})
        bus.publish_alert({"kind": "x", "n": i})
    st = bus.status()
    assert st["engine"]["phases"]["decode"] == {"steps": 2, "cycles": 150}
    assert st["engine"]["requests"] == 5
    assert st["alerts"] == 5
    assert len(bus.alerts()) == 3
    assert len(bus.engine.recent) == 2
    assert len(phases) == 3 and len(requests) == 5


def test_subscribe_unknown_topic_and_unsubscribe():
    bus = TelemetryBus()
    with pytest.raises(ValueError):
        bus.subscribe("bogus", print)
    got = []
    fn = bus.subscribe("window", got.append)
    st = bus.stream("s", ("x",))
    st.roll()
    bus.unsubscribe("window", fn)
    st.roll()
    assert len(got) == 1


# ----------------------------------------------------- fault injection

def test_stationary_traffic_zero_false_positives():
    for seed in SWEEP_SEEDS:
        for n_devices in (1, 4):
            bus = TelemetryBus()
            s = DriftSentinel(bus)
            FaultDriver(bus, seed=seed, n_devices=n_devices).run(20)
            assert s.tripped() == [], (seed, n_devices, s.tripped())


def test_step_fault_fires_once_named_and_bounded():
    cfg = SentinelConfig()
    for seed in SWEEP_SEEDS:
        bus = TelemetryBus()
        s = DriftSentinel(bus, cfg)
        FaultDriver(bus, seed=seed,
                    faults=[StepFault("attn", at_window=8)]).run(20)
        evs = s.tripped()
        assert len(evs) == 1, (seed, evs)
        assert evs[0].path == "attn" and evs[0].stream == "drive"
        assert 8 <= evs[0].window < 8 + cfg.trip_windows


def test_ramp_fault_fires_repeatedly():
    for seed in (0, 1, 2):
        bus = TelemetryBus()
        s = DriftSentinel(bus)
        FaultDriver(bus, seed=seed,
                    faults=[RampFault("mlp", start_window=8)]).run(24)
        evs = s.tripped()
        assert len(evs) >= 2, (seed, evs)
        assert all(e.path == "mlp" for e in evs)
        assert evs[0].window < 8 + 4


def test_straggler_fault_names_the_device():
    cfg = SentinelConfig()
    for seed in SWEEP_SEEDS:
        bus = TelemetryBus()
        s = DriftSentinel(bus, cfg)
        FaultDriver(bus, seed=seed, n_devices=4,
                    faults=[StragglerFault(device=2, at_window=8)]).run(14)
        evs = s.tripped()
        assert evs, seed
        assert all(e.kind == "straggler" and e.device == 2 for e in evs)
        assert min(e.window for e in evs) < 8 + cfg.trip_windows + 1


def test_simultaneous_faults_both_detected():
    bus = TelemetryBus()
    s = DriftSentinel(bus)
    FaultDriver(bus, seed=5, n_devices=4, paths=("attn", "mlp"),
                faults=[StragglerFault(device=1, at_window=8, path="attn"),
                        StepFault("mlp", at_window=8)]).run(16)
    kinds = {(e.kind, e.path) for e in s.tripped()}
    assert ("straggler", "attn") in kinds
    assert any(e.path == "mlp" and e.kind != "straggler"
               for e in s.tripped())
    assert all(e.device == 1 for e in s.tripped() if e.kind == "straggler")


def test_min_samples_gate_never_judges_thin_windows():
    bus = TelemetryBus()
    s = DriftSentinel(bus, SentinelConfig(min_samples=8))
    FaultDriver(bus, seed=0, samples_per_window=4,
                faults=[StepFault("attn", at_window=2)]).run(20)
    assert s.tripped() == []


def test_sentinel_decisions_invariant_to_chunking():
    def run(chunk):
        bus = TelemetryBus()
        s = DriftSentinel(bus)
        d = FaultDriver(bus, seed=7, n_devices=2,
                        faults=[StepFault("attn", at_window=6),
                                StragglerFault(device=1, at_window=12)],
                        chunk=chunk)
        frames = d.run(18)
        return frames, [(e.kind, e.path, e.device, e.window)
                        for e in s.tripped()]

    ref_frames, ref_events = run(None)
    assert ref_events
    for chunk in (1, 7, 64):
        frames, events = run(chunk)
        assert events == ref_events, chunk
        for a, b in zip(frames, ref_frames):
            assert np.array_equal(a.counts, b.counts)
            assert np.array_equal(a.totals, b.totals)
            assert np.array_equal(a.hist, b.hist)


def test_fake_clock_and_driver_determinism():
    clock = FakeClock()
    bus = TelemetryBus()
    d = FaultDriver(bus, seed=3, clock=clock)
    d.run(2)
    assert clock.now() > 0
    d2 = FaultDriver(TelemetryBus(), seed=3)
    d2.run(2)
    assert np.array_equal(d.stream.agg.total, d2.stream.agg.total)
    assert d2.clock.now() == clock.now()


def test_retune_hook_fires_on_drift():
    tuned = []
    hook = make_retune_hook(tuned.append, background=False)
    bus = TelemetryBus()
    s = DriftSentinel(bus, retune=hook)
    FaultDriver(bus, seed=1, faults=[StepFault("attn", at_window=6)]).run(12)
    assert hook.fired == len(s.tripped()) == len(tuned) == 1
    assert tuned[0].path == "attn"


# ----------------------------------------------- the same runs in JAX

SCENARIOS = {
    "step": dict(seed=3, faults=("step",)),
    "ramp": dict(seed=1, faults=("ramp",)),
    "straggler": dict(seed=4, n_devices=4, faults=("straggler",)),
    "both_chunked": dict(seed=7, n_devices=2, faults=("step", "straggler"),
                         chunk=7),
}


def _drive(tel, faults_mod, name, windows=18):
    """Run one scenario on one package; returns (bus, sentinel, driver)."""
    sc = dict(SCENARIOS[name])
    make = {"step": lambda: faults_mod.StepFault("attn", at_window=6),
            "ramp": lambda: faults_mod.RampFault("mlp", start_window=8),
            "straggler": lambda: faults_mod.StragglerFault(device=1,
                                                           at_window=10)}
    faults = [make[f]() for f in sc.pop("faults")]
    bus = tel.TelemetryBus()
    sentinel = tel.DriftSentinel(bus)
    driver = faults_mod.FaultDriver(bus, faults=faults, **sc)
    driver.run(windows)
    return bus, sentinel, driver


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_driver_and_sentinel_equal_jax(name):
    jbus, jsen, jdrv = _drive(jtel, jfaults, name)
    bus, sen, drv = _drive(ttel, tfaults, name)
    want = [e.to_dict() for e in jsen.tripped()]
    assert want
    assert [e.to_dict() for e in sen.tripped()] == want
    for a, b in zip(drv.frames, jdrv.frames):
        for key in ("counts", "totals", "hist"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert drv.clock.now() == jdrv.clock.now()
    assert port_report.sentinel_table(sen) == jax_report.sentinel_table(jsen)
    assert port_report.telemetry_alert_table(sen.tripped()) == \
        jax_report.telemetry_alert_table(jsen.tripped())


def _feed(tel, faults_mod):
    """The same bus inputs on one package: a 2-device drive with a step
    fault, engine phases and requests."""
    bus = tel.TelemetryBus()
    sentinel = tel.DriftSentinel(bus)
    faults_mod.FaultDriver(bus, seed=2, n_devices=2,
                           faults=[faults_mod.StepFault("attn", 6)]).run(12)
    st = bus.stream("session", ("layers", "layers/scan#0", "head"))
    rng = np.random.default_rng(8)
    for _ in range(30):
        st.add(int(rng.integers(0, 3)), rng.integers(1, 5000, 9))
    st.roll(0, 4, exact_totals=np.array([1, 2, 3]))
    for phase, cyc, b in (("prefill", 900, None), ("cache", 40, None),
                          ("decode", 500, 2), ("decode", 510, 2)):
        bus.publish_phase(phase, cycles=cyc, batch=b)
    bus.publish_request({"rid": 0, "tokens": 4, "decode_batches": [2, 2],
                         "phase_cycles": {"prefill": 900, "cache": 40,
                                          "decode": 1010}})
    return bus, sentinel


ENDPOINTS = ("/probes", "/mesh/skew", "/engine/phases", "/alerts",
             "/metrics")


def test_server_bytes_equal_jax():
    jbus, _ = _feed(jtel, jfaults)
    bus, _ = _feed(ttel, tfaults)
    with jtel.StatusServer(jbus) as jsrv, StatusServer(bus) as srv:
        for ep in ENDPOINTS:
            got, want = _get(srv.url + ep), _get(jsrv.url + ep)
            assert got == want, ep
        jdoc, _ = _get_json(jsrv.url + "/status")
        doc, raw = _get_json(srv.url + "/status")
    assert doc.pop("uptime_s") >= 0 and jdoc.pop("uptime_s") >= 0
    assert doc == jdoc
    assert raw.endswith(b"\n") and json.loads(raw) is not None


# ----------------------------------------------------- report tables

@dataclass
class _Req:
    rid: int
    prompt: List[int]
    out_tokens: List[int]
    phase_cycles: Dict[str, int]
    decode_batches: List[int]
    shared_pages: int = 0


@dataclass
class _Snap:
    steps: int
    span: int
    paths: tuple
    rows: list
    windows: list = field(default_factory=list)


def test_report_tables_render_byte_equal():
    phases = {"prefill": {"steps": 3, "cycles": 2911},
              "cache": {"steps": 3, "cycles": 251},
              "decode": {"steps": 4, "cycles": 2944},
              "chunkpf": {"steps": 0, "cycles": 0}}
    chunks = {(1, 1): {"steps": 2, "cycles": 1746},
              (0, 1): {"steps": 1, "cycles": 820}}
    reqs = [_Req(0, [1] * 21, [5] * 5, {"prefill": 1086, "cache": 85,
                                        "decode": 2944}, [4, 4, 2, 1]),
            _Req(1, [2] * 7, [3] * 3, {"prefill": 739, "cache": 81,
                                       "decode": 1616}, [4, 4], 1)]
    for fn in ("engine_phase_table", "engine_chunk_table"):
        arg = phases if fn == "engine_phase_table" else chunks
        assert getattr(port_report, fn)(arg) == getattr(jax_report, fn)(arg)
    assert port_report.engine_request_table(reqs) == \
        jax_report.engine_request_table(reqs)
    rows_args = [("layers", 7, 105, 7, 15.0, 15.0, 15, 15, 15, 15),
                 ("layers/scan#0", 35, 105, 35, 3.0, 3.0, 3, 3, 3, 3),
                 ("head", 7, 14, 7, 2.0, 2.0, 2, 2, 2, 2)]
    wins = [(0, 2, [30, 30, 4]), (2, 4, [30, 30, 4]), (4, 7, [45, 45, 6])]

    def snap(mod):
        rows = [mod.StreamRow(*r) for r in rows_args]
        windows = [mod.WindowStat(f"[{a}..{b})", a, b,
                                  np.array(t, np.int64))
                   for a, b, t in wins]
        return _Snap(7, 119, tuple(r[0] for r in rows_args), rows, windows)
    ps, js = snap(port_streaming), snap(jax_streaming)
    assert port_report.streaming_table(ps) == jax_report.streaming_table(js)
    assert port_report.streaming_bump_chart(ps) == \
        jax_report.streaming_bump_chart(js)
    empty = _Snap(0, 0, (), [])
    assert port_report.streaming_bump_chart(empty) == \
        jax_report.streaming_bump_chart(empty)
    assert port_report.telemetry_alert_table([]) == \
        jax_report.telemetry_alert_table([])


# -------------------------------------------------------- HTTP server

@pytest.fixture
def live():
    bus = TelemetryBus()
    sentinel = DriftSentinel(bus)
    FaultDriver(bus, seed=2, n_devices=2,
                faults=[StepFault("attn", at_window=6)]).run(12)
    bus.publish_phase("decode", cycles=500, batch=2)
    bus.publish_request({"rid": 0, "tokens": 4})
    with StatusServer(bus) as srv:
        yield bus, sentinel, srv


def test_server_binds_ephemeral_port_and_schema(live):
    bus, _, srv = live
    assert srv.port > 0
    doc, _ = _get_json(srv.url + "/status")
    assert sorted(doc) == ["alerts", "engine", "schema", "streams",
                           "uptime_s"]
    assert doc["streams"]["drive"]["windows"] == 12
    with StatusServer(bus) as srv2:
        assert srv2.port != srv.port
    for ep in ("/status", "/probes", "/mesh/skew", "/engine/phases",
               "/alerts"):
        raw = _get(srv.url + ep)
        canon = (json.dumps(json.loads(raw), sort_keys=True,
                            separators=(",", ":")) + "\n").encode()
        assert raw == canon, ep
    assert _get(srv.url + "/metrics").decode() == render_metrics(bus)


def test_unknown_endpoint_404(live):
    _, _, srv = live
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.url + "/bogus")
    assert e.value.code == 404
    assert "/mesh/skew" in json.loads(e.value.read())["endpoints"]


def test_control_plane_prints_its_url_and_alerts(capsys):
    plane = ControlPlane(0).start()
    FaultDriver(plane.bus, seed=1,
                faults=[StepFault("attn", at_window=6)]).run(12)
    url = plane.server.url
    assert _get_json(url + "/alerts")[0]["total"] == 1
    plane.finish()
    out = capsys.readouterr().out
    assert f"status server on {url}" in out
    assert "# sentinel drift events" in out and "hist-drift" in out


# --------------------------------------------- a session on the bus

def _tiny(x, w):
    with scope.named_scope("layers"):
        for _ in scope.scan(5):
            with scope.named_scope("layer"):
                x = torch.tanh(x @ w) + x
    with scope.named_scope("head"):
        return torch.sum(x * x)


def test_probe_session_publishes_windows_to_bus():
    bus = TelemetryBus()
    frames = []
    bus.subscribe("window", frames.append)
    args = (torch.full((4, 8), 0.05), torch.full((8, 8), 0.07))
    cfg = ProbeConfig(inline="off_all", offload=1.0, buffer_depth=2)
    with ProbeSession(_tiny, cfg, window_steps=2, bus=bus, source="sess",
                      device="cpu") as s:
        for _ in range(6):
            s.step(*args)
        snap = s.snapshot()
        s.sink.flush()
    stream = bus.stream("sess")
    assert stream.paths == tuple(snap.paths)
    assert stream.agg is s.sink.stats
    assert stream.windows == 3
    by_row = np.zeros(stream.n_rows, np.int64)
    exact = np.zeros(stream.n_rows, np.int64)
    for f in frames:
        by_row += f.totals
        exact += f.exact_totals
    assert np.array_equal(by_row, stream.agg.total)
    assert np.array_equal(exact, stream.agg.total)
    assert bus.status()["streams"]["sess"]["samples"] == \
        int(stream.agg.count.sum())
