"""The port's streaming sessions (``repro_torch.core.streaming``).

Inside the port, the properties ``tests/test_streaming.py`` asserts for
the reference: session aggregates over N steps equal N times the
one-shot records (counts, totals, min, max, histograms); the footprint
is flat at 40, 80 and 120 steps; outputs are bitwise the unprobed
function's under a live session with inputs that vary per step; totals
equal the device counters; ``offload=0`` keeps duration stats to the
ring's depth; stateful calls accumulate; a session reuses a
``ProbedFunction`` and ``close()`` restores its sink; the asynchronous
drain is lossless, waits on each row's copy event, and survives a
poisoned row. The host's copies of the call counts and the clock equal
the device's.

Against ``repro.core``: a session's paths and calls per probe after N
steps equal ``repro.core.ProbeSession``'s on the same programs, and
``StreamAggregator`` fed the same seeded durations gives the same count,
total, min, max, histogram and quantiles (EMA within 1e-12 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ProbeConfig as JaxProbeConfig
from repro.core import ProbeSession as JaxProbeSession
from repro.core.streaming import StreamAggregator as JaxStreamAggregator
from repro_torch.core import (ProbeConfig, ProbeSession, StreamAggregator,
                              StreamingSink, decode_record, probe, scope)
from repro_torch.core.buffer import HostSink, row_durations
from repro_torch.core.instrument import state_clock, state_totals
from repro_torch.core.streaming import _buckets_of
from test_torch_probe import SMALL, _jax_only, _small


def j_workload(x, w):
    def body(c, _):
        with jax.named_scope("layer"):
            with jax.named_scope("mm"):
                c = jnp.tanh(c @ w) + c
        return c, None
    with jax.named_scope("layers"):
        x, _ = jax.lax.scan(body, x, None, length=5)

    def cond(s):
        return jnp.sum(jnp.abs(s[0])) < 1e3

    def grow(s):
        with jax.named_scope("grow"):
            return (s[0] * 1.4 + 0.1, s[1] + 1)
    with jax.named_scope("dynamic"):
        x, n = jax.lax.while_loop(cond, grow, (x, jnp.int32(0)))
    with jax.named_scope("head"):
        return jnp.sum(x * x), n


def t_workload(x, w):
    with scope.named_scope("layers"):
        for _ in scope.scan(5):
            with scope.named_scope("layer"):
                with scope.named_scope("mm"):
                    x = torch.tanh(x @ w) + x

    def cond(s):
        return torch.sum(torch.abs(s[0])) < 1e3

    def grow(s):
        with scope.named_scope("grow"):
            return (s[0] * 1.4 + 0.1, s[1] + 1)
    with scope.named_scope("dynamic"):
        x, n = scope.while_loop(cond, grow,
                                (x, torch.zeros((), dtype=torch.int32)))
    with scope.named_scope("head"):
        return torch.sum(x * x), n


_NP = (np.full((4, 8), 0.05, np.float32), np.full((8, 8), 0.07, np.float32))
_CFG = ProbeConfig(inline="off_all", offload=1.0, buffer_depth=2)


def _args(i: int = 0):
    return (torch.from_numpy(_NP[0]) + 0.01 * i, torch.from_numpy(_NP[1]))


def _session(cfg=_CFG, **kw):
    return ProbeSession(t_workload, cfg, device="cpu", **kw)


def _one_shot_durations():
    """Per-probe per-call durations of one one-shot call (full history:
    HostSink records + ring remainder via the report)."""
    pf = probe(t_workload, _CFG, device="cpu")
    _, rec = pf(*_args())
    rep = pf.report(rec)
    return {r.path: np.array([e - s for s, e in r.iters], np.int64)
            for r in rep.rows}


def _check_mirrors(s):
    dec = decode_record(s._state)
    assert [int(c) for c in dec["calls"]] == s._calls
    assert s.clock() == state_clock(s._state) == dec["cycle"]


def test_aggregator_matches_one_shot_records():
    durs = _one_shot_durations()
    N = 7
    with _session() as s:
        for _ in range(N):
            s.step(*_args())
        snap = s.snapshot()
        _check_mirrors(s)
        merged = s._merged_stats(decode_record(s._state))
    assert set(snap.paths) == set(durs)
    assert any(r.calls for r in snap.rows)
    for r in snap.rows:
        d = durs[r.path]
        assert r.calls == N * len(d), r.path
        assert r.observed == r.calls, r.path
        assert r.total_cycles == N * int(d.sum()), r.path
        if len(d) == 0:
            continue
        assert r.min == int(d.min()) and r.max == int(d.max()), r.path
        assert r.min <= r.p50 <= r.p99 <= r.max, r.path
    for pid, path in enumerate(snap.paths):
        expect = np.zeros_like(merged.hist[pid])
        np.add.at(expect, _buckets_of(durs[path]), N)
        assert np.array_equal(merged.hist[pid], expect), path


def test_constant_memory_across_120_steps():
    sizes = {}
    with _session(window_steps=4, max_windows=4) as s:
        for i in range(1, 121):
            s.step(*_args())
            if i in (40, 80, 120):
                sizes[i] = s.state_nbytes()
        s.sink.flush()
        assert s.sink._batches == []         # nothing stored, only folded
        assert s.sink.dumps > 0              # ...but spills did happen
    assert sizes[40] == sizes[80] == sizes[120], sizes
    assert len(s._windows) == 4


def test_outputs_bit_identical_under_live_session():
    """Port against port: the same kernels on both sides."""
    with _session() as s:
        for i in range(6):
            got = s.step(*_args(i))
            want = t_workload(*_args(i))
            for a, b in zip(got, want):
                assert torch.equal(a, b), i


def test_session_totals_match_device_counters():
    with _session() as s:
        for _ in range(5):
            s.step(*_args())
        snap = s.snapshot()
        totals = state_totals(s._state)
    for pid, r in enumerate(snap.rows):
        assert r.observed == r.calls, r.path
        assert r.total_cycles == int(totals[pid]), r.path
        assert r.mean * r.observed == pytest.approx(r.total_cycles), r.path


def test_no_offload_truncates_to_ring_depth():
    cfg = ProbeConfig(inline="off_all", offload=0.0, buffer_depth=2)
    with _session(cfg) as s:
        for _ in range(4):
            s.step(*_args())
        snap = s.snapshot()
        _check_mirrors(s)
        assert s.sink.dumps == 0
    active = [r for r in snap.rows if r.calls]
    assert active
    for r in active:
        assert r.observed == min(r.calls, 2), r.path
        assert r.calls >= 4, r.path


def test_stateful_call_accumulates_across_steps():
    pf = probe(t_workload, _CFG, device="cpu")
    _, rec1 = pf(*_args())
    one = state_totals(rec1)
    state = pf.init_state()
    for _ in range(3):
        _, state = pf.stateful_call(state, *_args())
    assert np.array_equal(state_totals(state), 3 * one)


def test_session_reuses_existing_probed_function_and_restores_its_sink():
    pf = probe(t_workload, _CFG, device="cpu")
    pf.ensure_built(*_args())                  # captured once already
    orig = pf.sink
    with ProbeSession(pf) as s:
        out = s.step(*_args())
        snap = s.snapshot()
        assert s.sink.dumps > 0                # streaming sink installed
    assert pf.captures == 1 and snap.steps == 1
    for a, b in zip(out, t_workload(*_args())):
        assert torch.equal(a, b)
    assert pf.sink is orig
    _, rec = pf(*_args())                      # one-shot on the old sink
    assert pf.sink.dumps > 0
    hot = pf.report(rec).row("layers/scan#0/layer")
    assert hot is not None and len(hot.iters) == hot.calls


def test_step_with_other_shapes_raises():
    with _session() as s:
        s.step(*_args())
        with pytest.raises(RuntimeError, match="another structure"):
            s.step(torch.ones(5, 8), torch.from_numpy(_NP[1]))


def test_closed_session_and_empty_snapshot():
    s = _session()
    with pytest.raises(RuntimeError, match="no steps"):
        s.snapshot()
    assert s.clock() == 0 and s.close() is None
    with pytest.raises(RuntimeError, match="closed"):
        s.step(*_args())


class _LateCopy:
    """A stand-in for the CUDA event after a run's copies: the block
    holds its rows only once the event is waited on."""

    def __init__(self, block, values):
        self.block, self.values, self.waited = block, values, False

    def synchronize(self):
        self.block.copy_(self.values)
        self.waited = True


def test_streaming_sink_async_drain_is_lossless_and_waits_on_events():
    sink = StreamingSink()
    sink.bind(2)
    depth = 4
    full = torch.tensor([[100 * s, 100 * s + 7] for s in range(depth)],
                        dtype=torch.int64)
    events = []
    for k in range(25):                   # a run spilling 2 rows, 25 runs
        block = torch.zeros((3, depth, 2), dtype=torch.int64)
        ev = _LateCopy(block, full.expand(3, depth, 2))
        events.append(ev)
        sink.dump([0, 1], [k * depth, k * depth], [block[:1], block[1:2]],
                  ev)
    sink.flush()
    assert all(ev.waited for ev in events)     # nothing before its copy
    assert sink.dumps == 50 and sink.dropped == 0
    assert sink.stats.count[0] == sink.stats.count[1] == 25 * depth
    assert sink.stats.total[0] == 25 * depth * 7
    assert np.array_equal(row_durations(full), np.full(depth, 7))
    sink.close()
    assert sink.records(0) == []               # history is not retained


def test_host_sink_reassembles_rows_in_call_order():
    sink = HostSink()
    rows = torch.arange(12, dtype=torch.int64).reshape(3, 2, 2)
    sink.dump([1, 0], [2, 0], [rows[:2]])
    sink.dump([1], [0], [rows[2:]])
    assert sink.dumps == 3
    assert sink.records(1) == [(8, 9), (10, 11), (0, 1), (2, 3)]
    assert sink.records(0) == [(4, 5), (6, 7)]


def test_poisoned_batch_is_dropped_and_flush_returns():
    sink = StreamingSink()
    sink.bind(1)
    sink.dump([0], [0], [np.zeros((3, 3), np.int64)])    # not (k, depth, 2)
    sink.dump([0, 0], [0, 1], [np.zeros((1, 1, 2), np.int64)])   # 1 row
    sink.dump([0], [0], [torch.tensor([[[0, 5]]], dtype=torch.int64)])
    sink.flush()
    assert sink.dropped == 2
    assert sink.stats.count[0] == 1 and sink.stats.total[0] == 5
    sink.close()


# ------------------------------------------------------------ against JAX

PROGRAMS = ("workload",) + SMALL


def _programs(name):
    if name == "workload":
        return j_workload, t_workload, _NP
    return _small(name)


@pytest.mark.parametrize("name", PROGRAMS)
def test_session_paths_and_calls_match_jax(name):
    jfn, tfn, args = _programs(name)
    N = 3
    jcfg = JaxProbeConfig(inline="off_all", offload=1.0, buffer_depth=2,
                          max_probes=500)
    with JaxProbeSession(jfn, jcfg) as js:
        for _ in range(N):
            js.step(*(jnp.asarray(a) for a in args))
        want = [(r.path, r.calls) for r in js.snapshot().rows
                if not _jax_only(r.path)]
    cfg = ProbeConfig(inline="off_all", offload=1.0, buffer_depth=2,
                      max_probes=500)
    with ProbeSession(tfn, cfg, device="cpu") as s:
        for _ in range(N):
            s.step(*(torch.from_numpy(a) for a in args))
        snap = s.snapshot()
    assert [(r.path, r.calls) for r in snap.rows] == want
    for r in snap.rows:
        assert r.observed == r.calls, r.path


def test_aggregator_equals_jax_on_the_same_durations():
    rng = np.random.default_rng(0)
    port, ref = StreamAggregator(3, ema_alpha=0.2), \
        JaxStreamAggregator(3, ema_alpha=0.2)
    for _ in range(40):
        pid = int(rng.integers(0, 3))
        d = rng.integers(1, 1 << 30, int(rng.integers(1, 60)))
        port.add(pid, d)
        ref.add(pid, d)
    for name in ("count", "total", "min", "max", "hist"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(port.ema, ref.ema, rtol=1e-12, atol=0)
    for pid in range(3):
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert port.quantile(pid, q) == ref.quantile(pid, q)
    assert port.nbytes == ref.nbytes
    np.testing.assert_array_equal(port.skew(1), ref.skew(1))
