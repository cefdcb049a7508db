"""The port's engine soak (``repro_torch.engine.soak``) on the CPU.

- The short soak and the pressure soak with chunked prefill, asserting
  what ``tests/test_engine.py``'s soak cases assert (the soak asserts
  zero retraces, balanced pages at drain and flat host and device memory
  itself).
- Against ``repro.engine.soak.soak`` at the same arguments: the trace is
  the same numpy stream from the seed and every request decodes its
  ``max_new`` tokens whatever the weights, so the scheduler's statistics
  are equal: requests served, tokens, pages peak, evictions, prefix hits
  and misses, decode buckets, phase step counts, steps built. (Token ids
  are not compared: the two packages draw their random weights from
  different generators.)
- The same pressure soak with every step probed (``probe=True``): the
  engine's chunk step once passed its batch in another key order than
  warm-up's, so the step's session saw a new argument tree and raised.
- The CLI with ``--device cpu`` exits 0.
"""
import os
import subprocess
import sys

from repro_torch.engine.soak import soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULER = ("served", "pages_peak", "evictions", "prefix_hits",
             "prefix_misses", "buckets", "steps_traced", "tokens_out",
             "hol_blocked_steps", "retraces")


def test_engine_soak_short():
    out = soak(waves=2, requests_per_wave=4, seed=1, verbose=False,
               device="cpu")
    assert out["served"] == 8 and out["retraces"] == 0
    assert out["tokens"] == out["tokens_out"]


def test_engine_soak_pressure_short_equals_jax():
    """Undersized pool: the soak's own asserts cover flat memory and
    balanced drain; here pressure evicted, the chunked scheduler served
    the trace with zero retraces, and its statistics are JAX's."""
    from repro.engine.soak import soak as jax_soak
    kw = dict(waves=2, requests_per_wave=6, seed=1, pressure=True, chunk=2,
              min_hit_rate=0.0, verbose=False)
    out = soak(**kw, device="cpu")
    assert out["served"] == 12 and out["retraces"] == 0
    assert out["evictions"] > 0
    assert out["buffers_last"] <= out["buffers_first"] + 16
    want = jax_soak(**kw)
    for key in SCHEDULER:
        assert out[key] == want[key], key
    assert {p: v["steps"] for p, v in out["phases"].items()} == \
        {p: v["steps"] for p, v in want["phases"].items()}


def test_probed_chunked_soak_under_pressure():
    """Every step under a ``ProbeSession`` with chunked prefill: the
    chunk step's arguments keep warm-up's tree (a probed step's capture
    is keyed on it), so nothing is captured again, and the scheduler's
    statistics are the unprobed soak's."""
    kw = dict(waves=2, requests_per_wave=6, seed=1, pressure=True, chunk=2,
              min_hit_rate=0.0, verbose=False, device="cpu")
    probed, plain = soak(**kw, probe=True), soak(**kw)
    assert probed["retraces"] == 0 and probed["phases"]["chunkpf"]["steps"]
    for key in SCHEDULER:
        assert probed[key] == plain[key], key
    assert {p: v["steps"] for p, v in probed["phases"].items()} == \
        {p: v["steps"] for p, v in plain["phases"].items()}
    assert all(v["cycles"] > 0 for v in probed["phases"].values())


def test_soak_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.engine.soak", "--device", "cpu",
         "--waves", "2", "--requests-per-wave", "4"],
        env=env, cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "soak OK: 8 requests over 2 waves" in r.stdout
    assert r.stdout.count("wave ") == 2
