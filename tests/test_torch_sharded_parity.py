"""The sharded steps do the work an even split does, and JAX's, not more.

Per-device FLOPs of the dry run (``launch.dryrun.analyze_cell``,
``hlo_cost.analyze`` on ``meta``):

- smoke train cells (S 64, B 16) on a fake (2, 2) ``data, model`` world:
  rank 0's count x 4 within 1.08 x the unsharded count, for arctic-480b
  and minicpm-2b with their padded q heads (4 real of 64 and of 48: each
  model rank attends over its own real heads, nothing gathers q) beside
  the dense and MoE references. Rank 0 holds all four real heads, so
  its attention is twice an even split's; the factor allows that;
- the same cell in 4 microbatches within 2 % of the cell in 1, for
  tinyllama-1.1b and arctic-480b (a microbatch's product of the loss's
  logits used to come back replicated over the vocab and take the
  unembedding's gradient whole on every rank);
- production widths at 1 layer on the 16x16 fake world, 8 microbatches,
  against JAX's ``lower_cell(..., multi_pod=False, extra_cfg=...)`` run
  in a subprocess (its module sets ``XLA_FLAGS`` for 512 host devices
  as it is imported): tinyllama within 1.10 x JAX's count, arctic within
  1.25 x;
- two full-size serving cells on 16x16 against JAX's the same way, the
  per-device peak within 1.25 x JAX's: musicgen-large's prefill_32k (its
  FLOPs within 1.25 x; the K/V cache is made and written a block a rank,
  where it was allocated whole on every rank, 206 GiB) and mamba2-370m's
  long_500k decode (its FLOPs at most JAX's; the residual leaves each
  layer summed over ``model``, where each in_proj ran at full width).
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.model import Model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ShapeConfig("train", 64, 16, "train")
EVEN = ("arctic-480b", "minicpm-2b", "tinyllama-1.1b",
        "granite-moe-1b-a400m")
PRODUCTION = {"tinyllama-1.1b": 1.10, "arctic-480b": 1.25}
LAYER_1_MB_8 = {"num_layers": 1, "train_microbatches": 8}
# full-size serving cells on 16x16: (arch, shape, FLOPs factor); peaks
# within 1.25x JAX's
SERVING = (("musicgen-large", "prefill_32k", 1.25),
           ("mamba2-370m", "long_500k", 1.0))
CELLS = [(a, "train_4k", LAYER_1_MB_8) for a in PRODUCTION] + \
    [(a, s, None) for a, s, _ in SERVING]

JAX_SIDE = r"""
import json, sys
from repro.launch import dryrun
out = {}
for arch, shape, extra in json.loads(sys.argv[1]):
    rec = dryrun.lower_cell(arch, shape, False, extra_cfg=extra)
    out[arch + ":" + shape] = (rec["flops_per_device"],
                               rec["memory"]["peak_estimate_bytes"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_counts():
    """JAX's per-device counts, its subprocess started first so that it
    runs beside the port's cells."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, json.dumps(CELLS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    got = {}

    def result():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()


_COUNTS = {}


def _flops(arch: str, mesh: bool, **over) -> float:
    """Rank 0's per-device FLOPs of ``arch``'s smoke train cell, on the
    fake (2, 2) world or unsharded (memoised: tests share cells)."""
    key = (arch, mesh, tuple(sorted(over.items())))
    if key not in _COUNTS:
        model = Model(smoke_config(arch).replace(**over))
        if mesh:
            with fake_world(4):
                m = make_mesh((2, 2), ("data", "model"), device_type="cpu")
                cost = dryrun.analyze_cell(model, SMOKE, m)
            assert not dist.is_initialized()
        else:
            cost = dryrun.analyze_cell(model, SMOKE, None)
        _COUNTS[key] = float(cost["flops"])
    return _COUNTS[key]


@pytest.mark.parametrize("arch", EVEN)
def test_sharded_cell_splits_the_work_evenly(jax_counts, arch):
    cfg = smoke_config(arch)
    if arch in ("arctic-480b", "minicpm-2b"):
        assert cfg.resolved_padded_heads > cfg.num_heads
    ratio = 4 * _flops(arch, True) / _flops(arch, False)
    assert ratio <= 1.08, (arch, ratio)


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "arctic-480b"))
def test_microbatches_cost_what_one_batch_does(arch):
    one = _flops(arch, True, train_microbatches=1)
    four = _flops(arch, True, train_microbatches=4)
    assert abs(four - one) <= 0.02 * one, (arch, one, four)


@pytest.mark.parametrize("arch", tuple(PRODUCTION))
def test_production_cell_within_jax_count(jax_counts, arch):
    port = dryrun.lower_cell(arch, "train_4k", "16x16",
                             extra_cfg=LAYER_1_MB_8)["flops_per_device"]
    jax = jax_counts()[f"{arch}:train_4k"][0]
    assert port <= PRODUCTION[arch] * jax, (arch, port, jax)


@pytest.mark.parametrize("arch,shape,factor", SERVING,
                         ids=[f"{a}-{s}" for a, s, _ in SERVING])
def test_serving_cell_within_jax_count_and_peak(jax_counts, arch, shape,
                                                factor):
    rec = dryrun.lower_cell(arch, shape, "16x16")
    flops, peak = rec["flops_per_device"], \
        rec["memory"]["peak_estimate_bytes"]
    jax_flops, jax_peak = jax_counts()[f"{arch}:{shape}"]
    assert flops <= factor * jax_flops, (arch, flops, jax_flops)
    assert peak <= 1.25 * jax_peak, (arch, peak, jax_peak)
