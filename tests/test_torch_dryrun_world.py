"""The dry run's fake world (``launch.mesh.fake_world`` /
``make_production_mesh``): per-device counts under DTensor on meta
tensors, held against the rules and against a real gloo world.

- the production meshes are (16, 16) and (2, 16, 16) over 256 and 512
  fake ranks, and no default process group survives them;
- a product sharded on both axes of a (2, 2) mesh counts a quarter of
  its FLOPs on the rank (per-device: the rank's local product, not the
  global one DTensor dispatches first);
- the smoke tinyllama train step on a fake (2, 2) world (meta tensors,
  one process) counts the FLOPs, bytes and collectives (by kind, with
  their ring-model wire bytes) that each rank of a real 4-rank gloo
  world (CPU tensors, ``testing/sharded_ranks.py``'s ``dry_counts``)
  counts running it.
"""
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.dryrun import analyze_cell
from repro_torch.launch.hlo_cost import analyze
from repro_torch.launch.mesh import (fake_world, make_mesh,
                                     make_production_mesh, spawn)
from repro_torch.models.model import Model
from repro_torch.testing import sharded_ranks


def test_production_meshes_leave_no_process_group():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16),
                                ("pod", "data", "model"))):
        with make_production_mesh(multi_pod=multi) as mesh:
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == axes
            assert dist.get_world_size() == 256 * (2 if multi else 1)
            assert dist.get_rank() == 0
        assert not dist.is_initialized()


def test_product_sharded_on_both_axes_counts_a_quarter_a_rank():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    M, K, N = 64, 32, 48
    whole = analyze(torch.mm, torch.empty(M, K, device="meta"),
                    torch.empty(K, N, device="meta"))
    assert whole["flops"] == 2 * M * K * N
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        a = DTensor.from_local(torch.empty(M // 2, K, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(K, N // 2, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        local = analyze(torch.mm, a, b)
    assert not dist.is_initialized()
    assert 4 * local["flops"] == whole["flops"]
    assert not local["collectives"]


def test_fake_world_counts_what_a_gloo_world_runs():
    shape = ShapeConfig("train", 32, 4, "train")
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        fake = analyze_cell(Model(smoke_config("tinyllama-1.1b")), shape,
                            mesh)
    assert not dist.is_initialized()
    assert set(fake["collectives"]) == {"all-gather", "all-reduce",
                                        "all-to-all", "reduce-scatter"}
    ranks = spawn(sharded_ranks.dry_counts, (2, 2),
                  args=("tinyllama-1.1b", "train", 32, 4))
    for r in ranks:
        assert r["collectives"] == fake["collectives"]
        assert r["collective_wire_bytes"] == fake["collective_wire_bytes"]
        assert (r["flops"], r["bytes"]) == (fake["flops"], fake["bytes"])
