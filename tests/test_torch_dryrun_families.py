"""The dry run over the cells of the ssm, hybrid, int8-moment and M-RoPE
archs (``launch.dryrun`` on the fake world of ``launch.mesh``), and the
all-to-all as a card mesh runs it.

- a ``Shard(i)`` -> ``Shard(j)`` redistribution on a fake (2, 2) world
  counts one all-to-all with the ring model's wire bytes (a rank's block
  x (G - 1) / G) and no all-gather, though a cpu mesh runs it as an
  all-gather and a chunk;
- the microbatch split keeps each microbatch spread over the batch's
  mesh dims, its rows moved (an all-to-all) where the shards cut
  microbatches;
- a fake (2, 2) world counts, for the smoke train cells of mamba2-370m,
  zamba2-2.7b, arctic-480b (int8 moments, 2 microbatches) and
  qwen2-vl-72b (M-RoPE, 2 microbatches) and the ``long_500k`` decodes of mamba2 and
  zamba2 (``SERVE_LONG_RULES``), the FLOPs, bytes, collectives (by
  kind, with their wire bytes) and peak estimate (a train cell's
  exactly; a decode's at most the fake world's) that each rank of a
  4-rank gloo world
  counts running them (``testing/sharded_ranks.py``'s
  ``dry_counts_many``, one spawn for all);
- a collective over some, not all, of the mesh's axes runs over their
  flattened group;
- the full-size mamba2-370m ``long_500k`` cell traces on the 16x16 mesh.
"""
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import analyze
from repro_torch.launch.mesh import fake_world, make_mesh, spawn
from repro_torch.models.model import Model
from repro_torch.testing import sharded_ranks

# (arch, kind, seq, batch, shape name, config overrides): the smoke
# cells; arctic and qwen2-vl in 2 microbatches of 2 rows (their configs'
# 8 would need 16 rows and four times the ranks' time)
MB2 = {"train_microbatches": 2}
CELLS = (("mamba2-370m", "train", 32, 4, "train", None),
         ("zamba2-2.7b", "train", 32, 4, "train", None),
         ("arctic-480b", "train", 32, 4, "train", MB2),
         ("qwen2-vl-72b", "train", 32, 4, "train", MB2),
         ("mamba2-370m", "decode", 64, 1, "long_500k", None),
         ("zamba2-2.7b", "decode", 64, 1, "long_500k", None))


@pytest.mark.parametrize("mesh_dim", [0, 1])
def test_shard_to_shard_counts_one_alltoall(mesh_dim):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        src = [Replicate(), Replicate()]
        dst = list(src)
        src[mesh_dim], dst[mesh_dim] = Shard(0), Shard(1)
        x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh, src,
                               run_check=False)
        r = analyze(lambda t: t.redistribute(mesh, dst), x)
        assert tuple(r["result"].to_local().shape) == (16, 8)
    assert not dist.is_initialized()
    block = 8 * 16 * 4
    assert r["collectives"] == {"all-to-all": {
        "count": 1, "wire_bytes": block * (2 - 1) / 2}}
    assert r["collective_wire_bytes"] == block / 2
    # its block in and out, as the one op on a card mesh
    assert r["bytes"] == 2 * block and r["flops"] == 8 * 16
    assert r["memory"]["peak_estimate_bytes"] == 2 * block


def test_microbatches_stay_spread_over_the_batch_axis():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        x = DTensor.from_local(torch.empty(6, 3, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=torch.Size((12, 3)), stride=(3, 1))
        # shards that cut microbatches (3 of 4 rows over 2 ranks) but
        # split each evenly: the rows move to their ranks, an all-to-all
        moved = analyze(shd.split_leading, x, 3)
        # shards of whole microbatches (2 of 6): resharded, an all-to-all
        whole = analyze(shd.split_leading, x, 2)
        for r, k in ((moved, 3), (whole, 2)):
            y = r["result"]
            assert tuple(y.shape) == (k, 12 // k, 3)
            assert tuple(y.placements) == (Shard(1), Replicate())
            assert tuple(y.to_local().shape) == (k, 6 // k, 3)
            assert set(r["collectives"]) == {"all-to-all"}
        # shards (3 rows over 4 ranks) that hold neither whole
        # microbatches of 6 nor strides of 2: gathered, then sliced
        x4 = DTensor.from_local(torch.empty(3, 3, device="meta"), mesh,
                                [Shard(0), Shard(0)], run_check=False,
                                shape=torch.Size((12, 3)), stride=(3, 1))
        cut = analyze(shd.split_leading, x4, 2)
        assert tuple(cut["result"].shape) == (2, 6, 3)
        assert set(cut["collectives"]) == {"all-gather"}
    assert not dist.is_initialized()


def test_collective_over_some_mesh_axes():
    """A psum over ("pod", "data") of a ("pod", "data", "model") mesh
    (the MoE's on the 2x16x16 mesh) runs over those axes' flattened
    group: one all-reduce of G = 4 on a (2, 2, 2) world."""
    from repro_torch.distributed import compat
    with fake_world(8, rank=5):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
        with compat.mesh_context(mesh):
            r = analyze(lambda t: compat.psum(t, ("pod", "data")),
                        torch.empty(16, device="meta"))
            name = compat.group_name(("pod", "data"))
        assert dist.get_world_size(
            dist.distributed_c10d._resolve_process_group(name)) == 4
    assert not dist.is_initialized()
    assert r["collectives"] == {"all-reduce": {
        "count": 1, "wire_bytes": 2.0 * 64 * 3 / 4}}


@pytest.fixture(scope="module")
def gloo_counts():
    threads_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return spawn(sharded_ranks.dry_counts_many, (2, 2), args=(CELLS,),
                     timeout=300)
    finally:
        if threads_env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads_env


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{c[0]}-{c[4]}" for c in CELLS])
def test_fake_world_counts_what_a_gloo_world_runs(gloo_counts, i):
    """Rank r of the gloo world counts what the fake world seen from rank
    r counts. The train steps count alike on every rank of a model
    coordinate (rank % 2), and on every rank where all q heads are real;
    with padded q heads (arctic's smoke config: 4 real of 64) only the
    ranks holding real heads attend, so ranks 0 and 1 are each held to
    their own fake view. A decode writes its token into the cache block
    of the rank that holds ``pos`` alone (rank 3, the last block of the
    sequence; rank 0 holds the first), so a decode's ranks 0 and 3 are
    each held to their own fake view."""
    arch, kind, seq, batch, name, over = CELLS[i]
    cfg = smoke_config(arch).replace(**(over or {}))
    padded = cfg.resolved_padded_heads != cfg.num_heads
    for rank in ((0, 3) if kind == "decode" else (0, 1) if padded else (0,)):
        with fake_world(4, rank=rank):
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
            fake = dryrun.analyze_cell(
                Model(smoke_config(arch).replace(**(over or {}))),
                ShapeConfig(name, seq, batch, kind), mesh)
        assert not dist.is_initialized()
        assert fake["collectives"]
        got = gloo_counts[rank][i]
        assert got["collectives"] == fake["collectives"], (arch, rank)
        assert got["collective_wire_bytes"] == fake["collective_wire_bytes"]
        assert (got["flops"], got["bytes"]) == (fake["flops"],
                                                fake["bytes"]), (arch, rank)
        peak = (got["memory"]["peak_estimate_bytes"],
                fake["memory"]["peak_estimate_bytes"])
        if kind == "train":
            assert peak[0] == peak[1], (arch, rank, peak)
        else:
            # gloo runs a decode's all-reduce with its result allocated
            # where the counting mode does not see it (first seen as a
            # view), so the gloo world counts those bytes later, or not
            # at the peak: zamba2's long_500k reads 430884 B against the
            # fake world's 496420 (rank 0)
            assert peak[0] <= peak[1], (arch, rank, peak)
    if kind == "train":
        for r, got in enumerate(gloo_counts):
            assert got[i] == gloo_counts[r % 2 if padded else 0][i], arch


def test_mamba2_long_500k_traces_on_16x16():
    rec = dryrun.lower_cell("mamba2-370m", "long_500k", "16x16")
    assert "error" not in rec
    assert rec["flops_per_device"] > 0 and rec["collectives"]
    assert rec["memory"]["peak_estimate_bytes"] > 0
    assert rec["kernel_regions"] == {}       # the recurrent decode: no kernel
