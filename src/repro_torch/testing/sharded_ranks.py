"""Rank bodies of the auto-sharded (logical-axis) checks, one process a
device.

``launch.mesh.spawn`` imports each rank's function by name, so the
bodies that ``tests/test_torch_sharded_{ranks,pods}.py`` and
``chip_smoke.py`` spawn live here and return plain data (numbers, numpy
arrays):

- ``sharded_train``: ``build_train_step`` on params placed by
  ``sharding.distribute_params`` under a rule set, beside the unsharded
  step on the same params and batch; the gathered params, moments and
  metrics of both (the unsharded ones on rank 0 alone), and this rank's
  local blocks of the placed params;
- ``sharded_decode``: ``build_prefill_step`` + ``build_decode_step``
  under ``SERVE_RULES`` (or ``SERVE_LONG_RULES``, on
  ``sharding.mesh_for``'s mesh) beside the unsharded steps (logits of
  every step, this rank's cache blocks);
- ``sharded_moe``: ``Model.loss_fn`` of a MoE arch with the sharded MoE
  (``moe_apply`` under ``compat.shard_map``) beside the local path, and
  its train step beside the local one;
- ``sharded_int8``: the ``int8_ef`` train step on a ``pod`` mesh whose
  ``data`` / ``model`` axes are auto-sharded, beside the uncompressed
  sharded step;
- ``moe_microbatches``: a MoE train step in microbatches that the
  batch's shards cut, at a capacity that drops tokens with the aux
  loss, and at one that drops none without it beside the unsharded step;
- ``probed_train``: a ``TRAIN_RULES`` step under ``core.mesh_probe``,
  record against ``ShardOracle``, outputs against ``unprobed()``;
- ``shard_map_contract``: ``compat.shard_map`` bodies whose replicated
  output is psum'd, pmean'd, all-gathered, or left as it is (raises);
- ``dry_counts`` / ``dry_counts_many``: dry-run cells
  (``launch.dryrun.analyze_cell``) of smoke configs on real tensors,
  counted on this rank, to hold the fake world's meta counts against.

Each takes the mesh and the rank's device; ``checks_rank`` is the rank
body ``spawn`` runs, several of them on one mesh. Params come from
``params_np`` (tree order; the JAX package's, in the tests) or
``Model.init(0)``, batches from numpy seeds, the same on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import P
from repro_torch.distributed.steps import (build_decode_step,
                                           build_prefill_step,
                                           build_train_step)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adamw

RULES = {"train": shd.TRAIN_RULES, "serve": shd.SERVE_RULES,
         "serve_long": shd.SERVE_LONG_RULES}


def _np(tree) -> list:
    """Leaves (tree order) as numpy (f32 for floats); an int8 moment
    (``QTensor``) gives its values, then its scales."""
    from repro_torch.optim.quantized import QTensor
    out = []
    for t in adamw.tree_leaves(tree):
        for x in (tuple(t) if isinstance(t, QTensor) else (t,)):
            x = x.detach().cpu()
            out.append(x.float().numpy() if x.is_floating_point()
                       else x.numpy())
    return out


def _batch(cfg, B: int, S: int, seed: int, device) -> Dict[str, Any]:
    g = np.random.default_rng(seed)
    return {k: torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32)).to(device)
            for k in ("tokens", "labels")}


def smoke_model(arch: str = "tinyllama-1.1b", **over) -> Model:
    """``arch``'s smoke config, f32 compute unless ``over`` says else."""
    return Model(smoke_config(arch).replace(
        **dict(dict(compute_dtype="float32"), **over)))


def save_params(arch: str, path: str, **over) -> None:
    """The ``Model.init(0)`` of ``arch``'s smoke config (what each rank
    makes), saved in tree order (``load_leaves`` reads it back)."""
    p = smoke_model(arch, **over).init(0, device="cpu")
    np.savez(path, *[t.numpy() for t in adamw.tree_leaves(p)])


def load_leaves(path: str) -> list:
    """The arrays of an ``np.savez`` file, in the order saved."""
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


def _reference() -> bool:
    """Does this rank compute the unsharded references? Rank 0 alone: the
    ranks share the host's cores, and every rank's would be the same."""
    import torch.distributed as dist
    return dist.get_rank() == 0


def _params(model, dev, params_np=None):
    params = model.init(0, device=dev)
    if params_np is None:
        return params
    return adamw.tree_unflatten(params, [
        torch.from_numpy(a).to(dev, p.dtype) for a, p in
        zip(params_np, adamw.tree_leaves(params))])


def sharded_train(mesh, dev, *, arch: str = "tinyllama-1.1b", B: int = 8,
                  S: int = 32, seed: int = 1, params_np=None,
                  rules: str = "train", steps: int = 1,
                  over: Dict[str, Any] = None,
                  scan_bytes: int = None) -> Dict[str, Any]:
    """``steps`` train steps sharded by ``rules`` on ``mesh`` and
    unsharded, from the same params (``params_np`` in tree order, else
    ``Model.init(0)``) and batch. ``scan_bytes`` lowers AdamW's scan
    threshold (0: every leaf of 2+ dims is updated a leading slice at a
    time, as full-width leaves are)."""
    if scan_bytes is not None:
        adamw.SCAN_THRESHOLD_BYTES = scan_bytes
    model = smoke_model(arch, **(over or {}))
    cfg = model.cfg
    params = _params(model, dev, params_np)
    batch = _batch(cfg, B, S, seed, dev)
    step = build_train_step(model, TrainConfig(total_steps=10,
                                               warmup_steps=1))
    p1, o1 = params, adamw.init(params, cfg.moment_dtype)
    for _ in range(steps if _reference() else 0):
        p1, o1, m1 = step(p1, o1, batch)
    with compat.mesh_context(mesh), shd.axis_rules(RULES[rules], mesh):
        p2 = shd.distribute_params(params, model.schema(), mesh,
                                   RULES[rules])
        local = _np(adamw.tree_map(shd.local, p2))
        o2 = adamw.init(p2, cfg.moment_dtype)
        for _ in range(steps):
            p2, o2, m2 = step(p2, o2, batch)
        placed = [str(tuple(x.placements)) for x in adamw.tree_leaves(p2)]
        p2, o2, m2 = shd.gather((p2, o2, m2))
    out = dict(loss=float(m2["loss"]), local=local, placements=placed)
    if _reference():
        out.update(
            loss=[float(m1["loss"]), float(m2["loss"])],
            grad_norm=[float(m1["grad_norm"]), float(m2["grad_norm"])],
            params=[_np(p1), _np(p2)], mu=[_np(o1.mu), _np(o2.mu)],
            nu=[_np(o1.nu), _np(o2.nu)])
    return out


def sharded_decode(mesh, dev, *, arch: str = "granite-3-2b", B: int = 8,
                   prompt: int = 16, steps: int = 4, cache_len: int = 32,
                   params_np=None, over: Dict[str, Any] = None,
                   rules: str = "serve") -> Dict[str, Any]:
    """``build_prefill_step`` then ``steps`` greedy steps of
    ``build_decode_step``, under ``rules`` ("serve" or "serve_long", on
    ``sharding.mesh_for``'s mesh) on ``mesh`` and unsharded: every
    step's logits (the sharded ones gathered), the ids, the caches
    compared and their placements, and this rank's block of each cache
    leaf (with where it starts) and its coordinate on each mesh axis."""
    rs = RULES[rules]
    mesh = shd.mesh_for(mesh, shd.filter_rules(rs, mesh))
    model = smoke_model(arch, **dict(dict(kv_cache_dtype="float32"),
                                     **(over or {})))
    cfg = model.cfg
    params = _params(model, dev, params_np)
    toks = _batch(cfg, B, prompt, 7, dev)["tokens"]
    sc = ShapeConfig("serve", seq_len=cache_len, global_batch=B,
                     kind="prefill")
    prefill, decode = build_prefill_step(model, sc), build_decode_step(model)

    def serve(p):
        logits, cache = prefill(p, {"tokens": toks})
        out = [logits]
        nxt = torch.argmax(logits, dim=1).to(torch.int32)   # as decode_step
        ids = [nxt]
        for i in range(steps):
            logits, cache, nxt = decode(
                p, cache, {"tokens": nxt[:, None], "pos": prompt + i})
            out.append(logits)
            ids.append(nxt)
        return out, ids, cache

    with torch.no_grad():
        with compat.mesh_context(mesh), shd.axis_rules(rs, mesh):
            p2 = shd.distribute_params(params, model.schema(), mesh, rs)
            l2, i2, c2 = serve(p2)
            placed = {k: str(tuple(v.placements)) for k, v in c2.items()}
            blocks = {k: (shd.local(v).float().cpu().numpy(),
                          _offset(v)) for k, v in c2.items()}
            l2, i2, c2 = shd.gather((l2, i2, c2))
        coords = dict(zip(mesh.mesh_dim_names,
                          (int(c) for c in mesh.get_coordinate())))
        if not _reference():
            return dict(placements=placed, local_cache=blocks,
                        axis_coords=coords)
        l1, i1, c1 = serve(params)
    V = cfg.vocab_size
    return dict(logits=[[t[:, :V].float().cpu().numpy() for t in l1],
                        [t[:, :V].float().cpu().numpy() for t in l2]],
                ids=[[t.cpu().numpy() for t in i1],
                     [t.cpu().numpy() for t in i2]],
                cache_max_diff=max(float((c1[k] - c2[k]).abs().max())
                                   for k in c1),
                cache_rel={k: float((c1[k] - c2[k]).abs().max() /
                                    c1[k].abs().max().clamp_min(1e-30))
                           for k in c1},
                placements=placed, local_cache=blocks, axis_coords=coords)


def sharded_moe(mesh, dev, *, arch: str = "granite-moe-1b-a400m",
                B: int = 8, S: int = 32, seed: int = 2, params_np=None,
                train: bool = True) -> Dict[str, Any]:
    """``Model.loss_fn`` with the sharded MoE under ``TRAIN_RULES`` on
    ``mesh`` and the local path, on the same params and batch. With
    ``train``, one train step at a capacity where no token drops
    (``no_drop_moe``): sharded with the aux loss (for JAX's sharded step),
    and sharded and local without it (under a mesh the aux loss is the
    mean of each data shard's, so only without it are the two paths one
    function); their losses, grad norms and gathered params and moments
    (the local ones on rank 0 alone), and every rank's gathered router."""
    model = smoke_model(arch)
    params = _params(model, dev, params_np)
    batch = _batch(model.cfg, B, S, seed, dev)
    l1 = float("nan")
    if _reference():
        with torch.no_grad():
            l1, _ = model.loss_fn(params, batch)
    out = {}
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    with compat.mesh_context(mesh), shd.axis_rules(shd.TRAIN_RULES, mesh):
        p2 = shd.distribute_params(params, model.schema(), mesh,
                                   shd.TRAIN_RULES)
        with torch.no_grad():
            l2, m2 = model.loss_fn(p2, batch)
        out["loss"] = [float(l1), float(shd.gather(l2))]
        out["aux"] = float(shd.gather(m2["aux_loss"]))
        if not train:
            return out
        runs = []
        for aux in (True, False):
            m = no_drop_moe(model, aux)
            step = build_train_step(m, tcfg)
            runs.append(shd.gather(step(p2, adamw.init(
                p2, m.cfg.moment_dtype), batch)))
    out["router"] = _np(runs[0][0]["stack"]["layers"]["moe"]["router"])
    if not _reference():
        return out
    m = no_drop_moe(model, False)
    runs.insert(1, build_train_step(m, tcfg)(
        params, adamw.init(params, m.cfg.moment_dtype), batch))
    out["train"] = dict(
        loss=[float(r[2]["loss"]) for r in runs],
        grad_norm=[float(r[2]["grad_norm"]) for r in runs],
        params=[_np(r[0]) for r in runs], mu=[_np(r[1].mu) for r in runs],
        nu=[_np(r[1].nu) for r in runs])
    return out


def moe_microbatches(mesh, dev, *, arch: str = "granite-moe-1b-a400m",
                     B: int = 12, S: int = 32, k: int = 3, seed: int = 4,
                     capacity: float = 1.0,
                     params_np=None) -> Dict[str, Any]:
    """The ``TRAIN_RULES`` train step of ``arch`` in ``k`` microbatches
    of ``B // k`` rows, the batch given split over ``data`` as the dry
    run gives it, so that each rank's rows cut microbatches: at ``capacity`` with the aux loss
    (tokens drop per shard; for JAX's sharded step), and at capacity
    C = T without it beside the unsharded step (the two paths one
    function there). Losses, grad norms, gathered params and moments
    (the unsharded ones on rank 0 alone)."""
    import dataclasses
    model = smoke_model(arch)
    model = Model(model.cfg.replace(moe=dataclasses.replace(
        model.cfg.moe, capacity_factor=capacity)))
    params = _params(model, dev, params_np)
    batch = _batch(model.cfg, B, S, seed, dev)
    tcfg = TrainConfig(total_steps=10, warmup_steps=1, microbatches=k)
    runs = []
    with compat.mesh_context(mesh), shd.axis_rules(shd.TRAIN_RULES, mesh):
        p2 = shd.distribute_params(params, model.schema(), mesh,
                                   shd.TRAIN_RULES)
        # the batch placed as the dry run places it: its rows over data
        placed = {key: shd.place(v, mesh, shd.placements(shd.to_pspec(
            ("batch", None), shd.current_rules(), shape=v.shape, mesh=mesh),
            mesh, v.dim())) for key, v in batch.items()}
        for m in (model, no_drop_moe(model, False)):
            runs.append(shd.gather(build_train_step(m, tcfg)(
                p2, adamw.init(p2, m.cfg.moment_dtype), placed)))
    if not _reference():
        return {}
    m = no_drop_moe(model, False)
    runs.append(build_train_step(m, tcfg)(
        params, adamw.init(params, m.cfg.moment_dtype), batch))
    return dict(loss=[float(r[2]["loss"]) for r in runs],
                grad_norm=[float(r[2]["grad_norm"]) for r in runs],
                params=[_np(r[0]) for r in runs],
                mu=[_np(r[1].mu) for r in runs],
                nu=[_np(r[1].nu) for r in runs])


def no_drop_moe(model: Model, aux: bool = True) -> Model:
    """``model`` at capacity C = T, which no expert exceeds (top-k picks
    an expert at most once a token), with or without its aux loss."""
    import dataclasses
    moe = dataclasses.replace(
        model.cfg.moe,
        capacity_factor=model.cfg.moe.num_experts / model.cfg.moe.top_k,
        aux_loss_weight=model.cfg.moe.aux_loss_weight if aux else 0.0)
    return Model(model.cfg.replace(moe=moe))


def sharded_int8(mesh, dev, *, B: int = 8, S: int = 32, seed: int = 3,
                 params_np=None) -> Dict[str, Any]:
    """The ``int8_ef`` train step on a ``pod`` mesh under ``TRAIN_RULES``
    (``data`` / ``model`` auto-sharded inside the pod-manual
    ``shard_map``) beside the uncompressed sharded step: losses, the
    gathered params and this rank's block of its pod's residual."""
    from repro_torch.optim import compression
    model = smoke_model()
    params = _params(model, dev, params_np)
    batch = _batch(model.cfg, B, S, seed, dev)
    tcfg0 = TrainConfig(total_steps=10, warmup_steps=1)
    tcfg1 = TrainConfig(total_steps=10, warmup_steps=1,
                        grad_compression="int8_ef")
    with compat.mesh_context(mesh), shd.axis_rules(shd.TRAIN_RULES, mesh):
        p = shd.distribute_params(params, model.schema(), mesh,
                                  shd.TRAIN_RULES)
        opt = adamw.init(p, model.cfg.moment_dtype)
        p0, _, m0 = build_train_step(model, tcfg0)(p, opt, batch)
        p1, _, r1, m1 = build_train_step(model, tcfg1)(
            p, opt, batch, compression.init_residual(p))
        placed = [str(tuple(x.placements)) for x in adamw.tree_leaves(p1)]
        p0, m0, p1, m1 = shd.gather((p0, m0, p1, m1))
        res = _np(adamw.tree_map(shd.local, r1))
    return dict(loss=[float(m0["loss"]), float(m1["loss"])],
                params=[_np(p0), _np(p1)], residual=res, placements=placed)


def sharded_kernels(mesh, dev, seed: int = 5) -> Dict[str, Any]:
    """The three kernel dispatchers of ``kernels.ops`` on DTensors
    (``local_call``: batch over ``data``, heads over ``model``) against
    the same call on the whole tensors: max |difference| each. Flash has
    4 q heads over 1 kv head (a rank passes its kernel the kv head its
    q heads read), the SSD 4 heads over 2 groups, paged 2 kv heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def put(x, *pl):                  # x whole on every rank, placed
        return DTensor.from_local(_block(x, mesh, pl), mesh, pl,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    R = Replicate()
    q, k, v = rnd(4, 4, 16, 16), rnd(4, 1, 16, 16), rnd(4, 1, 16, 16)
    want = ops.flash_attention(q, k, v)
    got = ops.flash_attention(put(q, Shard(0), Shard(1)), put(k, Shard(0), R),
                              put(v, Shard(0), R)).full_tensor()
    out = {"flash": float((got - want).abs().max())}
    x, a = rnd(2, 16, 4, 8), -rnd(2, 16, 4).abs()
    b, c = rnd(2, 16, 2, 8), rnd(2, 16, 2, 8)
    want = ops.ssd_scan(x, a, b, c, chunk=8, h_per_g=2)
    got = ops.ssd_scan(put(x, Shard(0), Shard(2)), put(a, Shard(0), Shard(2)),
                       put(b, Shard(0), Shard(2)), put(c, Shard(0), Shard(2)),
                       chunk=8, h_per_g=2).full_tensor()
    out["ssd"] = float((got - want).abs().max())
    qd, pool_k, pool_v = rnd(4, 2, 2, 16), rnd(8, 4, 2, 16), rnd(8, 4, 2, 16)
    pages = torch.arange(8, dtype=torch.int32, device=dev).reshape(4, 2)
    pos = torch.tensor([1, 7, 4, 6], dtype=torch.int32, device=dev)
    want = ops.paged_attention(qd, pool_k, pool_v, pages, pos)
    got = ops.paged_attention(
        put(qd, Shard(0), Shard(1)), put(pool_k, R, Shard(2)),
        put(pool_v, R, Shard(2)), put(pages, Shard(0), R),
        put(pos, Shard(0), R)).full_tensor()
    out["paged"] = float((got - want).abs().max())
    return out


def _offset(x) -> tuple:
    """Where this rank's block of a DTensor starts in the whole tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(int(o) for o in compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1])


def _block(x, mesh, pl):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    return x[tuple(slice(o, o + n) for o, n in zip(off, shape))].clone()


def probed_train(mesh, dev, *, arch: str = "tinyllama-1.1b", B: int = 8,
                 S: int = 32, max_probes: int = 16) -> Dict[str, Any]:
    """A ``TRAIN_RULES`` train step under ``core.mesh_probe`` (no manual
    axis: specs ``P()``, the step's DTensors placed by the rules): this
    device's record against ``ShardOracle``'s replay of it, and the
    outputs against ``unprobed()``'s, bit for bit."""
    from repro_torch.core.meshprobe import mesh_probe
    from repro_torch.core.pragma import ProbeConfig
    from repro_torch.testing.mesh_ranks import _oracle_matches, _same
    model = smoke_model(arch)
    params = _params(model, dev)
    batch = _batch(model.cfg, B, S, 1, dev)
    step = build_train_step(model, TrainConfig(total_steps=10,
                                               warmup_steps=1))
    rank = int(torch.distributed.get_rank())
    with compat.mesh_context(mesh), shd.axis_rules(shd.TRAIN_RULES, mesh):
        p2 = shd.distribute_params(params, model.schema(), mesh,
                                   shd.TRAIN_RULES)
        o2 = adamw.init(p2, model.cfg.moment_dtype)
        mpf = mesh_probe(step, mesh, (P(), P(), P()), (P(), P(), P()),
                         ProbeConfig(max_probes=max_probes), device=dev)
        probed, state = mpf(p2, o2, batch)
        ref = mpf.unprobed()(p2, o2, batch)
        rec = mpf.decode(state)
        oc = mpf.oracle(p2, o2, batch, device=rank)
        local = [shd.local(t) for t in compat.tree_leaves((probed, ref))]
    n = len(local) // 2
    return dict(oracle_ok=_oracle_matches(rec, oc, rank),
                bit_ok=_same(local[:n], local[n:]),
                n_probes=len(rec.paths), paths=list(rec.paths),
                cycle=float(rec.device(rank)["cycle"]))


def shard_map_contract(mesh, dev) -> Dict[str, Any]:
    """``compat.shard_map`` over the mesh's axes with a gradient taken:
    an output ``out_specs`` replicates over a manual axis passes when the
    body psums or pmeans it there (or all-gathers it), and raises when it
    is left as each device's own part."""
    axes = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(axes, mesh.shape))
    x = torch.arange(8 * sizes[axes[0]], dtype=torch.float32,
                     device=dev).reshape(-1, 2).requires_grad_(True)
    out = {}
    bodies = {"psum": lambda t: compat.psum((t * t).sum(0), axes[0]),
              "pmean": lambda t: compat.pmean(t.sum(0), axes[0]) * 2,
              "gather": lambda t: compat.all_gather(t, axes[0]).sum(0),
              "local": lambda t: (t * t).sum(0)}
    with compat.mesh_context(mesh):
        for name, body in bodies.items():
            try:
                y = compat.shard_map(body, mesh=mesh, in_specs=P(axes[0]),
                                     out_specs=P())(x)
                (g,) = torch.autograd.grad(y.sum(), x)
                out[name] = "ok"
            except ValueError as e:
                out[name] = str(e)
    return out


def checks_rank(rank: int, device, meshes) -> Dict[str, Any]:
    """The checks of ``meshes`` [(shape, axes, {"train" | "decode" |
    "moe" | "int8" | "kernels" (a suffix after "/" free): kwargs}), ...],
    each mesh over the whole world, one thread a rank (the ranks share
    the host's cores). Returns every check's result by name and this
    rank's coordinates on each mesh ("coords", in order)."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    run = {"train": sharded_train, "decode": sharded_decode,
           "moe": sharded_moe, "int8": sharded_int8,
           "kernels": sharded_kernels, "probed": probed_train,
           "contract": shard_map_contract, "moe_mb": moe_microbatches}
    out: Dict[str, Any] = {"coords": []}
    for shape, axes, checks in meshes:
        mesh = make_mesh(shape, axes)
        out["coords"].append([int(c) for c in mesh.get_coordinate()])
        out.update({name: run[name.split("/")[0]](mesh, dev, **kw)
                    for name, kw in checks.items()})
    return out


def redistribute_rank(rank: int, device) -> Dict[str, Any]:
    """One ``Shard(0)`` -> ``Replicate`` redistribute (an all-gather) of a
    DTensor on ``device``'s tensors over a 1-D mesh of the world: the
    gathered value against the whole one."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dev = torch.device(device)
    n = dist.get_world_size()
    mesh = make_mesh((n,), ("data",), device_type=dev.type)
    whole = torch.arange(4 * n, dtype=torch.float32, device=dev)
    x = DTensor.from_local(whole[4 * rank:4 * (rank + 1)].clone(), mesh,
                           [Shard(0)], run_check=False)
    got = x.redistribute(mesh, [Replicate()]).to_local()
    return dict(ok=bool(torch.equal(got, whole)))


def auto_axes_rank(rank: int, device) -> Dict[str, Any]:
    """``compat.shard_map`` manual over ``pod`` on a (1, 2, 1) ``pod,
    data, model`` mesh, its ``data`` axis auto: a DTensor sharded over
    ``data`` stays a DTensor on the sub-mesh inside, reduces there, and
    comes back whole."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = make_mesh((1, 2, 1), ("pod", "data", "model"))
    sub = compat.sub_mesh(mesh, mesh.mesh_dim_names)
    whole = torch.arange(8.0)
    x = DTensor.from_local(whole[4 * rank:4 * (rank + 1)].clone(), sub,
                           [Shard(0)], run_check=False)
    seen = {}

    def body(y):
        seen["placed"] = shd.is_dtensor(y) and y.device_mesh.mesh_dim_names \
            == ("data",)
        return y.sum(), y * 2
    with compat.mesh_context(mesh):
        total, twice = compat.shard_map(body, mesh=mesh, in_specs=P(),
                                        out_specs=P(), axis_names={"pod"})(x)
    ok = (seen["placed"] and float(total.full_tensor()) == 28.0 and
          torch.equal(twice.full_tensor(), whole * 2))
    return dict(ok=bool(ok))


def dry_counts(rank: int, dev, arch: str, kind: str, seq: int, batch: int,
               mesh_shape=(2, 2), name: str = None,
               over: Dict[str, Any] = None) -> Dict[str, Any]:
    """This rank's counts (``hlo_cost.analyze``) of the smoke cell of
    ``arch`` (its config replaced by ``over``) on a ("data", "model")
    mesh of ``mesh_shape``, on real tensors (random from seed 0).
    ``name`` is the cell's shape name (the rule set follows it:
    "long_500k" decodes under ``SERVE_LONG_RULES``), ``kind`` by
    default."""
    from repro_torch.launch.dryrun import analyze_cell
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cost = analyze_cell(Model(smoke_config(arch).replace(**(over or {}))),
                        ShapeConfig(name or kind, seq, batch, kind), mesh, dev)
    return {k: cost[k] for k in ("flops", "bytes", "collectives",
                                 "collective_wire_bytes", "memory")}


def dry_counts_many(rank: int, dev, cells) -> list:
    """``dry_counts`` of each cell of ``cells`` [(arch, kind, seq, batch,
    name, over), ...], in order, one thread a rank."""
    torch.set_num_threads(1)
    return [dry_counts(rank, dev, a, k, s, b, name=n, over=o)
            for a, k, s, b, n, o in cells]

