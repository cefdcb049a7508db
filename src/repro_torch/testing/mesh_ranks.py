"""Rank bodies of the mesh-probing checks (one process a device).

``launch.mesh.spawn`` imports the function each rank runs by name, so
the bodies that the tests and ``chip_smoke.py`` spawn live here, in an
importable module, and return plain data (numbers, lists, numpy arrays)
that pickles back to the parent:

- ``workload_rank``: the JAX package's mesh-probe workload (a scanned
  ``tanh`` layer, an all-reduce-mean under ``sync`` and, with ``skew``, a
  ``while`` loop whose trip count is the device's index + 1) under
  ``mesh_probe``: the device-major record, this device's record against
  ``ShardOracle`` exactly, outputs bitwise ``unprobed()``'s, a k-step
  ``MeshProbeSession`` (on a ``TelemetryBus``) against k x one-shot, the
  collective sites and the report views;
- ``dp_train_rank``: ``build_dp_train_step`` under ``mesh_probe`` from
  given parameters and batch, the same checks, and the step's outputs;
- ``int8_rank``: ``build_train_step`` with ``grad_compression="int8_ef"``
  over a ``pod`` mesh (params, residual, scales), the uncompressed step
  beside it, and the step again with a ring that skips the peer.

Every body takes ``(rank, device, ...)`` and builds its mesh with
``launch.mesh.make_mesh``; ``device`` is where the rank's tensors, model
and probe state live (the one card, for a gloo world whose ranks share
it).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scope
from repro_torch.core.meshprobe import MeshProbeSession, mesh_probe
from repro_torch.core.pragma import ProbeConfig
from repro_torch.distributed import compat
from repro_torch.distributed.compat import P
from repro_torch.launch.mesh import make_mesh, probe_axis_names
from repro_torch.optim import adamw


def workload(axes: Tuple[str, ...], scan_len: int = 3, skew: bool = False):
    """The per-shard body of ``tests/test_meshprobe.py``'s workload, over
    every axis of the mesh."""
    axis = axes[0] if len(axes) == 1 else axes

    def step(x, w):
        with scope.named_scope("layers"):
            for _ in scope.scan(scan_len):
                with scope.named_scope("layer"):
                    x = torch.tanh(x @ w) + x
        with scope.named_scope("sync"):
            g = compat.pmean(torch.sum(x * x), axis)
        if not skew:
            with scope.named_scope("head"):
                return torch.sum(x * x) + g
        i = compat.axis_index(axis)

        def cond(s):
            return s[1] < i + 1

        def grow(s):
            with scope.named_scope("grow"):
                return (s[0] * 1.1, s[1] + 1)
        with scope.named_scope("dynamic"):
            x, n = scope.while_loop(
                cond, grow, (x, torch.zeros((), dtype=torch.int32,
                                            device=x.device)))
        with scope.named_scope("head"):
            return torch.sum(x * x) + g, n
    return step


def workload_inputs(n_devices: int, device="cpu"):
    """(x, w): x (2 D, 4) sharded by rows, w (4, 4) replicated."""
    x = torch.arange(8 * n_devices, dtype=torch.float32,
                     device=device).reshape(2 * n_devices, 4) * 0.01
    w = torch.full((4, 4), 0.25, device=device)
    return x, w


def _same(a, b) -> bool:
    la, lb = compat.tree_leaves(a), compat.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _record_dict(rec) -> Dict[str, Any]:
    return dict(paths=list(rec.paths), cycle=rec.cycle.tolist(),
                totals=rec.totals.tolist(), calls=rec.calls.tolist(),
                starts=rec.starts.tolist(), ends=rec.ends.tolist())


def _oracle_matches(rec, oc, d: int) -> bool:
    dev = rec.device(d)
    return (list(dev["totals"]) == oc.totals and
            list(dev["calls"]) == list(oc.calls) and
            list(dev["starts"]) == oc.starts and
            list(dev["ends"]) == oc.ends and dev["cycle"] == oc.cycle)


def _sites(mpf):
    return sorted((s.path, s.kind, list(s.axes), s.group_size,
                   s.result_bytes, float(s.wire_bytes))
                  for s in mpf.collectives())


def workload_rank(rank: int, device, shape: Sequence[int], *,
                  skew: bool = True, steps: int = 3) -> Dict[str, Any]:
    """One rank of the workload; every rank returns its checks, rank 0
    also the record, the sites and the views."""
    from repro_torch.telemetry.bus import TelemetryBus
    axes = probe_axis_names(shape)
    mesh = make_mesh(shape, axes)
    dev = torch.device(device)
    n = int(np.prod(shape))
    x, w = workload_inputs(n, dev)
    cfg = ProbeConfig(inline="off_all")
    spec = (P(axes), P())
    mpf = mesh_probe(workload(axes, skew=skew), mesh, spec, P(), cfg,
                     device=dev)
    mpf.ensure_built(x, w)                      # the capture, untimed
    t0 = time.perf_counter()
    out, state = mpf(x, w)
    probed_s = time.perf_counter() - t0
    rec = mpf.decode(state)
    oc = mpf.oracle(x, w, device=rank)
    t0 = time.perf_counter()
    ref = mpf.unprobed()(x, w)
    unprobed_s = time.perf_counter() - t0
    bus = TelemetryBus()
    with MeshProbeSession(
            mesh_probe(workload(axes, skew=skew), mesh, spec, P(), cfg,
                       device=dev),
            window_steps=2, bus=bus, source="mesh") as s:
        for _ in range(steps):
            s.step(x, w)
        snap = s.snapshot()
    stream = bus.stream("mesh")
    sess_ok = (np.array_equal(snap.record.totals, steps * rec.totals) and
               np.array_equal(snap.record.calls, steps * rec.calls) and
               np.array_equal(snap.stats.reduce("per-device", n),
                              snap.record.totals) and
               np.array_equal(snap.stats.skew(n), snap.record.skew()))
    res = dict(rank=rank, oracle_ok=_oracle_matches(rec, oc, rank),
               bit_ok=_same(out, ref), sess_ok=bool(sess_ok),
               stream=dict(n_devices=stream.n_devices,
                           windows=stream.windows,
                           totals_ok=bool(np.array_equal(
                               stream.agg.total.reshape(n, -1),
                               snap.record.totals))),
               capture_s=mpf.capture_seconds, probed_s=probed_s,
               unprobed_s=unprobed_s)
    if rank == 0:
        rep = mpf.report(rec)
        res.update(record=_record_dict(rec), sites=_sites(mpf),
                   device_table=rep.device_table(),
                   heat=rep.heat(), comm_table=rep.comm_table(),
                   session_table=snap.table())
    return res


def smoke_model(compute_dtype: str = "float32", full: bool = False,
                head_dim: int = 0):
    """tinyllama-1.1b: the smoke config at ``compute_dtype`` (with
    ``head_dim``, 4 heads of that width: the CUDA kernels take 64, 80
    and 128), or ``full`` width with bf16 master params (so no AdamW leaf
    exceeds the 128 MiB row-scan threshold: a short step)."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models.model import Model
    if full:
        return Model(get_config("tinyllama-1.1b").replace(
            param_dtype="bfloat16"))
    cfg = smoke_config("tinyllama-1.1b").replace(compute_dtype=compute_dtype)
    if head_dim:
        cfg = cfg.replace(head_dim=head_dim, d_model=4 * head_dim)
    return Model(cfg)


def _to_np(tree):
    return [t.detach().float().cpu().numpy() if t.is_floating_point() else
            t.detach().cpu().numpy() for t in adamw.tree_leaves(tree)]


def dp_train_rank(rank: int, device, shape: Sequence[int], params_np,
                  batch_np, *, max_probes: int = 16,
                  inline: str = "default", head_dim: int = 0,
                  compute_dtype: str = "float32") -> Dict[str, Any]:
    """One probed ``build_dp_train_step`` over the global batch (split
    over every mesh axis), the model ``smoke_model(compute_dtype,
    head_dim=)``. ``params_np`` None: ``Model.init(0)``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.steps import build_dp_train_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.convert import params_from_numpy
    axes = probe_axis_names(shape)
    mesh = make_mesh(shape, axes)
    dev = torch.device(device)
    model = smoke_model(compute_dtype, head_dim=head_dim)
    params = (model.init(0, dev) if params_np is None else
              params_from_numpy(params_np, dev))
    opt = adamw.init(params, model.cfg.moment_dtype)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in batch_np.items()}
    step = build_dp_train_step(
        model, TrainConfig(total_steps=10, warmup_steps=1),
        axis=axes[0] if len(axes) == 1 else axes)
    mpf = mesh_probe(step, mesh, (P(), P(), P(axes)), (P(), P(), P()),
                     ProbeConfig(inline=inline, max_probes=max_probes),
                     device=dev)
    mpf.ensure_built(params, opt, batch)        # the capture, untimed
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    (p1, o1, m1), state = mpf(params, opt, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    probed_s = time.perf_counter() - t0
    flash_launches = fa.flash_attention.launches
    t0 = time.perf_counter()
    p2, o2, m2 = mpf.unprobed()(params, opt, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    unprobed_s = time.perf_counter() - t0
    rec = mpf.decode(state)
    oc = mpf.oracle(params, opt, batch, device=rank)
    res = dict(rank=rank, oracle_ok=_oracle_matches(rec, oc, rank),
               bit_ok=_same((p1, o1, m1), (p2, o2, m2)),
               loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]),
               capture_s=mpf.capture_seconds, probed_s=probed_s,
               unprobed_s=unprobed_s, flash_launches=flash_launches)
    if rank == 0:
        res.update(record=_record_dict(rec), sites=_sites(mpf),
                   params=_to_np(p1))
    return res


def int8_rank(rank: int, device, params_np, batch_np,
              shape: Sequence[int] = (2, 1, 1)) -> Dict[str, Any]:
    """One ``int8_ef`` train step over a ("pod", "data", "model") mesh
    (its new params, this pod's residual and its int8 scales), the
    uncompressed step on the whole batch beside it, and the ``int8_ef``
    step again with a planted fault: a ring that skips the peer
    (``compat.ppermute`` returns this pod's own payload), so each pod
    trains on its half of the batch alone."""
    from unittest import mock

    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import compression
    mesh = make_mesh(shape, ("pod", "data", "model"))
    model = smoke_model()
    params = params_from_numpy(params_np, device)
    opt = adamw.init(params, model.cfg.moment_dtype)
    batch = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in batch_np.items()}
    kw = dict(total_steps=10, warmup_steps=1)
    p0, _, m0 = build_train_step(model, TrainConfig(**kw))(params, opt,
                                                           batch)
    step1 = build_train_step(model, TrainConfig(grad_compression="int8_ef",
                                                **kw))
    scales = []
    real_compress = compression.compress

    def compress(grads, residual):          # keeps this pod's scales
        out = real_compress(grads, residual)
        scales.extend(float(s) for s in adamw.tree_leaves(out[1]))
        return out
    with compat.mesh_context(mesh):
        with mock.patch.object(compression, "compress", compress):
            p1, _, r1, m1 = step1(params, opt, batch,
                                  compression.init_residual(params))
        with mock.patch.object(compat, "ppermute",
                               lambda x, axis, perm: x):
            pf = step1(params, opt, batch,
                       compression.init_residual(params))[0]
    return dict(rank=rank, l0=float(m0["loss"]), l1=float(m1["loss"]),
                abs_diff=max(float((a - b).abs().max()) for a, b in zip(
                    adamw.tree_leaves(p0), adamw.tree_leaves(p1))),
                params=_to_np(p1), residual=_to_np(r1), scales=scales,
                skip_peer_params=_to_np(pf))


def suite_rank(rank: int, device, shape: Sequence[int], *,
               params_np=None, batch_np=None) -> Dict[str, Any]:
    """The workload; with ``params_np`` and ``batch_np`` (a world of 2)
    also the DP train step with every probe (``inline="off_all"``) and
    the int8-EF step. One spawn for the lot."""
    out = dict(workload=workload_rank(rank, device, shape))
    if params_np is not None:
        out["dp"] = dp_train_rank(rank, device, shape, params_np, batch_np,
                                  max_probes=500, inline="off_all")
        out["int8"] = int8_rank(rank, device, params_np, batch_np)
    return out


def failing_rank(rank: int, device) -> None:
    """Rank 1 raises; rank 0 waits at a barrier that never completes
    (``spawn`` must report rank 1's traceback, not hang)."""
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("planted failure on rank 1")
    dist.barrier()


_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute", "collective-permute int8")


def collective_rank(rank: int, device, kind: str) -> str:
    """One ``compat`` collective of ``kind`` over a world of 2 on
    ``device``'s tensors."""
    mesh = make_mesh((2,), ("dev",))
    x = torch.arange(8.0, device=device).reshape(4, 2) + rank
    with compat.mesh_context(mesh, device):
        if kind == "all-reduce":
            y = compat.psum(x, "dev")
        elif kind == "all-gather":
            y = compat.all_gather(x, "dev")
        elif kind == "reduce-scatter":
            y = compat.psum_scatter(x, "dev")
        elif kind == "all-to-all":
            y = compat.all_to_all(x, "dev")
        else:
            y = compat.ppermute(x.to(torch.int8) if "int8" in kind else x,
                                "dev", [(0, 1), (1, 0)])
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
    return "ok"


def backend_collectives(device, backend: str = "gloo") -> Dict[str, str]:
    """Which collective kinds ``backend`` runs on ``device``'s tensors:
    "ok", or how its ranks failed (a crash included: each kind runs in a
    world of its own, the worlds side by side)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn

    def run(kind):
        try:
            return spawn(collective_rank, (2,), backend=backend,
                         device=str(device), args=(kind,), timeout=60)[0]
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            return " | ".join(lines[:1] + [ln.strip() for ln in lines
                                           if "Fatal" in ln][:1])[:300]
    with ThreadPoolExecutor(len(_KINDS)) as pool:
        return dict(zip(_KINDS, pool.map(run, _KINDS)))


def serve_rank(rank: int, device, kw) -> Dict[str, Any]:
    """One rank of ``launch.serve.serve`` with ``profile_mesh``: the
    token ids, this rank's kernel launches (its prefill) and the mesh
    session's final record."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import serve
    shape = kw["profile_mesh"]
    fa.flash_attention.launches = pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    res = serve(**kw, device=device,
                _mesh=make_mesh(shape, probe_axis_names(shape)))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    snap = res.snapshot
    return dict(rank=rank, tokens=res.tokens, seconds=res.seconds,
                capture_s=res.stats["capture_s"],
                wall_s=time.perf_counter() - t0,
                launches=dict(flash=fa.flash_attention.launches,
                              paged=pa.paged_attention.launches),
                steps=snap.steps, record=_record_dict(snap.record),
                skew=snap.record.skew().tolist(),
                state_nbytes=snap.state_nbytes)


def allreduce_ms(device, head_dim: int = 64, reps: int = 5) -> float:
    """Per-rank wall (ms, host clock, synced) of one all-reduce-mean of
    every gradient leaf of the smoke tinyllama (``head_dim``) over the
    world: the DP step's ``grad_exchange`` alone."""
    mesh = make_mesh((2,), ("dev",))
    model = smoke_model("bfloat16", head_dim=head_dim)
    leaves = adamw.tree_leaves(model.init(0, device))
    with compat.mesh_context(mesh, device):
        times = []
        for _ in range(reps + 1):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for g in leaves:
                compat.pmean(g, "dev")
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times[1:]))


def card_world2_rank(rank: int, device, batch_np, serve_kw
                     ) -> Dict[str, Any]:
    """Two ranks sharing one card over gloo: the skew workload, the DP
    train step at smoke width with head dim 64 (the kernels' narrowest),
    each with its checks (the DP step's flash launches are its probed
    call's), one all-reduce-mean of the DP step's gradients timed, then
    ``serve_rank(serve_kw)``: one spawn, so one process start a rank."""
    out = dict(workload=workload_rank(rank, device, (2,)),
               allreduce_ms=allreduce_ms(device, head_dim=64))
    out["dp"] = dp_train_rank(rank, device, (2,), None, batch_np,
                              head_dim=64, compute_dtype="bfloat16")
    out["serve"] = serve_rank(rank, device, serve_kw)
    return out
