"""End-to-end trainer (port of ``repro.launch.train``).

``--probe`` runs the whole loop under a streaming ``ProbeSession``
(every probe spilling, 16 probes, the JAX trainer's settings) and prints
a ``[probe]`` snapshot every ``--probe-every`` steps (default: the log
period), then the final table and bump chart. Checkpoints are the JAX
package's format (``checkpoint.Checkpointer``): atomic, async, with the
data pipeline's step for exactly-once resumption. The model runs on the
GPU unless ``device="cpu"`` (``--device cpu``) is passed; with no GPU
it raises.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --batch 2 --seq 32

Every arch of the registry trains (``--arch``): the dense, MoE (the
aux loss in the loss), ssm and hybrid families (the plain SSD path in
PyTorch ops, as the JAX package's training). An arch with a modality
frontend trains on synthetic embeddings (``models.frontends``, from a
generator seeded ``tcfg.seed``) in place of the pipeline's tokens, with
the pipeline's labels.

``--autotune`` loads the DSE-tuned kernel configs of the device from the
eval cache (``--tune-cache``, default ``.repro_cache/dse``; written by
``python -m repro_torch.tune``) before the model is built, as the JAX
trainer does.

``--mesh 2`` (or ``2x2``, with ``--probe``) probes per device: one rank
a device (``launch.mesh.spawn``: NCCL on the cards, gloo with
``--device cpu``), each running ``build_dp_train_step`` on its share of
the global batch under a ``MeshProbeSession`` (source ``train/mesh``);
rank 0 prints the mesh-session snapshots, then the per-device table and
the straggler heat view.

``train(mesh_shape=(2, 2))`` runs the auto-sharded step, as JAX's
``mesh_shape`` does: one rank a device (``launch.mesh.spawn``), the
mesh's axes ``data, model`` (``data`` for one dim, ``pod, data,
model`` for three), params and moments DTensors placed
by ``TRAIN_RULES`` (``distributed.sharding``), every rank fed the whole
global batch. Checkpoints gather each DTensor leaf whole before rank 0
saves it; rank 0's (params, opt_state, losses) come back. ``--mesh``
without ``--probe`` raises: JAX's CLI silently runs one device there.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2 --batch 2 --seq 32 --probe --mesh 2
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.steps import build_train_step
from repro_torch.models.frontends import synth_frontend_batch
from repro_torch.models.model import Model
from repro_torch.optim import adamw


def train(arch: str = "tinyllama-1.1b", *, smoke: bool = True,
          steps: int = 20, batch: int = 8, seq: int = 128,
          mesh_shape=None, probe_targets: Optional[tuple] = None,
          probe_mesh: Optional[tuple] = None,
          checkpoint_dir: Optional[str] = None, resume: bool = False,
          tcfg: Optional[TrainConfig] = None, log_every: int = 10,
          probe_every: int = 0, autotune: bool = False,
          tune_cache: Optional[str] = None,
          status_port: Optional[int] = None, device=None, _mesh=None):
    """Train ``arch`` for ``steps`` steps; returns (params, opt_state,
    losses). Parameters come from ``Model.init(tcfg.seed)``, batches
    from ``TokenPipeline`` (seed ``tcfg.seed``). With ``probe_targets``
    and ``probe_mesh`` the step runs data-parallel on one rank a device
    (NCCL on cuda, gloo on the CPU); rank 0's (params, opt_state,
    losses) come back, on the CPU."""
    if probe_mesh and probe_targets is None:
        raise NotImplementedError(
            "--mesh without --probe: JAX's CLI silently trains on one "
            "device there; the port refuses (ROADMAP Queue 3). --mesh with "
            "--probe probes the data-parallel step per device; the "
            "auto-sharded step is train(mesh_shape=...)")
    if mesh_shape and (probe_mesh or probe_targets is not None):
        raise ValueError("mesh_shape runs the auto-sharded step unprobed; "
                         "probe per device with probe_mesh")
    if mesh_shape and _mesh is None:
        import repro_torch.launch.train as mod
        from repro_torch.launch.mesh import spawn
        shape, axes = _mesh_shape_axes(mesh_shape)
        kw = dict(arch=arch, smoke=smoke, steps=steps, batch=batch,
                  seq=seq, checkpoint_dir=checkpoint_dir, resume=resume,
                  tcfg=tcfg, log_every=log_every, autotune=autotune,
                  tune_cache=tune_cache, status_port=status_port)
        return spawn(mod._train_sharded_rank, shape,
                     device=str(resolve_device(device)),
                     args=(kw, shape, axes))[0]
    if probe_mesh and _mesh is None:
        import repro_torch.launch.train as mod
        from repro_torch.launch.mesh import spawn
        kw = dict(arch=arch, smoke=smoke, steps=steps, batch=batch,
                  seq=seq, probe_targets=probe_targets,
                  probe_mesh=tuple(probe_mesh),
                  checkpoint_dir=checkpoint_dir, resume=resume, tcfg=tcfg,
                  log_every=log_every, probe_every=probe_every,
                  autotune=autotune, tune_cache=tune_cache,
                  status_port=status_port)
        dev = resolve_device(device)
        return spawn(mod._train_rank, probe_mesh, device=str(dev),
                     args=(kw,))[0]
    dev = resolve_device(device)
    if autotune:
        from repro_torch.core.incremental import device_kind
        from repro_torch.kernels import tuning
        tuning.load_cache(cache_dir=tune_cache, device=device_kind(dev),
                          verbose=True)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg)
    tcfg = tcfg or TrainConfig(
        total_steps=steps, warmup_steps=max(steps // 10, 1),
        checkpoint_dir=checkpoint_dir or os.path.join(
            tempfile.gettempdir(), "repro_ckpt"))

    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=tcfg.seed))
    params = model.init(tcfg.seed, device=dev)
    sharded = _mesh is not None and mesh_shape
    rules = shd.filter_rules(shd.TRAIN_RULES, _mesh) if sharded else None

    ckpt = None
    start_step = 0
    opt_state = None
    if checkpoint_dir:
        ckpt = Checkpointer(checkpoint_dir, keep=tcfg.keep_checkpoints,
                            async_save=tcfg.async_checkpoint)
        last = ckpt.latest()
        if resume and last is not None:
            (params, opt_state), extra = ckpt.restore(
                last, (params, adamw.init(params, cfg.moment_dtype)))
            start_step = int(extra["step"])
            pipe.state.step = int(extra["data_step"])
    if sharded:
        params = shd.distribute_params(params, model.schema(), _mesh, rules)
        if opt_state is not None:   # restored: the moments placed alike
            opt_state = opt_state._replace(
                mu=shd.distribute_params(opt_state.mu, model.schema(),
                                         _mesh, rules),
                nu=shd.distribute_params(opt_state.nu, model.schema(),
                                         _mesh, rules))
    if opt_state is None:
        opt_state = adamw.init(params, cfg.moment_dtype)

    step_fn = build_train_step(model, tcfg)
    rank0 = _mesh is None or _mesh.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    plane = None
    if status_port is not None and rank0:
        from repro_torch.telemetry import ControlPlane
        plane = ControlPlane(status_port).start()
    bus = plane.bus if plane is not None else None
    session = None
    if sharded:
        run = step_fn
    elif _mesh is not None:
        # mesh-aware probing: the data-parallel per-shard step, one
        # cycle-counter row a device
        from repro_torch.core import MeshProbeSession, ProbeConfig, mesh_probe
        from repro_torch.distributed.compat import P
        from repro_torch.distributed.steps import build_dp_train_step
        axes = tuple(_mesh.mesh_dim_names)
        dp_step = build_dp_train_step(
            model, tcfg, axis=axes[0] if len(axes) == 1 else axes)
        session = MeshProbeSession(
            mesh_probe(dp_step, _mesh, in_specs=(P(), P(), P(axes)),
                       out_specs=(P(), P(), P()),
                       config=ProbeConfig(targets=tuple(probe_targets),
                                          max_probes=16), device=dev),
            window_steps=max(probe_every or log_every, 1),
            bus=bus, source="train/mesh")
        run = session.step
    elif probe_targets is not None:
        from repro_torch.core import ProbeConfig, ProbeSession
        session = ProbeSession(
            step_fn, ProbeConfig(targets=tuple(probe_targets),
                                 offload=1.0, max_probes=16),
            window_steps=max(probe_every or log_every, 1),
            bus=bus, source="train/step", device=dev)
        run = session.step
    else:
        run = step_fn

    history = []
    gen = (torch.Generator(device=dev).manual_seed(tcfg.seed)
           if cfg.frontend != "none" else None)
    with compat.mesh_context(_mesh if sharded else None), \
            shd.axis_rules(rules, _mesh if sharded else None):
        t0 = time.time()
        for step in range(start_step, steps):
            batch_np = pipe.batch_at(step)
            pipe.state.step = step + 1
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_np.items()}
            if gen is not None:
                del b["tokens"]
                b.update(synth_frontend_batch(cfg, batch, seq,
                                              torch.bfloat16, gen))
            params, opt_state, metrics = run(params, opt_state, b)
            metrics = shd.gather(metrics)
            loss = float(metrics["loss"])
            history.append(loss)
            if step % log_every == 0 or step == steps - 1:
                dt = time.time() - t0
                say(f"step {step:5d} loss {loss:8.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):7.3f} "
                    f"({dt:.1f}s)", flush=True)
            if session is not None and \
                    session.steps % (probe_every or log_every) == 0:
                snap = session.snapshot()
                say(f"[probe] {snap.steps} steps, span={snap.span} "
                    f"cycles, state={snap.state_nbytes}B", flush=True)
                say(snap.table(), flush=True)
            if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
                _save(ckpt, rank0, step + 1, params, opt_state, pipe)
        if ckpt:
            _save(ckpt, rank0, steps, params, opt_state, pipe)
            if rank0:
                ckpt.wait()
    if session is not None:
        final = session.close()
        if final is not None:
            say("\n# final streaming probe telemetry")
            say(final.table())
            if _mesh is not None:
                say("\n# per-device cycle records")
                say(final.device_table())
                say("\n# straggler heat view")
                say(final.heat())
            else:
                say(final.bump_chart())
    if plane is not None:
        plane.finish()
    return params, opt_state, history


def _save(ckpt, rank0: bool, step: int, params, opt_state, pipe):
    """Every rank gathers the DTensor leaves whole; rank 0 saves."""
    whole = shd.gather((params, opt_state))
    if rank0:
        ckpt.save(step, whole, extra={"step": step,
                                      "data_step": pipe.state.step})


_MESH_AXES = {1: ("data",), 2: ("data", "model"),
              3: ("pod", "data", "model")}


def _mesh_shape_axes(mesh_shape):
    """``(2, 2)`` -> ((2, 2), ("data", "model")): the rule sets' axes."""
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) not in _MESH_AXES:
        raise ValueError(f"mesh_shape {shape}: 1 to 3 dims")
    return shape, _MESH_AXES[len(shape)]


def _train_sharded_rank(rank: int, device, kw, shape, axes):
    """One rank of an auto-sharded ``train`` (``launch.mesh.spawn``):
    rank 0 returns (params, opt_state, losses) gathered, on the CPU."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, axes)
    params, opt_state, history = train(**kw, mesh_shape=shape,
                                       device=device, _mesh=mesh)
    params, opt_state = shd.gather((params, opt_state))
    if rank:
        return None
    return _to_cpu(params), _to_cpu(opt_state), history


def _to_cpu(tree):
    from repro_torch.distributed import compat
    return compat.tree_unflatten(tree, [t.detach().cpu() for t in
                                        compat.tree_leaves(tree)])


def _train_rank(rank: int, device, kw):
    """One rank of a mesh-probed ``train`` (``launch.mesh.spawn``):
    rank 0 returns (params, opt_state, losses) on the CPU."""
    from repro_torch.launch.mesh import make_mesh, probe_axis_names
    shape = kw["probe_mesh"]
    mesh = make_mesh(shape, probe_axis_names(shape))
    params, opt_state, history = train(**kw, device=device, _mesh=mesh)
    if rank:
        return None
    return _to_cpu(params), _to_cpu(opt_state), history


def main():
    from repro_torch.launch.mesh import parse_mesh_arg
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the smoke config, "
                         "whose head dim 16 the CUDA kernel does not take)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "the plain versions of the kernels)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="profile the train step with a live ProbeSession")
    ap.add_argument("--mesh", default=None,
                    help="probe per device on an N-way mesh, e.g. '2' or "
                         "'2x2' (with --probe; batch must divide the mesh "
                         "size): one rank a device, NCCL on the cards, "
                         "gloo with --device cpu")
    ap.add_argument("--probe-targets", default="",
                    help="comma-separated probe subtree roots")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="snapshot period in steps (default: log-every)")
    ap.add_argument("--autotune", action="store_true",
                    help="load DSE-tuned kernel configs from the eval cache")
    ap.add_argument("--tune-cache", default=None,
                    help="eval cache dir (default .repro_cache/dse)")
    ap.add_argument("--status-port", type=int, default=None,
                    help="expose live telemetry over HTTP on this port "
                         "(0 = OS-assigned; prints the bound URL)")
    args = ap.parse_args()
    train(args.arch, smoke=not args.full, steps=args.steps,
          batch=args.batch, seq=args.seq,
          probe_targets=(tuple(args.probe_targets.split(","))
                         if args.probe else None),
          probe_mesh=parse_mesh_arg(args.mesh),
          probe_every=args.probe_every,
          checkpoint_dir=args.checkpoint_dir, resume=args.resume,
          autotune=args.autotune, tune_cache=args.tune_cache,
          status_port=args.status_port, device=args.device)


if __name__ == "__main__":
    main()
