"""Serving entry point, routed through the continuous-batching engine.

Port of ``repro.launch.serve`` (engine path and the legacy unbatched
loop). Each batch row becomes one request of the engine; decode runs at
a batch bucket over the paged KV pool (the dense and MoE families).
``--no-engine`` runs the legacy lock-step loop (``build_prefill_step`` +
``build_decode_step`` over a dense cache, as JAX's), which the ssm and hybrid
families and the archs with a modality frontend always take; a frontend
arch's prompt and each decode step's input are synthetic embeddings
(``models.frontends.synth_frontend_batch``, seed 1), as the JAX serve's.
The model runs on the GPU unless ``device="cpu"`` is passed.

``--profile`` probes the serve: on the engine path every (phase, shape)
step runs in a ``ProbeSession`` and the phase, chunk and request cycle
bills are printed; on the legacy path the decode loop runs under a
``ProbeSession``, with a ``[probe] decode step N`` line every
``--profile-every`` steps and the session's table and window bump chart
at the end. Token ids are those of the unprofiled serve.
``--status-port P`` serves the live telemetry (bus, drift sentinel,
HTTP status server; 0 = any free port, the URL is printed).

``--mesh 2`` (or ``2x2``) forces the legacy loop, as in JAX; with
``--profile`` its decode step runs per device: one rank a device
(``launch.mesh.spawn``: NCCL on the cards, gloo with ``--device cpu``),
each with the whole prefill and, under a ``MeshProbeSession`` (source
``serve/mesh``), the decode step on its share of the batch and of every
cache leaf's batch dimension. Rank 0 prints the ``[probe]`` lines, the
session table, the per-device table and the straggler heat view.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 2 --max-new 8
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core import ProbeConfig, ProbeSession
from repro_torch.distributed.steps import (build_decode_step,
                                           build_prefill_step)
from repro_torch.engine import EngineConfig, InferenceEngine, engine_compatible
from repro_torch.models.frontends import synth_frontend_batch
from repro_torch.models.model import Model


@dataclass
class ServeResult:
    tokens: np.ndarray                # (batch, max_new) int32 token ids
    first_logits: torch.Tensor        # (batch, V) f32, first sampled step
    seconds: float                    # submit to last token (host clock)
    stats: Dict[str, Any] = field(default_factory=dict)  # engine's; the
                                      # profiled legacy loop's capture_s
    snapshot: Optional[Any] = None    # profiled legacy loop: a
                                      # StreamSnapshot (MeshSnapshot)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine_serve(model, params, prompts, *, max_new: int,
                  engine_kernel: bool, prefill_chunk: int = 0,
                  profile: bool = False,
                  profile_targets: Tuple[str, ...] = ("",),
                  profile_max_probes: int = 16, bus=None) -> ServeResult:
    """Serve every prompt row as one request (decode bucketed at the batch
    size)."""
    batch, prompt_len = prompts.shape
    page = 16
    max_pages = max(1, math.ceil((prompt_len + max_new - 1) / page))
    eng = InferenceEngine(model, params, EngineConfig(
        page_size=page, pool_pages=batch * max_pages + 2,
        max_pages=max_pages,
        buckets=(1, batch) if batch > 1 else (1,),
        use_kernel=engine_kernel, probe=profile,
        probe_targets=profile_targets, probe_max_probes=profile_max_probes,
        prefill_chunk_pages=prefill_chunk), bus=bus)
    _sync(eng.device)
    t0 = time.perf_counter()
    for b in range(batch):
        eng.submit(prompts[b].tolist(), max_new)
    done = eng.run()
    _sync(eng.device)
    seconds = time.perf_counter() - t0
    st = eng.stats()
    print(f"engine: {batch} requests x {max_new} tokens in "
          f"{seconds * 1e3:.1f} ms (pages peak {st['pages_peak']}, "
          f"retraces {st['retraces']})")
    if profile:
        print("\n# per-phase cycle attribution")
        print(eng.phase_table())
        if prefill_chunk:
            print("\n# per-chunk-shape prefill bill")
            print(eng.chunk_table())
        print("\n# per-request phase bill")
        print(eng.request_table(done))
    eng.drain()
    eng.close()
    return ServeResult(np.array([r.out_tokens for r in done], np.int32),
                       torch.stack([r.first_logits for r in done]),
                       seconds, st)


def _mesh_decode_session(model, mesh, cache, frontend: bool, targets,
                         max_probes: int, window_steps: int, device,
                         bus=None):
    """Mesh-probed decode: the batch and every cache leaf's batch
    dimension (dim 1 of each) split over the mesh, so the live session
    records one cycle-counter row a device."""
    from repro_torch.core import MeshProbeSession, mesh_probe
    from repro_torch.distributed.compat import P
    axes = tuple(mesh.mesh_dim_names)
    cache_spec = {k: P(None, axes) for k in cache}
    batch_spec = {"embeds" if frontend else "tokens": P(axes), "pos": P()}
    return MeshProbeSession(
        mesh_probe(build_decode_step(model), mesh,
                   in_specs=(P(), cache_spec, batch_spec),
                   out_specs=(P(axes), cache_spec, P(axes)),
                   config=ProbeConfig(targets=targets,
                                      max_probes=max_probes),
                   device=device),
        window_steps=window_steps, bus=bus, source="serve/mesh")


def _legacy_serve(model, params, prompts, *, max_new: int, device,
                  profile: bool = False,
                  profile_targets: Tuple[str, ...] = ("",),
                  profile_every: int = 8, profile_max_probes: int = 16,
                  bus=None, mesh=None) -> ServeResult:
    """The unbatched lock-step loop: one prefill over the whole batch,
    then one decode step per token against a dense cache (under a live
    ``ProbeSession`` when profiled). A frontend arch takes synthetic
    embeddings (bf16, from a generator seeded 1 on ``device``) for the
    prompt and for each step, as the JAX loop does; its sampled ids feed
    nothing back."""
    batch, prompt_len = prompts.shape
    cfg = model.cfg
    say = print if mesh is None or mesh.get_rank() == 0 else \
        (lambda *a, **k: None)
    cparams = model._compute_cast(params)   # one compute-dtype copy
    tokens = torch.as_tensor(prompts, device=device)
    gen = None
    if cfg.frontend != "none":
        gen = torch.Generator(device=device).manual_seed(1)
        pbatch = synth_frontend_batch(cfg, batch, prompt_len,
                                      torch.bfloat16, gen)
    else:
        pbatch = {"tokens": tokens}
    profile_every = max(profile_every, 1)
    session = None
    decode = build_decode_step(model)
    prefill = build_prefill_step(model, ShapeConfig(
        "pf", prompt_len + max_new - 1, batch, "prefill"))
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cparams, pbatch)
    if profile and mesh is not None:
        session = _mesh_decode_session(
            model, mesh, cache, gen is not None, profile_targets,
            profile_max_probes, profile_every, device, bus=bus)
        decode = session.step
    elif profile:
        session = ProbeSession(
            decode,
            ProbeConfig(targets=profile_targets, offload=1.0,
                        max_probes=profile_max_probes),
            window_steps=profile_every, bus=bus, source="serve/decode",
            device=device)
        decode = session.step
    first = logits
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [next_tok]
    for i in range(max_new - 1):
        if gen is not None:
            dbatch = {"embeds": synth_frontend_batch(
                cfg, batch, 1, torch.bfloat16, gen)["embeds"]}
        else:
            dbatch = {"tokens": next_tok[:, None]}
        dbatch["pos"] = prompt_len + i
        logits, cache, next_tok = decode(cparams, cache, dbatch)
        out.append(next_tok)
        if session is not None and session.steps % profile_every == 0:
            snap = session.snapshot()
            if mesh is not None:
                d, p = snap.record.straggler()
                say(f"[probe] decode step {session.steps:4d}: "
                    f"span(max)={snap.span} cycles over "
                    f"{snap.record.n_devices} devices, "
                    f"straggler=dev{d}:{p} "
                    f"(skew {int(snap.record.skew().max(initial=0))})",
                    flush=True)
                continue
            hot = snap.bottleneck()
            hot_s = (f"{hot.path} (ema {hot.ema:.1f} cyc/call)"
                     if hot else "-")
            say(f"[probe] decode step {session.steps:4d}: "
                f"span={snap.span} cycles, state={snap.state_nbytes}B, "
                f"hot={hot_s}", flush=True)
    toks = torch.stack(out, dim=1).cpu().numpy()
    seconds = time.perf_counter() - t0
    say(f"prefill {prompt_len} tokens x{batch} + decode {max_new} steps: "
        f"{seconds * 1e3:.1f} ms")
    final = session.close() if session is not None else None
    stats = {}
    if session is not None:
        pf = session.mpf if mesh is not None else session.pf
        stats["capture_s"] = pf.capture_seconds
    if final is not None:
        say("\n# streaming probe telemetry (decode loop)")
        say(final.table())
        if mesh is not None:
            say("\n# per-device cycle records")
            say(final.device_table())
            say("\n# straggler heat view")
            say(final.heat())
        else:
            say("\n# bottleneck drift across windows")
            say(final.bump_chart())
    return ServeResult(toks, first, seconds, stats, snapshot=final)


def serve(arch: str = "tinyllama-1.1b", *, smoke: bool = True,
          batch: int = 4, prompt_len: int = 32, max_new: int = 16,
          engine: bool | None = None, engine_kernel: bool = False,
          prefill_chunk: int = 0, profile: bool = False,
          profile_targets: Tuple[str, ...] = ("",), profile_every: int = 8,
          profile_max_probes: int = 16, status_port: Optional[int] = None,
          autotune: bool = False, tune_cache: Optional[str] = None,
          layers: Optional[int] = None, device=None,
          profile_mesh: Tuple[int, ...] = (), _mesh=None) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens, ``max_new``
    tokens each, with random weights from seed 0 (prompts from seed 1).
    ``layers`` cuts the config's depth (its widths stay), for a model
    whose full depth does not fit the card.
    ``profile`` probes the serve; ``status_port`` (0 = any free port)
    serves its live telemetry while it runs. ``autotune`` loads the
    DSE-tuned kernel configs of this device from the eval cache
    (``tune_cache``, default ``.repro_cache/dse``) into
    ``kernels.tuning`` first, as ``python -m repro_torch.tune`` left
    them. ``profile_mesh`` (with ``profile``) probes the legacy decode
    per device on one rank a device (NCCL on cuda, gloo on the CPU);
    rank 0's result comes back."""
    device = resolve_device(device)
    if profile and profile_mesh and _mesh is None and engine is not True:
        import repro_torch.launch.serve as mod
        from repro_torch.launch.mesh import spawn
        kw = dict(arch=arch, smoke=smoke, batch=batch,
                  prompt_len=prompt_len, max_new=max_new, engine=False,
                  profile=True, profile_targets=profile_targets,
                  profile_every=profile_every,
                  profile_max_probes=profile_max_probes,
                  status_port=status_port, autotune=autotune,
                  tune_cache=tune_cache, layers=layers,
                  profile_mesh=tuple(profile_mesh))
        return spawn(mod._serve_rank, profile_mesh, device=str(device),
                     args=(kw,))[0]
    if autotune:
        from repro_torch.core.incremental import device_kind
        from repro_torch.kernels import tuning
        tuning.load_cache(cache_dir=tune_cache, device=device_kind(device),
                          verbose=True)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    model = Model(cfg)
    params = model.init(0, device)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, dtype=torch.int32).numpy()
    if engine is None:
        engine = engine_compatible(cfg) and not profile_mesh
    plane = None
    if status_port is not None and (_mesh is None or _mesh.get_rank() == 0):
        from repro_torch.telemetry import ControlPlane
        plane = ControlPlane(status_port).start()
    bus = plane.bus if plane is not None else None
    prof = dict(profile=profile, profile_targets=profile_targets,
                profile_max_probes=profile_max_probes, bus=bus)
    try:
        if engine:
            return _engine_serve(model, params, prompts, max_new=max_new,
                                 engine_kernel=engine_kernel,
                                 prefill_chunk=prefill_chunk, **prof)
        return _legacy_serve(model, params, prompts, max_new=max_new,
                             device=device, profile_every=profile_every,
                             mesh=_mesh, **prof)
    finally:
        if plane is not None:
            plane.finish()


def _serve_rank(rank: int, device, kw) -> Optional[ServeResult]:
    """One rank of a mesh-profiled legacy serve (``launch.mesh.spawn``);
    rank 0 returns its result, on the CPU."""
    from repro_torch.launch.mesh import make_mesh, probe_axis_names
    shape = kw["profile_mesh"]
    res = serve(**kw, device=device,
                _mesh=make_mesh(shape, probe_axis_names(shape)))
    if rank:
        return None
    res.first_logits = res.first_logits.cpu()
    return res


def main():
    from repro_torch.launch.mesh import parse_mesh_arg
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the smoke config, "
                         "whose head dim 16 the CUDA kernels do not take)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers "
                         "(widths kept)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "the plain versions of the kernels)")
    ap.add_argument("--no-engine", action="store_true",
                    help="force the legacy lock-step loop instead of the "
                         "continuous-batching engine")
    ap.add_argument("--engine-kernel", action="store_true",
                    help="decode through the paged-attention CUDA kernel")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk quantum in pages (0 = whole-prompt "
                         "prefill; >0 interleaves prefill chunks with "
                         "decode rounds)")
    ap.add_argument("--profile", action="store_true",
                    help="probe the serve: per-phase and per-request cycle "
                         "bills (engine), or the decode loop under a live "
                         "ProbeSession (legacy loop)")
    ap.add_argument("--mesh", default=None,
                    help="profile the legacy decode per device on an N-way "
                         "mesh, e.g. '2' or '2x2' (with --profile; batch "
                         "must divide the mesh size): one rank a device, "
                         "NCCL on the cards, gloo with --device cpu")
    ap.add_argument("--profile-targets", default="",
                    help="comma-separated probe subtree roots")
    ap.add_argument("--profile-every", type=int, default=8)
    ap.add_argument("--status-port", type=int, default=None,
                    help="expose live telemetry over HTTP on this port "
                         "(0 = OS-assigned; prints the bound URL)")
    ap.add_argument("--autotune", action="store_true",
                    help="load DSE-tuned kernel configs from the eval cache")
    ap.add_argument("--tune-cache", default=None,
                    help="eval cache dir (default .repro_cache/dse)")
    args = ap.parse_args()
    res = serve(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, max_new=args.max_new,
                engine=False if args.no_engine else None,
                engine_kernel=args.engine_kernel,
                prefill_chunk=args.prefill_chunk, profile=args.profile,
                profile_targets=tuple(args.profile_targets.split(",")),
                profile_every=args.profile_every,
                status_port=args.status_port, autotune=args.autotune,
                tune_cache=args.tune_cache, layers=args.layers,
                device=args.device, profile_mesh=parse_mesh_arg(args.mesh))
    print("sampled token ids (first sequence):", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
