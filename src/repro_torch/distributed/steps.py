"""Train, eval, prefill and decode step builders.

Port of ``repro.distributed.steps``: ``build_train_step``,
``build_eval_step``, ``build_prefill_step`` and ``build_decode_step``,
and the per-shard bodies ``build_dp_train_step`` /
``build_dp_eval_step``. Under active sharding rules
(``sharding.axis_rules`` with a mesh, params placed by
``sharding.distribute_params``) the same builders run auto-sharded: the
params, moments and activations are DTensors and each rank computes its
blocks. The steps are plain functions of (params,
opt_state, batch): ``value_and_grad`` becomes the forward under the
``loss`` scope and ``scope.grad`` (``torch.autograd.grad``, whose
backward a probe sees under ``loss~bwd``), and the optimizer update is
functional (``optim.adamw``), so a step writes nothing it was given and
a probe can run it as often as it likes. Gradient accumulation over
``TrainConfig.microbatches`` runs under ``microbatches`` / ``scope.scan``
as JAX's ``lax.scan`` does.

``grad_compression="int8_ef"`` (``train_step(params, opt_state, batch,
ef_residual)`` under a mesh with a ``pod`` axis): gradients stay
pod-local (``compat.shard_map`` over ``pod``, the batch split over it),
are quantized to int8 with per-tensor scales (``optim.compression``) and
ring-exchanged across pods (``compat.ppermute``) at 1 byte an element,
with the quantization error carried as error-feedback state. The
``data`` and ``model`` axes stay auto-sharded inside (DTensor placements
on the sub-mesh without ``pod``), as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import scope
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import P
from repro_torch.models.model import Model
from repro_torch.optim import adamw, compression
from repro_torch.optim.schedule import make_schedule


def _split_microbatches(batch: Dict[str, Any], k: int) -> Dict[str, Any]:
    def split(x):
        if x.dim() == 0:
            return x
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} % microbatches {k}")
        return shd.split_leading(x, k)
    return {key: split(v) for key, v in batch.items()}


def _leaves_requiring_grad(params):
    """Fresh leaves over the params' storage (no copy), so the gradient
    is taken with respect to exactly these tensors."""
    return adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.loss_fn`` under the ``loss``
    scope, the gradient by ``scope.grad``."""
    leaves = _leaves_requiring_grad(params)
    flat = adamw.tree_leaves(leaves)
    extra = []
    if "embeds" in batch:
        # a frontend's embeddings: their gradient is taken and dropped, so
        # the first layer's backward computes what every later layer's
        # does (JAX's transposed layer scan carries the cotangent through
        # every iteration alike)
        batch = dict(batch, embeds=batch["embeds"].detach()
                     .requires_grad_(True))
        extra = [batch["embeds"]]
    with torch.enable_grad():
        with scope.named_scope("loss"):
            loss, metrics = model.loss_fn(leaves, batch)
        grads = scope.grad(loss, flat + extra)[:len(flat)]
    # a DTensor's gradient comes out as its backward placed it: give it
    # its param's placements (JAX's gradients carry the params' sharding)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if shd.is_dtensor(p) and tuple(g.placements) != p.placements
             else g for g, p in zip(grads, flat)]
    return (loss.detach(), {n: m.detach() for n, m in metrics.items()},
            adamw.tree_unflatten(params, list(grads)))


def build_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch[, ef_residual]) ->
    (params, opt_state[, ef_residual], metrics)``; new params and state,
    the old left as they were. ``metrics`` holds 0-d tensors: loss, nll
    (and z_loss, aux_loss without microbatches), lr, grad_norm. With
    ``grad_compression="int8_ef"`` and an ``ef_residual``
    (``compression.init_residual``) the step runs under the ambient mesh
    (``compat.mesh_context``), whose ``pod`` axis carries the int8 ring."""
    if tcfg.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}")
    cfg = model.cfg
    schedule = make_schedule(cfg.schedule, tcfg)
    k = tcfg.microbatches

    def value_and_grad(params, batch):
        return _value_and_grad(model, params, batch)

    def grads_of(params, batch):
        if k == 1:
            return value_and_grad(params, batch)
        mrope = cfg.pos_emb == "mrope" and "positions" in batch
        if mrope:       # (3, B, S) -> (B, 3, S): split on the batch dim
            batch = dict(batch, positions=batch["positions"].movedim(0, 1))
        mb = _split_microbatches(batch, k)
        acc_dt = getattr(torch, cfg.grad_accum_dtype)
        # a DTensor's accumulator is placed as its param (each rank its
        # block), as JAX's zeros take the params' sharding
        gsum = adamw.tree_map(lambda p: compat.zeros_like(p, acc_dt), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=adamw.tree_leaves(params)[0].device)
        with scope.named_scope("microbatches"):
            for i in scope.scan(k, same_shapes=True):
                micro = {key: v[i] for key, v in mb.items()}
                if mrope:                        # back to (3, B / k, S)
                    micro["positions"] = micro["positions"].movedim(1, 0)
                loss, _, g = value_and_grad(params, micro)
                gsum = adamw.tree_unflatten(gsum, [
                    a + b.to(acc_dt) for a, b in zip(adamw.tree_leaves(gsum),
                                                     adamw.tree_leaves(g))])
                loss_sum = loss_sum + loss
        grads = adamw.tree_map(lambda g: g / k, gsum)
        loss = loss_sum / k
        return loss, {"nll": loss}, grads

    def compressed_grads_of(params, batch, residual):
        """Pod-local grads + int8 error-feedback ring exchange over the
        pod axis."""
        env = compat.current()
        if env is None or "pod" not in env.axes:
            raise RuntimeError("grad_compression='int8_ef' runs under a "
                               "mesh with a 'pod' axis (compat.mesh_context)")
        n_pods = env.sizes["pod"]
        perm = [(i, (i + 1) % n_pods) for i in range(n_pods)]

        def pod_local(params_, batch_, res_):
            loss, metrics, grads = grads_of(params_, batch_)
            with scope.named_scope("grad_compress"):
                payload, scales, new_res = compression.compress(grads, res_)

                def xchg(q8, s):
                    total = q8.to(torch.float32) * s
                    q_rot, s_rot = q8, s
                    for _ in range(n_pods - 1):     # int8 on the wire
                        q_rot = compat.ppermute(q_rot, "pod", perm)
                        s_rot = compat.ppermute(s_rot, "pod", perm)
                        total = total + q_rot.to(torch.float32) * s_rot
                    return total / n_pods

                grads = adamw.tree_unflatten(payload, [
                    xchg(q, sc) for q, sc in zip(adamw.tree_leaves(payload),
                                                 adamw.tree_leaves(scales))])
            loss = compat.pmean(loss, "pod")
            metrics = {n: compat.pmean(m, "pod") for n, m in metrics.items()}
            return loss, metrics, grads, new_res

        def batch_spec(x):
            if x.dim() == 0:
                return P()
            if cfg.pos_emb == "mrope" and x.dim() == 3 and x.shape[0] == 3:
                return P(None, "pod")
            return P("pod")

        specs = {key: batch_spec(v) for key, v in batch.items()}
        return compat.shard_map(
            pod_local, mesh=env, in_specs=(P(), specs, P()), out_specs=P(),
            axis_names={"pod"})(params, batch, residual)

    def train_step(params, opt_state, batch, ef_residual=None):
        if ef_residual is not None and tcfg.grad_compression == "int8_ef":
            loss, metrics, grads, ef_residual = compressed_grads_of(
                params, batch, ef_residual)
        else:
            loss, metrics, grads = grads_of(params, batch)
        with scope.named_scope("optimizer"):
            params, opt_state, om = adamw.update(params, grads, opt_state,
                                                 tcfg, schedule)
        metrics = dict(metrics)
        metrics.update(loss=loss, **om)
        if ef_residual is not None:
            return params, opt_state, ef_residual, metrics
        return params, opt_state, metrics

    return train_step


def build_prefill_step(model: Model, shape: ShapeConfig) -> Callable:
    """Returns ``prefill_step(params, batch) -> (logits, cache)`` with a
    cache of ``shape.seq_len``. ``cfg.prefill_microbatches`` = k > 1 runs
    the batch in k chunks under ``scope.scan`` (JAX's ``lax.map``): the
    forward's activations scale with B / k, each chunk's GEMMs run at
    M = B / k x S, and the logits and cache equal the whole batch's."""
    k = model.cfg.prefill_microbatches

    def prefill_step(params, batch):
        if k == 1:
            with scope.named_scope("prefill"):
                return model.prefill(params, batch, shape.seq_len)

        def split(key, v):
            if key == "positions" and v.dim() == 3 and v.shape[0] == 3:
                b = v.shape[1]
                return v.reshape(3, k, b // k, v.shape[2]).movedim(1, 0)
            return v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))

        def respec(key, v):      # keep the chunks data-sharded
            if key == "positions" and v.dim() == 4:
                return shd.shard(v, None, None, "batch", "seq")
            if v.dim() == 3:
                return shd.shard(v, None, "batch", "seq")
            return v

        mb = {key: respec(key, split(key, v)) for key, v in batch.items()}
        logits, caches = [], []
        for i in scope.scan(k):
            with scope.named_scope("prefill_chunk"):
                lg, cache = model.prefill(
                    params, {key: v[i] for key, v in mb.items()},
                    shape.seq_len)
            logits.append(lg)
            caches.append(cache)
        # cache leaves: (L, B / k, ...) a chunk -> (L, B, ...)
        return torch.cat(logits, dim=0), {
            key: torch.cat([c[key] for c in caches], dim=1)
            for key in caches[0]}

    return prefill_step


def build_decode_step(model: Model) -> Callable:
    """Returns ``decode_step(params, cache, batch) -> (logits, cache,
    next_token)``: ``Model.decode_step`` under the ``decode`` scope."""
    def decode_step(params, cache, batch):
        with scope.named_scope("decode"):
            return model.decode_step(params, cache, batch)
    return decode_step


def build_eval_step(model: Model) -> Callable:
    """Forward-only eval step (loss + metrics, no optimizer)."""
    def eval_step(params, batch):
        with torch.no_grad(), scope.named_scope("eval"):
            loss, metrics = model.loss_fn(params, batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return loss, metrics
    return eval_step


# ---------------------------------------------------- per-shard bodies
#
# Explicit-collective SPMD bodies for ``compat.shard_map`` and therefore
# for ``core.mesh_probe``, which records a per-device cycle row for every
# probe inside them. Parameters and optimizer state are replicated, the
# batch is sharded over ``axis`` (pure data parallelism), and the
# gradient exchange is an explicit all-reduce-mean (``compat.pmean``)
# that the probe attributes to the "grad_exchange" scope (ring wire-byte
# model; see launch/collectives.py).

def _pmean_tree(tree, axis):
    return adamw.tree_map(lambda x: compat.pmean(x, axis), tree)


def build_dp_train_step(model: Model, tcfg: TrainConfig,
                        axis="dev") -> Callable:
    """Data-parallel per-shard train step: grads_local -> all-reduce-mean
    over ``axis`` -> replicated AdamW update. Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with every output replicated."""
    schedule = make_schedule(model.cfg.schedule, tcfg)

    def train_step(params, opt_state, batch):
        with scope.named_scope("grads"):
            loss, metrics, grads = _value_and_grad(model, params, batch)
        with scope.named_scope("grad_exchange"):
            grads = _pmean_tree(grads, axis)
            loss = compat.pmean(loss, axis)
            metrics = _pmean_tree(metrics, axis)
        with scope.named_scope("optimizer"):
            params, opt_state, om = adamw.update(params, grads, opt_state,
                                                 tcfg, schedule)
        metrics = dict(metrics)
        metrics.update(loss=loss, **om)
        return params, opt_state, metrics

    return train_step


def build_dp_eval_step(model: Model, axis="dev") -> Callable:
    """Data-parallel per-shard eval step (loss all-reduce-meaned over
    ``axis``)."""
    base = build_eval_step(model)

    def eval_step(params, batch):
        loss, metrics = base(params, batch)
        with scope.named_scope("loss_exchange"):
            loss = compat.pmean(loss, axis)
            metrics = _pmean_tree(metrics, axis)
        return loss, metrics

    return eval_step
