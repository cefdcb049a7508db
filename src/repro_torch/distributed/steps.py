"""Train and eval step builders (one device).

Port of ``repro.distributed.steps``: ``build_train_step`` and
``build_eval_step``. The steps are plain functions of (params,
opt_state, batch): ``value_and_grad`` becomes the forward under the
``loss`` scope and ``scope.grad`` (``torch.autograd.grad``, whose
backward a probe sees under ``loss~bwd``), and the optimizer update is
functional (``optim.adamw``), so a step writes nothing it was given and
a probe can run it as often as it likes. Gradient accumulation over
``TrainConfig.microbatches`` runs under ``microbatches`` / ``scope.scan``
as JAX's ``lax.scan`` does.

Not ported: the sharded paths (``grad_compression="int8_ef"`` with its
pod-local exchange, and the per-shard ``build_dp_*`` steps) wait for the
multi-device item of ROADMAP Queue 1; ``build_prefill_step`` and
``build_decode_step`` are the engine's steps (``engine/step.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import scope
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import make_schedule


def _split_microbatches(batch: Dict[str, Any], k: int) -> Dict[str, Any]:
    def split(x):
        if x.dim() == 0:
            return x
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} % microbatches {k}")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))
    return {key: split(v) for key, v in batch.items()}


def _leaves_requiring_grad(params):
    """Fresh leaves over the params' storage (no copy), so the gradient
    is taken with respect to exactly these tensors."""
    return adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)


def build_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; new params and state, the old left as they
    were. ``metrics`` holds 0-d tensors: loss, nll (and z_loss, aux_loss
    without microbatches), lr, grad_norm."""
    if tcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} needs the "
            f"multi-device port (ROADMAP Queue 1) and optim/compression.py")
    cfg = model.cfg
    schedule = make_schedule(cfg.schedule, tcfg)
    k = tcfg.microbatches

    def value_and_grad(params, batch):
        leaves = _leaves_requiring_grad(params)
        flat = adamw.tree_leaves(leaves)
        extra = []
        if "embeds" in batch:
            # a frontend's embeddings: their gradient is taken and
            # dropped, so the first layer's backward computes what every
            # later layer's does (JAX's transposed layer scan carries the
            # cotangent through every iteration alike)
            batch = dict(batch, embeds=batch["embeds"].detach()
                         .requires_grad_(True))
            extra = [batch["embeds"]]
        with torch.enable_grad():
            with scope.named_scope("loss"):
                loss, metrics = model.loss_fn(leaves, batch)
            grads = scope.grad(loss, flat + extra)[:len(flat)]
        return (loss.detach(), {n: m.detach() for n, m in metrics.items()},
                adamw.tree_unflatten(params, list(grads)))

    def grads_of(params, batch):
        if k == 1:
            return value_and_grad(params, batch)
        mb = _split_microbatches(batch, k)
        acc_dt = getattr(torch, cfg.grad_accum_dtype)
        gsum = adamw.tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                    device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=adamw.tree_leaves(params)[0].device)
        with scope.named_scope("microbatches"):
            for i in scope.scan(k):
                micro = {key: v[i] for key, v in mb.items()}
                loss, _, g = value_and_grad(params, micro)
                gsum = adamw.tree_unflatten(gsum, [
                    a + b.to(acc_dt) for a, b in zip(adamw.tree_leaves(gsum),
                                                     adamw.tree_leaves(g))])
                loss_sum = loss_sum + loss
        grads = adamw.tree_map(lambda g: g / k, gsum)
        loss = loss_sum / k
        return loss, {"nll": loss}, grads

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        with scope.named_scope("optimizer"):
            params, opt_state, om = adamw.update(params, grads, opt_state,
                                                 tcfg, schedule)
        metrics = dict(metrics)
        metrics.update(loss=loss, **om)
        return params, opt_state, metrics

    return train_step


def build_eval_step(model: Model) -> Callable:
    """Forward-only eval step (loss + metrics, no optimizer)."""
    def eval_step(params, batch):
        with torch.no_grad(), scope.named_scope("eval"):
            loss, metrics = model.loss_fn(params, batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return loss, metrics
    return eval_step
