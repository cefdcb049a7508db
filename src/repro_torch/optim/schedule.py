"""LR schedules: WSD (MiniCPM's warmup-stable-decay) and cosine.

Port of ``repro.optim.schedule``. The step may be a Python number or a
0-d tensor (the optimizer's step counter, on the device); the result is
a 0-d float32 tensor on the step's device. Every constant is rounded to
float32 first and the arithmetic runs in float32, in the JAX package's
order, so the values are JAX's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig

_F32 = np.float32


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def wsd(step, cfg: TrainConfig, peak_lr: float):
    """Warmup-Stable-Decay [arXiv:2404.06395]: linear warmup, long stable
    plateau, then exponential-style decay to 10% of peak."""
    step = _step(step)
    warm, total = _F32(cfg.warmup_steps), _F32(cfg.total_steps)
    stable_end = warm + (total - warm) * _F32(cfg.stable_ratio)
    warmup_lr = peak_lr * step / float(max(warm, _F32(1.0)))
    decay_frac = (step - float(stable_end)) / float(
        max(total - stable_end, _F32(1.0)))
    decay_lr = peak_lr * torch.pow(0.1, decay_frac.clamp(0.0, 1.0))
    return torch.where(step < float(warm), warmup_lr,
                       torch.where(step < float(stable_end),
                                   torch.full_like(step, peak_lr), decay_lr))


def cosine(step, cfg: TrainConfig, peak_lr: float):
    step = _step(step)
    warm, total = _F32(cfg.warmup_steps), _F32(cfg.total_steps)
    warmup_lr = peak_lr * step / float(max(warm, _F32(1.0)))
    frac = ((step - float(warm)) / float(max(total - warm, _F32(1.0)))
            ).clamp(0.0, 1.0)
    cos_lr = 0.1 * peak_lr + 0.9 * peak_lr * 0.5 * (
        1 + torch.cos(float(_F32(math.pi)) * frac))
    return torch.where(step < float(warm), warmup_lr, cos_lr)


def make_schedule(name: str, cfg: TrainConfig):
    fn = {"wsd": wsd, "cosine": cosine}[name]
    return lambda step: fn(step, cfg, cfg.learning_rate)
