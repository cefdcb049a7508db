"""Modality-frontend stubs (port of ``repro.models.frontends``).

The ``audio`` (musicgen) and ``vision`` (qwen2-vl) configs specify the
transformer backbone only: the EnCodec / vision-patch frontend is a stub
whose job is to define the input contract, precomputed frame or patch
embeddings (B, S, d_model) plus, for M-RoPE, the 3-stream position ids
(3, B, S).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def frontend_input_specs(cfg: ModelConfig, batch: int, seq: int,
                         compute_dtype) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """name -> (shape, dtype) of the stubbed frontend outputs."""
    specs = {"embeds": ((batch, seq, cfg.d_model), compute_dtype)}
    if cfg.pos_emb == "mrope":
        specs["positions"] = ((3, batch, seq), torch.int32)
    return specs


def synth_frontend_batch(cfg: ModelConfig, batch: int, seq: int,
                         compute_dtype, gen: torch.Generator,
                         device=None) -> Dict[str, torch.Tensor]:
    """Concrete synthetic frontend outputs: embeddings N(0, 0.02^2) drawn
    from ``gen`` (on ``device``, the generator's), and for M-RoPE the
    text-like positions 0..seq-1 on all three streams."""
    device = gen.device if device is None else torch.device(device)
    out = {"embeds": (torch.randn((batch, seq, cfg.d_model), generator=gen,
                                  dtype=torch.float32, device=device)
                      * 0.02).to(compute_dtype)}
    if cfg.pos_emb == "mrope":
        pos = torch.arange(seq, dtype=torch.int32, device=device)
        out["positions"] = pos[None, None].expand(3, batch, seq).contiguous()
    return out
