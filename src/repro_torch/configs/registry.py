"""Architecture registry + reduced ("smoke") config derivation.

``get_config(name)`` returns the full assigned configuration;
``smoke_config(name)`` returns a structurally-identical but tiny variant
(few layers, narrow width, tiny vocab, few experts) that runs a real
forward/train step on CPU in the test suite. Full configs are only ever
lowered/compiled abstractly via the dry-run (no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig

from repro_torch.configs import (  # noqa: E402  (import order is the registry)
    minicpm_2b,
    granite_3_2b,
    tinyllama_1_1b,
    command_r_35b,
    mamba2_370m,
    musicgen_large,
    zamba2_2_7b,
    qwen2_vl_72b,
    arctic_480b,
    granite_moe_1b_a400m,
)

_MODULES = (
    minicpm_2b, granite_3_2b, tinyllama_1_1b, command_r_35b, mamba2_370m,
    musicgen_large, zamba2_2_7b, qwen2_vl_72b, arctic_480b,
    granite_moe_1b_a400m,
)

CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def list_archs() -> List[str]:
    return list(CONFIGS)


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}") from None


def supported_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """The assigned shape cells for one architecture.

    ``long_500k`` requires sub-quadratic attention and is skipped (with a
    DESIGN.md note) for pure full-attention architectures.
    """
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(s)
    return out


def all_cells() -> List[tuple]:
    """Every (arch, shape) dry-run cell, including explicit skips."""
    cells = []
    for name, cfg in CONFIGS.items():
        for s in SHAPES.values():
            skip = s.name == "long_500k" and not cfg.supports_long_context
            cells.append((name, s.name, skip))
    return cells


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        vocab_size=257,           # deliberately odd (uneven-sharding path)
        loss_chunk=32,
        attn_chunk=64,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=min(4, max(1, cfg.num_kv_heads // 8)),
                  head_dim=16, d_ff=128)
    else:
        kw.update(num_heads=0, num_kv_heads=0, d_ff=0)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k),
            residual_d_ff=32 if cfg.moe.dense_residual else 0)
        kw["d_ff"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8,
                                        chunk_size=16)
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 1
        kw["num_layers"] = 2
    if cfg.pos_emb == "mrope":
        kw["mrope_sections"] = (2, 3, 3)   # sums to head_dim/2 = 8
    return cfg.replace(**kw)
