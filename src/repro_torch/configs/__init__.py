from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, TrainConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "TrainConfig",
    "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
