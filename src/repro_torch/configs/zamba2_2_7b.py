"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + weight-SHARED attention
block applied every 6 SSM layers (Zamba2 style). [arXiv:2411.15242; hf]

Sub-quadratic (only the shared-attn KV grows) => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,               # 54 Mamba2 layers
    d_model=2560,
    num_heads=32,                # shared attention block (MHA: kv=32)
    num_kv_heads=32,
    d_ff=10240,                  # shared block MLP
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256, conv_kernel=4),
    shared_attn_every=6,         # 9 invocations of the shared block
    supports_long_context=True,
)
