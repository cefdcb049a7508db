"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 (SSD, state-space duality). [arXiv:2405.21060; unverified]

d_inner = expand*d_model = 2048; head_dim 64 => 32 SSD heads.
Attention-free => runs the long_500k shape (O(1)/token decode).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256, conv_kernel=4),
    pos_emb="none",
    supports_long_context=True,
)
