"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, MoE 128 experts top-2 + Arctic's dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]

HBM note: at 480B params a fp32 master + fp32 moments cannot fit a
16 GB/chip pod slice; this config keeps bf16 params + int8 blockwise AdamW moments + bf16 grad accumulation
(documented in DESIGN.md §Distribution design).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    padded_heads=64,          # 56 q-heads padded to 4/shard on TP=16
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True,
                  residual_d_ff=4864),
    train_microbatches=8,
    grad_accum_dtype="bfloat16",
    moment_dtype="int8",
    param_dtype="bfloat16",
)

