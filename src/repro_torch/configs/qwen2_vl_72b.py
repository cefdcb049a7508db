"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings; M-RoPE position ids (3, B, S) are inputs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    pos_emb="mrope",
    mrope_sections=(16, 24, 24),   # temporal/h/w rotary sections (sum=64)
    frontend="vision",
    use_bias=True,                 # qwen2 uses qkv biases
    train_microbatches=8,          # 72B on 16GB/chip: activation lever
    moment_dtype="int8",           # rowwise-quantized AdamW moments
    grad_accum_dtype="bfloat16",
)
