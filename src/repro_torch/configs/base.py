"""Model / run configuration dataclasses (a copy of ``repro.configs.base``:
the port keeps its own so it never imports the JAX package).

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input-shape suites are ``ShapeConfig``s. Configs are frozen
dataclasses so they can be hashed into jit/static caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Arctic-style dense residual MLP running in parallel with the MoE FFN.
    dense_residual: bool = False
    # d_ff of the dense residual branch (defaults to the expert d_ff).
    residual_d_ff: int = 0
    # capacity factor used by the EP (shard_map) dispatch path
    capacity_factor: float = 1.25
    # "capacity": sort + scatter into (E, C, d) blocks + dense batched
    #             GEMMs (GShard-style, token-dropping) — default
    # "ragged":  dropless sort + grouped GEMM (custom sparse VJP); for
    #            megablox-class backends
    impl: str = "capacity"
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    conv_kernel: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # TP head padding (Megatron-style): q-head dim padded to a multiple of
    # the model axis so attention shards; pad-head outputs are hard-masked
    # to zero (exact semantics, dead weights). 0 = no padding.
    padded_heads: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one weight-shared attention block applied after every
    # ``shared_attn_every`` SSM layers.
    shared_attn_every: int = 0
    # positional encoding: "rope" | "mrope" | "none"
    pos_emb: str = "rope"
    rope_theta: float = 10000.0
    # M-RoPE (qwen2-vl): head_dim split into (temporal, h, w) sections.
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    # modality frontend stub: "none" (token ids) | "audio" | "vision"
    frontend: str = "none"
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = False
    # attention: "xla_flash" (chunked running-softmax einsum path, used for
    # lowering/dry-run) | "pallas" (TPU kernel; validated in interpret mode)
    attn_impl: str = "xla_flash"
    attn_chunk: int = 1024       # kv chunk for the xla_flash path
    # training numerics
    param_dtype: str = "float32"     # master copy dtype
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"    # AdamW m/v dtype (bf16 for arctic-480b)
    remat: str = "full"              # full | dots | none
    loss_chunk: int = 2048           # vocab-parallel chunked xent seq chunk
    # schedule: "wsd" (minicpm) | "cosine"
    schedule: str = "cosine"
    # gradient-accumulation microbatches for the production train step
    # (memory lever for the biggest archs)
    train_microbatches: int = 1
    grad_accum_dtype: str = "float32"   # bf16 for arctic (HBM floor)
    # prefill batch-chunking: fwd-only activation lever for 32k prompts
    prefill_microbatches: int = 1
    # serving
    kv_cache_dtype: str = "bfloat16"
    # which shape suites this arch supports (long_500k only sub-quadratic)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def resolved_padded_heads(self) -> int:
        return self.padded_heads or self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style) so the
        vocab-parallel embedding/logits shard evenly on any TP<=256;
        pad logits are masked to -inf in the loss/sampler."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape suite (arch-independent)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class TrainConfig:
    """Run-level knobs (optimizer, schedule, batching, fault tolerance)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    stable_ratio: float = 0.8        # WSD: fraction of post-warmup in stable
    grad_clip: float = 1.0
    microbatches: int = 1            # grad accumulation (pipeline-friendly)
    # cross-pod gradient compression ("none" | "int8_ef")
    grad_compression: str = "none"
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    keep_checkpoints: int = 3
