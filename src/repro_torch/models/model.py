"""Model facade: schema/init, prefill, decode.

Port of the serving half of ``repro.models.model``. Parameters are nested
dicts of tensors with the JAX package's layouts (``layers.materialize``
or ``convert.params_from_numpy``).

Compute dtype: JAX casts the float32 master params to the compute dtype
inside every jitted step (``_compute_cast``). Here ``_compute_cast``
does the same, and a caller that runs many steps (the engine, the
serving loop) casts once up front and passes the compute-dtype copy;
casting a tensor that is already in the compute dtype returns it
unchanged, so the result is the same and no step copies the weights.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import scope
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Param, materialize

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def unsupported(cfg: ModelConfig) -> str:
    """Why this slice of the port cannot run ``cfg`` ('' if it can)."""
    if cfg.family == "hybrid":
        return f"family {cfg.family!r}"
    if cfg.moe is not None:
        return "MoE layers"
    if cfg.frontend != "none":
        return f"frontend {cfg.frontend!r}"
    want = "none" if cfg.family == "ssm" else "rope"
    if cfg.pos_emb != want:
        return f"pos_emb {cfg.pos_emb!r}"
    return ""


class Model:
    def __init__(self, cfg: ModelConfig):
        why = unsupported(cfg)
        if why:
            raise NotImplementedError(f"{cfg.name}: {why} is not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------ params
    def schema(self) -> Dict[str, Any]:
        cfg = self.cfg
        V = cfg.padded_vocab_size
        s: Dict[str, Any] = {
            "stack": tfm.stack_schemas(cfg),
            "embed": Param((V, cfg.d_model), ("vocab", "embed"), init="embed"),
        }
        if not cfg.tie_embeddings:
            s["unembed"] = Param((cfg.d_model, V), ("embed", "vocab"))
        return s

    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device), in ``param_dtype``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return materialize(self.schema(), gen,
                           getattr(torch, self.cfg.param_dtype), device)

    # ------------------------------------------------------------ pieces
    def _compute_cast(self, params):
        cd = getattr(torch, self.cfg.compute_dtype)

        def cast(t):
            if isinstance(t, dict):
                return {k: cast(v) for k, v in t.items()}
            return t.to(cd) if t.dtype in _FLOATS else t
        return cast(params)

    def _embed_in(self, params, batch):
        cd = getattr(torch, self.cfg.compute_dtype)
        with scope.named_scope("embed"):
            return params["embed"][batch["tokens"].long()].to(cd)

    def _positions(self, seq: int, batch_size: int, device):
        return torch.arange(seq, device=device)[None].expand(batch_size, seq)

    def _mask_pad(self, logits):
        if self.cfg.padded_vocab_size != self.cfg.vocab_size:
            logits[:, self.cfg.vocab_size:] = float("-inf")
        return logits

    def _unembed_weight(self, params):
        if "unembed" in params:
            return params["unembed"]                     # (d, V)
        return params["embed"].T                         # tied

    def _logits(self, params, x):
        """(B, d) -> (B, V) f32 logits, pad vocab masked: a bf16-input,
        f32-accumulate product, as JAX's preferred_element_type=f32."""
        w = self._unembed_weight(params).to(x.dtype)
        return self._mask_pad(x.float() @ w.float())

    # ----------------------------------------------------------- serving
    def prefill(self, params, batch, cache_len: int):
        """batch: {"tokens": (B, S)} -> (logits (B, V) at the last token,
        cache): {"k", "v"} of (L, B, cache_len, kv, hd), or for the ssm
        family {"conv", "ssd"} (see ``transformer.stack_prefill``)."""
        p = self._compute_cast(params)
        x = self._embed_in(p, batch)
        B, S, _ = x.shape
        positions = self._positions(S, B, x.device)
        x, cache = tfm.stack_prefill(p["stack"], x, positions, self.cfg,
                                     cache_len)
        with scope.named_scope("last_logits"):
            logits = self._logits(p, x[:, -1])
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for every sequence. batch: {"tokens": (B, 1), "pos":
        int}. The cache is updated in place and returned."""
        p = self._compute_cast(params)
        x = self._embed_in(p, batch)
        x, cache = tfm.stack_decode(p["stack"], cache, x, int(batch["pos"]),
                                    self.cfg)
        with scope.named_scope("last_logits"):
            logits = self._logits(p, x[:, -1])
        return logits, cache, torch.argmax(logits, dim=-1).to(torch.int32)
