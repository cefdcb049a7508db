"""Model facade: schema/init, train loss, prefill, decode, dry specs.

Port of ``repro.models.model``, every family of the registry. Models
with a modality frontend (``frontend != "none"``) take precomputed
embeddings (``batch["embeds"]``, see ``frontends``) instead of token
ids and have no ``embed`` table; M-RoPE models take their 3-stream
positions (``batch["positions"]``, (3, B, S)). Parameters are nested
dicts of tensors with the JAX package's layouts (``layers.materialize``
or ``convert.params_from_numpy``).

Compute dtype: JAX casts the float32 master params to the compute dtype
inside every jitted step (``_compute_cast``). Here ``_compute_cast``
does the same, and a caller that runs many steps (the engine, the
serving loop) casts once up front and passes the compute-dtype copy;
casting a tensor that is already in the compute dtype returns it
unchanged, so the result is the same and no step copies the weights.

Dry specs (JAX's ``abstract_params``, ``logical_axes``, ``param_count``,
``input_specs``, ``cache_specs``, ``init_cache``): JAX's
``ShapeDtypeStruct`` stand-ins become tensors on the ``meta`` device,
which carry a shape and a dtype and hold no data, so a dry run
(``launch.dryrun``) traces a full-size step with nothing allocated.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import scope
from repro_torch.distributed.sharding import (fold_matmul, fsdp_weight,
                                               gather_rows, is_dtensor,
                                               placed_grad,
                                               shard)
from repro_torch.models import transformer as tfm
from repro_torch.models.frontends import frontend_input_specs
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Param, abstract, map_schema,
                                      materialize)

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
Z_LOSS_WEIGHT = 1e-4


class _GradDtypeBarrier(torch.autograd.Function):
    """Identity whose backward casts the cotangent to ``dtype``: JAX's
    ``_grad_dtype_barrier``, which keeps the f32 cotangent of the f32
    logits from running down the residual stream."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def _grad_dtype_barrier(x, dtype_str: str):
    return _GradDtypeBarrier.apply(x, getattr(torch, dtype_str))


_FAMILIES = ("dense", "ssm", "hybrid", "moe", "audio", "vlm")


def unsupported(cfg: ModelConfig) -> str:
    """Why the port cannot run ``cfg`` ('' if it can). Every registry
    config runs (the MoE sharded too, under ``distributed.sharding``'s
    rules); what is left out are values no JAX module takes either."""
    if cfg.family not in _FAMILIES:
        return f"family {cfg.family!r}"
    if cfg.pos_emb not in ("rope", "mrope", "none"):
        return f"pos_emb {cfg.pos_emb!r}"
    if cfg.frontend not in ("none", "audio", "vision"):
        return f"frontend {cfg.frontend!r}"
    if cfg.moe is not None and cfg.moe.impl not in ("capacity", "ragged"):
        return f"MoE impl {cfg.moe.impl!r}"
    if cfg.family == "hybrid" and not cfg.shared_attn_every:
        return "a hybrid stack without shared_attn_every"
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
        s: Dict[str, Any] = {"stack": tfm.stack_schemas(cfg)}
        if cfg.frontend == "none":
            s["embed"] = Param((V, cfg.d_model), ("vocab", "embed"),
                               init="embed")
        if cfg.frontend != "none" or not cfg.tie_embeddings:
            s["unembed"] = Param((cfg.d_model, V), ("embed", "vocab"))
        return s

    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device), in ``param_dtype``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return materialize(self.schema(), gen,
                           getattr(torch, self.cfg.param_dtype), device)

    def abstract_params(self, device="meta") -> Dict[str, Any]:
        """The schema's tensors in ``param_dtype`` with nothing drawn
        (JAX's ``abstract_params``): on ``meta``, shapes and dtypes
        only."""
        return abstract(self.schema(), getattr(torch, self.cfg.param_dtype),
                        device)

    def logical_axes(self) -> Dict[str, Any]:
        return map_schema(lambda p: p.axes, self.schema())

    def param_count(self) -> int:
        n = [0]

        def add(p):
            n[0] += math.prod(p.shape)
        map_schema(add, self.schema())
        return n[0]

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
        if self.cfg.frontend != "none":
            x = batch["embeds"].to(cd)
        else:
            with scope.named_scope("embed"):
                x = gather_rows(params["embed"],
                                batch["tokens"].long()).to(cd)
        return shard(x, "batch", "seq", None)

    def _positions(self, batch, seq: int, batch_size: int, device):
        if self.cfg.pos_emb == "mrope":
            return batch["positions"]
        return torch.arange(seq, device=device)[None].expand(batch_size, seq)

    def _mask_pad(self, logits):
        V = self.cfg.vocab_size
        if self.cfg.padded_vocab_size != V:
            if is_dtensor(logits):       # vocab-sharded: no in-place fill
                pad = torch.arange(logits.shape[-1],
                                   device=logits.device) >= V
                return logits.masked_fill(pad, float("-inf"))
            logits[:, V:].fill_(float("-inf"))   # one op on every device
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

    def _chunked_xent(self, params, x, labels):
        """Vocab-parallel, seq-chunked cross entropy (+ z-loss).

        Never materializes (B, S, V) logits; each chunk runs under
        ``scope.remat``, so the backward recomputes the chunk's f32
        logits instead of keeping them. Returns (nll, z_loss) means."""
        cfg = self.cfg
        B, S, D = x.shape
        chunk = min(cfg.loss_chunk, S)
        if S % chunk:
            chunk = S            # fall back: no chunking on odd lengths
        nc = S // chunk
        w = self._unembed_weight(params)
        V = cfg.padded_vocab_size
        pad_mask = torch.arange(V, device=x.device) >= cfg.vocab_size
        # each chunk its own slice of x and its own view of w, taken before
        # the loop: the chunks' gradients then land in separate slots and
        # are gathered once after the loop, not summed inside it (which a
        # probe's capture refuses: the iterations would differ)
        xs, ls = x.split(chunk, dim=1), labels.split(chunk, dim=1)
        ws = w.expand((nc,) + tuple(w.shape)).unbind(0)

        def body(x_, l_, w_):
            with scope.named_scope("logits"):
                logits = fold_matmul(x_.float(), fsdp_weight(
                    x_, w_.to(x_.dtype).float()))
                logits = logits.masked_fill(pad_mask, float("-inf"))
                logits = shard(logits, "batch", "seq", "vocab")
            with scope.named_scope("xent"):
                m = logits.amax(dim=-1, keepdim=True).detach()
                logz = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) \
                    + m[..., 0]
                if is_dtensor(logits):
                    # vocab-sharded: each rank picks the label's column
                    # from its block, the others add exact zeros; the
                    # iota is sharded as the vocab is, so the one-hot is
                    # made a block a rank
                    iota = shard(torch.arange(V, device=x_.device), "vocab")
                    hit = iota == l_.long()[..., None]
                    ll = placed_grad(torch.where(hit, logits, 0.0)).sum(-1)
                else:
                    ll = torch.gather(logits, -1, l_.long()[..., None])[..., 0]
                return torch.sum(logz - ll), torch.sum(torch.square(logz))

        nll = zl = torch.zeros((), dtype=torch.float32, device=x.device)
        with scope.named_scope("loss"):
            for c in scope.scan(nc):
                c_nll, c_zl = scope.remat(body, xs[c], ls[c], ws[c])
                nll, zl = nll + c_nll, zl + c_zl
            n_tok = B * S
            return nll / n_tok, zl / n_tok

    # ------------------------------------------------------------- train
    def loss_fn(self, params, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        """batch: {"tokens", "labels"}: (B, S) -> (loss, {"nll",
        "z_loss", "aux_loss"}), scalar f32 tensors."""
        cfg = self.cfg
        p = self._compute_cast(params)
        x = self._embed_in(p, batch)
        B, S, _ = x.shape
        positions = self._positions(batch, S, B, x.device)
        x, aux = tfm.stack_apply(p["stack"], x, positions, cfg)
        x = _grad_dtype_barrier(x, cfg.compute_dtype)
        nll, zl = self._chunked_xent(p, x, batch["labels"])
        loss = nll + Z_LOSS_WEIGHT * zl + aux
        return loss, {"nll": nll, "z_loss": zl, "aux_loss": aux}

    # ----------------------------------------------------------- serving
    def prefill(self, params, batch, cache_len: int):
        """batch: {"tokens": (B, S)} (a frontend: {"embeds": (B, S, d)}
        [, "positions": (3, B, S)]) -> (logits (B, V) at the last token,
        cache): {"k", "v"} of (L, B, cache_len, kv, hd), or for the ssm
        and hybrid families {"conv", "ssd"[, "k", "v"]} (see
        ``transformer.stack_prefill``)."""
        p = self._compute_cast(params)
        x = self._embed_in(p, batch)
        B, S, _ = x.shape
        positions = self._positions(batch, S, B, x.device)
        x, cache = tfm.stack_prefill(p["stack"], x, positions, self.cfg,
                                     cache_len)
        with scope.named_scope("last_logits"):
            logits = self._logits(p, x[:, -1])
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for every sequence. batch: {"tokens": (B, 1) (a
        frontend: "embeds": (B, 1, d)), "pos": int}; M-RoPE positions
        derive from ``pos``. The cache is updated in place and
        returned."""
        p = self._compute_cast(params)
        x = self._embed_in(p, batch)
        x, cache = tfm.stack_decode(p["stack"], cache, x, int(batch["pos"]),
                                    self.cfg)
        with scope.named_scope("last_logits"):
            logits = self._logits(p, x[:, -1])
        # the vocab dim counted from the front: DTensor's argmax over a
        # sharded dim fails for dim=-1 at one row a rank (torch 2.13's
        # all-gather reshapes a negative gather dim wrongly)
        nxt = torch.argmax(logits, dim=logits.dim() - 1)
        return logits, cache, nxt.to(torch.int32)

    # --------------------------------------------------------- dry specs
    def input_specs(self, shape: ShapeConfig, device="meta"
                    ) -> Dict[str, torch.Tensor]:
        """Stand-ins (empty tensors on ``device``) for every model input
        of a cell, JAX's ``input_specs``: decode is one new token against
        a cache of ``shape.seq_len``, its positions derived from the
        scalar ``pos`` (the M-RoPE stream dropped)."""
        cfg = self.cfg
        cd = getattr(torch, cfg.compute_dtype)
        B = shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len
        if cfg.frontend == "none":
            specs = {"tokens": ((B, S), torch.int32)}
        else:
            specs = dict(frontend_input_specs(cfg, B, S, cd))
        if shape.kind == "train":
            specs["labels"] = ((B, S), torch.int32)
        elif shape.kind == "decode":
            specs.pop("positions", None)
            specs["pos"] = ((), torch.int32)
        return {k: torch.empty(s, dtype=dt, device=device)
                for k, (s, dt) in specs.items()}

    def cache_specs(self, shape: ShapeConfig, device="meta"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
        """(tensors, logical axes) of the decode cache, JAX's
        ``cache_specs``: {"k", "v"} (L, B, S, kv, hd) in
        ``kv_cache_dtype``; the ssm family {"conv" (L, B, K-1, conv_dim)
        in the compute dtype, "ssd" (L, B, h, p, n) f32}, the hybrid both,
        its K/V one a shared-block call."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        kvd = getattr(torch, cfg.kv_cache_dtype)
        cd = getattr(torch, cfg.compute_dtype)
        kv, hd, L = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
        specs: Dict[str, Tuple[tuple, torch.dtype]] = {}
        axes: Dict[str, tuple] = {}
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        if cfg.family in ("ssm", "hybrid"):
            d = ssm_mod.ssm_dims(cfg)
            specs["conv"] = ((L, B, d["conv_kernel"] - 1, d["conv_dim"]), cd)
            axes["conv"] = ("layers", "batch", None, "ssm_inner")
            specs["ssd"] = ((L, B, d["heads"], d["head_dim"], d["d_state"]),
                            torch.float32)
            axes["ssd"] = ("layers", "batch", "ssm_heads", "ssm_head_dim",
                           "ssm_state")
            if cfg.family == "hybrid":
                n_inv = cfg.num_layers // cfg.shared_attn_every
                specs["k"] = specs["v"] = ((n_inv, B, S, kv, hd), kvd)
                axes["k"] = axes["v"] = kv_axes
        else:
            specs["k"] = specs["v"] = ((L, B, S, kv, hd), kvd)
            axes["k"] = axes["v"] = kv_axes
        return ({k: torch.empty(s, dtype=dt, device=device)
                 for k, (s, dt) in specs.items()}, axes)

    def init_cache(self, shape: ShapeConfig, device=None
                   ) -> Dict[str, torch.Tensor]:
        """A zero decode cache of ``cache_specs``' shapes on ``device``."""
        specs, _ = self.cache_specs(shape, device="meta")
        device = resolve_device(device)
        return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
                for k, t in specs.items()}

    def input_shapes(self, kind: str, batch: int, seq: int
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """name -> (shape, dtype) of every model input of a ``train``,
        ``prefill`` or ``decode`` call: a view of ``input_specs``."""
        specs = self.input_specs(ShapeConfig("", seq, batch, kind))
        return {k: (tuple(t.shape), t.dtype) for k, t in specs.items()}
