"""Probe trees of all 10 registry archs: the port against ``repro.core``.

For every ``list_archs()`` smoke config, the two programs the golden
files pin (``tools/regen_golden.py``'s ``_arch_train`` and
``_arch_serve``: ``build_train_step(model, TrainConfig(total_steps=10,
warmup_steps=1))`` on a (2, 32) batch, and ``decode_step`` against a
(2, 64) cache at ``pos=3``), probed under ``inline="off_all"`` (JAX
counts jaxpr equations and the port aten operations, so the default
policy's threshold falls apart; ``test_torch_train.py`` holds the
default policy for tinyllama). The port's probe paths equal JAX's, in
order, and each path's calls equal JAX's, apart from the lists below.

Paths and calls follow from the programs' scopes and static scan
lengths alone: these programs hold no while loop and no cond (the stub
below refuses them). So JAX's side is traced at zero arguments of the
golden builders' shapes and dtypes (``Model.abstract_params`` and
``jax.eval_shape`` of the optimizer's init: no weights are drawn, no
XLA compile runs), and its calls
come from ``repro.core``'s own oracle replayed over the traced jaxpr
with every primitive's value stubbed; the reference asserts its record
== its oracle. The stub's calls are held once against JAX's live probe
record, on the hybrid decode step. The port runs on its own random
weights and a numpy batch.

``_jax_only``: JAX paths the port has no counterpart for, each for a
reason of JAX's tracing (see ``test_torch_train.py`` for the first
three): einsum scopes; the XLA flash route's scopes below ``flash``
(the port's forward is one kernel op; ``qblk_bwd`` is kept); top-level
``layer``, ``logits``, ``xent`` and, for the hybrid family,
``shared_attn``: JAX's partial evaluation hoists the remat'd scans'
loop-invariant forward work (here the shared block's weights are the
invariant) out of ``loss`` into nodes of their own; and, the same one
level down, ``.../groups/scan#0/rematted_computation/ssm_layer/...``:
the nested remat's inner scan has its invariant work hoisted beside it
in the group's recompute, where eager autograd runs it inside the loop.

``_CALLS_DIFFER``: compared paths whose calls differ, with both counts
and the reason; the same list stands in ROADMAP Queue 3.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import ProbeConfig as JaxProbeConfig
from repro.core import probe as jax_probe
from repro.core.instrument import decode_record as jax_decode_record
from repro.core.oracle import Oracle as JaxOracle
from repro.distributed.steps import build_train_step as jax_train_step
from repro.models import Model as JaxModel
from repro.models.frontends import frontend_input_specs
from repro.optim import adamw as jadamw
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import list_archs, smoke_config
from repro_torch.core import ProbeConfig, decode_record, probe
from repro_torch.distributed.steps import build_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw

ARCHS = list_archs()
OFF = dict(inline="off_all", max_probes=500)
B, S, CACHE, POS = 2, 32, 64, 3          # tools/regen_golden.py's shapes


def _jax_only(path: str) -> bool:
    segs = path.split("/")
    if any("->" in s for s in segs):
        return True
    if segs[0] in ("layer", "logits", "xent", "shared_attn"):
        return True
    for i, s in enumerate(segs[:-1]):
        if s == "rematted_computation" and segs[i + 1] == "ssm_layer" \
                and segs[i - 2:i] == ["groups", "scan#0"]:
            return True
    return "flash" in segs[:-1] and "qblk_bwd" not in segs


_REMAT_SPLIT = ("under remat, the XLA flash route's state initialisations "
                "lose their name stack and split each recomputed visit of "
                "the attention block, its attn and attn/flash in two; the "
                "port's recompute runs each as one visit")
_EMBEDS_SPLIT = ("with embeddings for input, JAX's partial evaluation "
                 "splits the layers scope's one visit around hoisted "
                 "nodes; the port's forward runs it as one visit")
_LOSS_SPLIT = ("JAX's partial evaluation splits the loss scope's one "
               "visit around the hoisted top-level nodes; the port's "
               "forward runs it as one visit")
_DENSE_REMAT = {
    "loss~bwd/layers/scan#0/rematted_computation/layer": (4, 2),
    "loss~bwd/layers/scan#0/rematted_computation/layer/attn": (4, 2),
    "loss~bwd/layers/scan#0/rematted_computation/layer/attn/flash": (4, 2),
}
_HYBRID_REMAT = {
    "loss~bwd/groups/scan#0/rematted_computation/shared_attn": (4, 2),
    "loss~bwd/groups/scan#0/rematted_computation/shared_attn/attn": (4, 2),
    "loss~bwd/groups/scan#0/rematted_computation/shared_attn/attn/flash":
        (4, 2),
}


def _calls_differ(arch: str, phase: str):
    """{path: (JAX's calls, the port's calls, why)} for one program."""
    if phase == "serve":
        return {}
    cfg = smoke_config(arch)
    out = {"loss": (3, 1, _LOSS_SPLIT)}
    if cfg.family == "ssm":
        return out
    remat = _HYBRID_REMAT if cfg.family == "hybrid" else _DENSE_REMAT
    out.update({p: c + (_REMAT_SPLIT,) for p, c in remat.items()})
    if cfg.frontend != "none":
        out["loss/layers"] = (2, 1, _EMBEDS_SPLIT)
    return out


class _StubOracle(JaxOracle):
    """``repro.core``'s oracle with every value stubbed by zeros of its
    shape: the replay walks the same equations and scopes."""

    def _bind(self, eqn, invals):
        outs = [np.broadcast_to(np.zeros((), v.aval.dtype), v.aval.shape)
                for v in eqn.outvars]
        return outs if eqn.primitive.multiple_results else outs[0]

    def _while(self, *a):
        raise AssertionError("a while loop's trips depend on values")

    def _cond(self, *a):
        raise AssertionError("a branch depends on values")


def _jax_calls(fn, args):
    pf = jax_probe(fn, JaxProbeConfig(**OFF))
    pf.ensure_built(*args)
    st = _StubOracle(pf.hierarchy, pf.assignment).run(
        pf.hierarchy.closed_jaxpr, jax.tree_util.tree_leaves(args))
    return pf, list(zip(pf.probe_paths(), [int(c) for c in st.calls]))


def _zeros(tree):
    return jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), tree)


def _jax_program(arch: str, phase: str, seq: int = S):
    """JAX's program and zero arguments of the golden builders' shapes
    and dtypes (see the module docstring)."""
    import jax.numpy as jnp
    cfg = jax_smoke_config(arch)
    m = JaxModel(cfg)
    params = m.abstract_params()
    frontend = cfg.frontend != "none"
    if phase == "train":
        opt = jax.eval_shape(lambda p: jadamw.init(p, cfg.moment_dtype),
                             params)
        batch = (_zeros(frontend_input_specs(cfg, B, seq, jnp.bfloat16))
                 if frontend else {"tokens": np.zeros((B, seq), np.int32)})
        batch["labels"] = np.zeros((B, seq), np.int32)
        step = jax_train_step(m, JaxTrainConfig(total_steps=10,
                                                warmup_steps=1))
        return step, (_zeros(params), _zeros(opt), batch)
    cache = _zeros(m.cache_specs(ShapeConfig("t", CACHE, B, "decode"))[0])
    batch = ({"embeds": np.zeros((B, 1, cfg.d_model), jnp.bfloat16)}
             if frontend else {"tokens": np.zeros((B, 1), np.int32)})
    batch["pos"] = np.int32(POS)
    return m.decode_step, (_zeros(params), cache, batch)


def _port_program(arch: str, phase: str, seq: int = S):
    """The port's program and a factory of fresh arguments (decode
    updates its cache in place): random weights from seed 0, a numpy
    batch of the same shapes."""
    cfg = smoke_config(arch)
    m = Model(cfg)
    params = m.init(0, "cpu")
    rng = np.random.default_rng(1)
    n = seq if phase == "train" else 1
    if cfg.frontend != "none":
        batch = {"embeds": torch.from_numpy(rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)}
        if cfg.pos_emb == "mrope" and phase == "train":
            batch["positions"] = torch.arange(n).expand(3, B, n)
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32))}
    if phase == "train":
        batch["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32))
        step = build_train_step(m, TrainConfig(total_steps=10,
                                               warmup_steps=1))
        return step, lambda: (params, adamw.init(params, cfg.moment_dtype),
                              batch)
    jm = JaxModel(jax_smoke_config(arch))
    shapes = jm.cache_specs(ShapeConfig("t", CACHE, B, "decode"))[0]

    def args():
        cache = {k: torch.zeros(v.shape, dtype=getattr(torch, str(v.dtype)))
                 for k, v in shapes.items()}
        return params, cache, dict(batch, pos=POS)
    return m.decode_step, args


@pytest.mark.parametrize("phase", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_probe_paths_and_calls_match_jax(arch, phase):
    _, jcalls = _jax_calls(*_jax_program(arch, phase))
    want = [(p, c) for p, c in jcalls if not _jax_only(p)]
    tfn, targs = _port_program(arch, phase)
    pf = probe(tfn, ProbeConfig(**OFF), device="cpu")
    _, rec = pf(*targs())
    got = list(zip(pf.probe_paths(),
                   [int(c) for c in decode_record(rec)["calls"]]))
    assert [p for p, _ in got] == [p for p, _ in want]
    differ = _calls_differ(arch, phase)
    for (p, jc), (_, tc) in zip(want, got):
        assert (jc, tc) == differ.get(p, (jc, jc))[:2], p
    for p in differ:          # every listed difference is still there
        assert p in dict(got), p


def test_stub_oracle_calls_equal_jax_live_record():
    """The stubbed replay gives the calls of JAX's live probe record, on
    the hybrid arch's decode step (SSM layers in a group scan, then the
    shared block)."""
    fn, args = _jax_program("zamba2-2.7b", "serve")
    pf, stub = _jax_calls(fn, args)
    _, rec = pf(*args)
    live = [int(c) for c in jax_decode_record(rec)["calls"]]
    assert [c for _, c in stub] == live


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-1b-a400m",
                                  "qwen2-vl-72b"])
def test_probed_train_step_is_exact_and_leaves_outputs_alone(arch):
    """Inside the port: the device record equals the oracle's, and the
    probed step's outputs are bitwise the unprobed step's, for one arch
    of each new family."""
    tfn, targs = _port_program(arch, "train")
    pf = probe(tfn, ProbeConfig(inline="off_all", max_probes=500,
                                buffer_depth=2, offload=0.5), device="cpu")
    out, rec = pf(*targs())
    oc = pf.oracle(*targs())
    dec = decode_record(rec)
    assert dec["cycle"] == oc.cycle
    for i, p in enumerate(pf.probe_paths()):
        assert int(dec["calls"][i]) == oc.calls[i], p
        assert int(dec["totals"][i]) == oc.totals[i], p
    plain = tfn(*targs())

    def flat(res):      # int8 moments are QTensors: (values, scales)
        return [t for x in adamw.tree_leaves((res[0], tuple(res[1])))
                for t in (x if isinstance(x, tuple) else (x,))]
    for a, b in zip(flat(out), flat(plain)):
        assert torch.equal(a, b)
    assert torch.equal(out[2]["loss"], plain[2]["loss"])


def test_probed_train_step_over_two_loss_chunks():
    """tinyllama's smoke train step on a (2, 64) batch: two loss chunks
    of 32, each with its own slice of the activations and view of the
    unembedding, so the capture prices both alike; paths and calls as
    JAX's (the same lists), record == oracle."""
    arch = "tinyllama-1.1b"
    _, jcalls = _jax_calls(*_jax_program(arch, "train", seq=64))
    want = [(p, c) for p, c in jcalls if not _jax_only(p)]
    tfn, targs = _port_program(arch, "train", seq=64)
    pf = probe(tfn, ProbeConfig(**OFF), device="cpu")
    _, rec = pf(*targs())
    dec = decode_record(rec)
    got = list(zip(pf.probe_paths(), [int(c) for c in dec["calls"]]))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert dict(got)["loss/loss/scan#0"] == 2
    differ = _calls_differ(arch, "train")
    for (p, jc), (_, tc) in zip(want, got):
        assert (jc, tc) == differ.get(p, (jc, jc))[:2], p
    oc = pf.oracle(*targs())
    assert dec["cycle"] == oc.cycle and [int(c) for c in dec["calls"]] == \
        oc.calls
