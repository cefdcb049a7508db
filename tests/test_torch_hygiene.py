"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never quietly fall back to the CPU."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "repro_torch", "repro_torch.configs", "repro_torch.configs.registry",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.transformer",
    "repro_torch.models.model", "repro_torch.models.convert",
    "repro_torch.models.ssm",
    "repro_torch.kernels", "repro_torch.kernels.ref",
    "repro_torch.kernels._build", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.paged_attention", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.probe_events",
    "repro_torch.core", "repro_torch.core.scope",
    "repro_torch.core.costmodel", "repro_torch.core.hierarchy",
    "repro_torch.core.kernelprobe",
    "repro_torch.core.inline", "repro_torch.core.buffer",
    "repro_torch.core.instrument", "repro_torch.core.oracle",
    "repro_torch.core.report", "repro_torch.core.pragma",
    "repro_torch.core.streaming",
    "repro_torch.telemetry", "repro_torch.telemetry.bus",
    "repro_torch.telemetry.sentinel", "repro_torch.telemetry.server",
    "repro_torch.testing", "repro_torch.testing.faults",
    "repro_torch.testing.graphgen", "repro_torch.testing.conformance",
    "repro_torch.testing.sweep", "repro_torch.engine.soak",
    "repro_torch.engine",
    "repro_torch.engine.pagetable", "repro_torch.engine.step",
    "repro_torch.engine.engine", "repro_torch.launch.serve",
    "repro_torch.optim", "repro_torch.optim.schedule",
    "repro_torch.optim.quantized", "repro_torch.optim.adamw",
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer",
    "repro_torch.distributed", "repro_torch.distributed.steps",
    "repro_torch.launch.train",
    "repro_torch.core.incremental", "repro_torch.core.overhead",
    "repro_torch.core.dse", "repro_torch.core.tracesim",
    "repro_torch.kernels.tuning", "repro_torch.kernels.ops",
    "repro_torch.kernels.search_spaces", "repro_torch.launch.tune",
    "repro_torch.tune", "repro_torch.distributed.compat",
    "repro_torch.launch.mesh", "repro_torch.launch.collectives",
    "repro_torch.core.meshprobe", "repro_torch.optim.compression",
    "repro_torch.testing.mesh_ranks", "repro_torch.launch.hlo_cost",
    "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
)


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO)


def test_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    """With no GPU and no device="cpu", serve() (profiled or not),
    train() (probed or not), Model.init, probe(), ProbeSession(fn) and
    init_state raise."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(batch=1, prompt_len=4, max_new=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(batch=1, prompt_len=4, max_new=1, profile=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(smoke_config("tinyllama-1.1b")).init(0)
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(steps=1, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(steps=1, batch=1, seq=8, probe_targets=("",))
    from repro_torch.core import ProbeSession, init_state, probe
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe(lambda x: x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProbeSession(lambda x: x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(2, 4)


def test_dse_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    """With no GPU and no device="cpu", the tune CLI, the search spaces,
    run_dse, run_sweep and serve(autotune=True) raise."""
    from repro_torch.core import run_dse, run_sweep
    from repro_torch.kernels import search_spaces as ss
    from repro_torch.launch.serve import serve
    from repro_torch.launch.tune import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--kernel", "flash_attention"])
    for make in ss.SPACES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_dse(lambda x: x * 2, (torch.ones(2),), repeats=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sweep("flash_attention")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(batch=1, prompt_len=4, max_new=1, autotune=True)


def test_harness_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    """With no GPU and no device="cpu", graphgen's build, run_conformance,
    the sweep's CLI and the soak raise."""
    from repro_torch.engine.soak import soak
    from repro_torch.testing import build, random_spec, run_conformance
    from repro_torch.testing.sweep import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(random_spec(7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_conformance(random_spec(7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--count", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        soak(waves=1, requests_per_wave=1, verbose=False)


def test_serve_engine_and_legacy_loop_agree_on_cpu():
    """serve() on the CPU: engine (whole and chunked prefill, kernel and
    dense decode) and the legacy lock-step loop give one set of ids."""
    from repro_torch.launch.serve import serve
    kw = dict(batch=2, prompt_len=20, max_new=4, device="cpu")
    base = serve(**kw, engine=False)
    assert base.tokens.shape == (2, 4) and not base.stats
    for over in (dict(), dict(engine_kernel=True),
                 dict(engine_kernel=True, prefill_chunk=1)):
        res = serve(**kw, **over)
        assert (res.tokens == base.tokens).all(), over
        assert res.stats["retraces"] == 0
        assert torch.isfinite(res.first_logits[:, :257]).all()


def test_trainer_cli_on_the_cpu_and_its_unported_flags(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` trains (and
    probes); ``--mesh`` without ``--probe`` (the auto-sharded step)
    raises, naming the roadmap; ``--autotune`` (ported
    with the DSE) loads the tuned configs, none from an empty cache."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--steps", "4", "--batch", "2", "--seq", "32"]
    out = subprocess.run(base + ["--probe", "--probe-every", "2"], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    assert "step     3 loss" in out and out.count("[probe] ") == 2
    assert "# final streaming probe telemetry" in out
    from repro_torch.launch.train import train
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(steps=1, batch=1, seq=8, device="cpu", probe_mesh=(2,))
    _, _, losses = train(steps=1, batch=1, seq=8, device="cpu",
                         autotune=True, tune_cache=str(tmp_path / "dse"))
    assert "[autotune] no cached configs" in capsys.readouterr().out
    assert len(losses) == 1
