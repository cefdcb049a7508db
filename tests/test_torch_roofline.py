"""The roofline's port (``repro_torch.launch.roofline``) against the JAX
package's, on the CPU.

- ``active_param_count`` of all 10 archs and ``model_flops`` of every
  (arch, ``SHAPES`` cell) equal JAX's exactly;
- one JAX-format record through JAX's ``cell_terms`` and the port's:
  each time term times its own constant (JAX's TPU v5e rates, the
  port's H100 rates from ``core.costmodel``) gives the same count back,
  so the two use one formula; MODEL_FLOPS, the counted total and the
  useful ratio are equal;
- ``table`` and ``cell_report`` over a results directory holding a
  record, a skip record and an error record.
"""
import math

import pytest

from repro.launch import roofline as jroof

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import CONFIGS
from repro_torch.core import costmodel as cm
from repro_torch.launch import roofline

REC = {"arch": "granite-moe-1b-a400m", "shape": "train_4k", "mesh": "16x16",
       "kind": "train", "trace_s": 1.0, "flops_per_device": 2.2e13,
       "bytes_per_device": 2.9e12, "collectives": {
           "all-gather": {"count": 10, "wire_bytes": 1.0e11}},
       "collective_bytes_per_device": 1.0e11,
       "raw_cost_analysis": {"flops": 2.0e13, "bytes_accessed": None},
       "memory": {"argument_bytes": 1, "output_bytes": 1, "temp_bytes": 1,
                  "alias_bytes": 0, "peak_estimate_bytes": 3 * 2**30},
       "param_count": 1}


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_active_params_and_model_flops_match_jax(arch):
    assert roofline.active_param_count(arch) == \
        jroof.active_param_count(arch)
    for name in SHAPES:
        assert roofline.model_flops(arch, name) == \
            jroof.model_flops(arch, name), name
        assert roofline.model_flops(arch, SHAPES[name]) == \
            jroof.model_flops(arch, name), name


def test_cell_terms_share_jax_formula():
    got = roofline.cell_terms(REC, 256)
    want = jroof.cell_terms(REC, 256)
    for key, port_rate, jax_rate in (
            ("compute_s", cm.PEAK_FLOPS_BF16, jroof.PEAK_FLOPS),
            ("memory_s", cm.HBM_BW, jroof.HBM_BW),
            ("collective_s", cm.LINK_BW, jroof.ICI_BW)):
        assert math.isclose(got[key] * port_rate, want[key] * jax_rate,
                            rel_tol=1e-12), key
    for key in ("model_flops", "hlo_flops_total", "useful_ratio"):
        assert got[key] == want[key], key
    assert got["bound_step_s"] == max(got["compute_s"], got["memory_s"],
                                      got["collective_s"])
    assert got["dominant"] == "memory"       # 2.9e12 B at 3.35e12 B/s
    assert roofline.PEAK_FLOPS_BF16 == 989e12
    assert (roofline.HBM_BW, roofline.LINK_BW) == (3.35e12, 450e9)


def test_table_and_cell_report_over_a_results_dir(tmp_path):
    import json
    (tmp_path / "granite-moe-1b-a400m__train_4k__16x16.json").write_text(
        json.dumps(REC))
    (tmp_path / "tinyllama-1.1b__long_500k__16x16.json").write_text(
        json.dumps({"arch": "tinyllama-1.1b", "shape": "long_500k",
                    "mesh": "16x16", "skipped": "full-attention"}))
    (tmp_path / "mamba2-370m__train_4k__16x16.json").write_text(
        json.dumps({"arch": "mamba2-370m", "shape": "train_4k",
                    "mesh": "16x16", "error": "RuntimeError: planted"}))
    (tmp_path / "tinyllama-1.1b__train_4k__2x16x16.json").write_text(
        json.dumps(dict(REC, arch="tinyllama-1.1b", mesh="2x16x16")))
    rows = roofline.table("16x16", tmp_path).splitlines()
    assert len(rows) == 4 and rows[0].split()[:3] == ["arch", "shape",
                                                      "comp_s"]
    moe = next(r for r in rows if r.startswith("granite-moe"))
    t = roofline.cell_terms(REC, 256)
    assert moe.split()[2:] == [f"{t['compute_s']:.4f}",
                               f"{t['memory_s']:.4f}",
                               f"{t['collective_s']:.4f}", "memory",
                               f"{t['useful_ratio']:.3f}", "3.00"]
    assert any("SKIP" in r for r in rows)
    assert any("ERROR RuntimeError: planted" in r for r in rows)
    rep = roofline.cell_report("granite-moe-1b-a400m", "train_4k", "16x16",
                               tmp_path)
    assert rep.splitlines()[0] == \
        "granite-moe-1b-a400m x train_4k on 16x16 (256 H100s)"
    assert "dominant: memory" in rep and "HBM3-bound" in rep
    assert json.loads(roofline.cell_report(
        "mamba2-370m", "train_4k", "16x16", tmp_path))["error"] == \
        "RuntimeError: planted"
    multi = roofline.table("2x16x16", tmp_path).splitlines()
    assert len(multi) == 2 and multi[1].startswith("tinyllama-1.1b")
