"""repro_torch.core — RealProbe for eager PyTorch functions on an H100.

Port of ``repro.core``'s probe path::

    from repro_torch.core import probe, ProbeConfig, scope

    def step(x, w):
        with scope.named_scope("layers"):
            for _ in scope.scan(8):
                x = torch.tanh(x @ w) + x
        with scope.named_scope("head"):
            return torch.sum(x * x)

    pf = probe(step, ProbeConfig(), device="cpu")
    out, record = pf(x, w)        # outputs bit-identical to step(x, w)
    print(pf.report(record).table())

Stages (paper Fig 3):
  1 pragma      pragma.probe / ProbeConfig; scope markers (scope;
                scope.grad / scope.remat for a backward's scopes)
  2 extraction  hierarchy.capture (one run under a dispatch mode)
  3 IP          instrument.Runner + kernels.probe_events (+ buffer spill)
  5 results     report (table / timeline / bump chart), oracle (ILA)
  kernels       ProbeConfig(kernel_probes=...): grid-step probing of the
                hand kernels (kernelprobe, kernels.probe_events.probe_grid,
                KernelOracle, kernel_grid_table / kernel_grid_heat)
  streaming     ProbeSession: the probe kept running across steps, with
                constant-memory aggregates (StreamingSink, StreamAggregator)
  mesh          mesh_probe / MeshProbeSession: one counter row a device of
                a sharded body run on torch.distributed ranks (CycleRecord,
                ShardOracle, MeshReport; launch.mesh.spawn starts the ranks)
  DSE           run_dse (probe storage x offload, Pareto), DSEEngine over
                the CUDA kernels' tiles (SearchSpace, DeviceBudget,
                EvalCache), run_sweep and tracesim, the overhead model
"""
from repro_torch.core import scope
from repro_torch.core.hierarchy import Hierarchy, capture
from repro_torch.core.instrument import decode_record, init_state
from repro_torch.core.oracle import KernelOracle, Oracle
from repro_torch.core.pragma import ProbeConfig, ProbedFunction, probe
from repro_torch.core.report import (Report, bump_chart, kernel_grid_heat,
                                     kernel_grid_table)
from repro_torch.core.streaming import (ProbeSession, StreamAggregator,
                                        StreamingSink, StreamSnapshot)
from repro_torch.core.costmodel import DeviceBudget, KernelResources
from repro_torch.core.dse import (DSEEngine, DSEPoint, DSEResult,
                                  SearchSpace, Trial, TuneResult, run_dse,
                                  run_sweep)
from repro_torch.core.incremental import (EvalCache, FileLock,
                                          capture_fingerprint, device_kind,
                                          measure_incremental)
from repro_torch.core.overhead import (OverheadModel, adapt_allocation,
                                       measure_overhead)
from repro_torch.core.tracesim import KernelTrace, TraceEntry, TraceStore
from repro_torch.core.meshprobe import (CycleRecord, MeshProbedFunction,
                                        MeshProbeSession, MeshReport,
                                        MeshSnapshot, ShardOracle,
                                        mesh_probe)

__all__ = ["scope", "probe", "ProbeConfig", "ProbedFunction", "Hierarchy",
           "capture", "Oracle", "Report", "bump_chart", "decode_record",
           "init_state", "ProbeSession", "StreamingSink", "StreamAggregator",
           "StreamSnapshot", "KernelOracle", "kernel_grid_table",
           "kernel_grid_heat", "DeviceBudget", "KernelResources",
           "DSEEngine", "DSEPoint", "DSEResult", "SearchSpace", "Trial",
           "TuneResult", "run_dse", "run_sweep", "EvalCache", "FileLock",
           "capture_fingerprint", "device_kind", "measure_incremental",
           "OverheadModel", "adapt_allocation", "measure_overhead",
           "KernelTrace", "TraceEntry", "TraceStore", "mesh_probe",
           "MeshProbedFunction", "MeshProbeSession", "MeshSnapshot",
           "CycleRecord", "ShardOracle", "MeshReport"]
