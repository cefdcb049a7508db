"""Conformance tooling of the port: seeded random model graphs, the
invariant harness, and the fault-injection driver.

Port of ``repro.testing``. ``graphgen`` turns integer seeds into eager
model graphs described by JSON-round-trippable ``GraphSpec``s (the same
JSON as the JAX package's for the same seed); ``conformance`` asserts
five probe exactness invariants on any spec (the JAX package's sixth,
``packed_vs_legacy``, has no counterpart: the port has one state
layout); ``sweep`` runs seed corpora and prints ready-to-paste repro
commands for failures; ``faults`` is the deterministic fault-injection
driver that locks the telemetry drift sentinel's detection claims.
"""
from repro_torch.testing.graphgen import (BlockSpec, GraphSpec, build,
                                          random_spec)
from repro_torch.testing.conformance import (INVARIANTS, ConformanceError,
                                             repro_command, run_conformance)
from repro_torch.testing.faults import (FakeClock, FaultDriver, RampFault,
                                        StepFault, StragglerFault)

__all__ = [
    "BlockSpec", "GraphSpec", "build", "random_spec",
    "INVARIANTS", "ConformanceError", "repro_command", "run_conformance",
    "FakeClock", "FaultDriver", "RampFault", "StepFault", "StragglerFault",
]
