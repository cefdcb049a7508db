"""Test tooling of the port.

Port of ``repro.testing``, so far its ``faults`` module only: the
deterministic fault-injection driver that locks the telemetry drift
sentinel's detection claims. ``graphgen``, ``conformance`` and ``sweep``
are not ported yet.
"""
from repro_torch.testing.faults import (FakeClock, FaultDriver, RampFault,
                                        StepFault, StragglerFault)

__all__ = ["FakeClock", "FaultDriver", "RampFault", "StepFault",
           "StragglerFault"]
