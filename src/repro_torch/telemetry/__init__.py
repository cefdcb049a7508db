"""Telemetry control plane: live export of the in-process probe data.

Port of ``repro.telemetry``. ``bus`` is the pub/sub hub every session
and engine publishes decode-side aggregates to; ``server`` exposes it
over HTTP (``/status``, ``/probes``, ``/mesh/skew``, ``/engine/phases``,
``/alerts``, ``/metrics``); ``sentinel`` watches the window stream for
online drift (p99 regressions, histogram shifts, straggler devices).
All three are pure Python and numpy.
"""
from repro_torch.telemetry.bus import (ProbeStream, TelemetryBus, WindowFrame,
                                       hist_quantile)
from repro_torch.telemetry.sentinel import (DriftEvent, DriftSentinel,
                                            SentinelConfig, make_retune_hook)
from repro_torch.telemetry.server import (ControlPlane, StatusServer,
                                          render_json, render_metrics)

__all__ = [
    "TelemetryBus", "ProbeStream", "WindowFrame", "hist_quantile",
    "DriftSentinel", "DriftEvent", "SentinelConfig", "make_retune_hook",
    "ControlPlane", "StatusServer", "render_json", "render_metrics",
]
