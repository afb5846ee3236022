"""Serving of the port; counterpart of ``repro.serve``: the engine
(continuous batching, async prefill, async MoE plan prep with retry and
fallback, drift unpinning), its SLO telemetry and the fault names."""
from .engine import PlanPrep, Request, ServeEngine
from .faults import FaultInjector, FaultSpec, InjectedFault
from .metrics import EngineMetrics, RequestMetrics, health_summary, percentile

__all__ = ["PlanPrep", "Request", "ServeEngine", "FaultInjector", "FaultSpec",
           "InjectedFault", "EngineMetrics", "RequestMetrics",
           "health_summary", "percentile"]
