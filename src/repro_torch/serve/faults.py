"""The serving engine's fault names, from ``repro_torch.runtime.faults``
(the plan/execute guardrails and the engine consume the same deterministic
fault schedules, DESIGN.md §12); counterpart of ``repro.serve.faults``."""
from ..runtime.faults import (FaultInjector, FaultSpec,  # noqa: F401
                              InjectedFault, active_injector, inject_faults)

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault", "inject_faults",
           "active_injector"]
