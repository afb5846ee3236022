"""The port's runtime: deterministic fault injection (``faults.py``),
bounded retry (``retry.py``) and the fault-tolerant training driver
(``driver.py``); counterpart of ``repro.runtime``."""
from .faults import (FaultInjector, FaultSpec, InjectedFault, active_injector,
                     consult, inject_faults)
from .retry import RetryPolicy, TaskOutcome, run_with_retry
from .driver import DriverConfig, StepEvent, TrainDriver

__all__ = ["DriverConfig", "FaultInjector", "FaultSpec", "InjectedFault",
           "RetryPolicy", "StepEvent", "TaskOutcome", "TrainDriver",
           "active_injector", "consult", "inject_faults", "run_with_retry"]
