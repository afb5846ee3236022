"""The port's runtime: deterministic fault injection (``faults.py``) and
bounded retry (``retry.py``); counterpart of ``repro.runtime``'s two
modules of the same names.  The reference's training driver
(``runtime/driver.py``) is not ported yet."""
from .faults import (FaultInjector, FaultSpec, InjectedFault, active_injector,
                     consult, inject_faults)
from .retry import RetryPolicy, TaskOutcome, run_with_retry

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault", "RetryPolicy",
           "TaskOutcome", "active_injector", "consult", "inject_faults",
           "run_with_retry"]
