"""Bounded retry with exponential backoff; counterpart of
``repro.runtime.retry``, pure Python.

``run_with_retry`` runs a thunk up to ``retries + 1`` times, sleeping
``backoff * factor**i`` (capped at ``max_backoff``) between failures, and
always returns a ``TaskOutcome``: it never raises.  A caller that runs it on
a worker thread shares the outcome with the scheduling thread (attempts and
the terminal status are visible while it runs), and ``should_abort`` lets
the scheduler cancel the attempts left of a task it has given up on.
``sleep`` is injectable, so tests run the schedule without waiting."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``retries`` extra attempts after the first, exponential backoff."""

    retries: int = 2
    backoff: float = 0.05          # seconds before the first retry
    factor: float = 2.0
    max_backoff: float = 2.0

    def delay(self, failure: int) -> float:
        """Backoff before retry number ``failure`` (1-based)."""
        return float(min(self.backoff * self.factor ** max(failure - 1, 0),
                         self.max_backoff))


@dataclasses.dataclass
class TaskOutcome:
    """Mutable record of one retried task; only the executing thread
    writes it."""

    status: str = "pending"        # pending | ok | failed | skipped | off
    attempts: int = 0
    error: Optional[str] = None
    value: Any = None
    elapsed: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def run_with_retry(fn: Callable[[], Any],
                   policy: RetryPolicy | None = None, *,
                   outcome: TaskOutcome | None = None,
                   should_abort: Callable[[], bool] | None = None,
                   on_retry: Callable[[int, BaseException], None] | None = None,
                   sleep: Callable[[float], None] = time.sleep) -> TaskOutcome:
    """Run ``fn`` under ``policy``; return (never raise) a ``TaskOutcome``.

    ``on_retry(n, exc)`` fires before backing off for retry ``n``;
    ``should_abort()`` is consulted after each failure; ``sleep`` is
    injectable."""
    policy = policy if policy is not None else RetryPolicy()
    out = outcome if outcome is not None else TaskOutcome()
    t0 = time.monotonic()
    while True:
        out.attempts += 1
        try:
            out.value = fn()
            out.status, out.error = "ok", None
            break
        except BaseException as e:  # noqa: BLE001 — the outcome carries it
            out.error = f"{type(e).__name__}: {e}"
            failures = out.attempts
            aborted = should_abort is not None and should_abort()
            if failures > policy.retries or aborted:
                out.status = "failed"
                if aborted:
                    out.error += " (aborted)"
                break
            if on_retry is not None:
                on_retry(failures, e)
            sleep(policy.delay(failures))
    out.elapsed = time.monotonic() - t0
    return out
