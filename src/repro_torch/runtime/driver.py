"""Fault-tolerant training driver; counterpart of
``repro.runtime.driver``.

Responsibilities (all exercised by tests/test_runtime.py):
  * checkpoint/restart — periodic async checkpoints; on (re)start the driver
    scans for the latest committed step and resumes from it, with the
    step-indexed data pipeline regenerating the exact stream.
  * failure handling — a step that raises is caught, the run rolls back to
    the last committed checkpoint and replays (in production the scheduler
    restarts the job; in-process we simulate that path — same code route).
  * preemption — SIGTERM triggers a final sync checkpoint before exit.
  * straggler watchdog — per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are logged as straggler events, and the
    mitigation hook fires (on real fleets: reshard/evict; here: recorded).
  * calibrate-on-first-run — when ``calibrate_to`` names a thresholds file
    that does not exist yet, a background thread measures the 2x2 kernel
    grid on the device the state lives on (``repro_torch.api.
    calibrate_backend``, CUDA events on the card) and persists the winner
    where ``$REPRO_THRESHOLDS`` auto-loads it, so fleets converge to
    backend-correct selector thresholds without operator action.

Train state and batches are trees of tensors, or of placed leaves
(``dist.placement``; ``run(state, shardings)`` restores onto the mesh of
``shardings``, by default onto the state's own, after a failure too); a
step's time is taken after a sync on the device of its first metric (of a
placed step, the first position's).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import threading
import time
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..checkpoint.manager import CheckpointManager
from .retry import RetryPolicy, TaskOutcome, run_with_retry


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    #: default: ``repro_torch_ckpt`` in the temporary directory ($TMPDIR)
    checkpoint_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    max_restarts: int = 3
    #: path for the background selector-thresholds calibration (None = off);
    #: skipped when the file already exists (a fleet calibrates once)
    calibrate_to: Optional[str] = None
    #: retry budget for the background calibration job (exponential backoff
    #: via ``runtime.retry``; transient FS / measurement hiccups must not
    #: leave the fleet permanently uncalibrated)
    calibrate_retries: int = 2
    calibrate_backoff: float = 0.5


@dataclasses.dataclass
class StepEvent:
    step: int
    wall: float
    metrics: dict
    straggler: bool = False


class TrainDriver:
    def __init__(self, cfg: DriverConfig, train_step: Callable,
                 data_fn: Callable[[int], Any],
                 failure_hook: Optional[Callable[[int], None]] = None):
        """data_fn(step) -> batch; failure_hook(step) may raise to inject
        faults (tests)."""
        self.cfg = cfg
        self.train_step = train_step
        self.data_fn = data_fn
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
        self.events: list[StepEvent] = []
        self.straggler_events: list[int] = []
        self.restarts = 0
        self._preempted = False
        self._ema: Optional[float] = None
        self._measured = 0
        self._calibrate_thread: Optional[threading.Thread] = None
        #: the device of the train state's first tensor (set by ``run``):
        #: where the background calibration times its kernels
        self._device = None
        #: observable outcome of the background calibration: ``status`` is
        #: "off" (not configured), "skipped" (thresholds file already
        #: exists), "pending" while running, then "ok"/"failed" with the
        #: attempt count and last error — no more silently swallowed
        #: failures
        self.calibration = TaskOutcome(status="off")

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def _start_calibration(self):
        """Background thresholds calibration (facade-level; tiny R-MAT
        suite, seconds) on the train state's device (the card when no state
        was seen) — the calibrate-on-first-serve ROADMAP hook.
        Runs through ``runtime.retry``: transient failures retry with
        backoff, and the terminal outcome (status/attempts/error) lands in
        ``self.calibration`` instead of being swallowed — calibration must
        never take the run down, but a silent no-file is undiagnosable."""
        if self.cfg.calibrate_to is None:
            return
        if os.path.exists(self.cfg.calibrate_to):
            self.calibration.status = "skipped"
            return
        if self._calibrate_thread is not None:
            return
        self.calibration.status = "pending"
        policy = RetryPolicy(retries=self.cfg.calibrate_retries,
                             backoff=self.cfg.calibrate_backoff)

        def job():
            import warnings
            from .. import api
            run_with_retry(
                lambda: api.calibrate_backend(save_to=self.cfg.calibrate_to,
                                              device=self._device),
                policy, outcome=self.calibration)
            if not self.calibration.ok:
                warnings.warn(
                    f"background thresholds calibration to "
                    f"{self.cfg.calibrate_to!r} failed after "
                    f"{self.calibration.attempts} attempts "
                    f"({self.calibration.error}); continuing on current "
                    "thresholds", stacklevel=1)

        self._calibrate_thread = threading.Thread(target=job, daemon=True)
        self._calibrate_thread.start()

    def wait_calibration(self, timeout: float | None = None):
        if self._calibrate_thread is not None:
            self._calibrate_thread.join(timeout)

    # ------------------------------------------------------------------ run
    def run(self, state: Any, shardings: Any = None) -> Any:
        self._device = _first_device(state)
        self._install_sigterm()
        self._start_calibration()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, like=state, shardings=shardings)
            start = latest
        step = start
        while step < self.cfg.total_steps:
            try:
                state, step = self._one_step(state, step)
            except Exception as e:  # node failure path
                # the writer of a save handed off before the failure is
                # joined first: a fast step can fail before that write
                # commits, and the scan below must see it
                self.ckpt.wait()
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise RuntimeError("failure before first checkpoint") from e
                state = self.ckpt.restore(latest, like=state, shardings=shardings)
                step = latest
                continue
            if self._preempted:
                self.ckpt.save(step, state)
                break
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save_async(step, state)
        self.ckpt.wait()
        self.ckpt.save(step, state)
        return state

    def _one_step(self, state: Any, step: int):
        if self.failure_hook is not None:
            self.failure_hook(step)
        batch = self.data_fn(step)
        t0 = time.monotonic()
        state, metrics = self.train_step(state, batch)
        _sync(metrics)
        wall = time.monotonic() - t0
        straggler = False
        if self._ema is not None and wall > self.cfg.straggler_factor * self._ema:
            straggler = True
            self.straggler_events.append(step)
        # the first measured step carries the one-time work (kernel builds,
        # plan and pattern prep) — exclude it from the EMA seed or every
        # later step looks impossibly fast
        self._measured += 1
        if self._measured >= 2 and not straggler:
            self._ema = (wall if self._ema is None
                         else (1 - self.cfg.ema_alpha) * self._ema
                         + self.cfg.ema_alpha * wall)
        self.events.append(StepEvent(step, wall, {k: float(v) for k, v in metrics.items()},
                                     straggler))
        return state, step + 1


def _first_device(tree: Any):
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _sync(metrics: Any) -> None:
    """Wait for the step: a sync on the device of the first metric."""
    dev = _first_device(metrics)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
