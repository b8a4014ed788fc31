"""Fault tolerance for long training runs (the port's numpy-only copy of
``repro.runtime.fault_tolerance``, held equal to it by a test).

* ``FailureInjector``   — deterministic pseudo-random failure injection
                          (chaos testing of the restart path);
* ``TrainSupervisor``   — runs the train loop under a retry policy: on a
                          failure the loop restores the latest checkpoint
                          and replays the data stream (a deterministic
                          pipeline, so the recovery is bit-identical);
* ``StragglerMonitor``  — per-step wall-time EWMA; steps slower than
                          ``threshold x`` the EWMA are flagged and handed
                          to the mitigation hook.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class SimulatedFailure(RuntimeError):
    """Injected failure (stands in for a lost worker or a link timeout)."""


class FailureInjector:
    def __init__(self, rate: float = 0.0, seed: int = 0,
                 failure_steps: Optional[List[int]] = None):
        self.rate = rate
        self.rng = np.random.default_rng(seed)
        self.forced = set(failure_steps or [])
        self.injected: List[int] = []

    def maybe_fail(self, step: int):
        if step in self.forced or (self.rate > 0 and
                                   self.rng.random() < self.rate):
            if step not in self.injected:
                self.injected.append(step)
                raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    flagged: bool


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 on_straggler: Optional[Callable[[StepRecord], None]] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.records: List[StepRecord] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, seconds: float) -> StepRecord:
        flagged = self.ewma is not None and \
            seconds > self.threshold * self.ewma
        rec = StepRecord(step, seconds, flagged)
        self.records.append(rec)
        if flagged and self.on_straggler:
            self.on_straggler(rec)
        if not flagged:  # don't poison the EWMA with outliers
            self.ewma = seconds if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * seconds
        return rec

    @property
    def straggler_steps(self) -> List[int]:
        return [r.step for r in self.records if r.flagged]


class TrainSupervisor:
    """Retry-from-checkpoint execution of a train loop.

    The caller provides ``run_segment(start_step) -> next_step`` which
    raises on failure after persisting progress via the checkpoint
    manager; the supervisor restores and resumes. ``max_restarts`` bounds
    the retry budget (a real deployment escalates after that).
    """

    def __init__(self, max_restarts: int = 3):
        self.max_restarts = max_restarts
        self.restarts: List[Dict[str, Any]] = []

    def run(self, run_segment: Callable[[int], int], start_step: int,
            total_steps: int) -> int:
        step = start_step
        while step < total_steps:
            try:
                step = run_segment(step)
            except SimulatedFailure as e:
                if len(self.restarts) >= self.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted: {e}") from e
                self.restarts.append({"at_step": step, "error": str(e),
                                      "time": time.time()})
                # run_segment restores from the latest checkpoint itself;
                # we simply re-enter. step stays (segment re-reads ckpt).
        return step
