"""Fault tolerance: watchdog, straggler detection, restart-on-failure --
the port's copy of ``repro/train/fault.py`` (numpy only).

On a real multi-host deployment the same hooks attach to the coordinator:
the watchdog flags hosts whose step time exceeds ``factor`` x the rolling
median (straggler mitigation: evict/hedge), and ``run_with_restart``
implements the checkpoint-restart contract — any crash inside the loop
resumes from the last committed checkpoint with identical data order
(stateless `batch_at(step)` samplers).  Tests inject faults mid-run and
assert bit-identical continuation vs an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["FaultInjected", "Watchdog", "run_with_restart",
           "make_fault_injector"]


class FaultInjected(RuntimeError):
    """Simulated node failure."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class Watchdog:
    """Rolling-median step-time monitor with straggler events."""

    def __init__(self, factor: float = 3.0, window: int = 50,
                 warmup: int = 5):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []

    def observe(self, step: int, duration: float):
        self.durations.append(duration)
        hist = self.durations[-self.window:]
        if len(hist) <= self.warmup:
            return
        med = float(np.median(hist[:-1]))
        if duration > self.factor * med:
            self.events.append(StragglerEvent(step, duration, med))

    @property
    def straggler_steps(self):
        return [e.step for e in self.events]


def make_fault_injector(fail_at_steps, *, once: bool = True):
    """Raise FaultInjected when the loop reaches the given steps."""
    remaining = set(fail_at_steps)

    def inject(step: int):
        if step in remaining:
            if once:
                remaining.discard(step)
            raise FaultInjected(f"injected failure at step {step}")

    return inject


def run_with_restart(
    run_fn: Callable[[Optional[int]], "object"],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
):
    """Crash-loop supervisor.

    ``run_fn(resume_step)`` must itself load the latest checkpoint when
    resume_step is not None.  Returns (result, n_restarts).
    """
    restarts = 0
    resume = None
    while True:
        try:
            return run_fn(resume), restarts
        except FaultInjected as e:  # real deployments catch host failures
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            resume = -1          # sentinel: resume from latest checkpoint
            time.sleep(0.01)     # backoff placeholder
