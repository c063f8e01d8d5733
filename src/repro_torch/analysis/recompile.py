"""Recompile-stability gate: registered entry points must keep a fixed
set of compiled variants across mutation-perturbed shapes.  The port of
``repro/analysis/recompile.py``.

Nothing is traced in the port, so a "recompile" is what the backends
count as a compiled variant (``ShardedSearchBackend.jit_cache_size``): a
new dispatch signature (mode, padded operand shape, dtype) after the
power-of-two warm-up, a placement that changed the device tables'
shapes, or a kernel library loaded after construction; and, for the
delta scatter, a new power-of-two scatter shape (``delta_cache_size``).
Each entry in :mod:`repro_torch.analysis.registry` builds a real backend
on one shard, on the device the caller names (the card by default), and
returns a :class:`Plan` -- an ordered list of ``(label, thunk)`` steps
(searches, mutations, delta applies, reboosts) plus a ``cache_size``
probe.  The runner executes the steps in order, snapshots the count
after the warm-up steps, and reports a ``recompile`` finding for every
later step that changes it -- with the step label, so the finding names
the mutation that introduced the new variant.

Findings carry the source location of the entry point's plan factory in
``registry.py`` so they participate in the same suppression mechanism
as the static rules.  A plan factory or step that *raises* is reported as
``entry-point-error`` -- a gate that silently skips a broken entry point
would report stability it never measured.

The gate logs through :mod:`repro_torch.obs`: every run records per-step
wall times and recompiles into the process-wide ``PROFILE`` registry
(``gate_step_ms``, ``gate_recompiles``) and emits
``gate.entry-point``/``gate.step`` spans and ``gate-recompile`` instants,
so a gate run under an active tracer shows up on the same Perfetto
timeline as the serving traffic it certifies.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Iterable, Optional

from repro_torch.analysis.core import Finding
from repro_torch.obs.profile import PROFILE
from repro_torch.obs.trace import get_tracer

__all__ = ["Plan", "run_entry_point", "run_recompile_gate"]


@dataclasses.dataclass
class Plan:
    """One entry point's executable stability plan.

    steps      : ordered ``(label, thunk)`` pairs; the first
                 ``warmup_steps`` are warm-ups (their variants are
                 expected -- one per distinct pow2 shape bucket the entry
                 point legitimately serves)
    cache_size : zero-arg probe returning the compiled-variant count of
                 the callable under test (< 0 = not measurable; the plan
                 is skipped)
    """

    steps: list
    cache_size: Callable[[], int]
    warmup_steps: int = 1


def _loc(make_plan) -> tuple:
    code = getattr(make_plan, "func", make_plan).__code__    # a partial's too
    path = code.co_filename
    rel = os.path.relpath(path)
    return (rel if not rel.startswith("..") else path,
            code.co_firstlineno)


def run_entry_point(name: str, make_plan: Callable[[], Plan]) -> list:
    """Run one entry point's plan (``make_plan()`` makes it: a registered
    factory bound to its device); returns its findings."""
    path, line = _loc(make_plan)
    tracer = get_tracer()
    h_step = PROFILE.histogram("gate_step_ms", lo=1e-3, hi=1e7)
    with tracer.span("gate.entry-point", entry=name) as esp:
        try:
            plan = make_plan()
        except Exception as e:
            esp.set(error=type(e).__name__)
            return [Finding(
                "entry-point-error", path, line, 1,
                f"{name}: plan factory failed: {e!r}")]
        findings: list = []
        baseline: Optional[int] = None
        for step_i, (label, thunk) in enumerate(plan.steps):
            t0 = time.perf_counter()
            try:
                with tracer.span("gate.step", entry=name, step=label):
                    thunk()
            except Exception as e:
                findings.append(Finding(
                    "entry-point-error", path, line, 1,
                    f"{name}: step '{label}' failed: {e!r}"))
                return findings
            h_step.observe((time.perf_counter() - t0) * 1e3)
            size = plan.cache_size()
            if size < 0:
                return findings      # not measurable: skip
            if step_i < plan.warmup_steps or baseline is None:
                baseline = size      # warm-up variants are expected
            elif size != baseline:
                PROFILE.counter("gate_recompiles").inc()
                tracer.instant("gate-recompile", entry=name, step=label,
                               variants=size)
                findings.append(Finding(
                    "recompile", path, line, 1,
                    f"{name}: step '{label}' changed the "
                    f"compile-signature set ({baseline} -> {size} cached "
                    "variants) -- a mutation-perturbed shape reached the "
                    "entry point"))
                baseline = size      # report each new trigger once
        esp.set(steps=len(plan.steps),
                variants=baseline if baseline is not None else -1)
    return findings


def run_recompile_gate(entry_points: Optional[Iterable[str]] = None, *,
                       device=None) -> list:
    """Run every registered entry point (or the named subset), its
    backends built on ``device`` (default the card)."""
    from repro_torch.analysis.registry import ENTRY_POINTS

    names = sorted(ENTRY_POINTS) if entry_points is None \
        else list(entry_points)
    findings: list = []
    for name in names:
        findings.extend(run_entry_point(
            name, functools.partial(ENTRY_POINTS[name], device=device)))
    return findings
