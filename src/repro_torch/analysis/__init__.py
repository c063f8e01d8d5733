"""Compile-path and concurrency lint for the port: the counterpart of
``repro.analysis``.

Three rule families enforce the invariants the serving-latency claims
rest on:

* :mod:`repro_torch.analysis.torchlint` -- no host syncs, branches on
  tensor values or implicit dtypes in ``@hot_path`` code, no
  out-of-place scatters assigned back to their source, no unbucketed
  pads at a hot call;
* :mod:`repro_torch.analysis.locks` -- every write to a shared attribute
  is dominated by the class's designated lock (``@guarded_by`` declares
  methods that require it);
* :mod:`repro_torch.analysis.recompile` -- the registered entry points
  (:mod:`repro_torch.analysis.registry`) keep a fixed set of compiled
  variants across mutation-perturbed shapes.

CLI: ``python -m repro_torch.analysis src/repro_torch [--strict]
[--device cpu|cuda]``.  Suppress a finding inline with
``# repro: allow(<rule>): <why>``, as in the reference.
"""
from repro_torch.analysis.annotations import guarded_by, hot_path
from repro_torch.analysis.core import (
    STATIC_RULES,
    Finding,
    Suppression,
    collect_suppressions,
    run_static_analysis,
)

__all__ = [
    "Finding", "Suppression", "collect_suppressions",
    "run_static_analysis", "STATIC_RULES", "guarded_by", "hot_path",
]
