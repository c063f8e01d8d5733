"""End-to-end observability, the port of ``repro.obs``: metrics registry,
request tracing, and one-time-cost and kernel profiling.

Three submodules, one per concern:

* :mod:`repro_torch.obs.metrics` -- fixed-footprint counters/gauges/
  log-scale histograms with JSON snapshot + Prometheus text exposition;
* :mod:`repro_torch.obs.trace` -- span API with propagated trace ids and
  Chrome-trace/Perfetto export;
* :mod:`repro_torch.obs.profile` -- dispatch-signature and kernel-build
  accounting, per-entry-point replay profiling, and the analytic
  bytes/FLOPs cost model.

``python -m repro_torch.obs.smoke`` checks the three surfaces on a short
fleet workload.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, merge_snapshots,
                                     parse_exposition)
from repro_torch.obs.profile import (PROFILE, backend_cost,
                                     install_compile_hooks,
                                     profile_entry_points)
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PROFILE",
    "Tracer",
    "backend_cost",
    "get_tracer",
    "install_compile_hooks",
    "merge_snapshots",
    "parse_exposition",
    "profile_entry_points",
    "set_tracer",
]
