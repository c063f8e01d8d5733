"""Serving tier: single-replica cells and the multi-cell fleet router.

Port of ``repro/serve``:

  * :mod:`repro_torch.serve.cell` — ``ServingCell``: micro-batching,
    hedged dispatch, result cache and estimator hooks, cancellation,
    fail-fast failure; the unit of replication;
  * :mod:`repro_torch.serve.engine` — ``ServingEngine``: one cell in a
    process;
  * :mod:`repro_torch.serve.fleet` — ``CellRouter``: admission control,
    load-aware and cache-affinity dispatch, cross-cell hedging, and the
    rolling leader-driven delta fan-out across cells.
"""
from repro_torch.serve.cell import CellFailure, EngineStats, ServingCell
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.fleet import CellRouter, FleetOverloadError, build_fleet

__all__ = [
    "CellFailure",
    "CellRouter",
    "EngineStats",
    "FleetOverloadError",
    "ServingCell",
    "ServingEngine",
    "build_fleet",
]
