"""Single-replica serving engine: the one-cell alias of ``ServingCell``.

Port of ``repro/serve/engine.py``.  The batching, hedging, cache and
telemetry live in :mod:`repro_torch.serve.cell`; ``ServingEngine`` is
the name for running exactly one cell in a process.  Code composing
several replicas uses :class:`repro_torch.serve.cell.ServingCell` and
:class:`repro_torch.serve.fleet.CellRouter` directly.
"""
from __future__ import annotations

from repro_torch.serve.cell import CellFailure, EngineStats, ServingCell, _bucket

__all__ = ["ServingEngine", "EngineStats", "CellFailure"]


class ServingEngine(ServingCell):
    """One-cell process: the same surface as :class:`ServingCell`."""


# the power-of-two helper, re-exported as the reference's module does
_bucket = _bucket
