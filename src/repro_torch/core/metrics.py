"""Evaluation metrics for ANN search (paper §4); a copy of
``repro/core/metrics.py`` (numpy only)."""
from __future__ import annotations

import time

import numpy as np

__all__ = ["recall_at_k", "percentile_ms", "LatencyTimer"]


def recall_at_k(pred_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    """Paper definition: fraction of queries whose ground-truth entity is
    among the top-k returned.  ``truth_ids`` may be (B,) — the single true
    entity (ER-style) — or (B, m) — true m nearest neighbors, in which case
    a hit means any overlap counts proportionally (recall@k over the set).
    """
    pred_ids = np.asarray(pred_ids)
    truth_ids = np.asarray(truth_ids)
    if truth_ids.ndim == 1:
        hit = (pred_ids == truth_ids[:, None]).any(axis=1)
        return float(hit.mean())
    inter = np.zeros(pred_ids.shape[0], dtype=np.float64)
    for b in range(pred_ids.shape[0]):
        inter[b] = np.intersect1d(pred_ids[b], truth_ids[b]).size
    return float((inter / truth_ids.shape[1]).mean())


def percentile_ms(samples_s: list[float], q: float = 90.0) -> float:
    """The ``q``-th percentile of latencies in seconds, in milliseconds."""
    return float(np.percentile(np.asarray(samples_s) * 1e3, q))


class LatencyTimer:
    """Collects per-call wall-clock latencies (P50/P90/P99 like the paper)."""

    def __init__(self) -> None:
        self.samples: list[float] = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    def stats(self) -> dict:
        if not self.samples:
            return {}
        a = np.asarray(self.samples) * 1e3
        return {
            "n": len(self.samples),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
        }
