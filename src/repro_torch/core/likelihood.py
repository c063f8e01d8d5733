"""Query-likelihood tooling (paper §4.2).

A copy of ``repro/core/likelihood.py`` (numpy only), kept here so the port
imports nothing of the reference: the same seed gives the same ``p`` and
the same queries in both packages.

The paper characterizes traffic skew with an information-entropy based
"unbalance score"::

    U(p) = 1 - H(p) / log2(N),   H(p) = -sum_i p_i log2 p_i

U = 0 for uniform traffic, U -> 1 as all mass concentrates on one entity.
The real Radio-Station traffic in the paper has U = 0.23.

Traffic is simulated by sampling entity weights from a Beta(a, b)
distribution and normalizing (§4.2).  ``beta_for_unbalance`` inverts the
simulation: it searches Beta shape parameters that achieve a target
unbalance score so Fig.-1-style sweeps can be reproduced exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "unbalance_score",
    "simulate_beta_likelihood",
    "beta_for_unbalance",
    "zipf_likelihood",
    "empirical_likelihood",
    "decayed_empirical_likelihood",
    "sample_queries",
]


def unbalance_score(p: np.ndarray) -> float:
    """1 - H(p)/log2(N); 0 == uniform, ~1 == fully concentrated."""
    p = np.asarray(p, dtype=np.float64)
    if p.ndim != 1:
        raise ValueError(f"p must be 1-D, got shape {p.shape}")
    n = p.size
    if n <= 1:
        return 1.0
    s = p.sum()
    if s <= 0:
        raise ValueError("p must have positive mass")
    p = p / s
    nz = p[p > 0]
    h = -(nz * np.log2(nz)).sum()
    return float(1.0 - h / np.log2(n))


def simulate_beta_likelihood(
    rng: np.random.Generator, n: int, a: float, b: float
) -> np.ndarray:
    """Sample a query-likelihood vector for ``n`` entities (paper §4.2)."""
    w = rng.beta(a, b, size=n)
    w = np.maximum(w, 1e-12)
    return w / w.sum()


def beta_for_unbalance(
    target: float,
    n: int,
    seed: int = 0,
    b: float = 8.0,
    tol: float = 5e-3,
    max_iter: int = 60,
) -> tuple[float, float, np.ndarray]:
    """Find Beta(a, b) whose normalized sample has ``unbalance_score ~ target``.

    Lowering ``a`` concentrates mass (higher unbalance).  Deterministic given
    ``seed``.  Returns (a, achieved_score, p).
    """
    if not 0.0 <= target < 1.0:
        raise ValueError("target unbalance must be in [0, 1)")
    lo, hi = 1e-3, 64.0

    def score_for(a: float) -> tuple[float, np.ndarray]:
        p = simulate_beta_likelihood(np.random.default_rng(seed), n, a, b)
        return unbalance_score(p), p

    s_lo, _ = score_for(lo)
    s_hi, _ = score_for(hi)
    # unbalance decreases as `a` grows; clamp target into achievable range.
    for _ in range(max_iter):
        mid = np.sqrt(lo * hi)
        s, p = score_for(mid)
        if abs(s - target) < tol:
            return mid, s, p
        if s > target:
            lo = mid
        else:
            hi = mid
    s, p = score_for(np.sqrt(lo * hi))
    return float(np.sqrt(lo * hi)), s, p


def zipf_likelihood(n: int, alpha: float = 1.0) -> np.ndarray:
    """Zipfian likelihood (classic fathead/long-tail traffic)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def empirical_likelihood(query_ids: np.ndarray, n: int, smoothing: float = 0.5):
    """Estimate p from an observed query log.

    The ``smoothing`` term is Laplace-style additive smoothing: every
    entity's count gets ``+ smoothing`` pseudo-observations before
    normalization, so unseen entities keep a small positive likelihood
    (the default 0.5 is the Jeffreys prior) instead of an exact zero that
    a KL-divergence drift check could not handle.
    """
    counts = np.bincount(np.asarray(query_ids, dtype=np.int64), minlength=n)
    counts = counts.astype(np.float64) + smoothing
    return counts / counts.sum()


def decayed_empirical_likelihood(
    query_ids: np.ndarray,
    n: int,
    halflife: float,
    smoothing: float = 0.5,
    *,
    prior_counts: Optional[np.ndarray] = None,
    return_counts: bool = False,
):
    """Exponentially-decayed empirical likelihood from a query log.

    The observation ``t`` positions before the newest carries weight
    ``0.5 ** (t / halflife)`` — the estimator tracks *recent* traffic, the
    regime index maintenance cares about, rather than the all-time
    average (``halflife=np.inf`` recovers :func:`empirical_likelihood`).
    ``smoothing`` is the same Laplace-style additive term.

    ``prior_counts`` chains calls over a stream: pass the counts returned
    by the previous call (``return_counts=True``) and they are decayed by
    the new batch's total age before being added, so feeding a log in
    batches is exactly equivalent to one call over the concatenated log.
    Shared by ``repro.adaptive.OnlineLikelihoodEstimator`` (its exact,
    sketch-free mode) and the benchmarks.
    """
    ids = np.asarray(query_ids, dtype=np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"query id out of range [0, {n})")
    t = ids.size
    if t:
        age = (t - 1) - np.arange(t)
        w = 0.5 ** (age / halflife) if np.isfinite(halflife) else \
            np.ones(t, np.float64)
        counts = np.bincount(ids, weights=w, minlength=n)
    else:
        counts = np.zeros(n, np.float64)
    if prior_counts is not None:
        decay = 0.5 ** (t / halflife) if np.isfinite(halflife) else 1.0
        counts = counts + np.asarray(prior_counts, np.float64) * decay
    p = counts + smoothing
    p = p / p.sum()
    return (p, counts) if return_counts else p


def sample_queries(
    rng: np.random.Generator,
    embeddings: np.ndarray,
    p: np.ndarray,
    n_queries: int,
    noise_scale: float = 0.05,
) -> tuple[np.ndarray, np.ndarray]:
    """Draw queries from the entity distribution ``p`` (paper §4.2).

    Each query is its ground-truth entity's embedding plus Gaussian noise
    scaled by ``noise_scale``·(mean pairwise scale), mimicking ASR/embedding
    noise around the true entity.  Returns (queries, ground_truth_ids).
    """
    n, d = embeddings.shape
    ids = rng.choice(n, size=n_queries, p=p / p.sum())
    scale = float(np.std(embeddings)) * noise_scale
    q = embeddings[ids] + rng.normal(0.0, scale, size=(n_queries, d))
    return q.astype(np.float32), ids.astype(np.int32)
