"""Synthetic ANN corpora statistically matched to the paper's datasets.

A copy of ``repro/data/synthetic.py`` (numpy only), kept here so the port
imports nothing of the reference.  The same seed gives the same corpus
and queries in both packages.

  radio_station : 10 K x 256   (private VA entity embeddings)
  sift          : 1 M  x 128   (SIFT descriptors, uint8-ranged)
  deep          : 10 M x 96    (unit-norm CNN descriptors)

Sizes scale down via ``scale`` for tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CorpusSpec", "CORPORA", "make_corpus", "make_queries"]


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    name: str
    n: int
    d: int
    n_clusters: int
    unit_norm: bool = False
    uint8_range: bool = False


CORPORA = {
    "radio_station": CorpusSpec("radio_station", 10_000, 256, 64),
    "sift": CorpusSpec("sift", 1_000_000, 128, 4096, uint8_range=True),
    "deep": CorpusSpec("deep", 10_000_000, 96, 16384, unit_norm=True),
}


def make_corpus(
    spec_or_name, *, scale: float = 1.0, seed: int = 0, dtype=np.float32
) -> np.ndarray:
    """Anisotropic Gaussian-mixture corpus (chunked generation, ~O(N d))."""
    spec = CORPORA[spec_or_name] if isinstance(spec_or_name, str) else \
        spec_or_name
    n = max(64, int(spec.n * scale))
    k = max(4, int(spec.n_clusters * min(1.0, scale * 4)))
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, size=(k, spec.d)).astype(np.float32)
    # anisotropy: per-cluster axis-aligned scales, long-tailed
    scales = rng.lognormal(mean=-0.5, sigma=0.6, size=(k, spec.d)) \
        .astype(np.float32)
    out = np.empty((n, spec.d), dtype=np.float32)
    sizes = rng.multinomial(n, rng.dirichlet(np.full(k, 2.0)))
    pos = 0
    for c in range(k):
        m = sizes[c]
        if m == 0:
            continue
        out[pos : pos + m] = centers[c] + rng.normal(
            size=(m, spec.d)
        ).astype(np.float32) * scales[c]
        pos += m
    rng.shuffle(out)
    if spec.unit_norm:
        out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-12
    if spec.uint8_range:
        lo, hi = out.min(), out.max()
        out = np.round((out - lo) / (hi - lo) * 255.0)
    return out.astype(dtype)


def make_queries(
    db: np.ndarray,
    n_queries: int,
    *,
    seed: int = 0,
    noise_scale: float = 0.1,
) -> np.ndarray:
    """Held-out-style queries: perturbed corpus points (uniform likelihood)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, db.shape[0], size=n_queries)
    scale = float(np.std(db)) * noise_scale
    q = db[ids] + rng.normal(0.0, scale, size=(n_queries, db.shape[1]))
    return q.astype(np.float32)
