"""On-device search configuration protocol (paper §5.3).

A copy of ``repro/core/protocol.py`` over the port's ``TwoLevelConfig``:
the same inputs give the same decisions.

Encodes the paper's decision tree verbatim:

  N < 30K:
    traffic distribution available      -> QLBT
    traffic distribution not available  -> standard projection tree
  N >= 30K:
    partition feature high-dim (embeddings) -> two-level PQ top + brute
        bottom, ~100 entities per bucket
    partition feature low-dim (geo)         -> two-level kd-tree top;
        bottom brute if <=100 entities/bucket else tree
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.two_level import TwoLevelConfig

__all__ = ["IndexSpec", "select_index_spec", "SMALL_CORPUS_THRESHOLD",
           "TARGET_BUCKET_ENTITIES"]

SMALL_CORPUS_THRESHOLD = 30_000     # paper Fig. 3 crossover
TARGET_BUCKET_ENTITIES = 100        # paper §5.2 optimum
LOW_DIM_THRESHOLD = 8               # "low dimension (e.g., geolocation)"


@dataclasses.dataclass
class IndexSpec:
    kind: str                                  # "qlbt" | "tree" | "two_level"
    two_level: Optional[TwoLevelConfig] = None
    reason: str = ""


def select_index_spec(
    n_entities: int,
    *,
    traffic_available: bool = False,
    partition_dim: Optional[int] = None,
    embedding_dim: int = 128,
    avg_bucket_entities: int = TARGET_BUCKET_ENTITIES,
) -> IndexSpec:
    """Paper §5.3 guideline, mechanized."""
    if n_entities < SMALL_CORPUS_THRESHOLD:
        if traffic_available:
            return IndexSpec("qlbt", reason="N<30K and traffic known (§5.3)")
        return IndexSpec("tree", reason="N<30K, no traffic (§5.3)")

    part_dim = embedding_dim if partition_dim is None else partition_dim
    n_clusters = max(1, int(round(n_entities / avg_bucket_entities)))
    # round to a power of two like the paper's 2^s sweeps
    n_clusters = 1 << max(0, int(round(np.log2(n_clusters))))

    if part_dim > LOW_DIM_THRESHOLD:
        cfg = TwoLevelConfig(n_clusters=n_clusters, top="pq", bottom="brute")
        return IndexSpec(
            "two_level", cfg,
            reason=f"N>=30K, high-dim partition feature -> PQ top + brute "
                   f"bottom, {n_clusters} buckets (~{avg_bucket_entities}/"
                   f"bucket) (§5.3)",
        )
    avg = n_entities / n_clusters
    bottom = "brute" if avg <= TARGET_BUCKET_ENTITIES else "tree"
    cfg = TwoLevelConfig(n_clusters=n_clusters, top="kdtree", bottom=bottom)
    return IndexSpec(
        "two_level", cfg,
        reason=f"N>=30K, low-dim partition feature -> kd-tree top + "
               f"{bottom} bottom (§5.3)",
    )
