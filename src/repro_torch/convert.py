"""Carry a built index across from the reference.

``index_from_arrays`` builds the port's :class:`TwoLevelIndex` from the
numpy arrays of an index built by the reference package, so both
packages search the *same* buckets.  It sees numpy arrays and a config
dict only, never an object of the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.two_level import (TwoLevelConfig, TwoLevelIndex,
                                        _check_levels, entity_buckets)
from repro_torch.device import resolve

__all__ = ["index_from_arrays"]


def index_from_arrays(arrays: dict, config: dict, device=None
                      ) -> TwoLevelIndex:
    """``arrays``: ``db`` (N, d), ``centroids`` (K, d), ``bucket_ids``
    (K, cap) -1 padded, ``bucket_counts`` (K,), optionally ``alive`` (N,).
    ``config``: keyword arguments of :class:`TwoLevelConfig`."""
    cfg = TwoLevelConfig(**config)
    _check_levels(cfg)
    # the index owns writable copies of its tables
    db = np.array(arrays["db"], dtype=np.float32, order="C")
    bucket_ids = np.array(arrays["bucket_ids"], dtype=np.int32, order="C")
    n, k = db.shape[0], bucket_ids.shape[0]
    alive = arrays.get("alive")
    return TwoLevelIndex(
        config=cfg, db=db,
        centroids=np.array(arrays["centroids"], dtype=np.float32, order="C"),
        bucket_ids=bucket_ids,
        bucket_counts=np.array(arrays["bucket_counts"], dtype=np.int32),
        alive=(np.ones(n, dtype=bool) if alive is None
               else np.array(alive, dtype=bool)),
        entity_bucket=entity_buckets(bucket_ids, n),
        dirty=np.zeros(k, dtype=bool), device=resolve(device))
