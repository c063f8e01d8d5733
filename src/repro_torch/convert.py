"""Carry a built index and its sidecars across from the reference.

``index_from_arrays`` builds the port's :class:`TwoLevelIndex` from the
numpy arrays of an index built by the reference package, so both
packages search the *same* buckets; ``metadata_from_arrays`` and
``lexical_from_arrays`` do the same for the metadata table and the
postings slabs.  They see numpy arrays, scalars and a config dict only,
never an object of the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lexical import LexicalSlabs
from repro_torch.core.metadata import MetadataTable
from repro_torch.core.two_level import (TwoLevelConfig, TwoLevelIndex,
                                        _check_levels, check_sidecars,
                                        entity_buckets)
from repro_torch.device import resolve

__all__ = ["index_from_arrays", "metadata_from_arrays",
           "lexical_from_arrays"]


def metadata_from_arrays(columns: dict) -> MetadataTable:
    """``columns``: name -> (N,) integer array."""
    return MetadataTable({name: np.array(col, dtype=np.int32)
                          for name, col in columns.items()})


def lexical_from_arrays(arrays: dict, params: dict) -> LexicalSlabs:
    """``arrays``: ``terms`` (N, S), ``tf_sat`` (N, S), ``idf`` (V,);
    ``params``: the scalars ``k1``, ``b``, ``avg_len``."""
    return LexicalSlabs(
        terms=np.array(arrays["terms"], dtype=np.int32, order="C"),
        tf_sat=np.array(arrays["tf_sat"], dtype=np.float32, order="C"),
        idf=np.array(arrays["idf"], dtype=np.float32),
        k1=float(params["k1"]), b=float(params["b"]),
        avg_len=float(params["avg_len"]))


def index_from_arrays(arrays: dict, config: dict, device=None, *,
                      metadata=None, lexical=None) -> TwoLevelIndex:
    """``arrays``: ``db`` (N, d), ``centroids`` (K, d), ``bucket_ids``
    (K, cap) -1 padded, ``bucket_counts`` (K,), optionally ``alive`` (N,).
    ``config``: keyword arguments of :class:`TwoLevelConfig`.
    ``metadata`` / ``lexical``: the port's sidecars (see the two helpers
    above), one row per corpus row."""
    cfg = TwoLevelConfig(**config)
    _check_levels(cfg)
    # the index owns writable copies of its tables
    db = np.array(arrays["db"], dtype=np.float32, order="C")
    bucket_ids = np.array(arrays["bucket_ids"], dtype=np.int32, order="C")
    n, k = db.shape[0], bucket_ids.shape[0]
    check_sidecars(n, metadata, lexical)
    alive = arrays.get("alive")
    return TwoLevelIndex(
        config=cfg, db=db,
        centroids=np.array(arrays["centroids"], dtype=np.float32, order="C"),
        bucket_ids=bucket_ids,
        bucket_counts=np.array(arrays["bucket_counts"], dtype=np.int32),
        alive=(np.ones(n, dtype=bool) if alive is None
               else np.array(alive, dtype=bool)),
        entity_bucket=entity_buckets(bucket_ids, n),
        dirty=np.zeros(k, dtype=bool), device=resolve(device),
        metadata=metadata, lexical=lexical)
