"""Carry a built index and its sidecars across from the reference.

``index_from_arrays`` builds the port's :class:`TwoLevelIndex` from the
numpy arrays of an index built by the reference package, so both
packages search the *same* buckets, PQ codes, kd tree, LSH codes and
per-bucket trees; ``tree_from_arrays`` does the same for one
:class:`FlatTree` (a one-level index's tree); ``metadata_from_arrays``
and ``lexical_from_arrays`` for the metadata table and the postings
slabs.  They see numpy arrays, scalars and a config dict only, never an
object of the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lexical import LexicalSlabs
from repro_torch.core.lsh import LSHIndex
from repro_torch.core.metadata import MetadataTable
from repro_torch.core.pq import ProductQuantizer
from repro_torch.core.tree import FlatTree
from repro_torch.core.two_level import (TwoLevelConfig, TwoLevelIndex,
                                        check_levels, check_sidecars,
                                        concat_forest, entity_buckets)
from repro_torch.device import resolve

__all__ = ["index_from_arrays", "tree_from_arrays", "metadata_from_arrays",
           "lexical_from_arrays"]

TREE_ARRAYS = ("proj", "dims", "tau", "children", "leaf_row",
               "leaf_entities", "depth", "entity_depth")


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


def tree_from_arrays(arrays: dict) -> FlatTree:
    """``arrays``: ``kind`` ("rp" or "kd") and the :class:`FlatTree`
    tables ``proj``, ``dims``, ``tau``, ``children``, ``leaf_row``,
    ``leaf_entities``, ``depth``, ``entity_depth``."""
    dtypes = {"proj": np.float32, "tau": np.float32}
    return FlatTree(kind=str(arrays["kind"]), **{
        name: np.array(arrays[name], dtype=dtypes.get(name, np.int32),
                       order="C")
        for name in TREE_ARRAYS})


def index_from_arrays(arrays: dict, config: dict, device=None, *,
                      metadata=None, lexical=None) -> TwoLevelIndex:
    """``arrays``: ``db`` (N, d), ``centroids`` (K, d), ``bucket_ids``
    (K, cap) -1 padded, ``bucket_counts`` (K,), and optionally ``alive``
    (N,), ``p`` (N,) and ``part_feats`` (N, pd); per level, as
    ``config["top"]`` / ``config["bottom"]`` need them: ``pq_codebooks``
    (M, 256, ds) and ``pq_codes`` (K, M); ``kd`` (a dict for
    :func:`tree_from_arrays`); ``lsh_proj`` (d, bits) and ``lsh_codes``
    (N, W); ``forest`` (a list of K such dicts, one per bucket, leaf ids
    global).  ``config``: keyword arguments of :class:`TwoLevelConfig`.
    ``metadata`` / ``lexical``: the port's sidecars (see the two helpers
    above), one row per corpus row."""
    cfg = TwoLevelConfig(**config)
    check_levels(cfg)
    # the index owns writable copies of its tables
    db = np.array(arrays["db"], dtype=np.float32, order="C")
    bucket_ids = np.array(arrays["bucket_ids"], dtype=np.int32, order="C")
    n, k = db.shape[0], bucket_ids.shape[0]
    check_sidecars(n, metadata, lexical)
    alive = arrays.get("alive")
    p = arrays.get("p")
    part_feats = arrays.get("part_feats")
    idx = TwoLevelIndex(
        config=cfg, db=db,
        centroids=np.array(arrays["centroids"], dtype=np.float32, order="C"),
        bucket_ids=bucket_ids,
        bucket_counts=np.array(arrays["bucket_counts"], dtype=np.int32),
        alive=(np.ones(n, dtype=bool) if alive is None
               else np.array(alive, dtype=bool)),
        entity_bucket=entity_buckets(bucket_ids, n),
        dirty=np.zeros(k, dtype=bool),
        p=None if p is None else np.array(p, dtype=np.float64),
        part_feats=(None if part_feats is None
                    else np.array(part_feats, dtype=np.float32, order="C")),
        device=resolve(device), metadata=metadata, lexical=lexical)
    if cfg.top == "pq":
        codebooks = np.array(arrays["pq_codebooks"], dtype=np.float32,
                             order="C")
        idx.top_pq = ProductQuantizer(
            codebooks=codebooks,
            codes=np.array(arrays["pq_codes"], dtype=np.uint8, order="C"),
            d=idx.centroids.shape[1])
    elif cfg.top == "kdtree":
        idx.top_kd = tree_from_arrays(arrays["kd"])
    if cfg.bottom == "lsh":
        proj = np.array(arrays["lsh_proj"], dtype=np.float32, order="C")
        idx.bottom_lsh = LSHIndex(
            proj=proj,
            codes=np.array(arrays["lsh_codes"], dtype=np.int32, order="C"),
            n_bits=proj.shape[1])
    elif cfg.bottom in ("tree", "qlbt"):
        idx.forest = concat_forest([tree_from_arrays(t)
                                    for t in arrays["forest"]])
    return idx
