"""Two-level approximate search (paper §3.2, Fig. 2a): brute top level,
brute bottom level.

Port of the ``top="brute"``, ``bottom="brute"`` subset of
``repro/core/two_level.py``.  Build: k-means the corpus into
``n_clusters`` buckets (on the card), pad every bucket to a fixed width
with a capacity-capped spill to the next-nearest centroid, and record the
mutation state the reference keeps.  Search: score the centroids, probe
the ``nprobe`` nearest buckets, and stream them with a running top-k
merge.

The index keeps its tables as host numpy arrays, as the reference does;
``device`` is where ``search`` runs and where a backend places them.
Every other top/bottom level and every mutation method raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.core.kmeans import _assign_topm, kmeans_fit
from repro_torch.device import resolve
from repro_torch.kernels.common import stable_topk

__all__ = ["TwoLevelConfig", "TwoLevelIndex", "build_two_level",
           "check_sidecars"]

TOP_ALGOS = ("brute", "kdtree", "pq")
BOTTOM_ALGOS = ("brute", "tree", "qlbt", "lsh")
_PORTED = ("brute",)
_LATER_LEVELS = ("ROADMAP.md, 'Modules still to port': the PQ/kd top "
                 "levels and the tree/QLBT/LSH bottom levels")
_LATER_MUTATION = ("ROADMAP.md, 'Modules still to port': mutation and "
                   "delta republish")


@dataclasses.dataclass
class TwoLevelConfig:
    n_clusters: int = 1024
    top: str = "brute"            # brute (pq, kdtree: not ported yet)
    bottom: str = "brute"         # brute (tree, qlbt, lsh: not ported yet)
    kmeans_iters: int = 10
    kmeans_minibatch: Optional[int] = 262144
    bucket_cap: Optional[int] = None   # pad width; default = capped max
    seed: int = 0


def _check_levels(config: TwoLevelConfig) -> None:
    if config.top not in TOP_ALGOS:
        raise ValueError(f"top must be one of {TOP_ALGOS}")
    if config.bottom not in BOTTOM_ALGOS:
        raise ValueError(f"bottom must be one of {BOTTOM_ALGOS}")
    if config.top not in _PORTED or config.bottom not in _PORTED:
        raise NotImplementedError(
            f"top={config.top!r}, bottom={config.bottom!r}: only brute/brute "
            f"is ported; see {_LATER_LEVELS}")


@dataclasses.dataclass
class TwoLevelIndex:
    config: TwoLevelConfig
    db: np.ndarray                      # (N, d) float32 original vectors
    centroids: np.ndarray               # (K, d)
    bucket_ids: np.ndarray              # (K, cap) int32, -1 padded
    bucket_counts: np.ndarray           # (K,)
    alive: Optional[np.ndarray] = None          # (N,) bool, False = tombstone
    entity_bucket: Optional[np.ndarray] = None  # (N,) int32, -1 = deleted
    dirty: Optional[np.ndarray] = None          # (K,) bool, membership changed
    device: Optional[torch.device] = None       # where search runs
    # per-entity sidecars, row-aligned with db: a MetadataTable (filters)
    # and LexicalSlabs (lexical / hybrid modes), placed by the backend
    metadata: Optional[object] = dataclasses.field(default=None, repr=False)
    lexical: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def n(self) -> int:
        return int(self.db.shape[0])

    @property
    def n_live(self) -> int:
        return self.n if self.alive is None else int(self.alive.sum())

    @property
    def k_clusters(self) -> int:
        return int(self.centroids.shape[0])

    # ---------------- mutation: a later slice ----------------
    def add_entities(self, *args, **kwargs):
        raise NotImplementedError(f"add_entities: see {_LATER_MUTATION}")

    def delete_entities(self, *args, **kwargs):
        raise NotImplementedError(f"delete_entities: see {_LATER_MUTATION}")

    def rebalance(self, *args, **kwargs):
        raise NotImplementedError(f"rebalance: see {_LATER_MUTATION}")

    def reboost(self, *args, **kwargs):
        raise NotImplementedError(f"reboost: see {_LATER_MUTATION}")

    def pop_delta(self, *args, **kwargs):
        raise NotImplementedError(f"pop_delta: see {_LATER_MUTATION}")

    # ---------------- search ----------------
    def search(self, queries: np.ndarray, k: int = 10, *, nprobe: int = 8,
               query_chunk: int = 1024):
        """Returns (dists (B, k), ids (B, k), work dict), numpy."""
        dev = resolve(self.device)
        q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32),
                            device=dev)
        db = torch.as_tensor(self.db, device=dev)
        cents = torch.as_tensor(self.centroids, device=dev)
        bids = torch.as_tensor(self.bucket_ids, device=dev)
        counts = torch.as_tensor(self.bucket_counts, device=dev)
        nprobe = min(nprobe, self.k_clusters)
        outs_d, outs_i = [], []
        work = {"top_scored": 0, "candidates": 0}
        for s in range(0, q.shape[0], query_chunk):
            qc = q[s:s + query_chunk]
            _, buckets = stable_topk(pairwise_l2sq(qc, cents), nprobe)
            work["top_scored"] += self.k_clusters * qc.shape[0]
            work["candidates"] += int(counts[buckets].sum())
            d, i = _probe_scan_brute(db, bids, buckets, qc, k)
            outs_d.append(d.cpu().numpy())
            outs_i.append(i.cpu().numpy())
        return np.concatenate(outs_d), np.concatenate(outs_i), work


def _probe_scan_brute(db, bucket_ids, buckets, q, k):
    """Stream probed buckets with a running top-k merge (bounded memory):
    one probe step gathers a (B, cap, d) tile."""
    B = q.shape[0]
    best_d = q.new_full((B, k), float("inf"))
    best_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for j in range(buckets.shape[1]):
        cand = bucket_ids[buckets[:, j]]                   # (B, cap)
        vecs = db[torch.clamp(cand, min=0).long()]         # (B, cap, d)
        d2 = torch.where(cand >= 0, batched_l2sq(vecs, q), float("inf"))
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, cand], dim=1)
        best_d, sel = stable_topk(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def check_sidecars(n: int, metadata=None, lexical=None) -> None:
    """The metadata table and the lexical slabs must hold one row per
    corpus row."""
    if metadata is not None and metadata.n_rows != n:
        raise ValueError(
            f"metadata table has {metadata.n_rows} rows for a {n}-row db")
    if lexical is not None and lexical.n_docs != n:
        raise ValueError(
            f"lexical slabs hold {lexical.n_docs} docs for a {n}-row db")


def build_two_level(db: np.ndarray, config: TwoLevelConfig, *,
                    metadata=None, lexical=None,
                    device=None) -> TwoLevelIndex:
    """Paper §3.2 build, brute/brute: k-means (on the card unless
    ``device`` says otherwise) -> capped bucket fill.  ``metadata`` (a
    :class:`repro_torch.core.metadata.MetadataTable`) and ``lexical`` (a
    :class:`repro_torch.core.lexical.LexicalSlabs`) are optional
    row-aligned sidecars."""
    _check_levels(config)
    dev = resolve(device)
    db = np.ascontiguousarray(db, dtype=np.float32)
    n = db.shape[0]
    check_sidecars(n, metadata, lexical)
    k = min(config.n_clusters, n)
    km = kmeans_fit(db, k, iters=config.kmeans_iters, seed=config.seed,
                    minibatch=config.kmeans_minibatch, device=dev)
    counts = np.bincount(km.assignments, minlength=k)
    if config.bucket_cap is not None:
        cap = config.bucket_cap
    else:
        # fixed pad width keeps probe tiles dense; spill overflow to the
        # next-nearest centroid instead of padding to the max bucket
        cap = int(min(counts.max(), max(int(np.ceil(2.5 * n / k)), 32)))
    bucket_ids, counts = _capped_assign(db, km.centroids, k, cap, device=dev)
    return TwoLevelIndex(
        config=config, db=db, centroids=km.centroids,
        bucket_ids=bucket_ids, bucket_counts=counts.astype(np.int32),
        alive=np.ones(n, dtype=bool),
        entity_bucket=entity_buckets(bucket_ids, n),
        dirty=np.zeros(k, dtype=bool), device=dev, metadata=metadata,
        lexical=lexical)


def entity_buckets(bucket_ids: np.ndarray, n: int) -> np.ndarray:
    """(N,) bucket of every entity, -1 for an entity in no bucket."""
    eb = np.full(n, -1, dtype=np.int32)
    rr, cc = np.nonzero(bucket_ids >= 0)
    eb[bucket_ids[rr, cc]] = rr
    return eb


def _capped_assign(feats: np.ndarray, centroids: np.ndarray, k: int,
                   cap: int, m: int = 4, *, device=None):
    """Capacity-capped bucket fill with spill to next-nearest centroid.

    Round r offers every unplaced entity a seat in its r-th nearest bucket;
    seats go to the closest applicants.  Entities unplaced after ``m``
    rounds land in the globally least-loaded bucket (rare at cap>=2x mean).
    Returns (bucket_ids (k, cap) int32 -1-padded, counts (k,) int32).
    """
    n = feats.shape[0]
    top_b, top_d = _assign_topm(feats, centroids, min(m, k), device=device)
    bucket_of = np.full(n, -1, dtype=np.int64)
    fill = np.zeros(k, dtype=np.int64)
    unplaced = np.arange(n, dtype=np.int64)
    for r in range(top_b.shape[1]):
        if unplaced.size == 0:
            break
        b = top_b[unplaced, r].astype(np.int64)
        d = top_d[unplaced, r]
        order = np.lexsort((d, b))
        bs, ids = b[order], unplaced[order]
        first = np.searchsorted(bs, bs, side="left")
        rank = np.arange(bs.size) - first
        ok = rank < cap - fill[bs]
        placed_ids, placed_b = ids[ok], bs[ok]
        bucket_of[placed_ids] = placed_b
        fill += np.bincount(placed_b, minlength=k)
        unplaced = ids[~ok]
    for e in unplaced:                      # rare fallback
        b = int(np.argmin(fill))
        bucket_of[e] = b
        fill[b] += 1
    cap_eff = int(max(cap, fill.max()))
    bucket_ids = np.full((k, cap_eff), -1, dtype=np.int32)
    order = np.argsort(bucket_of, kind="stable")
    offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(fill, out=offsets[1:])
    sorted_ids = np.arange(n, dtype=np.int32)[order]
    for b in range(k):
        ids = sorted_ids[offsets[b]: offsets[b + 1]]
        bucket_ids[b, : ids.size] = ids
    return bucket_ids, fill.astype(np.int32)
