"""Two-level approximate search (paper §3.2, Fig. 2a).

Port of ``repro/core/two_level.py``.  Build: (1) choose partition
features (entity embeddings by default, or any low-dim metadata such as
geolocation); (2) k-means them into ``n_clusters`` sub-datasets (on the
card); (3) index the *top level* over the centroids (brute | kd-tree | PQ)
and search the *bottom level* inside the probed buckets (brute | QLBT/tree
| LSH).  Buckets are padded to a fixed width with a capacity-capped spill
to the next-nearest centroid; per-bucket trees are one concatenated
*forest* (one node table + per-bucket root ids) so the beam descent is one
batched call.

The index keeps its tables as host numpy arrays, as the reference does;
``device`` is where ``search`` runs.  The tables are placed there at the
first search and reused until a mutation drops them.

Mutation model (the online lifecycle, numpy copies of the reference's):

  * ``add_entities``    - route new vectors to the nearest centroid with a
    free bucket slot (spill to next-nearest, grow the pad on overflow) and
    rebuild *only the dirty buckets'* trees;
  * ``delete_entities`` - tombstones: the db row stays (ids are stable),
    the bucket slot is swap-filled for reuse, and forest leaves are masked
    in place so a deleted id can never be returned;
  * ``refresh_forest`` / ``rebalance`` / ``reboost`` - rebuild dirty
    trees; a Lloyd step restricted to drifted buckets; the QLBT re-split
    of every bucket tree for a new likelihood.

Each mutation records what it dirtied in a ``DeltaLog``; ``pop_delta()``
emits the ``DeltaManifest`` that ``ShardedSearchBackend.apply_updates``
scatters in place.  Every mutation drops the placed search tables
(``_placed``), so the next search places the mutated index.

The PQ top level scores the centroid codes with the ``pq_adc_topk``
kernel, where the reference calls its jnp ``adc_scores``
(``repro/core/pq.py:8-10`` names the kernel as that scan's home); the
results are the same up to the order of the ADC sum.  The brute bottom
runs the whole probe chain through ``bucket_probe_topk_op`` (the
``candidate_topk`` kernel, rows read from the corpus by entity id), where
the reference runs its ``_probe_scan_brute`` loop (its docstring names the
kernel tile loop over the probed buckets as the loop's home): the same
ids up to rounding, except that a bucket probed twice is emitted once on
the card (ROADMAP fault 5).  The LSH bottom's probe scan, the
reference's jitted ``lax.scan`` ``_probe_scan_lsh``, runs through
``lsh_probe_shortlist_op`` (on the card one ``lsh_probe`` launch a query
chunk, the same shortlist id for id; the product ``q @ proj`` stays a
matmul, as in the reference).  Every other step is plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.core.brute import pairwise_l2sq
from repro_torch.core.delta import DeltaLog, DeltaManifest
from repro_torch.core.kmeans import _assign_topm, kmeans_fit
from repro_torch.core.lsh import LSHIndex, lsh_build, pack_bits
from repro_torch.core.pq import ProductQuantizer, adc_lut, pq_train
from repro_torch.core.tree import (FlatTree, build_kd_tree, build_qlbt,
                                   build_rp_tree)
from repro_torch.device import require_fp32_matmul, resolve
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.common import stable_topk
from repro_torch.kernels.ops import (bucket_probe_topk_op,
                                     lsh_probe_shortlist_op, pq_adc_topk_op)
from repro_torch.obs.trace import get_tracer

__all__ = ["TwoLevelConfig", "TwoLevelIndex", "build_two_level",
           "check_sidecars"]

TOP_ALGOS = ("brute", "kdtree", "pq")
BOTTOM_ALGOS = ("brute", "tree", "qlbt", "lsh")


@dataclasses.dataclass
class TwoLevelConfig:
    n_clusters: int = 1024
    top: str = "brute"            # brute | kdtree | pq
    bottom: str = "brute"         # brute | tree | qlbt | lsh
    pq_m: int = 8                 # top-level PQ subspaces
    lsh_bits: int = 64
    kmeans_iters: int = 10
    kmeans_minibatch: Optional[int] = 262144
    bucket_cap: Optional[int] = None   # pad width; default = capped max
    tree_leaf: int = 8
    tree_candidates: int = 4
    qlbt_boost_depth: int = 3
    qlbt_lambda: float = 0.5
    seed: int = 0


def check_levels(config: TwoLevelConfig) -> None:
    if config.top not in TOP_ALGOS:
        raise ValueError(f"top must be one of {TOP_ALGOS}")
    if config.bottom not in BOTTOM_ALGOS:
        raise ValueError(f"bottom must be one of {BOTTOM_ALGOS}")


@dataclasses.dataclass
class _Forest:
    """Per-bucket trees concatenated into one node table.

    ``trees`` keeps the per-bucket :class:`FlatTree` segments (leaf ids
    already global) so a mutation can rebuild one bucket's tree and
    re-concatenate without touching the other K-1; ``arrays`` are the
    concatenated host tables ``tree_search`` reads (see
    :meth:`FlatTree.device_arrays`)."""
    arrays: dict                  # host numpy node tables
    roots: np.ndarray             # (K,) int32 root node per bucket
    max_depth: int
    nbytes: int
    trees: Optional[list] = None  # per-bucket FlatTrees (global leaf ids)


@dataclasses.dataclass
class TwoLevelIndex:
    config: TwoLevelConfig
    db: np.ndarray                      # (N, d) float32 original vectors
    centroids: np.ndarray               # (K, d)
    bucket_ids: np.ndarray              # (K, cap) int32, -1 padded
    bucket_counts: np.ndarray           # (K,)
    top_pq: Optional[ProductQuantizer] = None
    top_kd: Optional[FlatTree] = None
    bottom_lsh: Optional[LSHIndex] = None
    forest: Optional[_Forest] = None
    alive: Optional[np.ndarray] = None          # (N,) bool, False = tombstone
    entity_bucket: Optional[np.ndarray] = None  # (N,) int32, -1 = deleted
    dirty: Optional[np.ndarray] = None          # (K,) bool, membership changed
    p: Optional[np.ndarray] = None              # (N,) likelihood (qlbt)
    part_feats: Optional[np.ndarray] = None     # (N, pd) if built on features
    n_adds: int = 0                             # mutations since last rebalance
    n_deletes: int = 0
    # last fully-BUILT per-bucket trees: reboost always derives from these,
    # never from a previous reboost (chained re-splits compound float
    # relocations until recall erodes).  None until the first reboost.
    base_trees: Optional[list] = None
    mutation_version: int = 0                   # bumped per mutation batch
    delta_log: Optional[DeltaLog] = dataclasses.field(default=None,
                                                      repr=False)
    device: Optional[torch.device] = None       # where search runs
    # per-entity sidecars, row-aligned with db: a MetadataTable (filters)
    # and LexicalSlabs (lexical / hybrid modes), placed by the backend
    metadata: Optional[object] = dataclasses.field(default=None, repr=False)
    lexical: Optional[object] = dataclasses.field(default=None, repr=False)
    # the search tables on the device, placed by the first search and
    # dropped by every mutation (a copy made with dataclasses.replace
    # starts without them)
    _placed: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def n(self) -> int:
        return int(self.db.shape[0])

    @property
    def n_live(self) -> int:
        return self.n if self.alive is None else int(self.alive.sum())

    @property
    def k_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def feats(self) -> np.ndarray:
        """Partition-feature view of the corpus (db itself by default)."""
        return self.db if self.part_feats is None else self.part_feats

    # ---------------- mutation (online lifecycle) ----------------
    def _ensure_mutable(self):
        """Lazily create mutation state for indexes built before it."""
        if self.alive is None:
            self.alive = np.ones(self.n, dtype=bool)
        if self.dirty is None:
            self.dirty = np.zeros(self.k_clusters, dtype=bool)
        if self.entity_bucket is None:
            self.entity_bucket = entity_buckets(self.bucket_ids, self.n)
        if self.delta_log is None:
            # created BEFORE the first mutation touches any state, so
            # base_n/base_version name the last published snapshot
            self.delta_log = DeltaLog(
                base_version=self.mutation_version, base_n=self.n)

    def _drop_placed(self) -> None:
        """Forget the placed search tables: the next search places the
        mutated index (a search already running keeps the old dict)."""
        self._placed = {}

    def pop_delta(self) -> DeltaManifest:
        """Emit (and reset) the record of everything mutated since the
        last pop: the input to ``ShardedSearchBackend.apply_updates(target,
        delta=...)``.  The manifest is metadata only; the payload is
        sliced from the index's *current* state at apply time."""
        self._ensure_mutable()
        return self.delta_log.pop(self.mutation_version, self.n)

    def _place(self, feat_rows: np.ndarray, gids: np.ndarray) -> None:
        """Route rows into buckets: nearest centroid with a free slot,
        spill to next-nearest, grow the pad width on overflow.  Marks the
        receiving buckets dirty."""
        top_b, _ = _assign_topm(feat_rows, self.centroids,
                                min(4, self.k_clusters), device=self.device)
        cap = self.bucket_ids.shape[1]
        counts = self.bucket_counts.astype(np.int64).copy()
        for j in range(gids.size):
            for b in top_b[j]:
                if counts[b] < cap:
                    break
            else:
                b = int(top_b[j, 0])
                if counts[b] >= cap:          # grow the pad width
                    grow = max(8, cap // 4)
                    self.bucket_ids = np.pad(
                        self.bucket_ids, ((0, 0), (0, grow)),
                        constant_values=-1)
                    cap += grow
            self.bucket_ids[b, counts[b]] = gids[j]
            counts[b] += 1
            self.entity_bucket[gids[j]] = b
            self.dirty[b] = True
            self.delta_log.mark_buckets(b)
        self.bucket_counts = counts.astype(np.int32)

    def add_entities(
        self,
        new_vecs: np.ndarray,
        *,
        partition_features: Optional[np.ndarray] = None,
        p: Optional[np.ndarray] = None,
        refresh: bool = True,
        metadata: Optional[dict] = None,
        docs: Optional[list] = None,
    ) -> np.ndarray:
        """Incremental insert for every bottom level; returns the new
        global entity ids (db rows are append-only, so ids never shift).

        Routing reuses the build's capped spill; freed (tombstoned) slots
        are reused before the pad grows.  Bottom-level upkeep: brute -
        none; lsh - append packed codes under the shared projections;
        tree/qlbt - rebuild the *dirty buckets'* trees only (with
        ``refresh=False`` the new entities stay invisible to the forest
        descent until ``refresh_forest()``).  ``metadata`` (column name ->
        values) and ``docs`` (token lists) grow the index's sidecars in
        lockstep.  Centroids are NOT refit here (``rebalance()`` does).
        """
        self._ensure_mutable()
        new_vecs = np.ascontiguousarray(new_vecs, dtype=np.float32)
        if self.part_feats is not None:
            if partition_features is None:
                raise ValueError(
                    "index was built on side partition features; "
                    "add_entities needs partition_features for new rows")
            partition_features = np.ascontiguousarray(
                partition_features, np.float32)
            if partition_features.shape[0] != new_vecs.shape[0]:
                raise ValueError(
                    f"partition_features has {partition_features.shape[0]} "
                    f"rows for {new_vecs.shape[0]} new vectors")
        elif partition_features is not None:
            raise ValueError(
                "index was built on the embeddings themselves; "
                "partition_features would be silently ignored")
        m = new_vecs.shape[0]
        start = self.n
        ids = np.arange(start, start + m, dtype=np.int32)
        self.db = np.concatenate([self.db, new_vecs], axis=0)
        self.alive = np.concatenate([self.alive, np.ones(m, bool)])
        self.entity_bucket = np.concatenate(
            [self.entity_bucket, np.full(m, -1, np.int32)])
        if self.part_feats is not None:
            self.part_feats = np.concatenate(
                [self.part_feats, partition_features])
        if self.p is not None:
            if p is None:
                # no traffic estimate yet: assume average likelihood
                p = np.full(m, float(np.mean(self.p)), self.p.dtype)
            self.p = np.concatenate([self.p, np.asarray(p, self.p.dtype)])

        if self.metadata is not None:
            # rows not named in ``metadata`` get the column fill (0),
            # appended before _place so a failed placement can't leave
            # the table short of the db
            self.metadata.append_rows(metadata or {}, m)
        elif metadata:
            raise ValueError(
                "index has no metadata table; build with metadata= to "
                "accept per-entity metadata on add_entities")
        if self.lexical is not None:
            self.lexical.append_docs(
                docs if docs is not None else [[] for _ in range(m)])
        elif docs is not None:
            raise ValueError(
                "index has no lexical slabs; build with lexical= to "
                "accept docs on add_entities")

        feat_rows = (new_vecs if self.part_feats is None
                     else self.part_feats[ids])
        self._place(feat_rows, ids)
        self.n_adds += m

        if self.bottom_lsh is not None:
            bits = (new_vecs @ self.bottom_lsh.proj > 0).astype(np.uint8)
            self.bottom_lsh.codes = np.concatenate(
                [self.bottom_lsh.codes, pack_bits(bits)], axis=0)
            self.delta_log.lsh_rows += m
        self.mutation_version += 1
        if self.forest is not None and refresh:
            self.refresh_forest()
        self._drop_placed()
        return ids

    def delete_entities(self, ids: np.ndarray) -> None:
        """Tombstone-delete: swap-fill the bucket slot for reuse, mask any
        forest leaves holding the id, keep the db row (stable ids).  A
        deleted id is immediately invisible on every search path."""
        self._ensure_mutable()
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self.n:
            raise ValueError("delete_entities: id out of range")
        if not self.alive[ids].all():
            raise ValueError("delete_entities: id already deleted")
        for e in ids:
            b = int(self.entity_bucket[e])
            row = self.bucket_ids[b]
            col = int(np.nonzero(row == e)[0][0])
            last = int(self.bucket_counts[b]) - 1
            row[col] = row[last]              # swap-fill the hole
            row[last] = -1
            self.bucket_counts[b] = last
            self.dirty[b] = True
            self.delta_log.mark_buckets(b)
        self.alive[ids] = False
        self.entity_bucket[ids] = -1
        self.delta_log.mark_tombstones(ids)
        self.n_deletes += ids.size
        self.mutation_version += 1
        if self.forest is not None:
            # mask in the concatenated tables AND the per-bucket segments
            # so a later partial refresh can't resurrect a deleted id
            le = self.forest.arrays["leaf_entities"].copy()
            le[np.isin(le, ids) & (le >= 0)] = -1
            self.forest.arrays["leaf_entities"] = le
            if self.forest.trees is not None:
                for t in self.forest.trees:
                    t.drop_entities(ids)
        if self.base_trees is not None:
            # the reboost base must drop the ids too, or the next reboost
            # would resurrect them
            for t in self.base_trees:
                t.drop_entities(ids)
        self._drop_placed()

    def refresh_forest(self) -> int:
        """Rebuild the trees of dirty buckets only and re-concatenate the
        forest (clears the dirty flags; no-op for non-tree bottoms).
        Returns #buckets rebuilt."""
        self._ensure_mutable()
        if self.forest is None:
            self.dirty[:] = False
            return 0
        if not self.dirty.any():
            return 0
        rebuilt = 0
        for b in np.nonzero(self.dirty)[0]:
            ids = self.bucket_ids[b][: self.bucket_counts[b]]
            ids = ids[ids >= 0]
            self.forest.trees[b] = bucket_tree(
                self.db, ids.astype(np.int64), self.config, self.p, int(b))
            if self.base_trees is not None:
                self.base_trees[b] = self.forest.trees[b]
            self.delta_log.mark_buckets(b)
            rebuilt += 1
        self.mutation_version += 1
        self.dirty[:] = False
        # publish with a single reference swap: a reader snapshotting
        # self.forest never sees new roots with old arrays
        self.forest = concat_forest(self.forest.trees)
        self._drop_placed()
        return rebuilt

    def rebalance(
        self,
        *,
        drift_threshold: float = 0.25,
        recenter: bool = True,
    ) -> dict:
        """Restore partition quality after accumulated mutations.

        A bucket has *drifted* when its live-member mean (in partition-
        feature space) moved more than ``drift_threshold`` of the bucket's
        own radius from the stored centroid.  Drifted buckets get one
        restricted Lloyd step (centroid to the member mean) and their
        members are re-routed through the capped assignment; then the
        top-level index over the centroids (PQ, retrained on ``device``,
        or kd) is rebuilt, every dirty bucket's tree is rebuilt and the
        mutation counters are cleared.

        Returns ``n_drifted``, ``n_moved``, ``n_rebuilt_buckets``,
        ``max_drift``.
        """
        self._ensure_mutable()
        K = self.k_clusters
        feats = self.feats
        drifted, max_drift = [], 0.0
        means = {}
        for b in range(K):
            ids = self.bucket_ids[b][: self.bucket_counts[b]]
            ids = ids[ids >= 0]
            if ids.size == 0:
                continue
            fb = feats[ids]
            mean = fb.mean(axis=0)
            radius = float(
                np.sqrt(((fb - self.centroids[b]) ** 2).sum(1).mean()))
            drift = float(np.linalg.norm(mean - self.centroids[b]))
            rel = drift / max(radius, 1e-12)
            max_drift = max(max_drift, rel)
            if rel > drift_threshold:
                drifted.append(b)
                means[b] = mean
        moved_ids = []
        if drifted and recenter:
            if not self.centroids.flags.writeable:
                self.centroids = np.array(self.centroids, np.float32)
            for b in drifted:
                self.centroids[b] = means[b]
            # pull every member of a drifted bucket and re-route it
            for b in drifted:
                ids = self.bucket_ids[b][: self.bucket_counts[b]]
                ids = ids[ids >= 0]
                moved_ids.append(ids.astype(np.int64))
                self.bucket_ids[b, :] = -1
                self.bucket_counts[b] = 0
                self.entity_bucket[ids] = -1
                self.dirty[b] = True
                self.delta_log.mark_buckets(b)
            moved = np.concatenate(moved_ids) if moved_ids else \
                np.zeros(0, np.int64)
            if moved.size:
                self._place(feats[moved], moved)
            # centroids changed -> the top-level index over them is stale
            if self.top_pq is not None:
                self.top_pq = pq_train(
                    self.centroids, m=self.config.pq_m,
                    seed=self.config.seed, train_sample=None,
                    device=self.device)
            if self.top_kd is not None:
                self.top_kd = build_kd_tree(self.centroids, leaf_size=4)
        n_rebuilt = self.refresh_forest()
        self.n_adds = 0
        self.n_deletes = 0
        self.mutation_version += 1
        self._drop_placed()
        return {
            "n_drifted": len(drifted),
            "n_moved": int(sum(x.size for x in moved_ids)),
            "n_rebuilt_buckets": n_rebuilt,
            "max_drift": max_drift,
        }

    def reboost(
        self,
        p: np.ndarray,
        *,
        frontier_depth: Optional[int] = None,
        max_move: float = 0.3,
    ) -> dict:
        """Incremental likelihood re-boost for the forest bottom.

        Stores ``p`` as the new traffic estimate and re-runs the boosted
        top-level splits of every per-bucket tree via
        :meth:`FlatTree.reboost` (subtrees below the frontier are reused),
        always from the last fully built trees (``base_trees``).  Pending
        dirty buckets are rebuilt first.  The rebuilt forest is swapped in
        with one reference assignment.  No-op (beyond storing ``p``) for
        brute/LSH bottoms.  Returns ``n_reboosted`` buckets re-split and
        ``n_refreshed`` dirty buckets rebuilt from scratch.
        """
        self._ensure_mutable()
        p = np.asarray(p, dtype=np.float64)
        if p.shape[0] != self.n:
            raise ValueError(
                f"p has {p.shape[0]} entries for {self.n} entities")
        self.p = p
        if self.forest is None or self.forest.trees is None:
            self.mutation_version += 1
            return {"n_reboosted": 0, "n_refreshed": 0}
        cfg = self.config
        p_eff = np.where(self.alive, p, 0.0)
        if self.base_trees is None:
            self.base_trees = list(self.forest.trees)
        n_ref = 0
        refreshed = set()
        for b in np.nonzero(self.dirty)[0]:
            ids = self.bucket_ids[b][: self.bucket_counts[b]]
            ids = ids[ids >= 0]
            self.base_trees[b] = bucket_tree(
                self.db, ids.astype(np.int64), cfg, self.p, int(b))
            # self.dirty may predate the last pop_delta (deferred refresh):
            # the rebuilt tree must re-enter the CURRENT log
            self.delta_log.mark_buckets(b)
            refreshed.add(int(b))
            n_ref += 1
        n_re = 0
        trees = list(self.base_trees)
        for b, t in enumerate(trees):
            if t.n_nodes <= 1 or b in refreshed:
                # freshly rebuilt buckets were built with the new p
                continue
            trees[b] = t.reboost(
                self.db, p_eff,
                boost_depth=cfg.qlbt_boost_depth,
                frontier_depth=frontier_depth,
                n_candidates=cfg.tree_candidates,
                lam=cfg.qlbt_lambda,
                max_move=max_move,
                seed=cfg.seed + b)
            self.delta_log.mark_buckets(b)
            n_re += 1
        self.forest = concat_forest(trees)   # one swap for readers
        self.dirty[:] = False
        self.mutation_version += 1
        self._drop_placed()
        return {"n_reboosted": n_re, "n_refreshed": n_ref}

    def footprint_bytes(self, include_db: bool = True) -> int:
        tot = self.centroids.nbytes + self.bucket_ids.nbytes
        tot += self.bucket_counts.nbytes
        if include_db:
            tot += self.db.nbytes
        if self.top_pq is not None:
            tot += self.top_pq.footprint_bytes()
        if self.top_kd is not None:
            tot += self.top_kd.footprint_bytes()
        if self.bottom_lsh is not None:
            tot += self.bottom_lsh.footprint_bytes()
        if self.forest is not None:
            tot += self.forest.nbytes
        return tot

    # ---------------- search ----------------
    def _tables(self, dev: torch.device) -> dict:
        """The search tables on ``dev``, placed once."""
        t = self._placed.get(dev)
        if t is not None:
            return t

        def put(a):
            return torch.as_tensor(a, device=dev)

        t = {"db": put(self.db), "centroids": put(self.centroids),
             "bucket_ids": put(self.bucket_ids),
             "bucket_counts": put(self.bucket_counts)}
        if self.top_pq is not None:
            t["pq_codebooks"] = put(self.top_pq.codebooks)
            t["pq_codes"] = put(self.top_pq.codes)
        if self.top_kd is not None:
            t["kd"] = self.top_kd.device_arrays(dev)
        if self.bottom_lsh is not None:
            t["lsh_codes"] = put(self.bottom_lsh.codes)
            t["lsh_proj"] = put(self.bottom_lsh.proj)
        if self.forest is not None:
            t["forest"] = {n: put(a) for n, a in self.forest.arrays.items()}
            t["forest_roots"] = put(self.forest.roots)
        self._placed[dev] = t
        return t

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        nprobe: int = 8,
        beam_width: int = 8,
        lsh_candidates: int = 128,
        query_chunk: int = 1024,
        query_partition_features: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Returns (dists (B,k), ids (B,k), work dict), numpy.

        ``query_partition_features`` must be supplied when the index was
        built on side features (e.g. geolocation) — the top level probes in
        partition-feature space, the bottom level in embedding space.
        """
        dev = resolve(self.device)
        require_fp32_matmul()
        t = self._tables(dev)
        q = np.ascontiguousarray(queries, dtype=np.float32)
        qp = (
            q
            if query_partition_features is None
            else np.ascontiguousarray(query_partition_features, np.float32)
        )
        outs_d, outs_i = [], []
        work = {"top_scored": 0, "candidates": 0}
        for s in range(0, q.shape[0], query_chunk):
            qc = torch.as_tensor(q[s:s + query_chunk], device=dev)
            qpc = torch.as_tensor(qp[s:s + query_chunk], device=dev)
            d, i, w = self._search_chunk(
                t, qc, qpc, k, nprobe=nprobe, beam_width=beam_width,
                lsh_candidates=lsh_candidates,
            )
            outs_d.append(d.cpu().numpy())
            outs_i.append(i.cpu().numpy())
            for key in work:
                work[key] += int(w[key])
        return np.concatenate(outs_d), np.concatenate(outs_i), work

    def _search_chunk(self, t, q, qp, k, *, nprobe, beam_width,
                      lsh_candidates):
        nprobe = min(nprobe, self.k_clusters)
        buckets, top_work = self._top_probe(t, qp, nprobe)   # (B, nprobe)
        B = q.shape[0]
        work = {"top_scored": top_work * B}

        bottom = self.config.bottom
        if bottom == "brute":
            # the whole probe chain: on the card one scan and one merge
            # launch of candidate_topk a pass, rows read by entity id
            d, i = bucket_probe_topk_op(q, buckets, t["bucket_ids"], k,
                                        db=t["db"])
            counts = t["bucket_counts"][buckets.long()]
            work["candidates"] = int(counts.sum())
            return d, i, work
        if bottom == "lsh":
            cap = self.bucket_ids.shape[1]
            shortlist = min(lsh_candidates, nprobe * cap)
            # every mutation keeps a row's live ids before its count, so
            # the counts are the kernel's extents
            cand = lsh_probe_shortlist_op(
                q @ t["lsh_proj"], t["lsh_codes"], t["bucket_ids"],
                buckets.to(torch.int32), shortlist,
                extents=t["bucket_counts"].to(torch.int32))
            work["candidates"] = int(cand.shape[0] * cand.shape[1])
            d, i = _rerank(t["db"], q, cand, k)
            return d, i, work
        # tree / qlbt forest
        cand = self._forest_candidates(t, q, buckets, beam_width)
        work["candidates"] = int((cand >= 0).sum())
        d, i = _rerank(t["db"], q, cand, k)
        return d, i, work

    def _top_probe(self, t, qp, nprobe):
        """Top-level search over centroids -> (bucket ids, work/query)."""
        top = self.config.top
        if top == "brute":
            _, b = stable_topk(pairwise_l2sq(qp, t["centroids"]), nprobe)
            return b, self.k_clusters
        if top == "pq":
            lut = adc_lut(qp, t["pq_codebooks"])
            _, b = pq_adc_topk_op(lut, t["pq_codes"], nprobe)
            return b, self.k_clusters  # ADC ops, cheaper per item
        if top == "kdtree":
            res = tree_mod.tree_search(
                t["kd"], t["centroids"], qp, kind="kd",
                beam_width=max(2 * nprobe, 8), k=nprobe,
                max_steps=self.top_kd.max_depth + 4,
            )
            return (torch.clamp(res.ids, min=0),
                    int(res.candidates.to(torch.float32).mean()))
        raise ValueError(f"unknown top {top!r}")

    def _forest_candidates(self, t, q, buckets, beam_width):
        """Descend each probed bucket's tree; union of leaf candidates."""
        B, nprobe = buckets.shape
        roots = t["forest_roots"][buckets.long()]             # (B, np)
        qq = torch.repeat_interleave(q, nprobe, dim=0)        # (B*np, d)
        res = tree_mod.tree_search(
            t["forest"], t["db"], qq,
            kind="rp", beam_width=beam_width,
            k=beam_width * self.config.tree_leaf,
            max_steps=self.forest.max_depth + 4,
            rerank=False, roots=roots.reshape(-1),
        )
        return res.ids.reshape(B, -1)


def _first_occurrences(cand: torch.Tensor) -> torch.Tensor:
    """``cand`` with every repeat of an id but its first occurrence set
    to -1 (the same entity can enter via two overlapping probes):
    stable-sort the ids, flag every repeat of its left neighbour and
    scatter the flags back, so one entity holds at most one top-k slot."""
    B = cand.shape[0]
    order = torch.sort(cand, dim=1, stable=True).indices
    sorted_ids = torch.gather(cand, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=cand.device),
         (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)],
        dim=1,
    )
    dup = torch.zeros(cand.shape, dtype=torch.bool,
                      device=cand.device).scatter(1, order, dup_sorted)
    return torch.where(dup, -1, cand)


def _rerank(db, q, cand, k):
    """The exact top-``min(k, C)`` of each query's candidate ids, an id
    counted once: the rows-by-id rerank (one kernel launch a pass on the
    card, the rows read by id; on the CPU its plain version, the gathered
    tile's distances sorted as the reference's ``_rerank`` sorts them)."""
    d, ids = kernel_ops.candidate_rows_topk_op(
        q, db, _first_occurrences(cand).to(torch.int32), k)
    k = min(k, cand.shape[1])
    return d[:, :k], ids[:, :k].to(cand.dtype)


def check_sidecars(n: int, metadata=None, lexical=None) -> None:
    """The metadata table and the lexical slabs must hold one row per
    corpus row."""
    if metadata is not None and metadata.n_rows != n:
        raise ValueError(
            f"metadata table has {metadata.n_rows} rows for a {n}-row db")
    if lexical is not None and lexical.n_docs != n:
        raise ValueError(
            f"lexical slabs hold {lexical.n_docs} docs for a {n}-row db")


def build_two_level(
    db: np.ndarray,
    config: TwoLevelConfig,
    *,
    p: Optional[np.ndarray] = None,
    partition_features: Optional[np.ndarray] = None,
    metadata=None,
    lexical=None,
    device=None,
) -> TwoLevelIndex:
    """Paper §3.2 build: partition features -> k-means (on the card unless
    ``device`` says otherwise) -> capped bucket fill -> per-level indexes.
    ``p`` is the traffic likelihood a QLBT bottom boosts with;
    ``metadata`` (a :class:`repro_torch.core.metadata.MetadataTable`) and
    ``lexical`` (a :class:`repro_torch.core.lexical.LexicalSlabs`) are
    optional row-aligned sidecars.  Each stage is a span of the process
    tracer (``build.kmeans``, ``build.assign``, ``build.top``,
    ``build.bottom``)."""
    check_levels(config)
    dev = resolve(device)
    tracer = get_tracer()
    db = np.ascontiguousarray(db, dtype=np.float32)
    n = db.shape[0]
    check_sidecars(n, metadata, lexical)
    feats = db if partition_features is None else np.ascontiguousarray(
        partition_features, dtype=np.float32)
    k = min(config.n_clusters, n)
    with tracer.span("build.kmeans", k=k):
        km = kmeans_fit(feats, k, iters=config.kmeans_iters,
                        seed=config.seed, minibatch=config.kmeans_minibatch,
                        device=dev)
    counts = np.bincount(km.assignments, minlength=k)
    if config.bucket_cap is not None:
        cap = config.bucket_cap
    else:
        # fixed pad width keeps probe tiles dense; spill overflow to the
        # next-nearest centroid instead of padding to the max bucket
        cap = int(min(counts.max(), max(int(np.ceil(2.5 * n / k)), 32)))
    with tracer.span("build.assign", cap=cap):
        bucket_ids, counts = _capped_assign(feats, km.centroids, k, cap,
                                            device=dev)
    idx = TwoLevelIndex(
        config=config, db=db, centroids=km.centroids,
        bucket_ids=bucket_ids, bucket_counts=counts.astype(np.int32),
        alive=np.ones(n, dtype=bool),
        entity_bucket=entity_buckets(bucket_ids, n),
        dirty=np.zeros(k, dtype=bool),
        p=None if p is None else np.asarray(p, np.float64),
        part_feats=None if partition_features is None else feats,
        device=dev, metadata=metadata, lexical=lexical)
    with tracer.span("build.top", top=config.top):
        if config.top == "pq":
            idx.top_pq = pq_train(km.centroids, m=config.pq_m,
                                  seed=config.seed, train_sample=None,
                                  device=dev)
        elif config.top == "kdtree":
            idx.top_kd = build_kd_tree(km.centroids, leaf_size=4)
    with tracer.span("build.bottom", bottom=config.bottom):
        if config.bottom == "lsh":
            idx.bottom_lsh = lsh_build(db, n_bits=config.lsh_bits,
                                       seed=config.seed)
        elif config.bottom in ("tree", "qlbt"):
            idx.forest = build_forest(db, bucket_ids, counts, config, idx.p)
    return idx


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


def bucket_tree(db, ids, config: TwoLevelConfig, p, b: int) -> FlatTree:
    """Build one bucket's tree with leaf entity ids remapped to *global*
    ids (a numpy copy of the reference's build, so the same arrays)."""
    ids = np.asarray(ids, dtype=np.int64)
    sub = db[ids] if ids.size else np.zeros((1, db.shape[1]), np.float32)
    if config.bottom == "qlbt" and p is not None and ids.size:
        t = build_qlbt(
            sub, p[ids], leaf_size=config.tree_leaf,
            n_candidates=config.tree_candidates,
            boost_depth=config.qlbt_boost_depth,
            lam=config.qlbt_lambda, seed=config.seed + b,
        )
    else:
        t = build_rp_tree(
            sub, leaf_size=config.tree_leaf,
            n_candidates=config.tree_candidates, seed=config.seed + b,
        )
    le = t.leaf_entities.copy()
    if ids.size:
        mask = le >= 0
        le[mask] = ids[le[mask]].astype(le.dtype)
    else:
        le[:] = -1
    return dataclasses.replace(t, leaf_entities=le)


def build_forest(db, bucket_ids, counts, config: TwoLevelConfig, p):
    """Concatenate per-bucket trees into one node table (global entity ids)."""
    trees: list[FlatTree] = []
    for b in range(bucket_ids.shape[0]):
        ids = bucket_ids[b][: counts[b]]
        ids = ids[ids >= 0]
        trees.append(bucket_tree(db, ids, config, p, b))
    return concat_forest(trees)


def concat_forest(trees: list) -> _Forest:
    """Concatenate per-bucket trees into one SoA node table.

    Leaf tables may have different widths — they are right-padded to the
    widest.
    """
    roots = np.zeros(len(trees), dtype=np.int32)
    offset = 0
    for b, t in enumerate(trees):
        roots[b] = offset
        offset += t.n_nodes

    def cat(field, fill_shift=None):
        parts = []
        shift = 0
        for t in trees:
            v = getattr(t, field)
            if fill_shift is not None:
                v = v.copy()
                mask = v >= 0
                v[mask] += shift
            parts.append(v)
            shift += t.n_nodes
        return np.concatenate(parts, axis=0)

    # leaf_row indexes into the concatenated leaf table -> shift by leaves
    leaf_rows = []
    lshift = 0
    for t in trees:
        lr = t.leaf_row.copy()
        lr[lr >= 0] += lshift
        lshift += t.n_leaves
        leaf_rows.append(lr)

    leaf_w = max(t.leaf_entities.shape[1] for t in trees)
    leaf_parts = [
        np.pad(t.leaf_entities,
               ((0, 0), (0, leaf_w - t.leaf_entities.shape[1])),
               constant_values=-1)
        for t in trees
    ]
    arrays = dict(
        proj=cat("proj"),
        dims=cat("dims"),
        tau=cat("tau"),
        children=cat("children", fill_shift=True),
        leaf_row=np.concatenate(leaf_rows),
        leaf_entities=np.concatenate(leaf_parts, axis=0),
    )
    return _Forest(
        arrays=arrays, roots=roots,
        max_depth=max(t.max_depth for t in trees),
        nbytes=sum(int(v.nbytes) for v in arrays.values()),
        trees=trees,
    )
