"""Unified index API: build from an IndexSpec, search with one signature.

Port of ``repro/core/index.py``, the public entry point of the index
layer: ``auto_build_index`` applies the paper's §5.3 protocol, and
``SearchIndex.search`` runs the one-level tree descent (QLBT or the
balanced projection tree) or the two-level search.  Search runs on the
card unless ``device`` says otherwise; builds of trees are numpy on the
host, as in the reference.  The online mutation methods are the
reference's: a two-level index takes the bucket-granular path
(:class:`repro_torch.core.two_level.TwoLevelIndex`), a single tree is
rebuilt over the surviving rows (its manifest is marked ``full``) or
masked in place for a delete.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.core.delta import DeltaLog, DeltaManifest
from repro_torch.core.protocol import IndexSpec, select_index_spec
from repro_torch.core.tree import FlatTree, build_qlbt, build_rp_tree
from repro_torch.core.two_level import TwoLevelIndex, build_two_level
from repro_torch.device import require_fp32_matmul, resolve

__all__ = ["SearchIndex", "build_index", "auto_build_index"]


@dataclasses.dataclass
class SearchIndex:
    spec: IndexSpec
    db: np.ndarray
    tree: Optional[FlatTree] = None
    two_level: Optional[TwoLevelIndex] = None
    p: Optional[np.ndarray] = None      # traffic estimate (qlbt rebuilds)
    alive: Optional[np.ndarray] = None  # single-tree tombstones
    # last fully-built tree: reboost always derives from it, never from a
    # previous reboost (chained re-splits compound float relocations)
    base_tree: Optional[FlatTree] = None
    # delta shipping (single-tree path; two-level delegates)
    mutation_version: int = 0
    delta_log: Optional[DeltaLog] = dataclasses.field(default=None,
                                                      repr=False)
    device: Optional[torch.device] = None   # where a tree search runs
    # single-tree metadata sidecar; two-level indexes own theirs (the
    # ``metadata`` property routes either way)
    _metadata: Optional[object] = dataclasses.field(default=None, repr=False)
    # the tree search tables on the device, placed by the first search and
    # dropped by every mutation
    _placed: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def metadata(self):
        """Row-aligned :class:`repro_torch.core.metadata.MetadataTable` (or
        None) — the table ``FilterSpec`` predicates resolve against."""
        if self.two_level is not None:
            return self.two_level.metadata
        return self._metadata

    @property
    def lexical(self):
        """Row-aligned :class:`repro_torch.core.lexical.LexicalSlabs` (or
        None) — the BM25 postings the lexical/hybrid modes scan."""
        if self.two_level is not None:
            return self.two_level.lexical
        return None

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        beam_width: int = 8,
        nprobe: int = 8,
        query_chunk: int = 1024,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Returns (dists, ids, work), numpy."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if self.spec.kind in ("qlbt", "tree"):
            dev = resolve(self.device)
            require_fp32_matmul()
            placed = self._placed.get(dev)
            if placed is None:
                placed = (self.tree.device_arrays(dev),
                          torch.as_tensor(self.db, device=dev))
                self._placed[dev] = placed
            arrays, db = placed
            t = self.tree
            res = tree_mod.tree_search(
                arrays, db, torch.as_tensor(q, device=dev), kind=t.kind,
                beam_width=beam_width, k=k, max_steps=t.max_depth + 4,
            )
            work = {
                "internal_visits": int(res.internal_visits.sum()),
                "candidates": int(res.candidates.sum()),
                "steps_mean": float(res.steps.cpu().numpy().mean()),
            }
            return res.dists.cpu().numpy(), res.ids.cpu().numpy(), work
        return self.two_level.search(
            q, k, nprobe=nprobe, beam_width=beam_width,
            query_chunk=query_chunk,
        )

    def footprint_bytes(self, include_db: bool = True) -> int:
        tot = self.db.nbytes if include_db else 0
        if self.tree is not None:
            tot += self.tree.footprint_bytes()
        if self.two_level is not None:
            tot += self.two_level.footprint_bytes(include_db=False)
        return tot

    # ---------------- online mutation (lifecycle API) ----------------
    def _tree_rebuild(self) -> None:
        """Rebuild the single tree over *live* rows only (tombstoned rows
        must never be re-indexed) and remap leaf ids back to global."""
        live = np.nonzero(self.alive)[0]
        if self.spec.kind == "qlbt" and self.p is not None:
            t = build_qlbt(self.db[live], self.p[live])
        else:
            t = build_rp_tree(self.db[live])
        leaf = t.leaf_entities
        m = leaf >= 0
        leaf[m] = live[leaf[m]].astype(leaf.dtype)
        self.tree = t
        self.base_tree = None          # fresh build is the new reboost base

    def _ensure_alive(self) -> None:
        if self.alive is None:
            self.alive = np.ones(self.db.shape[0], dtype=bool)
        if self.delta_log is None:
            self.delta_log = DeltaLog(
                base_version=self.mutation_version,
                base_n=int(self.db.shape[0]))

    def pop_delta(self) -> DeltaManifest:
        """Emit (and reset) the mutation record since the last pop.
        Two-level indexes delegate (bucket-granular); a single tree can
        express only tombstone-deletes as a delta, and any structural
        change (add, rebalance, reboost) marks the manifest ``full``."""
        if self.two_level is not None:
            return self.two_level.pop_delta()
        self._ensure_alive()
        return self.delta_log.pop(self.mutation_version,
                                  int(self.db.shape[0]))

    def add_entities(self, new_vecs: np.ndarray, **kw) -> np.ndarray:
        """Insert new entities; returns their global ids.  Two-level
        indexes take the incremental path; a single tree is rebuilt over
        the surviving rows (the paper's own update model at that scale)."""
        if self.two_level is not None:
            ids = self.two_level.add_entities(new_vecs, **kw)
            self.db = self.two_level.db
            return ids
        self._ensure_alive()
        new_vecs = np.ascontiguousarray(new_vecs, dtype=np.float32)
        start = self.db.shape[0]
        ids = np.arange(start, start + new_vecs.shape[0], dtype=np.int32)
        self.db = np.concatenate([self.db, new_vecs], axis=0)
        self.alive = np.concatenate([self.alive, np.ones(ids.size, bool)])
        meta_rows = kw.pop("metadata", None)
        if self._metadata is not None:
            self._metadata.append_rows(meta_rows or {}, ids.size)
        elif meta_rows:
            raise ValueError(
                "index has no metadata table; build with metadata= to "
                "accept per-entity metadata on add_entities")
        if self.spec.kind == "qlbt" and self.p is not None:
            p_new = kw.get("p")
            if p_new is None:
                p_new = np.full(ids.size, float(np.mean(self.p)))
            self.p = np.concatenate([self.p, np.asarray(p_new)])
        self._tree_rebuild()
        self.delta_log.mark_full()      # whole-tree rebuild, no delta
        self.mutation_version += 1
        self._placed = {}
        return ids

    def delete_entities(self, ids: np.ndarray) -> None:
        """Tombstone-delete: ids stay stable, deleted ids are immediately
        unreturnable (bucket-slot compaction / in-place leaf masking)."""
        if self.two_level is not None:
            self.two_level.delete_entities(ids)
            return
        self._ensure_alive()
        ids = np.asarray(ids)
        self.alive[ids] = False
        self.tree.drop_entities(ids)
        self.delta_log.mark_tombstones(ids)
        self.mutation_version += 1
        if self.base_tree is not None and self.base_tree is not self.tree:
            # keep the reboost base in sync: a later reboost from a base
            # still holding the id would resurrect a deleted entity
            self.base_tree.drop_entities(ids)
        self._placed = {}

    def rebalance(self, **kw) -> dict:
        """Two-level: drifted-bucket Lloyd step + dirty-tree rebuild.
        Single-tree: full rebuild from the surviving corpus."""
        if self.two_level is not None:
            return self.two_level.rebalance(**kw)
        self._ensure_alive()
        self._tree_rebuild()
        self.delta_log.mark_full()
        self.mutation_version += 1
        self._placed = {}
        return {"n_rebuilt_buckets": 1, "n_moved": 0,
                "n_drifted": 0, "max_drift": 0.0}

    def reboost(self, p: np.ndarray, **kw) -> dict:
        """Incremental re-boost from a new traffic estimate ``p``: a single
        tree re-runs the boosted split objective on its top levels only
        (:meth:`FlatTree.reboost`); a two-level index re-boosts every
        bucket tree (:meth:`TwoLevelIndex.reboost`)."""
        if self.two_level is not None:
            stats = self.two_level.reboost(p, **kw)
            self.p = self.two_level.p
            return stats
        self._ensure_alive()
        p = np.asarray(p, dtype=np.float64)
        if p.shape[0] != self.db.shape[0]:
            raise ValueError(
                f"p has {p.shape[0]} entries for {self.db.shape[0]} rows")
        self.p = p
        p_eff = np.where(self.alive, p, 0.0)
        if self.base_tree is None:
            self.base_tree = self.tree
        self.tree = self.base_tree.reboost(self.db, p_eff, **kw)
        self.delta_log.mark_full()      # node table re-split wholesale
        self.mutation_version += 1
        self._placed = {}
        return {"n_reboosted": 1, "n_refreshed": 0}

    def rebuild_with_likelihood(self, p: np.ndarray, *, seed: int = 0):
        """Paper §3.1: 'if only this distribution changes, a new search
        tree can be easily built, keeping other configurations the same'
        (the personalization path).  Rebuilds the QLBT in place from the
        stored vectors and the new traffic estimate; no effect on
        two-level indexes (their buckets don't depend on p).  As in the
        reference, the rebuild covers every db row, tombstoned ones too
        (ROADMAP.md, fault 15)."""
        if self.spec.kind not in ("qlbt", "tree"):
            return self
        self._ensure_alive()
        self.tree = build_qlbt(self.db, p, seed=seed)
        self.base_tree = None          # fresh build is the new reboost base
        self.delta_log.mark_full()
        self.mutation_version += 1
        self.spec = dataclasses.replace(self.spec, kind="qlbt")
        self._placed = {}
        return self


def build_index(
    spec: IndexSpec,
    db: np.ndarray,
    *,
    p: Optional[np.ndarray] = None,
    partition_features: Optional[np.ndarray] = None,
    metadata=None,
    lexical=None,
    seed: int = 0,
    device=None,
) -> SearchIndex:
    """Build the index ``spec`` names; its search (and a two-level
    index's k-means) runs on the card unless ``device`` says otherwise."""
    dev = resolve(device)
    db = np.ascontiguousarray(db, dtype=np.float32)
    if metadata is not None and metadata.n_rows != db.shape[0]:
        raise ValueError(
            f"metadata table has {metadata.n_rows} rows for a "
            f"{db.shape[0]}-row db")
    if spec.kind == "qlbt":
        if p is None:
            raise ValueError("QLBT requires a query-likelihood vector p")
        t = build_qlbt(db, p, seed=seed)
        return SearchIndex(spec=spec, db=db, tree=t,
                           p=np.asarray(p, np.float64), device=dev,
                           _metadata=metadata)
    if spec.kind == "tree":
        return SearchIndex(spec=spec, db=db,
                           tree=build_rp_tree(db, seed=seed), device=dev,
                           _metadata=metadata)
    if spec.kind == "two_level":
        tl = build_two_level(
            db, spec.two_level, p=p, partition_features=partition_features,
            metadata=metadata, lexical=lexical, device=dev,
        )
        return SearchIndex(spec=spec, db=db, two_level=tl, device=dev)
    raise ValueError(f"unknown index kind {spec.kind!r}")


def auto_build_index(
    db: np.ndarray,
    *,
    p: Optional[np.ndarray] = None,
    partition_features: Optional[np.ndarray] = None,
    seed: int = 0,
    device=None,
) -> SearchIndex:
    """Apply the paper's §5.3 protocol end-to-end."""
    part_dim = (
        partition_features.shape[1]
        if partition_features is not None
        else None
    )
    spec = select_index_spec(
        db.shape[0],
        traffic_available=p is not None,
        partition_dim=part_dim,
        embedding_dim=db.shape[1],
    )
    return build_index(
        spec, db, p=p, partition_features=partition_features, seed=seed,
        device=device,
    )
