"""Unified index API: build from an IndexSpec, search with one signature.

Port of ``repro/core/index.py``, the public entry point of the index
layer: ``auto_build_index`` applies the paper's §5.3 protocol, and
``SearchIndex.search`` runs the one-level tree descent (QLBT or the
balanced projection tree) or the two-level search.  Search runs on the
card unless ``device`` says otherwise; builds of trees are numpy on the
host, as in the reference.  The online mutation methods belong to a later
slice and raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.core.protocol import IndexSpec, select_index_spec
from repro_torch.core.tree import (LATER_MUTATION, FlatTree, build_qlbt,
                                   build_rp_tree)
from repro_torch.core.two_level import TwoLevelIndex, build_two_level
from repro_torch.device import require_fp32_matmul, resolve

__all__ = ["SearchIndex", "build_index", "auto_build_index"]


@dataclasses.dataclass
class SearchIndex:
    spec: IndexSpec
    db: np.ndarray
    tree: Optional[FlatTree] = None
    two_level: Optional[TwoLevelIndex] = None
    p: Optional[np.ndarray] = None      # traffic estimate (qlbt builds)
    device: Optional[torch.device] = None   # where a tree search runs
    # single-tree metadata sidecar; two-level indexes own theirs (the
    # ``metadata`` property routes either way)
    _metadata: Optional[object] = dataclasses.field(default=None, repr=False)
    # the tree search tables on the device, placed by the first search
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

    # ---------------- online mutation: a later slice ----------------
    def pop_delta(self, *args, **kwargs):
        raise NotImplementedError(f"pop_delta: see {LATER_MUTATION}")

    def add_entities(self, *args, **kwargs):
        raise NotImplementedError(f"add_entities: see {LATER_MUTATION}")

    def delete_entities(self, *args, **kwargs):
        raise NotImplementedError(f"delete_entities: see {LATER_MUTATION}")

    def rebalance(self, *args, **kwargs):
        raise NotImplementedError(f"rebalance: see {LATER_MUTATION}")

    def reboost(self, *args, **kwargs):
        raise NotImplementedError(f"reboost: see {LATER_MUTATION}")

    def rebuild_with_likelihood(self, *args, **kwargs):
        raise NotImplementedError(
            f"rebuild_with_likelihood: see {LATER_MUTATION}")


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
