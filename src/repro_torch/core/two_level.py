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
``device`` is where ``search`` runs.  The tables are placed there once, at
the first search, and reused: nothing in this slice changes them (every
mutation method raises ``NotImplementedError`` naming the ROADMAP item).

The PQ top level scores the centroid codes with the ``pq_adc_topk``
kernel, where the reference calls its jnp ``adc_scores``
(``repro/core/pq.py:8-10`` names the kernel as that scan's home); the
results are the same up to the order of the ADC sum.  The brute bottom
runs the whole probe chain through ``bucket_probe_topk_op`` (the
``candidate_topk`` kernel, rows read from the corpus by entity id), where
the reference runs its ``_probe_scan_brute`` loop (its docstring names the
kernel tile loop over the probed buckets as the loop's home): the same
ids up to rounding, except that a bucket probed twice is emitted once on
the card (ROADMAP fault 5).  The LSH bottom's gathered Hamming scan and
every other step are plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.core.kmeans import _assign_topm, kmeans_fit
from repro_torch.core.lsh import LSHIndex, lsh_build
from repro_torch.core.pq import ProductQuantizer, adc_lut, pq_train
from repro_torch.core.tree import (LATER_MUTATION, FlatTree, build_kd_tree,
                                   build_qlbt, build_rp_tree)
from repro_torch.device import require_fp32_matmul, resolve
from repro_torch.kernels.common import popcount32, stable_topk
from repro_torch.kernels.ops import bucket_probe_topk_op, pq_adc_topk_op
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
    already global); ``arrays`` are the concatenated host tables
    ``tree_search`` reads (see :meth:`FlatTree.device_arrays`)."""
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
    device: Optional[torch.device] = None       # where search runs
    # per-entity sidecars, row-aligned with db: a MetadataTable (filters)
    # and LexicalSlabs (lexical / hybrid modes), placed by the backend
    metadata: Optional[object] = dataclasses.field(default=None, repr=False)
    lexical: Optional[object] = dataclasses.field(default=None, repr=False)
    # the search tables on the device, placed by the first search (a copy
    # made with dataclasses.replace starts without them)
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

    # ---------------- mutation: a later slice ----------------
    def add_entities(self, *args, **kwargs):
        raise NotImplementedError(f"add_entities: see {LATER_MUTATION}")

    def delete_entities(self, *args, **kwargs):
        raise NotImplementedError(f"delete_entities: see {LATER_MUTATION}")

    def refresh_forest(self, *args, **kwargs):
        raise NotImplementedError(f"refresh_forest: see {LATER_MUTATION}")

    def rebalance(self, *args, **kwargs):
        raise NotImplementedError(f"rebalance: see {LATER_MUTATION}")

    def reboost(self, *args, **kwargs):
        raise NotImplementedError(f"reboost: see {LATER_MUTATION}")

    def pop_delta(self, *args, **kwargs):
        raise NotImplementedError(f"pop_delta: see {LATER_MUTATION}")

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
        counts = t["bucket_counts"][buckets.long()]
        work = {"top_scored": top_work * B, "candidates": int(counts.sum())}

        bottom = self.config.bottom
        if bottom == "brute":
            # the whole probe chain: on the card one scan and one merge
            # launch of candidate_topk a pass, rows read by entity id
            d, i = bucket_probe_topk_op(q, buckets, t["bucket_ids"], k,
                                        db=t["db"])
            return d, i, work
        if bottom == "lsh":
            cap = self.bucket_ids.shape[1]
            shortlist = min(lsh_candidates, nprobe * cap)
            cand = _probe_scan_lsh(t["lsh_codes"], t["lsh_proj"],
                                   t["bucket_ids"], buckets, q, shortlist)
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


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, n_bits) bool -> (B, ceil(n_bits/32)) int32 little-endian words:
    packed in int64 and wrapped to int32 (the reference packs in uint32,
    which PyTorch supports poorly)."""
    B, nb = bits.shape
    pad = (-nb) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(B, -1, 32).to(torch.int64)
    w = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    v = (b * w).sum(dim=2)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _probe_scan_lsh(codes, proj, bucket_ids, buckets, q, shortlist):
    """Stream probed buckets, keep a running Hamming top-``shortlist``.
    Ranks ``[carried best | tile]`` by column on ties, as the reference
    does: the shortlist it keeps is what ``_rerank`` sees."""
    B = q.shape[0]
    qcodes = _pack_bits(q @ proj > 0)
    best_h = q.new_full((B, shortlist), float("inf"))
    best_i = torch.full((B, shortlist), -1, dtype=torch.int32,
                        device=q.device)
    for j in range(buckets.shape[1]):
        cand = bucket_ids[buckets[:, j].long()]            # (B, cap)
        ccodes = codes[torch.clamp(cand, min=0).long()]    # (B, cap, W)
        x = torch.bitwise_xor(qcodes[:, None, :], ccodes)
        ham = popcount32(x).sum(-1).to(torch.float32)
        ham = torch.where(cand >= 0, ham, float("inf"))
        cat_h = torch.cat([best_h, ham], dim=1)
        cat_i = torch.cat([best_i, cand], dim=1)
        best_h, sel = stable_topk(cat_h, shortlist)
        best_i = torch.gather(cat_i, 1, sel)
    return best_i


def _rerank(db, q, cand, k):
    vecs = db[torch.clamp(cand, min=0).long()]
    d2 = torch.where(cand >= 0, batched_l2sq(vecs, q), float("inf"))
    # mask duplicate ids (the same entity can enter via two overlapping
    # probes): stable-sort the ids, flag every repeat of its left
    # neighbour, scatter the flags back, and penalize all but the first
    # occurrence so one entity holds at most one top-k slot.
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
    d2 = torch.where(dup, float("inf"), d2)
    k = min(k, cand.shape[1])
    d, sel = stable_topk(d2, k)
    ids = torch.gather(cand, 1, sel)
    return d, torch.where(torch.isinf(d), -1, ids)


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
