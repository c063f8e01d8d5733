"""Sharded search: device arrays, the per-shard brute (fp32 / int8),
lexical, hybrid, IVF and forest locals, the forest's shard layouts and
delta slicers, and the merge of per-shard results.

Port of the search half of ``repro/distributed/sharding.py``.  In the
reference each chip of a mesh runs a local over its shard inside
``shard_map`` and an ``all_gather`` brings every shard's top-k together
for ``_merge_gathered``.  Here one card holds one shard: a local's
result is stacked as the single entry of the ``(S, B, k)`` tensor that
``_merge_gathered`` takes, so a later slice can feed it from a
``torch.distributed`` all-gather instead without touching the merge.

The forest (tree/QLBT bottom) is sliced per shard into fixed shapes
(``ForestShardShapes``): *packed* (buckets back to back) or *slab* (every
bucket at a fixed node and leaf window, so one rebuilt bucket is a
fixed-shape payload, ``slice_forest_delta``, scattered in place).  The
slicers are numpy copies of the reference's; the tables keep the shard
dimension (length 1 here), so more cards change no layout.

``fused=True`` routes the per-shard scan through ``kernels.ops`` (the
CUDA kernels on the card, their plain versions on the CPU);
``fused=False`` runs the reference's unfused ops.  On the CPU both give
the same ids, since the plain versions are built from the same ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.common import INF, pad_sentinel, stable_topk
from repro_torch.kernels.ref import bm25_dists_ref

__all__ = ["make_sharded_brute_fn", "make_sharded_ivf_fn",
           "make_sharded_lexical_fn", "make_sharded_hybrid_fn",
           "make_sharded_forest_fn", "shard_forest", "forest_shard_shapes",
           "ForestShardShapes", "slice_forest_delta", "slice_ivf_delta"]


def _row_valid(n: int, rows: int, alive=None) -> np.ndarray:
    """Liveness of a shard grid of ``rows`` over ``n`` real rows: pads are
    dead, and so are tombstoned rows (``alive`` False)."""
    if rows < n:
        raise ValueError(
            f"corpus has {n} rows but the shard grid holds only {rows}; "
            "rebuild the backend (or raise headroom)")
    valid = np.arange(rows) < n
    if alive is not None:
        valid[:n] &= np.asarray(alive, bool)
    return valid.astype(np.int32)


def _brute_device_arrays(db, device, rows=None, alive=None):
    """Zero-pad db rows to the shard's row grid.  Pads (and tombstoned
    rows, via ``alive``) are masked by an explicit int32 per-row ``valid``
    operand, never by inf-valued vectors (whose distances would evaluate
    to ``inf - inf = NaN``).  Returns (padded db, valid).
    """
    db = np.asarray(db, np.float32)
    n = db.shape[0]
    valid = _row_valid(n, n if rows is None else rows, alive)
    dbp = torch.zeros((valid.size, db.shape[1]), dtype=torch.float32,
                      device=device)
    dbp[:n] = torch.as_tensor(db, device=device)
    return dbp, torch.as_tensor(valid, device=device)


def _brute_int8_device_arrays(db, device, rows=None, alive=None):
    """int8 counterpart of ``_brute_device_arrays``: per-row symmetric
    quantization (``kernels.ops.quantize_rows_int8``) before padding, so
    pad rows are zero codes with scale 1.0 (they dequantize to exact zero)
    and are masked by ``valid`` like every other dead row.  Returns
    (codes, scales, valid)."""
    db = np.asarray(db, np.float32)
    n = db.shape[0]
    valid = _row_valid(n, n if rows is None else rows, alive)
    codes, scales = kernel_ops.quantize_rows_int8(db)
    pad = valid.size - n
    codes = np.pad(codes, ((0, pad), (0, 0)))
    scales = np.pad(scales, (0, pad), constant_values=1.0)
    return (torch.as_tensor(codes, device=device),
            torch.as_tensor(scales, device=device),
            torch.as_tensor(valid, device=device))


def _lexical_device_arrays(terms, tf_sat, device, rows=None, alive=None):
    """Postings-slab counterpart of ``_brute_device_arrays``: term rows
    padded with -1 (no aliasing of term id 0), tf rows with zeros; pads
    and tombstones are masked by the same ``valid`` operand.  Returns
    (terms, tf_sat, valid)."""
    t = np.asarray(terms, np.int32)
    f = np.asarray(tf_sat, np.float32)
    n = t.shape[0]
    valid = _row_valid(n, n if rows is None else rows, alive)
    pad = valid.size - n
    return (torch.as_tensor(np.pad(t, ((0, pad), (0, 0)),
                                   constant_values=-1), device=device),
            torch.as_tensor(np.pad(f, ((0, pad), (0, 0))), device=device),
            torch.as_tensor(valid, device=device))


def _ivf_device_arrays(index, device, cap=None):
    """Place a built TwoLevelIndex's centroid and bucket tables, bucket
    width padded to ``cap`` (update headroom): zero vectors and -1 ids in
    the pad, masked by id.  Returns (centroids, bucket ids, bucket vectors
    (K, cap, d)).  The bucket vectors are gathered once here, so a probe
    step reads its tile without touching the corpus."""
    K, cap_now = index.bucket_ids.shape
    if cap is None:
        cap = cap_now
    if cap < cap_now:
        raise ValueError(
            f"bucket cap grew to {cap_now} > reserved {cap}; rebuild the "
            "backend (or raise headroom)")
    cents = torch.as_tensor(np.asarray(index.centroids, np.float32),
                            device=device)
    bids = torch.full((K, cap), -1, dtype=torch.int32, device=device)
    bids[:, :cap_now] = torch.as_tensor(
        np.asarray(index.bucket_ids, np.int32), device=device)
    db = torch.as_tensor(np.asarray(index.db, np.float32), device=device)
    bvecs = db[torch.clamp(bids, min=0).long()]
    bvecs.masked_fill_((bids < 0)[..., None], 0.0)
    return cents, bids, bvecs


def _merge_gathered(gd: torch.Tensor, gi: torch.Tensor, k: int):
    """(S, B, k) per-shard results -> merged (B, k)."""
    s, b, kk = gd.shape
    cat_d = gd.permute(1, 0, 2).reshape(b, s * kk)
    cat_i = gi.permute(1, 0, 2).reshape(b, s * kk)
    d, sel = stable_topk(cat_d, k)
    ids = torch.gather(cat_i, 1, sel)
    return d, torch.where(torch.isinf(d), -1, ids)


def _gather_shards(ld: torch.Tensor, li: torch.Tensor):
    """All-gather over the corpus shards: with one card, the stack of its
    own result."""
    return ld[None], li[None]


def _finish_local(ld, li, k: int):
    """A row-sharded local's (B, k_loc) top-k -> the merged (B, k).  One
    shard: its row ids are the global ids (more shards add the shard's
    row offset here, keeping the -1 sentinel)."""
    li = li.to(torch.int32)
    k_loc = ld.shape[1]
    if k_loc < k:
        b = ld.shape[0]
        ld = torch.cat([ld, ld.new_full((b, k - k_loc), INF)], dim=1)
        li = torch.cat([li, li.new_full((b, k - k_loc), -1)], dim=1)
    return _merge_gathered(*_gather_shards(ld, li), k)


def _masked_topk(dist, valid_shard, k_loc: int):
    """The unfused locals' selection: dead rows to +inf, stable top-k."""
    return stable_topk(torch.where(valid_shard[None, :] != 0, dist, INF),
                       k_loc)


def make_sharded_brute_fn(k: int, shard_rows: int, *, fused: bool = True,
                          precision: str = "f32"):
    """Exact search over a row-sharded corpus: ``fn(db, valid, q)``, or
    with ``precision="int8"`` (fused only) ``fn(codes, scales, valid, q)``
    over per-row-scaled int8 codes.

    Pad and tombstoned rows are masked by the ``valid`` operand, which is
    data, so a mutated corpus can be re-placed into the same shapes.
    """
    if precision not in ("f32", "int8"):
        raise ValueError(f"precision must be 'f32' or 'int8', "
                         f"got {precision!r}")
    if precision == "int8" and not fused:
        raise ValueError("precision='int8' is a fused-kernel feature; "
                         "pass fused=True")
    k_loc = min(k, shard_rows)   # a shard may hold fewer rows than k

    def local(db_shard, valid_shard, q):
        if fused:
            ld, li = kernel_ops.l2_topk_op(q, db_shard, k_loc,
                                           valid=valid_shard)
        else:
            ld, li = _masked_topk(pairwise_l2sq(q, db_shard), valid_shard,
                                  k_loc)
        return _finish_local(ld, li, k)

    def local_int8(codes_shard, scales_shard, valid_shard, q):
        ld, li = kernel_ops.l2_topk_int8_op(q, codes_shard, scales_shard,
                                            k_loc, valid=valid_shard)
        return _finish_local(ld, li, k)

    return local_int8 if precision == "int8" else local


def make_sharded_lexical_fn(k: int, shard_rows: int, *, fused: bool = True):
    """BM25 scan over row-sharded postings slabs — the brute layout with
    term/tf slabs in place of vectors: ``fn(terms, tf_sat, valid,
    q_terms, q_weights)``.  Filters and tombstones compose through
    ``valid`` as in the brute scan."""
    k_loc = min(k, shard_rows)

    def local(terms_shard, tf_shard, valid_shard, qt, qw):
        if fused:
            ld, li = kernel_ops.bm25_topk_op(qt, qw, terms_shard, tf_shard,
                                             k_loc, valid=valid_shard)
        else:
            ld, li = _masked_topk(
                bm25_dists_ref(qt, qw, terms_shard, tf_shard), valid_shard,
                k_loc)
        return _finish_local(ld, li, k)

    return local


def make_sharded_hybrid_fn(k: int, shard_rows: int, *, fused: bool = True):
    """Semantic L2 and BM25 fused per shard as ``alpha * l2sq - (1 -
    alpha) * bm25``: ``fn(db, terms, tf_sat, valid, q, q_terms, q_weights,
    alpha)``, ``alpha`` a (1, 1) float32 tensor on the device."""
    k_loc = min(k, shard_rows)

    def local(db_shard, terms_shard, tf_shard, valid_shard, q, qt, qw,
              alpha):
        if fused:
            ld, li = kernel_ops.hybrid_topk_op(
                q, db_shard, qt, qw, terms_shard, tf_shard, alpha, k_loc,
                valid=valid_shard)
        else:
            d2 = pairwise_l2sq(q, db_shard)
            score = -bm25_dists_ref(qt, qw, terms_shard, tf_shard)
            a = alpha.reshape(1, 1)
            ld, li = _masked_topk(a * d2 - (1.0 - a) * score, valid_shard,
                                  k_loc)
        return _finish_local(ld, li, k)

    return local


def make_sharded_ivf_fn(k: int, nprobe_local: int, n_buckets: int, *,
                        fused: bool = True):
    """Two-level, brute bottom, over a bucket-sharded index:
    ``fn(cents, bucket_ids, bucket_vecs, q)``.

    The shard (1) scores its ``n_buckets`` centroids, (2) probes its
    ``nprobe_local`` best buckets, and (3) contributes its top-k to the
    merge.  Fused, step (2) is one ``bucket_probe_topk_op`` call (on the
    card one scan and one merge launch, the bucket rows read inside the
    kernel); unfused, it is the reference's step-by-step loop with a
    carried running best.  (Sharded over more cards, the bucket tables are
    padded to the shard grid and the pads are masked by global bucket
    index, as in the reference.)
    """
    nprobe_local = min(nprobe_local, n_buckets)

    def local(cents, bucket_ids, bucket_vecs, q):
        d2c = pairwise_l2sq(q, cents)                      # (B, K)
        _, probe = stable_topk(d2c, nprobe_local)          # (B, np)
        if fused:
            best_d, best_i = kernel_ops.bucket_probe_topk_op(
                q, probe, bucket_ids, k, bucket_vecs=bucket_vecs)
            return _merge_gathered(*_gather_shards(best_d, best_i), k)
        B = q.shape[0]
        best_d = q.new_full((B, k), INF)
        best_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
        for j in range(nprobe_local):
            bsel = probe[:, j]                             # (B,)
            ids = bucket_ids[bsel]                         # (B, cap)
            vecs = bucket_vecs[bsel]                       # (B, cap, d)
            d2 = torch.where(ids >= 0, batched_l2sq(vecs, q), INF)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            best_d, sel = stable_topk(cat_d, k)
            best_i = torch.gather(cat_i, 1, sel)
        return _merge_gathered(*_gather_shards(best_d, best_i), k)

    return local


# ---------------------------------------------------------------------------
# Tree/QLBT forest bottom level
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ForestShardShapes:
    """Fixed per-shard array shapes for a sliced forest.

    Recorded at backend construction (optionally with headroom) and
    re-applied by :meth:`ShardedSearchBackend.apply_updates`: a mutated
    index re-slices into the *same* shapes, so its tables are rewritten in
    the tensors already placed.

    Two layouts share this record:

    * **packed** (``node_slab == 0``): each shard's buckets are packed
      back-to-back, minimal padding — the host entry points' layout.
    * **slab** (``node_slab > 0``): every bucket owns a fixed
      ``node_slab``-row node window and ``leaf_slab``-row leaf window at
      ``slot * slab``, so one bucket's rebuilt tree overwrites only its
      own slabs.  This is what makes *delta shipping* possible — a dirty
      bucket is a fixed-shape payload scattered in place on device — at
      the cost of padding every bucket to the largest tree
      (``nodes == kloc * node_slab``).
    """
    n_dev: int
    kloc: int       # buckets per shard
    cap: int        # bucket pad width
    nodes: int      # node-table rows per shard (excluding the dead node)
    leaves: int     # leaf-table rows per shard
    leaf_sz: int    # leaf width (entities per leaf row)
    max_depth: int  # bound on descent steps
    node_slab: int = 0   # slab layout: node rows reserved per bucket
    leaf_slab: int = 0   # slab layout: leaf rows reserved per bucket


def _forest_slices(index, n_dev: int):
    """Per-shard (b0, b1, N0, N1, L0, L1) bucket/node/leaf windows."""
    f = index.forest
    if f is None:
        raise ValueError("index has no forest (bottom must be tree/qlbt)")
    K = index.bucket_ids.shape[0]
    Kloc = -(-K // n_dev)
    leaf_row = np.asarray(f.arrays["leaf_row"])
    roots = np.asarray(f.roots, dtype=np.int64)
    n_nodes = leaf_row.shape[0]
    bounds = np.concatenate([roots, [n_nodes]])
    slices = []
    for s in range(n_dev):
        b0 = min(s * Kloc, K)
        b1 = min(b0 + Kloc, K)
        N0 = int(bounds[b0]) if b0 < K else n_nodes
        N1 = int(bounds[b1]) if b0 < K else n_nodes
        lr = leaf_row[N0:N1]
        rows = lr[lr >= 0]
        L0 = int(rows.min()) if rows.size else 0
        L1 = int(rows.max()) + 1 if rows.size else 0
        if rows.size not in (0, L1 - L0):
            raise ValueError(
                f"shard {s}: leaf rows not contiguous ({rows.size} rows in "
                f"window [{L0}, {L1})); build_forest concatenation order "
                "changed?")
        slices.append((b0, b1, N0, N1, L0, L1))
    return slices, Kloc


def _bucket_windows(index):
    """Per-bucket (N0, N1, L0, L1) node/leaf windows in the concatenated
    forest (bucket ``b`` owns nodes ``[roots[b], roots[b+1])`` and the
    contiguous leaf rows its own tree contributed)."""
    f = index.forest
    if f is None:
        raise ValueError("index has no forest (bottom must be tree/qlbt)")
    K = index.bucket_ids.shape[0]
    leaf_row = np.asarray(f.arrays["leaf_row"])
    roots = np.asarray(f.roots, dtype=np.int64)
    bounds = np.concatenate([roots, [leaf_row.shape[0]]])
    windows = []
    for b in range(K):
        N0, N1 = int(bounds[b]), int(bounds[b + 1])
        lr = leaf_row[N0:N1]
        rows = lr[lr >= 0]
        L0 = int(rows.min()) if rows.size else 0
        L1 = int(rows.max()) + 1 if rows.size else 0
        if rows.size not in (0, L1 - L0):
            raise ValueError(
                f"bucket {b}: leaf rows not contiguous; "
                "build_forest concatenation order changed?")
        windows.append((N0, N1, L0, L1))
    return windows


def forest_shard_shapes(index, n_dev: int, headroom: float = 1.0,
                        layout: str = "packed") -> ForestShardShapes:
    """Measure the natural per-shard shapes; ``headroom`` > 1 reserves
    room for post-mutation growth (bigger buckets after adds, deeper or
    wider trees after dirty-bucket rebuilds).

    ``layout="slab"`` reserves a fixed node/leaf slab *per bucket*
    (``headroom`` scales the slab against the current largest bucket
    tree) — the delta-shipping layout; see :class:`ForestShardShapes`.
    """
    f = index.forest
    cap = index.bucket_ids.shape[1]
    leaf_sz = np.asarray(f.arrays["leaf_entities"]).shape[1] if f else 0
    grow = lambda x: int(np.ceil(x * headroom))
    extra_depth = 8 if headroom > 1.0 else 0
    if layout == "slab":
        windows = _bucket_windows(index)
        K = index.bucket_ids.shape[0]
        Kloc = -(-K // n_dev)
        node_slab = grow(max(max((N1 - N0 for N0, N1, _, _ in windows),
                                 default=0), 1))
        leaf_slab = grow(max(max((L1 - L0 for *_, L0, L1 in windows),
                                 default=0), 1))
        return ForestShardShapes(
            n_dev=n_dev, kloc=Kloc, cap=grow(cap),
            nodes=Kloc * node_slab, leaves=Kloc * leaf_slab,
            leaf_sz=leaf_sz, max_depth=f.max_depth + extra_depth,
            node_slab=node_slab, leaf_slab=leaf_slab,
        )
    if layout != "packed":
        raise ValueError(f"layout must be 'packed' or 'slab', got {layout!r}")
    slices, Kloc = _forest_slices(index, n_dev)
    maxN = max(max((N1 - N0 for _, _, N0, N1, _, _ in slices), default=0), 1)
    maxL = max(max((L1 - L0 for *_, L0, L1 in slices), default=0), 1)
    return ForestShardShapes(
        n_dev=n_dev, kloc=Kloc, cap=grow(cap), nodes=grow(maxN),
        leaves=grow(maxL), leaf_sz=leaf_sz,
        max_depth=f.max_depth + extra_depth,
    )


def shard_forest(index, n_dev: int, *,
                 shapes: Optional[ForestShardShapes] = None) -> dict:
    """Slice a built forest index into ``n_dev`` equal-shape shards.

    The two-level build concatenates per-bucket trees into one node table
    (``two_level.build_forest``); bucket ``b`` owns node range
    ``[roots[b], roots[b+1])`` and a contiguous run of leaf-table rows.
    Each shard takes a contiguous block of buckets, re-bases node/leaf
    offsets, and remaps leaf entity ids from *global* entity ids to local
    *bucket-slot* ids (``bucket_row * cap + col``) so the rerank gathers
    from the shard's own ``(Kloc, cap, d)`` vector tile — corpus memory
    stays sharded.  One extra dead node per shard backs padded bucket
    roots.  Returns host (numpy) arrays stacked on a leading shard dim.

    ``shapes`` pads every shard to the given fixed sizes (raising if the
    forest outgrew them) so re-slicing a *mutated* index produces arrays
    of identical shape (the in-place update path).  Deleted entities are
    naturally dropped: they are absent from ``bucket_ids``, so their leaf
    slots remap to -1.

    A ``shapes`` with ``node_slab > 0`` switches to the *slab* layout
    (every bucket at a fixed per-slot window — the delta-shipping
    layout); the two layouts produce identical search results, they only
    differ in padding placement.
    """
    if shapes is not None and shapes.node_slab > 0:
        return _shard_forest_slab(index, shapes)
    slices, Kloc = _forest_slices(index, n_dev)
    f = index.forest
    K, cap_now = index.bucket_ids.shape
    arrays = {name: np.asarray(v) for name, v in f.arrays.items()}
    roots = np.asarray(f.roots, dtype=np.int64)
    d = index.db.shape[1]
    leaf_sz_now = arrays["leaf_entities"].shape[1]
    maxN = max(max((N1 - N0 for _, _, N0, N1, _, _ in slices), default=0), 1)
    maxL = max(max((L1 - L0 for *_, L0, L1 in slices), default=0), 1)

    if shapes is None:
        shapes = ForestShardShapes(
            n_dev=n_dev, kloc=Kloc, cap=cap_now, nodes=maxN, leaves=maxL,
            leaf_sz=leaf_sz_now, max_depth=f.max_depth)
    else:
        over = []
        if shapes.n_dev != n_dev:
            over.append(f"n_dev {n_dev} != {shapes.n_dev}")
        if Kloc > shapes.kloc:
            over.append(f"kloc {Kloc} > {shapes.kloc}")
        if cap_now > shapes.cap:
            over.append(f"cap {cap_now} > {shapes.cap}")
        if maxN > shapes.nodes:
            over.append(f"nodes {maxN} > {shapes.nodes}")
        if maxL > shapes.leaves:
            over.append(f"leaves {maxL} > {shapes.leaves}")
        if leaf_sz_now > shapes.leaf_sz:
            over.append(f"leaf_sz {leaf_sz_now} > {shapes.leaf_sz}")
        if f.max_depth > shapes.max_depth:
            over.append(f"max_depth {f.max_depth} > {shapes.max_depth}")
        if over:
            raise ValueError(
                "forest outgrew the reserved shard shapes ("
                + ", ".join(over)
                + "); rebuild the backend (or raise headroom)")
    Kloc, cap = shapes.kloc, shapes.cap
    padN, padL, leaf_sz = shapes.nodes, shapes.leaves, shapes.leaf_sz
    dead = padN                               # per-shard dead-leaf node id

    out = {
        "proj": np.zeros((n_dev, padN + 1, d), np.float32),
        "dims": np.zeros((n_dev, padN + 1), arrays["dims"].dtype),
        "tau": np.zeros((n_dev, padN + 1), np.float32),
        "children": np.full((n_dev, padN + 1, 2), -1, np.int32),
        "leaf_row": np.full((n_dev, padN + 1), -1, np.int32),
        "leaf_entities": np.full((n_dev, padL, leaf_sz), -1, np.int32),
        "roots": np.full((n_dev, Kloc), dead, np.int32),
        "valid": np.zeros((n_dev, Kloc), bool),
        "cents": np.zeros((n_dev, Kloc, d), np.float32),
        "bucket_ids": np.full((n_dev, Kloc, cap), -1, np.int32),
        "bvecs": np.zeros((n_dev, Kloc, cap, d), np.float32),
    }
    for s, (b0, b1, N0, N1, L0, L1) in enumerate(slices):
        nb, nn, nl = b1 - b0, N1 - N0, L1 - L0
        if nb == 0:
            continue
        ch = arrays["children"][N0:N1].copy()
        ch[ch >= 0] -= N0
        lr = arrays["leaf_row"][N0:N1].copy()
        lr[lr >= 0] -= L0
        out["proj"][s, :nn] = arrays["proj"][N0:N1]
        out["dims"][s, :nn] = arrays["dims"][N0:N1]
        out["tau"][s, :nn] = arrays["tau"][N0:N1]
        out["children"][s, :nn] = ch
        out["leaf_row"][s, :nn] = lr
        out["roots"][s, :nb] = (roots[b0:b1] - N0).astype(np.int32)
        out["valid"][s, :nb] = True
        out["cents"][s, :nb] = index.centroids[b0:b1]
        bl = index.bucket_ids[b0:b1]
        out["bucket_ids"][s, :nb, :cap_now] = bl
        bv = index.db[np.maximum(bl, 0)]
        out["bvecs"][s, :nb, :cap_now] = np.where((bl >= 0)[..., None], bv,
                                                  0.0)
        # global entity id -> local bucket-slot id for this shard's leaves
        # (deleted entities are absent from bucket_ids -> slot -1)
        slot_of = np.full(index.db.shape[0], -1, np.int64)
        rr, cc = np.nonzero(bl >= 0)
        slot_of[bl[rr, cc]] = rr * cap + cc
        le = arrays["leaf_entities"][L0:L1]
        le = np.pad(le, ((0, 0), (0, leaf_sz - le.shape[1])),
                    constant_values=-1).copy()
        m = le >= 0
        le[m] = slot_of[le[m]]
        out["leaf_entities"][s, :nl] = le
    out["max_depth"] = shapes.max_depth
    return out


def _slab_slot_of(index, Kloc: int, cap: int) -> np.ndarray:
    """Global entity id -> slab bucket-slot id (``(b % Kloc) * cap + col``)
    for every placed entity; -1 for deleted/absent.  One vectorized pass,
    shared by the full slab slicer and the delta slicer."""
    rr, cc = np.nonzero(index.bucket_ids >= 0)
    keep = cc < cap          # per-bucket overflow is diagnosed later
    rr, cc = rr[keep], cc[keep]
    slot_of = np.full(index.db.shape[0], -1, np.int64)
    slot_of[index.bucket_ids[rr, cc]] = (rr % Kloc) * cap + cc
    return slot_of


def _bucket_slab_payload(index, shapes: ForestShardShapes, b: int, j: int,
                         arrays: dict, roots: np.ndarray,
                         windows, slot_of: np.ndarray) -> dict:
    """One bucket's fixed-shape slab: every per-bucket array padded to the
    reserved slab sizes, node/leaf offsets rebased to slot ``j``'s
    windows, leaf entity ids remapped to the shard's bucket-slot ids
    (via the precomputed ``slot_of``).  Raises when the bucket outgrew a
    reservation (the same loud contract as the packed slicer)."""
    N0, N1, L0, L1 = windows[b]
    nb, nl = N1 - N0, L1 - L0
    cap, node_slab, leaf_slab = shapes.cap, shapes.node_slab, shapes.leaf_slab
    d = index.db.shape[1]
    over = []
    if nb > node_slab:
        over.append(f"nodes {nb} > slab {node_slab}")
    if nl > leaf_slab:
        over.append(f"leaves {nl} > slab {leaf_slab}")
    bl_full = index.bucket_ids[b]
    count = int((bl_full >= 0).sum())
    if count > cap:
        over.append(f"bucket count {count} > cap {cap}")
    le_w = arrays["leaf_entities"].shape[1]
    if le_w > shapes.leaf_sz:
        over.append(f"leaf_sz {le_w} > {shapes.leaf_sz}")
    if over:
        raise ValueError(
            f"bucket {b} outgrew the reserved slab shapes ("
            + ", ".join(over) + "); rebuild the backend (or raise headroom)")

    proj = np.zeros((node_slab, d), np.float32)
    dims = np.zeros((node_slab,), arrays["dims"].dtype)
    tau = np.zeros((node_slab,), np.float32)
    children = np.full((node_slab, 2), -1, np.int32)
    leaf_row = np.full((node_slab,), -1, np.int32)
    leaf_ents = np.full((leaf_slab, shapes.leaf_sz), -1, np.int32)
    proj[:nb] = arrays["proj"][N0:N1]
    dims[:nb] = arrays["dims"][N0:N1]
    tau[:nb] = arrays["tau"][N0:N1]
    ch = arrays["children"][N0:N1].astype(np.int32, copy=True)
    ch[ch >= 0] += j * node_slab - N0
    children[:nb] = ch
    lr = arrays["leaf_row"][N0:N1].astype(np.int32, copy=True)
    lr[lr >= 0] += j * leaf_slab - L0
    leaf_row[:nb] = lr

    # global entity id -> this shard's bucket-slot id (deleted entities
    # are absent from bucket_ids -> slot -1 via the shared slot_of map)
    bids = np.full((cap,), -1, np.int32)
    w = min(cap, bl_full.shape[0])
    bids[:w] = bl_full[:w]
    le = arrays["leaf_entities"][L0:L1]
    le = np.pad(le, ((0, 0), (0, shapes.leaf_sz - le.shape[1])),
                constant_values=-1).astype(np.int32, copy=True)
    m = le >= 0
    le[m] = slot_of[le[m]]
    leaf_ents[:nl] = le

    bv = index.db[np.maximum(bids, 0)].astype(np.float32)
    bv = np.where((bids >= 0)[:, None], bv, 0.0)
    return {
        "proj": proj, "dims": dims, "tau": tau, "children": children,
        "leaf_row": leaf_row, "leaf_entities": leaf_ents,
        "roots": np.int32(j * node_slab + int(roots[b] - N0)),
        "valid": True,
        "cents": index.centroids[b].astype(np.float32),
        "bucket_ids": bids, "bvecs": bv,
    }


def _shard_forest_slab(index, shapes: ForestShardShapes) -> dict:
    """Slab-layout slicer: same output contract as the packed
    ``shard_forest`` (stacked host arrays + ``max_depth``), but bucket
    ``b`` always lands at slot ``b % kloc`` of shard ``b // kloc`` with
    fixed node/leaf windows — so a mutated bucket later re-ships as a
    standalone slab (:func:`slice_forest_delta`)."""
    f = index.forest
    K = index.bucket_ids.shape[0]
    n_dev, Kloc = shapes.n_dev, shapes.kloc
    if -(-K // n_dev) > Kloc:
        raise ValueError(
            f"forest outgrew the reserved shard shapes (kloc "
            f"{-(-K // n_dev)} > {Kloc}); rebuild the backend")
    if f.max_depth > shapes.max_depth:
        raise ValueError(
            f"forest outgrew the reserved shard shapes (max_depth "
            f"{f.max_depth} > {shapes.max_depth}); rebuild the backend "
            "(or raise headroom)")
    arrays = {name: np.asarray(v) for name, v in f.arrays.items()}
    roots = np.asarray(f.roots, dtype=np.int64)
    windows = _bucket_windows(index)
    d = index.db.shape[1]
    padN, padL, cap = shapes.nodes, shapes.leaves, shapes.cap
    dead = padN                               # per-shard dead-leaf node id
    out = {
        "proj": np.zeros((n_dev, padN + 1, d), np.float32),
        "dims": np.zeros((n_dev, padN + 1), arrays["dims"].dtype),
        "tau": np.zeros((n_dev, padN + 1), np.float32),
        "children": np.full((n_dev, padN + 1, 2), -1, np.int32),
        "leaf_row": np.full((n_dev, padN + 1), -1, np.int32),
        "leaf_entities": np.full((n_dev, padL, shapes.leaf_sz), -1,
                                 np.int32),
        "roots": np.full((n_dev, Kloc), dead, np.int32),
        "valid": np.zeros((n_dev, Kloc), bool),
        "cents": np.zeros((n_dev, Kloc, d), np.float32),
        "bucket_ids": np.full((n_dev, Kloc, cap), -1, np.int32),
        "bvecs": np.zeros((n_dev, Kloc, cap, d), np.float32),
    }
    ns, ls = shapes.node_slab, shapes.leaf_slab
    slot_of = _slab_slot_of(index, Kloc, cap)
    for b in range(K):
        s, j = b // Kloc, b % Kloc
        p = _bucket_slab_payload(index, shapes, b, j, arrays, roots,
                                 windows, slot_of)
        out["proj"][s, j * ns:(j + 1) * ns] = p["proj"]
        out["dims"][s, j * ns:(j + 1) * ns] = p["dims"]
        out["tau"][s, j * ns:(j + 1) * ns] = p["tau"]
        out["children"][s, j * ns:(j + 1) * ns] = p["children"]
        out["leaf_row"][s, j * ns:(j + 1) * ns] = p["leaf_row"]
        out["leaf_entities"][s, j * ls:(j + 1) * ls] = p["leaf_entities"]
        out["roots"][s, j] = p["roots"]
        out["valid"][s, j] = True
        out["cents"][s, j] = p["cents"]
        out["bucket_ids"][s, j] = p["bucket_ids"]
        out["bvecs"][s, j] = p["bvecs"]
    out["max_depth"] = shapes.max_depth
    return out


def slice_forest_delta(index, shapes: ForestShardShapes,
                       dirty_buckets) -> dict:
    """Slice only the dirty buckets into stacked fixed-shape slab
    payloads (slab layout required: ``shapes.node_slab > 0``).

    Returns host arrays keyed like the device tables plus ``shard`` /
    ``slot`` index vectors: the operand set of the backend's in-place
    scatter.  Payload bytes are what a delta republish actually
    ships; compare against the full re-place bytes for the fallback
    decision.
    """
    if shapes.node_slab <= 0:
        raise ValueError("delta slicing requires the slab layout "
                         "(forest_shard_shapes(..., layout='slab'))")
    K = index.bucket_ids.shape[0]
    dirty = np.unique(np.asarray(dirty_buckets, dtype=np.int64))
    if dirty.size and (dirty.min() < 0 or dirty.max() >= K):
        raise ValueError(f"dirty bucket id out of range [0, {K})")
    f = index.forest
    if f.max_depth > shapes.max_depth:
        raise ValueError(
            f"forest outgrew the reserved shard shapes (max_depth "
            f"{f.max_depth} > {shapes.max_depth}); rebuild the backend "
            "(or raise headroom)")
    arrays = {name: np.asarray(v) for name, v in f.arrays.items()}
    roots = np.asarray(f.roots, dtype=np.int64)
    windows = _bucket_windows(index)
    Kloc = shapes.kloc
    slot_of = _slab_slot_of(index, Kloc, shapes.cap)
    rows = [_bucket_slab_payload(index, shapes, int(b), int(b % Kloc),
                                 arrays, roots, windows, slot_of)
            for b in dirty]
    out = {"shard": (dirty // Kloc).astype(np.int32),
           "slot": (dirty % Kloc).astype(np.int32)}
    for name in ("proj", "dims", "tau", "children", "leaf_row",
                 "leaf_entities", "roots", "valid", "cents",
                 "bucket_ids", "bvecs"):
        out[name] = np.stack([p[name] for p in rows]) if rows else \
            np.zeros((0,), np.int32)
    return out


def slice_ivf_delta(index, cap: int, dirty_buckets) -> dict:
    """Dirty-bucket rows of the IVF device tables (centroid, padded slot
    row, gathered bucket-vector tile), ready to scatter at ``rows``."""
    K, cap_now = index.bucket_ids.shape
    if cap < cap_now:
        raise ValueError(
            f"bucket cap grew to {cap_now} > reserved {cap}; rebuild the "
            f"backend (or raise headroom)")
    dirty = np.unique(np.asarray(dirty_buckets, dtype=np.int64))
    if dirty.size and (dirty.min() < 0 or dirty.max() >= K):
        raise ValueError(f"dirty bucket id out of range [0, {K})")
    bids = np.full((dirty.size, cap), -1, np.int32)
    bids[:, :cap_now] = index.bucket_ids[dirty]
    bvecs = index.db[np.maximum(bids, 0)].astype(np.float32)
    bvecs = np.where((bids >= 0)[..., None], bvecs, 0.0)
    return {
        "rows": dirty.astype(np.int32),
        "cents": index.centroids[dirty].astype(np.float32),
        "bucket_ids": bids,
        "bvecs": bvecs,
    }


def make_sharded_forest_fn(k: int, nprobe_local: int, beam_width: int,
                           leaf_size: int, max_depth: int, *,
                           fused: bool = True):
    """Two-level, tree/QLBT bottom, over a bucket-sharded forest:
    ``fn(cents, valid, roots, bucket_ids, bvecs, proj, dims, tau, children,
    leaf_row, leaf_entities, q)``, each table with its leading shard dim
    (length 1 on one card).

    The shard scores its centroids, descends its forest for the
    ``nprobe_local`` best buckets (one batched beam search over the
    shard's node table), reranks the leaf candidates (bucket-slot ids)
    against the shard's ``(Kloc cap, d)`` vector table and contributes its
    top-k to the merge.  Fused, the rerank is one ``candidate_rows_topk_op``
    call (on the card the ``candidate_topk`` kernel reading the rows by
    slot id); unfused, the reference's gather, distances and top-k.
    """
    from repro_torch.core.tree import tree_search

    def local(cents, valid, roots, bids, bvecs, proj, dims, tau, children,
              leaf_row, leaf_ents, q):
        cents, valid, roots = cents[0], valid[0], roots[0]
        bids, bvecs = bids[0], bvecs[0]
        arrays = dict(proj=proj[0], dims=dims[0], tau=tau[0],
                      children=children[0], leaf_row=leaf_row[0],
                      leaf_entities=leaf_ents[0])
        B, dd = q.shape
        np_eff = min(nprobe_local, cents.shape[0])
        d2c = torch.where(valid[None, :], pairwise_l2sq(q, cents), INF)
        _, probe = stable_topk(d2c, np_eff)                # (B, np)
        rr = roots[probe].reshape(-1)
        qq = torch.repeat_interleave(q, np_eff, dim=0)      # (B*np, d)
        vecs_flat = bvecs.reshape(-1, dd)                   # (Kloc*cap, d)
        res = tree_search(arrays, vecs_flat, qq, kind="rp",
                          beam_width=beam_width, k=beam_width * leaf_size,
                          max_steps=max_depth + 4, rerank=False, roots=rr)
        cand = res.ids.reshape(B, -1)                       # local slot ids
        # bucket-slot liveness: a slot whose bucket entry is -1 holds no
        # servable entity (pads, compacted deletes, filtered-out rows)
        flat_bids = bids.reshape(-1)
        cand = torch.where(
            (cand >= 0) & (flat_bids[torch.clamp(cand, min=0).long()] >= 0),
            cand, -1)
        if fused:
            ld, slot = kernel_ops.candidate_rows_topk_op(q, vecs_flat, cand,
                                                         k)
            gids = flat_bids[torch.clamp(slot, min=0).long()]
            li = torch.where((slot >= 0) & ~torch.isinf(ld), gids, -1)
        else:
            vecs = vecs_flat[torch.clamp(cand, min=0).long()]
            d2 = torch.where(cand >= 0, batched_l2sq(vecs, q), INF)
            k_eff = min(k, cand.shape[1])
            ld, sel = stable_topk(d2, k_eff)
            slot = torch.gather(cand, 1, sel)
            gids = flat_bids[torch.clamp(slot, min=0).long()]
            li = torch.where((slot >= 0) & ~torch.isinf(ld), gids, -1)
            ld, li = pad_sentinel(ld, li, k, k_eff)
        return _merge_gathered(*_gather_shards(ld, li.to(torch.int32)), k)

    return local


def _forest_device_arrays(index, device, shapes=None):
    """Slice ``index``'s forest (one shard) and place every table on
    ``device``.  Returns ({name: tensor}, {name: host array} with
    ``max_depth``)."""
    sh = shard_forest(index, 1, shapes=shapes)
    return ({name: torch.as_tensor(v, device=device)
             for name, v in sh.items() if name != "max_depth"}, sh)
