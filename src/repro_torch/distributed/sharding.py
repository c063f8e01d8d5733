"""Sharded search: device arrays, the per-shard brute (fp32 / int8),
lexical, hybrid and IVF locals, and the merge of per-shard results.

Port of the brute/IVF/lexical/hybrid half of
``repro/distributed/sharding.py``.  In the
reference each chip of a mesh runs a local over its shard inside
``shard_map`` and an ``all_gather`` brings every shard's top-k together
for ``_merge_gathered``.  Here one card holds one shard: a local's
result is stacked as the single entry of the ``(S, B, k)`` tensor that
``_merge_gathered`` takes, so a later slice can feed it from a
``torch.distributed`` all-gather instead without touching the merge.

``fused=True`` routes the per-shard scan through ``kernels.ops`` (the
CUDA kernels on the card, their plain versions on the CPU);
``fused=False`` runs the reference's unfused ops.  On the CPU both give
the same ids, since the plain versions are built from the same ops.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.common import INF, stable_topk
from repro_torch.kernels.ref import bm25_dists_ref

__all__ = ["make_sharded_brute_fn", "make_sharded_ivf_fn",
           "make_sharded_lexical_fn", "make_sharded_hybrid_fn"]


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
