"""Sharded search: device arrays, the per-shard brute and IVF locals, and
the merge of per-shard results.

Port of the brute/IVF half of ``repro/distributed/sharding.py``.  In the
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

__all__ = ["make_sharded_brute_fn", "make_sharded_ivf_fn"]


def _brute_device_arrays(db, device, rows=None, alive=None):
    """Zero-pad db rows to the shard's row grid.  Pads (and tombstoned
    rows, via ``alive``) are masked by an explicit int32 per-row ``valid``
    operand, never by inf-valued vectors (whose distances would evaluate
    to ``inf - inf = NaN``).  Returns (padded db, valid).
    """
    db = np.asarray(db, np.float32)
    n = db.shape[0]
    if rows is None:
        rows = n
    if rows < n:
        raise ValueError(
            f"corpus has {n} rows but the shard grid holds only {rows}; "
            "rebuild the backend (or raise headroom)")
    valid = np.arange(rows) < n
    if alive is not None:
        valid[:n] &= np.asarray(alive, bool)
    dbp = torch.zeros((rows, db.shape[1]), dtype=torch.float32, device=device)
    dbp[:n] = torch.as_tensor(db, device=device)
    return dbp, torch.as_tensor(valid.astype(np.int32), device=device)


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


def make_sharded_brute_fn(k: int, shard_rows: int, *, fused: bool = True):
    """Exact search over a row-sharded corpus: ``fn(db, valid, q)``.

    Pad and tombstoned rows are masked by the ``valid`` operand, which is
    data, so a mutated corpus can be re-placed into the same shapes.
    """
    k_loc = min(k, shard_rows)   # a shard may hold fewer rows than k

    def local(db_shard, valid_shard, q):
        if fused:
            ld, li = kernel_ops.l2_topk_op(q, db_shard, k_loc,
                                           valid=valid_shard)
        else:
            d2 = pairwise_l2sq(q, db_shard)                # (B, rows)
            d2 = torch.where(valid_shard[None, :] != 0, d2, INF)
            ld, li = stable_topk(d2, k_loc)
        # one shard: its row ids are the global ids (more shards add the
        # shard's row offset here, keeping the -1 sentinel)
        li = li.to(torch.int32)
        if k_loc < k:
            b = ld.shape[0]
            ld = torch.cat([ld, ld.new_full((b, k - k_loc), INF)], dim=1)
            li = torch.cat([li, li.new_full((b, k - k_loc), -1)], dim=1)
        return _merge_gathered(*_gather_shards(ld, li), k)

    return local


def make_sharded_ivf_fn(k: int, nprobe_local: int, n_buckets: int, *,
                        fused: bool = True):
    """Two-level, brute bottom, over a bucket-sharded index:
    ``fn(cents, bucket_ids, bucket_vecs, q)``.

    The shard (1) scores its ``n_buckets`` centroids, (2) probes its
    ``nprobe_local`` best buckets one step at a time, carrying the running
    best, and (3) contributes its top-k to the merge.  (Sharded over more
    cards, the bucket tables are padded to the shard grid and the pads are
    masked by global bucket index, as in the reference.)
    """
    nprobe_local = min(nprobe_local, n_buckets)

    def local(cents, bucket_ids, bucket_vecs, q):
        d2c = pairwise_l2sq(q, cents)                      # (B, K)
        _, probe = stable_topk(d2c, nprobe_local)          # (B, np)
        B = q.shape[0]
        best_d = q.new_full((B, k), INF)
        best_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
        for j in range(nprobe_local):
            bsel = probe[:, j]                             # (B,)
            ids = bucket_ids[bsel]                         # (B, cap)
            vecs = bucket_vecs[bsel]                       # (B, cap, d)
            if fused:
                # distance + merge in one launch; the probe chain carries
                # the running best through the kernel
                best_d, best_i = kernel_ops.candidate_topk_op(
                    q, vecs, ids, k, best_d=best_d, best_i=best_i)
                continue
            d2 = torch.where(ids >= 0, batched_l2sq(vecs, q), INF)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            best_d, sel = stable_topk(cat_d, k)
            best_i = torch.gather(cat_i, 1, sel)
        return _merge_gathered(*_gather_shards(best_d, best_i), k)

    return local
