"""Device dispatch of the ported kernels (mirrors ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version in ``ref``.  There is no fallback
from one to the other and no switch that forces either.  A ``meta``
tensor (the dry run, ``launch/dryrun.py``) reaches neither: it gets empty
``meta`` tensors of the kernel's result contract, (B, k) float32
distances and int32 ids, ``k`` clamped inside and the slots past the
candidates padded back to ``k`` as the kernel pads them (the counterpart
of XLA's abstract evaluation of a Pallas call).  Both answer any
``k``, as the reference does: the kernels whose lists hold at most
``common.KMAX`` (``KMAX_PQ``) pairs take a larger ``k`` in passes
(``common.topk_passes``).  ``tree_descent_op`` is no top-k: its ``meta``
branch gives the descent's five int32 results by shape,
``count_min_update_op``'s the sketch's new table and heavy hitters, and
``lsh_probe_shortlist_op``'s the (B, shortlist) int32 ids.  The two
attentions are no top-k either: ``chunked_attention_op`` and
``decode_attention_op`` give their output's shape and type on ``meta``,
and dispatch there the plain versions' products (per KV block, as the
reference's dry run counts its scan's dots), so that a FLOP counter sees
what the kernel computes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.annotations import hot_path
from repro_torch.kernels import (attention, bm25, bucket_topk, count_min,
                                 hamming, l2_topk, lsh_probe, pq_adc, ref,
                                 tree_descent)

__all__ = ["l2_topk_op", "l2_topk_int8_op", "candidate_topk_op",
           "candidate_rows_topk_op", "bucket_probe_topk_op",
           "bm25_topk_op", "hybrid_topk_op", "pq_adc_topk_op",
           "hamming_topk_op", "lsh_probe_shortlist_op", "tree_descent_op",
           "count_min_update_op", "chunked_attention_op",
           "decode_attention_op", "quantize_rows_int8"]


def _on_card(device: torch.device) -> bool:
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {device}")


def _shape_only(x: torch.Tensor, k: int, dots=None):
    """The result contract on ``meta``: (B, k) float32 and int32, no
    storage, where B is ``x``'s leading dim; ``None`` off ``meta``.
    ``dots`` (batch, m, n, depth): the candidate dot products the plain
    version computes, dispatched as one ``meta`` ``bmm`` so that a FLOP
    counter sees the kernel's products (the reference's dry run counts
    them in its plain lowering)."""
    if x.device.type != "meta":
        return None
    if dots is not None:
        b, m, n, depth = (int(v) for v in dots)
        torch.bmm(torch.empty((b, m, depth), device="meta"),
                  torch.empty((b, depth, n), device="meta"))
    b = x.shape[0]
    return (torch.empty((b, k), dtype=torch.float32, device="meta"),
            torch.empty((b, k), dtype=torch.int32, device="meta"))


def quantize_rows_int8(db) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization: ``row ~= scale * codes``.

    Returns (codes (N, D) int8, scales (N,) float32), on the host, at
    placement time; all-zero rows get scale 1.0 so the dequantized row is
    exactly zero.  A numpy copy of the reference's, bit for bit.
    """
    x = np.asarray(db, dtype=np.float32)
    amax = np.max(np.abs(x), axis=1)
    scales = np.where(amax > 0.0, amax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


@hot_path
def l2_topk_op(queries, db, k: int = 10, *, valid=None):
    """Fused brute-force L2 top-k: (dists ascending, ids)."""
    meta = _shape_only(queries, k, (1, queries.shape[0], db.shape[0],
                                    queries.shape[1]))
    if meta is not None:
        return meta
    if _on_card(queries.device):
        return l2_topk.l2_topk(queries, db, k, valid=valid)
    return ref.l2_topk_ref(queries, db, k, valid=valid)


@hot_path
def l2_topk_int8_op(queries, codes, scales, k: int = 10, *, valid=None):
    """int8-footprint brute scan (rows as per-row-scaled int8 codes)."""
    meta = _shape_only(queries, k, (1, queries.shape[0], codes.shape[0],
                                    queries.shape[1]))
    if meta is not None:
        return meta
    if _on_card(queries.device):
        return l2_topk.l2_topk_int8(queries, codes, scales, k, valid=valid)
    return ref.l2_topk_int8_ref(queries, codes, scales, k, valid=valid)


@hot_path
def candidate_topk_op(queries, vecs, ids, k: int = 10, *,
                      best_d=None, best_i=None):
    """Per-query candidate-tile L2 top-k with optional carried best (IVF
    probe chains): (dists ascending, ids)."""
    meta = _shape_only(queries, k, (vecs.shape[0], 1, vecs.shape[1],
                                    vecs.shape[2]))
    if meta is not None:
        return meta
    if _on_card(queries.device):
        return bucket_topk.candidate_topk(queries, vecs, ids, k,
                                          best_d=best_d, best_i=best_i)
    return ref.candidate_topk_ref(queries, vecs, ids, k,
                                  best_d=best_d, best_i=best_i)


@hot_path
def candidate_rows_topk_op(queries, rows, ids, k: int = 10):
    """Per-query candidate row ids into one (N, d) table, the rows read by
    id (the served forest's rerank): (dists ascending, ids)."""
    meta = _shape_only(queries, k, (ids.shape[0], 1, ids.shape[1],
                                    rows.shape[1]))
    if meta is not None:
        return meta
    if _on_card(queries.device):
        return bucket_topk.candidate_rows_topk(queries, rows, ids, k)
    return ref.candidate_rows_topk_ref(queries, rows, ids, k)


@hot_path
def bucket_probe_topk_op(queries, probe, bucket_ids, k: int = 10, *,
                         bucket_vecs=None, db=None):
    """The whole IVF probe chain: the top-k of each query's probed buckets,
    rows from ``bucket_vecs`` (K, cap, d) or ``db`` (N, d): (dists
    ascending, ids).  On the card one scan and one merge launch a pass."""
    meta = _shape_only(queries, k, (
        queries.shape[0], 1, probe.shape[1] * bucket_ids.shape[1],
        queries.shape[1]))
    if meta is not None:
        return meta
    if _on_card(queries.device):
        return bucket_topk.bucket_probe_topk(queries, probe, bucket_ids, k,
                                             bucket_vecs=bucket_vecs, db=db)
    return ref.bucket_probe_topk_ref(queries, probe, bucket_ids, k,
                                     bucket_vecs=bucket_vecs, db=db)


@hot_path
def bm25_topk_op(q_terms, q_weights, terms, tf_sat, k: int = 10, *,
                 valid=None):
    """Fused BM25 scan over postings slabs: (-score ascending, ids)."""
    meta = _shape_only(q_terms, k)
    if meta is not None:
        return meta
    if _on_card(q_terms.device):
        return bm25.bm25_topk(q_terms, q_weights, terms, tf_sat, k,
                              valid=valid)
    return ref.bm25_topk_ref(q_terms, q_weights, terms, tf_sat, k,
                             valid=valid)


@hot_path
def hybrid_topk_op(queries, db, q_terms, q_weights, terms, tf_sat, alpha,
                   k: int = 10, *, valid=None):
    """Fused ``alpha * l2sq - (1 - alpha) * bm25`` top-k; ``alpha`` is a
    (1, 1) operand on the queries' device."""
    meta = _shape_only(queries, k, (1, queries.shape[0], db.shape[0],
                                    queries.shape[1]))
    if meta is not None:
        return meta
    if _on_card(queries.device):
        return bm25.hybrid_topk(queries, db, q_terms, q_weights, terms,
                                tf_sat, alpha, k, valid=valid)
    return ref.hybrid_topk_ref(queries, db, q_terms, q_weights, terms,
                               tf_sat, alpha, k, valid=valid)


@hot_path
def pq_adc_topk_op(lut, codes, k: int = 10, *, valid=None):
    """PQ ADC scan + top-k from a per-query (B, M, 256) LUT: (adc dists
    ascending, ids)."""
    meta = _shape_only(lut, k)
    if meta is not None:
        return meta
    if _on_card(lut.device):
        return pq_adc.pq_adc_topk(lut, codes, k, valid=valid)
    return ref.pq_adc_topk_ref(lut, codes, k, valid=valid)


@hot_path
def hamming_topk_op(qcodes, codes, k: int = 10, *, valid=None):
    """Packed-bit Hamming scan + top-k: (dists ascending, ids)."""
    meta = _shape_only(qcodes, k)
    if meta is not None:
        return meta
    if _on_card(qcodes.device):
        return hamming.hamming_topk(qcodes, codes, k, valid=valid)
    return ref.hamming_topk_ref(qcodes, codes, k, valid=valid)


@hot_path
def lsh_probe_shortlist_op(qproj, codes, bucket_ids, probe,
                           shortlist: int, *, extents):
    """The LSH bottom's probe scan (the reference's jitted ``lax.scan``
    ``_probe_scan_lsh``): each query's Hamming shortlist over its probed
    buckets' slots, (B, shortlist) int32 ids in (distance, probe slot,
    column) order, -1 past the live slots.  ``qproj`` is queries @
    projections; ``extents`` (K,) int32 one past each bucket row's last
    live column (the index's ``bucket_counts``).  On the card one launch,
    which packs the sign bits and reads only the columns before each
    row's extent; the plain chain reads whole rows and ignores them."""
    meta = _shape_only(qproj, shortlist)
    if meta is not None:
        return meta[1]
    if _on_card(qproj.device):
        return lsh_probe.lsh_probe_shortlist(qproj, codes, bucket_ids,
                                             probe, shortlist,
                                             extents=extents)
    return ref.lsh_probe_shortlist_ref(qproj, codes, bucket_ids, probe,
                                       shortlist, extents=extents)


@hot_path
def tree_descent_op(arrays: dict, queries, *, kind: str, beam_width: int,
                    max_steps: int, roots=None):
    """The tree beam descent and its leaf gather (``core.tree.tree_search``
    before its rerank): (nodes (R, W), steps (R,), internal_visits (R,),
    leaf candidates (R, W leaf) with -1 pads, their count (R,)), int32.
    On the card one launch, each row stopping where the reference's
    ``while_loop`` leaves it."""
    if queries.device.type == "meta":
        R, W = queries.shape[0], beam_width
        leaf = arrays["leaf_entities"].shape[1]
        return tuple(torch.empty(shape, dtype=torch.int32, device="meta")
                     for shape in ((R, W), (R,), (R,), (R, W * leaf), (R,)))
    if _on_card(queries.device):
        return tree_descent.tree_descent(arrays, queries, kind=kind,
                                         beam_width=beam_width,
                                         max_steps=max_steps, roots=roots)
    return ref.tree_descent_ref(arrays, queries, kind=kind,
                                beam_width=beam_width, max_steps=max_steps,
                                roots=roots)


@hot_path
def count_min_update_op(table, a, b, hh_ids, ids: np.ndarray,
                        weights: np.ndarray, decay: float):
    """One count-min sketch update (the reference's jitted ``_update``):
    the decayed table with the batch's adds, and the re-ranked heavy
    hitters, as new tensors (table, hh_ids (topk,) int32, hh_est (topk,)
    fp32).  ``ids`` / ``weights`` (m,) live on the host.  On the card one
    launch; on the CPU the plain version, its adds planned on the host."""
    if table.device.type == "meta":
        k = hh_ids.shape[0]
        return (torch.empty(table.shape, dtype=torch.float32, device="meta"),
                torch.empty((k,), dtype=torch.int32, device="meta"),
                torch.empty((k,), dtype=torch.float32, device="meta"))
    if _on_card(table.device):
        return count_min.count_min_update(table, a, b, hh_ids, ids, weights,
                                          decay)
    return ref.count_min_update_ref(table, a, b, hh_ids, ids, weights, decay)


def _meta_products(batch: int, m: int, depth: int, n: int, dv: int,
                   times: int, dtype) -> None:
    """``times`` pairs of ``meta`` products, (batch, m, depth) @ (depth,
    n) then (batch, m, n) @ (n, dv): an attention's scores and P.V."""
    for _ in range(times):
        torch.bmm(torch.empty((batch, m, depth), dtype=dtype, device="meta"),
                  torch.empty((batch, depth, n), dtype=dtype, device="meta"))
        torch.bmm(torch.empty((batch, m, n), dtype=dtype, device="meta"),
                  torch.empty((batch, n, dv), dtype=dtype, device="meta"))


@hot_path
def chunked_attention_op(q, k, v, *, causal: bool, chunk: int,
                         scale: float, q_pos=None, kv_mask=None):
    """The chunked attention (the reference's ``lax.scan`` over KV blocks
    of ``chunk`` slots): q (B, Sq, Hq, dh), k (B, Sk, Hkv, dh), v (B, Sk,
    Hkv, dv) -> (B, Sq, Hq, dv) in q's type.  On the card one launch of
    ``attention_chunked``; on the CPU the plain block loop."""
    if q.device.type == "meta":
        b, sq, hq, dh = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        _meta_products(b * hkv, (hq // hkv) * sq, dh, chunk, v.shape[-1],
                       -(-sk // chunk), torch.promote_types(q.dtype, k.dtype))
        return torch.empty((b, sq, hq, v.shape[-1]), dtype=q.dtype,
                           device="meta")
    if _on_card(q.device):
        return attention.attention_chunked(q, k, v, causal=causal,
                                           chunk=chunk, scale=scale,
                                           q_pos=q_pos, kv_mask=kv_mask)
    return ref.chunked_attention_ref(q, k, v, causal=causal, chunk=chunk,
                                     q_pos=q_pos, kv_mask=kv_mask,
                                     scale=scale)


@hot_path
def decode_attention_op(q, k_cache, v_cache, lengths, *, scale: float):
    """One-token attention over a KV cache (the reference's
    ``decode_attention``): q (B, 1, Hq, dh), caches (B, S, Hkv, dh|dv),
    slots t < ``lengths[b]`` valid -> (B, 1, Hq, dv).  On the card one
    ``attention_decode`` call reading the cache in place; on the CPU the
    plain version."""
    if q.device.type == "meta":
        b, s, hkv, dh = k_cache.shape
        hq, dv = q.shape[2], v_cache.shape[-1]
        _meta_products(b * hkv, hq // hkv, dh, s, dv, 1,
                       torch.promote_types(q.dtype, k_cache.dtype))
        return torch.empty((b, 1, hq, dv),
                           dtype=torch.promote_types(q.dtype, v_cache.dtype),
                           device="meta")
    if _on_card(q.device):
        return attention.attention_decode(q, k_cache, v_cache, lengths,
                                          scale=scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                    scale=scale)
