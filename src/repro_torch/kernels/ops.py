"""Device dispatch of the ported kernels (mirrors ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version in ``ref``.  There is no fallback
from one to the other and no switch that forces either.  Both answer any
``k``, as the reference does: the kernels whose lists hold at most
``common.KMAX`` (``KMAX_PQ``) pairs take a larger ``k`` in passes
(``common.topk_passes``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (bm25, bucket_topk, hamming, l2_topk, pq_adc,
                                 ref)

__all__ = ["l2_topk_op", "l2_topk_int8_op", "candidate_topk_op",
           "bucket_probe_topk_op",
           "bm25_topk_op", "hybrid_topk_op", "pq_adc_topk_op",
           "hamming_topk_op", "quantize_rows_int8"]


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


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


def l2_topk_op(queries, db, k: int = 10, *, valid=None):
    """Fused brute-force L2 top-k: (dists ascending, ids)."""
    if _on_card(queries):
        return l2_topk.l2_topk(queries, db, k, valid=valid)
    return ref.l2_topk_ref(queries, db, k, valid=valid)


def l2_topk_int8_op(queries, codes, scales, k: int = 10, *, valid=None):
    """int8-footprint brute scan (rows as per-row-scaled int8 codes)."""
    if _on_card(queries):
        return l2_topk.l2_topk_int8(queries, codes, scales, k, valid=valid)
    return ref.l2_topk_int8_ref(queries, codes, scales, k, valid=valid)


def candidate_topk_op(queries, vecs, ids, k: int = 10, *,
                      best_d=None, best_i=None):
    """Per-query candidate-tile L2 top-k with optional carried best (IVF
    probe chains): (dists ascending, ids)."""
    if _on_card(queries):
        return bucket_topk.candidate_topk(queries, vecs, ids, k,
                                          best_d=best_d, best_i=best_i)
    return ref.candidate_topk_ref(queries, vecs, ids, k,
                                  best_d=best_d, best_i=best_i)


def bucket_probe_topk_op(queries, probe, bucket_ids, k: int = 10, *,
                         bucket_vecs=None, db=None):
    """The whole IVF probe chain: the top-k of each query's probed buckets,
    rows from ``bucket_vecs`` (K, cap, d) or ``db`` (N, d): (dists
    ascending, ids).  On the card one scan and one merge launch a pass."""
    if _on_card(queries):
        return bucket_topk.bucket_probe_topk(queries, probe, bucket_ids, k,
                                             bucket_vecs=bucket_vecs, db=db)
    return ref.bucket_probe_topk_ref(queries, probe, bucket_ids, k,
                                     bucket_vecs=bucket_vecs, db=db)


def bm25_topk_op(q_terms, q_weights, terms, tf_sat, k: int = 10, *,
                 valid=None):
    """Fused BM25 scan over postings slabs: (-score ascending, ids)."""
    if _on_card(q_terms):
        return bm25.bm25_topk(q_terms, q_weights, terms, tf_sat, k,
                              valid=valid)
    return ref.bm25_topk_ref(q_terms, q_weights, terms, tf_sat, k,
                             valid=valid)


def hybrid_topk_op(queries, db, q_terms, q_weights, terms, tf_sat, alpha,
                   k: int = 10, *, valid=None):
    """Fused ``alpha * l2sq - (1 - alpha) * bm25`` top-k; ``alpha`` is a
    (1, 1) operand on the queries' device."""
    if _on_card(queries):
        return bm25.hybrid_topk(queries, db, q_terms, q_weights, terms,
                                tf_sat, alpha, k, valid=valid)
    return ref.hybrid_topk_ref(queries, db, q_terms, q_weights, terms,
                               tf_sat, alpha, k, valid=valid)


def pq_adc_topk_op(lut, codes, k: int = 10, *, valid=None):
    """PQ ADC scan + top-k from a per-query (B, M, 256) LUT: (adc dists
    ascending, ids)."""
    if _on_card(lut):
        return pq_adc.pq_adc_topk(lut, codes, k, valid=valid)
    return ref.pq_adc_topk_ref(lut, codes, k, valid=valid)


def hamming_topk_op(qcodes, codes, k: int = 10, *, valid=None):
    """Packed-bit Hamming scan + top-k: (dists ascending, ids)."""
    if _on_card(qcodes):
        return hamming.hamming_topk(qcodes, codes, k, valid=valid)
    return ref.hamming_topk_ref(qcodes, codes, k, valid=valid)
