"""Plain PyTorch versions of the ported kernels (the ``ref.py`` contract).

Port of ``repro/kernels/ref.py``: the l2, int8, candidate, BM25, hybrid,
PQ-ADC and Hamming plain versions, and the probe chain over buckets
(``bucket_probe_topk_ref``, the loops the IVF local and the two-level
brute bottom ran before the chain had a kernel).  Each
function computes its kernel's result with no tiling; ``ops`` runs it for
tensors on the CPU, the tests hold it against the reference, and
``chip_smoke.py`` holds each kernel against it on the card.

``k`` is clamped to the candidate count, slots with no live candidate
come back as ``(inf, -1)``, and the distance expansions are exactly
``core.brute``'s, so the fused path equals the unfused one on the CPU.
Top-k is a stable sort over id-ordered columns (``lax.top_k``'s tie
order), never ``torch.topk``.

Each kernel with a list ceiling (all but Hamming) serves a large ``k`` in
passes, each pass bounded by a pair ``after`` (``common.topk_passes``).
Its plain version takes the same bound, ``after=(after_d, after_i)`` of
shape (B,): the pairs at or before the bound in the (distance, id) order
are dropped (-0.0 equal to +0.0), a pair repeated with the same distance
and id is kept once where the kernel does so (the candidate tile and the
probe chain), and the rest are ranked on (distance, id).  The tests drive
the pass loop over these to prove it exact; nothing on the card's path
calls them.

Tie rule: the kernels rank on the (distance, id) pair.  On an id-ordered
scan (``l2_topk``) that is the same order.  ``candidate_topk_ref`` keeps
the reference oracle's column order (carried best first, then the tile),
so it agrees with the kernel wherever ids are distinct and distances
untied — true on the IVF path, whose buckets are disjoint.

Operation order (the kernels follow it with round-to-nearest intrinsics,
nothing contracted into an FMA): int8 is ``qn + (s * s * xn8)`` then
``- (2 * s) * dot``; BM25 runs the query term slot ``t`` outer and the
document slot ``s`` inner, ``score = score + hit * qw[t]`` as two
roundings; hybrid is ``a * d2 - (1 - a) * score``; PQ-ADC sums the M
subspace entries in order ``m = 0..M-1`` from 0.0 (the Pallas kernel's
``fori_loop`` order), so the kernel equals it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels.common import (INF, pad_sentinel, popcount32,
                                        stable_topk)

__all__ = ["l2_topk_ref", "l2_topk_int8_ref", "candidate_topk_ref",
           "bucket_probe_topk_ref",
           "bm25_dists_ref", "bm25_topk_ref", "hybrid_topk_ref",
           "pq_adc_scores_ref", "pq_adc_topk_ref", "hamming_dists_ref",
           "hamming_topk_ref"]

# Elements of the (B, rows, S) match mask ``bm25_dists_ref`` builds at
# once (about 1 GB as float32); longer slabs are scanned in row chunks.
_MASK_ELEMS = 1 << 28


def _finish(d2: torch.Tensor, k: int):
    """top-k + sentinel masking + clamp-restoring pad; ids are the scan
    positions."""
    k_eff = min(k, d2.shape[1])
    d, ids = stable_topk(d2, k_eff)
    ids = torch.where(torch.isinf(d), -1, ids.to(torch.int32))
    return pad_sentinel(d, ids, k, k_eff)


def _after_topk(d: torch.Tensor, ids: torch.Tensor, k: int, after,
                unique: bool = False):
    """The ``k`` smallest (distance, id) pairs of the candidates ``d`` /
    ``ids`` (B, C) strictly after ``after = (after_d, after_i)``, each (B,)
    (``None``: no bound); with ``unique`` a pair repeated with the same
    distance and id counts once.  Dead candidates carry +inf; unfilled
    slots are ``(inf, -1)``."""
    ids = ids.to(torch.int32)
    if after is not None:
        ad = after[0].to(d.device, torch.float32)[:, None]
        ai = after[1].to(d.device, torch.int32)[:, None]
        d = torch.where((d > ad) | ((d == ad) & (ids > ai)), d, INF)
    order = torch.argsort(ids, dim=1, stable=True)      # (distance, id)
    d, ids = torch.gather(d, 1, order), torch.gather(ids, 1, order)
    if unique:
        d, sel = stable_topk(d, d.shape[1])
        ids = torch.gather(ids, 1, sel)
        again = torch.zeros_like(ids, dtype=torch.bool)
        again[:, 1:] = (d[:, 1:] == d[:, :-1]) & (ids[:, 1:] == ids[:, :-1])
        d = torch.where(again, INF, d)
    k_eff = min(k, d.shape[1])
    dd, sel = stable_topk(d, k_eff)
    ii = torch.gather(ids, 1, sel)
    return pad_sentinel(dd, torch.where(torch.isinf(dd), -1, ii), k, k_eff)


def _scan_topk(d2: torch.Tensor, k: int, after):
    """An id-ordered scan's top-k: ``_finish``, or with a bound
    ``_after_topk`` over the column ids."""
    if after is None:
        return _finish(d2, k)
    ids = torch.arange(d2.shape[1], dtype=torch.int32,
                       device=d2.device).expand(d2.shape[0], -1)
    return _after_topk(d2, ids, k, after)


def _apply_valid(d2: torch.Tensor, valid):
    if valid is None:
        return d2
    live = torch.as_tensor(valid, device=d2.device).to(torch.int32) != 0
    return torch.where(live[None, :], d2, INF)


def l2_topk_ref(queries, db, k: int = 10, *, valid=None, after=None):
    q = queries.to(torch.float32)
    x = db.to(torch.float32)
    return _scan_topk(_apply_valid(pairwise_l2sq(q, x), valid), k, after)


def l2_topk_int8_ref(queries, codes, scales, k: int = 10, *, valid=None,
                     after=None):
    """The int8-footprint scan over ``row ~= scale * codes``, the scale
    applied to the reduced terms."""
    q = queries.to(torch.float32)
    xf = codes.to(torch.float32)
    s = scales.to(torch.float32)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn8 = torch.sum(xf * xf, dim=1)
    d2 = qn + (s * s * xn8)[None, :] - 2.0 * s[None, :] * (q @ xf.T)
    return _scan_topk(_apply_valid(d2, valid), k, after)


def candidate_topk_ref(queries, vecs, ids, k: int = 10, *,
                       best_d=None, best_i=None, after=None):
    """Per-query candidate tiles with an optional carried running best
    (the IVF probe-chain pattern); the literal ops of the unfused IVF
    local.  With ``after``: the kernel's rule over [best | tile], a
    repeated pair kept once."""
    q = queries.to(torch.float32)
    v = vecs.to(torch.float32)
    ids = ids.to(torch.int32)
    d2 = torch.where(ids >= 0, batched_l2sq(v, q), INF)
    if after is not None:
        if best_d is not None:
            d2 = torch.cat([best_d.to(torch.float32), d2], dim=1)
            ids = torch.cat([best_i.to(torch.int32), ids], dim=1)
        return _after_topk(d2, ids, k, after, unique=True)
    if best_d is not None:
        cat_d = torch.cat([best_d.to(torch.float32), d2], dim=1)
        cat_i = torch.cat([best_i.to(torch.int32), ids], dim=1)
        d, sel = stable_topk(cat_d, k)
        out_i = torch.gather(cat_i, 1, sel)
    else:
        k_eff = min(k, ids.shape[1])
        d, sel = stable_topk(d2, k_eff)
        d, out_i = pad_sentinel(d, torch.gather(ids, 1, sel), k, k_eff)
    return d, torch.where(torch.isinf(d), -1, out_i)


def bucket_probe_topk_ref(queries, probe, bucket_ids, k: int = 10, *,
                          bucket_vecs=None, db=None, after=None):
    """The probe chain: query b's candidates are the slots of buckets
    ``probe[b, :]`` of ``bucket_ids`` (K, cap), ``-1`` dead, one probe
    step at a time with a carried running best.  Rows come from
    ``bucket_vecs`` (K, cap, d) by (bucket, slot) or from ``db`` (N, d) by
    entity id: exactly one of the two.

    With ``bucket_vecs`` each step is ``candidate_topk_ref`` (the served
    IVF local's loop); with ``db`` it is the reference's
    ``_probe_scan_brute`` step (the two-level brute bottom).  A bucket
    probed twice keeps both copies, as the reference does (the kernel
    emits the pair once).

    With ``after``: the union of every query's probed slots at once, a
    repeated pair kept once (the kernel's rule), bounded as the kernel's
    pass is."""
    if (bucket_vecs is None) == (db is None):
        raise ValueError("pass exactly one of bucket_vecs and db")
    q = queries.to(torch.float32)
    B = q.shape[0]
    if after is not None:
        p = probe.long()
        cand = bucket_ids[p].reshape(B, -1)                 # (B, np cap)
        if bucket_vecs is not None:
            vecs = bucket_vecs[p].reshape(B, cand.shape[1], -1)
        else:
            vecs = db[torch.clamp(cand, min=0).long()]
        d2 = torch.where(cand >= 0, batched_l2sq(vecs.to(torch.float32), q),
                         INF)
        return _after_topk(d2, cand, k, after, unique=True)
    best_d = q.new_full((B, k), INF)
    best_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for j in range(probe.shape[1]):
        bsel = probe[:, j].long()                          # (B,)
        cand = bucket_ids[bsel]                            # (B, cap)
        if bucket_vecs is not None:
            best_d, best_i = candidate_topk_ref(
                q, bucket_vecs[bsel], cand, k, best_d=best_d, best_i=best_i)
            continue
        vecs = db[torch.clamp(cand, min=0).long()]         # (B, cap, d)
        d2 = torch.where(cand >= 0, batched_l2sq(vecs, q), INF)
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, cand], dim=1)
        best_d, sel = stable_topk(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def bm25_dists_ref(q_terms, q_weights, terms, tf_sat):
    """(B, N) BM25 ranking distances (``-score``), reduced term slot
    first, then document slot.  Rows are taken in chunks that keep the
    match mask near ``_MASK_ELEMS``; no element depends on the chunk."""
    qt = q_terms.to(torch.int32)
    qw = q_weights.to(torch.float32)
    t = terms.to(torch.int32)
    f = tf_sat.to(torch.float32)
    b, n = qt.shape[0], t.shape[0]
    chunk = max(1, _MASK_ELEMS // max(1, b * t.shape[1]))
    score = torch.empty((b, n), dtype=torch.float32, device=qt.device)
    for r0 in range(0, n, chunk):
        tc, fc = t[r0:r0 + chunk], f[r0:r0 + chunk]
        sc = torch.zeros((b, tc.shape[0]), dtype=torch.float32,
                         device=qt.device)
        for slot in range(qt.shape[1]):
            s = qt[:, slot]                                     # (B,)
            m = (tc[None, :, :] == s[:, None, None]) & (
                s[:, None, None] >= 0)                          # (B, n, S)
            hit = torch.where(m, fc[None, :, :], 0.0).sum(-1)
            sc = sc + hit * qw[:, slot][:, None]
        score[:, r0:r0 + chunk] = sc
    return -score


def bm25_topk_ref(q_terms, q_weights, terms, tf_sat, k: int = 10, *,
                  valid=None, after=None):
    """The BM25 scan: (ranking dists = -score ascending, ids)."""
    dist = bm25_dists_ref(q_terms, q_weights, terms, tf_sat)
    return _scan_topk(_apply_valid(dist, valid), k, after)


def hybrid_topk_ref(queries, db, q_terms, q_weights, terms, tf_sat, alpha,
                    k: int = 10, *, valid=None, after=None):
    """The hybrid scan ``alpha * l2sq - (1 - alpha) * bm25``; ``alpha`` is
    a (1, 1) operand (a tensor on the queries' device, or a number)."""
    q = queries.to(torch.float32)
    x = db.to(torch.float32)
    d2 = pairwise_l2sq(q, x)
    score = -bm25_dists_ref(q_terms, q_weights, terms, tf_sat)
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=q.device).reshape(1, 1)
    dist = a * d2 - (1.0 - a) * score
    return _scan_topk(_apply_valid(dist, valid), k, after)


def pq_adc_scores_ref(lut, codes):
    """(B, N) ADC scores ``sum_m lut[b, m, codes[n, m]]``, summed in order
    ``m = 0..M-1`` from 0.0, one (B, N) gather per subspace."""
    lut = lut.to(torch.float32)
    c = codes.to(torch.int64)
    score = torch.zeros((lut.shape[0], c.shape[0]), dtype=torch.float32,
                        device=lut.device)
    for m in range(c.shape[1]):
        score = score + lut[:, m].index_select(1, c[:, m])
    return score


def pq_adc_topk_ref(lut, codes, k: int = 10, *, valid=None, after=None):
    """The PQ-ADC scan: (adc dists ascending, ids)."""
    return _scan_topk(_apply_valid(pq_adc_scores_ref(lut, codes), valid), k,
                      after)


def hamming_dists_ref(qcodes, codes):
    """(B, N) float32 Hamming distances between packed int32 codes; rows
    are taken in chunks that keep the (B, rows, W) XOR near
    ``_MASK_ELEMS``."""
    q = qcodes.to(torch.int32)
    c = codes.to(torch.int32)
    b, n, w = q.shape[0], c.shape[0], q.shape[1]
    chunk = max(1, _MASK_ELEMS // max(1, b * w))
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    for r0 in range(0, n, chunk):
        x = torch.bitwise_xor(q[:, None, :], c[None, r0:r0 + chunk, :])
        out[:, r0:r0 + chunk] = popcount32(x).sum(-1).to(torch.float32)
    return out


def hamming_topk_ref(qcodes, codes, k: int = 10, *, valid=None):
    """The Hamming scan: (dists ascending, ids); ties toward the lower id
    (a stable sort of the flat scan)."""
    return _finish(_apply_valid(hamming_dists_ref(qcodes, codes), valid), k)
