"""Checks of the kernels shared by ``tests/test_torch_gpu.py``,
``tests/test_torch_index_slice.py`` and ``chip_smoke.py``: the tables of
edge shapes, the operands each edge is drawn from, and the by-parts check
of a hybrid answer.

The edge shapes are those ``tests/test_kernels.py`` pins for the int8,
BM25 and hybrid kernels of the reference: B = 1, N not a multiple of the
row tile, k > N, all rows dead, about half the rows live, duplicate rows,
and two query tiles over several splits; each is drawn with slab rows of
distinct terms and with a repeated term, and query 0 holds only pad
terms (-1).

A hybrid distance is ``a * d2 - (1 - a) * score``.  At sift magnitudes
the fp32 rounding of ``d2`` (about one unit) is as large as the whole
BM25 term, so holding the sum to a tolerance cannot tell a right lexical
half from a missing one.  :func:`hybrid_by_parts` holds the halves
apart: the kernel's own ``d2`` of each returned pair comes from the fp32
L2 scan (the same tile code, so the same bits), its score from
:func:`lexical_scores_f32` (the kernels' float32 order), and the answer
must then equal ``a * d2 - (1 - a) * score`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.kernels import ops
from repro_torch.kernels.common import INF, merge_topk

__all__ = ["OPTION_EDGES", "EDGE_ALPHAS", "PQ_EDGES", "HAMMING_EDGES",
           "CHAIN_EDGES", "slab_rows", "option_edge_operands",
           "pq_edge_operands", "hamming_edge_operands",
           "chain_edge_operands", "chain_union_topk", "step_chain",
           "lexical_scores_f32", "hybrid_by_parts"]

# (name, B, N, d, k, rows): rows "dead" = every row dead, "half" = about
# half live, "dup" = the second half repeats the first; the BM25 lookup's
# edges: "head" = term 0 in every document and every query, "qrepeat" =
# each query repeats its first term in its second slot, "bigids" = term
# ids 2**31 - 1 - 64 v, all equal modulo 64 and up to the largest int32,
# "wide" = every query slot a distinct term of a 4,096-term vocabulary
# (a tile of 64 such queries holds more distinct terms than the kernel's
# 256 hit rows, so its block takes its queries in groups), each document
# holding one query term; "t64" = the same with T = 64 slots a query
# (bm25.MAX_T: the kernel's smallest group, four queries)
OPTION_EDGES = (
    ("B=1", 1, 100, 8, 5, None),
    ("N%tile!=0", 4, 300, 8, 5, None),
    ("k>N", 3, 6, 8, 10, None),
    ("all dead", 4, 50, 8, 5, "dead"),
    ("partial valid", 6, 120, 16, 7, "half"),
    ("duplicate rows", 5, 50, 8, 9, "dup"),
    ("two query tiles, splits", 70, 5000, 128, 32, "half"),
    ("head term everywhere", 6, 300, 128, 10, "head"),
    ("query repeats a term", 6, 300, 128, 10, "qrepeat"),
    ("colliding ids near 2^31", 6, 300, 128, 10, "bigids"),
    ("query tile past the dictionary", 70, 300, 128, 10, "wide"),
    ("64 term slots", 20, 300, 128, 10, "t64"),
)
# the hybrid's limits (0: the BM25 answer, 1: the fp32 L2 answer) and a
# blend between them
EDGE_ALPHAS = (0.0, 0.3, 1.0)
EDGE_VOCAB = 40
WIDE_VOCAB = 4096


# The PQ-ADC and Hamming kernels' edges: (name, B, N, M or W, k, rows),
# rows "dead" = every row dead, "half" = about half live, "ties" = every
# code row the same (so every distance ties and ids decide).  PQ covers
# k = 1, 10, 32, 33 and 64 (its list lengths' edges), Hamming k = 128 and
# 1,024 (the LSH shortlists), both k > N and a batch over several splits;
# PQ also lists filled by ties across its split boundaries and several
# query blocks at k = 64 with dead rows.
PQ_EDGES = (
    ("B=1 k=1", 1, 100, 8, 1, None),
    ("N%block!=0 k=10", 4, 300, 8, 10, None),
    ("k>N", 3, 6, 8, 10, None),
    ("all dead", 4, 50, 8, 5, "dead"),
    ("k=32 partial valid", 6, 400, 8, 32, "half"),
    ("k=33 partial valid", 6, 400, 8, 33, "half"),
    ("k=64", 5, 700, 8, 64, None),
    ("M=4", 3, 90, 4, 7, "half"),
    ("all-equal codes", 3, 80, 8, 32, "ties"),
    ("B=70 splits k=64", 70, 20000, 8, 64, "half"),
    ("ties across splits k=64", 3, 3000, 8, 64, "ties"),
    ("B=12 splits k=64 dead rows", 12, 2500, 8, 64, "half"),
)
HAMMING_EDGES = (
    ("B=1 k=1", 1, 100, 2, 1, None),
    ("N%block!=0 k=10", 4, 300, 2, 10, None),
    ("k>N", 3, 6, 2, 10, None),
    ("all dead", 4, 50, 3, 5, "dead"),
    ("partial valid k=33", 6, 400, 3, 33, "half"),
    ("W=1 k=64", 5, 700, 1, 64, None),
    ("k=128 partial valid", 3, 2000, 2, 128, "half"),
    ("k=1024", 2, 3000, 3, 1024, None),
    ("all-equal codes", 3, 80, 2, 32, "ties"),
    ("B=70 splits k=1024", 70, 50000, 3, 1024, "half"),
)


# The probe chain's edges (``bucket_probe_topk``): (name, B, nprobe, K,
# cap, d, k, slots).  slots "mid" = about a third of the slots dead,
# scattered through each bucket (as the filtered IVF masks them in place);
# "bucket" = bucket 0 all dead and probed by every query; "repeat" = every
# query probes one bucket twice.  They cover d = 96, 128 and d not a
# multiple of 4, k above the live candidates, B = 1 and 0, one probe (a
# single scan block a query), buckets wider than the kernel's 512-slot
# compaction round, and k = 1 and 32.
CHAIN_EDGES = (
    ("dead mid-bucket d=128", 6, 4, 12, 40, 128, 10, "mid"),
    ("all-dead bucket d=96", 5, 4, 10, 30, 96, 7, "bucket"),
    ("k>live d=13", 4, 2, 8, 6, 13, 32, "mid"),
    ("repeated probe", 4, 5, 10, 20, 32, 8, "repeat"),
    ("B=1", 1, 3, 6, 25, 16, 5, None),
    ("B=0", 0, 3, 6, 25, 16, 5, None),
    ("one probe", 7, 1, 5, 50, 8, 10, None),
    ("cap>512 d=96", 3, 3, 4, 1300, 96, 32, "mid"),
    ("k=1 d=128", 5, 6, 9, 33, 128, 1, "mid"),
)


def chain_edge_operands(case, seed: int = 0) -> dict:
    """numpy operands of one ``CHAIN_EDGES`` case: ``q`` (B, d), ``db``
    (N, d) with N = K cap, ``bucket_ids`` (K, cap) int32 (a permutation of
    the entity ids, ``-1`` where a slot is dead: disjoint buckets),
    ``bucket_vecs`` (K, cap, d) (the rows by slot, zeros in dead slots, as
    the served IVF places them), ``probe`` (B, nprobe) int32 and ``k``."""
    _, b, nprobe, K, cap, d, k, slots = case
    rng = np.random.default_rng([seed, b, nprobe, K, cap, d, k])
    n = K * cap
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    bids = rng.permutation(n).astype(np.int32).reshape(K, cap)
    if slots == "mid":
        bids[rng.random((K, cap)) < 1 / 3] = -1
    elif slots == "bucket":
        bids[0] = -1
    probe = np.array([rng.choice(K, nprobe, replace=False)
                      for _ in range(b)], np.int32).reshape(b, nprobe)
    if slots == "bucket":
        probe[:, 0] = 0
    elif slots == "repeat":
        probe[:, 1] = probe[:, 0]
    vecs = np.where((bids >= 0)[..., None], db[np.maximum(bids, 0)], 0.0)
    return {"q": q, "db": db, "bucket_ids": bids,
            "bucket_vecs": vecs.astype(np.float32), "probe": probe, "k": k}


def chain_union_topk(q, probe, bucket_ids, db, k: int):
    """The chain's answer under the kernels' rule, computed plainly: the
    k smallest (distance, id) pairs of the union of each query's probed
    buckets, a pair seen twice kept once (``common.merge_topk`` over every
    probed slot).  Distances are ``batched_l2sq``'s."""
    b = q.shape[0]
    cand = bucket_ids[probe.long()].reshape(
        b, probe.shape[1] * bucket_ids.shape[1])           # (B, np cap)
    vecs = db[torch.clamp(cand, min=0).long()]
    d2 = torch.where(cand >= 0, batched_l2sq(vecs, q), INF)
    sent_d = torch.full((b, k), INF, device=q.device)
    sent_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    d, i = merge_topk(sent_d, sent_i, d2, cand, k)
    return d, torch.where(torch.isinf(d), -1, i)


def step_chain(q, probe, bucket_ids, bucket_vecs, k: int):
    """The probe chain as ``nprobe`` calls of ``ops.candidate_topk_op``,
    one per probe step on its gathered (B, cap, d) tile, carrying the
    best: on the card ``nprobe`` launches of the per-step kernel (the
    chain entry must equal them bit for bit), on the CPU the plain loop
    of ``ref.bucket_probe_topk_ref``."""
    b = q.shape[0]
    best_d = torch.full((b, k), INF, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for j in range(probe.shape[1]):
        bsel = probe[:, j].long()
        best_d, best_i = ops.candidate_topk_op(
            q, bucket_vecs[bsel], bucket_ids[bsel], k, best_d=best_d,
            best_i=best_i)
    return best_d, best_i


def _edge_rows(rng, n: int, rows):
    if rows == "dead":
        return np.zeros(n, np.int32)
    if rows == "half":
        return (rng.random(n) > .5).astype(np.int32)
    return None


def pq_edge_operands(case, seed: int = 0):
    """numpy operands of one ``PQ_EDGES`` case: ``lut`` (B, M, 256)
    float32, ``codes`` (N, M) uint8, ``valid`` (N,) int32 or None, ``k``."""
    _, b, n, m, k, rows = case
    rng = np.random.default_rng([seed, b, n, m, k])
    lut = (rng.random((b, m, 256)) * 10).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    if rows == "ties":
        codes[:] = codes[0]
    return lut, codes, _edge_rows(rng, n, rows), k


def hamming_edge_operands(case, seed: int = 0):
    """numpy operands of one ``HAMMING_EDGES`` case: ``qcodes`` (B, W) and
    ``codes`` (N, W) int32 words, ``valid`` (N,) int32 or None, ``k``."""
    _, b, n, w, k, rows = case
    rng = np.random.default_rng([seed, b, n, w, k])
    q = rng.integers(-2**31, 2**31, size=(b, w)).astype(np.int32)
    codes = rng.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)
    if rows == "ties":
        codes[:] = codes[0]
    return q, codes, _edge_rows(rng, n, rows), k


def slab_rows(rng, n: int, s: int, vocab: int = EDGE_VOCAB,
              repeat: bool = False):
    """(terms, tf_sat) of ``n`` slab rows of up to ``s`` terms, -1 / 0
    padded: sorted distinct terms, or drawn with repetition."""
    terms = np.full((n, s), -1, np.int32)
    tf = np.zeros((n, s), np.float32)
    for r in range(n):
        m = int(rng.integers(0, s + 1))
        ids = rng.choice(vocab, size=m, replace=repeat)
        terms[r, :m] = ids if repeat else np.sort(ids)
        tf[r, :m] = rng.random(m) + 0.05
    return terms, tf


def option_edge_operands(case, repeat: bool, seed: int = 0) -> dict:
    """numpy operands of one ``OPTION_EDGES`` case: ``q`` (B, d), ``x``
    (N, d), ``valid`` (N,) int32 or None, slabs ``terms`` / ``tf`` (N, S),
    query terms ``qt`` / weights ``qw`` (B, T), and ``k``."""
    _, b, n, d, k, rows = case
    rng = np.random.default_rng([seed, b, n, d, int(repeat)])
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    valid = None
    if rows == "dead":
        valid = np.zeros(n, np.int32)
    elif rows == "half":
        valid = (rng.random(n) > .5).astype(np.int32)
    s, t = (16, 8) if d == 128 else (6, 4)
    if rows == "t64":
        t = 64
    terms, tf = slab_rows(rng, n, s, repeat=repeat)
    if rows == "dup":
        h = n - n // 2
        x[n // 2:], terms[n // 2:], tf[n // 2:] = x[:h], terms[:h], tf[:h]
    qt = rng.integers(0, EDGE_VOCAB, size=(b, t)).astype(np.int32)
    qt[0] = -1                                 # a query of pad terms only
    if rows == "head":
        for r in range(n):
            if not (terms[r] == 0).any():
                m = int((terms[r] >= 0).sum())
                slot = min(m, s - 1)
                terms[r, slot], tf[r, slot] = 0, rng.random() + 0.05
        qt[:, -1] = 0
    elif rows == "qrepeat":
        qt[1:, 1] = qt[1:, 0]
    elif rows in ("wide", "t64"):
        terms, tf = slab_rows(rng, n, s, vocab=WIDE_VOCAB, repeat=repeat)
        qt = rng.permutation(WIDE_VOCAB)[:b * t].reshape(b, t).astype(
            np.int32)
        qt[0] = -1
        for r in range(n):
            term = qt[1 + r % (b - 1), r % t]
            if not (terms[r] == term).any():
                terms[r, 0], tf[r, 0] = term, rng.random() + 0.05
    elif rows == "bigids":
        terms, qt = (np.where(a >= 0, 2**31 - 1 - 64 * a, a).astype(np.int32)
                     for a in (terms, qt))
    qw = (rng.random((b, t)) + 0.1).astype(np.float32)
    return {"q": q, "x": x, "valid": valid, "terms": terms, "tf": tf,
            "qt": qt, "qw": qw, "k": k}


def lexical_scores_f32(qt, qw, terms, tf) -> np.ndarray:
    """(P,) BM25 scores of P (query, document) pairs, row p pairing query
    operands ``qt[p]`` / ``qw[p]`` (T,) with slab row ``terms[p]`` /
    ``tf[p]`` (S,), in the kernels' float32 order (``csrc/lexical.cuh``):
    term slot t outer, document slot s inner, every add and multiply
    rounded once."""
    qt = np.asarray(qt, np.int32)
    qw = np.asarray(qw, np.float32)
    terms = np.asarray(terms, np.int32)
    tf = np.asarray(tf, np.float32)
    zero = np.float32(0.0)
    score = np.zeros(qt.shape[0], np.float32)
    for t in range(qt.shape[1]):
        term = qt[:, t]
        hit = np.zeros_like(score)
        for s in range(terms.shape[1]):
            hit = hit + np.where((terms[:, s] == term) & (term >= 0),
                                 tf[:, s], zero)
        score = score + hit * qw[:, t]
    return score


def hybrid_by_parts(q, x, qt, qw, terms, tf, alpha: float, kd, ki) -> dict:
    """Holds a hybrid answer (kd, ki) (B, k) to its two halves.

    For every returned pair (b, id): ``d2`` is the fp32 L2 scan's distance
    of row ``id`` for query ``b`` (one ``ops.l2_topk_op`` call per query
    over its returned rows: the kernel for CUDA tensors, the plain version
    for CPU ones) and ``score`` is :func:`lexical_scores_f32`.  Returns
    ``mismatches``, the pairs whose distance is not bitwise
    ``a * d2 - (1 - a) * score`` in float32; ``l2_max_rel_err``, the
    largest ``|d2 - d2_f64| / (qn + xn)``; ``lex_max_rel_err``, the
    largest ``|score - score_f64|`` over the float64 sum of the absolute
    score terms; and ``lex_bound``, the first-order bound of that error
    for float32 sums of S + T terms, ``(S + T) * 2**-24``."""
    kd_h = kd.cpu().numpy()
    ki_h = ki.cpu().numpy()
    fin = ki_h >= 0
    if not fin.any():
        return {"pairs": 0, "mismatches": 0, "l2_max_rel_err": 0.0,
                "lex_max_rel_err": 0.0, "lex_bound": 0.0}
    dev = x.device
    d2 = np.zeros(kd_h.shape, np.float32)
    for b in np.flatnonzero(fin.any(1)):
        live = np.flatnonzero(fin[b])
        rows = x[torch.as_tensor(ki_h[b, live].astype(np.int64), device=dev)]
        d, pos = ops.l2_topk_op(q[b:b + 1], rows, live.size)
        d2[b, live[pos[0].cpu().numpy()]] = d[0].cpu().numpy()
    bq, _ = np.nonzero(fin)
    ids = torch.as_tensor(ki_h[fin].astype(np.int64), device=dev)
    bqt = torch.as_tensor(bq.astype(np.int64), device=qt.device)
    pair_qt, pair_qw = qt[bqt].cpu().numpy(), qw[bqt].cpu().numpy()
    pair_t, pair_f = terms[ids].cpu().numpy(), tf[ids].cpu().numpy()
    score = lexical_scores_f32(pair_qt, pair_qw, pair_t, pair_f)

    a = np.float32(alpha)
    want = a * d2[fin] - (np.float32(1.0) - a) * score
    mismatches = int((want.view(np.int32)
                      != kd_h[fin].view(np.int32)).sum())

    qq = q[torch.as_tensor(bq.astype(np.int64), device=q.device)].double()
    xx = x[ids].double()
    d2_64 = ((qq - xx) ** 2).sum(-1).cpu().numpy()
    norms = ((qq * qq).sum(-1) + (xx * xx).sum(-1)).cpu().numpy()
    terms64 = ((pair_t[:, None, :] == pair_qt[:, :, None])
               & (pair_qt[:, :, None] >= 0)) * (
        pair_f.astype(np.float64)[:, None, :]
        * pair_qw.astype(np.float64)[:, :, None])
    score_64 = terms64.sum((1, 2))
    lex_abs = np.abs(terms64).sum((1, 2))
    return {
        "pairs": int(fin.sum()), "mismatches": mismatches,
        "l2_max_rel_err": float(np.max(np.abs(d2[fin] - d2_64) / norms)),
        "lex_max_rel_err": float(np.max(
            np.abs(score - score_64) / np.maximum(lex_abs, 1e-30))),
        "lex_bound": (terms.shape[1] + qt.shape[1]) * 2.0 ** -24,
    }
