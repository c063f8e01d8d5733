"""Checks of the kernels shared by ``tests/test_torch_gpu.py``, the CPU
tests and ``chip_smoke.py``: the tables of edge shapes, the operands each
edge is drawn from, the kernels' answers computed plainly, and the
by-parts check of a hybrid answer.

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

:func:`mips_parity` holds a maximum-inner-product answer served through
the two-level index (``models.recsys.mips_augment``) against the exact
top-k, near-ties rescored in float64; :func:`sasrec_mips_truth` gives it
SASRec's users, their exact top-k and the items.  :func:`message_dtypes`
records the dtype SchNet's message sums are taken in.
:func:`attention_at_true_fan_in` rescales an LM's attention projections
to the fan-in the CPU tests draw them at.  :data:`ATTN_EDGES` and
:data:`DECODE_EDGES` are the two attention kernels' edges, drawn by
:func:`attn_edge_operands` and :func:`decode_edge_operands` and held to
:data:`ATTN_TOL` of each output row's max by :func:`attn_row_err`.

:func:`shard_loop` computes a sharded search in one process -- every
shard's local with its own tables and its ``lin``, stacked and merged --
which a search over a mesh of ranks must equal bit for bit on the same
device: the collective only moves bytes.  Nothing on the main path calls
it.

:data:`MOVE_CASES` are moves of ``sharding.move`` (an exchange over one
mesh dim and over several, uneven and empty chunks, partial values
reduced and cut); :func:`run_move_cases` runs them on one rank of a
world of four, on a ``(2, 2)`` and a ``(1, 2, 2)`` mesh, each against
:func:`cut_as_dtensor` of the whole value (what gathering it whole and
cutting it gives), with the collectives each move issued beside the
ones the reference's lowering issues.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.kernels import ops
from repro_torch.kernels.common import INF, merge_topk

__all__ = ["OPTION_EDGES", "EDGE_ALPHAS", "PQ_EDGES", "HAMMING_EDGES",
           "CHAIN_EDGES", "ROWS_EDGES", "slab_rows", "option_edge_operands",
           "pq_edge_operands", "hamming_edge_operands",
           "chain_edge_operands", "chain_union_topk", "step_chain",
           "rows_edge_operands", "rows_union_topk", "DESCENT_EDGES",
           "descent_edge_operands", "LSH_PROBE_EDGES",
           "lsh_probe_edge_operands", "SKETCH_EDGES", "SKETCH_BIG_IDS",
           "sketch_edge_steps",
           "lexical_scores_f32", "hybrid_by_parts", "shard_backends",
           "shard_loop", "mips_parity", "sasrec_mips_truth",
           "message_dtypes", "attention_at_true_fan_in", "MOVE_CASES",
           "MOVE_MESHES", "placements_of", "cut_as_dtensor",
           "run_move_cases", "ATTN_EDGES", "DECODE_EDGES", "ATTN_TOL",
           "attn_edge_operands", "decode_edge_operands", "attn_row_err"]

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
    cand = bucket_ids[probe.long()].reshape(
        q.shape[0], probe.shape[1] * bucket_ids.shape[1])  # (B, np cap)
    return rows_union_topk(q, db, cand, k)


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


# (name, B, N, d, C, k, ids) of the tile read by row id
# (``candidate_rows_topk``): ids "dead" = about a third -1, "repeat" = the
# second half of each query's list repeats the first, "oob" = some ids at
# or past N (dead slots too), "none" = every id dead (-1 or past N), None
# = all live and distinct.  On the card a query's C slots are split over
# a cluster of up to 8 blocks (``bucket_topk.cluster_for``: segments of at
# least 64 slots, 8 at these B, 1 at B 1,024); a d that is a multiple of 4
# up to 256 stages its rows through shared memory, a larger one reads
# float4s, any other d scalars.
ROWS_EDGES = (
    ("dead ids d=128", 5, 300, 128, 200, 10, "dead"),
    ("repeated ids d=32", 4, 100, 32, 60, 8, "repeat"),
    ("d=13", 3, 80, 13, 40, 7, "dead"),
    ("C<k", 4, 50, 16, 6, 10, None),
    ("ids out of range", 3, 40, 8, 30, 5, "oob"),
    ("B=1 k=1", 1, 64, 16, 64, 1, None),
    ("many segments d=96", 6, 5000, 96, 2048, 32, "dead"),
    ("B=0", 0, 10, 8, 4, 3, None),
    ("B=1 C=2048 d=128", 1, 4000, 128, 2048, 10, "dead"),
    ("B=5 C=1000 d=64", 5, 3000, 64, 1000, 10, "dead"),
    ("C=40 in one short segment", 3, 200, 16, 40, 10, "dead"),
    ("C=700 in uneven segments", 4, 2000, 32, 700, 12, None),
    ("every id dead", 3, 400, 16, 300, 10, "none"),
    ("repeats across a cluster's blocks", 3, 2000, 32, 1024, 10, "repeat"),
    ("d=2", 4, 500, 2, 256, 32, "dead"),
    ("d=6", 4, 500, 6, 300, 10, "dead"),
    ("d=256 the widest ring", 3, 600, 256, 500, 10, "dead"),
    ("d=260 float4 loads", 3, 600, 260, 500, 10, "dead"),
    ("B=1024 C=2048", 1024, 20000, 8, 2048, 10, "dead"),
)


def rows_edge_operands(case, seed: int = 0) -> dict:
    """numpy operands of one ``ROWS_EDGES`` case: ``q`` (B, d), ``rows``
    (N, d), ``ids`` (B, C) int32 and ``k``.  Ids are distinct within a
    query's list except where the case repeats them."""
    _, b, n, d, c, k, kind = case
    rng = np.random.default_rng([seed, b, n, d, c, k])
    rows = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = np.array([rng.choice(n, c, replace=False) for _ in range(b)],
                   np.int32).reshape(b, c)
    if kind == "dead":
        ids[rng.random((b, c)) < 1 / 3] = -1
    elif kind == "repeat":
        h = c // 2
        ids[:, h:2 * h] = ids[:, :h]
    elif kind == "oob":
        ids[:, ::3] = n + rng.integers(0, 5, size=ids[:, ::3].shape)
    elif kind == "none":
        ids[:] = -1
        ids[:, ::2] = n + rng.integers(0, 5, size=ids[:, ::2].shape)
    return {"q": q, "rows": rows, "ids": ids, "k": k}


def rows_union_topk(q, rows, ids, k: int):
    """The tile-by-id answer under the kernels' rule, computed plainly: the
    k smallest (distance, id) pairs of each query's live ids, a pair seen
    twice kept once (``common.merge_topk``).  Distances are
    ``batched_l2sq``'s."""
    b = q.shape[0]
    ids = torch.where((ids >= 0) & (ids < rows.shape[0]), ids, -1)
    vecs = rows[torch.clamp(ids, min=0).long()]
    d2 = torch.where(ids >= 0, batched_l2sq(vecs, q), INF)
    sent_d = torch.full((b, k), INF, device=q.device)
    sent_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    d, i = merge_topk(sent_d, sent_i, d2, ids.to(torch.int32), k)
    return d, torch.where(torch.isinf(d), -1, i)


# (name, tree, B, N, d, leaf, W, steps, roots): the tree descent's edges.
# tree "rp" (the balanced SPPT), "qlbt" (Alg. 1 under a skewed likelihood)
# or "kd" (coordinate splits); steps None = the tree's max depth + 4 (every
# beam bottoms out first), an int = that many (rows still active when they
# stop); roots True = every other row starts at the root's right child (a
# forest's per-row start nodes).  "dead slots": more beam slots than the
# tree has leaves; "one leaf": the root is a leaf; "kd W=128": 2W = 256,
# the kd top's beam at nprobe 64; W 32 and 33 either side of the kernel's
# switch from a warp a row to a block a row.
DESCENT_EDGES = (
    ("rp W=1", "rp", 12, 600, 16, 8, 1, None, False),
    ("rp W=6 roots", "rp", 12, 900, 16, 8, 6, None, True),
    ("qlbt W=8", "qlbt", 12, 900, 24, 8, 8, None, False),
    ("qlbt W=3 d=13 roots", "qlbt", 9, 500, 13, 4, 3, None, True),
    ("kd W=16 d=3", "kd", 12, 700, 3, 4, 16, None, False),
    ("kd W=128 d=2 roots", "kd", 12, 2000, 2, 4, 128, None, True),
    ("rp W=32 dead slots", "rp", 12, 120, 8, 8, 32, None, False),
    ("rp W=8 steps=3", "rp", 12, 900, 16, 8, 8, 3, False),
    ("qlbt W=8 steps=6 roots", "qlbt", 12, 900, 16, 8, 8, 6, True),
    ("rp steps=0", "rp", 4, 200, 8, 8, 4, 0, False),
    ("one leaf", "rp", 5, 6, 8, 8, 4, None, False),
    ("B=1 W=24 d=130", "rp", 1, 1500, 130, 8, 24, None, False),
    ("qlbt W=17 roots", "qlbt", 9, 900, 20, 4, 17, None, True),
    ("rp W=33 roots", "rp", 9, 900, 16, 8, 33, None, True),
    ("kd W=33 steps=5", "kd", 9, 900, 3, 4, 33, 5, False),
)


def descent_edge_operands(case, seed: int = 0) -> dict:
    """numpy operands of one ``DESCENT_EDGES`` case: the port's ``tree``
    (a ``FlatTree``, built by the builders the reference's equal), ``db``
    (N, d), ``q`` (B, d) near the corpus, ``roots`` (B,) int32 or None and
    the keywords ``kind``, ``beam_width`` and ``max_steps``."""
    from repro_torch.core.tree import build_kd_tree, build_qlbt, build_rp_tree

    _, tree, b, n, d, leaf, w, steps, roots = case
    rng = np.random.default_rng([seed, b, n, d, leaf, w])
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = (db[rng.integers(0, n, b)]
         + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
    if tree == "kd":
        t = build_kd_tree(db, leaf_size=leaf)
    elif tree == "qlbt":
        t = build_qlbt(db, rng.beta(0.3, 8.0, size=n), leaf_size=leaf,
                       n_candidates=4, seed=1)
    else:
        t = build_rp_tree(db, leaf_size=leaf, n_candidates=4, seed=1)
    r = None
    if roots:
        r = np.where(np.arange(b) % 2 == 0, 0,
                     max(int(t.children[0, 1]), 0)).astype(np.int32)
    return {"tree": t, "db": db, "q": q, "roots": r,
            "kw": {"kind": t.kind, "beam_width": w,
                   "max_steps": t.max_depth + 4 if steps is None else steps}}


# The LSH bottom's probe scan (``lsh_probe``): (name, B, N, n_bits, K, cap,
# P, S, kind).  Codes are the sign bits of an 8-dimensional corpus, so a
# few hundred rows tie by the dozen at every distance; each bucket holds
# a random number of ids in its first columns (repeats across buckets
# allowed), the rest -1.  kind "repeat": every query probes one bucket
# twice and query 0 probes one bucket P times; "empty": every other
# bucket empty, and every bucket query 0 probes; "all empty": every
# bucket empty (no query has a live slot: the whole shortlist -1);
# "holes": a -1 inside every row of two or more ids, before its last live
# id; "short": every row ends before its last column; "sparse": at most
# three ids a row, fewer live slots than S; "full": every row full;
# "mutated": the bucket table, codes and projections of a small
# LSH-bottom index after ``delete_entities`` and ``add_entities``.  They
# cover 32, 40 and 64 bits (W 1-2), every W up to 8 (1, 96, 200 and 256
# bits), S = 1, below 32, not a multiple of 32 and = P cap, P above the
# rows the kernel stages at once (``lsh_probe.PSTAGE`` = 1,024), and the
# kernel's two emit paths (``lsh_probe.path_of``): the distances kept in
# shared memory (most cases), and the recompute path, where a query's
# distances exceed the store (about 51,200 live slots a query at W = 2;
# 25,600 at W = 8, two bytes a slot), also with P above the staged rows
# (about 70,400 live slots a query at W = 2 and 35,200 at W = 8 against
# a 24 KB store: the chunked recompute).
LSH_PROBE_EDGES = (
    ("32 bits", 6, 300, 32, 12, 40, 4, 64, None),
    ("64 bits", 6, 400, 64, 16, 40, 5, 100, None),
    ("40 bits", 5, 300, 40, 10, 48, 4, 50, None),
    ("repeated bucket", 5, 300, 64, 10, 40, 6, 120, "repeat"),
    ("S=1", 4, 300, 64, 10, 40, 4, 1, None),
    ("S=7", 4, 300, 64, 10, 40, 4, 7, None),
    ("S=45", 4, 300, 64, 10, 40, 4, 45, None),
    ("S=P cap", 4, 300, 64, 10, 40, 4, 160, None),
    ("empty buckets", 5, 200, 64, 12, 40, 5, 64, "empty"),
    ("after delete and add", 6, 400, 64, 8, 0, 4, 48, "mutated"),
    ("1 bit", 3, 200, 1, 6, 30, 3, 20, None),
    ("96 bits", 4, 300, 96, 10, 40, 4, 64, None),
    ("200 bits", 4, 300, 200, 10, 40, 4, 64, None),
    ("256 bits", 4, 300, 256, 10, 40, 4, 64, None),
    ("recompute W=2", 2, 300, 64, 200, 800, 128, 256, None),
    ("recompute W=8", 2, 300, 256, 100, 800, 64, 256, None),
    ("holes inside the extents", 5, 300, 64, 12, 40, 6, 90, "holes"),
    ("every probed row empty", 4, 300, 64, 10, 40, 4, 32, "all empty"),
    ("fewer live slots than S", 4, 300, 64, 10, 40, 5, 150, "sparse"),
    ("P 1100 above the staged rows", 2, 300, 64, 40, 8, 1100, 64, None),
    ("every row short of cap", 5, 300, 64, 12, 40, 5, 64, "short"),
    ("full rows", 2, 300, 64, 40, 300, 40, 128, "full"),
    ("P 1100 recompute W=2", 2, 300, 64, 40, 128, 1100, 64, None),
    ("P 1100 recompute W=8", 2, 300, 256, 40, 64, 1100, 64, None),
)


def lsh_probe_edge_operands(case, seed: int = 0) -> dict:
    """numpy operands of one ``LSH_PROBE_EDGES`` case: queries ``q`` (B,
    8) near the corpus, ``proj`` (8, n_bits), ``codes`` (N', W) int32,
    ``bucket_ids`` (K, cap') int32 with -1 pads, ``extents`` (K,) int32
    (one past each row's last live column, exact for any table), ``probe``
    (B, P) int32 and ``shortlist``; a "mutated" case takes N', K and cap'
    from its index (cap 0 in the table)."""
    from repro_torch.core.lsh import pack_bits

    _, b, n, bits, k, cap, p, s, kind = case
    rng = np.random.default_rng([seed, b, n, bits, k, cap, p, s])
    x = rng.normal(size=(n, 8)).astype(np.float32)
    q = (x[rng.integers(0, n, b)]
         + 0.3 * rng.normal(size=(b, 8))).astype(np.float32)
    if kind == "mutated":
        from repro_torch.core.two_level import TwoLevelConfig, build_two_level

        idx = build_two_level(x, TwoLevelConfig(
            n_clusters=k, top="brute", bottom="lsh", lsh_bits=bits,
            kmeans_iters=2, kmeans_minibatch=None, seed=1), device="cpu")
        idx.delete_entities(rng.choice(n, n // 4, replace=False))
        idx.add_entities((x[rng.integers(0, n, n // 8)] + 0.1 * rng.normal(
            size=(n // 8, 8))).astype(np.float32))
        proj = idx.bottom_lsh.proj
        codes, bids = idx.bottom_lsh.codes, idx.bucket_ids
        probe = rng.integers(0, bids.shape[0], (b, p)).astype(np.int32)
    else:
        proj = rng.normal(size=(8, bits)).astype(np.float32)
        codes = pack_bits((x @ proj > 0).astype(np.uint8))
        fill = rng.integers(0, cap + 1, k)
        if kind == "empty":
            fill[::2] = 0
        elif kind == "all empty":
            fill[:] = 0
        elif kind == "short":
            fill = np.minimum(fill, cap - 1 - rng.integers(0, 3, k))
        elif kind == "sparse":
            fill = rng.integers(0, 4, k)
        elif kind == "full":
            fill[:] = cap
        bids = np.full((k, cap), -1, np.int32)
        for r in range(k):
            bids[r, :fill[r]] = rng.integers(0, n, fill[r])
        if kind == "holes":
            for r in np.flatnonzero(fill >= 2):
                bids[r, rng.integers(0, fill[r] - 1)] = -1
        probe = rng.integers(0, k, (b, p)).astype(np.int32)
        if kind == "repeat":
            probe[:, -1] = probe[:, 0]
            probe[0, :] = probe[0, 0]
        elif kind == "empty":
            probe[0, :] = 2 * rng.integers(0, (k + 1) // 2, p)
    live = bids >= 0
    extents = np.where(live.any(1), bids.shape[1] - np.argmax(
        live[:, ::-1], axis=1), 0).astype(np.int32)
    return {"q": q, "proj": np.ascontiguousarray(proj, np.float32),
            "codes": np.ascontiguousarray(codes, np.int32),
            "bucket_ids": np.ascontiguousarray(bids, np.int32),
            "extents": extents, "probe": probe, "shortlist": s}


# (name, width, depth, topk, halflife, sizes, ids, weighted): one sketch
# updated with a batch of each real size in ``sizes`` (padded to a power of
# two by ``CountMinSketch.prepare``: 256 and below pass by value to the
# kernel, above it through one staged copy); ids "zipf" (Zipf 1.1 over 300
# ids: repeats), "one" (every id 7), "invalid" (about a third -1 or
# another negative), "big" (about half of them ``SKETCH_BIG_IDS``: their
# low 32 bits as an int32 decide, ROADMAP fault 28); weighted: weights in
# [0, 3), else unit weights.  The served sizes are 1 (a cache hit) and up
# to 64 (a batch) at width 4,096, depth 4, topk 64.
# "a slice ..." sizes the table about one copy block's slice of
# ``count_min.SLICE`` = 1,024 cells, and two.
SKETCH_EDGES = (
    ("m=1 x20", 4096, 4, 64, 4096.0, (1,) * 20, "zipf", False),
    ("m=1 x20 weighted", 4096, 4, 64, 4096.0, (1,) * 20, "zipf", True),
    ("m=2", 4096, 4, 64, 4096.0, (2, 2, 1, 2), "zipf", True),
    ("served sizes", 4096, 4, 64, 4096.0, (64, 33, 1, 64, 17), "zipf",
     False),
    ("served sizes, no decay", 4096, 4, 64, None, (64, 33, 1, 64, 17),
     "zipf", True),
    ("200 copies of one id", 512, 4, 16, 200.0, (200, 200, 1), "one",
     False),
    ("200 copies, weighted", 512, 4, 16, 200.0, (200, 200), "one", True),
    ("invalid ids", 512, 4, 16, 300.0, (17, 64, 100, 1), "invalid", True),
    ("ids at and above 2^31", 1024, 4, 16, None, (5, 64, 300), "big",
     False),
    ("ids at and above 2^31, weighted", 1024, 4, 16, 100.0, (7, 64, 1),
     "big", True),
    ("20 batches of 17-150", 512, 4, 16, 200.0,
     tuple(17 + 7 * t for t in range(20)), "zipf", True),
    ("width 65536 depth 8", 65536, 8, 64, 4096.0, (64, 1, 512), "zipf",
     True),
    ("m=4096 depth 8", 512, 8, 32, 1000.0, (4096, 3000), "zipf", False),
    ("topk above the candidates", 256, 2, 128, 50.0, (3, 5), "zipf",
     False),
    ("width 2", 2, 3, 8, 10.0, (9, 9), "zipf", True),
    ("width 1", 1, 2, 4, 10.0, (5, 3), "zipf", True),
    ("a slice less a row", 2, 511, 16, 100.0, (64, 1, 300), "zipf", True),
    ("a slice", 1024, 1, 16, 100.0, (64, 1), "zipf", True),
    ("a slice and a row", 2, 513, 16, 100.0, (64, 1, 300), "zipf", True),
    ("a slice and a cell", 1, 1025, 8, 100.0, (17, 1), "zipf", False),
    ("two slices and a row", 4, 513, 16, 100.0, (64, 33), "invalid",
     True),
)
SKETCH_BIG_IDS = np.array([2**31 - 1, 2**31, 2**31 + 5, 2**32 + 3, 2**33,
                           2**32 - 1, -2**32 + 5, 2**31 + 5], np.int64)


def sketch_edge_steps(case, seed: int = 0) -> dict:
    """One ``SKETCH_EDGES`` case: the sketch's keywords (``kw``), its real
    batches (``batches``: (ids int64, weights or None)) and the same
    batches as ``CountMinSketch.prepare`` hands them to the update op
    (``steps``: ``SketchBatch`` of padded ids and weights, decay and
    weight sum)."""
    from repro_torch.adaptive.sketch import CountMinSketch

    _, width, depth, topk, halflife, sizes, kind, weighted = case
    kw = dict(width=width, depth=depth, topk=topk, halflife=halflife)
    rng = np.random.default_rng([seed, width, depth, topk, len(sizes)])
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    batches = []
    for m in sizes:
        ids = rng.choice(300, m, p=p).astype(np.int64)
        if kind == "one":
            ids[:] = 7
        elif kind == "invalid":
            dead = rng.random(m) < 1 / 3
            ids[dead] = np.where(rng.random(int(dead.sum())) < 0.5, -1,
                                 -ids[dead] - 2)
        elif kind == "big":
            pick = rng.random(m) < 0.5
            ids[pick] = rng.choice(SKETCH_BIG_IDS, int(pick.sum()))
        w = rng.random(m).astype(np.float32) * 3 if weighted else None
        batches.append((ids, w))
    plan = CountMinSketch(device="cpu", **kw)
    return {"kw": kw, "batches": batches,
            "steps": [plan.prepare(i, w) for i, w in batches]}


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


def shard_backends(target, n_dev: int, **kw) -> list:
    """One ``ShardedSearchBackend`` a shard of an ``n_dev``-shard layout,
    all in this process and with no collective (``kw`` as the backend's:
    ``kind``, ``k``, ``device``, ...)."""
    from repro_torch.distributed.backend import ShardedSearchBackend
    from repro_torch.distributed.sharding import ShardSlot

    return [ShardedSearchBackend(target, shard=ShardSlot(n_dev=n_dev,
                                                         lin=lin), **kw)
            for lin in range(n_dev)]


def shard_loop(backends, queries=None, *, n_q: int = 1, filter_spec=None,
               mode: str = "semantic", alpha: float = 0.5, q_terms=None,
               q_weights=None):
    """The sharded search of ``backends`` (``shard_backends``, in shard
    order) in one process: the batch padded to ``n_q`` query blocks, each
    block through every shard's local, the (S, b, k) stack merged by
    ``_merge_gathered``, the blocks joined.  Returns numpy (B, k), as a
    mesh's ranks do."""
    from repro_torch.distributed.sharding import _merge_gathered

    if filter_spec is not None and filter_spec.empty:
        filter_spec = None
    be0 = backends[0]
    ops_, B = be0._operands(queries, q_terms, q_weights, mode, n_q)
    ops_ = tuple(be0._put(o) for o in ops_)
    calls = [be._local(filter_spec, mode, alpha) for be in backends]
    bq = ops_[0].shape[0] // n_q
    ds, ids = [], []
    for j in range(n_q):
        block = tuple(o[j * bq:(j + 1) * bq] for o in ops_)
        parts = [call(*block) for call in calls]
        d, i = _merge_gathered(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]), be0.k)
        ds.append(d)
        ids.append(i)
    return (torch.cat(ds)[:B].cpu().numpy(),
            torch.cat(ids)[:B].cpu().numpy())


def mips_parity(ann_ids, exact_ids, users, items, m2: float) -> dict:
    """A maximum-inner-product answer through the two-level index (L2 over
    ``recsys.mips_augment``'s rows) against the exact top-k by score.
    ``match`` is the share of (query, slot) pairs with the same id; every
    other slot must be a near-tie: the float64 scores of its two ids within
    1e-5 * (||u||^2 + M^2), the fp32 rounding of the augmented L2
    distance.  ``bad`` counts the slots that are neither, ``repeats`` the
    ids an answer holds twice."""
    ann_ids, exact_ids = np.asarray(ann_ids), np.asarray(exact_ids)
    u = np.asarray(users, np.float64)
    items = np.asarray(items)
    diff = ann_ids != exact_ids
    bad, worst = 0, 0.0
    for b, j in zip(*np.nonzero(diff)):
        s_ann = float(u[b] @ items[ann_ids[b, j]].astype(np.float64)) \
            if ann_ids[b, j] >= 0 else -np.inf
        s_ex = float(u[b] @ items[exact_ids[b, j]].astype(np.float64))
        gap = abs(s_ann - s_ex)
        worst = max(worst, gap)
        if not gap <= 1e-5 * (float(u[b] @ u[b]) + m2):
            bad += 1
    repeats = sum(len(r) - len(set(r.tolist())) for r in ann_ids)
    return {"match": float((~diff).mean()), "near_ties": int(diff.sum())
            - bad, "bad": bad, "max_gap": worst, "repeats": int(repeats)}


def sasrec_mips_truth(params, seq, cfg, k: int = 10) -> tuple:
    """SASRec's retrieval as the index sees it: the users' vectors
    (``recsys.user_vectors``, (B, D)), each user's exact top-``k`` over
    every item by ``retrieval_logits`` (one user a call, as it serves;
    (B, k)) and the item rows (N, D), all numpy on the host."""
    from repro_torch.models import recsys

    cand = np.arange(cfg.n_items, dtype=np.int32)
    users = recsys.user_vectors(params, seq, cfg).cpu().numpy()
    exact = np.stack([recsys.retrieval_logits(
        params, {"seq": seq[b:b + 1], "candidates": cand}, cfg,
        k=k)[1].cpu().numpy() for b in range(seq.shape[0])])
    items = params["item_table"][:cfg.n_items].cpu().numpy()
    return users, exact, items


@contextlib.contextmanager
def message_dtypes():
    """Within the block, the dtype of every sum ``models.schnet`` takes
    with its ``_segment_sum`` (the interactions' message aggregates, then
    the energy head's pool), in call order."""
    from repro_torch.models import schnet

    seen, orig = [], schnet._segment_sum

    def spy(x, seg, n):
        seen.append(x.dtype)
        return orig(x, seg, n)

    schnet._segment_sum = spy
    try:
        yield seen
    finally:
        schnet._segment_sum = orig


def attention_at_true_fan_in(params: dict, cfg) -> dict:
    """A GQA LM's ``w_q`` / ``w_k`` / ``w_v`` / ``w_o`` (a parameter tree
    of ``models.transformer``, plain tensors or DTensors) rescaled in
    place from ``init``'s fan-in to their true one (``d_model``; heads x
    head width for ``w_o``), as the CPU tests draw them.  ``init`` (the
    reference's rule) reads a weight's fan-in from its second-to-last
    dim: the heads of ``w_q`` (L, d, heads, width), the head width of
    ``w_o``.  Without qk-norm (granite-34b) the first attention is then a
    hard max at init, its scores' std near the head width, and two fp32
    summation orders of one step pick other keys (ROADMAP fault 27;
    ``tools/fan_in_conditioning_torch.py``).  Elementwise, so a sharded
    tree scales each rank's own shards."""
    from repro_torch.distributed.sharding import local

    fan = {"w_q": cfg.d_model, "w_k": cfg.d_model, "w_v": cfg.d_model,
           "w_o": cfg.n_heads * cfg.d_head}
    with torch.no_grad():
        for stack in ("dense_layers", "moe_layers"):
            for k, f in fan.items():
                if stack in params:
                    w = params[stack][k]
                    local(w).mul_((w.shape[-2] / f) ** 0.5)
    return params


# ---------------------------------------------------------------------------
# moves over a mesh of four ranks
# ---------------------------------------------------------------------------

# mesh name -> (shape, dim names): a pod dim of one rank on the second
MOVE_MESHES = {"2x2": ((2, 2), ("data", "model")),
               "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}

# (name, mesh, global shape, have, want, the collectives the forward
# issues, whether the backward is run too).  Placements are written
# "S<d>" (Shard), "R" (Replicate), "P" / "Pmax" (Partial sum / max).
# The MoE's expert exchange is ("dp", "tp") -> ("pp", "ep"): on the
# single-pod plan "S0,S1" -> "S1,S1", on the multi-pod one "S0,S0,S1" ->
# "S0,S1,S1" (its experts over the data and model dims of a pod) and, a
# model's experts spread over the pods too, "S0,S0,S1" -> "S1,S1,S1".
MOVE_CASES = (
    ("shard to shard", "2x2", (8, 12), "S0,R", "S1,R",
     ("all_to_all",), True),
    ("shard to shard on model", "2x2", (6, 8, 4), "S0,S2", "S0,S1",
     ("all_to_all",), False),
    ("moe exchange", "2x2", (4, 8, 3, 5), "S0,S1", "S1,S1",
     ("all_to_all",), True),
    ("moe exchange back", "2x2", (4, 8, 3, 5), "S1,S1", "S0,S1",
     ("all_to_all",), False),
    ("moe exchange in a pod", "1x2x2", (4, 8, 3, 5), "S0,S0,S1",
     "S0,S1,S1", ("all_to_all",), True),
    ("moe exchange over pods", "1x2x2", (4, 8, 3, 5), "S0,S0,S1",
     "S1,S1,S1", ("all_to_all",), False),
    ("uneven", "2x2", (5, 7, 3), "S0,S1", "S1,S1", ("all_to_all",), True),
    ("uneven on one dim", "2x2", (7, 5), "S0,R", "S1,R",
     ("all_to_all",), False),
    ("empty chunks", "2x2", (3, 1, 2), "S1,S0", "S0,S0",
     ("all_to_all",), True),
    ("empty chunks, a replicated dim joining", "2x2", (2, 6), "R,S1",
     "S0,S0", ("all_to_all",), False),
    ("partial sum to shard", "2x2", (8, 6), "S0,P", "S0,S1",
     ("reduce_scatter",), True),
    ("partial max to shard", "2x2", (8, 6), "S0,Pmax", "S0,S1",
     ("reduce_scatter",), False),
    ("partial max to shard, uneven", "2x2", (5, 6), "S1,Pmax", "S1,S0",
     ("reduce_scatter",), False),
    ("partial on both to shard", "2x2", (8, 6), "P,P", "S0,R",
     ("all_reduce", "reduce_scatter"), False),
    ("partial on both to one shard", "2x2", (8, 6), "P,P", "S0,S0",
     ("reduce_scatter",), False),
    ("partial on both to one shard, uneven", "2x2", (5, 3), "P,P",
     "S0,S0", ("reduce_scatter",), False),
    ("partial to shard in a pod", "1x2x2", (8, 6), "R,P,S0", "R,S1,S0",
     ("reduce_scatter",), True),
)


def placements_of(spec: str) -> tuple:
    """"S0,R,Pmax" -> (Shard(0), Replicate(), Partial("max"))."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for q in spec.split(","):
        if q == "R":
            out.append(Replicate())
        elif q.startswith("P"):
            out.append(Partial(q[1:] or "sum"))
        else:
            out.append(Shard(int(q[1:])))
    return tuple(out)


def cut_as_dtensor(full, sizes, coord, placements):
    """The block of ``full`` that the rank at mesh coordinate ``coord``
    holds under ``placements`` (a partial dim holds the whole): cut by
    ``torch.chunk`` along each sharded mesh dim, first mesh dim first,
    the chunks ``torch.chunk`` does not make empty, as DTensor cuts."""
    from torch.distributed.tensor import Shard

    t = full
    for m, q in enumerate(placements):
        if isinstance(q, Shard):
            pieces = list(torch.chunk(t, sizes[m], dim=q.dim))
            pieces += [t.narrow(q.dim, 0, 0)] * (sizes[m] - len(pieces))
            t = pieces[coord[m]]
    return t.contiguous()


def _move_parts(case_i: int, shape, sizes, have) -> dict:
    """The whole value's parts: one a coordinate of the partial mesh
    dims (one part, ``()``, with none), integer-valued fp32 so that any
    sum order is exact."""
    from torch.distributed.tensor import Partial

    pdims = [m for m, q in enumerate(have) if isinstance(q, Partial)]
    parts = {}
    for at in np.ndindex(*[sizes[m] for m in pdims]):
        g = torch.Generator().manual_seed(1000 * case_i + len(parts))
        parts[at] = torch.randint(-64, 64, shape, generator=g).float()
    return pdims, parts


def run_move_cases(meshes: dict, device) -> list:
    """Every case of :data:`MOVE_CASES` on this rank, each mesh of
    ``meshes`` ({name: DeviceMesh}) made on every rank beforehand:
    ``[{name, out, oracle, placements_ok, bytes, counts, routes,
    expected_bytes, grad, grad_oracle, grad_bytes, grad_counts}]``,
    tensors on the host."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed import sharding

    out = []
    for i, (name, mesh_name, shape, have_s, want_s, kinds,
            backward) in enumerate(MOVE_CASES):
        mesh = meshes[mesh_name]
        sizes = tuple(mesh.mesh.shape)
        coord = tuple(mesh.get_coordinate())
        have, want = placements_of(have_s), placements_of(want_s)
        pdims, parts = _move_parts(i, shape, sizes, have)
        stack = torch.stack(list(parts.values()))
        full = stack.amax(0) if pdims and have[pdims[0]].reduce_op == "max" \
            else stack.sum(0)
        mine = parts[tuple(coord[m] for m in pdims)]
        loc = cut_as_dtensor(mine, sizes, coord, have).to(device)
        x = DTensor.from_local(loc, mesh, have, run_check=False,
                               shape=torch.Size(shape),
                               stride=full.stride())
        if backward:
            x = x.detach().requires_grad_()
        for c in (sharding.COLLECTIVE_BYTES, sharding.COLLECTIVE_COUNTS,
                  sharding.MOVE_ROUTES):
            c.clear()
        y = sharding.move(x, want)
        rec = {"name": name, "out": y.to_local().detach().cpu(),
               "oracle": cut_as_dtensor(full, sizes, coord, want),
               "placements_ok": tuple(y.placements) == want,
               "bytes": dict(sharding.COLLECTIVE_BYTES),
               "counts": dict(sharding.COLLECTIVE_COUNTS),
               "routes": dict(sharding.MOVE_ROUTES)}
        # the reference's rule: a collective's result bytes, an
        # all-reduce's twice (it runs last, on the block kept); a
        # reduce-scatter's result is the largest member's chunk
        exp = {}
        for kind in kinds:
            if kind in ("all_to_all", "all_reduce"):
                exp[kind] = (2 if kind == "all_reduce" else 1) \
                    * rec["out"].numel() * 4
            else:
                d = next(b.dim for a, b in zip(have, want)
                         if isinstance(a, Partial) and a != b
                         and not isinstance(b, Replicate))
                c = max(cut_as_dtensor(full, sizes, at, want).shape[d]
                        for at in np.ndindex(*sizes))
                rest = math.prod(n for j, n in enumerate(rec["out"].shape)
                                 if j != d)
                exp[kind] = c * rest * 4
        rec["expected_bytes"] = exp
        if backward:
            src = tuple(Replicate() if isinstance(q, Partial) else q
                        for q in have)
            g = torch.Generator().manual_seed(7000 + i)
            gfull = torch.randint(-64, 64, shape, generator=g).float()
            gloc = cut_as_dtensor(gfull, sizes, coord, want).to(device)
            for c in (sharding.COLLECTIVE_BYTES, sharding.COLLECTIVE_COUNTS):
                c.clear()
            grad, = torch.autograd.grad((y.to_local() * gloc).sum(), x)
            rec.update(grad=grad.to_local().cpu(),
                       grad_placements_ok=tuple(grad.placements) == src,
                       grad_oracle=cut_as_dtensor(gfull, sizes, coord, src),
                       grad_bytes=dict(sharding.COLLECTIVE_BYTES),
                       grad_counts=dict(sharding.COLLECTIVE_COUNTS))
        out.append(rec)
    return out


# ---------------------------------------------------------------- attention
# (name, B, Sq, Sk, Hq, Hkv, dh, dv, chunk, causal, q_pos offset, kv_mask
# kind, dtype, layout): kv_mask "row0-empty" = batch row 0 fully masked
# (its rows get the uniform answer over every slot, pads included),
# "ragged" = row 0 valid up to a third of Sk; layout "strided" = K and V
# are views of a wider (B, Sk, 2 Hkv + 1, d) buffer and q a view with a
# gap between heads, read by their strides.  The served shapes are
# qwen3-0.6b's (16 query / 8 KV heads of 128, KV blocks of 1,024).
ATTN_EDGES = (
    ("qwen3 bf16 several blocks", 2, 1100, 1100, 16, 8, 128, 128, 256, True,
     None, None, "bfloat16", None),
    ("fp32", 2, 300, 300, 4, 2, 128, 128, 128, True, None, None, "float32",
     None),
    ("MQA R 48", 1, 100, 100, 48, 1, 128, 128, 64, True, None, None,
     "bfloat16", None),
    ("MLA dh 192 dv 128", 2, 200, 200, 4, 4, 192, 128, 128, True, None,
     None, "bfloat16", None),
    ("MLA fp32", 1, 100, 100, 4, 4, 192, 128, 64, True, None, None,
     "float32", None),
    ("Sk not a multiple of chunk", 2, 333, 333, 4, 2, 128, 128, 100, True,
     None, None, "bfloat16", None),
    ("q_pos at a shard's offset", 2, 100, 400, 4, 2, 128, 128, 128, True, 300,
     None, "bfloat16", None),
    ("kv_mask, a fully masked row", 2, 150, 150, 4, 2, 128, 128, 64, True,
     None, "row0-empty", "bfloat16", None),
    ("kv_mask fully masked, fp32", 2, 70, 70, 4, 2, 64, 64, 32, True, None,
     "row0-empty", "float32", None),
    ("kv_mask ragged, not causal", 2, 150, 150, 4, 2, 128, 128, 64, False,
     None, "ragged", "bfloat16", None),
    ("not causal", 2, 200, 300, 4, 2, 64, 64, 128, False, None, None,
     "bfloat16", None),
    ("dh 8 dv 6, scalar loads", 2, 13, 13, 4, 2, 8, 6, 4, True, None, None,
     "bfloat16", None),
    ("dh 8 dv 6 fp32", 2, 13, 13, 4, 2, 8, 6, 4, True, None, None, "float32",
     None),
    ("dh 24 dv 16 (MLA reduced)", 2, 40, 40, 4, 4, 24, 16, 8, True, None,
     None, "bfloat16", None),
    ("dh dv 256", 1, 130, 130, 2, 1, 256, 256, 64, True, None, None,
     "bfloat16", None),
    ("dh dv 256 fp32", 1, 70, 70, 2, 1, 256, 256, 32, True, None, None,
     "float32", None),
    ("strided views", 2, 200, 200, 4, 2, 128, 128, 64, True, None, None,
     "bfloat16", "strided"),
    ("several query tiles, causal skips", 1, 1024, 1024, 4, 2, 64, 64, 256,
     True, None, None, "bfloat16", None),
)

# (name, B, S, Hq, Hkv, dh, dv, lengths, dtype, layout): lengths a tuple
# (0: the uniform row over all S slots; S: every slot); layout "layer" =
# the caches are one layer of a (2, B, S, Hkv, d) buffer, as
# ``sharding.layer_of`` gives the decode step.
DECODE_EDGES = (
    ("qwen3 bf16 lengths 0 1 S", 3, 2048, 16, 8, 128, 128, (0, 1, 2048),
     "bfloat16", "layer"),
    ("ragged", 2, 3000, 16, 8, 128, 128, (1500, 2999), "bfloat16", None),
    ("fp32 lengths 0 1 S", 3, 1100, 4, 2, 128, 128, (0, 1, 1100), "float32",
     "layer"),
    ("MQA R 48", 2, 700, 48, 1, 128, 128, (513, 700), "bfloat16", None),
    ("dh 8 dv 6, scalar loads", 3, 9, 4, 2, 8, 6, (0, 4, 9), "bfloat16",
     None),
    ("dh 8 dv 6 fp32", 3, 9, 8, 1, 8, 6, (0, 4, 9), "float32", None),
    ("dh dv 256", 2, 600, 4, 2, 256, 256, (600, 37), "bfloat16", None),
    ("split edges", 4, 1536, 4, 2, 64, 64, (511, 512, 513, 1536),
     "bfloat16", None),
)

# each output row's max |o| times this bounds |kernel - plain|: two bf16
# ulps (the kernels sum in another order, so a rounding point may land a
# unit apart); fp32 to 1e-5
ATTN_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def attn_edge_operands(case, device, seed: int = 0) -> dict:
    """q, k, v (on ``device``, in the case's dtype and layout) and the
    keyword arguments of ``models.attention.attention`` for one
    ``ATTN_EDGES`` case."""
    _, b, sq, sk, hq, hkv, dh, dv, chunk, causal, off, mk, dt, lay = case
    rng = np.random.default_rng([seed, b, sq, sk, hq, dh, dv, chunk])
    dt = getattr(torch, dt)

    def t(x):
        return torch.as_tensor(x.astype(np.float32)).to(device=device,
                                                        dtype=dt)

    if lay == "strided":
        qb = t(rng.normal(size=(b, sq, hq + 1, dh)))
        q = qb[:, :, 1:]
        kvb = t(rng.normal(size=(b, sk, 2 * hkv + 1, max(dh, dv))))
        k, v = kvb[:, :, :hkv, :dh], kvb[:, :, hkv + 1:, :dv]
    else:
        q = t(rng.normal(size=(b, sq, hq, dh)))
        k = t(rng.normal(size=(b, sk, hkv, dh)))
        v = t(rng.normal(size=(b, sk, hkv, dv)))
    kw = {"causal": causal, "chunk": chunk, "scale": dh ** -0.5}
    if off is not None:
        kw["q_pos"] = torch.arange(off, off + sq, device=device)
    if mk is not None:
        m = np.ones((b, sk), np.int32)
        if mk == "row0-empty":
            m[0] = 0
        else:
            m[0, sk // 3:] = 0
        kw["kv_mask"] = torch.as_tensor(m, device=device)
    return {"q": q, "k": k, "v": v, "kw": kw}


def decode_edge_operands(case, device, seed: int = 0) -> dict:
    """q, the caches and lengths (on ``device``) and the scale of one
    ``DECODE_EDGES`` case."""
    _, b, s, hq, hkv, dh, dv, lengths, dt, lay = case
    rng = np.random.default_rng([seed, b, s, hq, hkv, dh, dv])
    dt = getattr(torch, dt)

    def t(x):
        return torch.as_tensor(x.astype(np.float32)).to(device=device,
                                                        dtype=dt)

    q = t(rng.normal(size=(b, 1, hq, dh)))
    if lay == "layer":
        k = t(rng.normal(size=(2, b, s, hkv, dh)))[1]
        v = t(rng.normal(size=(2, b, s, hkv, dv)))[1]
    else:
        k = t(rng.normal(size=(b, s, hkv, dh)))
        v = t(rng.normal(size=(b, s, hkv, dv)))
    return {"q": q, "k": k, "v": v,
            "lengths": torch.tensor(lengths, dtype=torch.int32,
                                    device=device),
            "scale": dh ** -0.5}


def attn_row_err(got, want) -> dict:
    """|got - want| over each output row's (last dim's) max |want|: the
    largest (``max_rel``), the largest absolute difference, and the share
    of elements that differ at all."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    diff = (g - w).abs()
    row = w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return {"max_rel": float((diff / row).max()) if diff.numel() else 0.0,
            "max_abs": float(diff.max()) if diff.numel() else 0.0,
            "share_differ": float((diff > 0).float().mean())
            if diff.numel() else 0.0}
