"""Plain PyTorch versions of the ported kernels (the ``ref.py`` contract).

Port of ``repro/kernels/ref.py``: the l2, int8, candidate, BM25, hybrid,
PQ-ADC and Hamming plain versions, the candidate tile read by row id
(``candidate_rows_topk_ref``, the served forest's rerank), the probe
chain over buckets
(``bucket_probe_topk_ref``, the loops the IVF local and the two-level
brute bottom ran before the chain had a kernel), and the tree beam
descent (``tree_descent_ref``, the reference's ``while_loop`` in
``tree_search``; its kernel has no Pallas counterpart), and the count-min
sketch's update (``count_min_update_ref``, the reference's jitted
``_update`` of ``adaptive/sketch.py``; no Pallas counterpart either) with
its ``_query`` (``count_min_query_ref``, which stays plain torch).  Each
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

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels.common import (INF, ids32, pad_sentinel,
                                        popcount32, stable_topk)

__all__ = ["l2_topk_ref", "l2_topk_int8_ref", "candidate_topk_ref",
           "candidate_rows_topk_ref", "bucket_probe_topk_ref",
           "bm25_dists_ref", "bm25_topk_ref", "hybrid_topk_ref",
           "pq_adc_scores_ref", "pq_adc_topk_ref", "hamming_dists_ref",
           "hamming_topk_ref", "pack_bits", "lsh_probe_shortlist_ref",
           "tree_descent_ref", "count_min_hash",
           "count_min_query_ref", "count_min_host_columns",
           "count_min_update_ref"]

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


def candidate_rows_topk_ref(queries, rows, ids, k: int = 10, *, after=None):
    """The tile read by row id: each query's candidates are rows ``ids``
    (B, C) of ``rows`` (N, d), an id outside ``[0, N)`` dead.  The gather
    of the (B, C, d) tile followed by ``candidate_topk_ref``."""
    ids = ids.to(torch.int32)
    ids = torch.where((ids >= 0) & (ids < rows.shape[0]), ids, -1)
    vecs = rows[torch.clamp(ids, min=0).long()]
    return candidate_topk_ref(queries, vecs, ids, k, after=after)


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


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
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


def lsh_probe_shortlist_ref(qproj, codes, bucket_ids, probe,
                            shortlist: int, *, extents=None):
    """The LSH bottom's probe scan, one probe step at a time: query b's
    sign bits are ``qproj[b] > 0`` (``qproj`` = queries @ projections,
    (B, n_bits)), its candidates the slots of buckets ``probe[b, :]`` of
    ``bucket_ids`` (K, cap), ``-1`` dead; a running Hamming top-
    ``shortlist`` over ``codes`` (N, W).  Returns (B, shortlist) int32 ids.

    Each step ranks ``[carried best | the bucket's row]`` with a stable
    sort, ties toward the lower column, as the reference's ``lax.top_k``:
    the list kept is the ``shortlist`` smallest slots under (distance,
    probe slot, column), dead slots after every live one, and ``-1`` where
    no live slot is left.  A bucket probed twice keeps both copies (the
    rerank drops the repeats).  ``extents`` is the kernel's operand and
    is ignored: the chain reads whole rows, as the reference's scan does."""
    B = qproj.shape[0]
    qcodes = pack_bits(qproj > 0)
    best_h = torch.full((B, shortlist), INF, device=qproj.device)
    best_i = torch.full((B, shortlist), -1, dtype=torch.int32,
                        device=qproj.device)
    for j in range(probe.shape[1]):
        cand = bucket_ids[probe[:, j].long()]              # (B, cap)
        ccodes = codes[torch.clamp(cand, min=0).long()]    # (B, cap, W)
        x = torch.bitwise_xor(qcodes[:, None, :], ccodes)
        ham = popcount32(x).sum(-1).to(torch.float32)
        ham = torch.where(cand >= 0, ham, INF)
        cat_h = torch.cat([best_h, ham], dim=1)
        cat_i = torch.cat([best_i, cand], dim=1)
        best_h, sel = stable_topk(cat_h, shortlist)
        best_i = torch.gather(cat_i, 1, sel)
    return best_i


def _split_margin(kind: str, arrays: dict, nodes, q):
    """alpha = proj[node]·q - tau[node]   (or coordinate split for kd)."""
    if kind == "kd":
        dim = arrays["dims"][nodes].long()                # (R, W)
        coord = torch.gather(q, 1, dim)                   # (R, W)
        return coord - arrays["tau"][nodes]
    pv = arrays["proj"][nodes]                            # (R, W, d)
    return torch.einsum("bwd,bd->bw", pv, q) - arrays["tau"][nodes]


def tree_descent_ref(arrays: dict, queries, *, kind: str, beam_width: int,
                     max_steps: int, roots=None):
    """The beam descent of ``repro/core/tree.py::tree_search`` and its leaf
    gather: (nodes (R, W), steps (R,), internal_visits (R,), candidates
    (R, W leaf) with -1 pads, their count (R,)), int32.

    Each step is the reference's ``body``; the loop ends, as its
    ``while_loop`` does, when no row holds an internal live node or after
    ``max_steps`` steps.  The exit test reads the card once a step where
    the tensors lie there, which only the tests and ``chip_smoke.py`` do;
    the kernel (``csrc/tree_descent.cu``) stops each row on its own, with
    the same result (its header note says why)."""
    q = queries.to(torch.float32)
    dev = q.device
    R = q.shape[0]
    W = beam_width
    children = arrays["children"]
    neg_inf = float("-inf")
    nodes = torch.full((R, W), -1, dtype=torch.int32, device=dev)
    nodes[:, 0] = 0 if roots is None else roots.to(torch.int32)
    prios = torch.full((R, W), neg_inf, dtype=torch.float32, device=dev)
    prios[:, 0] = 0.0
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    visits = torch.zeros(R, dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        safe = torch.clamp(nodes, min=0).long()
        valid = nodes >= 0
        left = children[safe, 0]
        right = children[safe, 1]
        active = valid & (left >= 0)                      # internal, live
        if not bool(active.any()):
            break
        alpha = _split_margin(kind, arrays, safe, q)
        near = torch.where(alpha <= 0, left, right)
        far = torch.where(alpha <= 0, right, left)
        # slot A: internal -> near child (same prio); leaf -> itself
        a_nodes = torch.where(active, near, nodes)
        a_prios = torch.where(valid, prios, neg_inf)
        # slot B: internal -> far child (prio - |alpha|); leaf/pad -> dead
        b_nodes = torch.where(active, far, -1)
        b_prios = torch.where(active, prios - torch.abs(alpha), neg_inf)
        cand_nodes = torch.cat([a_nodes, b_nodes], dim=1)
        cand_prios = torch.cat([a_prios, b_prios], dim=1)
        neg_top, top_i = stable_topk(-cand_prios, W)      # largest first
        new_nodes = torch.gather(cand_nodes, 1, top_i)
        nodes = torch.where(neg_top == float("inf"), -1, new_nodes)
        prios = -neg_top
        steps = steps + active.any(dim=1).to(torch.int32)
        visits = visits + active.sum(dim=1).to(torch.int32)
    # gather leaf entity ids
    leaf_entities = arrays["leaf_entities"]
    safe = torch.clamp(nodes, min=0).long()
    rows = torch.where(nodes >= 0, arrays["leaf_row"][safe], -1)  # (R, W)
    ents = torch.where(rows[..., None] >= 0,
                       leaf_entities[torch.clamp(rows, min=0).long()],
                       -1)                                # (R, W, leaf)
    cand = ents.reshape(R, W * leaf_entities.shape[1]).to(torch.int32)
    n_cand = (cand >= 0).sum(dim=1).to(torch.int32)
    return nodes, steps, visits, cand, n_cand


# ------------------------------------------------------------ count-min
_LOW32 = 0xFFFFFFFF


def count_min_hash(ids: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   width: int) -> torch.Tensor:
    """Multiply-shift universal hash -> (depth, m) int64 column indices.

    ``ids`` int64, taken mod 2**32 as the reference's uint32 cast takes
    them; ``a`` / ``b`` int64 holding uint32 values.  Torch has no
    dependable uint32 multiply on every backend, so the hash runs in int64:
    ``((a * x + b) & 0xFFFFFFFF) >> shift``; the product wraps in two's
    complement and its low 32 bits are exact, so the columns are the
    reference's."""
    shift = 32 - int(np.log2(width))
    x = ids & _LOW32
    h = (a[:, None] * x[None, :] + b[:, None]) & _LOW32
    return h >> shift


def count_min_query_ref(table: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The reference's ``_query``: each id's minimum over the rows of its
    cells, 0 for an invalid id.  ``ids`` int64 on the table's device, read
    by their low 32 bits as an int32 (the reference's arrays are 32-bit):
    negative there means invalid."""
    depth, width = table.shape
    x = ((ids & _LOW32) ^ 0x80000000) - 0x80000000     # the int32 value
    valid = x >= 0
    h = count_min_hash(torch.where(valid, x, 0), a, b, width)
    rows = torch.arange(depth, device=table.device)[:, None]
    est = table[rows, h].amin(dim=0)
    return torch.where(valid, est, 0.0)


def count_min_host_columns(ids: np.ndarray, a: np.ndarray, b: np.ndarray,
                           width: int) -> np.ndarray:
    """``count_min_hash`` on the host: (depth, m) columns of int64 ``ids``
    with the uint32 multipliers held as uint64 (a * x + b < 2**64: no
    wrap)."""
    shift = np.uint64(32 - int(np.log2(width)))
    x = (ids & _LOW32).astype(np.uint64)
    h = (a[:, None] * x[None, :] + b[:, None]) & np.uint64(_LOW32)
    return (h >> shift).astype(np.int64)


def _count_min_passes(cells: np.ndarray, w: np.ndarray):
    """Order the adds ``cells`` (flat table indices, in batch order) and
    their weights into passes that each touch a cell at most once, the
    ``p``-th pass holding every cell's ``p``-th add.  Returns (cells,
    weights, adds a pass)."""
    order = np.argsort(cells, kind="stable")
    s = cells[order]
    pos = np.arange(s.size)
    new_run = np.ones(s.size, bool)
    new_run[1:] = s[1:] != s[:-1]
    rank = pos - np.maximum.accumulate(np.where(new_run, pos, 0))
    by_rank = np.argsort(rank, kind="stable")
    return s[by_rank], w[order][by_rank], np.bincount(rank).tolist()


def count_min_update_ref(table, a, b, hh_ids, ids, weights, decay: float):
    """One sketch update, the reference's ``_update``: decay, the adds,
    the heavy-hitter re-rank.  ``ids`` / ``weights`` (m,) on the host (ids
    by their low 32 bits as an int32: negative means invalid, hashed as 0
    with weight 0), ``decay`` a float32 value.  Returns new tensors (the
    old ones are never written, so a reader holding them sees one
    consistent state).

    The reference's scatter-add runs its updates one after another in
    batch order.  ``index_put_(accumulate=True)`` may add duplicates in
    another order, or sum them before adding (and does so differently on
    the card and on the CPU), so the adds run in passes planned on the
    host: pass ``p`` holds the ``p``-th occurrence of every table cell in
    batch order, each cell at most once a pass.  Every device then rounds
    exactly as the reference does, weighted or not."""
    x = ids32(ids)
    w = np.asarray(weights, np.float32).ravel()
    depth, width = table.shape
    valid = x >= 0
    h = count_min_host_columns(
        np.where(valid, x, 0).astype(np.int64),
        a.cpu().numpy().astype(np.uint64), b.cpu().numpy().astype(np.uint64),
        width)
    cells, vals, counts = _count_min_passes(
        (np.arange(depth)[:, None] * width + h).reshape(-1),
        np.broadcast_to(np.where(valid, w, np.float32(0.0)),
                        h.shape).reshape(-1))
    dev = table.device
    cells = torch.as_tensor(cells, device=dev)
    vals = torch.as_tensor(vals, device=dev)
    table = table * decay
    flat = table.view(-1)
    lo = 0
    for c in counts:
        sl = cells[lo:lo + c]
        flat[sl] = flat[sl] + vals[lo:lo + c]
        lo += c

    # heavy hitters: re-rank the current top-k and the batch ids by their
    # fresh estimates; duplicates are masked so one id holds one slot
    cand = torch.cat([hh_ids, torch.as_tensor(x, device=dev)])
    est = count_min_query_ref(table, a, b, cand.long())
    est = torch.where(cand >= 0, est, -torch.inf)
    order = torch.argsort(cand, stable=True)
    sc = cand[order]
    dup_sorted = torch.zeros_like(sc, dtype=torch.bool)
    dup_sorted[1:] = (sc[1:] == sc[:-1]) & (sc[1:] >= 0)
    dup = torch.zeros_like(dup_sorted)
    dup[order] = dup_sorted
    est = torch.where(dup, -torch.inf, est)
    # lax.top_k's order: largest first, ties to the lower index, a NaN
    # (from a NaN weight) above every number, as the reference ranks the
    # NaN a NaN weight leaves: by value, then the NaNs stably first
    nan = torch.isnan(est)
    _, by_value = stable_topk(-torch.where(nan, 0.0, est)[None],
                              est.shape[0])
    order = by_value[0][torch.argsort((~nan[by_value[0]]).int(), stable=True)]
    top_i = order[:hh_ids.shape[0]]
    top_est = est[top_i]
    gone = torch.isneginf(top_est)
    new_ids = torch.where(gone, -1, cand[top_i]).to(torch.int32)
    new_est = torch.where(gone, 0.0, top_est)
    return table, new_ids, new_est
