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
its ``_query`` (``count_min_query_ref``, which stays plain torch), and
the LM serving path's two attentions (``chunked_attention_ref``, the
reference's ``lax.scan`` over KV blocks, and ``decode_attention_ref``,
its plain ``jnp`` decode; no Pallas counterpart either), each with a
split model (``chunked_attention_split``, ``decode_attention_split``)
that computes in its kernel's own order.  Each
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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels.attention import DECODE_SPLIT, tiles_of
from repro_torch.kernels.common import (INF, ids32, pad_sentinel,
                                        popcount32, stable_topk)

__all__ = ["l2_topk_ref", "l2_topk_int8_ref", "candidate_topk_ref",
           "candidate_rows_topk_ref", "bucket_probe_topk_ref",
           "bm25_dists_ref", "bm25_topk_ref", "hybrid_topk_ref",
           "pq_adc_scores_ref", "pq_adc_topk_ref", "hamming_dists_ref",
           "hamming_topk_ref", "pack_bits", "lsh_probe_shortlist_ref",
           "tree_descent_ref", "count_min_hash",
           "count_min_query_ref", "count_min_host_columns",
           "count_min_update_ref", "chunked_attention_ref",
           "chunked_attention_split", "decode_attention_ref",
           "decode_attention_split"]

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


# --------------------------------------------------------------- attention
# The LM serving path's two attentions (``models/attention.py`` keeps the
# signatures, the dense path and the contract).  Masked scores are -1e30,
# not -inf, so a row with no live slot gets the reference's uniform
# softmax, never NaN.

_NEG = -1e30


def _ein(eq: str, a, b):
    """``einsum`` with numpy's type promotion (``jnp.einsum`` of a bf16
    and an fp32 operand computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _group(q, n_kv: int):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def chunked_attention_ref(q, k, v, *, causal: bool, chunk: int, q_pos=None,
                          kv_mask=None, scale: float):
    """The reference's chunked attention (``repro/models/attention.py``'s
    ``lax.scan`` over KV blocks of ``chunk`` slots): q (B, Sq, Hq, dh), k
    (B, Sk, Hkv, dh), v (B, Sk, Hkv, dv) -> (B, Sq, Hq, dv) in q's dtype.

    A Python loop over the blocks, carrying the running (max, denominator,
    accumulator) in fp32; like the reference it computes every block, the
    last one padded (pads masked, V zero).  Each block's step
    (``_block_step``) runs in one of two modes, with the same numbers.
    Serving (no gradient wanted) updates each block's score tile in place,
    so a 32K prefill holds one tile.  When a gradient is wanted the step
    is out of place and runs under ``torch.utils.checkpoint``, as the
    reference wraps its scan step in ``jax.checkpoint``: the backward
    recomputes each block's probabilities from the carried statistics
    instead of saving every block's tile, which would rebuild the whole
    (Sq, Sk) matrix in fp32.  The recompute stops after the step's last op
    that saves a tensor (the checkpoint's early stop), so the step
    rescales its accumulator before the P.V product: the recompute then
    runs the scores and probabilities only, as XLA's remat of the
    reference's step does."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    qg = _group(q, hkv)                                   # (B,Sq,G,R,dh)
    qp = torch.arange(sq, dtype=torch.int64, device=dev) if q_pos is None \
        else q_pos.to(dev)
    n_blk = -(-sk // chunk)
    pad = n_blk * chunk - sk
    kpad = F.pad(k, (0, 0, 0, 0, 0, pad))
    vpad = F.pad(v, (0, 0, 0, 0, 0, pad))
    kvm = torch.ones((b, sk), dtype=torch.bool, device=dev) \
        if kv_mask is None else kv_mask.to(dev) > 0
    kvm = F.pad(kvm, (0, pad))
    dv = v.shape[-1]
    g, r = hkv, hq // hkv
    cdt = torch.promote_types(q.dtype, k.dtype)
    pdt = torch.promote_types(q.dtype, v.dtype)
    # (B, G, R*Sq, dh): one product a block per (batch, kv head)
    qh = qg.permute(0, 2, 3, 1, 4).reshape(b, g, r * sq, dh).to(cdt)
    m = torch.full((b, g, r, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, g, r, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, g, r, sq, dv), dtype=torch.float32, device=dev)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for blk in range(n_blk):
        lo = blk * chunk
        kc = kpad[:, lo:lo + chunk].permute(0, 2, 3, 1).to(cdt)  # B,G,dh,C
        vc = vpad[:, lo:lo + chunk].permute(0, 2, 1, 3).to(pdt)  # B,G,C,dv
        mask = ~kvm[:, lo:lo + chunk][:, None, None, None, :]
        if causal:
            kpos = lo + torch.arange(chunk, dtype=torch.int64, device=dev)
            mask = mask | ~(qp[:, None] >= kpos[None, :])
        if grad:
            m, l, acc = checkpoint(_block_step, qh, kc, vc, mask, m, l, acc,
                                   scale, q.dtype, False, use_reentrant=False)
        else:
            m, l, acc = _block_step(qh, kc, vc, mask, m, l, acc, scale,
                                    q.dtype, True)
    o = acc / torch.clamp(l[..., None], min=1e-30)
    o = o.permute(0, 3, 1, 2, 4)                           # (B,Sq,G,R,dv)
    return o.reshape(b, sq, hq, dv).to(q.dtype)


def _block_step(qh, kc, vc, mask, m, l, acc, scale: float, qdt,
                inplace: bool):
    """One KV block of the online softmax: scores (B, G, R, Sq, C) in
    fp32, ``mask`` True where a slot is masked; returns the carried (max,
    denominator, accumulator).  ``inplace`` (no autograd: serving) updates
    the score tile in place; the same numbers either way."""
    b, g, r, sq = m.shape
    chunk = kc.shape[-1]
    s = torch.matmul(qh, kc).view(b, g, r, sq, chunk).float()
    if inplace:
        s = s.mul_(scale).masked_fill_(mask, _NEG)
    else:
        s = (s * scale).masked_fill(mask, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    if inplace:
        p = s.sub_(m_new[..., None]).exp_()
    else:
        p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    # the rescale before the product: it is the step's last op that saves
    # a tensor, so the checkpoint's recompute stops ahead of P.V, whose
    # result the backward never reads (as XLA drops it from its remat)
    acc = acc * corr[..., None]
    pv = torch.matmul(p.to(qdt).to(vc.dtype).view(b, g, r * sq, chunk),
                      vc).view(b, g, r, sq, -1)
    return m_new, l, acc + pv.float()


def decode_attention_ref(q, k_cache, v_cache, lengths, *, scale: float):
    """The reference's one-token attention over a KV cache: q (B, 1, Hq,
    dh), caches (B, S, Hkv, dh|dv), slot t of row b valid where t <
    ``lengths[b]``; -> (B, 1, Hq, dv).  A row with no valid slot gets the
    uniform softmax over all S slots."""
    b, s, hkv, dh = k_cache.shape
    hq = q.shape[2]
    qg = _group(q, hkv)                                   # (B,1,G,R,dh)
    sc = _ein("bqgrd,bkgd->bgrqk", qg, k_cache).float() * scale
    valid = torch.arange(s, dtype=torch.int64,
                         device=q.device)[None, :] < lengths[:, None]
    sc = sc.masked_fill(~valid[:, None, None, None, :], _NEG)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    o = _ein("bgrqk,bkgd->bqgrd", p, v_cache)
    return o.reshape(b, 1, hq, -1)


def _to(x, dt):
    """``x`` rounded to ``dt`` and back to fp32 (a rounding point)."""
    return x.to(dt).float()


def chunked_attention_split(q, k, v, *, causal: bool, chunk: int,
                            q_pos=None, kv_mask=None, scale: float,
                            tiles=None):
    """``attention_chunked``'s design in plain torch, in the kernel's own
    order (``csrc/attention.cu``), so that the CPU tests hold the design
    against the reference where there is no card.

    Each (batch, KV head) flattens its query rows position-major, row t
    the position t // R and query head g R + t % R; a query tile is
    ``tiles[0]`` rows, walked over the reference's blocks of ``chunk``
    slots in inner tiles of ``tiles[1]`` slots (``attention.tiles_of``
    by default: the bf16 or the fp32 kernel's).  Each block takes two
    passes over its tiles: the block's max first, then ``p``, its sum and
    the block's P.V, which is rounded to the dtype once at the block's
    end.  A tile is skipped when it is masked for every row of the query
    tile and every row of the tile has a live slot somewhere (such work
    adds exactly 0); a causal tile past the tile's last position ends the
    walk.  A tile with a row that has no live slot skips nothing, so that
    row gets the reference's uniform answer over every slot, pads
    included."""
    bm, bn = tiles or tiles_of(q.dtype)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    r = hq // hkv
    dt = q.dtype
    rows = sq * r
    qp = (torch.arange(sq) if q_pos is None else q_pos.cpu()).long()
    rpos = qp.repeat_interleave(r)                        # (rows,)
    live = (torch.ones((b, sk), dtype=torch.bool) if kv_mask is None
            else kv_mask.cpu() > 0)
    n_blk = -(-sk // chunk)
    out = torch.empty((b, sq, hq, dv), dtype=torch.float32)
    neg_inf = float("-inf")
    for bi in range(b):
        hit = torch.nonzero(live[bi])
        first = int(hit[0]) if len(hit) else sk
        for g in range(hkv):
            qrows = q[bi, :, g * r:(g + 1) * r].reshape(rows, dh).float()
            kk, vv = k[bi, :, g].float(), v[bi, :, g].float()
            for t0 in range(0, rows, bm):
                t1 = min(t0 + bm, rows)
                Q, pos = qrows[t0:t1], rpos[t0:t1]
                qmax = int(pos.max())
                row_live = first <= pos if causal else \
                    torch.full(pos.shape, first < sk)
                skip_ok = bool(row_live.all())

                def scores(k0, k1):
                    n = torch.arange(k0, k0 + bn)
                    inb = n < sk
                    kt = torch.zeros((bn, dh))
                    kt[inb] = kk[n[inb]]
                    s = _to(Q @ kt.T, dt) * scale
                    ok = inb.clone()
                    ok[inb] = live[bi, n[inb]]
                    dead = ~ok[None, :]
                    if causal:
                        dead = dead | (n[None, :] > pos[:, None])
                    s = s.masked_fill(dead, _NEG)
                    return s.masked_fill((n >= k1)[None, :], neg_inf), n, inb

                m = torch.full((t1 - t0,), _NEG)
                l = torch.zeros(t1 - t0)
                acc = torch.zeros((t1 - t0, dv))
                done = False
                for blk in range(n_blk):
                    blo, bhi = blk * chunk, (blk + 1) * chunk
                    walk = []
                    for k0 in range(blo, bhi, bn):
                        k1 = min(k0 + bn, bhi)
                        if skip_ok:
                            if causal and k0 > qmax:
                                done = True
                                break
                            if k0 >= sk:
                                break
                            if not bool(live[bi, k0:min(k1, sk)].any()):
                                continue
                        walk.append((k0, k1))
                    if walk:
                        mloc = torch.stack([scores(*w)[0].amax(1)
                                            for w in walk]).amax(0)
                        m_new = torch.maximum(m, mloc)
                        lsum = torch.zeros_like(l)
                        pv = torch.zeros_like(acc)
                        for w in walk:
                            s, n, inb = scores(*w)
                            p = torch.exp(s - m_new[:, None])
                            lsum += p.sum(1)
                            vt = torch.zeros((bn, dv))
                            vt[inb] = vv[n[inb]]
                            pv += _to(p, dt) @ vt
                        corr = torch.exp(m - m_new)
                        l = l * corr + lsum
                        acc = acc * corr[:, None] + _to(pv, dt)
                        m = m_new
                    if done:
                        break
                o = acc / torch.clamp(l[:, None], min=1e-30)
                tt = torch.arange(t0, t1)
                out[bi, tt // r, g * r + tt % r] = o
    return out.to(dt)


def decode_attention_split(q, k_cache, v_cache, lengths, *, scale: float,
                           split=None):
    """``attention_decode``'s design in plain torch, in the kernel's own
    order: each (batch, KV head)'s live slots (all S where ``lengths[b]``
    is 0: the uniform row) cut into splits of ``split`` slots
    (``attention.DECODE_SPLIT`` by default); each split's scores, max
    ``m_i`` and ``z_i = sum exp(s - m_i)``; the row's max ``M = max m_i``
    and ``Z = sum_i z_i exp(m_i - M)`` in split order; each split's fp32
    P.V with ``p`` rounded to the dtype; the splits' sum rounded once."""
    split = split or DECODE_SPLIT
    b, s, hkv, dh = k_cache.shape
    hq, dv = q.shape[2], v_cache.shape[-1]
    r = hq // hkv
    dt = q.dtype
    out = torch.empty((b, 1, hq, dv), dtype=torch.float32)
    for bi in range(b):
        length = int(lengths[bi])
        end = s if length <= 0 else min(length, s)
        for g in range(hkv):
            Q = q[bi, 0, g * r:(g + 1) * r].float().cpu()
            K = k_cache[bi, :end, g].float().cpu()
            V = v_cache[bi, :end, g].float().cpu()
            sc = _to(Q @ K.T, dt) * scale
            if length <= 0:
                sc = torch.full_like(sc, _NEG)
            segs = [(i, min(i + split, end)) for i in range(0, end, split)]
            ms = [sc[:, a:e].amax(1) for a, e in segs]
            zs = [torch.exp(sc[:, a:e] - mi[:, None]).sum(1)
                  for (a, e), mi in zip(segs, ms)]
            M = torch.stack(ms).amax(0)
            Z = torch.zeros_like(M)
            for mi, zi in zip(ms, zs):
                Z = Z + zi * torch.exp(mi - M)
            o = torch.zeros((r, dv))
            for a, e in segs:
                p = _to(torch.exp(sc[:, a:e] - M[:, None]) / Z[:, None], dt)
                o = o + p @ V[a:e]
            out[bi, 0, g * r:(g + 1) * r] = o
    return out.to(dt)
