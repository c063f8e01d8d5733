"""Host-side choices of the PQ, BM25 and fp32 / hybrid tile wrappers, and
the arithmetic the BM25 kernel's per-document lookup rests on, on the CPU.

The tile of ``csrc/l2_topk.cu`` (fp32, hybrid and int8 rows) stages rows
and queries BK dims at a time through a ring of STAGES buffers (one more
for int8 rows, widened to fp32 a chunk ahead into two fp32 chunks), so
its shared memory does not grow with d; ``l2_topk.tile_smem_bytes``
mirrors its layout, whose constants are read from the source here, and
the layout must fit the 227 KB a block may use (two fp32 or int8 blocks
an SM) at every d and every query term count the wrappers admit (the
card test holds the mirror to the launcher's own figure).

``pq_adc.splits_for`` decides how many blocks the PQ scan gives the card
at the main path's shapes (the DEEP-10M top level, B = 1,024 x N =
32,768; a batch of 64); the kernel itself runs only on the card.
The BM25 kernel replaces the S-inner compare loop by a table whose hit is
the in-order sum of the matching slots' tf alone, and skips pad slots of
finite weight; the test below holds that order to
``testing.lexical_scores_f32`` (the kernels' float32 order) bit for bit
on every edge slab, repeated terms and pads of negative and infinite
weight included.
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

from repro_torch.kernels import bm25, l2_topk, pq_adc
from repro_torch.testing import (OPTION_EDGES, lexical_scores_f32,
                                 option_edge_operands)

H100_SMS = 132


@pytest.mark.parametrize("b, n, splits", [
    (1024, 32768, 1),      # the DEEP-10M top level: 7.8 blocks a SM already
    (1030, 40000, 1),      # the card test's batch past one query chunk
    (100, 40000, 6),       # the card test's split batch
    (64, 32768, 9),        # a batch of 64: 9 splits of 3,641 rows
    (64, 8192, 8),         # sift's 8,192 centroids: each split 1,024 rows
    (70, 20000, 8),
    (1, 100, 1),           # fewer rows than one split's minimum
])
def test_pq_splits_fill_the_card(b, n, splits):
    s = pq_adc.splits_for(b, n, H100_SMS)
    assert s == splits
    # enough blocks for BLOCKS_PER_SM a SM, unless N is too short to split
    assert (b * s >= pq_adc.BLOCKS_PER_SM * H100_SMS
            or s == -(-n // pq_adc.MIN_ROWS))


def test_pq_splits_never_exceed_the_rows():
    for b in (1, 7, 64, 1024, 4096):
        for n in (1, 64, 1023, 1024, 1025, 100_000):
            s = pq_adc.splits_for(b, n, H100_SMS)
            assert 1 <= s <= max(1, -(-n // pq_adc.MIN_ROWS))


def _kernel_constants(name: str, namespace: str = "") -> dict:
    """The integer ``constexpr``s of a kernel source (of one of its
    namespaces, when named, and the file's own before it), and of the
    lexical header it shares (``csrc/lexical.cuh``)."""
    csrc = pathlib.Path(pq_adc.__file__).with_name("csrc")
    text = (csrc / name).read_text()
    if namespace:
        text = text[:text.index(f"}}  // namespace {namespace}")]
    out = {}
    for src in ((csrc / "lexical.cuh").read_text(), text):
        out.update({m[1]: int(m[2]) for m in re.finditer(
            r"constexpr int (\w+) = (\d+);", src)})
    return out


def test_bm25_query_groups_always_fit_the_hit_rows():
    # the wrapper admits up to MAX_T query slots; the kernel halves its
    # query groups from BQ down to QG = THREADS / BN queries, and a group
    # of QG queries of MAX_T distinct terms must fit its 256 hit rows
    c = _kernel_constants("bm25_topk.cu")
    assert c["MAX_T"] == bm25.MAX_T
    qg = c["THREADS"] // c["BN"]
    assert c["BQ"] % qg == 0 and (c["BQ"] // qg) & (c["BQ"] // qg - 1) == 0
    assert qg * bm25.MAX_T <= c["UCAP"] - 1
    assert c["UCAP"] - 1 <= 256        # a hit row's number fits a byte


def _table_order_scores(qt, qw, terms, tf) -> np.ndarray:
    """Scores as the kernel's table computes them: per term, the sum of
    the matching slots' tf only, in slot order from 0.0; then the query's
    real slots in order, two roundings each, with a pad slot (term < 0)
    read as a zero hit where its weight is not finite and skipped where
    it is."""
    score = np.zeros(qt.shape[0], np.float32)
    for t in range(qt.shape[1]):
        hit = np.zeros_like(score)
        for s in range(terms.shape[1]):
            match = (terms[:, s] == qt[:, t]) & (qt[:, t] >= 0)
            hit = np.where(match, hit + tf[:, s], hit)
        used = (qt[:, t] >= 0) | ~np.isfinite(qw[:, t])
        score = np.where(used, score + hit * qw[:, t], score)
    return score


@pytest.mark.parametrize("repeat", [False, True],
                         ids=["distinct", "repeated_terms"])
@pytest.mark.parametrize("case", OPTION_EDGES,
                         ids=[c[0] for c in OPTION_EDGES])
def test_lookup_hits_equal_the_compare_loop_bitwise(case, repeat):
    o = option_edge_operands(case, repeat)
    b, n = o["qt"].shape[0], min(o["terms"].shape[0], 600)
    bq, rows = np.divmod(np.arange(b * n), n)
    args = (o["qt"][bq], o["qw"][bq], o["terms"][rows], o["tf"][rows])
    table = _table_order_scores(*args)
    loop = lexical_scores_f32(*args)
    assert table.tobytes() == loop.tobytes()
    # pad slots of negative and of infinite weight: the kernel skips the
    # first (+-0.0 never changes a sum that is never -0.0) and scores the
    # second (0 x inf is NaN there, as in the loop)
    qw = args[1].copy()
    pads = np.flatnonzero((args[0] < 0).ravel())
    qw.ravel()[pads] = np.where(pads % 3 == 0, np.inf, -2.5)
    args = (args[0], qw, args[2], args[3])
    table = _table_order_scores(*args)
    loop = lexical_scores_f32(*args)
    assert table.tobytes() == loop.tobytes()


def test_tile_constants_match_the_host_mirror():
    c = _kernel_constants("l2_topk.cu", "tile")
    assert c["BK"] == l2_topk.TILE_BK
    assert c["STAGES"] == l2_topk.TILE_STAGES >= 3
    # an int8 row's chunk is one 16-byte copy, and a block's 256 threads
    # widen a 128-row chunk 8 codes each
    assert c["BK"] == 16 and l2_topk.BN * c["BK"] == 8 * c["THREADS"]
    assert c["LIST"] == l2_topk.TILE_LIST
    assert c["BQ"] == l2_topk.BQ == 8 * c["THREADS"] // 32
    assert c["DICT_BITS_MAX"] == l2_topk.DICT_BITS_MAX
    assert c["UCAP"] == l2_topk.UCAP and c["SLAB_MAX"] == l2_topk.SLAB_MAX
    assert c["MAX_T"] == bm25.MAX_T
    # the staged stride keeps the float4 reads of eight lanes (rows lane,
    # a quarter-warp's phase) on 32 distinct banks
    ldk = c["BK"] + 4
    assert ldk == l2_topk.TILE_LDK and ldk % 4 == 0
    assert len({(r * ldk + w) % 32 for r in range(8) for w in range(4)}) == 32


@pytest.mark.parametrize("d", [128, 960, 13, 640, 1000])
@pytest.mark.parametrize("rows, t", [("f32", 0), ("int8", 0),
                                     ("hybrid", 1), ("hybrid", 4),
                                     ("hybrid", 8), ("hybrid", 16),
                                     ("hybrid", 64)])
def test_tile_shared_memory_fits_at_any_d(d, rows, t):
    """The staged chunks carry any d: the query tile no longer sits whole in
    shared memory (the first tile loop, int8 rows included, refused d
    above 512), so the layout is the same at every d; the hybrid's hit
    rows (257 of 64 documents), dictionary and query slots fit at every
    T."""
    smem = l2_topk.tile_smem_bytes(rows, t)
    assert smem <= l2_topk.SMEM_MAX
    chunks = -(-d // l2_topk.TILE_BK)
    assert chunks * l2_topk.TILE_BK >= d
    if rows != "hybrid":   # two blocks an SM (228 KB, 1 KB reserved a block)
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("b, n, splits, rows", [
    (64, 1_000_000, 261, 3840),     # the main shape: one wave, two an SM
    (70, 5000, 40, 128),            # two query tiles: one tile a split
    (1024, 1_000_000, 16, 62592),   # the index's exact-truth batches
    (1, 100, 1, 128),
])
def test_dense_splits_at_the_main_shapes(b, n, splits, rows):
    s, r = l2_topk.splits_for(b, n, H100_SMS)
    assert (s, r) == (splits, rows)
    # whole tiles of the fp32 and int8 scans, and of the hybrid's and
    # BM25's 64-row tiles; every row in exactly one split
    assert r % l2_topk.BN == 0 and r % l2_topk.HYBRID_BN == 0
    assert (s - 1) * r < n <= s * r
    assert s * -(-b // l2_topk.BQ) <= 2 * H100_SMS    # one wave, two an SM
