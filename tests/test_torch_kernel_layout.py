"""Host-side choices of the PQ and BM25 wrappers, and the arithmetic the
BM25 kernel's per-document lookup rests on, on the CPU.

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

from repro_torch.kernels import bm25, pq_adc
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


def _kernel_constants(name: str) -> dict:
    src = pathlib.Path(pq_adc.__file__).with_name("csrc") / name
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src.read_text())}


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
