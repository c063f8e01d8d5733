"""Card tests of the port's CUDA kernels: each kernel against its plain
version (with the hybrid alpha = 0 / 1 identities), at k up to the
lists' length and above it (the passes of ``common.topk_passes``), the
fp32 tile at d = 960 and the int8 one at d = 13, 640 and 1,000 (and an
int8 backend at d = 640), Hamming over every word count, batch shape and
threshold edge, the probe chain's two
row sources against each other and against the chain of single steps,
one small IVF serve,
one small filtered / lexical / hybrid / int8 serve and one small run of
the index layer (PQ top level, one-level LSH) through the kernels.

Marked ``gpu``; each test decides inside itself whether a card is there
and skips with the reason when not.  Run on the card with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: the kernels sum in another order than PyTorch's ops, so
distances agree to |d_k - d_p| <= 1e-5 * (qn + xn); ids agree exactly on
these inputs (continuous random data, no near-ties at these sizes),
except on BM25 slabs with a repeated term, whose massively tied scores
round differently in the two orders: there ids may differ at near-ties,
and each kernel distance is held bit for bit to the kernels' own order.
The PQ-ADC kernel sums in the plain version's order and the Hamming
distances are whole numbers, so those two equal their plain versions bit
for bit, ids and distances, ties included.  The probe chain's entry
(``bucket_probe_topk``) shares ``candidate_topk``'s arithmetic, so its
two row sources and the chain of ``candidate_topk`` steps agree with it
bit for bit; against the plain version it holds the tolerance above.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.core.index import build_index
from repro_torch.core.lexical import build_lexical_slabs, query_operands
from repro_torch.core.lsh import lsh_build, lsh_search
from repro_torch.core.metadata import FilterSpec, MetadataTable
from repro_torch.core.protocol import IndexSpec
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.data.synthetic import make_corpus, make_queries
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import (bm25, bucket_topk, hamming, l2_topk, ops,
                                 pq_adc, ref)
from repro_torch.kernels.common import merge_topk
from repro_torch.serve.cell import ServingCell
from repro_torch.testing import (CHAIN_EDGES, EDGE_ALPHAS, HAMMING_EDGES,
                                 OPTION_EDGES, PQ_EDGES,
                                 chain_edge_operands, chain_union_topk,
                                 hamming_edge_operands, step_chain,
                                 hybrid_by_parts, lexical_scores_f32,
                                 option_edge_operands, pq_edge_operands)

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close(kd, ki, pd, pi, scale):
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    assert np.array_equal(np.isinf(kd), np.isinf(pd))
    assert (ki == pi).all()
    fin = np.isfinite(pd)
    assert (np.abs(kd[fin] - pd[fin])
            <= REL * np.broadcast_to(scale, pd.shape)[fin]).all()


def _close_near_ties(kd, ki, pd, pi, scale):
    """``_close`` for slab rows with a repeated term: the plain version's
    hit sums round in another order than the kernel's, and BM25 scores tie
    massively, so ids may differ where the two distances of a slot agree
    within the tolerance."""
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    assert np.array_equal(np.isinf(kd), np.isinf(pd))
    fin = np.isfinite(pd)
    tol = REL * np.broadcast_to(scale, pd.shape)
    err = np.abs(np.where(fin, kd.astype(np.float64) - pd, 0.0))
    assert (err <= tol).all()
    assert ((ki == pi) | (err <= tol)).all()


@pytest.mark.parametrize("b,n,d,k,valid", [
    (1, 100, 8, 5, None),
    (4, 77, 8, 5, None),          # N not a multiple of the row tile
    (3, 6, 8, 10, None),          # k > N: sentinel pad
    (4, 50, 8, 5, "dead"),
    (6, 120, 8, 7, "half"),
    (70, 5000, 128, 32, "half"),  # two query tiles, several splits
])
def test_l2_topk_kernel_matches_plain(dev, b, n, d, k, valid):
    rng = np.random.default_rng(b * 1000 + n)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    v = None
    if valid == "dead":
        v = torch.zeros(n, dtype=torch.int32, device=dev)
    elif valid == "half":
        v = torch.as_tensor((rng.random(n) > .5).astype(np.int32), device=dev)
    before = l2_topk.LAUNCHES.count
    kd, ki = l2_topk.l2_topk(q, x, k, valid=v)
    pd, pi = ref.l2_topk_ref(q, x, k, valid=v)
    torch.cuda.synchronize()
    assert l2_topk.LAUNCHES.count == before + 1
    scale = ((q * q).sum(1)[:, None] + (x * x).sum(1).max()).cpu().numpy()
    _close(kd, ki, pd, pi, scale)


@pytest.mark.parametrize("case", ["dead", "k>C", "carried", "all_dead"])
def test_candidate_topk_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(8)
    B, C, D, k = 5, 37, 8, 6
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    q = t(rng.normal(size=(B, D)).astype(np.float32))
    vecs = t(rng.normal(size=(B, C, D)).astype(np.float32))
    ids = rng.integers(0, 500, size=(B, C)).astype(np.int32)
    ids[:, ::5] = -1
    ids = t(ids)
    kw = {}
    if case == "k>C":
        vecs, ids, k = vecs[:, :20].contiguous(), ids[:, :20].contiguous(), 24
    elif case == "carried":
        kw = dict(best_d=t(np.sort(rng.random((B, k)).astype(np.float32)
                                   * .5, axis=1)),
                  best_i=t(rng.integers(1000, 2000, size=(B, k))
                           .astype(np.int32)))
    elif case == "all_dead":
        ids = torch.full_like(ids, -1)
    kd, ki = bucket_topk.candidate_topk(q, vecs, ids, k, **kw)
    pd, pi = ref.candidate_topk_ref(q, vecs, ids, k, **kw)
    torch.cuda.synchronize()
    scale = ((q * q).sum(1) + (vecs * vecs).sum(-1).amax(1))[:, None]
    _close(kd, ki, pd, pi, scale.cpu().numpy())


def test_candidate_topk_duplicate_emitted_once(dev):
    rng = np.random.default_rng(9)
    B, C, D, k = 4, 30, 16, 8
    q = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32), device=dev)
    vecs = torch.as_tensor(rng.normal(size=(B, C, D)).astype(np.float32),
                           device=dev)
    vecs[:, 1::2] = vecs[:, 0:-1:2]
    ids = torch.arange(C, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    ids[:, 1::2] = ids[:, 0:-1:2]
    kd, ki = bucket_topk.candidate_topk(q, vecs, ids, k)
    sent_d = torch.full((B, k), float("inf"), device=dev)
    sent_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    pd, pi = merge_topk(sent_d, sent_i, batched_l2sq(vecs, q), ids, k)
    torch.cuda.synchronize()
    for row in ki.cpu().numpy():
        assert len(set(row.tolist())) == k
    scale = ((q * q).sum(1) + (vecs * vecs).sum(-1).amax(1))[:, None]
    _close(kd, ki, pd, pi, scale.cpu().numpy())


def _bits_equal(a, b):
    (ad, ai), (bd, bi) = a, b
    assert torch.equal(ai, bi), "ids differ"
    assert torch.equal(ad.view(torch.int32), bd.view(torch.int32)), \
        "distance bits differ"


@pytest.mark.parametrize("case", CHAIN_EDGES, ids=[c[0] for c in CHAIN_EDGES])
def test_probe_chain_kernel_matches_plain(dev, case):
    o = chain_edge_operands(case)
    q, db, bids, bvecs, probe = (torch.as_tensor(o[n], device=dev) for n in (
        "q", "db", "bucket_ids", "bucket_vecs", "probe"))
    k, B = o["k"], q.shape[0]
    before = bucket_topk.LAUNCHES.count
    by_slot = bucket_topk.bucket_probe_topk(q, probe, bids, k,
                                            bucket_vecs=bvecs)
    by_id = bucket_topk.bucket_probe_topk(q, probe, bids, k, db=db)
    torch.cuda.synchronize()
    assert bucket_topk.LAUNCHES.count == before + (2 if B else 0)
    # the same rows through either source: the same bits
    _bits_equal(by_slot, by_id)
    # the chain of single steps carries the best through the same
    # arithmetic, a pair seen twice dropped at each merge
    _bits_equal(by_slot, step_chain(q, probe, bids, bvecs, k))
    if case[-1] == "repeat":
        # the plain loop keeps both copies of a repeated bucket; the rule
        # (a pair seen twice emitted once) is merge_topk's
        pd, pi = chain_union_topk(q, probe, bids, db, k)
        assert all(len(set(r[r >= 0].tolist())) == (r >= 0).sum()
                   for r in by_slot[1].cpu().numpy())
    else:
        pd, pi = ref.bucket_probe_topk_ref(q, probe, bids, k,
                                           bucket_vecs=bvecs)
        _bits_equal((pd, pi), ref.bucket_probe_topk_ref(q, probe, bids, k,
                                                        db=db))
    scale = ((q * q).sum(1) + (db * db).sum(1).max())[:, None]
    _close(*by_slot, pd, pi, scale.cpu().numpy())


def test_probe_chain_rejects_what_it_cannot_take(dev):
    o = chain_edge_operands(CHAIN_EDGES[0])
    q, db, bids, bvecs, probe = (torch.as_tensor(o[n], device=dev) for n in (
        "q", "db", "bucket_ids", "bucket_vecs", "probe"))
    # k above KMAX: served in passes, the reference's answer (it clamps
    # any k), not a refusal
    got = bucket_topk.bucket_probe_topk(q, probe, bids, 33, db=db)
    scale = ((q * q).sum(1) + (db * db).sum(1).max())[:, None]
    _close(*got, *ref.bucket_probe_topk_ref(q, probe, bids, 33, db=db),
           scale.cpu().numpy())
    with pytest.raises(ValueError, match="exactly one"):
        bucket_topk.bucket_probe_topk(q, probe, bids, 5)
    with pytest.raises(ValueError, match="exactly one"):
        bucket_topk.bucket_probe_topk(q, probe, bids, 5, db=db,
                                      bucket_vecs=bvecs)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_topk.bucket_probe_topk(q.cpu(), probe, bids, 5, db=db)
    with pytest.raises(TypeError):
        bucket_topk.bucket_probe_topk(q, probe, bids.long(), 5, db=db)
    with pytest.raises(ValueError):
        bucket_topk.bucket_probe_topk(q, probe, bids, 5,
                                      bucket_vecs=bvecs[:, :3])
    idx = build_two_level(o["db"], TwoLevelConfig(n_clusters=8, seed=0),
                          device=dev)
    d, i, w = idx.search(o["q"], 40, nprobe=2)
    cpu = dataclasses.replace(idx, device=torch.device("cpu"))
    dc, ic, wc = cpu.search(o["q"], 40, nprobe=2)
    assert i.shape == (o["q"].shape[0], 40) and w == wc
    assert (i == ic).all()
    np.testing.assert_allclose(d, dc, rtol=REL, atol=1e-4)


def test_kernels_reject_cpu_tensors_and_large_k(dev):
    q = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):
        l2_topk.l2_topk(q.cpu(), torch.zeros((10, 8)), 3)
    # k above KMAX: passes, each one counted launch, the plain answer
    rng = np.random.default_rng(33)
    x = torch.as_tensor(rng.normal(size=(100, 8)).astype(np.float32),
                        device=dev)
    q = torch.as_tensor(rng.normal(size=(2, 8)).astype(np.float32),
                        device=dev)
    before = l2_topk.LAUNCHES.count
    kd, ki = l2_topk.l2_topk(q, x, 33)
    assert l2_topk.LAUNCHES.count == before + 2
    scale = ((q * q).sum(1)[:, None] + (x * x).sum(1).max()).cpu().numpy()
    _close(kd, ki, *ref.l2_topk_ref(q, x, 33), scale)


def test_small_ivf_serve_runs_through_the_kernels(dev):
    db = make_corpus("sift", scale=0.016, seed=0)
    queries = make_queries(db, 64, seed=1)
    idx = build_two_level(db, TwoLevelConfig(n_clusters=64, seed=0),
                          device=dev)
    backend = ShardedSearchBackend(idx, kind="ivf", nprobe_local=8, k=10)
    before = bucket_topk.LAUNCHES.count
    cell = ServingCell(backend, max_batch=16)
    try:
        served = [cell.search(q, timeout=60) for q in queries[:16]]
    finally:
        cell.close()
    assert bucket_topk.LAUNCHES.count > before
    plain = ShardedSearchBackend(idx, kind="ivf", nprobe_local=8, k=10,
                                 device="cpu")(queries[:16])
    ids = np.stack([s[1] for s in served])
    # sift-range rows round d2 by about one unit in either expansion, so
    # a neighbour pair closer than that may swap (two of 160 slots)
    assert (ids == plain[1]).mean() >= 0.95
    assert cell.stats().n == 16


@pytest.mark.parametrize("repeat", [False, True],
                         ids=["distinct", "repeated_terms"])
@pytest.mark.parametrize("case", OPTION_EDGES, ids=[c[0] for c in OPTION_EDGES])
def test_option_kernels_match_plain(dev, case, repeat):
    o = option_edge_operands(case, repeat)
    q, x, qt, qw, terms, tf, v = (
        None if o[n] is None else torch.as_tensor(o[n], device=dev)
        for n in ("q", "x", "qt", "qw", "terms", "tf", "valid"))
    k = o["k"]
    qn = (q * q).sum(1)[:, None].cpu().numpy()

    codes, scales = (torch.as_tensor(a, device=dev)
                     for a in ops.quantize_rows_int8(o["x"]))
    deq = codes.float() * scales[:, None]
    n8 = l2_topk.INT8_LAUNCHES.count
    kd, ki = l2_topk.l2_topk_int8(q, codes, scales, k, valid=v)
    pd, pi = ref.l2_topk_int8_ref(q, codes, scales, k, valid=v)
    torch.cuda.synchronize()
    assert l2_topk.INT8_LAUNCHES.count == n8 + 1
    _close(kd, ki, pd, pi, qn + float((deq * deq).sum(1).max()))

    bd, bi = bm25.bm25_topk(qt, qw, terms, tf, k, valid=v)
    pd, pi = ref.bm25_topk_ref(qt, qw, terms, tf, k, valid=v)
    torch.cuda.synchronize()
    if repeat:
        _close_near_ties(bd, bi, pd, pi, 1.0)
    else:   # one non-zero term per hit sum: bitwise on every slot
        assert torch.equal(bi, pi)
        assert torch.equal(bd.view(torch.int32), pd.view(torch.int32))
    # every returned distance is -score in the kernels' float32 order
    got = bi.cpu().numpy() >= 0
    bq, _ = np.nonzero(got)
    rows = bi.cpu().numpy()[got]
    want = -lexical_scores_f32(o["qt"][bq], o["qw"][bq], o["terms"][rows],
                               o["tf"][rows])
    assert want.tobytes() == bd.cpu().numpy()[got].tobytes()

    ld, li = l2_topk.l2_topk(q, x, k, valid=v)
    scale = qn + float((x * x).sum(1).max())
    for alpha in EDGE_ALPHAS:
        a = torch.full((1, 1), alpha, device=dev)
        hd, hi = bm25.hybrid_topk(q, x, qt, qw, terms, tf, a, k, valid=v)
        pd, pi = ref.hybrid_topk_ref(q, x, qt, qw, terms, tf, a, k, valid=v)
        torch.cuda.synchronize()
        (_close_near_ties if repeat else _close)(hd, hi, pd, pi,
                                                 alpha * scale + 1.0)
        # each returned pair is a * d2 - (1 - a) * score bit for bit
        parts = hybrid_by_parts(q, x, qt, qw, terms, tf, alpha, hd, hi)
        assert parts["mismatches"] == 0, parts
        assert parts["l2_max_rel_err"] <= REL
        assert parts["lex_max_rel_err"] <= parts["lex_bound"]
        if alpha == 0.0:     # the BM25 kernel's answer
            assert torch.equal(hi, bi) and torch.equal(hd, bd)
        if alpha == 1.0:     # the fp32 L2 kernel's answer (same tile code)
            assert torch.equal(hi, li) and torch.equal(hd, ld)


def test_option_kernels_reject_what_they_cannot_take(dev):
    t = torch.zeros((4, 17), dtype=torch.int32, device=dev)
    f = torch.zeros((4, 17), device=dev)
    qt = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    qw = torch.zeros((2, 3), device=dev)
    with pytest.raises(ValueError, match="slots"):
        bm25.bm25_topk(qt, qw, t, f, 2)
    with pytest.raises(TypeError):
        l2_topk.l2_topk_int8(torch.zeros((2, 8), device=dev),
                             torch.zeros((4, 8), device=dev),
                             torch.ones(4, device=dev), 2)


def test_small_option_serve_runs_through_the_kernels(dev):
    rng = np.random.default_rng(3)
    db = make_corpus("sift", scale=0.016, seed=0)
    n = db.shape[0]
    queries = make_queries(db, 32, seed=1)
    docs = [rng.integers(0, 500, size=int(rng.integers(6, 13))).tolist()
            for _ in range(n)]
    slabs = build_lexical_slabs(docs, 500)
    meta = MetadataTable({"pct": rng.permutation(n) % 100})
    qt, qw = query_operands([docs[int(i)][:3] for i in range(32)], slabs)
    spec = FilterSpec.range("pct", 0, 49)
    brute = ShardedSearchBackend(db, kind="brute", k=10, metadata=meta,
                                 lexical=slabs)
    int8 = ShardedSearchBackend(db, kind="brute", k=10, precision="int8")
    plain = ShardedSearchBackend(db, kind="brute", k=10, metadata=meta,
                                 lexical=slabs, device="cpu")
    sets = [dict(filter=spec), dict(mode="lexical"),
            dict(mode="hybrid", alpha=0.5)]
    before = {c.name: c.count for c in (l2_topk.LAUNCHES, bm25.LAUNCHES,
                                        bm25.HYBRID_LAUNCHES,
                                        l2_topk.INT8_LAUNCHES)}
    cell, cell8 = (ServingCell(brute, max_batch=16),
                   ServingCell(int8, max_batch=16))
    try:
        served = [[cell.search(queries[r], timeout=60, q_terms=qt[r],
                               q_weights=qw[r], **o) for r in range(32)]
                  for o in sets]
        served8 = [cell8.search(q, timeout=60) for q in queries]
    finally:
        cell.close()
        cell8.close()
    after = {c.name: c.count for c in (l2_topk.LAUNCHES, bm25.LAUNCHES,
                                       bm25.HYBRID_LAUNCHES,
                                       l2_topk.INT8_LAUNCHES)}
    assert all(after[k] > before[k] for k in before)
    admitted = spec.mask(meta, n)
    assert admitted[np.stack([s[1] for s in served[0]])].all()
    for o, got in zip(sets, served):
        want = plain(queries, filter_spec=o.get("filter"),
                     mode=o.get("mode", "semantic"),
                     alpha=o.get("alpha", 0.5), q_terms=qt, q_weights=qw)
        ids = np.stack([s[1] for s in got])
        if o.get("mode") == "lexical":
            assert (ids == want[1]).all()
        else:                # sift-range rows: near-ties may swap
            assert (ids == want[1]).mean() >= 0.95
    ids8 = np.stack([s[1] for s in served8])
    truth = plain(queries)[1]
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(ids8, truth)]) >= 0.5


def _bitwise(kd, ki, pd, pi):
    assert torch.equal(ki, pi)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))


@pytest.mark.parametrize("case", PQ_EDGES, ids=[c[0] for c in PQ_EDGES])
def test_pq_adc_topk_kernel_matches_plain(dev, case):
    lut, codes, valid, k = (
        None if a is None else torch.as_tensor(a, device=dev)
        if isinstance(a, np.ndarray) else a for a in pq_edge_operands(case))
    before = pq_adc.LAUNCHES.count
    kd, ki = pq_adc.pq_adc_topk(lut, codes, k, valid=valid)
    pd, pi = ref.pq_adc_topk_ref(lut, codes, k, valid=valid)
    torch.cuda.synchronize()
    assert pq_adc.LAUNCHES.count == before + 1
    _bitwise(kd, ki, pd, pi)
    # int32 codes are taken as well (the Pallas kernel's operand type)
    kd2, ki2 = pq_adc.pq_adc_topk(lut, codes.to(torch.int32), k, valid=valid)
    _bitwise(kd2, ki2, pd, pi)


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("b, split", [(1030, False), (100, True)],
                         ids=["B=1030", "B=100 split"])
def test_pq_adc_topk_main_path_batch_matches_plain(dev, b, split, k):
    """Past one query chunk over more centroid codes than DEEP-10M has,
    with dead rows (one split: the queries fill the card), and a smaller
    batch whose rows the grid splits across blocks; both bit for bit the
    plain version."""
    rng = np.random.default_rng([7, b, k])
    lut = torch.as_tensor((rng.random((b, 8, 256)) * 10).astype(
        np.float32), device=dev)
    codes = torch.as_tensor(rng.integers(0, 256, size=(40000, 8)).astype(
        np.uint8), device=dev)
    valid = torch.as_tensor((rng.random(40000) > 0.1).astype(np.int32),
                            device=dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (pq_adc.splits_for(b, 40000, sm) > 1) == split
    kd, ki = pq_adc.pq_adc_topk(lut, codes, k, valid=valid)
    pd, pi = ref.pq_adc_topk_ref(lut, codes, k, valid=valid)
    torch.cuda.synchronize()
    _bitwise(kd, ki, pd, pi)


@pytest.mark.parametrize("case", HAMMING_EDGES,
                         ids=[c[0] for c in HAMMING_EDGES])
def test_hamming_topk_kernel_matches_plain(dev, case):
    q, codes, valid, k = (
        None if a is None else torch.as_tensor(a, device=dev)
        if isinstance(a, np.ndarray) else a
        for a in hamming_edge_operands(case))
    before = hamming.LAUNCHES.count
    kd, ki = hamming.hamming_topk(q, codes, k, valid=valid)
    pd, pi = ref.hamming_topk_ref(q, codes, k, valid=valid)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES.count == before + 1
    _bitwise(kd, ki, pd, pi)


def test_index_kernels_reject_what_they_cannot_take(dev):
    lut = torch.zeros((2, 8, 256), device=dev)
    codes = torch.zeros((100, 8), dtype=torch.uint8, device=dev)
    # k above KMAX_PQ: two passes, bit for bit the plain version
    lut_r = torch.as_tensor(np.random.default_rng(65).random(
        (2, 8, 256)).astype(np.float32), device=dev)
    codes_r = torch.as_tensor(np.random.default_rng(66).integers(
        0, 256, size=(100, 8)).astype(np.uint8), device=dev)
    before = pq_adc.LAUNCHES.count
    got = pq_adc.pq_adc_topk(lut_r, codes_r, 65)
    assert pq_adc.LAUNCHES.count == before + 2
    _bitwise(*got, *ref.pq_adc_topk_ref(lut_r, codes_r, 65))
    with pytest.raises(ValueError):
        pq_adc.pq_adc_topk(lut[:, :, :128], codes, 5)
    with pytest.raises(TypeError):
        pq_adc.pq_adc_topk(lut, codes.float(), 5)
    q = torch.zeros((2, 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="W=9"):
        hamming.hamming_topk(q, torch.zeros((10, 9), dtype=torch.int32,
                                            device=dev), 3)
    with pytest.raises(TypeError):
        hamming.hamming_topk(q.float(), torch.zeros((10, 9), device=dev), 3)


def test_small_index_runs_through_the_kernels(dev):
    """A PQ-top two-level index and the one-level LSH scan on the card:
    both kernels launch, and the answers are the CPU run's on the same
    structures."""
    db = make_corpus("deep", scale=0.002, seed=0)
    queries = make_queries(db, 64, seed=1)
    idx = build_index(IndexSpec("two_level", TwoLevelConfig(
        n_clusters=128, top="pq", bottom="brute", seed=0)), db)
    before = pq_adc.LAUNCHES.count
    chain = bucket_topk.LAUNCHES.count
    d, i, w = idx.search(queries, 10, nprobe=8)
    torch.cuda.synchronize()
    assert pq_adc.LAUNCHES.count > before
    # the brute bottom: one chain call a query chunk
    assert bucket_topk.LAUNCHES.count == chain + 1
    cpu = dataclasses.replace(idx.two_level, device=torch.device("cpu"))
    dc, ic, wc = cpu.search(queries, 10, nprobe=8)
    assert (i == ic).mean() >= 0.99 and w == wc
    lsh = lsh_build(db, 96, seed=0)
    before = hamming.LAUNCHES.count
    _, li = lsh_search(lsh, db, queries, 10, n_candidates=256)
    assert hamming.LAUNCHES.count == before + 1
    _, lc = lsh_search(lsh, db, queries, 10, n_candidates=256, device="cpu")
    assert (li == lc).mean() >= 0.99


LARGE_KS = (33, 64, 65, 100)


def _passes(k: int, kmax: int = 32) -> int:
    return -(-k // kmax)


@pytest.mark.parametrize("k", LARGE_KS)
def test_bounded_kernels_at_large_k_match_plain(dev, k):
    """Every kernel with a list ceiling, above it: two query tiles over
    several splits, about half the rows live; ceil(k / KMAX) counted
    launches a call (KMAX_PQ for PQ); BM25 on distinct-term slabs and PQ
    bit for bit, the hybrid by its two halves.  Down to rank 100 of a few
    thousand rows two neighbours' distances may agree within the rounding
    of the two sums, so ids may differ where the distances agree within
    the tolerance (as ``chip_smoke.compare`` allows); a pair a pass misses
    or repeats changes a distance past it."""
    o = option_edge_operands(("large k", 70, 3000, 128, k, "half"), False)
    q, x, qt, qw, terms, tf, v = (
        torch.as_tensor(o[n], device=dev)
        for n in ("q", "x", "qt", "qw", "terms", "tf", "valid"))
    B = q.shape[0]
    qn = (q * q).sum(1)[:, None].cpu().numpy()
    scale = qn + float((x * x).sum(1).max())

    def counted(counter, passes, fn):
        """``fn()``, asserting it made ``passes`` counted launches."""
        before = counter.count
        out = fn()
        assert counter.count == before + passes, counter.name
        return out

    _close_near_ties(*counted(l2_topk.LAUNCHES, _passes(k),
                    lambda: l2_topk.l2_topk(q, x, k, valid=v)),
           *ref.l2_topk_ref(q, x, k, valid=v), scale)
    codes, scales = (torch.as_tensor(a, device=dev)
                     for a in ops.quantize_rows_int8(o["x"]))
    deq = codes.float() * scales[:, None]
    _close_near_ties(*counted(l2_topk.INT8_LAUNCHES, _passes(k),
                    lambda: l2_topk.l2_topk_int8(q, codes, scales, k,
                                                 valid=v)),
           *ref.l2_topk_int8_ref(q, codes, scales, k, valid=v),
           qn + float((deq * deq).sum(1).max()))
    _bitwise(*counted(bm25.LAUNCHES, _passes(k),
                      lambda: bm25.bm25_topk(qt, qw, terms, tf, k, valid=v)),
             *ref.bm25_topk_ref(qt, qw, terms, tf, k, valid=v))
    a = torch.full((1, 1), 0.5, device=dev)
    hd, hi = counted(bm25.HYBRID_LAUNCHES, _passes(k),
                     lambda: bm25.hybrid_topk(q, x, qt, qw, terms, tf, a, k,
                                              valid=v))
    _close_near_ties(hd, hi, *ref.hybrid_topk_ref(q, x, qt, qw, terms, tf, a,
                                                  k, valid=v),
                     0.5 * scale + 1.0)
    assert hybrid_by_parts(q, x, qt, qw, terms, tf, 0.5, hd,
                           hi)["mismatches"] == 0

    # the candidate tile with a carried best of k pairs
    rng = np.random.default_rng([k, 1])
    C = 300
    vecs = torch.as_tensor(rng.normal(size=(B, C, 128)).astype(np.float32),
                           device=dev)
    ids = torch.as_tensor(np.where(rng.random((B, C)) > .3,
                                   rng.permutation(5000)[:C], -1)
                          .astype(np.int32), device=dev)
    best_d = torch.as_tensor(np.sort(rng.random((B, k)).astype(np.float32)
                                     * 200 + 180, axis=1), device=dev)
    best_i = torch.as_tensor(rng.integers(10000, 20000, size=(B, k))
                             .astype(np.int32), device=dev)
    cscale = ((q * q).sum(1) + (vecs * vecs).sum(-1).amax(1))[:, None]
    _close_near_ties(*counted(bucket_topk.LAUNCHES, _passes(k),
                    lambda: bucket_topk.candidate_topk(
                        q, vecs, ids, k, best_d=best_d, best_i=best_i)),
           *ref.candidate_topk_ref(q, vecs, ids, k, best_d=best_d,
                                   best_i=best_i), cscale.cpu().numpy())
    # the probe chain over disjoint buckets
    ch = chain_edge_operands(("large k", B, 6, 40, 30, 128, k, "mid"))
    cq, cdb, cbids, cprobe = (torch.as_tensor(ch[n], device=dev) for n in (
        "q", "db", "bucket_ids", "probe"))
    _close_near_ties(*counted(bucket_topk.LAUNCHES, _passes(k),
                    lambda: bucket_topk.bucket_probe_topk(cq, cprobe, cbids,
                                                          k, db=cdb)),
           *ref.bucket_probe_topk_ref(cq, cprobe, cbids, k, db=cdb),
           ((cq * cq).sum(1) + (cdb * cdb).sum(1).max())[:, None]
           .cpu().numpy())
    # PQ: passes of 64
    lut, pcodes, pvalid, _ = (
        None if a_ is None else torch.as_tensor(a_, device=dev)
        if isinstance(a_, np.ndarray) else a_
        for a_ in pq_edge_operands(("large k", B, 3000, 8, k, "half")))
    _bitwise(*counted(pq_adc.LAUNCHES, _passes(k, 64),
                      lambda: pq_adc.pq_adc_topk(lut, pcodes, k,
                                                 valid=pvalid)),
             *ref.pq_adc_topk_ref(lut, pcodes, k, valid=pvalid))


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("repeat", [False, True],
                         ids=["distinct", "repeated_terms"])
def test_hybrid_limits_equal_bm25_and_l2(dev, repeat, k):
    """alpha = 1 is the fp32 L2 kernel's answer bit for bit (the same d2),
    alpha = 0 the BM25 kernel's (by value: an unmatched row is 0 d2 - 0,
    +0.0 or -0.0), over two query tiles and several splits, above KMAX
    too."""
    o = option_edge_operands(("limits", 70, 5000, 128, k, "half"), repeat)
    q, x, qt, qw, terms, tf, v = (
        torch.as_tensor(o[n], device=dev)
        for n in ("q", "x", "qt", "qw", "terms", "tf", "valid"))
    one = torch.ones((1, 1), device=dev)
    hd, hi = bm25.hybrid_topk(q, x, qt, qw, terms, tf, one, k, valid=v)
    ld, li = l2_topk.l2_topk(q, x, k, valid=v)
    torch.cuda.synchronize()
    assert torch.equal(hi, li)
    assert torch.equal(hd.view(torch.int32), ld.view(torch.int32))
    hd, hi = bm25.hybrid_topk(q, x, qt, qw, terms, tf, 0.0 * one, k, valid=v)
    bd, bi = bm25.bm25_topk(qt, qw, terms, tf, k, valid=v)
    torch.cuda.synchronize()
    assert torch.equal(hi, bi) and torch.equal(hd, bd)


@pytest.mark.parametrize("k", [10, 100])
def test_l2_topk_wide_rows(dev, k):
    """d = 960 (the staged chunks carry any d; the old tile refused d above
    512), with dead rows and N not a multiple of the tile; and d = 13, the
    4-byte copies' path."""
    for b, n, d in ((9, 2000, 960), (5, 700, 13)):
        rng = np.random.default_rng([d, k])
        q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                            device=dev)
        x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                            device=dev)
        v = torch.as_tensor((rng.random(n) > .2).astype(np.int32), device=dev)
        scale = ((q * q).sum(1)[:, None] + (x * x).sum(1).max()).cpu().numpy()
        _close(*l2_topk.l2_topk(q, x, k, valid=v),
               *ref.l2_topk_ref(q, x, k, valid=v), scale)


def test_tile_shared_memory_matches_the_host_layout(dev):
    """The launcher's layout of the tile (fp32, hybrid, int8 rows) equals
    the host's mirror (``l2_topk.tile_smem_bytes``, which the CPU layout
    tests hold under the block limit)."""
    lib = l2_topk.library()
    for t in (1, 4, 8, 16, 64):
        bits = 1
        while (1 << bits) < 2 * 64 * t and bits < l2_topk.DICT_BITS_MAX:
            bits += 1
        assert lib.l2_tile_smem_bytes(1, t, bits) == \
            l2_topk.tile_smem_bytes("hybrid", t)
    assert lib.l2_tile_smem_bytes(0, 0, 0) == l2_topk.tile_smem_bytes("f32")
    assert lib.l2_tile_smem_bytes(2, 0, 0) == l2_topk.tile_smem_bytes("int8")


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("b, n, d", [(5, 700, 13), (9, 2000, 640),
                                     (9, 2000, 1000), (70, 3000, 128)],
                         ids=["d=13", "d=640", "d=1000", "d=128"])
def test_l2_topk_int8_any_d(dev, b, n, d, k):
    """The int8 rows on the tile loop: d = 640 and 1,000 (the first loop
    refused d above 512), d = 13 and 1,000 through the byte copies (d not
    a multiple of 16), two query tiles at d = 128; dead rows, k within
    one list and above it; ids equal, distances within REL."""
    rng = np.random.default_rng([d, k])
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev)
    codes, scales = (torch.as_tensor(a, device=dev) for a in
                     ops.quantize_rows_int8(
                         rng.normal(size=(n, d)).astype(np.float32)))
    v = torch.as_tensor((rng.random(n) > .2).astype(np.int32), device=dev)
    deq = codes.float() * scales[:, None]
    scale = ((q * q).sum(1)[:, None] + (deq * deq).sum(1).max()).cpu().numpy()
    before = l2_topk.INT8_LAUNCHES.count
    kd, ki = l2_topk.l2_topk_int8(q, codes, scales, k, valid=v)
    assert l2_topk.INT8_LAUNCHES.count == before + _passes(k)
    _close(kd, ki, *ref.l2_topk_int8_ref(q, codes, scales, k, valid=v),
           scale)


def test_int8_backend_serves_wide_rows(dev):
    """A brute int8 backend over d = 640 rows answers on the card as on
    the CPU (the same quantized codes, the plain version there)."""
    rng = np.random.default_rng(640)
    db = rng.normal(size=(3000, 640)).astype(np.float32)
    queries = (db[:16] + 0.1 * rng.normal(size=(16, 640))).astype(np.float32)
    card = ShardedSearchBackend(db, kind="brute", k=10, precision="int8")
    cpu = ShardedSearchBackend(db, kind="brute", k=10, precision="int8",
                               device="cpu")
    before = l2_topk.INT8_LAUNCHES.count
    got, want = card(queries), cpu(queries)
    assert l2_topk.INT8_LAUNCHES.count > before
    codes, scales = ops.quantize_rows_int8(db)
    deq = codes.astype(np.float64) * scales[:, None]
    scale = ((queries.astype(np.float64) ** 2).sum(1)[:, None]
             + (deq * deq).sum(1).max())
    _close(*(torch.as_tensor(a) for a in (*got, *want)), scale)
    assert (np.asarray(got[1])[:, 0] == np.arange(16)).all()


def _hamming_case(w, b, n, seed, ties=False):
    rng = np.random.default_rng([w, b, n, seed])
    q = rng.integers(-2**31, 2**31, size=(b, w)).astype(np.int32)
    codes = rng.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)
    if ties:
        codes[:] = codes[0]
    valid = (rng.random(n) > 0.3).astype(np.int32)
    return q, codes, valid


@pytest.mark.parametrize("b", [1, 33, 1024])
@pytest.mark.parametrize("w", list(range(1, 9)))
def test_hamming_topk_every_word_count_and_batch(dev, w, b):
    """W = 1 .. 8 at B = 1, 33 (a group of 32 and one of 1) and 1,024,
    over several splits with dead rows, at k = 1, at the running count
    that ends query 0's threshold bin (and one past it) and at k = N:
    bit for bit the plain version."""
    n = 6000 if b == 1024 else 20000
    q, codes, valid = (torch.as_tensor(a, device=dev)
                       for a in _hamming_case(w, b, n, 0))
    d0 = ref.hamming_dists_ref(q[:1], codes)[0][valid != 0]
    cum = np.cumsum(np.bincount(d0.cpu().numpy().astype(np.int64),
                                minlength=32 * w + 1))
    edge = int(cum[np.searchsorted(cum, 50)])       # a bin's running count
    ks = [1, edge, edge + 1] + ([n] if b < 1024 else [])
    for k in ks:
        before = hamming.LAUNCHES.count
        got = hamming.hamming_topk(q, codes, k, valid=valid)
        assert hamming.LAUNCHES.count == before + 1
        _bitwise(*got, *ref.hamming_topk_ref(q, codes, k, valid=valid))


@pytest.mark.parametrize("b, ties", [(70, False), (45, True), (1, True)],
                         ids=["B=70", "B=45 all-equal codes",
                              "B=1 all-equal codes"])
def test_hamming_topk_partial_group_and_equal_codes(dev, b, ties):
    """A last query group that is partly empty (B not a multiple of 32),
    and codes all equal (one bin holds every live row, across every
    split): bit for bit the plain version, k below and above the live
    count."""
    q, codes, valid = (torch.as_tensor(a, device=dev)
                       for a in _hamming_case(3, b, 9000, 1, ties))
    live = int((valid != 0).sum())
    for k in (10, 500, live + 7):
        _bitwise(*hamming.hamming_topk(q, codes, k, valid=valid),
                 *ref.hamming_topk_ref(q, codes, k, valid=valid))
