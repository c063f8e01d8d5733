"""Card tests of the port's CUDA kernels: each kernel against its plain
version (with the hybrid alpha = 0 / 1 identities), at k up to the
lists' length and above it (the passes of ``common.topk_passes``), the
fp32 tile at d = 960 and the int8 one at d = 13, 640 and 1,000 (and an
int8 backend at d = 640), Hamming over every word count, batch shape and
threshold edge, the probe chain's two
row sources against each other and against the chain of single steps,
the tile read by row id against its plain version and the gathered
tile, the tree descent against its plain version on every edge of
``testing.DESCENT_EDGES`` (equal nodes, steps, visits and leaf
candidates) and through ``tree_search``, one small IVF serve, one small forest serve (fused against
unfused), the in-place delta applies of every kind,
one small filtered / lexical / hybrid / int8 serve and one small run of
the index layer (PQ top level, one-level LSH) through the kernels, and
the sharded backends over a world-size-1 NCCL mesh and over four gloo
ranks sharing the card (against the backends without a mesh and the
single-process shard loop, bit for bit), the count-min sketch on the card
against the CPU's (bit for bit, weighted too), and a two-cell fleet on
``cuda:0`` whose routed answers equal its backends' before and after a
fan-out; the recompile gate over the seven registered entry points on
the card, and ``roofline_report`` after a served batch; the language
models, and the recsys archs and SchNet at ``reduced()`` card against
CPU (SchNet's bf16 scatter-add within its bound), with SASRec's items
through a small two-level index at d 51, exact at full probing; one
train step of a reduced arch of each family and one CTR sparse step card
against CPU, ``save_async`` of card tensors, and a restart on the card
bit for bit.

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
from repro_torch.core.tree import tree_search as port_tree_search
from repro_torch.core.index import build_index
from repro_torch.core.lexical import build_lexical_slabs, query_operands
from repro_torch.core.lsh import lsh_build, lsh_search
from repro_torch.core.metadata import FilterSpec, MetadataTable
from repro_torch.core.protocol import IndexSpec
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.data.synthetic import make_corpus, make_queries
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import (bm25, bucket_topk, hamming, l2_topk, ops,
                                 pq_adc, ref, tree_descent)
from repro_torch.kernels.common import merge_topk
from repro_torch.serve.cell import ServingCell
from repro_torch.testing import (CHAIN_EDGES, DESCENT_EDGES, EDGE_ALPHAS,
                                 HAMMING_EDGES, OPTION_EDGES, PQ_EDGES,
                                 ROWS_EDGES, descent_edge_operands,
                                 chain_edge_operands, chain_union_topk,
                                 hamming_edge_operands, step_chain,
                                 hybrid_by_parts, lexical_scores_f32,
                                 option_edge_operands, pq_edge_operands,
                                 rows_edge_operands, rows_union_topk)

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


@pytest.mark.parametrize("k", [None, 33, 64, 100])
@pytest.mark.parametrize("case", ROWS_EDGES, ids=[c[0] for c in ROWS_EDGES])
def test_rows_entry_matches_plain(dev, case, k):
    """The tile read by row id: against its plain version (the gathered
    tile; the kernels' rule where a list repeats an id) and, bit for bit,
    against the tile entry on the gathered rows (the same arithmetic)."""
    o = rows_edge_operands(case)
    k = o["k"] if k is None else k
    q, rows, ids = (torch.as_tensor(o[n], device=dev)
                    for n in ("q", "rows", "ids"))
    kd, ki = bucket_topk.candidate_rows_topk(q, rows, ids, k)
    if case[-1] == "repeat":
        pd, pi = rows_union_topk(q, rows, ids, k)
        for row in ki.cpu().numpy():
            assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()
    else:
        pd, pi = ref.candidate_rows_topk_ref(q, rows, ids, k)
    scale = ((q.double() ** 2).sum(1)[:, None]
             + float((rows.double() ** 2).sum(1).max())).cpu().numpy() \
        if q.shape[0] else 1.0
    _close(kd, ki, pd, pi, scale)
    live = torch.where((ids >= 0) & (ids < rows.shape[0]), ids, -1)
    td, ti = bucket_topk.candidate_topk(
        q, rows[torch.clamp(live, min=0).long()].contiguous(), live, k)
    assert torch.equal(ki, ti)
    assert torch.equal(kd.view(torch.int32), td.view(torch.int32))


def test_rows_entry_rejects_what_it_cannot_take(dev):
    q = torch.zeros((2, 8), device=dev)
    rows = torch.zeros((10, 8), device=dev)
    ids = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_topk.candidate_rows_topk(q.cpu(), rows.cpu(), ids.cpu(), 3)
    with pytest.raises(TypeError):
        bucket_topk.candidate_rows_topk(q, rows, ids.long(), 3)
    with pytest.raises(ValueError):
        bucket_topk.candidate_rows_topk(q, rows[:, :4], ids, 3)
    with pytest.raises(ValueError):
        bucket_topk.candidate_rows_topk(q, rows[:0], ids, 3)


@pytest.mark.parametrize("case", DESCENT_EDGES,
                         ids=[c[0] for c in DESCENT_EDGES])
def test_tree_descent_kernel_matches_plain(dev, case):
    """One launch a call; the beam, steps, internal visits, leaf
    candidates and their counts equal the plain batch loop's on the card
    (continuous normal data: no split margin within rounding of 0)."""
    o = descent_edge_operands(case)
    arrays = o["tree"].device_arrays(dev)
    q = torch.as_tensor(o["q"], device=dev)
    roots = (None if o["roots"] is None
             else torch.as_tensor(o["roots"], device=dev))
    before = tree_descent.LAUNCHES.count
    got = tree_descent.tree_descent(arrays, q, roots=roots, **o["kw"])
    assert tree_descent.LAUNCHES.count == before + 1
    want = ref.tree_descent_ref(arrays, q, roots=roots, **o["kw"])
    for name, a, b in zip(("nodes", "steps", "visits", "cand", "n_cand"),
                          got, want):
        assert a.dtype == torch.int32 and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_tree_search_on_the_card_runs_the_kernel(dev):
    """``tree_search`` launches the descent once a call and answers as on
    the CPU (ids exactly, distances within the tolerance)."""
    o = descent_edge_operands(DESCENT_EDGES[2])
    t = o["tree"]
    before = tree_descent.LAUNCHES.count
    got = port_tree_search(t.device_arrays(dev),
                           torch.as_tensor(o["db"], device=dev),
                           torch.as_tensor(o["q"], device=dev), k=10,
                           **o["kw"])
    assert tree_descent.LAUNCHES.count == before + 1
    want = port_tree_search(t.device_arrays("cpu"), torch.as_tensor(o["db"]),
                            torch.as_tensor(o["q"]), k=10, **o["kw"])
    assert torch.equal(got.ids.cpu(), want.ids)
    for n in ("steps", "internal_visits", "candidates"):
        assert torch.equal(getattr(got, n).cpu(), getattr(want, n)), n
    ids = want.ids.numpy()
    scale = ((o["q"].astype(np.float64) ** 2).sum(1)[:, None]
             + (o["db"].astype(np.float64) ** 2).sum(1)[ids])
    assert (np.abs(got.dists.cpu().numpy() - want.dists.numpy())
            <= REL * scale).all()


def test_tree_descent_rejects_what_it_cannot_take(dev):
    o = descent_edge_operands(DESCENT_EDGES[1])
    arrays = o["tree"].device_arrays(dev)
    q = torch.as_tensor(o["q"], device=dev)
    kw = o["kw"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tree_descent.tree_descent(o["tree"].device_arrays("cpu"), q, **kw)
    with pytest.raises(ValueError, match="unknown kind"):
        tree_descent.tree_descent(arrays, q, **dict(kw, kind="ball"))
    with pytest.raises(ValueError):
        tree_descent.tree_descent(arrays, q[:, :4], **kw)
    with pytest.raises(ValueError):
        tree_descent.tree_descent(arrays, q, roots=torch.zeros(
            3, dtype=torch.int32, device=dev), **kw)
    with pytest.raises(TypeError):
        tree_descent.tree_descent(arrays, q.double(), **kw)
    with pytest.raises(ValueError, match="shared memory"):
        tree_descent.tree_descent(arrays, q, **dict(kw, beam_width=8000))


def _forest_index(dev, n=6000, d=32, k_clusters=48, seed=4):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    idx = build_two_level(db, TwoLevelConfig(
        n_clusters=k_clusters, bottom="tree", kmeans_iters=4), device=dev)
    q = (db[rng.choice(n, 40, replace=False)]
         + 0.3 * rng.normal(size=(40, d))).astype(np.float32)
    return idx, q, rng


def test_small_forest_serve_fused_matches_unfused(dev):
    """The forest kind on the card: its rerank through the rows-by-id
    entry (one launch a call) against the unfused gather; a cell over it
    answers as the backend does."""
    idx, q, _ = _forest_index(dev)
    fused = ShardedSearchBackend(idx, k=10, nprobe_local=8, beam_width=8)
    plain = ShardedSearchBackend(idx, k=10, nprobe_local=8, beam_width=8,
                                 fused=False)
    assert fused.kind == "forest"
    n0 = bucket_topk.LAUNCHES.count
    a = fused(q)
    assert bucket_topk.LAUNCHES.count == n0 + 1
    b = plain(q)
    assert (a[1] == b[1]).all()
    qn = (q.astype(np.float64) ** 2).sum(1)[:, None]
    xn = (idx.db.astype(np.float64) ** 2).sum(1)[a[1]]
    assert (np.abs(a[0] - b[0]) <= REL * (qn + xn)).all()
    d64 = ((q[:, None, :].astype(np.float64) - idx.db[a[1]]) ** 2).sum(-1)
    assert (np.abs(d64 - a[0]) <= REL * (qn + xn)).all()
    a50 = ShardedSearchBackend(idx, k=50, nprobe_local=8, beam_width=8)(q)
    assert (a50[1][:, :10] == a[1]).all()
    cell = ServingCell.sharded(idx, k=10, nprobe_local=8, beam_width=8)
    try:
        for r in range(3):
            assert (cell.search(q[r], timeout=60)[1] == a[1][r]).all()
    finally:
        cell.close()


@pytest.mark.parametrize("kind", ["forest", "ivf", "brute"])
def test_delta_apply_keeps_the_placed_storage(dev, kind):
    """A delta apply scatters into the placed tensors: every ``data_ptr``
    stays, the tables equal a full re-place's bit for bit, an added
    vector finds itself and a deleted id never returns."""
    idx, q, rng = _forest_index(dev)
    if kind == "ivf":
        idx = dataclasses.replace(
            idx, config=dataclasses.replace(idx.config, bottom="brute"),
            forest=None)
    target = idx.db if kind == "brute" else idx
    be, full = (ShardedSearchBackend(target, kind=kind, k=10,
                                     nprobe_local=8, headroom=1.5)
                for _ in range(2))
    ptrs = [t.data_ptr() for t in be._args]
    b = int(np.argmax(idx.bucket_counts))
    new = (idx.centroids[[b] * 6]
           + 0.1 * rng.normal(size=(6, idx.db.shape[1]))).astype(np.float32)
    ids = idx.add_entities(new)
    gone = idx.bucket_ids[b][:5].astype(np.int64)
    idx.delete_entities(gone)
    man = idx.pop_delta()
    if kind == "brute":
        man = dataclasses.replace(man, dirty_buckets=man.dirty_buckets[:0])
        target = idx.db
    st = be.apply_updates(target, delta=man)
    assert st["mode"] == "delta" and st["bytes"] < st["full_bytes"]
    assert [t.data_ptr() for t in be._args] == ptrs
    if kind == "brute":
        full.apply_updates(target, alive=idx.alive)
    else:
        full.apply_updates(target)
    for x, y in zip(be._args, full._args):
        assert torch.equal(x, y)
    got = be(new)[1][:, 0]
    assert (got == ids).all()
    assert not np.isin(be(idx.db[gone])[1], gone).any()
    a, c = be(q), full(q)
    assert (a[1] == c[1]).all()
    assert np.array_equal(a[0].view(np.int32), c[0].view(np.int32))



# ------------------------------------------------------------- sharded
def _sharded_data():
    rng = np.random.default_rng(19)
    c = rng.normal(size=(32, 32)) * 4
    db = (c[rng.integers(0, 32, 3000)]
          + rng.normal(size=(3000, 32))).astype(np.float32)
    q = (db[rng.choice(3000, 96, replace=False)]
         + 0.05 * rng.normal(size=(96, 32))).astype(np.float32)
    return db, q


def _sharded_kinds(db, ivf, tree):
    return {"brute": (db, dict(kind="brute")),
            "ivf": (ivf, dict(kind="ivf", nprobe_local=3)),
            "forest": (tree, dict(kind="forest", nprobe_local=3,
                                  beam_width=4))}


@pytest.fixture(scope="module")
def sharded_indexes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    db, q = _sharded_data()
    ivf = build_two_level(db, TwoLevelConfig(n_clusters=50, kmeans_iters=4))
    tree = build_two_level(db, TwoLevelConfig(n_clusters=50, kmeans_iters=4,
                                              bottom="tree", tree_leaf=8))
    return db, q, ivf, tree


@pytest.mark.parametrize("kind", ["brute", "ivf", "forest"])
def test_world1_nccl_backend_equals_no_mesh(dev, tmp_path, sharded_indexes,
                                             kind):
    """A backend over a world-size-1 NCCL mesh answers as the backend
    without a mesh, bit for bit."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    db, q, ivf, tree = sharded_indexes
    target, kw = _sharded_kinds(db, ivf, tree)[kind]
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        a = ShardedSearchBackend(target, k=10, mesh=mesh, axes=("data",),
                                 **kw)(q)
        b = ShardedSearchBackend(target, k=10, **kw)(q)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(a[1], b[1])
    assert np.array_equal(a[0].view(np.int32), b[0].view(np.int32))


def _gloo_rank(rank: int, world: int, workdir: str) -> None:
    """One of four ranks sharing the card under gloo: each kind on a
    (4,) mesh; answers pickled."""
    import datetime
    import os
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            db, q, ivf, tree = pickle.load(f)
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        out = {name: ShardedSearchBackend(target, k=10, mesh=mesh,
                                          axes=("data",), **kw)(q)
               for name, (target, kw) in _sharded_kinds(db, ivf,
                                                        tree).items()}
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_on_the_card_equal_the_shard_loop(
        dev, tmp_path, sharded_indexes):
    """Four ranks share the card under gloo (NCCL refuses two ranks on one
    device): each kind equals the single-process shard loop on the card
    bit for bit, on every rank."""
    import os
    import pickle
    import subprocess
    import sys
    import textwrap

    from repro_torch.testing import shard_backends, shard_loop

    db, q, ivf, tree = sharded_indexes
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(sharded_indexes, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here]))
    code = textwrap.dedent(f"""
        import sys
        from test_torch_gpu import _gloo_rank
        _gloo_rank(int(sys.argv[1]), 4, {str(tmp_path)!r})
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env)
             for r in range(4)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4
    for name, (target, kw) in _sharded_kinds(db, ivf, tree).items():
        loop = shard_loop(shard_backends(target, 4, k=10, **kw), q)
        for r in range(4):
            with open(tmp_path / f"rank{r}.pkl", "rb") as f:
                got = pickle.load(f)[name]
            assert np.array_equal(got[1], loop[1]), (name, r)
            assert np.array_equal(got[0].view(np.int32),
                                  loop[0].view(np.int32)), (name, r)


# ------------------------------------------------------- fleet, sketch
@pytest.mark.parametrize("weighted", [False, True])
def test_sketch_on_the_card_equals_the_cpu(dev, weighted):
    """The count-min sketch's columns, table and heavy hitters on the card
    equal the same sketch's on the CPU bit for bit (the adds to a cell run
    in batch order on both)."""
    from repro_torch.adaptive import CountMinSketch

    rng = np.random.default_rng(3)
    card, cpu = (CountMinSketch(width=1024, depth=4, topk=32, halflife=300.0,
                                seed=5, device=d) for d in (dev, "cpu"))
    ids = np.arange(2**31 - 100, 2**31)
    assert np.array_equal(card.columns(ids), cpu.columns(ids))
    p = 1.0 / np.arange(1, 501) ** 1.1
    for t in range(20):
        ids = rng.choice(500, 13 + 11 * t, p=p / p.sum())
        w = rng.random(ids.size).astype(np.float32) if weighted else None
        card.update(ids, w)
        cpu.update(ids, w)
    assert np.array_equal(card.table.cpu().numpy().view(np.int32),
                          cpu.table.numpy().view(np.int32))
    for a, b in zip(card.heavy_hitters(), cpu.heavy_hitters()):
        assert np.array_equal(a, b)
    q = np.arange(-1, 600)
    assert np.array_equal(card.query(q), cpu.query(q))


def test_two_cell_fleet_on_the_card_answers_as_its_backends(dev):
    """Two cells on ``cuda:0``, each its own IVF placement (and stream):
    every routed answer equals its cell backend's direct answer bit for
    bit, before and after an add / delete fan-out; no deleted id returns
    and every cache was invalidated once."""
    from repro_torch.adaptive import OnlineLikelihoodEstimator
    from repro_torch.serve.fleet import build_fleet

    db = make_corpus("sift", scale=0.016, seed=0)
    q = make_queries(db, 48, seed=1)
    idx = build_two_level(db, TwoLevelConfig(n_clusters=64, seed=0),
                          device=dev)
    est = OnlineLikelihoodEstimator(idx.n + 16, device=dev)
    router = build_fleet([dev, dev], idx, kind="ivf", k=10,
                         cache_capacity=64, estimator=est,
                         backend_kw=dict(nprobe_local=8, headroom=1.5),
                         cell_kw=dict(max_wait_ms=0.5))
    try:
        bes = [c.search_fn for c in router.cells]
        assert bes[0]._stream is not None and bes[0]._stream != bes[1]._stream

        def check():
            for x in q:
                d, i = router.search(x, timeout=60)
                wd, wi = router.preferred_cell(x).search_fn(x[None])
                assert np.array_equal(i, wi[0])
                assert np.array_equal(d.view(np.int32),
                                      wd[0].view(np.int32))

        before = bucket_topk.LAUNCHES.count
        check()
        check()                          # the second pass hits the caches
        assert bucket_topk.LAUNCHES.count > before
        assert router.stats().cache_hits >= len(q)
        gens = [c.cache.generation for c in router.cells]
        b = int(np.argmax(idx.bucket_counts))
        new = (idx.centroids[[b] * 16] + 0.1 * np.random.default_rng(2)
               .normal(size=(16, db.shape[1]))).astype(np.float32)
        added = idx.add_entities(new)
        gone = idx.bucket_ids[b][:8].astype(np.int64)
        idx.delete_entities(gone)
        agg = router.apply_updates(idx)
        assert agg["mode"] == "delta"
        assert [c.cache.generation for c in router.cells] == [g + 1
                                                              for g in gens]
        check()
        got = np.stack([router.search(x, timeout=60)[1] for x in new])
        assert (got[:, 0] == added).all()
        assert not np.isin(np.stack([router.search(x, timeout=60)[1]
                                     for x in db[gone]]), gone).any()
        assert est.n_total > 0
    finally:
        router.close()


def test_recompile_gate_on_the_card_finds_nothing(dev):
    """The seven registered entry points, their backends on the card:
    no step after the warm-up mints a compiled variant, and none fails."""
    from repro_torch.analysis.recompile import run_recompile_gate
    from repro_torch.analysis.registry import ENTRY_POINTS

    assert len(ENTRY_POINTS) == 7
    found = run_recompile_gate(device=dev)
    assert found == [], "\n".join(f.format() for f in found)


def test_roofline_report_after_a_served_batch(dev):
    """A brute backend on the card answers one served batch of 64; its
    report's measured useful-byte share of the H100's 3.35 TB/s is a
    possible reading: above 0, at most 1.05."""
    db = make_corpus("sift", scale=0.2, seed=0)
    q = make_queries(db, 64, seed=1)
    be = ShardedSearchBackend(db, kind="brute", k=10, device=dev)
    cell = ServingCell(be, max_batch=64, max_wait_ms=5.0)
    try:
        futs = [cell.submit(x) for x in q]
        for f in futs:
            f.get(timeout=60)
    finally:
        cell.close()
    rep = be.roofline_report(b=64, peak_bw=3.35e12)
    assert rep["useful_bytes"] == db.shape[0] * db.shape[1] * 4.0
    assert 0 < rep["measured_frac"] <= 1.05, rep
    assert be.metrics.counter("compile_signatures").value >= 1
    assert be.metrics.get("first_call_ms").count >= 1


# ---------------------------------------------------------------------------
# the language models (plain torch on the card; no kernel of their own)
# ---------------------------------------------------------------------------

LM_ARCHS = ["qwen3-0.6b", "qwen3-14b", "granite-34b", "deepseek-v3-671b",
            "kimi-k2-1t-a32b"]
LM_TOL = dict(rtol=1e-4, atol=1e-4)


def _lm_cfg(arch):
    from repro_torch.configs.registry import get_arch

    cfg = dataclasses.replace(get_arch(arch)[0].reduced(),
                              residual_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_card_equals_cpu(dev, arch):
    """Each reduced arch at the fp32 policy (no TF32): ``loss_fn``,
    ``prefill`` and one ``decode_step`` on the card against the CPU on the
    same weights, rtol / atol 1e-4, argmax equal; the decode cache too."""
    from repro_torch.data.lm import LMStream
    from repro_torch.device import require_fp32_matmul
    from repro_torch.models import transformer as T
    from repro_torch.models.base import tree_map

    cfg = _lm_cfg(arch)
    require_fp32_matmul()
    T.set_precision(torch.float32, torch.float32)
    try:
        pc = T.init(cfg, seed=0, device=dev)
        pcpu = tree_map(lambda t: t.cpu(), pc)
        batch = LMStream(cfg.vocab, 16, 2, seed=0).batch_at(0)
        toks = batch["tokens"]
        res = {}
        for name, p in (("card", pc), ("cpu", pcpu)):
            loss, _ = T.loss_fn(p, batch, cfg)
            logits, cache = T.prefill(p, toks[:, :8], cfg, max_len=12)
            pre = {k: v.cpu().clone() for k, v in cache.items()}
            dlog, cache = T.decode_step(p, cache, toks[:, 8:9], cfg)
            res[name] = (loss.cpu(), logits.cpu(), pre, dlog.cpu(),
                         {k: v.cpu() for k, v in cache.items()})
        (lc, gc, pc_, dc, cc), (lp, gp, pp_, dp, cp) = res["card"], res["cpu"]
        torch.testing.assert_close(lc, lp, **LM_TOL)
        for a, b in ((gc, gp), (dc, dp)):
            torch.testing.assert_close(a, b, **LM_TOL)
            assert torch.equal(a.argmax(-1), b.argmax(-1))
        for k in cc:
            torch.testing.assert_close(pc_[k], pp_[k], **LM_TOL)
            torch.testing.assert_close(cc[k], cp[k], **LM_TOL)
    finally:
        T.set_precision()


def test_lm_decode_cache_write_equals_one_hot(dev):
    """The decode step's indexed cache write against the reference's
    one-hot select over the whole cache (``jnp.where(arange(S) ==
    lengths, new, cache)``), bit for bit, rows of different lengths."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(_lm_cfg("qwen3-0.6b"), moe=None)
    p = T.init(cfg, seed=3, device=dev)
    toks = torch.randint(0, cfg.vocab, (3, 6), device=dev)
    _, cache = T.prefill(p, toks, cfg, max_len=9)
    cache["lengths"] = torch.tensor([6, 2, 8], dtype=torch.int32,
                                    device=dev)
    before = {k: v.clone() for k, v in cache.items()}
    _, after = T.decode_step(p, cache, toks[:, :1], cfg)
    pos = (torch.arange(9, device=dev)[None, :]
           == before["lengths"][:, None].long())          # (B, S)
    for k in ("k", "v"):
        new = after[k][:, torch.arange(3, device=dev),
                       before["lengths"].long()]          # (L, B, H, dh)
        want = torch.where(pos[None, :, :, None, None], new[:, :, None],
                           before[k])
        assert torch.equal(after[k], want)
    assert after["lengths"].tolist() == [7, 3, 9]


def test_constrain_raises_under_a_bound_mesh(dev, tmp_path):
    """``ShardPlan.constrain`` is the identity with no mesh; under a real
    (world-1 NCCL) mesh it raises ``TypeError`` on a plain tensor and
    returns a DTensor with the requested placements and the same whole
    value."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import SINGLE_POD_PLAN, whole

    x = torch.arange(16.0, device=dev).reshape(4, 4)
    assert SINGLE_POD_PLAN.constrain(x, "dp", "tp") is x
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        plan = SINGLE_POD_PLAN.with_mesh(mesh)
        with pytest.raises(TypeError, match="plain"):
            plan.constrain(x, "dp", "tp")
        d = plan.distribute(x, None, None)
        for dims, want in (((("dp", "tp"), None), (Shard(0), Shard(0))),
                           (("tp", "dp"), (Shard(1), Shard(0))),
                           ((None, None), (Replicate(), Replicate()))):
            y = plan.constrain(d, *dims)
            assert isinstance(y, DTensor) and y.placements == want
            assert y.to_local().device.type == "cuda"
            assert torch.equal(whole(y), x)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world1_cells(tmp_path_factory):
    """Every case of ``test_torch_sharded_models`` through the port's
    cells on a world-1 NCCL ``(1, 1)`` mesh on the card, and with no mesh
    on the CPU (a sharded checkpoint saved and restored on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the world-1 mesh is an NCCL group")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import LOCAL_PLAN, SINGLE_POD_PLAN
    from test_torch_sharded_models import _run_cases

    d = tmp_path_factory.mktemp("world1")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(d / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        card = _run_cases(SINGLE_POD_PLAN.with_mesh(mesh), "cuda",
                          str(d / "ckpt"))
    finally:
        dist.destroy_process_group()
    return card, _run_cases(LOCAL_PLAN, "cpu")


@pytest.mark.parametrize("name", ["qwen3", "deepseek", "dlrm", "dcn",
                                  "schnet_molecule", "schnet_graph"])
def test_sharded_cells_on_a_world1_mesh_equal_the_cpu(world1_cells, name):
    """The cells at ``reduced()`` over a world-1 mesh on the card against
    the same cells with no mesh on the CPU (fp32; 1e-4 of each leaf's
    max, argmax equal)."""
    from test_torch_sharded_models import _close_leaves, _leaves

    card, cpu = world1_cells
    a, b = card[name], cpu[name]
    if name.startswith("schnet"):
        a, b = a["float32"], b["float32"]
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if "restored" in path or "saved" in path:
            continue
        if "logits" in path:
            assert np.array_equal(np.asarray(x).argmax(-1),
                                  np.asarray(y).argmax(-1)), path
    _close_leaves({k: v for k, v in a.items()
                   if k not in ("restored", "saved")},
                  {k: v for k, v in b.items()
                   if k not in ("restored", "saved")})
    if name == "qwen3":
        from test_torch_sharded_models import _bits
        _bits(a["restored"], a["saved"])


# ---------------------------------------------------------------------------
# the recsys and GNN models (plain torch on the card; the SASRec retrieval
# through the two-level index runs the probe chain's kernel)
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ["dlrm-mlperf", "dcn-v2", "din", "sasrec"]
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_L2 = 2 ** -4


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_card_equals_cpu(dev, arch, monkeypatch):
    """Each recsys arch at ``reduced()`` on the card against the CPU on the
    same weights (no TF32): ``serve_logits``, ``loss_fn`` and
    ``retrieval_logits`` (k 16 of 256 in chunks of 100, ids equal), rtol /
    atol 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import batch_for, retrieval_batch, serve_batch
    from repro_torch.device import require_fp32_matmul
    from repro_torch.models import recsys as R
    from repro_torch.models.base import tree_map

    cfg = get_arch(arch)[0].reduced()
    require_fp32_matmul()
    monkeypatch.setattr(R, "RETRIEVAL_CHUNK", 100)
    pc = R.init(cfg, seed=0, device=dev)
    pcpu = tree_map(lambda t: t.cpu(), pc)
    batch = batch_for(cfg, 16, 0)
    serve, rb = serve_batch(cfg, batch), retrieval_batch(cfg, batch, 256)
    res = {}
    for name, p in (("card", pc), ("cpu", pcpu)):
        s = R.serve_logits(p, serve, cfg)
        loss, aux = R.loss_fn(p, batch, cfg)
        top, ids = R.retrieval_logits(p, rb, cfg, k=16)
        res[name] = [t.cpu() for t in (s, loss, aux["loss"], top, ids)]
    (sc, lc, ac, tc, ic), (sp, lp, ap, tp, ip) = res["card"], res["cpu"]
    assert sc.device.type == "cpu" and tuple(sc.shape) == (16,)
    for a, b in ((sc, sp), (lc, lp), (ac, ap), (tc, tp)):
        torch.testing.assert_close(a, b, **MODEL_TOL)
    assert torch.equal(ic, ip)


def _schnet_batches():
    from repro_torch.data.graph import (NeighborSampler, make_graph,
                                        molecule_batch, pad_edges)

    g = make_graph(600, 4000, 12, n_classes=4, seed=0)
    snd, rcv = g.edge_list()
    full = {"feats": g.feats, "pos": g.pos, "senders": snd,
            "receivers": rcv, "labels": g.labels}
    sub = pad_edges(NeighborSampler(g, (4, 3), seed=0).sample(
        np.arange(32)), 800, 2048)
    sampled = {k: sub[k] for k in ("feats", "pos", "senders", "receivers",
                                   "labels", "node_mask")}
    return {"full": full, "sampled": sampled,
            "molecule": molecule_batch(8, 12, 40, 12, step=0)}


@pytest.mark.parametrize("message_dtype", ["float32", "bfloat16"])
def test_schnet_card_equals_cpu(dev, message_dtype):
    """SchNet at ``reduced()`` on the three batch kinds, card against CPU on
    the same weights.  fp32 messages: ``forward`` and ``loss_fn`` to rtol /
    atol 1e-4 (the card's ``index_add_`` adds in no fixed order).  bf16
    messages: the scatter-add's atomics accumulate in bf16, so the node
    states are held to a relative L2 error of 2**-4 (the CPU tests' bf16
    bound) and the loss to rtol 1e-2."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import require_fp32_matmul
    from repro_torch.models import schnet as S
    from repro_torch.models.base import tree_map
    from repro_torch.testing import message_dtypes

    cfg = dataclasses.replace(get_arch("schnet")[0].reduced(), d_feat=12,
                              n_out=4, message_dtype=message_dtype)
    require_fp32_matmul()
    pc = S.init(cfg, seed=0, device=dev)
    pcpu = tree_map(lambda t: t.cpu(), pc)
    for kind, batch in _schnet_batches().items():
        with message_dtypes() as sums:
            hc = S.forward(pc, batch, cfg).cpu()
        # the bound below holds bf16 noise, not the dtype: pin the dtype
        assert sums == [getattr(torch, message_dtype)] * cfg.n_interactions
        hp = S.forward(pcpu, batch, cfg)
        lc = S.loss_fn(pc, batch, cfg)[0].cpu()
        lp = S.loss_fn(pcpu, batch, cfg)[0]
        assert hc.dtype == hp.dtype == torch.float32, kind
        assert torch.isfinite(hc).all(), kind
        if message_dtype == "float32":
            torch.testing.assert_close(hc, hp, **MODEL_TOL)
            torch.testing.assert_close(lc, lp, **MODEL_TOL)
        else:
            err = float((hc - hp).norm() / hp.norm())
            assert err <= BF16_REL_L2, (kind, err)
            torch.testing.assert_close(lc, lp, rtol=1e-2, atol=1e-2)


def test_sasrec_retrieval_through_two_level_index_d51(dev):
    """SASRec's items at full width (d 50, MIPS-augmented to 51, a width
    that is not a multiple of four) through ``build_two_level`` (brute top,
    brute bottom: the probe chain's kernel), held against the plain chain
    on the same probe lists; probing every bucket, the answers equal the
    exact ``retrieval_logits`` top-10 on at least 0.99 of the slots and
    every other slot is a float64 near-tie."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import sasrec_batch
    from repro_torch.device import require_fp32_matmul
    from repro_torch.kernels.common import LAUNCH_COUNTERS
    from repro_torch.models import recsys as R
    from repro_torch.testing import mips_parity, sasrec_mips_truth

    cfg = dataclasses.replace(get_arch("sasrec")[0], n_items=20_000)
    require_fp32_matmul()
    params = R.init(cfg, seed=0, device=dev)
    seq = sasrec_batch(cfg, 16, 0)["seq"]
    users, exact, items = sasrec_mips_truth(params, seq, cfg)
    aug_items, aug_users, m2 = R.mips_augment(items, users)
    assert aug_items.shape[1] == 51
    idx = build_two_level(aug_items, TwoLevelConfig(
        n_clusters=64, top="brute", bottom="brute", kmeans_iters=4),
        device=dev)
    counter = LAUNCH_COUNTERS["candidate_topk"]
    n0 = counter.count
    dist, ann, work = idx.search(aug_users, 10, nprobe=64)
    assert counter.count > n0
    assert work["candidates"] == seq.shape[0] * cfg.n_items
    # the search's own answer against the plain chain on its probe lists
    t = idx._tables(dev)
    q = torch.as_tensor(aug_users, device=dev)
    probe, _ = idx._top_probe(t, q, 64)
    pd, pi = ref.bucket_probe_topk_ref(q, probe, t["bucket_ids"], 10,
                                       db=t["db"])
    scale = ((q * q).sum(1) + (t["db"] * t["db"]).sum(1).max())[:, None]
    _close_near_ties(torch.as_tensor(dist), torch.as_tensor(ann), pd, pi,
                     scale.cpu().numpy())
    res = mips_parity(ann, exact, users, items, m2)
    assert res["match"] >= 0.99 and res["bad"] == 0, res
    assert res["repeats"] == 0, res


# ---------------------------------------------------------------------------
# training (plain torch on the card: the reference's training path reaches
# no Pallas kernel)
# ---------------------------------------------------------------------------

# a train step card against CPU: rtol 1e-4 and an atol of 1e-4 of each
# leaf's max abs, never below 1e-9 (DIN's attention-MLP output bias has a
# gradient of exactly zero, softmax being shift invariant: both sides
# return rounding noise there)
TRAIN_TOL = dict(rtol=1e-4, atol_of_max=1e-4, atol_floor=1e-9)


def _train_family(arch):
    """(cfg, params on the CPU, loss_fn, batch_at) of a reduced arch of
    ``arch``'s family at the fp32 policy."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.data.recsys import batch_for
    from repro_torch.models import recsys as R
    from repro_torch.models import schnet as S
    from repro_torch.models import transformer as T

    cfg, family = get_arch(arch)
    if family == "lm":
        cfg = _lm_cfg(arch)
        stream = LMStream(cfg.vocab, 16, 2, seed=0)
        return (T.init(cfg, seed=0, device="cpu"),
                lambda p, b: T.loss_fn(p, b, cfg), stream.batch_at)
    if family == "recsys":
        cfg = cfg.reduced()
        return (R.init(cfg, seed=0, device="cpu"),
                lambda p, b: R.loss_fn(p, b, cfg),
                lambda i: batch_for(cfg, 16, i))
    cfg = dataclasses.replace(cfg.reduced(), d_feat=12, n_out=4)
    batch = _schnet_batches()["full"]
    return (S.init(cfg, seed=0, device="cpu"),
            lambda p, b: S.loss_fn(p, b, cfg), lambda i: batch)


def _close_leaves(a_tree, b_tree, rtol, atol_of_max, atol_floor=0.0):
    from repro_torch.train.checkpoint import leaf_paths

    b = dict(leaf_paths(b_tree))
    for name, x in leaf_paths(a_tree):
        y = b[name].cpu().float()
        atol = max(atol_of_max * float(y.abs().max()) if y.numel() else 0.0,
                   atol_floor)
        torch.testing.assert_close(x.cpu().float(), y, rtol=rtol, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b", "din",
                                  "schnet"])
def test_train_step_card_equals_cpu(dev, arch):
    """A reduced arch of each family (and the MoE + MLA + MTP LM) at the
    fp32 policy: two SGD-M steps on the CPU, the state copied to the card,
    then one step on each side from it: params, momentum and the aux
    values to ``TRAIN_TOL`` (the CPU tests' gradient tolerance).  SGD is
    linear in the gradient; AdamW would turn the rounding noise of DIN's
    zero gradient into a full step of either sign (its card step is held
    in the smoke's ``train`` phase)."""
    from repro_torch.device import require_fp32_matmul
    from repro_torch.models import transformer as T
    from repro_torch.train import optim
    from repro_torch.models.base import tree_map
    from repro_torch.train.loop import TrainState, init_state, make_train_step

    require_fp32_matmul()
    T.set_precision(torch.float32, torch.float32)
    try:
        params, loss, batch_at = _train_family(arch)
        opt = optim.sgd(optim.constant_lr(1e-2))
        step = make_train_step(loss, opt)
        st = init_state(params, opt)
        for i in range(2):
            st, _ = step(st, batch_at(i))
        card = TrainState(step=st.step.to(dev),
                          params=tree_map(lambda t: t.to(dev), st.params),
                          opt_state=tree_map(lambda t: t.to(dev),
                                             st.opt_state))
        cpu_new, cpu_aux = step(st, batch_at(2))
        card_new, card_aux = step(card, batch_at(2))
    finally:
        T.set_precision()
    from repro_torch.train.tree import leaves

    assert all(t.device.type == "cuda" for t in leaves(card_new.params))
    assert int(card_new.step) == 3 and card_new.step.device.type == "cuda"
    for k in cpu_aux:
        torch.testing.assert_close(card_aux[k].cpu(), cpu_aux[k],
                                   rtol=1e-4, atol=1e-6, msg=k)
    _close_leaves(card_new.params, cpu_new.params, **TRAIN_TOL)
    _close_leaves(card_new.opt_state, cpu_new.opt_state, **TRAIN_TOL)


def test_sparse_step_card_equals_cpu(dev):
    """DLRM at ``reduced()`` in fp32: one sparse step (row-wise AdaGrad
    through ``index_add_``, atomics on the card) from the same state on
    both sides; the table, the accumulator and the dense params to rtol /
    atol 1e-5 of each leaf's max."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import batch_for
    from repro_torch.device import require_fp32_matmul
    from repro_torch.distributed.sharding import LOCAL_PLAN
    from repro_torch.models import recsys as R
    from repro_torch.models.base import tree_map
    from repro_torch.train import optim
    from repro_torch.train.sparse_embed import make_ctr_sparse_train_step

    require_fp32_matmul()
    cfg = get_arch("dlrm-mlperf")[0].reduced()
    init, step = make_ctr_sparse_train_step(
        cfg, LOCAL_PLAN, optim.adamw(optim.constant_lr(1e-3)))
    params = R.init(cfg, seed=0, device="cpu")
    cpu = init(params)
    card = init(tree_map(lambda t: t.to(dev), params))
    batch = batch_for(cfg, 64, 0)
    cpu, _ = step(cpu, batch)
    card, _ = step(card, batch)
    assert card.params["table"].device.type == "cuda"
    _close_leaves(card.params, cpu.params, rtol=1e-5, atol_of_max=1e-5)
    _close_leaves(card.opt_state, cpu.opt_state, rtol=1e-5,
                  atol_of_max=1e-5)


def test_save_async_on_the_card_snapshots_at_the_call(dev, tmp_path):
    """``save_async`` copies the card's tensors to the host before it
    returns: the next sparse step updates the table in place, and the
    checkpoint still holds the table of the call, bit for bit."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import batch_for
    from repro_torch.distributed.sharding import LOCAL_PLAN
    from repro_torch.models import recsys as R
    from repro_torch.train import checkpoint as C
    from repro_torch.train import optim
    from repro_torch.train.sparse_embed import make_ctr_sparse_train_step

    cfg = get_arch("dcn-v2")[0].reduced()
    init, step = make_ctr_sparse_train_step(
        cfg, LOCAL_PLAN, optim.sgd(optim.constant_lr(1e-2)))
    st = init(R.init(cfg, seed=0, device=dev))
    st, _ = step(st, batch_for(cfg, 64, 0))
    at_call = st.params["table"].clone()
    C.save_async(str(tmp_path), 1, st)
    st2, _ = step(st, batch_for(cfg, 64, 1))
    assert st2.params["table"] is st.params["table"]        # in place
    assert not torch.equal(st2.params["table"], at_call)
    C.wait_pending()
    got = C.restore(str(tmp_path), 1, st)
    assert got.params["table"].device.type == "cuda"
    assert torch.equal(got.params["table"], at_call)


def test_restart_on_the_card_is_bit_for_bit(dev, tmp_path):
    """qwen3-0.6b at ``reduced()`` with remat and the chunked attention
    (bf16 policy): 4 steps with a checkpoint at 2, then step 2 restored
    and replayed; every param equals the uninterrupted run's bit for
    bit."""
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as C
    from repro_torch.train import optim
    from repro_torch.train.loop import init_state, make_train_step, train
    from repro_torch.train.tree import leaves

    cfg = dataclasses.replace(_lm_cfg("qwen3-0.6b"), remat=True,
                              attn_chunk=8)
    stream = LMStream(cfg.vocab, 32, 2, seed=0)
    opt = optim.adamw(optim.constant_lr(1e-3))
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)

    def fresh():
        return init_state(T.init(cfg, seed=0, device=dev), opt)

    d = str(tmp_path)
    full = train(fresh(), step, stream.batch_at, 4, ckpt_dir=d,
                 ckpt_every=2, ckpt_async=False)
    again = train(C.restore(d, 2, fresh()), step, stream.batch_at, 4)
    for a, b in zip(leaves(full.state.params), leaves(again.state.params)):
        assert torch.equal(a, b)
