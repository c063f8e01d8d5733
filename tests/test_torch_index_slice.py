"""The paper's index layer on the CPU, held against the reference.

Kernels: the port's plain ``pq_adc_topk_ref`` and ``hamming_topk_ref``
(what the port runs for a CPU tensor, and what ``chip_smoke.py`` holds
the CUDA kernels against) are compared with the reference's jnp oracles
and its Pallas kernels in interpret mode on the edge shapes.

Builds: the tree, QLBT and kd builders, ``pack_bits`` / ``lsh_build``, the
likelihood tools and the §5.3 protocol are numpy copies, so their arrays
and decisions must EQUAL the reference's.  ``pq_train`` runs k-means on
the device and is held by invariants.

Search: structures built by the reference are carried across with
``convert`` (numpy arrays only), so both packages search the same trees,
codes and buckets; ids must be equal and the work counters too.  The
slice as a whole (build from raw data in both packages) is held by
recall against exact search, since the k-means steps round differently.

Tolerance: ids exactly, Hamming distances exactly (whole numbers); PQ-ADC
distances to rtol=1e-6 (the reference's jnp oracle sums the M LUT entries
in an order XLA picks, the port in order); search distances to rtol=1e-5
plus atol=1e-4, because XLA-CPU and torch-CPU fp32 products round
differently.  Parity inputs are continuous normal data, whose neighbours,
split margins and sign bits are never tied to within that rounding.
"""
from __future__ import annotations

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import (TREE_ARRAYS, index_from_arrays,
                                 tree_from_arrays)
from repro_torch.core import likelihood as port_lik
from repro_torch.core import tree as port_tree
from repro_torch.core.brute import brute_search
from repro_torch.core.index import SearchIndex, auto_build_index, build_index
from repro_torch.core.lsh import LSHIndex, lsh_build, lsh_search, pack_bits
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.pq import ProductQuantizer, pq_search, pq_train
from repro_torch.core.protocol import IndexSpec, select_index_spec
from repro_torch.core.two_level import (TwoLevelConfig, _pack_bits,
                                        build_two_level)
from repro_torch.kernels import ref
from repro_torch.testing import (HAMMING_EDGES, PQ_EDGES,
                                 hamming_edge_operands, pq_edge_operands)

RTOL, ATOL = 1e-5, 1e-4
PQ_RTOL = 1e-6
# interpret mode walks the Pallas grid step by step (and the merge unrolls
# k steps): the kernels run there on the small edges, the jnp oracles on
# all of them
PALLAS_MAX = 50_000
N, D, K_BUCKETS, B, K = 1536, 16, 16, 12, 10


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _ids_equal(port_ids, ref_ids):
    pi, ri = np.asarray(port_ids), np.asarray(ref_ids)
    assert pi.shape == ri.shape
    assert (pi == ri).all(), f"{int((pi != ri).sum())} ids differ"


def _same(port, theirs, rtol=RTOL, atol=ATOL):
    (pd, pi), (td, ti) = port, theirs
    _ids_equal(pi, ti)
    np.testing.assert_allclose(np.asarray(pd), np.asarray(td), rtol=rtol,
                               atol=atol)


def _tree_arrays(t) -> dict:
    """A reference FlatTree as the numpy dict ``tree_from_arrays`` takes."""
    return {"kind": t.kind,
            **{n: np.asarray(getattr(t, n)) for n in TREE_ARRAYS}}


def _carry(ref_idx, device="cpu"):
    """A reference TwoLevelIndex carried across as numpy arrays."""
    arrays = {n: np.asarray(getattr(ref_idx, n)) for n in
              ("db", "centroids", "bucket_ids", "bucket_counts")}
    if ref_idx.p is not None:
        arrays["p"] = ref_idx.p
    if ref_idx.part_feats is not None:
        arrays["part_feats"] = ref_idx.part_feats
    if ref_idx.top_pq is not None:
        arrays["pq_codebooks"] = ref_idx.top_pq.codebooks
        arrays["pq_codes"] = ref_idx.top_pq.codes
    if ref_idx.top_kd is not None:
        arrays["kd"] = _tree_arrays(ref_idx.top_kd)
    if ref_idx.bottom_lsh is not None:
        arrays["lsh_proj"] = ref_idx.bottom_lsh.proj
        arrays["lsh_codes"] = ref_idx.bottom_lsh.codes
    if ref_idx.forest is not None:
        arrays["forest"] = [_tree_arrays(t) for t in ref_idx.forest.trees]
    return index_from_arrays(arrays, dataclasses.asdict(ref_idx.config),
                             device=device)


def _jv(valid):
    return None if valid is None else jnp.asarray(valid)


# --------------------------------------------------------------- kernels
@pytest.mark.parametrize("case", PQ_EDGES, ids=[c[0] for c in PQ_EDGES])
def test_pq_adc_topk_plain_matches_reference(reference, case):
    lut, codes, valid, k = pq_edge_operands(case)
    v = None if valid is None else torch.as_tensor(valid)
    pd, pi = ref.pq_adc_topk_ref(torch.as_tensor(lut),
                                 torch.as_tensor(codes), k, valid=v)
    od, oi = reference.ref.pq_adc_topk_ref(jnp.asarray(lut),
                                           jnp.asarray(codes), k,
                                           valid=_jv(valid))
    theirs = [(od, oi)]
    if lut.shape[0] * codes.shape[0] <= PALLAS_MAX:
        theirs.append(reference.pq_adc.pq_adc_topk_pallas(
            jnp.asarray(lut), jnp.asarray(codes), k, valid=_jv(valid), bq=8,
            bn=64, interpret=True))
    for other in theirs:
        _same((pd, pi), other, rtol=PQ_RTOL, atol=0.0)
    if case[5] == "ties":          # equal scores rank by id
        assert (pi.numpy() == np.arange(k)).all()


def test_pq_adc_scores_sum_subspaces_in_order():
    """The plain version adds the M entries in order from 0.0, one float32
    rounding each: the kernel's order, so the two agree bit for bit."""
    lut, codes, _, _ = pq_edge_operands(PQ_EDGES[6])
    got = ref.pq_adc_scores_ref(torch.as_tensor(lut),
                                torch.as_tensor(codes)).numpy()
    want = np.zeros(got.shape, np.float32)
    for m in range(codes.shape[1]):
        want = want + lut[:, m, :][:, codes[:, m]]
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("case", HAMMING_EDGES,
                         ids=[c[0] for c in HAMMING_EDGES])
def test_hamming_topk_plain_matches_reference(reference, case):
    q, codes, valid, k = hamming_edge_operands(case)
    v = None if valid is None else torch.as_tensor(valid)
    pd, pi = ref.hamming_topk_ref(torch.as_tensor(q), torch.as_tensor(codes),
                                  k, valid=v)
    theirs = [reference.ref.hamming_topk_ref(
        jnp.asarray(q), jnp.asarray(codes), k, valid=_jv(valid))]
    if k <= 64 and q.shape[0] * codes.shape[0] <= PALLAS_MAX:
        theirs.append(reference.hamming.hamming_topk_pallas(
            jnp.asarray(q), jnp.asarray(codes), k, valid=_jv(valid), bq=8,
            bn=64, interpret=True))
    for od, oi in theirs:
        _ids_equal(pi, oi)
        assert np.array_equal(pd.numpy(), np.asarray(od))
    if case[5] == "ties":
        assert (pi.numpy() == np.arange(k)).all()


def test_pack_bits_match_reference_and_wrap(reference):
    rng = _rng("pack")
    for nb in (32, 64, 96, 70):
        bits = rng.random((9, nb)) > 0.5
        bits[0] = True                    # every word 0xFFFFFFFF = -1
        want = reference.lsh.pack_bits(bits.astype(np.uint8))
        assert np.array_equal(pack_bits(bits.astype(np.uint8)), want)
        assert np.array_equal(_pack_bits(torch.as_tensor(bits)).numpy(),
                              want)
        assert (want[0, :nb // 32] == -1).all()


# ---------------------------------------------------------------- builds
def test_lsh_build_matches_reference(reference):
    x = _rng("lsh").normal(size=(500, D)).astype(np.float32)
    for kw in ({"n_bits": 64, "seed": 3}, {"n_bits": 96, "seed": 0}):
        mine, theirs = lsh_build(x, **kw), reference.lsh.lsh_build(x, **kw)
        assert np.array_equal(mine.proj, theirs.proj)
        assert np.array_equal(mine.codes, theirs.codes)
        assert mine.n_bits == theirs.n_bits
    proj = _rng("lsh proj").normal(size=(D, 40)).astype(np.float32)
    assert np.array_equal(lsh_build(x, 40, proj=proj).codes,
                          reference.lsh.lsh_build(x, 40, proj=proj).codes)


def _tree_equal(mine, theirs):
    assert mine.kind == theirs.kind
    for n in TREE_ARRAYS:
        a, b = getattr(mine, n), np.asarray(getattr(theirs, n))
        assert a.dtype == b.dtype and np.array_equal(a, b), n


@pytest.mark.parametrize("builder", ["rp", "qlbt", "qlbt_greedy", "kd"])
def test_tree_builders_match_reference(reference, builder):
    rng = _rng("build " + builder)
    x = rng.normal(size=(700, D)).astype(np.float32)
    p = rng.beta(0.3, 8.0, size=700)
    rt = reference.tree
    if builder == "rp":
        kw = dict(leaf_size=8, n_candidates=6, seed=4)
        mine, theirs = (port_tree.build_rp_tree(x, **kw),
                        rt.build_rp_tree(x, **kw))
    elif builder == "kd":
        pts = x[:, :3]
        mine, theirs = (port_tree.build_kd_tree(pts, leaf_size=4),
                        rt.build_kd_tree(pts, leaf_size=4))
    else:
        kw = dict(leaf_size=8, n_candidates=6, boost_depth=3, lam=0.4,
                  seed=5, objective="greedy" if builder.endswith("greedy")
                  else "massbalance")
        mine, theirs = (port_tree.build_qlbt(x, p, **kw),
                        rt.build_qlbt(x, p, **kw))
        assert mine.expected_depth(p) == theirs.expected_depth(p)
    _tree_equal(mine, theirs)
    assert mine.footprint_bytes() == theirs.footprint_bytes()


def test_likelihood_matches_reference(reference):
    rl = reference.likelihood
    p = rl.zipf_likelihood(500, 1.1)
    assert np.array_equal(port_lik.zipf_likelihood(500, 1.1), p)
    assert port_lik.unbalance_score(p) == rl.unbalance_score(p)
    a = port_lik.simulate_beta_likelihood(np.random.default_rng(1), 300, .5, 8)
    assert np.array_equal(a, rl.simulate_beta_likelihood(
        np.random.default_rng(1), 300, .5, 8))
    mine, theirs = (port_lik.beta_for_unbalance(0.23, 2000, seed=3),
                    rl.beta_for_unbalance(0.23, 2000, seed=3))
    assert mine[:2] == theirs[:2] and np.array_equal(mine[2], theirs[2])
    ids = _rng("log").integers(0, 400, size=3000)
    assert np.array_equal(port_lik.empirical_likelihood(ids, 400),
                          rl.empirical_likelihood(ids, 400))
    pm, cm = port_lik.decayed_empirical_likelihood(
        ids[:1000], 400, 300.0, return_counts=True)
    pt, ct = rl.decayed_empirical_likelihood(ids[:1000], 400, 300.0,
                                             return_counts=True)
    assert np.array_equal(pm, pt) and np.array_equal(cm, ct)
    assert np.array_equal(
        port_lik.decayed_empirical_likelihood(ids[1000:], 400, 300.0,
                                              prior_counts=cm),
        rl.decayed_empirical_likelihood(ids[1000:], 400, 300.0,
                                        prior_counts=ct))
    db = _rng("db").normal(size=(400, D)).astype(np.float32)
    qm, gm = port_lik.sample_queries(np.random.default_rng(7), db, p[:400]
                                     / p[:400].sum(), 50)
    qt, gt = rl.sample_queries(np.random.default_rng(7), db, p[:400]
                               / p[:400].sum(), 50)
    assert np.array_equal(qm, qt) and np.array_equal(gm, gt)


def test_select_index_spec_matches_reference(reference):
    rp = reference.protocol
    for n in (1000, 29_999, 30_000, 250_000, 1_000_000, 10_000_000):
        for traffic in (False, True):
            for part_dim in (None, 2, 8, 9, 64):
                for emb in (4, 96, 128):
                    kw = dict(traffic_available=traffic,
                              partition_dim=part_dim, embedding_dim=emb)
                    mine = select_index_spec(n, **kw)
                    theirs = rp.select_index_spec(n, **kw)
                    assert mine.kind == theirs.kind
                    assert mine.reason == theirs.reason
                    assert ((mine.two_level is None)
                            == (theirs.two_level is None))
                    if mine.two_level is not None:
                        assert (dataclasses.asdict(mine.two_level)
                                == dataclasses.asdict(theirs.two_level))


def test_pq_train_invariants(reference):
    """Codebooks from the port's k-means: every code is its nearest
    codeword (float64, up to a rounding tie), the shapes and dtypes are
    the reference's, and ADC search finds the reference's recall."""
    rng = _rng("pq train")
    x = rng.normal(size=(3000, 24)).astype(np.float32)
    q = x[:40] + 0.05 * rng.normal(size=(40, 24)).astype(np.float32)
    mine = pq_train(x, m=6, iters=6, seed=2, device="cpu")
    theirs = reference.pq.pq_train(x, m=6, iters=6, seed=2)
    assert mine.codebooks.shape == theirs.codebooks.shape == (6, 256, 4)
    assert mine.codes.shape == theirs.codes.shape == (3000, 6)
    assert mine.codes.dtype == np.uint8 and mine.d == 24
    sub = x.reshape(3000, 6, 4).astype(np.float64)
    cb = mine.codebooks.astype(np.float64)
    d2 = ((sub[:, :, None, :] - cb[None]) ** 2).sum(-1)     # (N, M, 256)
    got = np.take_along_axis(d2, mine.codes[:, :, None].astype(np.int64),
                             axis=2)[..., 0]
    assert (got <= d2.min(-1) * (1 + 1e-5) + 1e-6).all()
    truth = brute_search(q, x, 10, device="cpu")[1]
    r_mine = recall_at_k(pq_search(mine, q, 10, device="cpu")[1], truth)
    r_theirs = recall_at_k(reference.pq.pq_search(theirs, q, 10)[1], truth)
    assert r_mine >= r_theirs - 0.05


# ------------------------------------------------ carried-across search
def test_one_level_pq_and_lsh_search_match_reference(reference):
    rng = _rng("one level")
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    q = x[:B] + 0.1 * rng.normal(size=(B, 32)).astype(np.float32)
    theirs = reference.pq.pq_train(x, m=8, iters=4, seed=0)
    mine = ProductQuantizer(codebooks=np.asarray(theirs.codebooks),
                            codes=np.asarray(theirs.codes), d=32)
    _same(pq_search(mine, q, K, device="cpu"),
          reference.pq.pq_search(theirs, q, K), rtol=PQ_RTOL, atol=1e-5)
    lsh = reference.lsh.lsh_build(x, 96, seed=1)
    port_lsh = LSHIndex(proj=lsh.proj, codes=lsh.codes, n_bits=96)
    for n_cand in (64, 256, 1024, 5000):
        _same(lsh_search(port_lsh, x, q, K, n_candidates=n_cand,
                         device="cpu"),
              reference.lsh.lsh_search(lsh, x, q, K, n_candidates=n_cand))


@pytest.mark.parametrize("kind,roots,rerank", [
    ("rp", False, True), ("rp", True, True), ("rp", True, False),
    ("kd", False, True)])
def test_tree_search_matches_reference(reference, kind, roots, rerank):
    rng = _rng(f"tree search {kind} {roots}")
    x = rng.normal(size=(900, D)).astype(np.float32)
    q = x[:B] + 0.1 * rng.normal(size=(B, D)).astype(np.float32)
    rt = reference.tree
    if kind == "kd":
        x = x[:, :3].copy()
        q = q[:, :3].copy()
        theirs = rt.build_kd_tree(x, leaf_size=4)
    else:
        theirs = rt.build_rp_tree(x, leaf_size=8, n_candidates=4, seed=1)
    mine = tree_from_arrays(_tree_arrays(theirs))
    kw = dict(kind=kind, beam_width=6, k=K, max_steps=mine.max_depth + 4,
              rerank=rerank)
    r = None
    if roots:     # start half the queries below the root
        r = np.where(np.arange(B) % 2 == 0, 0,
                     theirs.children[0, 1]).astype(np.int32)
    res_m = port_tree.tree_search(
        mine.device_arrays("cpu"), torch.as_tensor(x), torch.as_tensor(q),
        roots=None if r is None else torch.as_tensor(r), **kw)
    res_t = rt.tree_search(theirs.device_arrays(), jnp.asarray(x),
                           jnp.asarray(q),
                           roots=None if r is None else jnp.asarray(r), **kw)
    _same((res_m.dists, res_m.ids), (res_t.dists, res_t.ids))
    for n in ("steps", "internal_visits", "candidates"):
        assert np.array_equal(getattr(res_m, n).numpy(),
                              np.asarray(getattr(res_t, n))), n
    assert int(res_m.steps.max()) < kw["max_steps"]
    # every beam has bottomed out: further steps change nothing (the
    # reference stops there; the port runs its max_steps)
    more = port_tree.tree_search(
        mine.device_arrays("cpu"), torch.as_tensor(x), torch.as_tensor(q),
        roots=None if r is None else torch.as_tensor(r),
        **dict(kw, max_steps=kw["max_steps"] + 20))
    for n in ("ids", "dists", "steps", "internal_visits", "candidates"):
        assert torch.equal(getattr(more, n), getattr(res_m, n)), n


COMBOS = [(top, bottom) for top in ("brute", "pq", "kdtree")
          for bottom in ("brute", "lsh", "tree", "qlbt")]


@pytest.fixture(scope="module")
def corpus():
    rng = _rng("two level corpus")
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = db[:B] + 0.2 * rng.normal(size=(B, D)).astype(np.float32)
    geo = rng.normal(size=(N, 2)).astype(np.float32)      # low-dim features
    qgeo = geo[:B] + 0.05 * rng.normal(size=(B, 2)).astype(np.float32)
    p = rng.beta(0.3, 8.0, size=N)
    return db, q, geo, qgeo, p


@pytest.mark.parametrize("top,bottom", COMBOS,
                         ids=[f"{t}-{b}" for t, b in COMBOS])
def test_two_level_search_matches_reference(reference, corpus, top, bottom):
    db, q, geo, qgeo, p = corpus
    rtl = reference.two_level
    cfg = dict(n_clusters=K_BUCKETS, top=top, bottom=bottom, kmeans_iters=4,
               lsh_bits=64, seed=1)
    feats = geo if top == "kdtree" else None
    theirs = rtl.build_two_level(db, rtl.TwoLevelConfig(**cfg), p=p,
                                 partition_features=feats)
    mine = _carry(theirs)
    qp = qgeo if top == "kdtree" else None
    if bottom == "lsh":    # the sign bits the two scans compute agree
        assert np.array_equal((q @ theirs.bottom_lsh.proj) > 0,
                              (torch.as_tensor(q) @ torch.as_tensor(
                                  theirs.bottom_lsh.proj) > 0).numpy())
    for nprobe, beam in ((3, 4), (6, 8)):
        kw = dict(nprobe=nprobe, beam_width=beam, lsh_candidates=48,
                  query_chunk=8, query_partition_features=qp)
        md, mi, mw = mine.search(q, K, **kw)
        td, ti, tw = theirs.search(q, K, **kw)
        _same((md, mi), (td, ti))
        assert mw == tw
    assert mine.footprint_bytes() == theirs.footprint_bytes()


def test_carried_structures_round_trip(reference, corpus):
    """What ``convert`` builds holds the reference's arrays unchanged,
    and the forest it concatenates equals the reference's node table."""
    db, _, _, _, p = corpus
    rtl = reference.two_level
    theirs = rtl.build_two_level(db, rtl.TwoLevelConfig(
        n_clusters=K_BUCKETS, top="pq", bottom="qlbt", kmeans_iters=2),
        p=p)
    mine = _carry(theirs)
    for n in ("db", "centroids", "bucket_ids", "bucket_counts",
              "entity_bucket", "p"):
        assert np.array_equal(getattr(mine, n), np.asarray(getattr(theirs,
                                                                   n))), n
    assert np.array_equal(mine.top_pq.codebooks, theirs.top_pq.codebooks)
    assert np.array_equal(mine.top_pq.codes, theirs.top_pq.codes)
    for name, a in mine.forest.arrays.items():
        b = np.asarray(theirs.forest.arrays[name])
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(mine.forest.roots, theirs.forest.roots)
    assert mine.forest.max_depth == theirs.forest.max_depth
    assert mine.forest.nbytes == theirs.forest.nbytes
    for a, b in zip(mine.forest.trees, theirs.forest.trees):
        _tree_equal(a, b)
    kd = rtl.build_two_level(db, rtl.TwoLevelConfig(
        n_clusters=K_BUCKETS, top="kdtree", bottom="lsh", kmeans_iters=2))
    mine = _carry(kd)
    _tree_equal(mine.top_kd, kd.top_kd)
    assert np.array_equal(mine.bottom_lsh.codes, kd.bottom_lsh.codes)
    assert np.array_equal(mine.bottom_lsh.proj, kd.bottom_lsh.proj)


def test_two_level_build_matches_reference_trees(reference, corpus):
    """The port's own build: k-means differs by rounding, but given the
    same buckets the per-bucket trees and the kd tree are the reference's
    arrays exactly (numpy builders)."""
    db, _, _, _, p = corpus
    rtl = reference.two_level
    port_idx = build_two_level(db, TwoLevelConfig(
        n_clusters=K_BUCKETS, top="kdtree", bottom="qlbt", kmeans_iters=3),
        p=p, device="cpu")
    assert sorted(port_idx.bucket_ids[port_idx.bucket_ids >= 0].tolist()) \
        == list(range(N))
    _tree_equal(port_idx.top_kd,
                reference.tree.build_kd_tree(port_idx.centroids, leaf_size=4))
    forest = rtl._build_forest(db, port_idx.bucket_ids,
                               port_idx.bucket_counts, port_idx.config, p)
    for name, a in port_idx.forest.arrays.items():
        assert np.array_equal(a, np.asarray(forest.arrays[name])), name


@pytest.mark.parametrize("kind", ["qlbt", "tree", "two_level"])
def test_search_index_matches_reference(reference, corpus, kind):
    db, q, _, _, p = corpus
    ri = reference.index
    spec = (reference.protocol.IndexSpec(kind) if kind != "two_level" else
            reference.protocol.IndexSpec(kind, reference.two_level
                                         .TwoLevelConfig(n_clusters=K_BUCKETS,
                                                         top="pq",
                                                         bottom="tree",
                                                         kmeans_iters=3)))
    theirs = ri.build_index(spec, db, p=p if kind == "qlbt" else None,
                            seed=2)
    if kind == "two_level":
        mine = SearchIndex(spec=IndexSpec(kind), db=db,
                           two_level=_carry(theirs.two_level))
    else:
        mine = SearchIndex(spec=IndexSpec(kind), db=db,
                           tree=tree_from_arrays(_tree_arrays(theirs.tree)),
                           device="cpu")
        # the port's own numpy build is the same tree
        own = build_index(IndexSpec(kind), db, p=p if kind == "qlbt" else None,
                          seed=2, device="cpu")
        _tree_equal(own.tree, theirs.tree)
    for beam, nprobe in ((2, 3), (8, 6)):
        md, mi, mw = mine.search(q, K, beam_width=beam, nprobe=nprobe)
        td, ti, tw = theirs.search(q, K, beam_width=beam, nprobe=nprobe)
        _same((md, mi), (td, ti))
        assert mw == tw
    assert mine.footprint_bytes() == theirs.footprint_bytes()


def test_auto_build_index_matches_reference(reference):
    """§5.3 end to end on a 2,000-row corpus: the same choice with and
    without traffic, the same trees, the same answers."""
    rng = _rng("auto")
    db = rng.normal(size=(2000, D)).astype(np.float32)
    _, _, p = port_lik.beta_for_unbalance(0.23, 2000)
    q, _ = port_lik.sample_queries(rng, db, p, 24)
    for traffic in (p, None):
        mine = auto_build_index(db, p=traffic, device="cpu")
        theirs = reference.index.auto_build_index(db, p=traffic)
        assert mine.spec.kind == theirs.spec.kind == (
            "qlbt" if traffic is not None else "tree")
        assert mine.spec.reason == theirs.spec.reason
        _tree_equal(mine.tree, theirs.tree)
        md, mi, mw = mine.search(q, K, beam_width=4)
        td, ti, tw = theirs.search(q, K, beam_width=4)
        _same((md, mi), (td, ti))
        assert mw == tw
    if traffic is None:
        assert mine.tree.expected_depth(p) > 0


@pytest.mark.parametrize("top,bottom", [("pq", "brute"), ("kdtree", "tree"),
                                        ("brute", "lsh")])
def test_slice_recall_matches_reference(reference, top, bottom):
    """``build_index`` -> ``search`` from raw data in both packages: the
    k-means steps round differently, so the buckets may differ; recall@10
    against exact search must be within 0.02 of the reference's."""
    rng = _rng(f"slice {top} {bottom}")
    centers = rng.normal(0, 3, size=(40, D))
    db = (centers[rng.integers(0, 40, 4096)]
          + rng.normal(size=(4096, D))).astype(np.float32)
    q = (db[rng.integers(0, 4096, 64)]
         + 0.3 * rng.normal(size=(64, D))).astype(np.float32)
    geo = (db[:, :2] + 0.01 * rng.normal(size=(4096, 2))).astype(np.float32)
    feats = geo if top == "kdtree" else None
    cfg = dict(n_clusters=64, top=top, bottom=bottom, kmeans_iters=5)
    truth = brute_search(q, db, K, device="cpu")[1]
    mine = build_index(IndexSpec("two_level", TwoLevelConfig(**cfg)), db,
                       partition_features=feats, device="cpu")
    theirs = reference.index.build_index(
        reference.protocol.IndexSpec(
            "two_level", reference.two_level.TwoLevelConfig(**cfg)), db,
        partition_features=feats)
    qp = q[:, :2] if top == "kdtree" else None
    kw = dict(nprobe=8, beam_width=8, query_chunk=64)
    r_mine = recall_at_k(mine.two_level.search(
        q, K, query_partition_features=qp, **kw)[1], truth)
    r_theirs = recall_at_k(theirs.two_level.search(
        q, K, query_partition_features=qp, **kw)[1], truth)
    assert r_mine >= r_theirs - 0.02
    assert r_theirs > 0.3
