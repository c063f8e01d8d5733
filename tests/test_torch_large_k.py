"""Exact answers at any ``k`` (the kernels' large-k passes), on the CPU.

The reference's kernels clamp ``k`` to the candidate count and answer
any ``k``.  The port's kernels hold at most ``KMAX`` (``KMAX_PQ``) pairs a
list, so above it their wrappers run ``common.topk_passes``: pass r is one
launch bounded by each query's last pair of pass r - 1, and a pair ranks
only if it comes strictly after that bound in the (distance, id) order.
The kernels run only on the card; here:

1. every bounded op's plain version at k in {33, 64, 65, 100, N} is held
   against the reference's jnp oracle: ids exactly, distances to rtol
   1e-5 (cross-framework rounding, ROADMAP fault 2);
2. ``topk_passes`` driven over the bounded plain versions
   (``ref.*_ref(..., after=...)``) equals one plain top-k bit for bit, on
   the edges that could break a pass boundary: ties across it, BM25's
   -0.0 and a hybrid's +-0.0 across it, dead rows, k above the live
   count, a probe row repeated in the chain (emitted once, fault 5) and a
   carried best that straddles the bound;
3. the served backends at k = 50 and ``SearchIndex.search`` at k = 100
   equal the reference's on a (1, 1) mesh.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import index_from_arrays
from repro_torch.core.brute import batched_l2sq
from repro_torch.core.index import SearchIndex
from repro_torch.core.protocol import IndexSpec
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import (INF, KMAX, KMAX_PQ, merge_topk,
                                        topk_passes)
from repro_torch.testing import (CHAIN_EDGES, chain_edge_operands,
                                 chain_union_topk, option_edge_operands,
                                 pq_edge_operands)

RTOL, ATOL = 1e-5, 1e-4
N = 150
KS = (33, 64, 65, 100, N)
OPS = ("l2", "int8", "bm25", "hybrid", "pq", "candidate", "chain")


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _operands(op: str, seed: int = 0) -> dict:
    """numpy operands of one op over N candidates a query (the chain:
    N = K cap rows, probed in full), about half the rows live."""
    rng = np.random.default_rng([seed, OPS.index(op)])
    b, d = 5, 16
    o = {"q": rng.normal(size=(b, d)).astype(np.float32),
         "x": rng.normal(size=(N, d)).astype(np.float32),
         "valid": (rng.random(N) > .4).astype(np.int32)}
    if op in ("bm25", "hybrid"):
        lex = option_edge_operands(("large k", b, N, 16, 10, "half"), False,
                                   seed=seed)
        o.update({n: lex[n] for n in ("terms", "tf", "qt", "qw")})
    if op == "int8":
        o["codes"], o["scales"] = ops.quantize_rows_int8(o["x"])
    if op == "pq":
        lut, codes, _, _ = pq_edge_operands(("large k", b, N, 8, 10, None),
                                            seed=seed)
        o.update(lut=lut, codes=codes)
    if op == "candidate":
        o["vecs"] = rng.normal(size=(b, N, d)).astype(np.float32)
        ids = rng.permutation(10 * N)[:N].astype(np.int32)
        o["ids"] = np.where(rng.random((b, N)) > .3, ids, -1).astype(np.int32)
    if op == "chain":
        o.update(chain_edge_operands(("large k", b, 3, 6, 25, d, 10, "mid"),
                                     seed=seed))
        o["probe"] = np.tile(np.arange(6, dtype=np.int32), (b, 1))
    return o


def _port(op: str, o: dict, k: int, after=None):
    """The port's plain version of ``op`` at ``k`` (bounded by ``after``)."""
    t = {n: _t(v) for n, v in o.items() if isinstance(v, np.ndarray)}
    kw = {"after": after}
    if op == "l2":
        return ref.l2_topk_ref(t["q"], t["x"], k, valid=t["valid"], **kw)
    if op == "int8":
        return ref.l2_topk_int8_ref(t["q"], t["codes"], t["scales"], k,
                                    valid=t["valid"], **kw)
    if op == "bm25":
        return ref.bm25_topk_ref(t["qt"], t["qw"], t["terms"], t["tf"], k,
                                 valid=t["valid"], **kw)
    if op == "hybrid":
        return ref.hybrid_topk_ref(t["q"], t["x"], t["qt"], t["qw"],
                                   t["terms"], t["tf"], 0.5, k,
                                   valid=t["valid"], **kw)
    if op == "pq":
        return ref.pq_adc_topk_ref(t["lut"], t["codes"], k, valid=t["valid"],
                                   **kw)
    if op == "candidate":
        return ref.candidate_topk_ref(t["q"], t["vecs"], t["ids"], k, **kw)
    return ref.bucket_probe_topk_ref(t["q"], t["probe"], t["bucket_ids"], k,
                                     db=t["db"], **kw)


def _theirs(reference, op: str, o: dict, k: int):
    j = {n: _j(v) for n, v in o.items() if isinstance(v, np.ndarray)}
    r = reference.ref
    if op == "l2":
        return r.l2_topk_ref(j["q"], j["x"], k, valid=j["valid"])
    if op == "int8":
        return r.l2_topk_int8_ref(j["q"], j["codes"], j["scales"], k,
                                  valid=j["valid"])
    if op == "bm25":
        return r.bm25_topk_ref(j["qt"], j["qw"], j["terms"], j["tf"], k,
                               valid=j["valid"])
    if op == "hybrid":
        return r.hybrid_topk_ref(j["q"], j["x"], j["qt"], j["qw"], j["terms"],
                                 j["tf"], jnp.full((1, 1), 0.5), k,
                                 valid=j["valid"])
    if op == "pq":
        return r.pq_adc_topk_ref(j["lut"], j["codes"], k, valid=j["valid"])
    if op == "candidate":
        return r.candidate_topk_ref(j["q"], j["vecs"], j["ids"], k)
    return reference.two_level._probe_scan_brute(
        j["db"], j["bucket_ids"], j["probe"], j["q"], k)


def _close(port, theirs):
    (pd, pi), (td, ti) = port, theirs
    pd, pi, td, ti = map(np.asarray, (pd, pi, td, ti))
    assert pi.shape == ti.shape
    assert (pi == ti).all(), f"{int((pi != ti).sum())} ids differ"
    np.testing.assert_allclose(pd, td, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("op", OPS)
def test_plain_versions_at_large_k_match_reference(reference, op, k):
    o = _operands(op)
    port = _port(op, o, k)
    assert port[0].shape == (o["q"].shape[0] if op != "pq" else
                             o["lut"].shape[0], k)
    _close(port, _theirs(reference, op, o, k))


def _bits(a, b):
    (ad, ai), (bd, bi) = a, b
    assert torch.equal(ai, bi), "ids differ"
    assert torch.equal(ad.view(torch.int32), bd.view(torch.int32)), \
        "distance bits differ"


def _unbounded(b: int):
    """The bound (-inf, int32 min): every pair comes after it (the
    kernels' ``RT_AFTER_NONE_D`` / ``AFTER_NONE_I``)."""
    return (torch.full((b,), -INF),
            torch.full((b,), -2**31, dtype=torch.int32))


def _passes(plain, b: int, k: int, kmax: int = KMAX):
    """``topk_passes`` over a bounded plain version ``plain(kr, after)``;
    the first pass, which the kernels run with no bound, gets the bound
    that admits every pair, so the plain versions apply the kernels' rule
    (a repeated pair once) in every pass."""
    def run(kr, after_d, after_i):
        return plain(kr, _unbounded(b) if after_d is None
                     else (after_d, after_i))
    return topk_passes(run, b, k, kmax, "cpu")


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("op", OPS)
def test_passes_equal_one_top_k(op, k):
    """Every bounded op, its passes against one unbounded call: the
    candidate tile and the chain under the kernel's rule (a pair once)."""
    o = _operands(op, seed=1)
    kmax = KMAX_PQ if op == "pq" else KMAX
    b = (o["lut"] if op == "pq" else o["q"]).shape[0]
    whole = _port(op, o, k, after=_unbounded(b))
    _bits(_passes(lambda kr, a: _port(op, o, kr, a), b, k, kmax), whole)
    if op not in ("candidate", "chain"):   # id-ordered scans: _finish too
        _bits(whole, _port(op, o, k))


def test_ties_across_a_pass_boundary():
    """Forty copies of one row around entries 32 and 64: equal distances
    break on the id, in every pass."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    x[20:60] = x[0]
    x[100:140] = x[1]
    q = torch.as_tensor(x[:3] + 0.01)
    xt = torch.as_tensor(x)
    for k in (64, 65, 100, 200):
        got = _passes(lambda kr, a: ref.l2_topk_ref(q, xt, kr, after=a), 3, k)
        _bits(got, ref.l2_topk_ref(q, xt, k))
    # all-equal PQ codes: every distance tied, passes of 64
    lut, codes, _, _ = pq_edge_operands(("ties", 3, 300, 8, 10, "ties"))
    lut, codes = torch.as_tensor(lut), torch.as_tensor(codes)
    got = _passes(lambda kr, a: ref.pq_adc_topk_ref(lut, codes, kr, after=a),
                  3, 150, KMAX_PQ)
    want = ref.pq_adc_topk_ref(lut, codes, 150)
    _bits(got, want)
    assert (want[1] == torch.arange(150)).all()


def test_signed_zeros_across_a_pass_boundary():
    """BM25's unmatched documents score -0.0; a distance matrix of -0.0
    and +0.0 in one run: the kernels hold them equal and break on the id,
    and the passes return each distance with its sign."""
    o = option_edge_operands(("zeros", 4, 300, 8, 10, None), False)
    o["qt"][:, 1:] = -1                 # one term a query: most docs unmatched
    qt, qw, terms, tf = (torch.as_tensor(o[n]) for n in
                         ("qt", "qw", "terms", "tf"))
    want = ref.bm25_topk_ref(qt, qw, terms, tf, 120)
    got = _passes(lambda kr, a: ref.bm25_topk_ref(qt, qw, terms, tf, kr,
                                                  after=a), 4, 120)
    _bits(got, want)
    assert (torch.signbit(want[0]) & (want[0] == 0)).any()
    rng = np.random.default_rng(3)
    d = torch.as_tensor(np.where(rng.random((3, 90)) > .5, 0.0, -0.0)
                        .astype(np.float32))
    d[:, ::7] = 1.0
    ids = torch.arange(90, dtype=torch.int32).expand(3, -1)
    got = _passes(lambda kr, a: ref._after_topk(d, ids, kr, a), 3, 90)
    _bits(got, ref._after_topk(d, ids, 90, None))
    assert torch.equal(got[0].view(torch.int32)[:, :70],
                       torch.gather(d, 1, got[1][:, :70].long())
                       .view(torch.int32))


def test_dead_rows_and_k_above_the_live_count():
    """Forty live rows of 300: a pass that runs out ends in sentinels, and
    every pass after it is sentinels too."""
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.normal(size=(4, 8)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(300, 8)).astype(np.float32))
    valid = torch.zeros(300, dtype=torch.int32)
    valid[rng.choice(300, 40, replace=False)] = 1
    for k in (33, 100, 300):
        got = _passes(lambda kr, a: ref.l2_topk_ref(q, x, kr, valid=valid,
                                                    after=a), 4, k)
        want = ref.l2_topk_ref(q, x, k, valid=valid)
        _bits(got, want)
        assert (want[1][:, 40:] == -1).all() and torch.isinf(
            want[0][:, 40:]).all()
        assert (valid[want[1][:, :40].long()] == 1).all()
    # a whole query tile dead: its first pass is all sentinels
    got = _passes(lambda kr, a: ref.l2_topk_ref(
        q, x, kr, valid=torch.zeros(300, dtype=torch.int32), after=a), 4, 70)
    assert (got[1] == -1).all() and torch.isinf(got[0]).all()


def test_repeated_probe_row_is_emitted_once():
    """A bucket probed twice: the chain's passes emit each pair once, as
    ``chain_union_topk`` (the kernels' rule) does in one call."""
    case = next(c for c in CHAIN_EDGES if c[-1] == "repeat")
    o = chain_edge_operands(case)
    q, db, bids, bvecs, probe = (torch.as_tensor(o[n]) for n in (
        "q", "db", "bucket_ids", "bucket_vecs", "probe"))
    live = int((bids[probe[0].long()] >= 0).sum())
    for k in (33, 65, live + 5):
        for src in ({"db": db}, {"bucket_vecs": bvecs}):
            got = _passes(lambda kr, a: ref.bucket_probe_topk_ref(
                q, probe, bids, kr, after=a, **src), q.shape[0], k)
            _bits(got, chain_union_topk(q, probe, bids, db, k))
            for row in got[1].numpy():
                assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()


def test_carried_best_straddling_the_bound():
    """A carried best drawn from the tile's own pairs, so its entries sit on
    both sides of every pass's bound and repeat pairs of the tile: the
    passes give ``merge_topk``'s answer (each pair once)."""
    rng = np.random.default_rng(5)
    b, c, d = 4, 90, 8
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32))
    vecs = torch.as_tensor(rng.normal(size=(b, c, d)).astype(np.float32))
    ids = torch.as_tensor(rng.permutation(1000)[:c].astype(np.int32))
    ids = ids.expand(b, -1).contiguous()
    tile_d = batched_l2sq(vecs, q)
    for k in (40, 70):
        pick = torch.as_tensor(np.sort(rng.choice(c, k, replace=False)))
        sub_d, sub_i = tile_d[:, pick], ids[:, pick]
        order = torch.sort(sub_d + 0.0, dim=1, stable=True).indices
        best_d = torch.gather(sub_d, 1, order)
        best_i = torch.gather(sub_i, 1, order)
        got = _passes(lambda kr, a: ref.candidate_topk_ref(
            q, vecs, ids, kr, best_d=best_d, best_i=best_i, after=a), b, k)
        _bits(got, merge_topk(best_d, best_i, tile_d, ids, k))
        for row in got[1].numpy():
            assert len(set(row.tolist())) == k


# ------------------------------------------ backends and the index layer
ND, D, N_BUCKETS, B = 4096, 32, 64, 16


@pytest.fixture(scope="module")
def carried(reference):
    rng = np.random.default_rng(11)
    db = rng.normal(size=(ND, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    rtl = reference.two_level
    ref_idx = rtl.build_two_level(db, rtl.TwoLevelConfig(
        n_clusters=N_BUCKETS, top="brute", bottom="brute", seed=0))
    arrays = {name: np.asarray(getattr(ref_idx, name)) for name in
              ("db", "centroids", "bucket_ids", "bucket_counts")}
    port_idx = index_from_arrays(arrays, dataclasses.asdict(ref_idx.config),
                                 device="cpu")
    return dict(db=db, q=q, ref_idx=ref_idx, port_idx=port_idx,
                mesh=jax.make_mesh((1, 1), ("data", "model")))


@pytest.mark.parametrize("kind,fused", [("ivf", True), ("ivf", False),
                                        ("brute", True)])
def test_backend_at_k50_matches_reference(reference, carried, kind, fused):
    target_ref = carried["ref_idx"] if kind == "ivf" else carried["db"]
    target_port = carried["port_idx"] if kind == "ivf" else carried["db"]
    port = ShardedSearchBackend(target_port, kind=kind, k=50, nprobe_local=8,
                                fused=fused, device="cpu")(carried["q"])
    theirs = reference.backend.ShardedSearchBackend(
        carried["mesh"], target_ref, kind=kind, k=50, nprobe_local=8,
        fused=fused)(carried["q"])
    assert np.asarray(port[1]).shape == (B, 50)
    _close(port, theirs)


def test_search_index_at_k100_matches_reference(reference, carried):
    rp = reference.protocol
    theirs = reference.index.SearchIndex(
        spec=rp.IndexSpec("two_level"), db=carried["db"],
        two_level=carried["ref_idx"])
    mine = SearchIndex(spec=IndexSpec("two_level"), db=carried["db"],
                       two_level=carried["port_idx"])
    for nprobe in (4, 8):
        md, mi, mw = mine.search(carried["q"], 100, nprobe=nprobe)
        td, ti, tw = theirs.search(carried["q"], 100, nprobe=nprobe)
        assert np.asarray(mi).shape == (B, 100)
        _close((md, mi), (td, ti))
        assert mw == tw
