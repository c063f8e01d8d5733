"""Filtered, lexical, hybrid and int8 search on the CPU, held against the
reference.

The numpy modules (metadata masks and keys, postings slabs, query
operands, the BM25 oracle, int8 quantization) must equal the reference's
exactly, numpy on both sides.  The new plain kernels (what the port runs
for a CPU tensor, and what ``chip_smoke.py`` holds the CUDA kernels
against) are compared with the reference's jnp oracles and its Pallas
kernels in interpret mode, on the edge shapes of ``tests/test_kernels.py``.
The port's ``ShardedSearchBackend`` is compared with the reference's on a
one-device mesh over every option the reference allows, fused and
unfused, and must refuse what it refuses.

Tolerance: ids exactly; distances to rtol=1e-5 (BM25 1e-6) plus a small
atol, because XLA-CPU and torch-CPU fp32 products round differently;
never bitwise across the two packages.  Parity inputs are continuous
normal data, whose neighbours are never tied to within that rounding.
"""
from __future__ import annotations

import threading
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import (index_from_arrays, lexical_from_arrays,
                                 metadata_from_arrays)
from repro_torch.core import lexical as port_lexical
from repro_torch.core.metadata import FilterSpec, MetadataTable
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import stable_topk
from repro_torch.serve.cell import ServingCell
from repro_torch.testing import (OPTION_EDGES, hybrid_by_parts,
                                 lexical_scores_f32, option_edge_operands)

RTOL, ATOL = 1e-5, 1e-4
V = 40                       # vocabulary of the small lexical cases


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _same(port, *others, rtol=RTOL, atol=ATOL):
    pd, pi = (np.asarray(t) for t in port)
    for od, oi in others:
        od, oi = np.asarray(od), np.asarray(oi)
        assert pd.shape == od.shape and pi.shape == oi.shape
        assert (pi == oi).all(), f"{int((pi != oi).sum())} ids differ"
        np.testing.assert_allclose(pd, od, rtol=rtol, atol=atol)


# ------------------------------------------------------------ numpy modules
def _docs(rng, n, lo=0, hi=30, vocab=V, neg=False):
    out = []
    for _ in range(n):
        d = rng.integers(-2 if neg else 0, vocab + (3 if neg else 0),
                         size=int(rng.integers(lo, hi + 1)))
        out.append(d.tolist())
    return out


def test_metadata_masks_and_keys_match_reference(reference):
    rng = _rng("metadata")
    cols = {"pct": rng.permutation(500) % 100,
            "cat": rng.integers(0, 7, 500)}
    mine, theirs = (MetadataTable(cols),
                    reference.metadata.MetadataTable(cols))
    specs = [
        ((), ()),
        (("eq", "cat", 3),),
        (("range", "pct", 0, 4),),
        (("isin", "cat", (6, 1, 2)),),
        (("range", "pct", 10, 60), ("eq", "cat", 2)),
    ]
    for preds in specs:
        ours = FilterSpec()
        yours = reference.metadata.FilterSpec()
        for p in [p for p in preds if p]:
            if p[0] == "eq":
                ours &= FilterSpec.eq(p[1], p[2])
                yours &= reference.metadata.FilterSpec.eq(p[1], p[2])
            elif p[0] == "range":
                ours &= FilterSpec.range(p[1], p[2], p[3])
                yours &= reference.metadata.FilterSpec.range(p[1], p[2],
                                                             p[3])
            else:
                ours &= FilterSpec.isin(p[1], p[2])
                yours &= reference.metadata.FilterSpec.isin(p[1], p[2])
        assert ours.key() == yours.key()
        assert ours.empty == yours.empty
        assert ours.describe() == yours.describe()
        for n in (500, 640):            # 640: headroom rows beyond the table
            np.testing.assert_array_equal(ours.mask(mine, n),
                                          yours.mask(theirs, n))
    snap = mine.snapshot()
    mine.append_rows({"pct": np.arange(3)}, 3, fill=9)
    theirs.append_rows({"pct": np.arange(3)}, 3, fill=9)
    assert snap.n_rows == 500 and mine.n_rows == theirs.n_rows == 503
    for c in ("pct", "cat"):
        np.testing.assert_array_equal(mine.column(c), theirs.column(c))
    with pytest.raises(ValueError):
        FilterSpec.eq("cat", 1).mask(None, 4)
    with pytest.raises(KeyError):
        FilterSpec.eq("nope", 1).mask(mine, 4)


@pytest.mark.parametrize("case", ["short", "wider_than_slots",
                                  "negatives_and_out_of_vocab", "append",
                                  "empty_docs"])
def test_lexical_slabs_match_reference(reference, case):
    rng = _rng(case)
    slots = 16
    if case == "short":
        docs = _docs(rng, 60, 1, 12)
    elif case == "wider_than_slots":
        # more than S distinct terms, and repeats: the highest-tf rule
        docs = _docs(rng, 40, 20, 60)
        slots = 8
    elif case == "negatives_and_out_of_vocab":
        docs = _docs(rng, 50, 0, 25, neg=True)
        slots = 6
    elif case == "append":
        docs = _docs(rng, 30, 1, 30)
    else:
        docs = [[], [3, 3, 3], []] + _docs(rng, 5, 0, 4) + [[-1, -1]]
    mine = port_lexical.build_lexical_slabs(docs, V, slots=slots)
    theirs = reference.lexical.build_lexical_slabs(docs, V, slots=slots)
    if case == "append":
        more = _docs(rng, 12, 0, 40, neg=True)
        mine.append_docs(more)
        theirs.append_docs(more)
    for name in ("terms", "tf_sat", "idf"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    assert (mine.k1, mine.b, mine.avg_len) == (theirs.k1, theirs.b,
                                              theirs.avg_len)
    q_docs = _docs(rng, 9, 0, 14, neg=True)
    qt, qw = port_lexical.query_operands(q_docs, mine, slots=4)
    rt, rw = reference.lexical.query_operands(q_docs, theirs, slots=4)
    assert qt.tobytes() == rt.tobytes() and qw.tobytes() == rw.tobytes()
    a = port_lexical.bm25_dists(mine.terms, mine.tf_sat, qt, qw)
    b = reference.lexical.bm25_dists(theirs.terms, theirs.tf_sat, rt, rw)
    assert a.tobytes() == b.tobytes()
    # the plain kernel computes the oracle's distances
    np.testing.assert_allclose(
        ref.bm25_dists_ref(*map(torch.as_tensor, (qt, qw, mine.terms,
                                                  mine.tf_sat))).numpy(),
        a, rtol=1e-6, atol=0)


def test_quantize_rows_int8_matches_reference_bitwise(reference):
    rng = _rng("quantize")
    x = (rng.normal(size=(300, 24)) * rng.lognormal(size=(300, 1))
         ).astype(np.float32)
    x[7] = 0.0                           # an all-zero row: scale 1.0
    x[9, 3] = -x[9].__abs__().max() * 3  # a dominant negative entry
    mine = ops.quantize_rows_int8(x)
    theirs = reference.ops.quantize_rows_int8(x)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (mine[0][7] == 0).all() and mine[1][7] == 1.0


# ------------------------------------------------------------- plain kernels
_N, _B, _K, _D = 77, 5, 8, 8          # 77 % 32 != 0: the grid pad is on


def _slabs(rng, n, s=6, repeat=False):
    terms = np.where(rng.random((n, s)) < 0.8, rng.integers(0, V, (n, s)),
                     -1).astype(np.int32)
    if not repeat:                       # distinct terms in a row
        for r in range(n):
            seen = set()
            for c in range(s):
                if terms[r, c] in seen:
                    terms[r, c] = -1
                seen.add(terms[r, c])
    tf = np.where(terms >= 0, rng.random((n, s)) + 0.05, 0.0)
    return terms, tf.astype(np.float32)


def _edge(name):
    """Operands of one edge case: (q, x, qt, qw, terms, tf, k, valid)."""
    rng = _rng(name)
    b, n, k, d = _B, _N, _K, _D
    if name.startswith("d="):      # "d=640...": rows wider than 512
        d = int(name[2:].split("_")[0])
    if name == "single_query_row":
        b = 1
    elif name == "k_exceeds_n":
        n, k = 6, 10
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if name == "duplicate_rows":
        x[n // 2:] = x[:n - n // 2]
    terms, tf = _slabs(rng, n, repeat=name == "repeated_slab_terms")
    qt = rng.integers(0, V, size=(b, 4)).astype(np.int32)
    if name == "query_terms_all_pad":
        qt[0] = -1
    qw = (rng.random((b, 4)) + 0.1).astype(np.float32)
    valid = None
    if name == "all_dead":
        valid = np.zeros(n, np.int32)
    elif name.endswith("partial_valid"):
        valid = (rng.random(n) > 0.5).astype(np.int32)
    return q, x, qt, qw, terms, tf, k, valid


_EDGES = ["single_query_row", "n_not_multiple_of_tile", "k_exceeds_n",
          "all_dead", "partial_valid", "duplicate_rows",
          "query_terms_all_pad", "repeated_slab_terms"]


def _jv(valid):
    return None if valid is None else jnp.asarray(valid)


def _tv(valid):
    return None if valid is None else torch.as_tensor(valid)


def _check_contract(port, valid):
    d, i = (t.numpy() for t in port)
    assert (i[np.isinf(d)] == -1).all() and not np.isnan(d).any()
    if valid is not None:
        assert not np.isin(i, np.flatnonzero(valid == 0)).any()


@pytest.mark.parametrize("name", _EDGES + ["d=640_partial_valid", "d=1000"])
def test_l2_topk_int8_plain_matches_reference(reference, name):
    q, x, _, _, _, _, k, valid = _edge(name)
    codes, scales = ops.quantize_rows_int8(x)
    port = ref.l2_topk_int8_ref(torch.as_tensor(q), torch.as_tensor(codes),
                                torch.as_tensor(scales), k, valid=_tv(valid))
    args = (jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales))
    oracle = reference.ref.l2_topk_int8_ref(*args, k, valid=_jv(valid))
    # bn=64: in interpret mode on this JAX the reference's int8 kernel
    # leaves its own oracle for B > 1 at bn in {16, 32, 512} (ROADMAP
    # fault 8); bn in {8, 64} agrees with it on every edge here
    pallas = reference.l2_topk.l2_topk_int8_pallas(
        *args, k, valid=_jv(valid), bq=8, bn=64, interpret=True)
    _same(port, oracle, pallas)
    _check_contract(port, valid)


@pytest.mark.parametrize("name", _EDGES)
def test_bm25_topk_plain_matches_reference(reference, name):
    _, _, qt, qw, terms, tf, k, valid = _edge(name)
    port = ref.bm25_topk_ref(*map(torch.as_tensor, (qt, qw, terms, tf)), k,
                             valid=_tv(valid))
    args = tuple(map(jnp.asarray, (qt, qw, terms, tf)))
    oracle = reference.ref.bm25_topk_ref(*args, k, valid=_jv(valid))
    pallas = reference.bm25.bm25_topk_pallas(*args, k, valid=_jv(valid),
                                             bq=8, bn=32, interpret=True)
    _same(port, oracle, pallas, rtol=1e-6, atol=0)
    _check_contract(port, valid)
    if name == "query_terms_all_pad":      # scores nothing: all -0.0 ties
        d, i = (t.numpy() for t in port)
        assert (d[0] == 0).all() and (i[0] == np.arange(k)).all()


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("name", ["single_query_row", "k_exceeds_n",
                                  "all_dead", "partial_valid",
                                  "query_terms_all_pad",
                                  "repeated_slab_terms"])
def test_hybrid_topk_plain_matches_reference(reference, name, alpha):
    q, x, qt, qw, terms, tf, k, valid = _edge(name)
    a = np.full((1, 1), alpha, np.float32)
    ops_in = (q, x, qt, qw, terms, tf, a)
    port = ref.hybrid_topk_ref(*map(torch.as_tensor, ops_in), k,
                               valid=_tv(valid))
    args = tuple(map(jnp.asarray, ops_in))
    oracle = reference.ref.hybrid_topk_ref(*args, k, valid=_jv(valid))
    pallas = reference.bm25.hybrid_topk_pallas(*args, k, valid=_jv(valid),
                                               bq=8, bn=32, interpret=True)
    _same(port, oracle, pallas)
    _check_contract(port, valid)
    # the limits: alpha = 0 is the BM25 scan, alpha = 1 the L2 scan
    if alpha in (0.0, 1.0):
        other = (ref.bm25_topk_ref(*map(torch.as_tensor, (qt, qw, terms, tf)),
                                   k, valid=_tv(valid)) if alpha == 0.0 else
                 ref.l2_topk_ref(torch.as_tensor(q), torch.as_tensor(x), k,
                                 valid=_tv(valid)))
        assert torch.equal(port[1], other[1])
        assert torch.equal(port[0], other[0])


@pytest.mark.parametrize("repeat", [False, True],
                         ids=["distinct", "repeated_terms"])
def test_lexical_scores_f32_match_plain_and_reference(reference, repeat):
    # the widest shared edge: 70 queries x 5,000 rows, S = 16, T = 8
    o = option_edge_operands(OPTION_EDGES[6], repeat)
    b, n = o["qt"].shape[0], o["terms"].shape[0]
    bq, rows = np.divmod(np.arange(b * n), n)
    mine = lexical_scores_f32(o["qt"][bq], o["qw"][bq], o["terms"][rows],
                              o["tf"][rows]).reshape(b, n)
    theirs = -reference.lexical.bm25_dists(o["terms"], o["tf"], o["qt"],
                                           o["qw"])
    np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=0)
    if not repeat:      # one non-zero term per hit sum: the plain bits
        plain = -ref.bm25_dists_ref(*map(torch.as_tensor, (
            o["qt"], o["qw"], o["terms"], o["tf"]))).numpy()
        assert mine.tobytes() == plain.tobytes()


@pytest.mark.parametrize("repeat", [False, True],
                         ids=["distinct", "repeated_terms"])
@pytest.mark.parametrize("case", OPTION_EDGES,
                         ids=[c[0] for c in OPTION_EDGES])
def test_bm25_option_edges_match_reference(reference, case, repeat):
    # the edges the card holds bm25_topk to (a head term in every document
    # and query, a query repeating a term, ids colliding modulo a power of
    # two up to 2**31 - 1, a query tile of more distinct terms than the
    # kernel's hit rows): the plain version against the reference's jnp
    # oracle and its Pallas kernel in interpret mode, and the kernels'
    # float32 score order against the reference's numpy scores
    o = option_edge_operands(case, repeat)
    qt, qw, terms, tf, k, valid = (o[n] for n in ("qt", "qw", "terms", "tf",
                                                  "k", "valid"))
    port = ref.bm25_topk_ref(*map(torch.as_tensor, (qt, qw, terms, tf)), k,
                             valid=_tv(valid))
    args = tuple(map(jnp.asarray, (qt, qw, terms, tf)))
    oracle = reference.ref.bm25_topk_ref(*args, k, valid=_jv(valid))
    pallas = reference.bm25.bm25_topk_pallas(*args, k, valid=_jv(valid),
                                             bq=8, bn=32, interpret=True)
    _same(port, oracle, pallas, rtol=1e-6, atol=0)
    _check_contract(port, valid)
    b, n = qt.shape[0], terms.shape[0]
    bq, rows = np.divmod(np.arange(b * n), n)
    mine = lexical_scores_f32(qt[bq], qw[bq], terms[rows],
                              tf[rows]).reshape(b, n)
    theirs = -reference.lexical.bm25_dists(terms, tf, qt, qw)
    np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", OPTION_EDGES,
                         ids=[c[0] for c in OPTION_EDGES])
def test_hybrid_by_parts_sees_a_missing_lexical_half(case):
    o = option_edge_operands(case, False)
    q, x, qt, qw, terms, tf, valid = (
        None if o[n] is None else torch.as_tensor(o[n])
        for n in ("q", "x", "qt", "qw", "terms", "tf", "valid"))
    a = torch.zeros((1, 1))
    # alpha = 0: the answer is the score alone, so the plain version's d2
    # rounding (which differs between a full and a gathered scan) is out
    kd, ki = ops.hybrid_topk_op(q, x, qt, qw, terms, tf, a, o["k"],
                                valid=valid)
    parts = hybrid_by_parts(q, x, qt, qw, terms, tf, 0.0, kd, ki)
    assert parts["mismatches"] == 0, parts
    assert parts["l2_max_rel_err"] <= 1e-5
    assert parts["lex_max_rel_err"] <= parts["lex_bound"]
    # the same scan with every weight 0: the lexical half is gone
    kd0, ki0 = ops.hybrid_topk_op(q, x, qt, torch.zeros_like(qw), terms, tf,
                                  a, o["k"], valid=valid)
    dropped = hybrid_by_parts(q, x, qt, qw, terms, tf, 0.0, kd0, ki0)
    if dropped["pairs"] and (o["qt"] >= 0).any():
        assert dropped["mismatches"] > 0


def test_stable_topk_holds_signed_zeros_equal():
    d = torch.tensor([[0.0, -0.0, -1.0, 0.0, -0.0]])
    vals, idx = stable_topk(d, 5)
    assert idx.tolist() == [[2, 0, 1, 3, 4]]
    assert torch.signbit(vals).tolist() == [[True, False, True, False,
                                             True]]


# ------------------------------------------------------------------ backend
N, D, B, K, NB, NPROBE = 2048, 16, 12, 10, 32, 8
F_WIDE = ("range", "pct", 0, 49)
F_NARROW = ("range", "pct", 0, 4)


@pytest.fixture(scope="module")
def world(reference):
    """One corpus with metadata and slabs, both packages' copies, and a
    reference-built index carried across."""
    rng = _rng("world")
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    cols = {"pct": rng.permutation(N) % 100}
    docs = _docs(rng, N, 3, 10, vocab=200)
    q_docs = [docs[int(i)][:3] + [int(rng.integers(0, 200))]
              for i in rng.integers(0, N, B)]
    ref_slabs = reference.lexical.build_lexical_slabs(docs, 200)
    ref_meta = reference.metadata.MetadataTable(cols)
    slabs = lexical_from_arrays(
        {n: getattr(ref_slabs, n) for n in ("terms", "tf_sat", "idf")},
        {n: getattr(ref_slabs, n) for n in ("k1", "b", "avg_len")})
    meta = metadata_from_arrays(cols)
    qt, qw = port_lexical.query_operands(q_docs, slabs)
    ref_idx = reference.two_level.build_two_level(
        db, reference.two_level.TwoLevelConfig(n_clusters=NB, seed=0),
        metadata=ref_meta)
    idx = index_from_arrays(
        {n: np.asarray(getattr(ref_idx, n)) for n in
         ("db", "centroids", "bucket_ids", "bucket_counts")},
        {"n_clusters": NB, "seed": 0}, device="cpu", metadata=meta)
    return types.SimpleNamespace(
        db=db, q=q, qt=qt, qw=qw, slabs=slabs, meta=meta, idx=idx,
        ref_slabs=ref_slabs, ref_meta=ref_meta, ref_idx=ref_idx,
        mesh=jax.make_mesh((1, 1), ("data", "model")), backends={})


def _specs(reference, pred):
    if pred is None:
        return None, None
    return (FilterSpec((pred,)), reference.metadata.FilterSpec((pred,)))


def _pair(reference, world, kind, precision, fused):
    """The port's and the reference's backend for one configuration,
    built once per module."""
    key = (kind, precision, fused)
    if key not in world.backends:
        lex = kind == "brute" and precision == "f32"
        target = (world.idx, world.ref_idx) if kind == "ivf" else (
            world.db, world.db)
        mine = ShardedSearchBackend(
            target[0], kind=kind, k=K, nprobe_local=NPROBE, fused=fused,
            precision=precision, metadata=world.meta,
            lexical=world.slabs if lex else None, device="cpu")
        theirs = reference.backend.ShardedSearchBackend(
            world.mesh, target[1], kind=kind, k=K, nprobe_local=NPROBE,
            fused=fused, precision=precision, metadata=world.ref_meta,
            lexical=world.ref_slabs if lex else None)
        world.backends[key] = (mine, theirs)
    return world.backends[key]


_BACKEND_CASES = [
    (kind, prec, fused, pred, mode, alpha)
    for kind, prec, fused in (("brute", "f32", True), ("brute", "f32", False),
                              ("brute", "int8", True), ("ivf", "f32", True),
                              ("ivf", "f32", False))
    for pred in (None, F_WIDE)
    for mode, alpha in (("semantic", 0.5), ("lexical", 0.5), ("hybrid", 0.0),
                        ("hybrid", 0.5), ("hybrid", 1.0))
    if mode == "semantic" or (kind, prec) == ("brute", "f32")
]


@pytest.mark.parametrize("kind,precision,fused,pred,mode,alpha",
                         _BACKEND_CASES)
def test_backend_options_match_reference(reference, world, kind, precision,
                                         fused, pred, mode, alpha):
    mine, theirs = _pair(reference, world, kind, precision, fused)
    ours, yours = _specs(reference, pred)
    kw = dict(mode=mode, alpha=alpha, q_terms=world.qt, q_weights=world.qw)
    port = mine(world.q, filter_spec=ours, **kw)
    ref_out = theirs(world.q, filter_spec=yours, **kw)
    _same(port, ref_out)
    if pred is not None:
        admitted = np.flatnonzero(ours.mask(world.meta, N))
        got = port[1][port[1] >= 0]
        assert np.isin(got, admitted).all()


def test_filtered_ivf_at_low_selectivity_matches_reference(reference, world):
    mine, theirs = _pair(reference, world, "ivf", "f32", True)
    ours, yours = _specs(reference, F_NARROW)
    _same(mine(world.q, filter_spec=ours), theirs(world.q, filter_spec=yours))


@pytest.mark.parametrize("refusal", [
    "int8_on_ivf", "lexical_with_int8", "lexical_on_ivf", "mode_without_slabs",
    "mode_without_terms", "unknown_mode", "unknown_precision",
    "int8_unfused", "slab_rows"])
def test_backend_refusals_match_reference(reference, world, refusal):
    def build(pkg, **kw):
        if pkg == "mine":
            return ShardedSearchBackend(kw.pop("target"), device="cpu", **kw)
        return reference.backend.ShardedSearchBackend(
            world.mesh, kw.pop("target"), **kw)

    for pkg in ("mine", "theirs"):
        idx = world.idx if pkg == "mine" else world.ref_idx
        slabs = world.slabs if pkg == "mine" else world.ref_slabs
        with pytest.raises(ValueError):
            if refusal == "int8_on_ivf":
                build(pkg, target=idx, kind="ivf", precision="int8")
            elif refusal == "lexical_with_int8":
                build(pkg, target=world.db, kind="brute", precision="int8",
                      lexical=slabs)
            elif refusal == "lexical_on_ivf":
                build(pkg, target=idx, kind="ivf", lexical=slabs)
            elif refusal == "mode_without_slabs":
                build(pkg, target=world.db, kind="brute")(
                    world.q, mode="hybrid", q_terms=world.qt,
                    q_weights=world.qw)
            elif refusal == "mode_without_terms":
                build(pkg, target=world.db, kind="brute", lexical=slabs)(
                    world.q, mode="lexical")
            elif refusal == "unknown_mode":
                build(pkg, target=world.db, kind="brute")(world.q,
                                                          mode="dense")
            elif refusal == "unknown_precision":
                build(pkg, target=world.db, kind="brute", precision="bf16")
            elif refusal == "int8_unfused":
                build(pkg, target=world.db, kind="brute", precision="int8",
                      fused=False)
            else:
                build(pkg, target=world.db[:-1], kind="brute", lexical=slabs)


def test_index_sidecars_are_checked_and_used(world):
    with pytest.raises(ValueError, match="metadata"):
        build_two_level(world.db, TwoLevelConfig(n_clusters=4),
                        metadata=MetadataTable({"a": np.zeros(3)}),
                        device="cpu")
    with pytest.raises(ValueError, match="lexical"):
        index_from_arrays(
            {n: getattr(world.idx, n) for n in
             ("db", "centroids", "bucket_ids", "bucket_counts")},
            {"n_clusters": NB}, device="cpu", lexical=lexical_from_arrays(
                {"terms": np.zeros((3, 2)), "tf_sat": np.zeros((3, 2)),
                 "idf": np.ones(4)}, {"k1": 1.2, "b": .75, "avg_len": 1.}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        world.idx.add_entities()
    # the backend takes the index's metadata when given none
    be = ShardedSearchBackend(world.idx, kind="ivf", k=K,
                              nprobe_local=NPROBE, device="cpu")
    spec = FilterSpec((F_WIDE,))
    _, ids = be(world.q, filter_spec=spec)
    assert np.isin(ids[ids >= 0],
                   np.flatnonzero(spec.mask(world.meta, N))).all()
    # an empty spec is the unfiltered call
    assert (be(world.q, filter_spec=FilterSpec())[1] == be(world.q)[1]).all()


def test_cell_groups_mixed_options_into_separate_dispatches(world):
    backend = ShardedSearchBackend(world.db, kind="brute", k=K,
                                   metadata=world.meta, lexical=world.slabs,
                                   device="cpu")
    wide = FilterSpec((F_WIDE,))
    options = [dict(), dict(filter=wide), dict(mode="lexical"),
               dict(mode="lexical", filter=wide),
               dict(mode="hybrid", alpha=0.5), dict(mode="hybrid", alpha=0.2)]

    def call_kw(o, r):
        kw = {"filter_spec": o.get("filter"), "mode": o.get("mode",
                                                            "semantic"),
              "alpha": o.get("alpha", 0.5)}
        if kw["mode"] != "semantic":
            kw["q_terms"] = world.qt[r:r + 1]
            kw["q_weights"] = world.qw[r:r + 1]
        return kw

    # the direct answer of each request: its own one-row backend call
    direct = {(r, j): backend(world.q[r:r + 1], **call_kw(o, r))
              for r in range(B) for j, o in enumerate(options)}
    cell = ServingCell(backend, max_batch=64, max_wait_ms=50.0)
    out = {}

    def client(r):
        for j, o in enumerate(options):
            extra = {}
            if o.get("mode", "semantic") != "semantic":
                extra = {"q_terms": world.qt[r], "q_weights": world.qw[r]}
            out[(r, j)] = cell.search(world.q[r], timeout=60, **o, **extra)

    threads = [threading.Thread(target=client, args=(r,)) for r in range(B)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = cell.stats()
    finally:
        cell.close()
    for key, (d, i) in out.items():
        np.testing.assert_array_equal(i, direct[key][1][0])
        np.testing.assert_allclose(d, direct[key][0][0], rtol=RTOL,
                                   atol=ATOL)
    assert stats.n == B * len(options)
    assert sum(stats.batch_sizes) == B * len(options)
    # a dispatch never mixes option sets, so every collected batch that
    # held several of them was split
    assert stats.dispatches >= max(stats.collected_batches, len(options))
    assert stats.dispatches == len(stats.batch_sizes)


def test_cell_pads_lexical_operands_to_the_group_width():
    seen = []

    def backend(qs, **kw):
        seen.append(kw)
        return (np.zeros((len(qs), 2), np.float32),
                np.zeros((len(qs), 2), np.int32))

    # a wide window: the three lexical requests land in one batch
    cell = ServingCell(backend, max_batch=8, max_wait_ms=500.0)
    try:
        futs = [cell.submit(np.zeros(4, np.float32), mode="lexical",
                            q_terms=np.arange(n), q_weights=np.ones(n))
                for n in (1, 3, 2)]
        for f in futs:
            f.get(timeout=30)
        cell.submit(np.zeros(4, np.float32)).get(timeout=30)
    finally:
        cell.close()
    lex = [kw for kw in seen if kw]
    assert sum(kw["q_terms"].shape[0] for kw in lex) >= 3
    qt = lex[0]["q_terms"]
    assert qt.shape[1] == 4 and qt.dtype == np.int32   # pow2 of 3 slots
    assert (qt[0] == [0, -1, -1, -1]).all()
    assert (lex[0]["q_weights"][0] == [1, 0, 0, 0]).all()
    assert {} in seen                  # the default request: the bare call


@pytest.mark.parametrize("bad", [
    dict(mode="lexical"),                                   # no operands
    dict(mode="hybrid", q_terms=[1, 2]),                    # no weights
    dict(mode="lexical", q_terms=[1, 2], q_weights=[1.0]),  # lengths differ
    dict(mode="dense"),                                     # unknown mode
])
def test_cell_refuses_a_bad_request_without_failing_others(bad):
    seen = []

    def backend(qs, **kw):
        seen.append(kw)
        return (np.zeros((len(qs), 2), np.float32),
                np.zeros((len(qs), 2), np.int32))

    cell = ServingCell(backend, max_batch=8, max_wait_ms=200.0)
    try:
        good = cell.submit(np.zeros(4, np.float32), mode="lexical",
                           q_terms=[3], q_weights=[1.0])
        with pytest.raises(ValueError):
            cell.submit(np.zeros(4, np.float32), **bad)
        d, i = good.get(timeout=30)
    finally:
        cell.close()
    assert d.shape == (2,) and i.shape == (2,)
    assert len(seen) == 1 and seen[0]["q_terms"].shape == (1, 1)
