"""The probe chain's plain version and its wiring on the CPU, held against
the reference.

``ref.bucket_probe_topk_ref`` is what the port runs for CPU tensors where
the card runs one ``candidate_topk`` chain launch: with rows by entity id
(``db=``) it is the reference's ``two_level._probe_scan_brute``, with rows
by slot (``bucket_vecs=``) the loop of the reference's candidate-tile step
(its jnp oracle and its Pallas kernel in interpret mode) that the served
IVF local runs.  The wiring: the IVF backend's fused path and the
two-level brute bottom call the chain and return what the reference
returns.  Inputs are the shared edge table ``testing.CHAIN_EDGES``, made
from a numpy seed.

Tolerance: ids exactly; distances to rtol=1e-5, atol=1e-5 (XLA-CPU and
torch-CPU fp32 products round differently; values here are O(100)).
Inside the port the two row sources and the op are compared bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import TREE_ARRAYS, index_from_arrays
from repro_torch.core.metadata import FilterSpec, MetadataTable
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import bucket_topk, ops, ref
from repro_torch.testing import (CHAIN_EDGES, chain_edge_operands,
                                 chain_union_topk, step_chain)

RTOL = ATOL = 1e-5
LIVE = [c for c in CHAIN_EDGES if c[1] > 0]
# the Pallas kernel in interpret mode walks its grid step by step: the
# narrow buckets only
PALLAS = [c for c in LIVE if c[4] <= 64]


def _ids(cases):
    return [c[0] for c in cases]


def _operands(case):
    o = chain_edge_operands(case)
    t = {n: torch.as_tensor(o[n]) for n in ("q", "db", "bucket_ids",
                                            "bucket_vecs", "probe")}
    return o, t


def _same(port, *others):
    pd, pi = (np.asarray(x) for x in port)
    for od, oi in others:
        od, oi = np.asarray(od), np.asarray(oi)
        assert pd.shape == od.shape and pi.shape == oi.shape
        assert (pi == oi).all(), f"{int((pi != oi).sum())} ids differ"
        np.testing.assert_allclose(pd, od, rtol=RTOL, atol=ATOL)


def _bits(a, b):
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))


@pytest.mark.parametrize("case", LIVE, ids=_ids(LIVE))
def test_rows_by_id_match_reference_probe_scan_brute(reference, case):
    o, t = _operands(case)
    port = ref.bucket_probe_topk_ref(t["q"], t["probe"], t["bucket_ids"],
                                     o["k"], db=t["db"])
    theirs = reference.two_level._probe_scan_brute(
        jnp.asarray(o["db"]), jnp.asarray(o["bucket_ids"]),
        jnp.asarray(o["probe"]), jnp.asarray(o["q"]), o["k"])
    _same(port, theirs)


@pytest.mark.parametrize("case", LIVE, ids=_ids(LIVE))
def test_rows_by_slot_match_reference_step_loop(reference, case):
    """The served IVF local's loop: one candidate-tile step per probe,
    carrying the best, as the reference's jnp oracle and (on the narrow
    buckets) its Pallas kernel in interpret mode run it.  On a repeated
    probe the Pallas kernel, like the CUDA one, keeps a pair seen twice
    once (ROADMAP fault 5): there it equals the kernels' rule, the
    oracle the plain loop."""
    o, t = _operands(case)
    k = o["k"]
    port = ref.bucket_probe_topk_ref(t["q"], t["probe"], t["bucket_ids"], k,
                                     bucket_vecs=t["bucket_vecs"])
    q = jnp.asarray(o["q"])
    runs = [reference.ref.candidate_topk_ref]
    if case in PALLAS:
        runs.append(lambda *a, **kw: reference.bucket_topk
                    .candidate_topk_pallas(*a, bq=8, bc=16, interpret=True,
                                           **kw))
    b = o["q"].shape[0]
    outs = []
    for step in runs:
        bd = jnp.full((b, k), jnp.inf, jnp.float32)
        bi = jnp.full((b, k), -1, jnp.int32)
        for j in range(o["probe"].shape[1]):
            sel = o["probe"][:, j]
            bd, bi = step(q, jnp.asarray(o["bucket_vecs"][sel]),
                          jnp.asarray(o["bucket_ids"][sel]), k,
                          best_d=bd, best_i=bi)
        outs.append((bd, jnp.where(jnp.isinf(bd), -1, bi)))
    if case[-1] == "repeat":
        _same(chain_union_topk(t["q"], t["probe"], t["bucket_ids"], t["db"],
                               k), *outs[1:])
        outs = outs[:1]
    _same(port, *outs)


@pytest.mark.parametrize("case", CHAIN_EDGES, ids=_ids(CHAIN_EDGES))
def test_row_sources_agree_and_keep_the_contract(case):
    """Both row sources give the same bits; off a repeated probe they are
    the (distance, id) rule's answer; unfilled slots are (inf, -1)."""
    o, t = _operands(case)
    k = o["k"]
    by_slot = ref.bucket_probe_topk_ref(t["q"], t["probe"], t["bucket_ids"],
                                        k, bucket_vecs=t["bucket_vecs"])
    by_id = ref.bucket_probe_topk_ref(t["q"], t["probe"], t["bucket_ids"], k,
                                      db=t["db"])
    _bits(by_slot, by_id)
    # the chain of per-step calls (on the card, per-step launches)
    _bits(by_slot, step_chain(t["q"], t["probe"], t["bucket_ids"],
                              t["bucket_vecs"], k))
    d, i = by_slot
    assert d.shape == i.shape == (o["q"].shape[0], k)
    assert (i[torch.isinf(d)] == -1).all() and (i[~torch.isinf(d)] >= 0).all()
    union = chain_union_topk(t["q"], t["probe"], t["bucket_ids"], t["db"], k)
    if case[-1] == "repeat":
        # the plain loop keeps both copies of a repeated bucket (as the
        # reference does); the kernel's rule keeps one
        assert not torch.equal(i, union[1])
    else:
        _bits(by_slot, union)


def test_chain_op_dispatches_by_device():
    o, t = _operands(CHAIN_EDGES[0])
    args = (t["q"], t["probe"], t["bucket_ids"], o["k"])
    n0 = bucket_topk.LAUNCHES.count
    for src in ({"bucket_vecs": t["bucket_vecs"]}, {"db": t["db"]}):
        _bits(ops.bucket_probe_topk_op(*args, **src),
              ref.bucket_probe_topk_ref(*args, **src))
    assert bucket_topk.LAUNCHES.count == n0
    with pytest.raises(ValueError, match="exactly one"):
        ops.bucket_probe_topk_op(*args)
    with pytest.raises(ValueError, match="exactly one"):
        ops.bucket_probe_topk_op(*args, db=t["db"],
                                 bucket_vecs=t["bucket_vecs"])
    # the kernel wrapper never takes a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        bucket_topk.bucket_probe_topk(*args, db=t["db"])


N, D, N_BUCKETS, B, K = 2048, 16, 32, 12, 10


@pytest.fixture(scope="module")
def built(reference):
    rng = np.random.default_rng(14)
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = db[:B] + 0.3 * rng.normal(size=(B, D)).astype(np.float32)
    geo = rng.normal(size=(N, 2)).astype(np.float32)
    qgeo = geo[:B] + 0.05 * rng.normal(size=(B, 2)).astype(np.float32)
    return db, q, geo, qgeo


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
def test_ivf_backend_runs_the_chain_as_before(reference, built, filtered):
    """The fused IVF local is one chain call: bit for bit the unfused
    step loop on the CPU (with a filter: bucket slots masked to -1 in
    place, mid-bucket), and the reference's answer."""
    db, q, _, _ = built
    rtl = reference.two_level
    theirs = rtl.build_two_level(db, rtl.TwoLevelConfig(
        n_clusters=N_BUCKETS, seed=0))
    arrays = {n: np.asarray(getattr(theirs, n)) for n in
              ("db", "centroids", "bucket_ids", "bucket_counts")}
    mine = index_from_arrays(arrays, {"n_clusters": N_BUCKETS, "seed": 0},
                             device="cpu")
    meta = MetadataTable({"pct": np.arange(N) % 100})
    kw = {"filter_spec": FilterSpec.range("pct", 0, 49)} if filtered else {}
    fused, unfused = (ShardedSearchBackend(
        mine, kind="ivf", k=K, nprobe_local=6, fused=f, metadata=meta,
        device="cpu")(q, **kw) for f in (True, False))
    np.testing.assert_array_equal(fused[1], unfused[1])
    np.testing.assert_array_equal(fused[0].view(np.int32),
                                  unfused[0].view(np.int32))
    if filtered:
        assert (np.arange(N) % 100 < 50)[fused[1][fused[1] >= 0]].all()
    else:
        ref_be = reference.backend.ShardedSearchBackend(
            jax.make_mesh((1, 1), ("data", "model")), theirs, kind="ivf",
            k=K, nprobe_local=6)
        _same(fused, ref_be(q))


@pytest.mark.parametrize("top", ["brute", "pq", "kdtree"])
def test_two_level_brute_bottom_runs_the_chain_as_before(reference, built,
                                                         top):
    """The two-level brute bottom is one chain call a query chunk: the
    reference's ids, at an nprobe where the kd top level pads its probe
    list with bucket 0 (a repeated bucket, kept twice on the CPU as in
    the reference)."""
    db, q, geo, qgeo = built
    rtl = reference.two_level
    feats = geo if top == "kdtree" else None
    theirs = rtl.build_two_level(db, rtl.TwoLevelConfig(
        n_clusters=N_BUCKETS, top=top, bottom="brute", kmeans_iters=4,
        seed=2), partition_features=feats)
    arrays = {n: np.asarray(getattr(theirs, n)) for n in
              ("db", "centroids", "bucket_ids", "bucket_counts")}
    if feats is not None:
        arrays["part_feats"] = theirs.part_feats
    if theirs.top_pq is not None:
        arrays["pq_codebooks"] = theirs.top_pq.codebooks
        arrays["pq_codes"] = theirs.top_pq.codes
    if theirs.top_kd is not None:
        arrays["kd"] = {"kind": theirs.top_kd.kind,
                        **{n: np.asarray(getattr(theirs.top_kd, n))
                           for n in TREE_ARRAYS}}
    mine = index_from_arrays(arrays, dataclasses.asdict(theirs.config),
                             device="cpu")
    qp = qgeo if top == "kdtree" else None
    for nprobe in (4, 24):
        kw = dict(nprobe=nprobe, query_chunk=5, query_partition_features=qp)
        md, mi, mw = mine.search(q, K, **kw)
        td, ti, tw = theirs.search(q, K, **kw)
        _same((md, mi), (td, ti))
        assert mw == tw
