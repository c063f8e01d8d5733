"""The served two-level slice on the CPU, held against the reference.

An index built by the reference is carried across with
``convert.index_from_arrays``, so both packages search the same buckets;
the port's ``TwoLevelIndex.search`` and its IVF and brute
``ShardedSearchBackend`` (fused and unfused) must return the reference's
ids, the reference's backend running on a 1-device mesh.  An index the
port builds itself is held by invariants: the same entity set, the caps
respected, and recall@10 within 1 pt of the reference's build at the
same seed (jnp and torch Lloyd steps round differently, so assignments
may differ).

Tolerance: ids exactly; distances to rtol=1e-5 plus atol=1e-4, because
XLA-CPU and torch-CPU fp32 products round differently (squared
distances here are O(10-100)).  Parity inputs are continuous normal
data, whose neighbours are never tied to within that rounding.
"""
from __future__ import annotations

import threading
import time
import types

import jax
import numpy as np
import pytest

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import index_from_arrays
from repro_torch.core.brute import brute_search
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.data.synthetic import CorpusSpec, make_corpus, make_queries
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.serve.cell import ServingCell

N, D, N_BUCKETS, B, NPROBE, K = 4096, 32, 64, 16, 8, 10
RTOL, ATOL = 1e-5, 1e-4


def _same(port, theirs):
    (pd, pi), (td, ti) = port, theirs
    pd, pi, td, ti = map(np.asarray, (pd, pi, td, ti))
    assert pi.shape == ti.shape == (B, K)
    assert (pi == ti).all(), f"{int((pi != ti).sum())} ids differ"
    np.testing.assert_allclose(pd, td, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def carried(reference):
    rng = np.random.default_rng(11)
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    ref_idx = reference.two_level.build_two_level(
        db, reference.two_level.TwoLevelConfig(
            n_clusters=N_BUCKETS, top="brute", bottom="brute", seed=0))
    arrays = {name: np.asarray(getattr(ref_idx, name)) for name in
              ("db", "centroids", "bucket_ids", "bucket_counts")}
    port_idx = index_from_arrays(arrays, {"n_clusters": N_BUCKETS, "seed": 0},
                                 device="cpu")
    return types.SimpleNamespace(
        db=db, q=q, ref_idx=ref_idx, port_idx=port_idx,
        mesh=jax.make_mesh((1, 1), ("data", "model")))


def test_two_level_search_matches_reference(carried):
    pd, pi, pw = carried.port_idx.search(carried.q, K, nprobe=NPROBE)
    td, ti, tw = carried.ref_idx.search(carried.q, K, nprobe=NPROBE)
    _same((pd, pi), (td, ti))
    assert pw == tw


@pytest.mark.parametrize("kind,fused,alive", [
    ("ivf", True, False), ("ivf", False, False),
    ("brute", True, False), ("brute", False, False),
    ("brute", True, True)])
def test_backend_matches_reference(reference, carried, kind, fused, alive):
    target_ref = carried.ref_idx if kind == "ivf" else carried.db
    target_port = carried.port_idx if kind == "ivf" else carried.db
    mask = None
    if alive:
        mask = np.random.default_rng(12).random(N) > 0.3
    port = ShardedSearchBackend(target_port, kind=kind, k=K,
                                nprobe_local=NPROBE, fused=fused, alive=mask,
                                device="cpu")(carried.q)
    theirs = reference.backend.ShardedSearchBackend(
        carried.mesh, target_ref, kind=kind, k=K, nprobe_local=NPROBE,
        fused=fused, alive=mask)(carried.q)
    _same(port, theirs)
    if alive:
        assert not np.isin(port[1], np.flatnonzero(~mask)).any()


def test_fused_and_unfused_agree_on_the_cpu(carried):
    for kind, target in (("ivf", carried.port_idx), ("brute", carried.db)):
        a = ShardedSearchBackend(target, kind=kind, k=K, nprobe_local=NPROBE,
                                 device="cpu")(carried.q)
        b = ShardedSearchBackend(target, kind=kind, k=K, nprobe_local=NPROBE,
                                 fused=False, device="cpu")(carried.q)
        assert (a[1] == b[1]).all()
        np.testing.assert_array_equal(a[0], b[0])


def test_kmeans_same_seed_samples_the_same_rows(reference):
    """The host rng streams are the reference's: with no Lloyd step the
    centroids are the same sampled rows; with mini-batch steps the same
    rows are drawn, so the centroids stay within rounding."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4096, 16)).astype(np.float32)
    mine = kmeans_fit(x, 16, iters=0, seed=3, device="cpu")
    theirs = reference.kmeans.kmeans_fit(x, 16, iters=0, seed=3)
    np.testing.assert_array_equal(mine.centroids, theirs.centroids)
    assert (mine.assignments == theirs.assignments).all()
    mine = kmeans_fit(x, 16, iters=3, seed=3, minibatch=2048, chunk=512,
                      device="cpu")
    theirs = reference.kmeans.kmeans_fit(x, 16, iters=3, seed=3,
                                         minibatch=2048, chunk=512)
    np.testing.assert_allclose(mine.centroids, theirs.centroids,
                               rtol=1e-4, atol=1e-4)
    assert mine.n_iter == theirs.n_iter


def test_port_built_index_holds_the_reference_invariants(reference):
    spec = CorpusSpec("clustered", N, D, N_BUCKETS)
    db = make_corpus(spec, seed=0)
    q = make_queries(db, 64, seed=1)
    _, truth = brute_search(q, db, K, device="cpu")
    cfg = dict(n_clusters=N_BUCKETS, top="brute", bottom="brute", seed=0)
    mine = build_two_level(db, TwoLevelConfig(**cfg), device="cpu")
    theirs = reference.two_level.build_two_level(
        db, reference.two_level.TwoLevelConfig(**cfg))
    for idx in (mine, theirs):
        ids = idx.bucket_ids[idx.bucket_ids >= 0]
        assert np.array_equal(np.sort(ids), np.arange(N))
        assert int(idx.bucket_counts.sum()) == N
        assert (idx.bucket_counts <= idx.bucket_ids.shape[1]).all()
        filled = (idx.bucket_ids >= 0).sum(1)
        assert (filled == idx.bucket_counts).all()
    cap_rule = min(int(np.bincount(theirs.entity_bucket).max()),
                   max(int(np.ceil(2.5 * N / N_BUCKETS)), 32))
    assert mine.bucket_ids.shape[1] <= max(cap_rule,
                                           theirs.bucket_ids.shape[1])
    assert (mine.entity_bucket[mine.bucket_ids[mine.bucket_ids >= 0]]
            >= 0).all()
    r_mine = recall_at_k(mine.search(q, K, nprobe=NPROBE)[1], truth)
    r_theirs = recall_at_k(theirs.search(q, K, nprobe=NPROBE)[1], truth)
    assert abs(r_mine - r_theirs) <= 0.01, (r_mine, r_theirs)


def test_serving_cell_matches_backend_and_counts(carried):
    backend = ShardedSearchBackend(carried.port_idx, kind="ivf", k=K,
                                   nprobe_local=NPROBE, device="cpu")
    direct = backend(carried.q)
    cell = ServingCell(backend, max_batch=8, max_wait_ms=5.0)
    out = [None] * B

    def client(rows):
        for r in rows:
            out[r] = cell.search(carried.q[r], timeout=60)

    threads = [threading.Thread(target=client, args=(range(c, B, 4),))
               for c in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = cell.stats()
    finally:
        cell.close()
    ids = np.stack([o[1] for o in out])
    dists = np.stack([o[0] for o in out])
    assert (ids == direct[1]).all()
    np.testing.assert_allclose(dists, direct[0], rtol=RTOL, atol=ATOL)
    assert stats.n == B and sum(stats.batch_sizes) == B
    assert max(stats.batch_sizes) <= 8
    assert {"queue", "batch", "dispatch", "kernel", "rerank"} <= set(
        stats.stages)
    assert backend.metrics.get("dispatches").value == len(
        stats.batch_sizes) + 1


def test_serving_cell_cancels_on_timeout_and_fails_fast():
    release = threading.Event()

    def slow(qs):
        release.wait(10)
        return np.zeros((len(qs), 1), np.float32), np.zeros((len(qs), 1),
                                                             np.int32)

    cell = ServingCell(slow, max_batch=4, max_wait_ms=1.0)
    try:
        cell.submit(np.zeros(4, np.float32))      # occupies the worker
        time.sleep(0.2)
        with pytest.raises(TimeoutError):
            cell.search(np.zeros(4, np.float32), timeout=0.2)
        release.set()
        time.sleep(0.3)
        assert cell.n_cancelled == 1
        assert cell.stats().n == 1                # the cancelled one is not
    finally:
        cell.close()

    def broken(qs):
        raise ValueError("backend down")

    cell = ServingCell(broken)
    try:
        with pytest.raises(RuntimeError, match="backend failed"):
            cell.search(np.zeros(4, np.float32), timeout=10)
        assert isinstance(cell.failure(), ValueError)
    finally:
        cell.close()
