"""The fleet tier on the CPU, held against the reference.

* routing keys: ``query_key`` and the cells' rendezvous salts equal the
  reference's, so the port's router prefers the same cell for every
  query (200 queries, 4 cells, and again with a cell down);
* the reference's behaviour tests of the fleet (``tests/test_fleet.py``)
  mirrored on plain callables: cancellation and fail-fast cells,
  admission and shedding, stable and minimal-remap affinity, the
  cross-cell hedge, rerouting with no request lost, the cache at the
  affinity cell, the rolling aggregate of a fan-out, the replay of
  missed manifests at ``revive``, the scheduler as the fleet's leader
  (a QLBT index at the reference test's size) and the fleet stats;
* conformance: a 2-cell fleet over the port's IVF backends
  (``device="cpu"``) against the reference's ``build_fleet`` on the same
  carried index, routed answers (ids exactly, distances to rtol 1e-5:
  ROADMAP fault 2) and every cell's ``apply_updates`` stats equal before
  and after an add / delete fan-out, a fan-out a down cell misses and
  its ``revive``;
* the launcher, ``python -m repro_torch.launch.serve --device cpu``, at
  a small scale.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from test_torch_forest_slice import carry
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.serve.cell import CellFailure, ServingCell
from repro_torch.serve.fleet import (CellRouter, FleetOverloadError,
                                     _mix64, _salt_of, build_fleet,
                                     query_key)

N, D, NB, NPROBE, K = 3000, 16, 24, 4, 10
RTOL = 1e-5


def _ok_fn(qs):
    b = qs.shape[0]
    return (np.zeros((b, 3), np.float32),
            np.tile(np.arange(3), (b, 1)).astype(np.int64))


def _slow_fn(delay_s):
    def fn(qs):
        time.sleep(delay_s)
        return _ok_fn(qs)

    return fn


def _query(rng):
    return rng.normal(size=(4,)).astype(np.float32)


def _query_for(router, rng, cell_name):
    for _ in range(1000):
        q = _query(rng)
        if router.preferred_cell(q).name == cell_name:
            return q
    raise AssertionError(f"no query routed to {cell_name} in 1000 draws")


def _cells(n, fn=_ok_fn, **kw):
    return [ServingCell(fn, name=f"cell{i}", max_wait_ms=0.5, **kw)
            for i in range(n)]


# ------------------------------------------------------------ routing
def test_routing_keys_and_choices_equal_the_reference(reference):
    rng = np.random.default_rng(0)
    qs = [rng.normal(size=(8,)).astype(np.float32) for _ in range(200)]
    qs += [q.astype(np.float64) for q in qs[:20]]
    for q in qs:
        assert query_key(q) == reference.fleet.query_key(q)
    names = [f"cell{i}" for i in range(4)] + ["west-2"]
    assert [_salt_of(n) for n in names] == [reference.fleet._salt_of(n)
                                            for n in names]
    for a in range(0, 2**64, 2**60 + 12345):
        assert _mix64(a) == reference.fleet._mix64(a)
    mine = CellRouter(_cells(4))
    theirs = reference.fleet.CellRouter(
        [reference.cell.ServingCell(_ok_fn, name=f"cell{i}", max_wait_ms=0.5)
         for i in range(4)])
    try:
        for router in (mine, theirs):
            router.before = [router.preferred_cell(q).name for q in qs]
        assert mine.before == theirs.before
        for router in (mine, theirs):
            with router._lock:
                router._mark_down("cell1", RuntimeError("x"))
        assert ([mine.preferred_cell(q).name for q in qs]
                == [theirs.preferred_cell(q).name for q in qs])
    finally:
        mine.close()
        theirs.close()


# ----------------------------------------------------------- behaviour
def test_cell_timeout_cancels_and_excludes_from_stats():
    cell = ServingCell(_slow_fn(0.3), name="slow", max_wait_ms=0.5)
    try:
        with pytest.raises(TimeoutError):
            cell.search(np.ones(4, np.float32), timeout=0.05)
        time.sleep(0.8)
        st = cell.stats()
        assert st.cancelled == 1 and st.n == 0
        d, _ = cell.search(np.ones(4, np.float32), timeout=5.0)
        assert d.shape == (3,)
        st = cell.stats()
        assert st.n == 1 and st.cancelled == 1
    finally:
        cell.close()


def test_cell_backend_failure_fails_fast_and_close_fails_queued():
    boom = {"on": True}

    def flaky(qs):
        if boom["on"]:
            raise RuntimeError("boom")
        return _ok_fn(qs)

    cell = ServingCell(flaky, name="flaky", max_wait_ms=0.5)
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="backend failed"):
            cell.search(np.ones(4, np.float32), timeout=10.0)
        assert time.perf_counter() - t0 < 5.0
        assert isinstance(cell.failure(), RuntimeError)
        boom["on"] = False
        d, _ = cell.search(np.ones(4, np.float32), timeout=5.0)
        assert d.shape == (3,)
    finally:
        cell.close()
    cell = ServingCell(_slow_fn(0.5), name="c", max_wait_ms=0.5, max_batch=1)
    fut1 = cell.submit(np.ones(4, np.float32))
    fut2 = cell.submit(np.ones(4, np.float32))
    cell.close()
    outs = [fut1.get(timeout=6.0), fut2.get(timeout=6.0)]
    assert any(isinstance(o, CellFailure) for o in outs)


def test_router_admission_sheds_with_retriable_signal():
    gate = threading.Event()

    def blocked(qs):
        gate.wait(60.0)
        return _ok_fn(qs)

    cell = ServingCell(blocked, name="cell0", max_wait_ms=0.5, max_batch=1)
    router = CellRouter([cell], max_queue_depth=2)
    threads = [threading.Thread(target=lambda j=j: router.search(
        np.full(4, j, np.float32), timeout=90.0), daemon=True)
        for j in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 15.0
        while cell.depth() < 2 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert cell.depth() >= 2, "setup never saturated the queue"
        with pytest.raises(FleetOverloadError) as ei:
            router.search(np.full(4, 99, np.float32), timeout=1.0)
        assert ei.value.retriable is True
        assert router.stats().shed == 1
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=5.0)
        router.close()
    with pytest.raises(ValueError, match="at least one"):
        CellRouter([])
    twins = [ServingCell(_ok_fn), ServingCell(_ok_fn)]
    with pytest.raises(ValueError, match="unique"):
        CellRouter(twins)
    for c in twins:
        c.close()


def test_router_affinity_is_stable_balanced_and_remaps_minimally():
    router = CellRouter(_cells(4))
    try:
        rng = np.random.default_rng(1)
        qs = [_query(rng) for _ in range(400)]
        before = [router.preferred_cell(q).name for q in qs]
        assert before == [router.preferred_cell(q).name for q in qs]
        counts = {n: before.count(n) for n in set(before)}
        assert len(counts) == 4
        assert all(c > 400 / 4 / 3 for c in counts.values()), counts
        with router._lock:
            router._mark_down("cell2", RuntimeError("x"))
        after = [router.preferred_cell(q).name for q in qs]
        for b, a in zip(before, after):
            assert a == b if b != "cell2" else a != "cell2"
        assert router.revive("cell2") is None
        assert [router.preferred_cell(q).name for q in qs] == before
    finally:
        router.close()


def test_router_cross_cell_hedge():
    cells = [ServingCell(_slow_fn(0.5), name="cell0", max_wait_ms=0.5),
             ServingCell(_ok_fn, name="cell1", max_wait_ms=0.5)]
    router = CellRouter(cells, hedge_ms=30.0)
    try:
        q = _query_for(router, np.random.default_rng(2), "cell0")
        t0 = time.perf_counter()
        d, _ = router.search(q, timeout=10.0)
        assert d.shape == (3,)
        assert time.perf_counter() - t0 < 0.4
        assert router.stats().hedge_cell == 1
    finally:
        router.close()


def test_router_reroutes_on_cell_failure_and_sheds_when_all_down():
    def failing(qs):
        raise RuntimeError("dead mesh")

    cells = [ServingCell(failing, name="cell0", max_wait_ms=0.5),
             ServingCell(_ok_fn, name="cell1", max_wait_ms=0.5)]
    router = CellRouter(cells)
    try:
        q = _query_for(router, np.random.default_rng(3), "cell0")
        d, _ = router.search(q, timeout=10.0)
        assert d.shape == (3,)
        assert router.stats().rerouted == 1
        assert "cell0" in router.down_cells()
        assert router.preferred_cell(q).name == "cell1"
        with router._lock:
            router._mark_down("cell1", RuntimeError("x"))
        with pytest.raises(FleetOverloadError):
            router.search(q, timeout=1.0)
    finally:
        router.close()


def test_router_zero_lost_requests_under_cell_failure():
    switch = threading.Event()

    def flaky(qs):
        if switch.is_set():
            raise RuntimeError("injected failure")
        return _ok_fn(qs)

    cells = [ServingCell(flaky, name="cell0", max_wait_ms=0.5)]
    cells += [ServingCell(_ok_fn, name=f"cell{i}", max_wait_ms=0.5)
              for i in (1, 2)]
    router = CellRouter(cells, max_queue_depth=64)
    try:
        rng = np.random.default_rng(4)
        queries = [_query(rng) for _ in range(60)]
        ok, errors = [], []

        def client(chunk):
            for q in chunk:
                try:
                    ok.append(router.search(q, timeout=15.0)[0].shape)
                except Exception as e:   # counted: a lost request
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(queries[i::6],),
                                    daemon=True) for i in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        switch.set()
        for t in threads:
            t.join(timeout=30.0)
        assert not errors, f"lost {len(errors)} requests: {errors[:3]}"
        assert len(ok) == 60
    finally:
        router.close()


def test_router_search_uses_affinity_cell_cache():
    from repro_torch.adaptive import FrequencyAdmissionCache

    cells = [ServingCell(_ok_fn, name=f"cell{i}", max_wait_ms=0.5,
                         cache=FrequencyAdmissionCache(capacity=32))
             for i in range(2)]
    router = CellRouter(cells)
    try:
        q = _query(np.random.default_rng(5))
        pref = router.preferred_cell(q)
        router.search(q, timeout=5.0)
        router.search(q, timeout=5.0)
        assert pref.cache.hits >= 1
        other = next(c for c in router.cells if c is not pref)
        assert other.cache.hits == 0, "affinity leaked to the other cache"
    finally:
        router.close()


class _Backend:
    def __init__(self):
        self.applied = []

    def __call__(self, qs):
        return _ok_fn(qs)

    def apply_updates(self, target, delta=None, **kw):
        self.applied.append(delta)
        return {"mode": "delta" if delta is not None else "full",
                "bytes": 7, "full_bytes": 100, "reason": None}


def test_router_apply_updates_rolls_and_aggregates():
    class _Target:
        def __init__(self):
            self.pops = 0

        def pop_delta(self):
            self.pops += 1
            return f"manifest-{self.pops}"

    backends = [_Backend() for _ in range(3)]
    router = CellRouter([ServingCell(b, name=f"cell{i}", max_wait_ms=0.5)
                         for i, b in enumerate(backends)])
    try:
        target = _Target()
        agg = router.apply_updates(target)
        assert target.pops == 1
        assert all(b.applied == ["manifest-1"] for b in backends)
        assert agg["mode"] == "delta"
        assert agg["bytes"] == 21 and agg["full_bytes"] == 300
        assert set(agg["cells"]) == {"cell0", "cell1", "cell2"}
        with router._lock:
            router._mark_down("cell1", RuntimeError("x"))
        agg2 = router.apply_updates(target)
        assert target.pops == 2
        assert agg2["cells"]["cell1"]["mode"] == "skipped"
        assert len(backends[1].applied) == 1 and len(backends[0].applied) == 2
        assert router.stats().republished_bytes == 7 * 3 + 7 * 2
    finally:
        router.close()


def test_revive_replays_missed_manifests_before_rejoin():
    from repro_torch.core.delta import DeltaManifest

    def _man(bv, v, bn, n, dirty, tombs=()):
        return DeltaManifest(
            base_version=bv, version=v, base_n=bn, n=n,
            dirty_buckets=np.asarray(dirty, np.int64),
            tombstones=np.asarray(tombs, np.int64))

    backends = [_Backend() for _ in range(3)]
    router = CellRouter([ServingCell(b, name=f"cell{i}", max_wait_ms=0.5)
                         for i, b in enumerate(backends)])
    try:
        target = object()
        router.apply_updates(target, delta=_man(0, 1, 10, 10, [0]))
        with router._lock:
            router._mark_down("cell1", RuntimeError("x"))
        router.apply_updates(target, delta=_man(1, 2, 10, 12, [1, 3]))
        router.apply_updates(target, delta=_man(2, 3, 12, 12, [3, 5],
                                                tombs=[7]))
        assert len(backends[1].applied) == 1
        rep = router.revive("cell1")
        assert len(backends[1].applied) == 2
        merged = backends[1].applied[-1]
        assert (merged.base_version, merged.version) == (1, 3)
        assert (merged.base_n, merged.n) == (10, 12)
        assert merged.dirty_buckets.tolist() == [1, 3, 5]
        assert merged.tombstones.tolist() == [7]
        assert rep["mode"] == "delta"
        assert "cell1" not in router.down_cells()
        assert router.stats().resyncs == 1
        with router._lock:
            router._mark_down("cell2", RuntimeError("x"))
        router.apply_updates(target, delta=_man(3, 4, 12, 13, [2]))
        router.apply_updates(target, delta=None)
        router.revive("cell2")
        assert backends[2].applied[-1] is None, "expected forced re-place"
        assert router.stats().resyncs == 2
        with router._lock:
            router._mark_down("cell0", RuntimeError("x"))
        n_before = len(backends[0].applied)
        assert router.revive("cell0") is None
        assert len(backends[0].applied) == n_before
        assert router.stats().resyncs == 2
    finally:
        router.close()


def test_maintenance_scheduler_as_fleet_leader():
    """One drift decision on the shared estimator, one reboost, one
    manifest fanned out to every cell, every cache invalidated (a QLBT
    index at the reference test's size)."""
    from repro_torch.adaptive import (FrequencyAdmissionCache,
                                      HostIndexBackend, MaintenanceScheduler,
                                      OnlineLikelihoodEstimator)
    from repro_torch.core.index import SearchIndex
    from repro_torch.core.protocol import IndexSpec
    from repro_torch.core.tree import build_qlbt

    rng = np.random.default_rng(6)
    n, d = 256, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    p0 = np.full(n, 1.0 / n)
    idx = SearchIndex(spec=IndexSpec(kind="qlbt"), db=db,
                      tree=build_qlbt(db, p0, seed=1), p=p0, device="cpu")
    est = OnlineLikelihoodEstimator(n, reference=p0, halflife=64,
                                    device="cpu")
    backends = [HostIndexBackend(idx, k=5) for _ in range(2)]
    cells = [ServingCell(b, name=f"cell{i}", max_wait_ms=0.5,
                         cache=FrequencyAdmissionCache(capacity=16),
                         estimator=est)
             for i, b in enumerate(backends)]
    router = CellRouter(cells)
    sched = MaintenanceScheduler(est, idx, engine=router, interval_s=None,
                                 drift_threshold=0.05, min_observations=32,
                                 cooldown_observations=1, rebalance=False)
    try:
        _, i0 = router.search(db[3], timeout=30.0)
        assert i0[0] == 3
        gens = [c.cache.generation for c in cells]
        for _ in range(40):
            est.observe(np.arange(4))
        ev = sched.check_now()
        assert ev is not None, "leader never triggered"
        assert set(ev["republish"]["cells"]) == {"cell0", "cell1"}
        assert all(b.index is idx for b in backends)
        assert all(b.last_delta is backends[0].last_delta for b in backends)
        assert all(c.cache.generation == g + 1
                   for c, g in zip(cells, gens))
        assert est.drift()["tv"] < 1e-9
        _, i1 = router.search(db[3], timeout=30.0)
        assert i1[0] == 3
    finally:
        sched.close()
        router.close()


def test_build_fleet_shares_one_estimator_and_stats_aggregate():
    from repro_torch.adaptive import OnlineLikelihoodEstimator

    rng = np.random.default_rng(8)
    db = rng.normal(size=(128, 8)).astype(np.float32)
    est = OnlineLikelihoodEstimator(128, device="cpu")
    router = build_fleet(["cpu", "cpu"], db, kind="brute", k=5,
                         cache_capacity=16, estimator=est,
                         cell_kw=dict(max_wait_ms=0.5))
    try:
        assert all(c.estimator is est for c in router.cells)
        assert router.cells[0].cache is not router.cells[1].cache
        assert all(c.search_fn.device.type == "cpu" for c in router.cells)
        for j in range(12):
            d, i = router.search(db[j], timeout=30.0)
            assert d.shape == (5,) and i[0] == j
        deadline = time.perf_counter() + 5.0
        while est.n_total < 12 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert est.n_total == 12
        st = router.stats()
        assert st.n == 12 and set(st.cells) == {"cell0", "cell1"}
        assert sum(s.n for s in st.cells.values()) == 12
        assert st.cache_misses == 12 and "route" in st.stages
        snap = router.metrics_snapshot()
        assert any(k.startswith("router.") for k in snap)
        assert "cell0_backend_kernel_ms" in router.exposition()
    finally:
        router.close()


# --------------------------------------------------------- conformance
def _fleet_inputs():
    rng = np.random.default_rng(11)
    c = rng.normal(size=(20, D)) * 4
    db = (c[rng.integers(0, 20, N)] + rng.normal(size=(N, D))).astype(
        np.float32)
    q = (db[rng.choice(N, 40, replace=False)]
         + 0.05 * rng.normal(size=(40, D))).astype(np.float32)
    return db, q


def _mutations(idx):
    """Bucket-local mutations (so each ships a delta): 15 vectors near
    each of buckets 3 and 11; the first 10 members of buckets 5, 17 and
    20 to delete."""
    rng = np.random.default_rng(12)
    cents = np.asarray(idx.centroids)
    new = (np.repeat(cents[[3, 11]], 15, axis=0)
           + 0.2 * rng.normal(size=(30, D))).astype(np.float32)
    bids, counts = np.asarray(idx.bucket_ids), np.asarray(idx.bucket_counts)
    gone = np.concatenate([bids[b][:min(int(counts[b]), 10)]
                           for b in (5, 17, 20)]).astype(np.int64)
    return new, gone


def _routed(router, q):
    outs = [router.search(x, timeout=60.0) for x in q]
    return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])


def _same(mine, theirs, q, db):
    assert np.array_equal(mine[1], np.asarray(theirs[1]))
    scale = ((q.astype(np.float64) ** 2).sum(1)[:, None]
             + (db.astype(np.float64) ** 2).sum(1)[np.maximum(mine[1], 0)])
    assert (np.abs(mine[0] - np.asarray(theirs[0])) <= RTOL * scale).all()


def test_fleet_equals_the_reference_through_fan_out_and_revive(reference):
    import jax

    db, q = _fleet_inputs()
    tl = reference.two_level
    ref_idx = tl.build_two_level(db, tl.TwoLevelConfig(
        n_clusters=NB, top="brute", bottom="brute", kmeans_iters=5))
    new, gone = _mutations(ref_idx)
    mine_idx = carry(ref_idx)
    auto = jax.sharding.AxisType.Auto
    meshes = [jax.make_mesh((1,), ("data",), axis_types=(auto,))
              for _ in range(2)]
    kw = dict(kind="ivf", k=K, cache_capacity=64,
              backend_kw=dict(nprobe_local=NPROBE, headroom=1.5),
              cell_kw=dict(max_wait_ms=0.5))
    theirs = reference.fleet.build_fleet(meshes, ref_idx, **kw)
    mine = build_fleet(["cpu", "cpu"], mine_idx, **kw)
    try:
        assert ([mine.preferred_cell(x).name for x in q]
                == [theirs.preferred_cell(x).name for x in q])
        _same(_routed(mine, q), _routed(theirs, q), q, db)
        _same(_routed(mine, q), _routed(theirs, q), q, db)     # cache hits
        assert mine.stats().cache_hits == theirs.stats().cache_hits > 0
        steps = (("add", lambda x: x.add_entities(new)),
                 ("delete", lambda x: x.delete_entities(gone[:20])),
                 ("down", lambda x: x.delete_entities(gone[20:])))
        for name, op in steps:
            if name == "down":
                for router in (mine, theirs):
                    with router._lock:
                        router._mark_down("cell1", RuntimeError("x"))
            op(mine_idx)
            op(ref_idx)
            a, b = mine.apply_updates(mine_idx), theirs.apply_updates(ref_idx)
            assert a == b, name
            assert a["mode"] == "delta"
            dbn = np.asarray(ref_idx.db)
            _same(_routed(mine, q), _routed(theirs, q), q, dbn)
            _same(_routed(mine, new), _routed(theirs, new), new, dbn)
        assert mine.revive("cell1") == theirs.revive("cell1")
        assert mine.stats().resyncs == theirs.stats().resyncs == 1
        for router in (mine, theirs):
            router.cells[0].close()               # only cell1 answers now
        _same(_routed(mine, q), _routed(theirs, q), q, dbn)
        got = _routed(mine, q)[1]
        assert not np.isin(got, gone).any()
        st_m, st_t = mine.stats(), theirs.stats()
        assert st_m.republished_bytes == st_t.republished_bytes
        assert st_m.delta_fraction == st_t.delta_fraction
    finally:
        mine.close()
        theirs.close()


# ------------------------------------------------------------ launcher
def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "sift-1m", "--scale", "0.005", "--n-requests",
                "64", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "sift-1m: corpus 5000 x 128, 81 buckets, top=pq bottom=brute" \
        in text
    assert "recall@10 = " in text and "paper bars: recall>0.8 PASS" in text
    assert out["recall"] > 0.8 and out["p90_ms"] > 0
