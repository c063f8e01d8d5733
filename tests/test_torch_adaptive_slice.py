"""The adaptive loop on the CPU, held against the reference.

The port's count-min sketch, likelihood estimator, result cache and
maintenance scheduler (``repro_torch.adaptive``) against the reference's
(``repro.adaptive``) on the same seeded numpy inputs:

* the sketch's hash columns equal the reference's exactly (ids near
  2**31 and the multipliers ``default_rng(seed)`` draws), and its table,
  heavy-hitter ids and estimates equal the reference's bit for bit over
  20 decayed batches, with unit weights and with weights (the port adds
  to a cell in batch order, as the reference's scatter does);
* the estimator's ``likelihood``, ``current_raw`` and ``drift`` equal
  the reference's to rtol 1e-9 in the sketch and the exact modes, through
  ``resize`` and invalid ids;
* the cache keys and the cell's option suffix (``_opts_extra``) are the
  reference's bytes, filters included;
* the reference's own behaviour tests of the sketch, cache, engine and
  scheduler (``tests/test_adaptive.py``) mirrored on the port.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.adaptive import (CountMinSketch, FrequencyAdmissionCache,
                                  MaintenanceScheduler,
                                  OnlineLikelihoodEstimator)
from repro_torch.kernels.ref import count_min_host_columns
from repro_torch.core.likelihood import zipf_likelihood
from repro_torch.core.metadata import FilterSpec
from repro_torch.serve.cell import _opts_extra
from repro_torch.serve.engine import ServingEngine

RTOL = 1e-9          # estimator outputs: float64 arithmetic on equal counts


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                          b.view(np.int32) if b.dtype == np.float32 else b)


def _batches(seed: int, n_ids: int, weighted: bool):
    """20 batches of ids (sizes not powers of two, repeats, an invalid id)
    and weights (None for unit weights)."""
    rng = np.random.default_rng(seed)
    p = zipf_likelihood(n_ids, 1.1)
    out = []
    for t in range(20):
        ids = rng.choice(n_ids, 17 + 7 * t, p=p).astype(np.int64)
        if t % 5 == 3:
            ids[0] = -1
        w = (rng.random(ids.size).astype(np.float32) * 3
             if weighted else None)
        out.append((ids, w))
    return out


# --------------------------------------------------------------- sketch
@pytest.mark.parametrize("seed", [0, 7])
def test_sketch_columns_equal_the_reference(reference, seed):
    import jax.numpy as jnp

    ref = reference.sketch.CountMinSketch(width=4096, depth=4, seed=seed)
    mine = CountMinSketch(width=4096, depth=4, seed=seed, device="cpu")
    assert np.array_equal(mine._a.numpy(), np.asarray(ref._a).astype(np.int64))
    assert np.array_equal(mine._b.numpy(), np.asarray(ref._b).astype(np.int64))
    ids = np.concatenate([np.arange(2**31 - 64, 2**31),
                          np.arange(0, 64), [12345, 999_999, 2**30]])
    want = np.asarray(reference.sketch._hash(jnp.asarray(ids, jnp.int32),
                                             ref._a, ref._b, 4096))
    assert np.array_equal(mine.columns(ids), want)
    # the host's columns, which plan the plain version's adds, are the same
    assert np.array_equal(count_min_host_columns(
        ids, mine._a.numpy().astype(np.uint64),
        mine._b.numpy().astype(np.uint64), 4096), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_sketch_state_equals_the_reference(reference, weighted):
    ref = reference.sketch.CountMinSketch(width=512, depth=4, topk=16,
                                          halflife=200.0, seed=3)
    mine = CountMinSketch(width=512, depth=4, topk=16, halflife=200.0,
                          seed=3, device="cpu")
    for ids, w in _batches(1, 300, weighted):
        ref.update(ids, w)
        mine.update(ids, w)
        _bits(mine.table.numpy(), np.asarray(ref.table))
        _bits(mine.hh_ids.numpy(), np.asarray(ref.hh_ids))
        _bits(mine.hh_est.numpy(), np.asarray(ref.hh_est))
        assert mine.n_observed == ref.n_observed
    q = np.arange(-2, 310)
    _bits(mine.query(q), np.asarray(ref.query(q)))
    for a, b in zip(mine.heavy_hitters(), ref.heavy_hitters()):
        _bits(a, b)


def test_sketch_overestimates_and_tracks_heavy_hitters():
    rng = np.random.default_rng(0)
    s = CountMinSketch(width=1024, depth=4, topk=16, seed=0, device="cpu")
    ids = rng.choice(100, 4000, p=zipf_likelihood(100, 1.2))
    for lo in range(0, ids.size, 512):
        s.update(ids[lo:lo + 512])
    true = np.bincount(ids, minlength=100)
    est = s.query(np.arange(100))
    assert (est >= true - 1e-3).all(), "CMS estimates must be conservative"
    hh, he = s.heavy_hitters()
    top5 = set(np.argsort(true)[::-1][:5].tolist())
    assert len(top5 & set(hh.tolist())) >= 4
    assert (np.diff(he) <= 1e-6).all(), "heavy hitters sorted descending"


def test_sketch_decay_fades_old_traffic_and_resets():
    s = CountMinSketch(width=1024, depth=4, topk=8, halflife=100, seed=0,
                       device="cpu")
    s.update(np.zeros(200, np.int64))
    s.update(np.ones(400, np.int64))         # id 0 decayed by 0.5**4
    e = s.query(np.array([0, 1]))
    assert e[0] < 0.2 * 200 and e[1] >= 400 - 1e-3
    s.reset()
    assert s.query(np.array([0, 1])).sum() == 0 and s.n_observed == 0


def test_sketch_width_must_be_power_of_two_and_device_explicit():
    with pytest.raises(ValueError, match="power of two"):
        CountMinSketch(width=1000, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CountMinSketch()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OnlineLikelihoodEstimator(16)


# ------------------------------------------------------------ estimator
def _estimator_pair(reference, n, width, ref_p=None):
    kw = dict(reference=ref_p, halflife=256.0, width=width, depth=4,
              topk=16, seed=5)
    return (OnlineLikelihoodEstimator(n, device="cpu", **kw),
            reference.estimator.OnlineLikelihoodEstimator(n, **kw))


def _same_estimates(mine, ref):
    np.testing.assert_allclose(mine.likelihood(), ref.likelihood(),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(mine.current_raw(), ref.current_raw(),
                               rtol=RTOL, atol=0)
    dm, dr = mine.drift(), ref.drift()
    assert dm.keys() == dr.keys()
    for key in dm:
        np.testing.assert_allclose(dm[key], dr[key], rtol=RTOL, atol=1e-15)
    assert mine.n_total == ref.n_total and mine.n == ref.n
    for a, b in zip(mine.heavy_hitters(), ref.heavy_hitters()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("width", [1024, None])
def test_estimator_equals_the_reference(reference, width):
    n = 400
    rng = np.random.default_rng(2)
    p0 = np.empty(n)
    p0[rng.permutation(n)] = zipf_likelihood(n, 1.2)
    mine, ref = _estimator_pair(reference, n, width, ref_p=p0)
    _same_estimates(mine, ref)               # before any traffic
    for t, (ids, _) in enumerate(_batches(4, n + 30, False)):
        # ids past n are dropped until the resize; -1 always
        assert mine.observe(ids) == ref.observe(ids)
        if t == 9:
            mine.resize(n + 30)
            ref.resize(n + 30)
        _same_estimates(mine, ref)
    mine.set_reference(mine.current_raw())
    ref.set_reference(ref.current_raw())
    _same_estimates(mine, ref)
    with pytest.raises(ValueError, match="shrink"):
        mine.resize(n)


@pytest.mark.parametrize("width", [4096, None])
def test_estimator_drift_detects_rotation_and_resets(width):
    rng = np.random.default_rng(2)
    n = 512
    z = zipf_likelihood(n, 1.2)
    p0 = np.empty(n)
    p0[rng.permutation(n)] = z
    p1 = np.empty(n)
    p1[rng.permutation(n)] = z
    est = OnlineLikelihoodEstimator(n, reference=p0, halflife=1024,
                                    width=width, device="cpu")
    for _ in range(8):
        est.observe(rng.choice(n, 256, p=p0))
    stationary = est.drift()
    for _ in range(8):
        est.observe(rng.choice(n, 256, p=p1))
    drifted = est.drift()
    assert drifted["tv"] > stationary["tv"] + 0.2, (stationary, drifted)
    assert drifted["kl"] > stationary["kl"]
    est.set_reference(est.likelihood())
    assert est.drift()["tv"] < stationary["tv"] + 0.05


def test_estimator_ignores_invalid_ids():
    est = OnlineLikelihoodEstimator(16, width=None, device="cpu")
    assert est.observe(np.array([-1, 3, 99, 5])) == 2
    assert est.n_total == 2


# ---------------------------------------------------------------- keys
def _filters(fs):
    return [None, fs.range("pct", 0, 4), fs.eq("pct", 7),
            fs.isin("pct", [1, 5, 9]),
            fs.range("pct", 0, 49) & fs.eq("region", 3)]


def test_cache_keys_and_option_suffix_are_the_reference_bytes(reference):
    rng = np.random.default_rng(8)
    rf = reference.metadata.FilterSpec
    queries = [rng.normal(size=8).astype(np.float32),
               rng.normal(size=8).astype(np.float64),
               rng.normal(size=(2, 4)).astype(np.float32)]
    for mine_f, ref_f in zip(_filters(FilterSpec), _filters(rf)):
        for mode, alpha in (("semantic", 0.5), ("lexical", 0.0),
                            ("hybrid", 0.3), ("hybrid", 0.7)):
            mx = _opts_extra(mine_f, mode, alpha)
            assert mx == reference.cell._opts_extra(ref_f, mode, alpha)
            for q in queries:
                assert (FrequencyAdmissionCache.key_for(q, mx)
                        == reference.cache.FrequencyAdmissionCache.key_for(
                            q, mx))


# ---------------------------------------------------------------- cache
def test_cache_frequency_admission_protects_head():
    cache = FrequencyAdmissionCache(capacity=4)
    keys = [cache.key_for(np.full(3, i, np.float32)) for i in range(8)]
    for _ in range(5):
        cache.get(keys[0])
    cache.offer(keys[0], "r0")
    for i in range(1, 4):
        cache.get(keys[i])
        cache.offer(keys[i], f"r{i}")
    cache.get(keys[7])
    assert not cache.offer(keys[7], "r7"), "cold key must not evict"
    assert cache.get(keys[0]) == "r0"
    st = cache.stats()
    assert st["rejected"] == 1 and st["size"] == 4


def test_cache_generation_guard_and_key_shapes():
    cache = FrequencyAdmissionCache(capacity=8)
    q = np.arange(4, dtype=np.float32)
    key = cache.key_for(q)
    cache.get(key)
    gen = cache.generation
    cache.invalidate_all()
    assert not cache.offer(key, "stale", generation=gen)
    assert cache.get(key) is None
    assert cache.offer(key, "fresh", generation=cache.generation)
    assert cache.get(key) == "fresh"
    a = np.zeros(4, np.float32)
    assert cache.key_for(a) != cache.key_for(a.astype(np.float64))
    assert cache.key_for(a) != cache.key_for(a.reshape(2, 2))


# --------------------------------------------------------------- engine
class _VersionedBackend:
    """Returns ids stamped with the current index 'version'."""

    def __init__(self):
        self.version = 0

    def __call__(self, qs):
        b = qs.shape[0]
        return (np.zeros((b, 1), np.float32),
                np.full((b, 1), self.version, np.int32))

    def apply_updates(self, target, **kw):
        self.version = target


def test_engine_search_timeout_raises():
    def slow_fn(qs):
        time.sleep(0.5)
        b = qs.shape[0]
        return np.zeros((b, 1), np.float32), np.zeros((b, 1), np.int32)

    eng = ServingEngine(slow_fn, max_wait_ms=0.1)
    try:
        with pytest.raises(TimeoutError, match="timed out"):
            eng.search(np.zeros(4, np.float32), timeout=0.05)
        _, i = eng.search(np.zeros(4, np.float32), timeout=5.0)
        assert i.shape == (1,)
    finally:
        eng.close()


def test_engine_apply_updates_invalidates_cache_and_updates_the_hedge():
    backend, replica = _VersionedBackend(), _VersionedBackend()
    cache = FrequencyAdmissionCache(capacity=32)
    eng = ServingEngine(backend, cache=cache, hedge_fn=replica,
                        max_wait_ms=0.1)
    try:
        q = np.arange(6, dtype=np.float32)
        _, i0 = eng.search(q, timeout=5.0)
        assert i0[0] == 0
        _, i1 = eng.search(q, timeout=5.0)
        assert i1[0] == 0 and eng.stats().cache_hits == 1
        eng.apply_updates(7)
        assert replica.version == 7
        _, i2 = eng.search(q, timeout=5.0)
        assert i2[0] == 7, "cache served a stale pre-update result"
    finally:
        eng.close()
    with pytest.raises(TypeError, match="hedge_fn"):
        cell = ServingEngine(backend, hedge_fn=lambda qs: backend(qs))
        try:
            cell.apply_updates(1)
        finally:
            cell.close()


def test_engine_estimator_sees_hits_and_misses():
    backend = _VersionedBackend()
    backend.version = 3
    est = OnlineLikelihoodEstimator(16, width=None, device="cpu")
    cache = FrequencyAdmissionCache(capacity=8)
    eng = ServingEngine(backend, cache=cache, estimator=est,
                        max_wait_ms=0.1)
    try:
        q = np.arange(5, dtype=np.float32)
        eng.search(q, timeout=5.0)
        for _ in range(3):
            eng.search(q, timeout=5.0)
        deadline = time.time() + 5
        while est.n_total < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert est.n_total == 4, est.n_total
        st = eng.stats()
        assert st.cache_hits == 3 and st.cache_misses == 1
    finally:
        eng.close()


def test_engine_hedge_answers_a_straggler():
    def slow(qs):
        time.sleep(0.5)
        return _VersionedBackend()(qs)

    fast = _VersionedBackend()
    fast.version = 9
    eng = ServingEngine(slow, hedge_fn=fast, hedge_ms=20.0, max_wait_ms=0.1)
    try:
        t0 = time.perf_counter()
        _, i = eng.search(np.zeros(3, np.float32), timeout=5.0)
        assert i[0] == 9 and time.perf_counter() - t0 < 0.4
        assert eng.stats().hedges == 1
    finally:
        eng.close()


# ------------------------------------------------------------ scheduler
class _StubEstimator:
    def __init__(self):
        self.tv = 0.0
        self.mass = 1e9
        self.n_total = 10_000
        self.reference = None

    def drift(self):
        return {"tv": self.tv, "kl": 0.0, "n_observed": self.mass}

    def likelihood(self):
        return np.full(8, 1 / 8)

    def set_reference(self, p):
        self.reference = p
        self.tv = 0.0


class _StubIndex:
    def __init__(self):
        self.calls = []
        self.two_level = object()      # rebalance="auto" chains it

    def reboost(self, p):
        self.calls.append("reboost")
        return {"n_reboosted": 1}

    def rebalance(self):
        self.calls.append("rebalance")
        return {"n_drifted": 0}


class _StubEngine:
    def __init__(self):
        self.published = []

    def apply_updates(self, target):
        self.published.append(target)


def test_scheduler_trigger_chain_and_cooldown():
    est, idx, eng = _StubEstimator(), _StubIndex(), _StubEngine()
    sched = MaintenanceScheduler(est, idx, engine=eng, interval_s=None,
                                 drift_threshold=0.3, min_observations=100,
                                 cooldown_observations=500)
    assert sched.check_now() is None
    est.tv = 0.9
    ev = sched.check_now()
    assert ev is not None and idx.calls == ["reboost", "rebalance"]
    assert eng.published == [idx]
    assert est.reference is not None
    est.tv = 0.9
    assert sched.check_now() is None, "cooldown must debounce"
    est.n_total += 600
    assert sched.check_now() is not None
    assert sched.n_reboosts == 2


def test_scheduler_gates_on_observation_mass_and_metric():
    est, idx = _StubEstimator(), _StubIndex()
    est.tv, est.mass = 0.9, 10.0
    sched = MaintenanceScheduler(est, idx, interval_s=None,
                                 min_observations=100)
    assert sched.check_now() is None and idx.calls == []
    with pytest.raises(ValueError, match="metric"):
        MaintenanceScheduler(est, idx, interval_s=None, metric="js")


def test_scheduler_background_thread_fires_and_survives_errors():
    est, idx = _StubEstimator(), _StubIndex()
    cache = FrequencyAdmissionCache(capacity=4)
    est.tv = 0.9
    boom = {"n": 0}

    def on_event(ev):
        boom["n"] += 1
        if boom["n"] == 1:
            raise RuntimeError("observer exploded")

    sched = MaintenanceScheduler(est, idx, cache=cache, interval_s=0.02,
                                 min_observations=100,
                                 cooldown_observations=0, on_event=on_event)
    try:
        deadline = time.time() + 5
        while boom["n"] < 2 and time.time() < deadline:
            est.tv = 0.9
            time.sleep(0.02)
        assert boom["n"] >= 2, "thread died after the first error"
        assert isinstance(sched.last_error, RuntimeError)
        assert cache.generation >= 1
    finally:
        sched.close()
    assert not sched._thread.is_alive()
