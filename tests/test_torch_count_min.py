"""The count-min sketch update on the CPU, held against the reference.

``kernels.ops.count_min_update_op`` (the reference's jitted ``_update`` of
``repro/adaptive/sketch.py``) on the same seeded numpy inputs:

* the op on the CPU (the plain version) equals the reference's ``_update``
  bit for bit, table, heavy-hitter ids and estimates, over every case of
  ``testing.SKETCH_EDGES``: 20 decayed batches of one id, the served
  sizes, 200 copies of one id, negative ids and ids at and above 2**31,
  weighted and not, widths 1 to 65,536, depth up to 8, batches up to
  4,096;
* a numpy model of the kernel's algorithm (``csrc/count_min.cu``: the
  copy blocks' decayed slices skipping the batch's cells, block 0's adds
  folded from the old table by the item of each column's first
  occurrence, the estimates read from its own writes or the old table
  decayed, the repeats masked, the stable rank selection) equals the
  plain version bit for bit on the same cases, and the reference's
  ``_update`` on batches with repeats, candidates on touched cells,
  invalid ids, NaN weights and batches above ``INLINE``;
* ids at and above 2**31 follow the reference's 32-bit rule through
  ``CountMinSketch`` (ROADMAP fault 28);
* the op's ``meta`` branch gives the shapes, and on the CPU it runs the
  plain version, never the kernel;
* ``OnlineLikelihoodEstimator.observe`` holds its lock around the update
  op only, the host's share done before it.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.adaptive import CountMinSketch, OnlineLikelihoodEstimator
from repro_torch.adaptive import sketch as sketch_mod
from repro_torch.kernels import count_min, ops
from repro_torch.kernels.common import ids32
from repro_torch.testing import SKETCH_EDGES, sketch_edge_steps

IDS = [c[0] for c in SKETCH_EDGES]


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                          b.view(np.int32) if b.dtype == np.float32 else b)


def _state(sk: CountMinSketch):
    """(table, hh_ids, hh_est) on the CPU."""
    return sk.table, sk.hh_ids, sk.hh_est


def _kernel_model(table, a, b, hh_ids, ids, weights, decay):
    """``csrc/count_min.cu``'s two roles in numpy float32, in the order
    their threads do them: the copy blocks decay every cell the batch does
    not touch, a slice of ``count_min.SLICE`` cells each; block 0 folds the
    touched cells from the old table and estimates the candidates from its
    own writes (a touched cell) or the old table decayed (any other).
    Every cell is written once, and the old table never."""
    depth, width = table.shape
    log2w = width.bit_length() - 1
    x = ids32(ids)
    w = np.asarray(weights, np.float32)
    m = x.size
    a64, b64 = a.astype(np.uint64), b.astype(np.uint64)
    old = table.copy()
    dec = np.float32(decay)

    def cols_of(v):                       # (depth, n) columns of int32 v
        h = (a64[:, None] * (v.astype(np.int64) & 0xFFFFFFFF).astype(
            np.uint64)[None, :] + b64[:, None]) & np.uint64(0xFFFFFFFF)
        if log2w == 0:
            return np.zeros(h.shape, np.int64)
        return (h >> np.uint64(32 - log2w)).astype(np.int64)

    cols = cols_of(np.where(x >= 0, x, 0))
    wv = np.where(x >= 0, w, np.float32(0.0))
    new = np.full(depth * width, np.nan, np.float32)
    writes = np.zeros(depth * width, np.int64)
    flat = old.reshape(-1)
    # blocks 1..G: a slice each, the batch's cells skipped
    touched = np.zeros(depth * width, bool)
    touched[(np.arange(depth)[:, None] * width + cols).reshape(-1)] = True
    for lo in range(0, depth * width, count_min.SLICE):
        sl = slice(lo, min(lo + count_min.SLICE, depth * width))
        keep = np.flatnonzero(~touched[sl]) + lo
        new[keep] = flat[keep] * dec
        writes[keep] += 1
    # block 0: an item of a column's first occurrence folds its adds from
    # the old table, in batch order
    val = np.full((depth, m), np.nan, np.float32)
    for r in range(depth):
        cr = cols[r]
        for j in range(m):
            if (cr[:j] == cr[j]).any():
                continue
            acc = np.float32(old[r, cr[j]] * dec)
            for j2 in np.flatnonzero(cr[j:] == cr[j]) + j:
                acc = np.float32(acc + wv[j2])
            new[r * width + cr[j]] = acc
            writes[r * width + cr[j]] += 1
            val[r, j] = acc
    assert (writes == 1).all(), "every cell written once"
    assert np.array_equal(old.view(np.int32), table.view(np.int32))
    # the candidates: a touched cell's value from block 0's own fold (the
    # row's first item with that column), else the old cell decayed;
    # repeats after the first masked; NaN propagates, as amin
    cand = np.concatenate([hh_ids, x])
    C = cand.size
    est = np.full(C, -np.inf, np.float32)
    ccols = cols_of(np.where(cand >= 0, cand, 0))
    for c in range(C):
        if cand[c] < 0 or (cand[:c] == cand[c]).any():
            continue
        e = np.float32(-np.inf)
        for r in range(depth):
            f = np.flatnonzero(cols[r] == ccols[r, c])
            v = val[r, f[0]] if f.size else np.float32(old[r, ccols[r, c]]
                                                       * dec)
            e = v if (r == 0 or v < e or v != v) and e == e else e
        est[c] = e
    # the stable rank: the candidates ahead in (estimate desc, index asc),
    # a NaN above every number
    j = np.arange(C)
    nc, nj = np.isnan(est)[:, None], np.isnan(est)[None, :]
    earlier = j[None, :] < j[:, None]
    ahead = np.where(nc, nj & earlier, nj | (est[None, :] > est[:, None]) | (
        (est[None, :] == est[:, None]) & earlier))
    rank = ahead.sum(axis=1)
    assert np.unique(rank).size == C, "the ranks are a permutation"
    topk = hh_ids.size
    out_ids = np.empty(topk, np.int32)
    out_est = np.empty(topk, np.float32)
    for c in np.flatnonzero(rank < topk):
        gone = est[c] == -np.inf
        out_ids[rank[c]] = -1 if gone else cand[c]
        out_est[rank[c]] = 0.0 if gone else est[c]
    return new.reshape(depth, width), out_ids, out_est


# (name, width, depth, topk, ids, sizes): a sketch's batches for the split
# model against the reference: ids "zipf" over 30 values (repeats in every
# batch, and at width 16 heavy hitters whose cells the batch touches
# without holding their id), "invalid" (a third -1 or another negative),
# "nan" (two NaN weights a batch), "staged" (batches above INLINE).
SPLIT_CASES = (
    ("repeats, candidates on touched cells", 16, 3, 8, "zipf", (40, 9, 40)),
    ("invalid ids", 64, 4, 8, "invalid", (50, 1, 33)),
    ("nan weights", 32, 4, 8, "nan", (20, 5, 20)),
    ("above INLINE", 128, 4, 16, "zipf", (300, 1, 257)),
)


def _split_batches(case):
    _, width, depth, topk, kind, sizes = case
    rng = np.random.default_rng([width, depth, topk, len(sizes)])
    out = []
    for m in sizes:
        ids = rng.zipf(1.3, m).astype(np.int64) % 30
        w = (rng.random(m) * 3).astype(np.float32)
        if kind == "invalid":
            dead = rng.random(m) < 1 / 3
            ids[dead] = np.where(rng.random(int(dead.sum())) < 0.5, -1,
                                 -ids[dead] - 2)
        if kind == "nan":
            w[rng.choice(m, min(m, 2), replace=False)] = np.nan
        out.append((ids, w))
    return out


def _bits_or_nan(mine, theirs):
    """Bit for bit, a NaN by being NaN (its payload is the platform's)."""
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    if theirs.dtype != np.float32:
        return _bits(mine, theirs)
    nan = np.isnan(theirs)
    assert np.array_equal(np.isnan(mine), nan)
    _bits(np.where(nan, 0, mine).astype(np.float32),
          np.where(nan, 0, theirs).astype(np.float32))


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_model_equals_the_reference_update(reference, case):
    """The kernel's split (touched cells folded from the old table by one
    block, the rest decay-copied by the others), modelled in numpy, and
    the op's plain version, against the reference's ``_update`` from the
    same state, batch after batch: table, ids and estimates bit for bit
    (NaN cells by their NaN; a NaN estimate ranks above every number, as
    the reference's ``lax.top_k`` ranks the NaN a NaN weight leaves)."""
    import jax.numpy as jnp

    _, width, depth, topk, _, _ = case
    ref = reference.sketch.CountMinSketch(width=width, depth=depth,
                                          topk=topk, halflife=40.0, seed=3)
    a = np.asarray(ref._a).astype(np.int64)
    b = np.asarray(ref._b).astype(np.int64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    rt, rh, re_ = ref.table, ref.hh_ids, ref.hh_est
    mt, mh = np.asarray(rt).copy(), np.asarray(rh).copy()
    pt, ph = torch.from_numpy(mt.copy()), torch.from_numpy(mh.copy())
    for ids, w in _split_batches(case):
        decay = float(np.float32(0.5 ** (ids.size / 40.0)))
        mt, mh, me = _kernel_model(mt, a, b, mh, ids, w, decay)
        pt, ph, pe = ops.count_min_update_op(pt, ta, tb, ph, ids, w, decay)
        rt, rh, re_ = reference.sketch._update(
            rt, ref._a, ref._b, rh, jnp.asarray(ids32(ids)), jnp.asarray(w),
            jnp.float32(decay))
        for mine, plain, theirs in ((mt, pt, rt), (mh, ph, rh),
                                    (me, pe, re_)):
            _bits_or_nan(mine, theirs)
            _bits_or_nan(plain.numpy(), theirs)


@pytest.mark.parametrize("case", SKETCH_EDGES, ids=IDS)
def test_op_equals_the_reference_update(reference, case):
    """The op on the CPU and the reference's ``_update`` from the same
    state, a batch at a time: table, ids and estimates bit for bit."""
    import jax.numpy as jnp

    o = sketch_edge_steps(case)
    sk = CountMinSketch(device="cpu", seed=3, **o["kw"])
    ref = reference.sketch.CountMinSketch(seed=3, **o["kw"])
    assert np.array_equal(sk._a.numpy(), np.asarray(ref._a).astype(np.int64))
    table, hh = sk.table, sk.hh_ids
    rt, rh, re_ = ref.table, ref.hh_ids, ref.hh_est
    for st in o["steps"]:
        decay = float(np.float32(st.decay))
        table, hh, est = ops.count_min_update_op(
            table, sk._a, sk._b, hh, st.ids, st.weights, decay)
        rt, rh, re_ = reference.sketch._update(
            rt, ref._a, ref._b, rh, jnp.asarray(ids32(st.ids)),
            jnp.asarray(st.weights), jnp.float32(st.decay))
        _bits(table.numpy(), np.asarray(rt))
        _bits(hh.numpy(), np.asarray(rh))
        _bits(est.numpy(), np.asarray(re_))


@pytest.mark.parametrize("case", SKETCH_EDGES, ids=IDS)
def test_kernel_model_equals_the_plain_version(case):
    """The kernel's algorithm, modelled in numpy, against the plain
    version (host-planned passes, sort-based top-k) from the same state."""
    o = sketch_edge_steps(case)
    sk = CountMinSketch(device="cpu", seed=3, **o["kw"])
    a, b = sk._a.numpy(), sk._b.numpy()
    table, hh = sk.table, sk.hh_ids
    mt, mh = table.numpy().copy(), hh.numpy().copy()
    for st in o["steps"]:
        decay = float(np.float32(st.decay))
        table, hh, est = ops.count_min_update_op(
            table, sk._a, sk._b, hh, st.ids, st.weights, decay)
        mt, mh, me = _kernel_model(mt, a, b, mh, st.ids, st.weights, decay)
        _bits(table.numpy(), mt)
        _bits(hh.numpy(), mh)
        _bits(est.numpy(), me)


def test_ids_at_and_above_2_31_follow_the_reference(reference):
    """ROADMAP fault 28: the reference holds ids in 32-bit integers, so an
    id in [2**31, 2**32) is invalid (hashed as 0, weight 0) and 2**32 + 3
    counts as 3; ``n_observed`` adds every weight."""
    ids = np.array([2**31 - 1, 2**31, 2**31 + 5, 2**31 + 5, 2**32 + 3, 7,
                    2**33, 3], np.int64)
    for weights in (None, np.linspace(0.5, 4.0, ids.size, dtype=np.float32)):
        ref = reference.sketch.CountMinSketch(width=64, depth=2, topk=8,
                                              halflife=50.0, seed=1)
        mine = CountMinSketch(width=64, depth=2, topk=8, halflife=50.0,
                              seed=1, device="cpu")
        for lo in (0, 3):
            ref.update(ids[lo:], None if weights is None else weights[lo:])
            mine.update(ids[lo:], None if weights is None else weights[lo:])
            _bits(mine.table.numpy(), np.asarray(ref.table))
            _bits(mine.hh_ids.numpy(), np.asarray(ref.hh_ids))
            _bits(mine.hh_est.numpy(), np.asarray(ref.hh_est))
            assert mine.n_observed == ref.n_observed
            for x, y in zip(mine.heavy_hitters(), ref.heavy_hitters()):
                _bits(x, y)
        _bits(mine.query(ids), np.asarray(ref.query(ids)))


def test_op_meta_branch_gives_the_shapes():
    table = torch.empty((8, 1024), device="meta")
    hh = torch.empty((32,), dtype=torch.int32, device="meta")
    ab = torch.empty((8,), dtype=torch.int64, device="meta")
    t, i, e = ops.count_min_update_op(table, ab, ab, hh, np.arange(64),
                                      np.ones(64, np.float32), 0.5)
    assert [x.device.type for x in (t, i, e)] == ["meta"] * 3
    assert (t.shape, t.dtype) == ((8, 1024), torch.float32)
    assert (i.shape, i.dtype) == ((32,), torch.int32)
    assert (e.shape, e.dtype) == ((32,), torch.float32)


def test_op_runs_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU sketch updates through the op's plain branch: the kernel's
    counter does not move, and the kernel's wrapper refuses CPU tensors."""
    calls = []
    real = ops.count_min_update_op

    def spy(*args, **kw):
        calls.append(args[4].size)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "count_min_update_op", spy)
    before = count_min.LAUNCHES.count
    sk = CountMinSketch(width=256, depth=4, topk=8, device="cpu")
    sk.update(np.arange(5))
    sk.update(np.zeros(0, np.int64))          # empty: no update
    sk.update(np.array([3]))
    assert calls == [8, 1]
    assert count_min.LAUNCHES.count == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        count_min.count_min_update(sk.table, sk._a, sk._b, sk.hh_ids,
                                   np.arange(4), np.ones(4, np.float32), 1.0)


def test_observe_holds_the_lock_only_around_the_op(monkeypatch):
    """The estimator pads and decays a batch before it takes its lock; under
    the lock it runs the update op and nothing else of the sketch."""
    est = OnlineLikelihoodEstimator(100, width=256, depth=4, topk=8,
                                    halflife=64.0, device="cpu")
    seen = []
    real_prepare = sketch_mod.CountMinSketch.prepare
    real_op = ops.count_min_update_op

    def prepare(self, *args, **kw):
        seen.append(("prepare", est._lock.locked()))
        return real_prepare(self, *args, **kw)

    def op(*args, **kw):
        seen.append(("op", est._lock.locked()))
        return real_op(*args, **kw)

    monkeypatch.setattr(sketch_mod.CountMinSketch, "prepare", prepare)
    monkeypatch.setattr(ops, "count_min_update_op", op)
    assert est.observe(np.array([1, 2, 2, 500, -1])) == 3
    assert est.observe(np.array([4])) == 1
    assert seen == [("prepare", False), ("op", True)] * 2
    # the same state as updating the sketch directly
    ref = CountMinSketch(width=256, depth=4, topk=8, halflife=64.0,
                         device="cpu")
    ref.update(np.array([1, 2, 2]))
    ref.update(np.array([4]))
    for x, y in zip(_state(est.sketch), _state(ref)):
        _bits(x.numpy(), y.numpy())
    assert est.sketch.n_observed == ref.n_observed


def test_observe_from_threads_equals_the_lock_order():
    """Updates from several threads land in the order they took the
    estimator's lock (replayed in that order, the same table)."""
    est = OnlineLikelihoodEstimator(300, width=512, depth=4, topk=16,
                                    halflife=200.0, device="cpu")
    order = []
    real_apply = est.sketch.apply

    def apply(batch):
        order.append(batch)
        real_apply(batch)

    est.sketch.apply = apply
    rng = np.random.default_rng(0)
    work = [rng.integers(0, 300, rng.integers(1, 40)) for _ in range(60)]

    def client(part):
        for ids in part:
            est.observe(ids)

    threads = [threading.Thread(target=client, args=(work[t::3],))
               for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    replay = CountMinSketch(width=512, depth=4, topk=16, halflife=200.0,
                            device="cpu")
    for batch in order:
        replay.apply(batch)
    assert len(order) == 60
    for x, y in zip(_state(est.sketch), _state(replay)):
        _bits(x.numpy(), y.numpy())
