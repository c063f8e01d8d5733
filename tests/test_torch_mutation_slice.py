"""The index lifecycle on the CPU, held against the reference.

One reference index is carried across (``test_torch_forest_slice.carry``)
and the same op sequence runs on both packages: ``add_entities`` with
metadata rows and docs, ``delete_entities``, ``refresh_forest``,
``reboost``, ``rebalance`` (brute top), and ``SearchIndex``'s single-tree
lifecycle.  After each step the index state (buckets, liveness, the
forest's tables and roots) and the popped ``DeltaManifest`` must equal
the reference's bit for bit: the mutation code is numpy on both sides,
and the one step on the device (the top-4 centroid routing of new rows)
picks the same buckets on these inputs.  A PQ top's ``rebalance`` retrains
its codebooks with the port's Lloyd steps, which round differently: there
everything but the PQ top is compared exactly and the codebooks to
``PQ_TOL``.

The backends' ``apply_updates`` stats (``mode``, ``bytes``,
``full_bytes``, ``reason``) must equal the reference's for the brute,
int8, IVF and forest kinds, every fallback reason reached; inside the
port a delta apply must leave the placed tensors (same storage) equal to
a full re-place's, and answer as it does.  Answers are held to the
reference's ids exactly (distances rtol=1e-5, atol=1e-4).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_forest_slice import carry, same, tree_arrays
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import (lexical_from_arrays, metadata_from_arrays,
                                 tree_from_arrays)
from repro_torch.core import delta as port_delta
from repro_torch.core.index import SearchIndex
from repro_torch.core.lexical import build_lexical_slabs
from repro_torch.core.protocol import IndexSpec
from repro_torch.distributed.backend import ShardedSearchBackend

N, D, NB, B, NPROBE, BEAM, K = 2000, 16, 24, 12, 6, 4, 10
PQ_TOL = 1e-4         # codebooks: rtol and atol (Lloyd steps round apart)
V = 30                # vocabulary of the docs sidecar
MANIFEST_FIELDS = ("base_version", "version", "base_n", "n",
                   "lsh_rows_appended", "full")


def MESH():
    """The reference backends' one-device mesh, its axes in Auto mode: the
    reference's in-place scatters leave their output sharding to the
    compiler, which an Explicit mesh (this JAX's default) refuses."""
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))


def _docs(rng, n):
    return [rng.integers(0, V, size=int(rng.integers(1, 8))).tolist()
            for _ in range(n)]


def _manifests_equal(mine, theirs):
    for f in MANIFEST_FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    for f in ("dirty_buckets", "tombstones"):
        a, b = np.asarray(getattr(mine, f)), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert mine.empty == theirs.empty
    assert mine.describe() == theirs.describe()


def _state_equal(mine, theirs, pq_exact=True):
    for name in ("bucket_ids", "bucket_counts", "entity_bucket", "alive",
                 "dirty", "db", "centroids"):
        a, b = np.asarray(getattr(mine, name)), np.asarray(getattr(theirs,
                                                                   name))
        assert a.shape == b.shape and np.array_equal(a, b), name
    for name in ("n_adds", "n_deletes", "mutation_version"):
        assert getattr(mine, name) == getattr(theirs, name), name
    if theirs.p is not None:
        np.testing.assert_array_equal(mine.p, theirs.p)
    if theirs.forest is not None:
        for name, a in mine.forest.arrays.items():
            b = np.asarray(theirs.forest.arrays[name])
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert np.array_equal(mine.forest.roots, theirs.forest.roots)
        assert mine.forest.max_depth == theirs.forest.max_depth
    assert (mine.base_trees is None) == (theirs.base_trees is None)
    if theirs.bottom_lsh is not None:
        np.testing.assert_array_equal(mine.bottom_lsh.codes,
                                      theirs.bottom_lsh.codes)
    if theirs.top_pq is not None:
        if pq_exact:
            np.testing.assert_array_equal(mine.top_pq.codebooks,
                                          theirs.top_pq.codebooks)
        else:
            np.testing.assert_allclose(mine.top_pq.codebooks,
                                       theirs.top_pq.codebooks,
                                       rtol=PQ_TOL, atol=PQ_TOL)
    if theirs.metadata is not None:
        assert mine.metadata.n_rows == theirs.metadata.n_rows == mine.n
        np.testing.assert_array_equal(mine.metadata.column("pct"),
                                      theirs.metadata.column("pct"))
    if theirs.lexical is not None:
        assert mine.lexical.n_docs == theirs.lexical.n_docs == mine.n
        np.testing.assert_array_equal(mine.lexical.terms,
                                      theirs.lexical.terms)


class Pair:
    """The same index in both packages, each step run on both and held
    equal, its manifests popped and compared."""

    def __init__(self, reference, bottom, top="brute", sidecars="both",
                 seed=0):
        rng = np.random.default_rng([31, seed])
        self.rng = rng
        self.db = rng.normal(size=(N, D)).astype(np.float32)
        self.p = rng.random(N) ** 6 + 1e-4
        rmeta = pmeta = rlex = plex = None
        if sidecars:
            pct = rng.permutation(N) % 100
            rmeta = reference.metadata.MetadataTable({"pct": pct})
            pmeta = metadata_from_arrays({"pct": pct})
        if sidecars == "both":
            docs = _docs(rng, N)
            rlex = reference.lexical.build_lexical_slabs(docs, V, slots=8)
            plex = lexical_from_arrays(
                {n: np.asarray(getattr(rlex, n))
                 for n in ("terms", "tf_sat", "idf")},
                {n: getattr(rlex, n) for n in ("k1", "b", "avg_len")})
        self.ref = reference.two_level.build_two_level(
            self.db, reference.two_level.TwoLevelConfig(
                n_clusters=NB, top=top, bottom=bottom, kmeans_iters=4,
                pq_m=4, lsh_bits=32, seed=0),
            p=self.p if bottom == "qlbt" else None, metadata=rmeta,
            lexical=rlex)
        self.port = carry(self.ref, metadata=pmeta, lexical=plex)
        self.reference = reference

    def step(self, name, *args, pq_exact=True, **kw):
        out = getattr(self.port, name)(*args, **kw)
        theirs = getattr(self.ref, name)(*args, **kw)
        if isinstance(out, dict):
            assert out.keys() == theirs.keys()
            for key in out:
                assert out[key] == pytest.approx(theirs[key]), key
        elif out is not None:
            np.testing.assert_array_equal(out, np.asarray(theirs))
        _state_equal(self.port, self.ref, pq_exact=pq_exact)
        return out

    def pop(self):
        mine, theirs = self.port.pop_delta(), self.ref.pop_delta()
        _manifests_equal(mine, theirs)
        return mine, theirs

    def near(self, buckets, per, scale=0.2):
        """``per`` new vectors near each bucket's centroid."""
        c = np.asarray(self.ref.centroids)[buckets]
        v = np.repeat(c, per, axis=0)
        return (v + scale * self.rng.normal(size=v.shape)).astype(np.float32)

    def drift(self, b, m):
        """``m`` new vectors most of the way from bucket ``b``'s centroid
        to its farthest member: they land in ``b`` and pull its mean."""
        ids = self.bucket_members([b], 10 ** 6)
        c = np.asarray(self.ref.centroids)[b]
        far = self.db[ids][np.argmax(((self.db[ids] - c) ** 2).sum(1))] \
            if ids.max() < N else c
        v = c + 0.8 * (far - c) + 0.05 * self.rng.normal(size=(m, D))
        return v.astype(np.float32)

    def bucket_members(self, buckets, m):
        ids = [np.asarray(self.ref.bucket_ids)[b][
            :int(np.asarray(self.ref.bucket_counts)[b])][:m] for b in buckets]
        return np.concatenate(ids).astype(np.int64)


# ------------------------------------------------------------- manifests
def test_merge_manifests_and_log_match_reference(reference):
    rng = np.random.default_rng(3)
    runs = []
    for v in range(4):
        dirty = np.sort(rng.choice(50, 5, replace=False))
        tomb = np.sort(rng.choice(900, 7, replace=False))
        kw = dict(base_version=v, version=v + 1, base_n=800 + 10 * v,
                  n=810 + 10 * v, lsh_rows_appended=v, full=(v == 2))
        runs.append((port_delta.DeltaManifest(dirty_buckets=dirty,
                                              tombstones=tomb, **kw),
                     reference.delta.DeltaManifest(dirty_buckets=dirty,
                                                   tombstones=tomb, **kw)))
    order = [2, 0, 3, 1]
    _manifests_equal(
        port_delta.merge_manifests([runs[i][0] for i in order]),
        reference.delta.merge_manifests([runs[i][1] for i in order]))
    _manifests_equal(port_delta.merge_manifests([runs[0][0]]),
                     reference.delta.merge_manifests([runs[0][1]]))
    with pytest.raises(ValueError):
        port_delta.merge_manifests([])
    a = port_delta.DeltaManifest(base_version=0, version=0, base_n=0, n=0)
    b = port_delta.DeltaManifest(base_version=0, version=0, base_n=0, n=0)
    assert a.empty and a.dirty_buckets is not b.dirty_buckets
    mine = port_delta.DeltaLog(base_version=4, base_n=10)
    theirs = reference.delta.DeltaLog(base_version=4, base_n=10)
    for log in (mine, theirs):
        log.mark_buckets([3, 1, 3])
        log.mark_tombstones(np.array([9, 2, 9]))
        log.lsh_rows += 2
    _manifests_equal(mine.pop(6, 12), theirs.pop(6, 12))
    _manifests_equal(mine.pop(7, 12), theirs.pop(7, 12))


# ------------------------------------------------------------- two-level
@pytest.mark.parametrize("bottom", ["tree", "qlbt", "brute", "lsh"])
def test_two_level_lifecycle_matches_reference(reference, bottom):
    pair = Pair(reference, bottom)
    hot = [3, 11]
    new = pair.near(hot, 15)
    pct = np.arange(new.shape[0]) % 100
    docs = _docs(pair.rng, new.shape[0])
    ids = pair.step("add_entities", new, metadata={"pct": pct}, docs=docs,
                    p=np.full(new.shape[0], 0.5) if bottom == "qlbt" else None)
    assert (ids == np.arange(N, N + new.shape[0])).all()
    pair.pop()
    gone = np.concatenate([pair.bucket_members([5, 17], 12), ids[:4]])
    pair.step("delete_entities", gone)
    mine, _ = pair.pop()
    assert np.array_equal(mine.tombstones, np.unique(gone))
    with pytest.raises(ValueError, match="already deleted"):
        pair.port.delete_entities(gone[:1])
    pair.step("refresh_forest")
    pair.pop()
    # deferred refresh: add without it, then reboost folds the buckets in
    pair.step("add_entities", pair.near([7], 6), refresh=False)
    pair.step("reboost", pair.rng.random(pair.port.n) ** 4)
    pair.pop()
    # a deleted id stays deleted through reboost's base trees
    pair.step("delete_entities", pair.bucket_members([0], 3))
    pair.step("reboost", pair.rng.random(pair.port.n) ** 2)
    pair.pop()
    pair.step("add_entities", pair.drift(9, 40))
    stats = pair.step("rebalance")
    assert stats["n_drifted"] > 0
    pair.pop()
    assert pair.port.pop_delta().empty


def test_pq_top_rebalance_matches_reference_to_tolerance(reference):
    pair = Pair(reference, "tree", top="pq", sidecars=None, seed=1)
    pair.step("add_entities", np.concatenate([pair.drift(2, 40),
                                              pair.drift(4, 40)]))
    pair.pop()
    stats = pair.step("rebalance", pq_exact=False)
    assert stats["n_drifted"] > 0
    pair.pop()
    assert pair.port.top_pq.codes.shape == pair.ref.top_pq.codes.shape


def test_single_tree_lifecycle_matches_reference(reference):
    rng = np.random.default_rng(5)
    db = rng.normal(size=(600, 12)).astype(np.float32)
    p = rng.random(600) ** 4 + 1e-4
    theirs = reference.index.build_index(
        reference.protocol.IndexSpec("qlbt"), db, p=p)
    mine = SearchIndex(spec=IndexSpec("qlbt"), db=db.copy(),
                       tree=tree_from_arrays(tree_arrays(theirs.tree)),
                       p=p.copy(), device="cpu")
    q = db[:8] + 0.01

    def check():
        for name in ("proj", "tau", "children", "leaf_row",
                     "leaf_entities", "depth", "entity_depth"):
            assert np.array_equal(getattr(mine.tree, name),
                                  np.asarray(getattr(theirs.tree, name))), \
                name
        _manifests_equal(mine.pop_delta(), theirs.pop_delta())
        assert mine.spec.kind == theirs.spec.kind
        same(mine.search(q, 5)[:2], theirs.search(q, 5)[:2])

    for name, args in (
            ("delete_entities", (np.array([3, 7, 8]),)),
            ("add_entities", (rng.normal(size=(20, 12)).astype(np.float32),)),
            ("reboost", (rng.random(620) ** 3,)),
            ("delete_entities", (np.array([1, 610]),)),
            ("rebalance", ()),
            ("rebuild_with_likelihood", (rng.random(620),))):
        if name == "rebuild_with_likelihood":
            # until here a deleted id never returns; the rebuild covers
            # every db row, tombstones too, in both packages
            got = mine.search(mine.db[[3, 7, 8, 1, 610]], 1)[1][:, 0]
            assert not np.isin(got, [3, 7, 8, 1, 610]).any()
        mine_placed = mine._placed
        getattr(mine, name)(*args)
        getattr(theirs, name)(*args)
        assert mine._placed is not mine_placed and not mine._placed, name
        check()


def test_every_mutation_drops_the_placed_tables(reference):
    pair = Pair(reference, "tree", sidecars=None)
    idx = pair.port
    q = pair.db[:4]
    steps = (
        ("add_entities", None, lambda: idx.add_entities(pair.near([1], 3))),
        ("delete_entities", None,
         lambda: idx.delete_entities(np.array([0, 1]))),
        ("refresh_forest",
         lambda: idx.add_entities(pair.near([5], 2), refresh=False),
         idx.refresh_forest),
        ("reboost", None, lambda: idx.reboost(np.ones(idx.n))),
        ("rebalance", None, idx.rebalance))
    for name, prep, op in steps:
        if prep is not None:
            prep()
        idx.search(q, 3, nprobe=4)
        placed = idx._placed
        assert placed
        op()
        assert idx._placed is not placed and not idx._placed, name
    # the next search places the mutated index: a deleted id never returns
    _, ids, _ = idx.search(pair.db[:2], 3, nprobe=NB)
    assert not np.isin(ids, [0, 1]).any()


# ------------------------------------------------------------- backends
class Backends:
    """A port backend, a port control re-placed fully each step, and the
    reference's backend on a one-device mesh, over one target each."""

    def __init__(self, reference, port_target, ref_target, **kw):
        self.kw = kw
        self.mine = ShardedSearchBackend(port_target, device="cpu", **kw)
        self.control = ShardedSearchBackend(port_target, device="cpu", **kw)
        self.theirs = reference.backend.ShardedSearchBackend(
            MESH(), ref_target, **kw)

    def apply(self, port_target, ref_target, manifests, alive=None,
              live=None):
        """One apply on both packages and the control's full re-place
        (``live``: the corpus's whole liveness, for a flat corpus)."""
        mine_m, theirs_m = manifests if manifests is not None else (None,
                                                                   None)
        ptrs = [t.data_ptr() for t in self.mine._args]
        kw = {} if alive is None else {"alive": alive}
        got = self.mine.apply_updates(port_target, delta=mine_m, **kw)
        want = self.theirs.apply_updates(ref_target, delta=theirs_m, **kw)
        assert got == want
        self.control.apply_updates(
            port_target,
            alive=alive if live is None or got["mode"] == "full" else live)
        if got["mode"] == "delta":
            assert [t.data_ptr() for t in self.mine._args] == ptrs
        for a, b in zip(self.mine._args, self.control._args):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if self.mine._lex_args is not None:
            for a, b in zip(self.mine._lex_args, self.control._lex_args):
                assert torch.equal(a, b)
        return got

    def answers(self, q, **kw):
        got = self.mine(q, **kw)
        want = self.control(q, **kw)
        assert (got[1] == want[1]).all()
        np.testing.assert_array_equal(got[0], want[0])
        return got


@pytest.mark.parametrize("bottom", ["tree", "qlbt", "brute"])
def test_bucket_kinds_apply_updates_match_reference(reference, bottom):
    """IVF (brute bottom) and forest (tree / QLBT bottom) kinds: the same
    stats as the reference after every step, deltas in place equal to a
    full re-place, every reachable fallback reason."""
    pair = Pair(reference, bottom, sidecars="meta")
    kind = "ivf" if bottom == "brute" else "forest"
    be = Backends(reference, pair.port, pair.ref, kind=kind, k=K,
                  nprobe_local=NPROBE, beam_width=BEAM, headroom=1.5)
    q = pair.near([3, 11, 20], 4, scale=0.5)
    modes = []

    def apply(manifests=None):
        st = be.apply(pair.port, pair.ref, manifests)
        modes.append((st["mode"], st["reason"]))
        same(be.answers(q), be.theirs(q))
        assert st["bytes"] <= st["full_bytes"]
        return st

    new = pair.near([3, 11], 10)
    ids = pair.step("add_entities", new, metadata={"pct": np.arange(20)})
    st = apply(pair.pop())
    assert st["mode"] == "delta" and st["bytes"] < st["full_bytes"] / 3
    got = be.answers(new[:4])[1][:, 0]
    assert (got == ids[:4]).all()
    gone = pair.bucket_members([3, 11], 9)
    pair.step("delete_entities", gone)
    assert apply(pair.pop())["mode"] == "delta"
    assert not np.isin(be.answers(pair.db[gone])[1], gone).any()
    pair.step("refresh_forest")
    apply(pair.pop())
    pair.step("reboost", pair.rng.random(pair.port.n) ** 4)
    st = apply(pair.pop())
    if kind == "forest":
        assert (st["mode"], st["reason"]) == ("full", "threshold")
    # a missed pop: the next manifest does not cover the backend
    pair.step("delete_entities", pair.bucket_members([1], 2))
    pair.pop()
    pair.step("delete_entities", pair.bucket_members([2], 2))
    assert apply(pair.pop())["reason"] == "version"
    assert apply(None)["reason"] == "no-manifest"
    full = pair.pop()
    full = tuple(dataclasses.replace(m, full=True) for m in full)
    assert apply(full)["reason"] == "manifest-full"
    pair.step("add_entities", pair.drift(9, 30))
    pair.step("rebalance")
    apply(pair.pop())
    assert ("delta", None) in modes and ("full", "version") in modes
    assert be.mine.n_delta_applies == be.theirs.n_delta_applies > 0
    assert be.mine.republished_bytes == be.theirs.republished_bytes
    assert be.mine.republish_full_bytes == be.theirs.republish_full_bytes
    if kind == "forest":
        # the packed layout ships no slabs
        packed = Backends(reference, pair.port, pair.ref, kind=kind, k=K,
                          nprobe_local=NPROBE, beam_width=BEAM,
                          headroom=1.5, delta_updates=False)
        pair.step("delete_entities", pair.bucket_members([4], 2))
        assert packed.apply(pair.port, pair.ref,
                            pair.pop())["reason"] == "packed-layout"
    # a filter after the applies sees the appended metadata rows
    spec = reference.metadata.FilterSpec.range("pct", 0, 4)
    from repro_torch.core.metadata import FilterSpec
    same(be.mine(q, filter_spec=FilterSpec.range("pct", 0, 4)),
         be.theirs(q, filter_spec=spec))


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_flat_kinds_apply_updates_match_reference(reference, precision):
    """The brute kind over a flat corpus (f32 with lexical slabs, and
    int8): appends and tombstones as deltas, the explicit-``alive`` path,
    and the flat kinds' fallbacks."""
    rng = np.random.default_rng(9)
    db = rng.normal(size=(N, D)).astype(np.float32)
    docs = _docs(rng, N)
    lex = dict(port=None, ref=None)
    kw = dict(kind="brute", k=K, headroom=1.5, precision=precision)
    if precision == "f32":
        lex["port"] = build_lexical_slabs(docs, V, slots=8)
        lex["ref"] = reference.lexical.build_lexical_slabs(docs, V, slots=8)
    be = Backends.__new__(Backends)
    be.mine = ShardedSearchBackend(db, device="cpu", lexical=lex["port"],
                                   **kw)
    be.control = ShardedSearchBackend(db, device="cpu", lexical=lex["port"],
                                      **kw)
    be.theirs = reference.backend.ShardedSearchBackend(
        MESH(), db, lexical=lex["ref"],
        **kw)
    q = db[:B] + 0.01

    def manifest(v, base_n, n, tomb=(), dirty=(), full=False):
        m = dict(base_version=v, version=v + 1, base_n=base_n, n=n,
                 tombstones=np.asarray(tomb, np.int64),
                 dirty_buckets=np.asarray(dirty, np.int64), full=full)
        return (port_delta.DeltaManifest(**m),
                reference.delta.DeltaManifest(**m))

    live = np.ones(N, bool)

    def apply(m, alive=None):
        """Apply on both; the control is re-placed with the liveness the
        backend now holds: a delta's cumulative flips, the caller's mask
        (``alive``) as the whole truth, or after a full re-place ``alive``
        alone (a raw corpus placed without it is all live)."""
        nxt = live.copy() if alive is None else np.asarray(alive).copy()
        tomb = m[0].tombstones
        nxt[tomb[tomb < nxt.size]] = False
        st = be.apply(db, db, m, alive=alive, live=nxt)
        if st["mode"] == "delta":
            live[:] = nxt
        elif st["mode"] == "full":
            live[:] = True if alive is None else alive
        return st

    def grow(m):
        nonlocal db, live
        more = rng.normal(size=(m, D)).astype(np.float32)
        db = np.concatenate([db, more])
        live = np.concatenate([live, np.ones(m, bool)])
        if lex["port"] is not None:
            d = _docs(rng, m)
            lex["port"].append_docs(d)
            lex["ref"].append_docs(d)
        return more

    more = grow(50)
    st = apply(manifest(0, N, N + 50, tomb=[4, 9]))
    assert st["mode"] == "delta"
    got = be.answers(np.concatenate([more[:3], db[[4, 9]]]))[1]
    assert (got[:3, 0] == np.arange(N, N + 3)).all()
    assert not np.isin(got[3:], [4, 9]).any()
    same(be.mine(q), be.theirs(q))
    assert apply(manifest(1, N + 50, N + 50, tomb=[11]))[
        "mode"] == "delta"
    assert apply(manifest(2, N + 50, N + 50))["mode"] == "noop"
    assert apply(manifest(3, N + 50, N + 50, dirty=[1]))[
        "reason"] == "bucket-delta-on-flat-corpus"
    assert apply(manifest(3, N + 60, N + 60, tomb=[12]))[
        "reason"] == "version"
    assert apply(manifest(3, N + 50, N + 50, full=True))[
        "reason"] == "manifest-full"
    alive = np.ones(db.shape[0], bool)
    alive[[0, 5]] = False
    st = apply(manifest(4, N + 50, N + 50, tomb=[6]), alive=alive)
    assert st["mode"] == "delta"
    assert not np.isin(be.answers(db[[0, 5, 6]])[1], [0, 5, 6]).any()
    be.mine.delta_max_fraction = be.theirs.delta_max_fraction = 1e-6
    be.control.delta_max_fraction = 1e-6
    grow(5)
    assert apply(manifest(5, N + 50, N + 55))[
        "reason"] == "threshold"
    if lex["port"] is not None:
        # rows appended without their docs: both refuse the delta, then
        # the full re-place raises
        short = np.concatenate([db, db[:2]])
        m = manifest(6, N + 55, N + 57)
        for b, mm in ((be.mine, m[0]), (be.theirs, m[1])):
            b.delta_max_fraction = 0.5
            assert b._delta_payload(short, None, mm) == (
                None, "lexical-misaligned")
            with pytest.raises(ValueError):
                b.apply_updates(short, delta=mm)
    big = np.concatenate([db, rng.normal(size=(4 * N, D)).astype(
        np.float32)])
    m = manifest(7, db.shape[0], big.shape[0])
    for b, mm in ((be.mine, m[0]), (be.theirs, m[1])):
        b.delta_max_fraction = 0.5
        assert b._delta_payload(big, None, mm) == (None, "outgrew")
        with pytest.raises(ValueError):
            b.apply_updates(big, delta=mm)


def test_cell_apply_updates_pops_once_and_serves_the_update(reference):
    """``ServingCell.apply_updates``: ``delta="auto"`` pops the index's
    manifest and the backend ships it in place; ``delta=None`` forces a
    full re-place; a plain callable has no ``apply_updates``."""
    from repro_torch.serve.cell import ServingCell

    pair = Pair(reference, "tree", sidecars=None)
    idx = pair.port
    cell = ServingCell.sharded(idx, k=K, nprobe_local=NPROBE,
                               beam_width=BEAM, headroom=1.5, device="cpu")
    try:
        new = pair.near([3], 5)
        ids = idx.add_entities(new)
        st = cell.apply_updates(idx)
        assert st["mode"] == "delta" and st["bytes"] < st["full_bytes"]
        assert idx.pop_delta().empty                 # popped once, above
        assert cell.search(new[0], timeout=60)[1][0] == ids[0]
        idx.delete_entities(ids[:1])
        assert cell.apply_updates(idx, delta=None)["reason"] == "no-manifest"
        assert cell.search(new[0], timeout=60)[1][0] != ids[0]
    finally:
        cell.close()
    plain = ServingCell(lambda q: (q[:, :1], q[:, :1]))
    try:
        with pytest.raises(TypeError, match="apply_updates"):
            plain.apply_updates(idx)
    finally:
        plain.close()
