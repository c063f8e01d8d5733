"""The LSH bottom's probe scan on the CPU, held against the reference.

``TwoLevelIndex.search`` with ``bottom="lsh"`` takes its shortlist from
``kernels.ops.lsh_probe_shortlist_op``: on the card one launch of
``csrc/lsh_probe.cu``, on the CPU the plain chain
``ref.lsh_probe_shortlist_ref`` (the loop the index ran before the scan
had a kernel).  Here the plain chain runs every edge of
``testing.LSH_PROBE_EDGES`` (heavy ties at 32 and 64 bits, 40 bits, W up
to 8, a probe row repeating a bucket, S = 1, 7, 45 and P cap, empty
buckets, every probed row empty, -1 holes inside the extents, fewer live
slots than S, P above the rows the kernel stages at once on both emit
paths, rows short of cap, a bucket table after ``delete_entities`` and ``add_entities``)
against the reference's jitted ``_probe_scan_lsh`` on the same operands:
the same ids in the same order, every slot.  ``_probe_scan_lsh`` is plain
JAX, so nothing runs in interpret mode.  The sign bits both sides take
from their own ``q @ proj`` are checked equal first.

A numpy model of the kernel's algorithm (the ballot packing, the probe
rows staged with the scan of their extents into a compacted slot space,
per-warp histograms over contiguous segments of it, the threshold bin,
the per-warp offsets and the emit in 32-slot runs from the stored
distances, writing each winner's compacted slot and then its id in one
read, or recomputed, with the bound dropping once the
threshold bin is full) must equal the plain chain on every edge and on
both emit paths: the stable counting sort cut at S over the live columns
is the scan's (distance, probe slot, column) order.

The kernel reads a row's columns only before its extent, the index's
``bucket_counts``: every mutation of ``TwoLevelIndex`` must keep a row's
live ids in front of its -1 pads, which is checked after each one.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.core import two_level as port_two_level
from repro_torch.core.lsh import lsh_build
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.kernels import lsh_probe, ops, ref
from repro_torch.testing import LSH_PROBE_EDGES, lsh_probe_edge_operands

IDS = [c[0] for c in LSH_PROBE_EDGES]
WARPS = 8            # csrc/lsh_probe.cu: warps a block, a segment each


def _plain(o):
    qproj = torch.as_tensor(o["q"]) @ torch.as_tensor(o["proj"])
    got = ref.lsh_probe_shortlist_ref(
        qproj, torch.as_tensor(o["codes"]), torch.as_tensor(o["bucket_ids"]),
        torch.as_tensor(o["probe"]), o["shortlist"])
    return qproj.numpy(), got.numpy()


@pytest.mark.parametrize("case", LSH_PROBE_EDGES, ids=IDS)
def test_plain_scan_matches_reference(reference, case):
    o = lsh_probe_edge_operands(case)
    qproj, mine = _plain(o)
    theirs = np.asarray(reference.two_level._probe_scan_lsh(
        jnp.asarray(o["codes"]), jnp.asarray(o["proj"]),
        jnp.asarray(o["bucket_ids"]), jnp.asarray(o["probe"]),
        jnp.asarray(o["q"]), o["shortlist"]))
    assert np.array_equal(qproj > 0, np.asarray(
        jnp.asarray(o["q"]) @ jnp.asarray(o["proj"])) > 0)
    assert mine.dtype == np.int32 and mine.shape == theirs.shape
    assert np.array_equal(mine, theirs), (
        f"{int((mine != theirs).sum())} slots differ")


def _popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    return np.unpackbits(x.view(np.uint8)).reshape(*x.shape, 32).sum(-1)


def _stage(rows_all, ext_all, j0: int, ps: int):
    """The prologue's staged chunk: buckets, the exclusive scan of their
    extents (``rstart[m]`` the chunk's slots)."""
    bkt = rows_all[j0:j0 + ps]
    return bkt, np.concatenate([[0], np.cumsum(ext_all[j0:j0 + ps])])


def kernel_model(qproj, codes, bucket_ids, extents, probe, S: int,
                 store: int) -> np.ndarray:
    """csrc/lsh_probe.cu's block, one query at a time, in numpy."""
    B, nb = qproj.shape
    N, W = codes.shape
    K, cap = bucket_ids.shape
    P = probe.shape[1]
    BINS = 32 * W + 1
    DEAD = BINS
    ps = min(P, lsh_probe.PSTAGE)
    # 0. the prologue's ballots: bit ``lane`` of word ``warp``
    qw = np.zeros((B, W), np.uint32)
    for bit in range(nb):
        qw[:, bit // 32] |= ((qproj[:, bit] > 0).astype(np.uint32)
                             << np.uint32(bit % 32))
    out = np.empty((B, S), np.int32)
    for b in range(B):
        rows_all = np.clip(probe[b], 0, K - 1)
        ext_all = np.clip(extents[rows_all], 0, cap)
        n = int(ext_all.sum())
        path = lsh_probe.path_of(n, store, W)
        # the compacted slots chunk by chunk: each slot's id and distance
        ids = np.empty(n, np.int64)
        for j0 in range(0, P, ps):
            bkt, rstart = _stage(rows_all, ext_all, j0, ps)
            base = int(ext_all[:j0].sum())
            s = np.arange(int(rstart[-1]))
            j = np.searchsorted(rstart, s, side="right") - 1
            ids[base + s] = bucket_ids[bkt[j], s - rstart[j]]
        x = codes[np.clip(ids, 0, N - 1)].view(np.uint32) ^ qw[b]
        d = np.where(ids < 0, DEAD, _popcount(x).sum(1)) if n else ids
        seg = -(-(-(-n // WARPS)) // 32) * 32
        # 1. count: each warp's histogram of its segment's live slots
        hist = np.zeros((WARPS, BINS), np.int64)
        for w in range(WARPS):
            seg_d = d[w * seg:min(n, (w + 1) * seg)]
            np.add.at(hist[w], seg_d[seg_d != DEAD], 1)
        # 2. offsets: starts, the threshold bin, each warp's offsets
        total = hist.sum(0)
        start = np.concatenate([[0], np.cumsum(total)[:-1]])
        t = BINS - 1
        for v in range(BINS):
            if start[v] < S <= start[v] + total[v]:
                t = v
        off = start[None, :] + np.cumsum(hist, 0) - hist
        out[b, int(total.sum()):] = -1
        # 3. emit: runs of 32 in slot order, the bound dropping once bin t
        # is full; a hit's compacted slot, read as its id in step 4 (or its
        # id, recomputed)
        stored = path == lsh_probe.PATHS[0]
        for w in range(WARPS):
            h = off[w].copy()
            bound = t - 1 if h[t] >= S else t
            lo, hi = w * seg, min(n, (w + 1) * seg)
            for r0 in range(lo, hi, 32):
                if bound < 0:
                    break
                run = np.arange(r0, min(r0 + 32, hi))
                hits = run[d[run] <= bound]
                for v in np.unique(d[hits]):
                    peers = hits[d[hits] == v]
                    for rank, slot_s in enumerate(peers):
                        if h[v] + rank < S:
                            out[b, h[v] + rank] = (
                                slot_s if stored else ids[slot_s])
                    h[v] += peers.size
                if h[bound] >= S:
                    bound -= 1
        if stored:   # 4. each winner's slot read as its id, chunk by chunk
            wins = out[b, :min(int(total.sum()), S)].copy()
            for j0 in range(0, P, ps):
                bkt, rstart = _stage(rows_all, ext_all, j0, ps)
                base = int(ext_all[:j0].sum())
                sl = wins - base
                mine = (sl >= 0) & (sl < rstart[-1])
                jr = np.searchsorted(rstart, sl[mine], side="right") - 1
                out[b, np.flatnonzero(mine)] = bucket_ids[
                    bkt[jr], sl[mine] - rstart[jr]]
    return out


def _model_stores(o):
    """The slot store the wrapper gives the edge, and stores that send
    every query down each emit path."""
    K, cap = o["bucket_ids"].shape
    P, W = o["probe"].shape[1], o["codes"].shape[1]
    return lsh_probe.store_bytes(P, cap, W), 0, 1 << 30


@pytest.mark.parametrize("case", LSH_PROBE_EDGES, ids=IDS)
def test_kernel_model_matches_plain(case):
    o = lsh_probe_edge_operands(case)
    qproj, plain = _plain(o)
    for store in _model_stores(o)[:1 if "recompute" in case[0] else 3]:
        got = kernel_model(qproj, o["codes"], o["bucket_ids"],
                           o["extents"], o["probe"], o["shortlist"], store)
        assert np.array_equal(got, plain), (
            f"store {store}: {int((got != plain).sum())} differ")


def test_edge_extents_are_one_past_the_last_live_column():
    """The edges' extents fit their tables: every column at or past a
    row's extent is -1, and the column before it holds an id."""
    seen = set()
    for case in LSH_PROBE_EDGES:
        o = lsh_probe_edge_operands(case)
        bids, ext = o["bucket_ids"], o["extents"]
        assert ext.dtype == np.int32 and ext.shape == (bids.shape[0],)
        cols = np.arange(bids.shape[1])[None, :]
        assert (bids[cols >= ext[:, None]] == -1).all(), case[0]
        assert (bids[ext > 0, ext[ext > 0] - 1] >= 0).all(), case[0]
        K, cap = bids.shape
        P, W = o["probe"].shape[1], o["codes"].shape[1]
        store = lsh_probe.store_bytes(P, cap, W)
        for row in o["probe"]:
            n = int(ext[np.clip(row, 0, K - 1)].sum())
            seen.add(lsh_probe.path_of(n, store, W))
        if case[0] == "holes inside the extents":
            inside = (cols < ext[:, None]) & (bids < 0)
            assert inside.any()
        if case[0] == "every probed row empty":
            assert (ext == 0).all()
        if case[0].startswith("P 1100"):
            assert P > lsh_probe.PSTAGE
        if case[0].startswith("P 1100 recompute"):
            assert {lsh_probe.path_of(int(ext[np.clip(row, 0, K - 1)].sum()),
                                      store, W)
                    for row in o["probe"]} == {"recompute"}, case[0]
    assert seen == set(lsh_probe.PATHS)


def test_store_paths():
    """sift-1m's LSH bottom (P 32, cap 306, W 2) keeps every query's
    distances in 9,792 B; above ``STORE_MAX`` of them the store is
    ``SLOT_STORE`` and a query with more slots recomputes them."""
    store = lsh_probe.store_bytes(32, 306, 2)
    assert store == 32 * 306
    assert lsh_probe.path_of(32 * 306, store, 2) == "distances stored"
    assert lsh_probe.store_bytes(64, 763, 2) == 64 * 763        # DEEP-10M
    assert lsh_probe.store_bytes(64, 768, 8) == 64 * 768 * 2
    assert lsh_probe.store_bytes(128, 800, 2) == lsh_probe.SLOT_STORE
    assert lsh_probe.path_of(24 * 1024, lsh_probe.SLOT_STORE, 2) == \
        "distances stored"
    assert lsh_probe.path_of(24 * 1024 + 1, lsh_probe.SLOT_STORE, 2) == \
        "recompute"
    assert lsh_probe.path_of(12 * 1024 + 1, lsh_probe.SLOT_STORE, 8) == \
        "recompute"


def test_op_runs_the_plain_version_on_the_cpu():
    o = lsh_probe_edge_operands(LSH_PROBE_EDGES[3])
    args = [torch.as_tensor(o[n]) for n in ("codes", "bucket_ids", "probe")]
    qproj = torch.as_tensor(o["q"]) @ torch.as_tensor(o["proj"])
    ext = torch.as_tensor(o["extents"])
    before = lsh_probe.LAUNCHES.count
    got = ops.lsh_probe_shortlist_op(qproj, *args, o["shortlist"],
                                     extents=ext)
    assert lsh_probe.LAUNCHES.count == before
    assert torch.equal(got, ref.lsh_probe_shortlist_ref(
        qproj, *args, o["shortlist"]))
    meta = ops.lsh_probe_shortlist_op(
        qproj.to("meta"), *(a.to("meta") for a in args), o["shortlist"],
        extents=ext.to("meta"))
    assert meta.device.type == "meta"
    assert (tuple(meta.shape), meta.dtype) == (tuple(got.shape), torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lsh_probe.lsh_probe_shortlist(qproj, *args, o["shortlist"],
                                      extents=ext)
    with pytest.raises(TypeError, match="extents"):
        ops.lsh_probe_shortlist_op(qproj, *args, o["shortlist"])


def test_stores_distances_up_to_shared_memory():
    assert lsh_probe.stores_distances(32, 306, 2)           # sift-1m
    assert lsh_probe.stores_distances(64, 763, 2)           # DEEP-10M
    assert not lsh_probe.stores_distances(128, 800, 2)
    assert lsh_probe.stores_distances(64, 768, 8)
    assert not lsh_probe.stores_distances(64, 800, 8)


def test_lsh_bottom_takes_its_shortlist_from_the_op(monkeypatch):
    """One op call a query chunk, with the chunk's q @ proj, the placed
    tables, int32 probe rows and the clamped shortlist."""
    rng = np.random.default_rng(5)
    db = rng.normal(size=(600, 16)).astype(np.float32)
    q = (db[:20] + 0.1 * rng.normal(size=(20, 16))).astype(np.float32)
    base = build_two_level(db, TwoLevelConfig(
        n_clusters=12, top="brute", bottom="brute", kmeans_iters=2,
        kmeans_minibatch=None, seed=0), device="cpu")
    idx = dataclasses.replace(
        base, config=dataclasses.replace(base.config, bottom="lsh"),
        bottom_lsh=lsh_build(db, n_bits=40, seed=0))
    calls = []
    real = port_two_level.lsh_probe_shortlist_op

    def spy(qproj, codes, bids, probe, shortlist, *, extents):
        assert torch.equal(extents, torch.as_tensor(idx.bucket_counts))
        calls.append((tuple(qproj.shape), probe.dtype, shortlist,
                      extents.dtype))
        return real(qproj, codes, bids, probe, shortlist, extents=extents)

    monkeypatch.setattr(port_two_level, "lsh_probe_shortlist_op", spy)
    cap = idx.bucket_ids.shape[1]
    idx.search(q, 5, nprobe=3, lsh_candidates=10_000, query_chunk=8)
    assert calls == [((8, 40), torch.int32, 3 * cap, torch.int32),
                     ((8, 40), torch.int32, 3 * cap, torch.int32),
                     ((4, 40), torch.int32, 3 * cap, torch.int32)]


def _packed(idx) -> bool:
    """Every row's live ids in columns [0, count), -1 after them."""
    cols = np.arange(idx.bucket_ids.shape[1])[None, :]
    front = cols < idx.bucket_counts[:, None]
    return bool((idx.bucket_ids[front] >= 0).all()
                and (idx.bucket_ids[~front] == -1).all())


MUTATIONS = ("build_two_level", "add_entities", "add_entities pad growth",
             "delete_entities", "rebalance recenter", "refresh_forest",
             "reboost")


@pytest.fixture(scope="module")
def lifecycle():
    """A QLBT-bottom index through every mutation path, whether its rows
    were packed after each, and what each step did."""
    rng = np.random.default_rng(11)
    db = rng.normal(size=(900, 8)).astype(np.float32)
    idx = build_two_level(db, TwoLevelConfig(
        n_clusters=12, top="pq", bottom="qlbt", pq_m=4, kmeans_iters=3,
        kmeans_minibatch=None, seed=2), p=rng.beta(0.3, 8.0, size=900),
        device="cpu")
    seen = {"build_two_level": (_packed(idx), True)}
    idx.add_entities((db[rng.integers(0, 900, 60)] + 0.1 * rng.normal(
        size=(60, 8))).astype(np.float32), refresh=False)
    seen["add_entities"] = (_packed(idx), True)
    cap = idx.bucket_ids.shape[1]
    spot = db[0] + 0.01 * rng.normal(size=(5 * cap, 8))
    idx.add_entities(spot.astype(np.float32), refresh=False)
    seen["add_entities pad growth"] = (_packed(idx),
                                       idx.bucket_ids.shape[1] > cap)
    idx.delete_entities(rng.choice(idx.n, 200, replace=False))
    seen["delete_entities"] = (_packed(idx), True)
    idx.add_entities((db[:80] + 3.0).astype(np.float32), refresh=False)
    stats = idx.rebalance(drift_threshold=0.05)
    seen["rebalance recenter"] = (_packed(idx), stats["n_moved"] > 0)
    idx.delete_entities(np.flatnonzero(idx.alive)[:50])
    n = idx.refresh_forest()
    seen["refresh_forest"] = (_packed(idx), n > 0)
    st = idx.reboost(rng.beta(0.5, 4.0, size=idx.n))
    seen["reboost"] = (_packed(idx), st["n_reboosted"] > 0)
    return seen


@pytest.mark.parametrize("step", MUTATIONS)
def test_every_mutation_keeps_rows_packed(lifecycle, step):
    """``bucket_ids[b, :bucket_counts[b]] >= 0`` and ``bucket_ids[b,
    bucket_counts[b]:] == -1`` after each mutation path, so the counts are
    the kernel's extents; each step did what it names."""
    packed, did = lifecycle[step]
    assert did, f"{step} did not exercise its path"
    assert packed, f"{step} left a live id past a row's count"


@pytest.mark.parametrize("bottom", ["brute", "lsh", "tree"])
def test_work_dicts_equal_the_reference(reference, bottom):
    """``_search_chunk``'s work counters, chunk by chunk, equal the
    reference's ``search`` for each bottom (the brute bottom counts the
    probed buckets' live slots, the LSH bottom its shortlist slots, the
    tree bottom its leaf candidates)."""
    from test_torch_index_slice import _carry

    rng = np.random.default_rng(3)
    db = rng.normal(size=(800, 8)).astype(np.float32)
    q = (db[:21] + 0.2 * rng.normal(size=(21, 8))).astype(np.float32)
    rtl = reference.two_level
    theirs = rtl.build_two_level(db, rtl.TwoLevelConfig(
        n_clusters=10, top="pq", bottom=bottom, pq_m=4, kmeans_iters=3,
        lsh_bits=40, seed=1))
    mine = _carry(theirs)
    kw = dict(nprobe=4, beam_width=4, lsh_candidates=30, query_chunk=8)
    _, mi, mw = mine.search(q, 5, **kw)
    _, ti, tw = theirs.search(q, 5, **kw)
    assert mw == tw
    assert mw["candidates"] > 0 and mw["top_scored"] > 0
