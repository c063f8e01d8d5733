"""The LSH bottom's probe scan on the CPU, held against the reference.

``TwoLevelIndex.search`` with ``bottom="lsh"`` takes its shortlist from
``kernels.ops.lsh_probe_shortlist_op``: on the card one launch of
``csrc/lsh_probe.cu``, on the CPU the plain chain
``ref.lsh_probe_shortlist_ref`` (the loop the index ran before the scan
had a kernel).  Here the plain chain runs every edge of
``testing.LSH_PROBE_EDGES`` (heavy ties at 32 and 64 bits, 40 bits, W up
to 8, a probe row repeating a bucket, S = 1, 7, 45 and P cap, empty
buckets, a bucket table after ``delete_entities`` and ``add_entities``)
against the reference's jitted ``_probe_scan_lsh`` on the same operands:
the same ids in the same order, every slot.  ``_probe_scan_lsh`` is plain
JAX, so nothing runs in interpret mode.  The sign bits both sides take
from their own ``q @ proj`` are checked equal first.

A numpy model of the kernel's algorithm (the ballot packing, per-warp
histograms over contiguous segments, the threshold bin, the per-warp
offsets and the emit in 32-slot runs with the bound dropping once the
threshold bin is full) must equal the plain chain on every edge: the
stable counting sort cut at S is the scan's (distance, probe slot,
column) order.
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


def kernel_model(qproj, codes, bucket_ids, probe, S: int) -> np.ndarray:
    """csrc/lsh_probe.cu's block, one query at a time, in numpy."""
    B, nb = qproj.shape
    N, W = codes.shape
    K, cap = bucket_ids.shape
    P = probe.shape[1]
    BINS = 32 * W + 1
    DEAD = BINS
    n = P * cap
    seg = -(-(-(-n // WARPS)) // 32) * 32
    # 0. the prologue's ballots: bit ``lane`` of word ``warp``
    qw = np.zeros((B, W), np.uint32)
    for bit in range(nb):
        qw[:, bit // 32] |= ((qproj[:, bit] > 0).astype(np.uint32)
                             << np.uint32(bit % 32))
    out = np.empty((B, S), np.int32)
    s = np.arange(n)
    j, c = s // cap, s % cap
    for b in range(B):
        ids = bucket_ids[np.clip(probe[b, j], 0, K - 1), c]
        x = codes[np.clip(ids, 0, N - 1)].view(np.uint32) ^ qw[b]
        d = np.where(ids < 0, DEAD, _popcount(x).sum(1))
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
        # 3. emit: runs of 32 in slot order, the bound dropping once bin
        # t is full
        for w in range(WARPS):
            h = off[w].copy()
            bound = t - 1 if h[t] >= S else t
            for s0 in range(w * seg, min(n, (w + 1) * seg), 32):
                if bound < 0:
                    break
                run = np.arange(s0, min(s0 + 32, n, (w + 1) * seg))
                hits = run[d[run] <= bound]
                for v in np.unique(d[hits]):
                    peers = hits[d[hits] == v]
                    for rank, slot_s in enumerate(peers):
                        if h[v] + rank < S:
                            out[b, h[v] + rank] = ids[slot_s]
                    h[v] += peers.size
                if h[bound] >= S:
                    bound -= 1
    return out


@pytest.mark.parametrize("case", LSH_PROBE_EDGES, ids=IDS)
def test_kernel_model_matches_plain(case):
    o = lsh_probe_edge_operands(case)
    qproj, plain = _plain(o)
    got = kernel_model(qproj, o["codes"], o["bucket_ids"], o["probe"],
                       o["shortlist"])
    assert np.array_equal(got, plain), f"{int((got != plain).sum())} differ"


def test_op_runs_the_plain_version_on_the_cpu():
    o = lsh_probe_edge_operands(LSH_PROBE_EDGES[3])
    args = [torch.as_tensor(o[n]) for n in ("codes", "bucket_ids", "probe")]
    qproj = torch.as_tensor(o["q"]) @ torch.as_tensor(o["proj"])
    before = lsh_probe.LAUNCHES.count
    got = ops.lsh_probe_shortlist_op(qproj, *args, o["shortlist"])
    assert lsh_probe.LAUNCHES.count == before
    assert torch.equal(got, ref.lsh_probe_shortlist_ref(
        qproj, *args, o["shortlist"]))
    meta = ops.lsh_probe_shortlist_op(
        qproj.to("meta"), *(a.to("meta") for a in args), o["shortlist"])
    assert meta.device.type == "meta"
    assert (tuple(meta.shape), meta.dtype) == (tuple(got.shape), torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lsh_probe.lsh_probe_shortlist(qproj, *args, o["shortlist"])


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

    def spy(qproj, codes, bids, probe, shortlist):
        calls.append((tuple(qproj.shape), probe.dtype, shortlist))
        return real(qproj, codes, bids, probe, shortlist)

    monkeypatch.setattr(port_two_level, "lsh_probe_shortlist_op", spy)
    cap = idx.bucket_ids.shape[1]
    idx.search(q, 5, nprobe=3, lsh_candidates=10_000, query_chunk=8)
    assert calls == [((8, 40), torch.int32, 3 * cap),
                     ((8, 40), torch.int32, 3 * cap),
                     ((4, 40), torch.int32, 3 * cap)]
