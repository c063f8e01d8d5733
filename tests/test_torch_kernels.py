"""The port's kernel modules on the CPU, held against the reference.

The plain versions ``l2_topk_ref`` / ``candidate_topk_ref`` (what the
port runs for a CPU tensor, and what ``chip_smoke.py`` holds the CUDA
kernels against) are compared with both the reference's jnp oracles and
its Pallas kernels in interpret mode, on the edge shapes that
``tests/test_kernels.py`` pins.  Inputs come from one numpy seed and go to
both packages as numpy arrays.

Tolerance: ids exactly; distances to rtol=1e-5, atol=1e-5, because
XLA-CPU and torch-CPU fp32 products round differently (values here are
O(10), so 1e-5 is a few ulps).
"""
from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.core.brute import batched_l2sq, brute_search, pairwise_l2sq
from repro_torch.distributed.sharding import _merge_gathered
from repro_torch.kernels import common, ref

RTOL = ATOL = 1e-5


def _same(port, *others):
    pd, pi = (np.asarray(t) for t in port)
    for od, oi in others:
        od, oi = np.asarray(od), np.asarray(oi)
        assert pd.shape == od.shape and pi.shape == oi.shape
        assert (pi == oi).all(), "ids differ"
        np.testing.assert_allclose(pd, od, rtol=RTOL, atol=ATOL)


def _l2_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "duplicate_rows":
        base = rng.normal(size=(25, 8)).astype(np.float32)
        x = np.concatenate([base, base])
        q = base[:5] + 0.01 * rng.normal(size=(5, 8)).astype(np.float32)
        return q, x, 9, None
    b, n, d, k, valid = {
        "single_query_row": (1, 100, 8, 5, None),
        "n_not_multiple_of_tile": (4, 77, 8, 5, None),
        "k_exceeds_n": (3, 6, 8, 10, None),
        "all_dead": (4, 50, 8, 5, "dead"),
        "partial_valid": (6, 120, 8, 7, "half"),
        "wider": (16, 300, 32, 10, "half"),
    }[name]
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if valid == "dead":
        valid = np.zeros(n, np.int32)
    elif valid == "half":
        valid = (rng.random(n) > 0.5).astype(np.int32)
    return q, x, k, valid


@pytest.mark.parametrize("name", [
    "single_query_row", "n_not_multiple_of_tile", "k_exceeds_n", "all_dead",
    "partial_valid", "duplicate_rows", "wider"])
def test_l2_topk_plain_matches_reference(reference, name):
    q, x, k, valid = _l2_case(name)
    port = ref.l2_topk_ref(torch.as_tensor(q), torch.as_tensor(x), k,
                           valid=None if valid is None
                           else torch.as_tensor(valid))
    jv = None if valid is None else jnp.asarray(valid)
    oracle = reference.ref.l2_topk_ref(jnp.asarray(q), jnp.asarray(x), k,
                                       valid=jv)
    pallas = reference.l2_topk.l2_topk_pallas(
        jnp.asarray(q), jnp.asarray(x), k, valid=jv, bq=8, bn=32,
        interpret=True)
    _same(port, oracle, pallas)
    d, i = (t.numpy() for t in port)
    assert (i[np.isinf(d)] == -1).all()
    if valid is not None:
        assert not np.isin(i, np.flatnonzero(valid == 0)).any()


def _cand_case(name):
    rng = np.random.default_rng(8)
    B, C, D, k = 5, 37, 8, 6
    q = rng.normal(size=(B, D)).astype(np.float32)
    vecs = rng.normal(size=(B, C, D)).astype(np.float32)
    ids = rng.integers(0, 500, size=(B, C)).astype(np.int32)
    ids[:, ::5] = -1
    kw = {}
    if name == "k_exceeds_c":
        k = C + 10
    elif name == "carried_best":
        kw = dict(best_d=np.sort(rng.random((B, k)).astype(np.float32) * .5,
                                 axis=1),
                  best_i=rng.integers(1000, 2000, size=(B, k))
                  .astype(np.int32))
        vecs = rng.normal(size=(B, C, D)).astype(np.float32)
        ids = rng.integers(0, 500, size=(B, C)).astype(np.int32)
    elif name == "all_dead":
        ids = np.full((B, C), -1, np.int32)
        k = 4
    return q, vecs, ids, k, kw


@pytest.mark.parametrize("name", ["dead_slots", "k_exceeds_c",
                                  "carried_best", "all_dead"])
def test_candidate_topk_plain_matches_reference(reference, name):
    q, vecs, ids, k, kw = _cand_case(name)
    port = ref.candidate_topk_ref(
        torch.as_tensor(q), torch.as_tensor(vecs), torch.as_tensor(ids), k,
        **{n: torch.as_tensor(v) for n, v in kw.items()})
    jkw = {n: jnp.asarray(v) for n, v in kw.items()}
    oracle = reference.ref.candidate_topk_ref(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(ids), k, **jkw)
    pallas = reference.bucket_topk.candidate_topk_pallas(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(ids), k, bq=8, bc=16,
        interpret=True, **jkw)
    _same(port, oracle, pallas)
    d, i = (t.numpy() for t in port)
    assert d.shape == (q.shape[0], k)
    assert (i[np.isinf(d)] == -1).all()


def test_merge_topk_rule_matches_reference(reference):
    """The kernels' (distance, id) rule: exact ties go to the smaller id,
    and a duplicated (distance, id) pair is emitted once."""
    rng = np.random.default_rng(3)
    bd = np.sort(rng.integers(0, 6, size=(4, 5)).astype(np.float32), axis=1)
    bi = rng.integers(0, 40, size=(4, 5)).astype(np.int32)
    td = rng.integers(0, 6, size=(4, 12)).astype(np.float32)
    ti = rng.integers(0, 40, size=(4, 12)).astype(np.int32)
    td[:, :3], ti[:, :3] = bd[:, :3], bi[:, :3]      # exact duplicates
    td[:, 5] = np.inf
    port = common.merge_topk(*(torch.as_tensor(a) for a in (bd, bi, td, ti)),
                             7)
    theirs = reference.common.merge_topk(
        *(jnp.asarray(a) for a in (bd, bi, td, ti)), 7)
    _same(port, theirs)
    d, i = (t.numpy() for t in port)
    for row_d, row_i in zip(d, i):
        pairs = [(a, b) for a, b in zip(row_d, row_i) if np.isfinite(a)]
        assert pairs == sorted(pairs) and len(set(pairs)) == len(pairs)


def test_distance_expansions_match_reference(reference):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    v = rng.normal(size=(6, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        pairwise_l2sq(torch.as_tensor(q), torch.as_tensor(x)).numpy(),
        np.asarray(reference.brute.pairwise_l2sq(jnp.asarray(q),
                                                 jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        batched_l2sq(torch.as_tensor(v), torch.as_tensor(q)).numpy(),
        np.asarray(reference.brute.batched_l2sq(jnp.asarray(v),
                                                jnp.asarray(q))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [64, 65536])
def test_brute_search_matches_reference(reference, chunk):
    rng = np.random.default_rng(5)
    db = rng.normal(size=(1000, 24)).astype(np.float32)
    q = rng.normal(size=(12, 24)).astype(np.float32)
    _same(brute_search(q, db, 10, chunk, device="cpu"),
          reference.brute.brute_search(q, db, 10, chunk))


def test_merge_gathered_four_shards_matches_reference(reference):
    rng = np.random.default_rng(6)
    S, B, k = 4, 7, 5
    gd = np.sort(rng.random((S, B, k)).astype(np.float32), axis=2)
    gi = rng.permutation(S * B * k).reshape(S, B, k).astype(np.int32)
    gd[1, :2] = np.inf                      # a shard with empty slots
    gi[1, :2] = -1
    gd[2, 3, 0] = gd[0, 3, 0]               # a cross-shard exact tie
    port = _merge_gathered(torch.as_tensor(gd), torch.as_tensor(gi), k)
    theirs = reference.sharding._merge_gathered(jnp.asarray(gd),
                                                jnp.asarray(gi), k)
    _same(port, theirs)
