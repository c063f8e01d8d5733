"""The index path's exact reranks through the rows-by-id op, on the CPU,
held against the reference.

Three sites rerank a candidate list by exact L2: the two-level index's
``_rerank`` (its LSH and tree / QLBT bottoms), ``tree_search``'s rerank
(``SearchIndex``'s trees, the kd top) and the one-level ``lsh_search``.
Each now calls ``kernel_ops.candidate_rows_topk_op`` (on the card one
kernel launch a pass, the rows read by id; here its plain version, the
gathered tile's distances sorted stably).  ``_rerank`` first sets every
repeat of an id but its first occurrence to -1 on the ids alone, so one
entity holds at most one slot, as the reference's mask does (ROADMAP
fault 5: the kd top pads a short probe list with bucket 0, whose leaves
then repeat).  Ids are compared exactly and distances to rtol 1e-5
(fault 2: the two frameworks sum in other orders); the queries are not
corpus rows, so no distance is near zero.
"""
from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import TREE_ARRAYS, tree_from_arrays
from repro_torch.core import two_level as port_two_level
from repro_torch.core import tree as port_tree
from repro_torch.core.lsh import LSHIndex, lsh_search
from repro_torch.kernels import ref

RTOL, ATOL = 1e-5, 1e-5


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _same(port, theirs):
    (pd, pi), (td, ti) = port, theirs
    pi, ti = np.asarray(pi), np.asarray(ti)
    assert pi.shape == ti.shape
    assert (pi == ti).all(), f"{int((pi != ti).sum())} ids differ"
    np.testing.assert_allclose(np.asarray(pd), np.asarray(td), rtol=RTOL,
                               atol=ATOL)


def _kd_padded(rng, b, n, buckets, leaf, probes, real):
    """Candidates as the two-level tree bottom makes them under a kd top
    that found only ``real`` of ``probes`` buckets: one leaf block of
    ``leaf`` ids (a quarter -1 pads) a probed bucket, the missing probes
    clamped to bucket 0, so bucket 0's block repeats."""
    blocks = rng.choice(n, size=(buckets, leaf), replace=False)
    blocks[rng.random((buckets, leaf)) < 0.25] = -1
    probe = np.zeros((b, probes), np.int64)
    for r in range(b):
        probe[r, :real] = rng.choice(buckets, real, replace=False)
    return blocks[probe].reshape(b, probes * leaf).astype(np.int32)


def _rerank_case(name):
    """(db, q, cand, k) of one ``_rerank`` case."""
    rng = _rng(f"rerank {name}")
    n, d, b = 600, 16, 9
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    if name == "kd top padded bucket 0":
        return db, q, _kd_padded(rng, b, n, 40, 8, 6, 3), 10
    c = {"C<k": 6, "k above the list": 200}.get(name, 96)
    cand = np.stack([rng.choice(n, c, replace=False) for _ in range(b)])
    cand = cand.astype(np.int32)
    if name in ("repeats", "k above the list"):
        cand[:, c // 3:2 * (c // 3)] = cand[:, :c // 3]
        cand[:, -5:] = cand[:, 7:12]
    if name in ("dead slots", "k above the list"):
        cand[rng.random(cand.shape) < 0.4] = -1
    if name == "every slot dead":
        cand[:] = -1
    k = 50 if name == "k above the list" else 10
    return db, q, cand, k


RERANK_CASES = ("repeats", "kd top padded bucket 0", "dead slots", "C<k",
                "every slot dead", "k above the list")


@pytest.mark.parametrize("name", RERANK_CASES)
def test_rerank_matches_reference(reference, name):
    db, q, cand, k = _rerank_case(name)
    got = port_two_level._rerank(torch.as_tensor(db), torch.as_tensor(q),
                                 torch.as_tensor(cand), k)
    want = reference.two_level._rerank(jnp.asarray(db), jnp.asarray(q),
                                       jnp.asarray(cand), k)
    assert got[1].dtype == torch.int32
    assert got[0].shape == (q.shape[0], min(k, cand.shape[1]))
    _same(got, want)
    ids = got[1].numpy()
    for row in ids:               # one slot an id (fault 5)
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()


@pytest.mark.parametrize("name", RERANK_CASES)
def test_first_occurrences_keep_each_id_once(name):
    _, _, cand, _ = _rerank_case(name)
    got = port_two_level._first_occurrences(torch.as_tensor(cand)).numpy()
    want = cand.copy()
    for row in want:
        seen = set()
        for j, v in enumerate(row):
            if v >= 0 and v in seen:
                row[j] = -1
            seen.add(int(v))
    assert np.array_equal(got, want)


def _count_plain(monkeypatch) -> list:
    """Count the calls of the rows-by-id op's plain version."""
    calls = []
    plain = ref.candidate_rows_topk_ref

    def counted(*args, **kw):
        calls.append(args[2].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(ref, "candidate_rows_topk_ref", counted)
    return calls


def test_rerank_goes_through_the_rows_op(monkeypatch):
    calls = _count_plain(monkeypatch)
    db, q, cand, k = _rerank_case("repeats")
    port_two_level._rerank(torch.as_tensor(db), torch.as_tensor(q),
                           torch.as_tensor(cand), k)
    assert calls == [cand.shape]


def _tree_arrays(t) -> dict:
    return {"kind": t.kind,
            **{n: np.asarray(getattr(t, n)) for n in TREE_ARRAYS}}


@pytest.mark.parametrize("kind,k", [("rp", 10), ("rp", 40), ("kd", 40)],
                         ids=["rp k<C", "rp k>C", "kd d=2 k>C"])
def test_tree_search_rerank_matches_reference(reference, monkeypatch, kind,
                                              k):
    """``tree_search``'s rerank at k below and above the beam's
    candidates (beam 3 x leaf 8 = 24 slots for rp, 3 x 4 for kd), the kd
    tree over 2-d features (the kd top's shape)."""
    rng = _rng(f"tree rerank {kind} {k}")
    rt = reference.tree
    d = 2 if kind == "kd" else 16
    x = rng.normal(size=(700, d)).astype(np.float32)
    q = rng.normal(size=(11, d)).astype(np.float32)
    theirs = (rt.build_kd_tree(x, leaf_size=4) if kind == "kd" else
              rt.build_rp_tree(x, leaf_size=8, n_candidates=4, seed=1))
    mine = tree_from_arrays(_tree_arrays(theirs))
    kw = dict(kind=kind, beam_width=3, k=k, max_steps=mine.max_depth + 4)
    calls = _count_plain(monkeypatch)
    res_m = port_tree.tree_search(mine.device_arrays("cpu"),
                                  torch.as_tensor(x), torch.as_tensor(q),
                                  **kw)
    res_t = rt.tree_search(theirs.device_arrays(), jnp.asarray(x),
                           jnp.asarray(q), **kw)
    assert len(calls) == 1
    assert res_m.ids.shape == (11, k)
    if k > calls[0][1]:
        assert (res_m.ids.numpy()[:, calls[0][1]:] == -1).all()
    _same((res_m.dists, res_m.ids), (res_t.dists, res_t.ids))


@pytest.mark.parametrize("n_cand,k", [(8, 20), (64, 10), (700, 10)])
def test_lsh_search_matches_reference(reference, monkeypatch, n_cand, k):
    """The one-level ``lsh_search``'s rerank, the shortlist below k, above
    it and the whole corpus."""
    rng = _rng(f"lsh rerank {n_cand} {k}")
    x = rng.normal(size=(700, 24)).astype(np.float32)
    q = rng.normal(size=(13, 24)).astype(np.float32)
    lsh = reference.lsh.lsh_build(x, 64, seed=3)
    mine = LSHIndex(proj=lsh.proj, codes=lsh.codes, n_bits=64)
    calls = _count_plain(monkeypatch)
    got = lsh_search(mine, x, q, k, n_candidates=n_cand, device="cpu")
    want = reference.lsh.lsh_search(lsh, x, q, k, n_candidates=n_cand)
    assert calls == [(13, min(n_cand, 700))]
    assert got[0].shape == (13, min(k, n_cand))
    _same(got, want)
