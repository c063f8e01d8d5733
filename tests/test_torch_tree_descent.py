"""The tree beam descent on the CPU, held against the reference.

``core.tree.tree_search`` descends through ``kernels.ops.tree_descent_op``:
on the card one launch of ``csrc/tree_descent.cu``, on the CPU the plain
loop ``ref.tree_descent_ref`` with the reference's ``while_loop`` exit.
Here the plain path runs every edge of ``testing.DESCENT_EDGES`` (``rp``,
QLBT and ``kd`` trees, per-row roots, beams 1-128, a row still active at
``max_steps``, dead slots, a tree of one leaf), with the rerank on and
off, against the reference's jitted ``tree_search`` on the same trees
(the port's builders give the reference's arrays, as
``tests/test_torch_index_slice.py`` shows).

Tolerance: ids, ``steps``, ``internal_visits`` and ``candidates``
exactly; distances to 1e-5 of ``|q|^2 + |x|^2``, the scale the
``(qn + xn) - 2 q.x`` expansion rounds on (ROADMAP faults 2 and 7).
Parity inputs are continuous normal data whose split margins are never
tied to within fp32 rounding.

A numpy model of the kernel's own loop (each row stopping on its own,
the stable rank selection) must equal the plain batch loop on every
edge: the per-row exit is the reference's global one.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.core import tree as port_tree
from repro_torch.kernels import ops, ref, tree_descent
from repro_torch.testing import DESCENT_EDGES, descent_edge_operands

K = 10
REL = 1e-5
TREE_FIELDS = ("proj", "dims", "tau", "children", "leaf_row",
               "leaf_entities")
IDS = [c[0] for c in DESCENT_EDGES]


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _search_both(reference, o, rerank):
    t = o["tree"]
    mine = port_tree.tree_search(
        t.device_arrays("cpu"), torch.as_tensor(o["db"]),
        torch.as_tensor(o["q"]), k=K, rerank=rerank, roots=_t(o["roots"]),
        **o["kw"])
    theirs = reference.tree.tree_search(
        {n: jnp.asarray(getattr(t, n)) for n in TREE_FIELDS},
        jnp.asarray(o["db"]), jnp.asarray(o["q"]), k=K, rerank=rerank,
        roots=None if o["roots"] is None else jnp.asarray(o["roots"]),
        **o["kw"])
    return mine, theirs


@pytest.mark.parametrize("rerank", [True, False], ids=["rerank", "leaves"])
@pytest.mark.parametrize("case", DESCENT_EDGES, ids=IDS)
def test_descent_matches_reference(reference, case, rerank):
    o = descent_edge_operands(case)
    mine, theirs = _search_both(reference, o, rerank)
    for n in ("ids", "steps", "internal_visits", "candidates"):
        a, b = getattr(mine, n).numpy(), np.asarray(getattr(theirs, n))
        assert a.shape == b.shape, n
        assert (a == b).all(), f"{n}: {int((a != b).sum())} differ"
    d, dref = mine.dists.numpy(), np.asarray(theirs.dists)
    assert np.array_equal(np.isinf(d), np.isinf(dref))
    if rerank:
        ids = mine.ids.numpy()
        q64, x64 = (o[k].astype(np.float64) for k in ("q", "db"))
        scale = (q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[ids]
        fin = np.isfinite(dref)
        assert (np.abs(d[fin] - dref[fin]) <= REL * scale[fin]).all()
    else:
        assert (d == 0).all() and (dref == 0).all()


def _kernel_model(t, q, roots, kind, beam_width, max_steps):
    """The kernel's loop in numpy, row by row: each row stops when none of
    its live slots is internal or its steps reach ``max_steps``; the top
    W of the 2W candidates by a stable rank (priority descending, column
    ascending)."""
    R, W = q.shape[0], beam_width
    ch = t.children
    out_nodes = np.full((R, W), -1, np.int32)
    steps = np.zeros(R, np.int32)
    visits = np.zeros(R, np.int32)
    for r in range(R):
        nodes = np.full(W, -1, np.int64)
        prio = np.full(W, -np.inf, np.float32)
        nodes[0] = 0 if roots is None else roots[r]
        prio[0] = 0.0
        while True:
            act = (nodes >= 0) & (ch[np.maximum(nodes, 0), 0] >= 0)
            if not act.any() or steps[r] >= max_steps:
                break
            cn = np.concatenate([nodes, np.full(W, -1, np.int64)])
            cp = np.concatenate([np.where(nodes >= 0, prio, -np.inf),
                                 np.full(W, -np.inf)]).astype(np.float32)
            for w in np.nonzero(act)[0]:
                n = nodes[w]
                if kind == "kd":
                    al = np.float32(q[r, t.dims[n]] - t.tau[n])
                else:
                    al = np.float32(np.dot(t.proj[n], q[r]) - t.tau[n])
                near, far = ((ch[n, 0], ch[n, 1]) if al <= 0
                             else (ch[n, 1], ch[n, 0]))
                cn[w], cn[W + w] = near, far
                cp[W + w] = np.float32(prio[w] - np.float32(abs(al)))
            j = np.arange(2 * W)
            rank = ((cp[None, :] > cp[:, None])
                    | ((cp[None, :] == cp[:, None]) & (j[None, :] < j[:, None]))
                    ).sum(1)
            keep = rank < W
            nodes[rank[keep]] = np.where(cp[keep] == -np.inf, -1, cn[keep])
            prio[rank[keep]] = cp[keep]
            steps[r] += 1
            visits[r] += int(act.sum())
        out_nodes[r] = nodes
    return out_nodes, steps, visits


@pytest.mark.parametrize("case", DESCENT_EDGES, ids=IDS)
def test_per_row_exit_equals_the_batch_loop(case):
    """The kernel's design, modelled in numpy: every row stopping on its
    own gives the plain batch loop's beam, steps and visits."""
    o = descent_edge_operands(case)
    t = o["tree"]
    nodes, steps, visits, cand, n_cand = ops.tree_descent_op(
        t.device_arrays("cpu"), torch.as_tensor(o["q"]),
        roots=_t(o["roots"]), **o["kw"])
    m_nodes, m_steps, m_visits = _kernel_model(t, o["q"], o["roots"],
                                               **o["kw"])
    assert (nodes.numpy() == m_nodes).all()
    assert (steps.numpy() == m_steps).all()
    assert (visits.numpy() == m_visits).all()
    # the leaf gather: each slot's leaf row, -1 for internal or dead slots
    rows = np.where(m_nodes >= 0, t.leaf_row[np.maximum(m_nodes, 0)], -1)
    ents = np.where(rows[..., None] >= 0,
                    t.leaf_entities[np.maximum(rows, 0)], -1)
    want = ents.reshape(len(rows), -1)
    assert (cand.numpy() == want).all()
    assert (n_cand.numpy() == (want >= 0).sum(1)).all()


@pytest.mark.parametrize("case", [c for c in DESCENT_EDGES
                                  if c[7] is None], ids=lambda c: c[0])
def test_more_steps_change_nothing_once_bottomed_out(case):
    """Past every row's bottom-out a step is the identity: twenty more
    allowed steps give the same five results."""
    o = descent_edge_operands(case)
    arrays = o["tree"].device_arrays("cpu")
    kw = o["kw"]
    a = ops.tree_descent_op(arrays, torch.as_tensor(o["q"]),
                            roots=_t(o["roots"]), **kw)
    b = ops.tree_descent_op(arrays, torch.as_tensor(o["q"]),
                            roots=_t(o["roots"]),
                            **dict(kw, max_steps=kw["max_steps"] + 20))
    assert int(a[1].max()) < kw["max_steps"]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_op_runs_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor goes to ``ref.tree_descent_ref`` (the kernel's launch
    count does not move), and the kernel's wrapper refuses it."""
    o = descent_edge_operands(DESCENT_EDGES[1])
    arrays = o["tree"].device_arrays("cpu")
    calls = []
    plain = ref.tree_descent_ref

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "tree_descent_ref", spy)
    before = tree_descent.LAUNCHES.count
    out = ops.tree_descent_op(arrays, torch.as_tensor(o["q"]),
                              roots=_t(o["roots"]), **o["kw"])
    assert calls == [1] and tree_descent.LAUNCHES.count == before
    assert [x.dtype for x in out] == [torch.int32] * 5
    with pytest.raises(ValueError, match="CUDA tensors"):
        tree_descent.tree_descent(arrays, torch.as_tensor(o["q"]),
                                  **o["kw"])


@pytest.mark.parametrize("case", [DESCENT_EDGES[1], DESCENT_EDGES[5]],
                         ids=lambda c: c[0])
def test_op_meta_branch_gives_the_shapes(case):
    """On ``meta`` the op returns the CPU result's shapes and dtypes, with
    no storage and no loop run."""
    o = descent_edge_operands(case)
    arrays = o["tree"].device_arrays("cpu")
    cpu = ops.tree_descent_op(arrays, torch.as_tensor(o["q"]),
                              roots=_t(o["roots"]), **o["kw"])
    meta = ops.tree_descent_op(
        {n: v.to("meta") for n, v in arrays.items()},
        torch.as_tensor(o["q"]).to("meta"),
        roots=None if o["roots"] is None else _t(o["roots"]).to("meta"),
        **o["kw"])
    for c, m in zip(cpu, meta):
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(c.shape), c.dtype)
    res = port_tree.tree_search(
        {n: v.to("meta") for n, v in arrays.items()},
        torch.as_tensor(o["db"]).to("meta"),
        torch.as_tensor(o["q"]).to("meta"), k=K, **o["kw"])
    assert tuple(res.ids.shape) == (o["q"].shape[0], K)


def test_every_caller_descends_through_the_op(monkeypatch):
    """The four paths that descend a tree reach ``tree_descent_op`` (on
    the CPU its plain version): ``SearchIndex``'s QLBT, the two-level kd
    top and forest bottom, and the served forest's local."""
    from repro_torch.core.index import build_index
    from repro_torch.core.protocol import IndexSpec
    from repro_torch.core.two_level import TwoLevelConfig, build_two_level
    from repro_torch.distributed.backend import ShardedSearchBackend

    kinds = []
    plain = ref.tree_descent_ref

    def spy(arrays, queries, **kw):
        kinds.append((kw["kind"], kw["roots"] is not None))
        return plain(arrays, queries, **kw)

    monkeypatch.setattr(ref, "tree_descent_ref", spy)
    rng = np.random.default_rng(7)
    db = rng.normal(size=(1200, 8)).astype(np.float32)
    q = db[:6] + 0.05 * rng.normal(size=(6, 8)).astype(np.float32)
    qlbt = build_index(IndexSpec(kind="qlbt"), db, p=rng.random(1200),
                       device="cpu")
    qlbt.search(q, 5)
    assert kinds == [("rp", False)]
    geo = rng.normal(size=(1200, 2)).astype(np.float32)
    idx = build_two_level(db, TwoLevelConfig(
        n_clusters=16, top="kdtree", bottom="tree", kmeans_iters=3),
        partition_features=geo, device="cpu")
    kinds.clear()
    idx.search(q, 5, nprobe=4, query_partition_features=geo[:6])
    assert kinds == [("kd", False), ("rp", True)]
    forest = build_two_level(db, TwoLevelConfig(
        n_clusters=16, bottom="tree", kmeans_iters=3), device="cpu")
    kinds.clear()
    be = ShardedSearchBackend(forest, k=5, nprobe_local=4, beam_width=4,
                              device="cpu")
    assert be.kind == "forest"
    be(q)
    assert kinds == [("rp", True)]
