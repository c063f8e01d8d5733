"""The served forest kind (tree / QLBT bottom) on the CPU, held against the
reference.

A two-level index with a tree or QLBT bottom, built by the reference, is
carried across with ``convert.index_from_arrays`` (``carry`` below, which
also carries an index mid-lifecycle), so both packages slice and search
the same forest.  The port's forest layouts (packed and slab) must equal
the reference's bit for bit; its forest ``ShardedSearchBackend`` must
return the reference's ids (the reference's backend on a one-device
mesh), fused against fused and unfused against unfused, filtered and not,
at k 10 and 50.  The tile read by row id (``candidate_rows_topk``, the
forest's rerank) is held by its plain version: the gathered tile's, the
reference's oracle on that tile, and the kernels' rule in passes.

Tolerance: ids exactly; distances to rtol=1e-5 plus atol=1e-4 (XLA-CPU
and torch-CPU fp32 products round differently; distances here are
O(10-100)).  Inputs are continuous normal data, never tied to within
that rounding.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.convert import TREE_ARRAYS, index_from_arrays
from repro_torch.core.metadata import FilterSpec, MetadataTable
from repro_torch.distributed import sharding
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import ref
from repro_torch.kernels.common import INF, KMAX, topk_passes
from repro_torch.serve.cell import ServingCell
from repro_torch.testing import (ROWS_EDGES, rows_edge_operands,
                                 rows_union_topk)

N, D, NB, B, NPROBE, BEAM = 3000, 16, 32, 16, 8, 4
RTOL, ATOL = 1e-5, 1e-4
SELECTIVITY = {"narrow": 4, "wide": 49}      # pct <= hi: 0.05 and 0.5


def tree_arrays(t) -> dict:
    """A reference FlatTree as the numpy dict ``tree_from_arrays`` takes."""
    return {"kind": t.kind,
            **{n: np.asarray(getattr(t, n)) for n in TREE_ARRAYS}}


def carry(ref_idx, metadata=None, lexical=None):
    """A reference TwoLevelIndex carried across as numpy arrays, with its
    mutation state (the port's delta log starts at its version)."""
    arrays = {n: np.asarray(getattr(ref_idx, n)) for n in
              ("db", "centroids", "bucket_ids", "bucket_counts")}
    for name in ("alive", "entity_bucket", "dirty", "p", "part_feats"):
        if getattr(ref_idx, name) is not None:
            arrays[name] = np.asarray(getattr(ref_idx, name))
    for name in ("n_adds", "n_deletes", "mutation_version"):
        arrays[name] = getattr(ref_idx, name)
    if ref_idx.top_pq is not None:
        arrays["pq_codebooks"] = np.asarray(ref_idx.top_pq.codebooks)
        arrays["pq_codes"] = np.asarray(ref_idx.top_pq.codes)
    if ref_idx.top_kd is not None:
        arrays["kd"] = tree_arrays(ref_idx.top_kd)
    if ref_idx.bottom_lsh is not None:
        arrays["lsh_proj"] = np.asarray(ref_idx.bottom_lsh.proj)
        arrays["lsh_codes"] = np.asarray(ref_idx.bottom_lsh.codes)
    if ref_idx.forest is not None:
        arrays["forest"] = [tree_arrays(t) for t in ref_idx.forest.trees]
    if ref_idx.base_trees is not None:
        arrays["base_trees"] = [tree_arrays(t) for t in ref_idx.base_trees]
    return index_from_arrays(arrays, dataclasses.asdict(ref_idx.config),
                             device="cpu", metadata=metadata,
                             lexical=lexical)


def same(port, theirs, rtol=RTOL, atol=ATOL):
    (pd, pi), (td, ti) = port, theirs
    pd, pi, td, ti = map(np.asarray, (pd, pi, td, ti))
    assert pi.shape == ti.shape
    assert (pi == ti).all(), f"{int((pi != ti).sum())} ids differ"
    np.testing.assert_allclose(pd, td, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def world(reference):
    rng = np.random.default_rng(21)
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = (db[rng.choice(N, B, replace=False)]
         + 0.3 * rng.normal(size=(B, D))).astype(np.float32)
    p = rng.random(N) ** 6 + 1e-4
    pct = rng.permutation(N) % 100
    idx = {}
    for bottom in ("tree", "qlbt"):
        r = reference.two_level.build_two_level(
            db, reference.two_level.TwoLevelConfig(
                n_clusters=NB, bottom=bottom, kmeans_iters=4, seed=0),
            p=p if bottom == "qlbt" else None)
        idx[bottom] = (r, carry(r))
    return types.SimpleNamespace(
        db=db, q=q, p=p, idx=idx,
        meta=MetadataTable({"pct": pct}),
        ref_meta=reference.metadata.MetadataTable({"pct": pct}),
        mesh=jax.make_mesh((1, 1), ("data", "model")))


# ------------------------------------------------------------- layouts
@pytest.mark.parametrize("layout", ["packed", "slab"])
@pytest.mark.parametrize("n_dev", [1, 2])
@pytest.mark.parametrize("headroom", [1.0, 1.5])
def test_forest_layout_matches_reference(reference, world, layout, n_dev,
                                         headroom):
    r, port = world.idx["qlbt"]
    theirs = reference.sharding.forest_shard_shapes(r, n_dev, headroom,
                                                    layout=layout)
    mine = sharding.forest_shard_shapes(port, n_dev, headroom, layout=layout)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    pairs = [(mine, theirs)] + ([(None, None)] if layout == "packed"
                                else [])
    for ours, yours in pairs:
        a = sharding.shard_forest(port, n_dev, shapes=ours)
        b = reference.sharding.shard_forest(r, n_dev, shapes=yours)
        assert a.keys() == b.keys()
        for name in a:
            x, y = np.asarray(a[name]), np.asarray(b[name])
            assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_forest_layout_refuses_outgrown_shapes(world):
    _, port = world.idx["tree"]
    small = dataclasses.replace(
        sharding.forest_shard_shapes(port, 1, layout="slab"), node_slab=1,
        nodes=NB)
    with pytest.raises(ValueError, match="outgrew"):
        sharding.shard_forest(port, 1, shapes=small)
    with pytest.raises(ValueError, match="slab layout"):
        sharding.slice_forest_delta(
            port, sharding.forest_shard_shapes(port, 1), [0])


# ------------------------------------------------------------- backend
@pytest.fixture(scope="module")
def backends(reference, world):
    """(bottom, fused, k) -> (port backend, reference backend), built
    once: filters are data, so one pair serves every filter."""
    cache = {}

    def get(bottom, fused, k):
        key = (bottom, fused, k)
        if key not in cache:
            r, port = world.idx[bottom]
            cache[key] = (
                ShardedSearchBackend(port, kind="auto", k=k,
                                     nprobe_local=NPROBE, beam_width=BEAM,
                                     fused=fused, metadata=world.meta,
                                     device="cpu"),
                reference.backend.ShardedSearchBackend(
                    world.mesh, r, kind="auto", k=k, nprobe_local=NPROBE,
                    beam_width=BEAM, fused=fused, metadata=world.ref_meta))
        return cache[key]
    return get


@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bottom", ["tree", "qlbt"])
def test_forest_backend_matches_reference(reference, world, backends,
                                          bottom, fused, k):
    mine, theirs = backends(bottom, fused, k)
    assert mine.kind == theirs.kind == "forest"
    same(mine(world.q), theirs(world.q))
    for name, hi in SELECTIVITY.items():
        spec = FilterSpec.range("pct", 0, hi)
        got = mine(world.q, filter_spec=spec)
        same(got, theirs(world.q, filter_spec=reference.metadata.FilterSpec
                         .range("pct", 0, hi)))
        ids = got[1][got[1] >= 0]
        assert (world.meta.column("pct")[ids] <= hi).all(), name


def test_forest_layouts_and_cell_serve_the_same_answers(world, backends):
    """The packed layout (``delta_updates=False``) and a ``ServingCell``
    over the slab layout answer as the backend does."""
    _, port = world.idx["tree"]
    want = backends("tree", True, 10)[0](world.q)
    packed = ShardedSearchBackend(port, k=10, nprobe_local=NPROBE,
                                  beam_width=BEAM, delta_updates=False,
                                  device="cpu")
    assert packed._shapes.node_slab == 0
    got = packed(world.q)
    assert (got[1] == want[1]).all()
    np.testing.assert_array_equal(got[0], want[0])
    cell = ServingCell.sharded(port, k=10, nprobe_local=NPROBE,
                               beam_width=BEAM, device="cpu")
    try:
        assert cell.search_fn.kind == "forest"
        for b in range(4):
            d, i = cell.search(world.q[b], timeout=60)
            assert (i == want[1][b]).all()
    finally:
        cell.close()


def test_forest_fused_and_unfused_agree_on_the_cpu(world, backends):
    """On the CPU the fused rerank is the plain version of the rows-by-id
    entry: the same ids as the unfused gather, which no repeated slot id
    can split (the leaves partition each bucket's entities)."""
    for bottom in ("tree", "qlbt"):
        a = backends(bottom, True, 10)[0](world.q)
        b = backends(bottom, False, 10)[0](world.q)
        assert (a[1] == b[1]).all()
        np.testing.assert_array_equal(a[0], b[0])


# ---------------------------------------------- the tile read by row id
def _t(case):
    o = rows_edge_operands(case)
    return (torch.as_tensor(o["q"]), torch.as_tensor(o["rows"]),
            torch.as_tensor(o["ids"]), o["k"])


@pytest.mark.parametrize("case", ROWS_EDGES, ids=[c[0] for c in ROWS_EDGES])
def test_rows_entry_plain_equals_gathered_tile(reference, case):
    q, rows, ids, k = _t(case)
    got = ref.candidate_rows_topk_ref(q, rows, ids, k)
    live = torch.where((ids >= 0) & (ids < rows.shape[0]), ids, -1)
    vecs = rows[torch.clamp(live, min=0).long()]
    want = ref.candidate_topk_ref(q, vecs, live, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if q.shape[0]:
        td, ti = reference.ref.candidate_topk_ref(
            jnp.asarray(q.numpy()), jnp.asarray(vecs.numpy()),
            jnp.asarray(live.numpy()), k)
        same(got, (td, ti))
    if case[-1] != "repeat":        # distinct ids: the kernels' rule too
        union = rows_union_topk(q, rows, ids, k)
        assert torch.equal(got[1], union[1])


@pytest.mark.parametrize("k", [10, 33, 64, 100])
@pytest.mark.parametrize("case", ROWS_EDGES, ids=[c[0] for c in ROWS_EDGES])
def test_rows_entry_passes_keep_the_kernels_rule(case, k):
    """Driven as the kernel is above its 32-pair list (``topk_passes``, the
    first pass admitting every pair), the bounded plain version equals
    the kernels' rule in one call: a repeated id emitted once."""
    q, rows, ids, _ = _t(case)
    b = q.shape[0]
    if b == 0:
        return
    first = (torch.full((b,), -INF), torch.full((b,), -2**31,
                                                dtype=torch.int32))

    def run(kr, ad, ai):
        return ref.candidate_rows_topk_ref(
            q, rows, ids, kr, after=first if ad is None else (ad, ai))

    got = topk_passes(run, b, k, KMAX, "cpu")
    want = rows_union_topk(q, rows, ids, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for row in got[1].numpy():
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()
