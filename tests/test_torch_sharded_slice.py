"""Sharded search over more than one rank, on the CPU.

Three layers, from the inside out:

1. the shard arithmetic -- ``ShardPlan`` and the three plans,
   ``_check_disjoint``, ``_pad_queries`` and ``_pad_term_queries`` --
   against the reference's;
2. the single-process shard loop (``repro_torch.testing.shard_loop``:
   every shard's local with its own tables and its ``lin``, stacked and
   merged) at S = 4 and 8 against the reference's backends on S of 8
   fake XLA devices (a subprocess, as ``tests/test_distributed.py`` runs
   them), with K = 50 buckets, so the bucket grid pads (to 52 and 56):
   ids exactly, distances to 1e-5 of ``|q|^2 + |x|^2`` (ROADMAP faults 2
   and 7: the expansion ``(qn + xn) - 2 q.x`` rounds on that scale, which
   a near-zero distance of this clustered corpus shows).  One test holds
   the IVF local's pad-centroid mask (a zero pad centroid must never take
   a probe from a real bucket), one the forest at full probe against the
   one-shard index; and every filtered, int8, lexical and hybrid case at
   S = 4 and on a (2, 2) mesh with a query axis against the reference's
   backend on those meshes (the filter slices, the flat locals' row
   offsets, the query blocks);
3. one spawn of 4 gloo ranks (a ``FileStore`` under a temporary
   directory, every group with a 60 s timeout, every rank joined with a
   time limit) on meshes ``(4,)`` over ``("data",)``, ``(2, 2)`` with
   ``query_axes=("model",)`` at B = 37, and ``(2, 2)`` with ``axes=
   ("model", "data")`` (gathered out of the groups' rank order): every
   kind and option must equal the shard loop bit for bit, on every rank,
   and every flat case the backend built without a mesh; a request that
   fails to compile on a leading root fails there alone; the host entries must match the exact scan; a delta apply (an add and
   a delete through ``pop_delta``) must equal a full re-place bit for bit
   with the reference's ``bytes`` / ``full_bytes`` on a 4-device mesh;
   and a rank-0 ``ServingCell`` with three followers must answer 64
   requests as direct calls do and take a full re-place, ``close()``
   ending the followers; a cell over the ``(4,)`` mesh of each kind takes
   an add, a delete and a full re-place through
   ``ServingCell.apply_updates`` on the root, after which every rank's
   tables equal the shard loop's bit for bit (and the answers, filtered
   ones too), with the reference's stats, each follower having received
   only its part; a follower that fails its part fails every rank; and
   in a second group (6 s timeout) a root idle 15 s still serves, while
   a root that sends nothing fails its followers after the timeout.

The ranks and the reference run in subprocesses; a rank that fails or
outlives its limit fails the tests that read it.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from test_torch_reference import REPO, reference  # noqa: F401  (fixture)

from repro_torch.distributed import sharding
from repro_torch.testing import shard_backends, shard_loop

N, D, NB, B, K, LEAF, BEAM, NPROBE = 2500, 16, 50, 37, 10, 8, 4, 2
RTOL, ATOL = 1e-5, 1e-4
WORLD = 4
RANK_LIMIT_S = 300            # every rank of the spawn, joined together
REF_LIMIT_S = 600
NARROW, WIDE = (0, 4), (0, 49)       # pct ranges: selectivity 0.05, 0.5
V = 30                               # vocabulary of the docs


def _data():
    """Clustered corpus, queries near rows, pct column, docs: numpy, the
    same in every process."""
    rng = np.random.default_rng(19)
    c = rng.normal(size=(32, D)) * 4
    db = (c[rng.integers(0, 32, N)] + rng.normal(size=(N, D))).astype(
        np.float32)
    q = (db[rng.choice(N, B, replace=False)]
         + 0.05 * rng.normal(size=(B, D))).astype(np.float32)
    pct = rng.permutation(N) % 100
    docs = [rng.integers(0, V, size=int(rng.integers(1, 8))).tolist()
            for _ in range(N)]
    return types.SimpleNamespace(db=db, q=q, pct=pct, docs=docs)


def _lex_queries():
    """Per-query term ids (the last slot a -1 pad) and weights."""
    rng = np.random.default_rng(29)
    qt = rng.integers(0, V, (B, 4)).astype(np.int32)
    qt[:, 3] = -1
    return qt, rng.random((B, 4)).astype(np.float32)


# ------------------------------------------------------------- reference
_REF = """
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import warnings; warnings.filterwarnings("ignore")
import numpy as np
import jax
from test_torch_reference import reference_modules
from test_torch_forest_slice import carry
from repro_torch.convert import metadata_from_arrays
from test_torch_sharded_slice import (_data, NB, K, LEAF, BEAM, NPROBE, V,
                                      CASES, REF_MESHES, _case, _lex_queries,
                                      delta_inputs)

out_path = sys.argv[1]
data = _data()
auto = jax.sharding.AxisType.Auto
mesh = lambda s: jax.make_mesh((s,), ("data",), devices=jax.devices()[:s],
                               axis_types=(auto,))
out = {}
with reference_modules() as ref:
    tl = ref.two_level
    idx = {b: tl.build_two_level(data.db, tl.TwoLevelConfig(
               n_clusters=NB, top="brute", bottom=b, kmeans_iters=5,
               tree_leaf=LEAF),
               metadata=ref.metadata.MetadataTable({"pct": data.pct}))
           for b in ("brute", "tree")}
    out["index"] = {b: pickle.dumps(carry(
        i, metadata=metadata_from_arrays({"pct": data.pct})))
        for b, i in idx.items()}
    Be = ref.backend.ShardedSearchBackend
    for s in (4, 8):
        kloc = -(-NB // s)
        cases = {
            "brute": (data.db, dict(kind="brute")),
            "ivf": (idx["brute"], dict(kind="ivf", nprobe_local=NPROBE)),
            "ivf_one_probe": (idx["brute"], dict(kind="ivf",
                                                 nprobe_local=1)),
            "ivf_full": (idx["brute"], dict(kind="ivf",
                                            nprobe_local=kloc)),
            "forest": (idx["tree"], dict(kind="forest",
                                         nprobe_local=NPROBE,
                                         beam_width=BEAM)),
            "forest_full": (idx["tree"], dict(kind="forest",
                                              nprobe_local=kloc,
                                              beam_width=BEAM)),
        }
        for name, (target, kw) in cases.items():
            be = Be(mesh(s), target, k=K, axes=("data",), **kw)
            out[(s, name)] = be(data.q)
    # every option case over the shards, with the reference's own
    # metadata, slabs and filters
    qt, qw = _lex_queries()
    inp = {"db": data.db, "ivf": idx["brute"], "tree": idx["tree"],
           "meta": ref.metadata.MetadataTable({"pct": data.pct}),
           "slabs": ref.lexical.build_lexical_slabs(data.docs, V, slots=8),
           "qt": qt, "qw": qw}
    for mname, (shape, names, axes, qaxes) in REF_MESHES.items():
        m = jax.make_mesh(shape, names, devices=jax.devices()[:4],
                          axis_types=(auto,) * len(shape))
        for case in CASES:
            target, kw, call = _case(case, inp, ref.metadata.FilterSpec)
            be = Be(m, target, k=K, axes=axes, query_axes=qaxes, **kw)
            out[(mname, case)] = be(data.q, **call)
    # the lifecycle on a 4-device mesh: an add and a delete, popped
    new, gone = delta_inputs(idx["brute"].centroids, idx["brute"].bucket_ids,
                             idx["brute"].bucket_counts)
    for b, kind in (("brute", "ivf"), ("tree", "forest")):
        x = idx[b]
        be = Be(mesh(4), x, kind=kind, k=K, axes=("data",),
                nprobe_local=NPROBE, beam_width=BEAM, headroom=1.5)
        flat = Be(mesh(4), np.asarray(x.db), kind="brute", k=K,
                  axes=("data",), headroom=1.5)
        for step in ("add", "delete"):
            if step == "add":
                x.add_entities(new, metadata={"pct": np.arange(len(new))})
            else:
                x.delete_entities(gone)
            man = x.pop_delta()
            out[("stats", kind, step)] = be.apply_updates(x, delta=man)
            if kind == "ivf":
                fm = dataclasses.replace(
                    man, dirty_buckets=np.zeros(0, np.int64))
                out[("stats", "brute", step)] = flat.apply_updates(
                    np.asarray(x.db), delta=fm)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def delta_inputs(centroids, bucket_ids, bucket_counts):
    """The lifecycle's inputs, the same for both packages: 10 vectors near
    each of buckets 3 and 11, then the first 9 members of buckets 5 and
    17 deleted."""
    rng = np.random.default_rng(23)
    c = np.repeat(np.asarray(centroids)[[3, 11]], 10, axis=0)
    new = (c + 0.2 * rng.normal(size=c.shape)).astype(np.float32)
    bids, counts = np.asarray(bucket_ids), np.asarray(bucket_counts)
    gone = np.concatenate([bids[b][:min(int(counts[b]), 9)]
                           for b in (5, 17)]).astype(np.int64)
    return new, gone


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.path.join(REPO, "tests")]))


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's answers at S = 4 and 8 and its lifecycle stats on
    4 devices, with the port's copies of its two indexes."""
    path = str(tmp_path_factory.mktemp("reference") / "ref.pkl")
    r = subprocess.run([sys.executable, "-c", _REF, path],
                       capture_output=True, text=True, timeout=REF_LIMIT_S,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(path, "rb") as f:
        out = pickle.load(f)
    out["index"] = {b: pickle.loads(v) for b, v in out["index"].items()}
    return out


def _same(mine, theirs, q, db, alpha=1.0):
    """Ids exactly; distances to fp32 rounding, RTOL of the terms summed:
    ``alpha (|q|^2 + |x|^2)`` for the expansion (faults 2 and 7) plus
    ``(1 - alpha) (|d| + 1)`` for a BM25 part (``alpha`` 0: lexical).
    Empty slots (-1, +inf) must agree exactly."""
    ids = mine[1]
    assert np.array_equal(ids, np.asarray(theirs[1]))
    td = np.asarray(theirs[0])
    scale = alpha * ((q.astype(np.float64) ** 2).sum(1)[:, None] + (
        db.astype(np.float64) ** 2).sum(1)[np.maximum(ids, 0)])
    scale = scale + (1 - alpha) * (
        np.abs(np.where(np.isfinite(td), td, 0)).max() + 1)
    with np.errstate(invalid="ignore"):
        close = np.abs(mine[0] - td) <= RTOL * scale
    assert (close | (mine[0] == td)).all()


def _bits(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    assert np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert np.array_equal(a[1], b[1])


# ------------------------------------------------------------- arithmetic
def _spec(p) -> tuple:
    """A reference ``PartitionSpec`` as per-dimension axis tuples (JAX
    writes a one-axis entry as the bare name)."""
    return tuple((e,) if isinstance(e, str) else e for e in p)


class _Mesh:
    """The shape of a mesh, for both packages' plans: the port reads
    ``mesh_dim_names`` and the rank tensor, the reference ``shape``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("shape,names", [((2, 4), ("data", "model")),
                                         ((2, 4, 2), ("pod", "data",
                                                      "model"))])
def test_shard_plans_match_reference(reference, shape, names):
    mesh = _Mesh(shape, names)
    dims = ("dp", "tp", ("dp", "tp"), ("ep", "pp"), None, "fsdp",
            ("pp", "dp"))
    for mine, theirs in ((sharding.LOCAL_PLAN, reference.sharding.LOCAL_PLAN),
                         (sharding.SINGLE_POD_PLAN,
                          reference.sharding.SINGLE_POD_PLAN),
                         (sharding.MULTI_POD_PLAN,
                          reference.sharding.MULTI_POD_PLAN)):
        assert dataclasses.astuple(mine)[:5] == dataclasses.astuple(
            theirs)[:5]
        if "pod" not in names and mine.pp:
            continue
        m, t = mine.with_mesh(mesh), theirs.with_mesh(mesh)
        assert m.mesh is mesh and t.mesh is mesh
        for d in dims:
            assert m.resolve(d) == t.resolve(d)
            assert m.size_of(d) == t.size_of(d)
        for role in ("dp", "fsdp", "tp", "ep", "pp"):
            assert m.axis_size(role) == t.axis_size(role)
        assert m.p(*dims) == _spec(t.p(*dims))
        for shp in ((8, 6), (4, 16), (3, 5)):
            assert m.div_p(shp, "dp", "tp") == _spec(t.div_p(shp, "dp",
                                                             "tp"))
        assert mine.axis_size("tp") == theirs.axis_size("tp") == 1


def test_disjoint_axes_and_query_padding_match_reference(reference):
    mesh = _Mesh((2, 3), ("data", "model"))
    rs = reference.sharding
    for axes, qaxes in ((("data",), ("model",)), (("data", "model"), ()),
                        (("data", "model"), ("model",)),
                        (("data",), ("data", "model"))):
        try:
            rs._check_disjoint(axes, qaxes)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            sharding._check_disjoint(axes, qaxes)
        else:
            with pytest.raises(ValueError) as got:
                sharding._check_disjoint(axes, qaxes)
            assert str(got.value) == want
    rng = np.random.default_rng(4)
    for b in (1, 6, 7, 37):
        q = rng.normal(size=(b, 5)).astype(np.float32)
        qt = rng.integers(0, 9, (b, 4)).astype(np.int32)
        qw = rng.random((b, 4)).astype(np.float32)
        for qaxes in ((), ("model",), ("data", "model")):
            mp, mb = sharding._pad_queries(mesh, q, qaxes)
            tp, tb = rs._pad_queries(mesh, q, qaxes)
            assert mb == tb and np.array_equal(mp, np.asarray(tp))
            mine = sharding._pad_term_queries(mesh, qt, qw, qaxes)
            theirs = rs._pad_term_queries(mesh, qt, qw, qaxes)
            assert mine[2] == theirs[2]
            for a, t in zip(mine[:2], theirs[:2]):
                assert a.dtype == np.asarray(t).dtype
                assert np.array_equal(a, np.asarray(t))
            assert sharding._q_spec(qaxes) == _spec(rs._q_spec(qaxes))


# ------------------------------------------------------------- shard loop
def _loop_cases(ref_run):
    data = _data()
    s_kw = {"brute": (data.db, dict(kind="brute")),
            "ivf": (ref_run["index"]["brute"], dict(kind="ivf",
                                                    nprobe_local=NPROBE)),
            "ivf_one_probe": (ref_run["index"]["brute"],
                              dict(kind="ivf", nprobe_local=1)),
            "forest": (ref_run["index"]["tree"],
                       dict(kind="forest", nprobe_local=NPROBE,
                            beam_width=BEAM))}
    return data, s_kw


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("name", ["brute", "ivf", "ivf_one_probe",
                                  "ivf_full", "forest", "forest_full"])
def test_shard_loop_matches_reference(ref_run, S, name):
    data, cases = _loop_cases(ref_run)
    kloc = -(-NB // S)
    if name == "ivf_full":
        target, kw = ref_run["index"]["brute"], dict(kind="ivf",
                                                      nprobe_local=kloc)
    elif name == "forest_full":
        target, kw = ref_run["index"]["tree"], dict(
            kind="forest", nprobe_local=kloc, beam_width=BEAM)
    else:
        target, kw = cases[name]
    bes = shard_backends(target, S, k=K, device="cpu", **kw)
    _same(shard_loop(bes, data.q), ref_run[(S, name)], data.q, data.db)


def test_ivf_pad_centroids_never_take_a_probe(ref_run):
    """K = 50 over 8 shards: shard 7 holds bucket 49 and six zero pad
    centroids.  With one probe a shard, shard 7 must probe bucket 49 for
    every query -- also where a pad is nearer (|q|^2 < |q - c_49|^2) --
    and return its top-k from bucket 49's members."""
    data = _data()
    idx = ref_run["index"]["brute"]
    members = idx.bucket_ids[49][:int(idx.bucket_counts[49])]
    c49 = np.asarray(idx.centroids)[49]
    q = data.q
    assert ((q ** 2).sum(1) < ((q - c49) ** 2).sum(1)).any(), \
        "no query where an unmasked pad would win the probe"
    bes = shard_backends(idx, 8, k=K, kind="ivf", nprobe_local=1,
                         device="cpu")
    _, li = bes[7]._local(None, "semantic", 0.5)(torch.as_tensor(q))
    live = min(K, members.size)
    assert (li[:, :live] >= 0).all() and np.isin(li[:, :live],
                                                  members).all()
    want = np.argsort(((q[:, None, :] - idx.db[members][None]) ** 2).sum(-1),
                      axis=1, kind="stable")[:, :live]
    assert (li[:, :live].numpy() == members[want]).all()


@pytest.mark.parametrize("layout", ["packed", "slab"])
def test_one_shard_slicing_equals_its_row_of_the_whole(ref_run, layout):
    """What a rank slices (``shard_forest(..., only=lin)``) is its row of
    the whole slicing, with K = 50 over 8 shards (the last one short)."""
    idx = ref_run["index"]["tree"]
    shapes = sharding.forest_shard_shapes(idx, 8, 1.25, layout=layout)
    whole = sharding.shard_forest(idx, 8, shapes=shapes)
    for lin in range(8):
        one = sharding.shard_forest(idx, 8, shapes=shapes, only=lin)
        assert one.keys() == whole.keys()
        for name, v in whole.items():
            if name == "max_depth":
                assert one[name] == v
                continue
            assert one[name].dtype == v.dtype
            assert np.array_equal(one[name], v[lin:lin + 1]), (lin, name)


def test_forest_full_probe_matches_the_one_shard_index(ref_run):
    """Every shard descends the same per-bucket trees; with every bucket
    probed on both sides the candidate sets coincide."""
    data = _data()
    idx = ref_run["index"]["tree"]
    bes = shard_backends(idx, 8, k=K, kind="forest", nprobe_local=7,
                         beam_width=8, device="cpu")
    d, i = shard_loop(bes, data.q)
    ds, js, _ = idx.search(data.q, K, nprobe=NB, beam_width=8)
    np.testing.assert_allclose(np.sort(d, 1), np.sort(ds, 1), rtol=1e-4,
                               atol=1e-4)
    for b in range(B):
        assert set(i[b].tolist()) == set(js[b].tolist())


# ------------------------------------------------------------- 4 ranks
# name: (ranks, or None for the first ranks in order; shape; dimension
# names; axes; query_axes).  "permuted22" places the ranks so that each
# dimension's group numbers its members against their coordinates.
MESHES = {
    "flat4": (None, (4,), ("data",), ("data",), ()),
    "query22": (None, (2, 2), ("data", "model"), ("data",), ("model",)),
    "reversed22": (None, (2, 2), ("data", "model"), ("model", "data"), ()),
    "permuted22": ([3, 1, 2, 0], (2, 2), ("data", "model"),
                   ("data", "model"), ()),
}
CASES = ("brute", "brute_narrow", "brute_wide", "int8", "lexical",
         "lexical_wide", "hybrid", "ivf", "ivf_wide", "forest",
         "forest_narrow")
FLAT = CASES[:7]                    # one row scan: no split changes a row
ALPHA = {"lexical": 0.0, "lexical_wide": 0.0, "hybrid": 0.3}
# the meshes the reference answers every case on: (shape, names, axes,
# query_axes), the 4-rank meshes of the same shard and query grids
REF_MESHES = {"flat4": ((4,), ("data",), ("data",), ()),
              "query22": ((2, 2), ("data", "model"), ("data",),
                          ("model",))}


def _case(name, inp, FilterSpec=None):
    """(target, backend kwargs, call kwargs) of one case; ``FilterSpec``
    is the port's unless the reference's is given."""
    if FilterSpec is None:
        from repro_torch.core.metadata import FilterSpec

    narrow = FilterSpec.range("pct", *NARROW)
    wide = FilterSpec.range("pct", *WIDE)
    lex = dict(q_terms=inp["qt"], q_weights=inp["qw"])
    flat = dict(kind="brute", metadata=inp["meta"], lexical=inp["slabs"])
    return {
        "brute": (inp["db"], flat, {}),
        "brute_narrow": (inp["db"], flat, dict(filter_spec=narrow)),
        "brute_wide": (inp["db"], flat, dict(filter_spec=wide)),
        "int8": (inp["db"], dict(kind="brute", precision="int8"), {}),
        "lexical": (inp["db"], flat, dict(mode="lexical", **lex)),
        "lexical_wide": (inp["db"], flat, dict(mode="lexical",
                                              filter_spec=wide, **lex)),
        "hybrid": (inp["db"], flat, dict(mode="hybrid", alpha=ALPHA["hybrid"],
                                         **lex)),
        "ivf": (inp["ivf"], dict(kind="ivf", nprobe_local=NPROBE), {}),
        "ivf_wide": (inp["ivf"], dict(kind="ivf", nprobe_local=NPROBE),
                     dict(filter_spec=wide)),
        "forest": (inp["tree"], dict(kind="forest", nprobe_local=NPROBE,
                                     beam_width=BEAM), {}),
        "forest_narrow": (inp["tree"], dict(kind="forest",
                                            nprobe_local=NPROBE,
                                            beam_width=BEAM),
                          dict(filter_spec=narrow)),
    }[name]


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank of the spawn: every mesh, case, host entry, the lifecycle
    and the served cell; its results pickled to ``rank<r>.pkl``."""
    import datetime

    import torch.distributed as dist

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.brute import brute_search
    from repro_torch.distributed.backend import ShardedSearchBackend
    from repro_torch.launch.mesh import make_plan, make_test_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        meshes = {name: make_test_mesh(shape, names, device_type="cpu")
                      if order is None else DeviceMesh(
                          "cpu", torch.as_tensor(order).reshape(shape),
                          mesh_dim_names=names)
                  for name, (order, shape, names, _, _) in MESHES.items()}
        out = {"plan": make_plan(meshes["query22"]).p("dp", "tp"),
               "lin": {}}
        for mname, (_, _, _, axes, qaxes) in MESHES.items():
            mesh = meshes[mname]
            out[(mname, "collective")] = _collective(mesh, axes, qaxes,
                                                     rank)
            for case in CASES:
                target, kw, call = _case(case, inp)
                be = ShardedSearchBackend(target, k=K, mesh=mesh, axes=axes,
                                          query_axes=qaxes, device="cpu",
                                          **kw)
                out["lin"][mname] = be.slot
                out[(mname, case)] = be(inp["q"], **call)
                if rank == 0:
                    bes = shard_backends(target, be.n_dev, k=K,
                                         device="cpu", **kw)
                    out[("loop", mname, case)] = shard_loop(
                        bes, inp["q"], n_q=be.slot.n_q, **call)
            # the host entries
            out[(mname, "host_brute")] = sharding.sharded_brute_search(
                mesh, inp["db"], inp["q"], K, axes=axes, query_axes=qaxes)
            out[(mname, "host_ivf")] = sharding.sharded_ivf_search(
                mesh, inp["ivf"], inp["q"], K, nprobe_local=NB,
                axes=axes, query_axes=qaxes)
            out[(mname, "host_forest")] = sharding.sharded_forest_search(
                mesh, inp["tree"], inp["q"], K, nprobe_local=NB,
                beam_width=8, axes=axes, query_axes=qaxes)
        if rank == 0:
            # the one-shard backend: a flat scan's answer is the same at
            # every split
            for case in FLAT:
                target, kw, call = _case(case, inp)
                out[("one", case)] = ShardedSearchBackend(
                    target, k=K, device="cpu", **kw)(inp["q"], **call)
        out["bad_request"] = _bad_request(inp, meshes["flat4"], rank)
        out["cells"] = _cell_meshes()
        out["exact"] = brute_search(inp["q"], inp["db"], K, device="cpu")
        out["one_shard_forest"] = inp["tree"].search(
            inp["q"], K, nprobe=NB, beam_width=8)[:2]
        out["lifecycle"] = _lifecycle(inp, meshes["flat4"])
        out["cell"] = _cell(inp, meshes["flat4"], rank)
        out["cell_updates"] = _cell_updates(inp, meshes["flat4"], rank)
        out["failed_update"] = _failed_update(inp, meshes["flat4"], rank)
        out["compressed_psum"] = _compressed_psum(rank)
    finally:
        dist.destroy_process_group()
    out["heartbeat"] = _heartbeat(inp, rank, world, workdir)
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _bad_request(inp, mesh, rank: int) -> dict:
    """A leading root whose request fails to compile (a filter on an
    unknown column) fails alone; its followers serve the next call."""
    from repro_torch.core.metadata import FilterSpec
    from repro_torch.distributed.backend import ShardedSearchBackend

    be = ShardedSearchBackend(inp["db"], k=K, mesh=mesh, axes=("data",),
                              metadata=inp["meta"], device="cpu")
    wide = FilterSpec.range("pct", *WIDE)
    if rank != 0:
        return {"served": be.follow()}
    be.lead()
    try:
        with pytest.raises(KeyError, match="nope"):
            be(inp["q"], filter_spec=FilterSpec.range("nope", 0, 1))
        got = be(inp["q"], filter_spec=wide)
    finally:
        be.stop_followers()
    return {"got": got}


def _cell_meshes() -> dict:
    """``make_cell_meshes`` on every rank, in one order: two disjoint
    cells, three cells sharing the four ranks round-robin, and a cell
    larger than the pool (refused)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_cell_meshes

    def view(meshes):
        return [(m.mesh.tolist(), m.mesh_dim_names, m.get_coordinate(),
                 None if m.get_coordinate() is None
                 else dist.get_process_group_ranks(
                     m.get_group(m.mesh_dim_names[-1])))
                for m in meshes]

    out = {"disjoint": view(make_cell_meshes(2, device_type="cpu")),
           "two_d": view(make_cell_meshes(2, shape=(1, 2),
                                          device_type="cpu"))}
    shared = make_cell_meshes(3, shape=(2,), share_devices=True,
                              device_type="cpu")
    out["shared"] = view(shared)
    # the first and the third cell hold the same ranks in distinct groups
    if shared[0].get_coordinate() is not None:
        out["shared_distinct"] = (shared[0].get_group()
                                  is not shared[2].get_group())
    try:
        make_cell_meshes(1, shape=(8,), share_devices=True,
                         device_type="cpu")
        out["repeat"] = None
    except ValueError as e:
        out["repeat"] = str(e)
    return out


def _collective(mesh, axes, qaxes, rank: int) -> dict:
    """What the mesh collective moves: each rank's ``lin`` (and block
    ``qlin``) gathered, and the root's rank broadcast."""
    coll = sharding.MeshCollective(mesh, axes, qaxes)
    s = coll.slot
    t = torch.full((3, 2), float(s.lin))
    gd, gi = coll.gather_corpus(t, torch.full((3, 2), 10 * s.lin,
                                              dtype=torch.int32))
    qd, qi = coll.gather_queries(torch.full((2, 1), float(s.qlin)),
                                 torch.full((2, 1), s.qlin,
                                            dtype=torch.int32))
    v = torch.full((4,), float(rank))
    return {"corpus": (gd[:, 0, 0].tolist(), gi[:, 0, 0].tolist()),
            "shape": tuple(gd.shape), "queries": (qd[:, 0].tolist(),
                                                  qi[:, 0].tolist()),
            "object": coll.broadcast_object({"rank": rank}),
            "tensor": coll.broadcast(v).tolist(), "root": coll.root}


def _lifecycle(inp, mesh) -> dict:
    """An add and a delete, popped and applied as deltas on the IVF,
    forest and flat brute kinds, each against a control re-placed in
    full: stats, tables and answers."""
    from repro_torch.distributed.backend import ShardedSearchBackend

    out = {}
    kw = dict(k=K, mesh=mesh, axes=("data",), device="cpu", headroom=1.5)
    for b, kind in (("ivf", "ivf"), ("tree", "forest")):
        x = copy.deepcopy(inp[b])
        mine = ShardedSearchBackend(x, kind=kind, nprobe_local=NPROBE,
                                    beam_width=BEAM, **kw)
        control = ShardedSearchBackend(x, kind=kind, nprobe_local=NPROBE,
                                       beam_width=BEAM, **kw)
        flat = ShardedSearchBackend(np.asarray(x.db), kind="brute", **kw)
        flat_control = ShardedSearchBackend(np.asarray(x.db), kind="brute",
                                            **kw)
        for step in ("add", "delete"):
            if step == "add":
                x.add_entities(inp["new"],
                               metadata={"pct": np.arange(len(inp["new"]))})
            else:
                x.delete_entities(inp["gone"])
            man = x.pop_delta()
            pairs = [(kind, mine, control, x, man)]
            if kind == "ivf":
                fm = dataclasses.replace(
                    man, dirty_buckets=np.zeros(0, np.int64))
                pairs.append(("brute", flat, flat_control,
                              np.asarray(x.db), fm))
            for name, be, ctl, target, m in pairs:
                ptrs = [t.data_ptr() for t in be._args]
                st = be.apply_updates(target, delta=m)
                if name == "brute":
                    ctl.apply_updates(target, alive=np.asarray(x.alive))
                else:
                    ctl.apply_updates(target)
                out[(name, step)] = {
                    "stats": st,
                    "in_place": [t.data_ptr() for t in be._args] == ptrs,
                    "tables": all(torch.equal(a, c) for a, c in
                                  zip(be._args, ctl._args)),
                    "answers": (be(inp["q"]), ctl(inp["q"])),
                    "deleted_served": bool(np.isin(
                        be(inp["q"])[1], inp["gone"]).any())
                    if step == "delete" else False}
    return out


def _cell(inp, mesh, rank: int) -> dict:
    """Direct collective calls, then a cell on rank 0 with the other
    ranks following; 64 requests in batches of up to 16."""
    from repro_torch.core.metadata import FilterSpec
    from repro_torch.distributed.backend import ShardedSearchBackend
    from repro_torch.serve.cell import ServingCell

    reqs = inp["requests"]
    kw = dict(kind="brute", k=K, mesh=mesh, axes=("data",), device="cpu")
    direct = ShardedSearchBackend(inp["db"], **kw)(reqs)
    cell = ServingCell.sharded(inp["db"], max_batch=16, max_wait_ms=5.0,
                               **kw)
    if cell is None:
        return {"direct": direct, "followed": True}
    assert rank == 0
    try:
        futs = [cell.submit(r) for r in reqs]
        got = [f.get(timeout=120) for f in futs]
        # a request that fails on the root (this backend holds no
        # metadata) fails alone, and the followers serve the next one
        with pytest.raises(RuntimeError, match="backend failed"):
            cell.search(reqs[0], timeout=120,
                        filter=FilterSpec.range("pct", *NARROW))
        after = cell.search(reqs[1], timeout=120)
        # a full re-place on a cell that leads: every rank takes its shard
        replaced = cell.apply_updates(inp["db"])
        after_update = cell.search(reqs[2], timeout=120)
        stats = cell.stats()
    finally:
        cell.close()
    return {"direct": direct,
            "served": (np.stack([g[0] for g in got]),
                       np.stack([g[1] for g in got])),
            "after": after, "replaced": replaced,
            "after_update": after_update, "dispatches": stats.dispatches,
            "leads_after_close": cell.search_fn.leads}


# the kinds a cell over the (4,) mesh updates (index of the inputs, backend
# kind) and the steps: the lifecycle's add and delete, then a full re-place
UPDATE_KINDS = {"ivf": ("ivf", "ivf"), "forest": ("tree", "forest"),
                "brute": ("ivf", "brute")}
UPDATE_STEPS = ("add", "delete", "full")
GROUP_TIMEOUT_S = 6          # the heartbeat spawn's group timeout
IDLE_S = 15                  # a root idle past it, still served after
SILENT_S = 10                # a root that sends nothing (dead) this long


def _update_backend(inp, kind, **kw):
    """(mutable copy of the kind's index, its backend) for the updates."""
    from repro_torch.distributed.backend import ShardedSearchBackend

    src, bkind = UPDATE_KINDS[kind]
    x = copy.deepcopy(inp[src])
    target = np.asarray(x.db) if kind == "brute" else x
    return x, ShardedSearchBackend(target, kind=bkind, k=K,
                                   nprobe_local=NPROBE, beam_width=BEAM,
                                   headroom=1.5, device="cpu", **kw)


def _update_step(x, inp, kind, step) -> tuple:
    """Mutate ``x`` by one step and pop its manifest: (target, apply
    kwargs) of the kind's update (the flat part of the manifest for the
    brute kind; no manifest for a full re-place)."""
    if step == "add":
        x.add_entities(inp["new"], metadata={"pct": np.arange(len(inp["new"]))})
    elif step == "delete":
        x.delete_entities(inp["gone"])
    man = x.pop_delta() if step != "full" else None
    if kind != "brute":
        return x, {"delta": man}
    if man is None:
        return np.asarray(x.db), {"delta": None,
                                  "alive": np.asarray(x.alive)}
    return np.asarray(x.db), {"delta": dataclasses.replace(
        man, dirty_buckets=np.zeros(0, np.int64))}


def _cell_updates(inp, mesh, rank: int) -> dict:
    """A cell over the mesh for each kind, taking the steps through
    ``ServingCell.apply_updates`` on the root; every rank's tables after
    each step, the root's answers (a direct collective call), stats and
    the bytes it sent each rank."""
    from repro_torch.core.metadata import FilterSpec
    from repro_torch.serve.cell import ServingCell

    out = {}
    for kind in UPDATE_KINDS:
        x, be = _update_backend(inp, kind, mesh=mesh, axes=("data",))
        if rank != 0:
            tables = []
            be.follow(on_update=lambda b: tables.append(
                [t.clone() for t in b._args]))
            out[kind] = {"tables": tables, "updates": be.updates}
            continue
        cell = ServingCell(be.lead(), max_wait_ms=5.0)
        got = {}
        try:
            for step in UPDATE_STEPS:
                target, kw = _update_step(x, inp, kind, step)
                st = cell.apply_updates(target, **kw)
                got[step] = {"stats": st, "answers": be(inp["q"]),
                             "filtered": (None if kind == "brute" else be(
                                 inp["q"], filter_spec=FilterSpec.range(
                                     "pct", *WIDE))),
                             "served": cell.search(inp["q"][0], timeout=120),
                             "tables": [t.clone() for t in be._args],
                             "fanout": be.last_fanout}
        finally:
            cell.close()
        out[kind] = got
    return out


def _failed_update(inp, mesh, rank: int) -> dict:
    """Rank 2 fails its part of a delta: every rank raises, and the root's
    backend refuses to serve after it."""
    from repro_torch.serve.cell import ServingCell

    x, be = _update_backend(inp, "ivf", mesh=mesh, axes=("data",))
    if rank != 0:
        if rank == 2:
            def broken(part):
                raise MemoryError("injected")
            be._scatter = broken
        try:
            be.follow()
            return {"raised": None}
        except RuntimeError as e:
            return {"raised": str(e), "cause": repr(e.__cause__)}
    cell = ServingCell(be.lead(), max_wait_ms=5.0)
    try:
        target, kw = _update_step(x, inp, "ivf", "add")
        try:
            cell.apply_updates(target, **kw)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        try:
            cell.search(inp["q"][0], timeout=60)
            served = True
        except RuntimeError as e:
            served = repr(e.__cause__)
    finally:
        cell.close()
    return {"raised": raised, "served_after": served}


def _psum_inputs(rank: int) -> dict:
    """Each rank's operands of the compressed mean (numpy-seeded by rank):
    a matrix, a vector with one outlier, an all-zero tensor."""
    rng = np.random.default_rng((7, rank))
    vec = rng.standard_normal(9).astype(np.float32)
    vec[rank] = 40.0
    return {"mat": rng.standard_normal((6, 5)).astype(np.float32),
            "vec": vec, "zero": np.zeros((3,), np.float32)}


def _compressed_psum(rank: int) -> dict:
    """``train.compression.compressed_psum`` over the world (gloo): the
    int8 all-gather and the local mean of every operand."""
    from repro_torch.train.compression import compressed_psum

    return {k: compressed_psum(torch.from_numpy(x)).numpy()
            for k, x in _psum_inputs(rank).items()}


def _heartbeat(inp, rank: int, world: int, workdir: str) -> dict:
    """A new group with a GROUP_TIMEOUT_S timeout: a cell whose root sits
    idle IDLE_S, then answers a call with every rank; then a root that
    sends nothing for SILENT_S (no heartbeat: a dead root) fails its
    followers after the timeout."""
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed.backend import ShardedSearchBackend
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve.cell import ServingCell

    store = dist.FileStore(os.path.join(workdir, "store_beat"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = make_test_mesh((world,), ("data",), device_type="cpu")
        kw = dict(kind="brute", k=K, mesh=mesh, axes=("data",),
                  device="cpu")
        be = ShardedSearchBackend(inp["db"], **kw)
        out = {}
        if rank == 0:
            cell = ServingCell(be.lead(), max_wait_ms=5.0)
            try:
                time.sleep(IDLE_S)
                out["after_idle"] = cell.search(inp["q"][3], timeout=60)
            finally:
                cell.close()                # joins the heartbeat thread
            out["beats"] = be.beats
            out["beat_s"] = be._beat_s
        else:
            out["served"] = be.follow()
            out["beats"] = be.beats
        silent = ShardedSearchBackend(inp["db"], **kw)
        if rank == 0:
            time.sleep(SILENT_S)            # never leads: sends nothing
        else:
            t0 = time.perf_counter()
            try:
                silent.follow()
                out["silent"] = None
            except RuntimeError as e:
                out["silent"] = (str(e)[:300], time.perf_counter() - t0)
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_inputs(ref_run):
    """The port's inputs of every case, the lifecycle and the cell."""
    from repro_torch.core.lexical import build_lexical_slabs
    from repro_torch.core.metadata import MetadataTable

    data = _data()
    ivf, tree = ref_run["index"]["brute"], ref_run["index"]["tree"]
    new, gone = delta_inputs(ivf.centroids, ivf.bucket_ids,
                             ivf.bucket_counts)
    qt, qw = _lex_queries()
    return {"db": data.db, "q": data.q, "ivf": ivf, "tree": tree,
            "meta": MetadataTable({"pct": data.pct}),
            "slabs": build_lexical_slabs(data.docs, V, slots=8),
            "qt": qt, "qw": qw, "new": new, "gone": gone,
            "requests": (data.db[:64] + 0.01).astype(np.float32)}


@pytest.mark.parametrize("mesh", list(REF_MESHES))
@pytest.mark.parametrize("case", CASES)
def test_shard_loop_options_match_reference(ref_run, port_inputs, mesh,
                                            case):
    """Every filtered, int8, lexical and hybrid case: the shard loop on
    the shard and query grid of ``mesh`` against the reference's backend
    on that mesh of fake devices (the filter slices, the row offsets of
    every flat local, the query blocks)."""
    shape, names, axes, qaxes = REF_MESHES[mesh]
    dims = dict(zip(names, shape))
    n_dev, n_q = (int(np.prod([dims[a] for a in ax])) for ax in (axes,
                                                                  qaxes))
    inp = port_inputs
    target, kw, call = _case(case, inp)
    bes = shard_backends(target, n_dev, k=K, device="cpu", **kw)
    mine = shard_loop(bes, inp["q"], n_q=n_q, **call)
    assert mine[1].shape == (B, K) and (mine[1][:, 0] >= 0).all()
    _same(mine, ref_run[(mesh, case)], inp["q"], inp["db"],
          alpha=ALPHA.get(case, 1.0))


@pytest.fixture(scope="module")
def ranks(port_inputs, tmp_path_factory):
    """Spawn the 4 gloo ranks once; their pickled results by rank."""
    workdir = str(tmp_path_factory.mktemp("ranks"))
    inp = port_inputs
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    code = textwrap.dedent(f"""
        import sys
        from test_torch_sharded_slice import _rank_main
        _rank_main(int(sys.argv[1]), {WORLD}, {workdir!r})
    """)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=_env(), cwd=REPO)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=RANK_LIMIT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()

    def tail(r):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            return f.read()[-3000:]

    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} exit {procs[r].returncode}:\n"
                              + tail(r) for r in bad)
    out = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_ranks_sit_in_lin_order(ranks):
    """Each rank's shard index: row-major over ``axes`` as given (the
    reversed mesh puts "model" first), the query block over
    ``query_axes``."""
    got = {m: [r["lin"][m] for r in ranks] for m in MESHES}
    assert [s.lin for s in got["flat4"]] == [0, 1, 2, 3]
    assert [(s.lin, s.qlin, s.n_dev, s.n_q) for s in got["query22"]] == [
        (0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2), (1, 1, 2, 2)]
    assert [s.lin for s in got["reversed22"]] == [0, 2, 1, 3]
    # ranks [[3, 1], [2, 0]]: rank r sits at the coordinate of r
    assert [s.lin for s in got["permuted22"]] == [3, 1, 2, 0]
    assert all(r["plan"] == (("data",), ("model",)) for r in ranks)


def test_cell_meshes_carve_consecutive_blocks(ranks):
    for rank, r in enumerate(ranks):
        c = r["cells"]
        assert [m[0] for m in c["disjoint"]] == [[0, 1], [2, 3]]
        assert all(m[1] == ("data",) for m in c["disjoint"])
        assert [m[0] for m in c["two_d"]] == [[[0, 1]], [[2, 3]]]
        assert all(m[1] == ("data", "model") for m in c["two_d"])
        for kind in ("disjoint", "two_d"):
            mine = [m for m in c[kind] if m[2] is not None]
            assert len(mine) == 1 and mine[0][2][-1] == rank % 2
            assert mine[0][3] == np.ravel(mine[0][0]).tolist()
        assert [m[0] for m in c["shared"]] == [[0, 1], [2, 3], [0, 1]]
        if rank < 2:
            assert c["shared_distinct"]
        assert "may not repeat" in c["repeat"]


def test_mesh_helpers_refuse_what_the_world_cannot_hold():
    """Without a process group the world is this one process."""
    from repro_torch.launch import mesh as lm

    with pytest.raises(RuntimeError, match="need 256 devices, found 1"):
        lm.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices, found 1"):
        lm.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        lm.make_test_mesh((2, 4))
    with pytest.raises(ValueError, match="positive"):
        lm.make_cell_meshes(0)
    with pytest.raises(RuntimeError, match="share_devices=True"):
        lm.make_cell_meshes(2)
    with pytest.raises(RuntimeError, match="share_devices=True"):
        lm.make_cell_meshes(2, shape=(1,))
    assert lm.make_plan(_Mesh((2, 2), ("data", "model"))).dp == ("data",)
    plan = lm.make_plan(_Mesh((2, 2, 2), ("pod", "data", "model")))
    assert plan.dp == ("pod", "data") and plan.size_of("dp") == 4


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathers_come_in_lin_order(ranks, mesh):
    """The corpus gather lands shard ``lin`` at row ``lin`` and the query
    gather block ``qlin`` at block ``qlin``, whatever the order of the
    axes and of the groups' members; the broadcast carries the root's."""
    order = MESHES[mesh][0]
    root = 0 if order is None else order[0]
    for r in ranks:
        c = r[(mesh, "collective")]
        S = r["lin"][mesh].n_dev
        n_q = r["lin"][mesh].n_q
        assert c["shape"] == (S, 3, 2)
        assert c["corpus"] == (list(map(float, range(S))),
                               [10 * s for s in range(S)])
        blocks = [j for j in range(n_q) for _ in range(2)]
        assert c["queries"] == (list(map(float, blocks)), blocks)
        assert c["object"] == {"rank": root}
        assert c["tensor"] == [float(root)] * 4
    assert [r[(mesh, "collective")]["root"] for r in ranks].count(True) == 1


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_ranks_equal_the_shard_loop(ranks, mesh, case):
    loop = ranks[0][("loop", mesh, case)]
    assert loop[1].shape == (B, K) and (loop[1][:, 0] >= 0).all()
    for r in ranks:
        _bits(r[(mesh, case)], loop)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", FLAT)
def test_flat_ranks_equal_the_one_shard_backend(ranks, mesh, case):
    """A row's score does not depend on the split, and ties break on the
    global id: every flat case equals the backend built without a mesh."""
    for r in ranks:
        _bits(r[(mesh, case)], ranks[0][("one", case)])


def test_a_request_that_fails_on_the_root_fails_alone(ranks):
    """The root compiles a call before its followers hear of it: a filter
    on an unknown column raises on the root, and the followers join only
    the next call."""
    got = ranks[0]["bad_request"]["got"]
    want = ranks[0][("one", "brute_wide")]
    _bits(got, want)
    assert [r["bad_request"]["served"] for r in ranks[1:]] == [1, 1, 1]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_host_entries_match_the_exact_scan(ranks, mesh):
    for r in ranks:
        exact = r["exact"]
        d, i = r[(mesh, "host_brute")]
        assert np.array_equal(i, exact[1])
        np.testing.assert_allclose(d, exact[0], rtol=RTOL, atol=ATOL)
        # at full probe both bucketed kinds scan every bucket
        for name, want in (("host_ivf", exact),
                           ("host_forest", r["one_shard_forest"])):
            d, i = r[(mesh, name)]
            for b in range(B):
                assert set(i[b].tolist()) == set(np.asarray(
                    want[1][b]).tolist())
            np.testing.assert_allclose(np.sort(d, 1),
                                       np.sort(np.asarray(want[0]), 1),
                                       rtol=1e-4, atol=1e-4)
        _bits(r[(mesh, "host_brute")], ranks[0][(mesh, "host_brute")])


@pytest.mark.parametrize("kind", ["ivf", "forest", "brute"])
@pytest.mark.parametrize("step", ["add", "delete"])
def test_delta_apply_across_ranks_equals_a_full_replace(ranks, ref_run,
                                                        kind, step):
    want = ref_run[("stats", kind, step)]
    for r in ranks:
        got = r["lifecycle"][(kind, step)]
        assert got["stats"] == want
        assert got["stats"]["mode"] == "delta"
        assert got["in_place"] and got["tables"]
        _bits(*got["answers"])
        assert not got["deleted_served"]
        _bits(got["answers"][0], ranks[0]["lifecycle"][(kind,
                                                        step)]["answers"][0])


def test_cell_with_followers_answers_as_direct_calls(ranks):
    lead = ranks[0]["cell"]
    assert all(r["cell"].get("followed") for r in ranks[1:])
    d, i = lead["served"]
    assert np.array_equal(i, lead["direct"][1])
    np.testing.assert_allclose(d, lead["direct"][0], rtol=RTOL, atol=ATOL)
    # served after the failed request
    assert np.array_equal(lead["after"][1], i[1])
    np.testing.assert_allclose(lead["after"][0], d[1], rtol=RTOL, atol=ATOL)
    assert lead["dispatches"] >= 4 and not lead["leads_after_close"]
    for r in ranks[1:]:
        _bits(r["cell"]["direct"], lead["direct"])
    # the cell that leads took a full re-place (no manifest) on every rank
    assert lead["replaced"]["mode"] == "full"
    assert lead["replaced"]["reason"] == "no-manifest"
    assert np.array_equal(lead["after_update"][1], i[2])
    np.testing.assert_allclose(lead["after_update"][0], d[2], rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def update_loop(port_inputs):
    """The single-process shard loop through the same steps as the cells
    over the mesh: stats, every shard's tables, answers, and the bytes of
    each shard's part of the update."""
    from repro_torch.core.metadata import FilterSpec
    from repro_torch.distributed.backend import _nbytes
    from repro_torch.distributed.sharding import ShardSlot

    inp = port_inputs
    out = {}
    for kind in UPDATE_KINDS:
        src, bkind = UPDATE_KINDS[kind]
        x = copy.deepcopy(inp[src])
        bes = [_update_backend(inp, kind, shard=ShardSlot(n_dev=WORLD,
                                                          lin=lin))[1]
               for lin in range(WORLD)]
        for step in UPDATE_STEPS:
            target, kw = _update_step(x, inp, kind, step)
            be0 = bes[0]
            if kw["delta"] is not None:
                pay, reason = be0._delta_payload(target, kw.get("alive"),
                                                 kw["delta"])
                assert reason is None
                parts = [_nbytes(be0._cut(pay, lin)) for lin in range(WORLD)]
            else:
                parts = []
                for lin in range(WORLD):
                    t = be0._tables(target, kw.get("alive"), lin,
                                    torch.device("cpu"))
                    parts.append(sum(int(a.nbytes) for a in t["args"]))
            stats = [be.apply_updates(target, **kw) for be in bes]
            assert all(st == stats[0] for st in stats)
            out[(kind, step)] = {
                "stats": stats[0], "parts": parts,
                "tables": [[t.clone() for t in be._args] for be in bes],
                "answers": shard_loop(bes, inp["q"]),
                "filtered": (None if kind == "brute" else shard_loop(
                    bes, inp["q"], filter_spec=FilterSpec.range(
                        "pct", *WIDE)))}
    return out


@pytest.mark.parametrize("kind", list(UPDATE_KINDS))
@pytest.mark.parametrize("step", UPDATE_STEPS)
def test_cell_updates_reach_every_rank(ranks, update_loop, ref_run, kind,
                                       step):
    """``ServingCell.apply_updates`` on the root of a (4,) mesh: every
    rank's tables equal the shard loop's after the same update, bit for
    bit, and so do the answers, filtered ones too; a delta's stats are the
    reference's mesh backend's; each follower received its own part of
    the update, no more."""
    want = update_loop[(kind, step)]
    lead = ranks[0]["cell_updates"][kind][step]
    assert lead["stats"] == want["stats"]
    if step == "full":
        assert lead["stats"]["mode"] == "full"
    else:
        assert lead["stats"] == ref_run[("stats", kind, step)]
        assert lead["stats"]["mode"] == "delta"
    _bits(lead["answers"], want["answers"])
    if kind != "brute":
        # filters compile on every rank from the mirrors and metadata rows
        # the update's header carried
        _bits(lead["filtered"], want["filtered"])
    assert np.array_equal(lead["served"][1], want["answers"][1][0])
    j = UPDATE_STEPS.index(step)
    tables = [lead["tables"]] + [r["cell_updates"][kind]["tables"][j]
                                 for r in ranks[1:]]
    for lin, got in enumerate(tables):
        assert len(got) == len(want["tables"][lin])
        assert all(torch.equal(a, b) for a, b in zip(got, want["tables"][lin]))
    sent = lead["fanout"]["bytes_to_rank"]
    assert lead["fanout"]["mode"] == lead["stats"]["mode"]
    for r in range(1, WORLD):
        took = ranks[r]["cell_updates"][kind]["updates"][j]
        assert took["mode"] == lead["stats"]["mode"]
        assert took["part_bytes"] == sent[r] == want["parts"][r]
    if step != "full":
        assert sum(want["parts"]) <= lead["stats"]["bytes"]


def test_a_failed_follower_update_fails_every_rank(ranks):
    """Rank 2 fails its part: the root's apply raises, every follower's
    ``follow`` raises, and the root's backend refuses to serve after."""
    lead = ranks[0]["failed_update"]
    assert "an update failed on 1 rank(s)" in lead["raised"]
    assert "no longer serves" in lead["served_after"]
    for r in ranks[1:]:
        assert "an update failed on 1 rank(s)" in r["failed_update"]["raised"]
    assert "injected" in ranks[2]["failed_update"]["cause"]


def test_an_idle_root_keeps_its_followers(ranks):
    """Group timeout 6 s, the root idle 15 s: heartbeats keep the
    followers waiting, and the next call is answered by every rank."""
    lead = ranks[0]["heartbeat"]
    want = ranks[0][("one", "brute")]
    assert np.array_equal(lead["after_idle"][1], want[1][3])
    np.testing.assert_allclose(lead["after_idle"][0], want[0][3], rtol=RTOL,
                               atol=ATOL)
    assert lead["beat_s"] == 0.25 * GROUP_TIMEOUT_S
    assert lead["beats"] >= IDLE_S / lead["beat_s"] - 2
    for r in ranks[1:]:
        assert r["heartbeat"]["served"] == 1
        assert r["heartbeat"]["beats"] == lead["beats"]


def test_a_silent_root_fails_its_followers(ranks):
    """A root that sends nothing past the group's timeout (no heartbeat,
    as a dead root) fails every follower's wait, after the timeout."""
    for r in ranks[1:]:
        msg, waited = r["heartbeat"]["silent"]
        assert GROUP_TIMEOUT_S - 1 <= waited < SILENT_S + GROUP_TIMEOUT_S


def test_compressed_psum_equals_the_reference(ranks, reference):
    """Every rank's compressed mean equals the reference's
    ``compressed_psum`` run over a named axis of the four ranks' operands
    (``jax.vmap`` with ``axis_name``: its ``all_gather`` sees the four
    rows as the axis); the same on every rank."""
    jax = pytest.importorskip("jax")
    rc = reference.compression
    for k in _psum_inputs(0):
        xs = np.stack([_psum_inputs(r)[k] for r in range(WORLD)])
        want = np.asarray(jax.vmap(lambda x: rc.compressed_psum(x, "i"),
                                   axis_name="i")(jax.numpy.asarray(xs)))
        for rank, r in enumerate(ranks):
            got = r["compressed_psum"][k]
            assert got.dtype == np.float32 and got.shape == xs.shape[1:]
            np.testing.assert_allclose(got, want[rank], rtol=1e-6,
                                       atol=1e-7, err_msg=(k, rank))
            assert np.array_equal(got, ranks[0]["compressed_psum"][k])
        # 4x fewer bytes on the wire, and within half an int8 step of
        # the exact mean
        step = np.abs(xs).max(axis=tuple(range(1, xs.ndim))) / 127.0
        assert (np.abs(want[0] - xs.mean(0)) <= step.max() / 2 + 1e-7).all()
