"""The GNN serving path on the CPU, held against the reference.

The port's ``data.graph`` (``CSRGraph``, ``make_graph``,
``NeighborSampler``, ``pad_edges``, ``molecule_batch``),
``core.graph_build.radius_graph`` and ``models.schnet`` against the
reference's on the same seeds, the reference's weights carried across with
``convert.schnet_params_from_arrays``:

* graphs, edge lists, samples (two successive calls: the sampler's rng
  stream), padded subgraphs and molecule batches equal bit for bit;
* ``radius_graph`` brute equal, capped and not; two-level on the
  reference test's points (500 x 3, cutoff 1.5, 16 buckets, nprobe 8)
  equal to the reference's edges (the k-means and the bucket probe run in
  torch on the CPU; their host rng draws are the reference's, and on these
  points no assignment is near a tie), and at the reference test's bar,
  edge recall >= 0.95 against brute;
* SchNet ``forward`` / ``loss_fn`` (and its aux) on the three batch kinds
  (a full graph with labels, a sampled padded subgraph with ``node_mask``,
  a molecule batch with the energy head): fp32 messages to rtol / atol
  1e-5 (``TOL32``); bf16 messages within a relative L2 error of 2**-4
  (``BF16_REL_L2``, the bound of the LM slice: about eight bf16 ulps on
  the whole tensor) and each element within rtol 2**-3 / atol 2**-2
  (``TOL_BF16``), loss to rtol 1e-2.  That bound holds bf16 noise, not the
  dtype: on these batches the port's node states sit 1.8e-3 to 6.9e-3
  (relative L2) from the reference's at bf16 messages, and the port's at
  fp32 messages sit 2.6e-3 to 6.0e-3 from the same reference, so no
  bound between the two readings exists.  The message dtype is pinned
  instead (``testing.message_dtypes``: every interaction's sum taken in
  bf16).  The node state returns to fp32 after the first interaction in
  both packages;
* ``param_specs`` / ``param_shapes`` at full width; a misshapen leaf
  raises ``ValueError``; the two-level build and ``init`` need a card
  unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_recsys_slice import _paths, _spec, np_weights
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.configs import registry as preg
from repro_torch.convert import schnet_params_from_arrays
from repro_torch.core.graph_build import radius_graph
from repro_torch.data import graph as pg
from repro_torch.distributed.sharding import SINGLE_POD_PLAN
from repro_torch.models import base as pbase
from repro_torch.models import schnet as PS
from repro_torch.testing import message_dtypes

TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2 ** -3, atol=2 ** -2)
BF16_REL_L2 = 2 ** -4
GRAPH_KW = [dict(n_nodes=200, n_edges=900, d_feat=12, n_classes=4, seed=0),
            dict(n_nodes=500, n_edges=3000, d_feat=8, seed=1),
            dict(n_nodes=97, n_edges=1013, d_feat=5, n_classes=7, seed=5)]


def _eq_dicts(mine: dict, theirs: dict):
    assert mine.keys() == theirs.keys()
    for k in theirs:
        a, b = np.asarray(mine[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype, k
        assert np.array_equal(a, b), k


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", GRAPH_KW, ids=lambda kw: str(kw["n_nodes"]))
def test_make_graph_and_edge_list_bit_for_bit(reference, kw):
    kw = dict(kw)
    n, e, f = kw.pop("n_nodes"), kw.pop("n_edges"), kw.pop("d_feat")
    mine, theirs = pg.make_graph(n, e, f, **kw), \
        reference.graph.make_graph(n, e, f, **kw)
    _eq_dicts(dataclasses.asdict(mine), dataclasses.asdict(theirs))
    assert (mine.n_nodes, mine.n_edges) == (theirs.n_nodes, theirs.n_edges)
    for a, b in zip(mine.edge_list(), theirs.edge_list()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fanout,n_seeds", [((4, 3), 16), ((5, 3), 32),
                                            ((15, 10), 8)])
def test_neighbor_sampler_and_pad_edges_bit_for_bit(reference, fanout,
                                                    n_seeds):
    g_mine = pg.make_graph(500, 3000, 8, seed=1)
    g_ref = reference.graph.make_graph(500, 3000, 8, seed=1)
    s_mine = pg.NeighborSampler(g_mine, fanout, seed=3)
    s_ref = reference.graph.NeighborSampler(g_ref, fanout, seed=3)
    for call in range(2):                       # the rng stream carries on
        seeds = np.arange(call * n_seeds, (call + 1) * n_seeds)
        a, b = s_mine.sample(seeds), s_ref.sample(seeds)
        _eq_dicts(a, b)
        n_nodes = a["feats"].shape[0] + 7
        n_edges = a["senders"].shape[0] + 11
        _eq_dicts(pg.pad_edges(a, n_nodes, n_edges),
                  reference.graph.pad_edges(b, n_nodes, n_edges))
    with pytest.raises(ValueError, match="exceeds pad"):
        pg.pad_edges(a, 1, 1)


@pytest.mark.parametrize("args", [(3, 8, 24, 12, 0), (4, 30, 64, 16, 2),
                                  (2, 12, 8, 3, 1)])
def test_molecule_batch_bit_for_bit(reference, args):
    *shape, step = args
    _eq_dicts(pg.molecule_batch(*shape, step=step, seed=1),
              reference.graph.molecule_batch(*shape, step=step, seed=1))


# ---------------------------------------------------------------------------
# radius graph
# ---------------------------------------------------------------------------


def _points():
    rng = np.random.default_rng(9)
    return rng.normal(size=(500, 3)).astype(np.float32) * 3


@pytest.mark.parametrize("max_neighbors", [None, 5])
def test_radius_graph_brute_bit_for_bit(reference, max_neighbors):
    pos = _points()
    a = radius_graph(pos, 1.5, method="brute", max_neighbors=max_neighbors)
    b = reference.graph_build.radius_graph(pos, 1.5, method="brute",
                                           max_neighbors=max_neighbors)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
    # auto takes the brute branch at or below 4,096 points, on no device
    assert all(np.array_equal(x, y) for x, y in zip(
        radius_graph(pos, 1.5, max_neighbors=max_neighbors), a))


@pytest.mark.parametrize("max_neighbors", [None, 5])
def test_radius_graph_two_level_equals_reference(reference, max_neighbors):
    pos = _points()
    kw = dict(n_buckets=16, nprobe=8, max_neighbors=max_neighbors)
    a = radius_graph(pos, 1.5, method="two_level", device="cpu", **kw)
    b = reference.graph_build.radius_graph(pos, 1.5, method="two_level",
                                           **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    s1, d1 = radius_graph(pos, 1.5, method="brute",
                          max_neighbors=max_neighbors)
    e1 = set(zip(s1.tolist(), d1.tolist()))
    e2 = set(zip(a[0].tolist(), a[1].tolist()))
    assert len(e2 & e1) / max(len(e1), 1) > 0.95   # the reference's bar
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            radius_graph(pos, 1.5, method="two_level", **kw)


# ---------------------------------------------------------------------------
# SchNet
# ---------------------------------------------------------------------------


def _cfgs(reference, message_dtype="float32"):
    kw = dict(d_feat=12, n_out=4, message_dtype=message_dtype)
    rcfg = dataclasses.replace(
        reference.registry.get_arch("schnet")[0].reduced(), **kw)
    pcfg = dataclasses.replace(preg.get_arch("schnet")[0].reduced(), **kw)
    return rcfg, pcfg


def _batches():
    g = pg.make_graph(200, 900, 12, n_classes=4, seed=0)
    snd, rcv = g.edge_list()
    full = {"feats": g.feats, "pos": g.pos, "senders": snd,
            "receivers": rcv, "labels": g.labels}
    sub = pg.pad_edges(pg.NeighborSampler(g, (4, 3), seed=0).sample(
        np.arange(16)), 400, 1200)
    sampled = {k: sub[k] for k in ("feats", "pos", "senders", "receivers",
                                   "labels", "node_mask")}
    return {"full": full, "sampled": sampled,
            "molecule": pg.molecule_batch(3, 8, 24, 12, step=0)}


_RUNS: dict = {}


def _run(reference, message_dtype):
    if message_dtype in _RUNS:
        return _RUNS[message_dtype]
    jnp = pytest.importorskip("jax.numpy")
    S = reference.schnet
    rcfg, pcfg = _cfgs(reference, message_dtype)
    arrays = np_weights(S.param_shapes(rcfg, reference.sharding.ShardPlan()),
                        0)
    rp = pbase.tree_map(jnp.asarray, arrays)
    pp = schnet_params_from_arrays(arrays, pcfg, device="cpu")
    out = {}
    for kind, batch in _batches().items():
        with message_dtypes() as sums:
            port = (PS.forward(pp, batch, pcfg), PS.loss_fn(pp, batch, pcfg))
        out[kind] = {"ref": (S.forward(rp, batch, rcfg),
                             S.loss_fn(rp, batch, rcfg)),
                     "port": port, "sums": sums}
    _RUNS[message_dtype] = out
    return out


def _close(port, ref, tol):
    a = port.detach().float().numpy()
    b = np.asarray(ref, dtype=np.float32)
    if tol is TOL_BF16:
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= BF16_REL_L2, f"relative L2 error {err}"
    np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("kind", ["full", "sampled", "molecule"])
@pytest.mark.parametrize("message_dtype", ["float32", "bfloat16"])
def test_schnet_forward_and_loss_equal_reference(reference, message_dtype,
                                                 kind):
    out = _run(reference, message_dtype)[kind]
    (rh, (rl, raux)), (ph, (pl, paux)) = out["ref"], out["port"]
    # the first residual add (h + upd + b2, b2 fp32) promotes h to fp32
    assert ph.dtype == torch.float32 and str(rh.dtype) == "float32"
    assert tuple(ph.shape) == tuple(rh.shape)
    tol = TOL32 if message_dtype == "float32" else TOL_BF16
    _close(ph, rh, tol)
    ltol = TOL32 if message_dtype == "float32" else dict(rtol=1e-2,
                                                         atol=1e-2)
    _close(pl, rl, ltol)
    assert set(paux) == set(raux)
    for k in raux:
        _close(paux[k], raux[k], ltol)
    assert ("accuracy" in paux) == (kind != "molecule")
    # the relative L2 bound cannot tell bf16 messages from fp32 ones (fp32
    # messages land as close to the bf16 reference), so the dtype is
    # pinned: every interaction sums its messages in message_dtype, in
    # forward and again in loss_fn; the energy head pools in fp32
    n = _cfgs(reference)[1].n_interactions
    mdt = getattr(torch, message_dtype)
    pool = [torch.float32] if kind == "molecule" else []
    assert out["sums"] == [mdt] * n + [mdt] * n + pool


def test_schnet_heads_and_rbf_equal_reference(reference):
    """``_rbf`` at full width (300 centers on [0, 10]): the packages'
    ``linspace`` centers may differ in the last bit (the two compute them
    by other formulas), so the centers are held to one ulp of the cutoff,
    and the basis to fp32 tolerance plus what that moves it by, at most
    sqrt(2 gamma / e) * ulp(cutoff) (the largest slope of
    exp(-gamma x**2)); then both heads to ``TOL32``."""
    jnp = pytest.importorskip("jax.numpy")
    S = reference.schnet
    rcfg, pcfg = _cfgs(reference)
    full = reference.registry.get_arch("schnet")[0]
    pfull = preg.get_arch("schnet")[0]
    ref_c = np.asarray(jnp.linspace(0.0, full.cutoff, full.n_rbf))
    mine_c = torch.linspace(0.0, pfull.cutoff, pfull.n_rbf).numpy()
    ulp = np.spacing(np.float32(full.cutoff))
    assert np.abs(mine_c - ref_c).max() <= ulp
    gamma = 1.0 / float(ref_c[1] - ref_c[0]) ** 2
    slope_ulp = np.sqrt(2 * gamma / np.e) * ulp
    dist = np.linspace(0.0, 12.0, 97).astype(np.float32)
    _close(PS._rbf(torch.as_tensor(dist), pfull),
           S._rbf(jnp.asarray(dist), full),
           dict(rtol=1e-5, atol=1e-5 + slope_ulp))
    arrays = np_weights(S.param_shapes(rcfg, reference.sharding.ShardPlan()),
                        6)
    rp = pbase.tree_map(jnp.asarray, arrays)
    pp = schnet_params_from_arrays(arrays, pcfg, device="cpu")
    h = np.random.default_rng(6).standard_normal(
        (24, pcfg.d_hidden)).astype(np.float32)
    _close(PS.node_logits(pp, torch.as_tensor(h)),
           S.node_logits(rp, jnp.asarray(h)), TOL32)
    gid = np.repeat(np.arange(4, dtype=np.int32), 6)
    gid[-2:] = -1                       # padded atoms count into graph 0
    _close(PS.graph_energy(pp, torch.as_tensor(h), gid, 4),
           S.graph_energy(rp, jnp.asarray(h), jnp.asarray(gid), 4), TOL32)


def test_schnet_specs_shapes_and_params_from_arrays(reference):
    jnp = pytest.importorskip("jax.numpy")
    S = reference.schnet
    rcfg = reference.registry.get_arch("schnet")[0]
    pcfg = preg.get_arch("schnet")[0]
    mine = _paths(PS.param_specs(pcfg, SINGLE_POD_PLAN))
    theirs = _paths(S.param_specs(rcfg, reference.sharding.SINGLE_POD_PLAN))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert _spec(mine[k]) == _spec(theirs[k]), k
    mine = _paths(PS.param_shapes(pcfg))
    shapes = S.param_shapes(rcfg, reference.sharding.ShardPlan())
    theirs = _paths(shapes)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].device.type == "meta"
        assert tuple(mine[k].shape) == tuple(theirs[k].shape), k
        assert str(mine[k].dtype).split(".")[-1] == \
            jnp.dtype(theirs[k].dtype).name, k
    arrays = np_weights(shapes, 1)
    tree = schnet_params_from_arrays(arrays, pcfg, device="cpu")
    for k, v in _paths(arrays).items():
        assert np.array_equal(_paths(tree)[k].numpy(), v), k
    bad = dict(arrays, inter=dict(arrays["inter"],
                                  w1=arrays["inter"]["w1"][:, :-1]))
    with pytest.raises(ValueError, match="/inter/w1"):
        schnet_params_from_arrays(bad, pcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        schnet_params_from_arrays(dict(arrays, extra=arrays["head_b1"]),
                                  pcfg, device="cpu")
    p = PS.init(pcfg, seed=0, device="cpu")
    assert pbase.count_params(p) == pbase.count_params(PS.param_shapes(pcfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PS.init(pcfg)


def test_schnet_padded_edges_never_reach_node_zero():
    """A batch and the same batch with extra padded edges (-1) give the
    same node states: pads are masked before the scatter into node 0."""
    cfg = dataclasses.replace(preg.get_arch("schnet")[0].reduced(),
                              d_feat=5, n_out=3)
    p = PS.init(cfg, seed=2, device="cpu")
    mb = pg.molecule_batch(2, 6, 10, 5, step=0)
    padded = dict(mb, senders=np.pad(mb["senders"], (0, 9),
                                     constant_values=-1),
                  receivers=np.pad(mb["receivers"], (0, 9),
                                   constant_values=-1))
    assert torch.equal(PS.forward(p, mb, cfg), PS.forward(p, padded, cfg))
