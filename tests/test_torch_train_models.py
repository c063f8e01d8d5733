"""The backward of the port's models on the CPU, held against ``jax.grad``.

``repro_torch.train.loop.value_and_grad`` over the port's ``loss_fn``s
against the reference's ``jax.value_and_grad`` on the same numpy-seeded
weights (carried across with ``convert``) and the same batches, at the
fp32 compute policy:

* the five LM archs at ``reduced()`` (MoE capacity factor 8 so no token
  drops, deepseek's MTP, remat on as ``reduced()`` keeps it), the four
  recsys archs on ``batch_for`` batches of 16 rows and SchNet on a node
  batch and an energy (molecule) batch: every leaf's gradient and the
  loss to rtol 1e-4 / atol 1e-4 of the leaf's max abs (``GRAD_TOL``,
  with a floor of 1e-9 for a gradient that is zero by symmetry;
  the fp32 gradient of these small models is itself only good to about
  1e-5 of a leaf's max, measured against float64 in
  ``tests/test_torch_train_slice.py``);
* the chunked attention's gradient (a ``reduced()`` LM with
  ``attn_chunk=8`` at seq 32, each block step under ``checkpoint``)
  against the reference's chunked path; ``reduced()`` alone never reaches
  it;
* remat on against remat off: equal on the CPU, bit for bit;
* the in-place ``index_add_`` paths (the MoE combine, SchNet's message
  sum) under ``torch.autograd.gradcheck`` in float64;
* the CTR sparse step (``make_ctr_sparse_train_step``) for DLRM and
  DCN-v2 at ``reduced()``, ids with duplicates, 3 steps: table, AdaGrad
  accumulator and dense params to rtol 1e-5 / atol 1e-5 of the leaf's
  max;
* ``launch/train.main`` for one arch of each family on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_lm_slice import _ref_weights
from test_torch_recsys_slice import np_weights
from test_torch_reference import reference  # noqa: F401  (fixture)
from test_torch_train_slice import _close_tree, _np

from repro_torch.configs import registry as preg
from repro_torch.convert import (lm_params_from_arrays,
                                 recsys_params_from_arrays,
                                 schnet_params_from_arrays)
from repro_torch.data import graph as pg
from repro_torch.data.lm import LMStream
from repro_torch.data.recsys import batch_for
from repro_torch.distributed.sharding import LOCAL_PLAN
from repro_torch.models import attention as pattn
from repro_torch.models import moe as pmoe
from repro_torch.models import recsys as PR
from repro_torch.models import schnet as PS
from repro_torch.models import transformer as PT
from repro_torch.train import optim
from repro_torch.train.loop import value_and_grad
from repro_torch.train.sparse_embed import make_ctr_sparse_train_step
from repro_torch.train.tree import leaves

LM_ARCHS = ["qwen3-0.6b", "qwen3-14b", "granite-34b", "deepseek-v3-671b",
            "kimi-k2-1t-a32b"]
RECSYS_ARCHS = ["dlrm-mlperf", "dcn-v2", "din", "sasrec"]
# gradients: rtol 1e-4 and an atol of 1e-4 of the leaf's max abs, and
# never below 1e-9 (DIN's attention-MLP output bias has a gradient of
# exactly zero, softmax being shift invariant: both packages return
# rounding noise of about 1e-10 there)
GRAD_TOL = dict(rtol=1e-4, atol_of_max=1e-4, atol_floor=1e-9)
# three sparse steps: rtol 1e-5 and 1e-5 of the leaf's max abs (the
# batch's sums add in another order than XLA's)
SPARSE_TOL = dict(rtol=1e-5, atol_of_max=1e-5)


def _ref_grad(jax, loss_fn, arrays, batch):
    """``((loss, aux), grads)`` of the reference, as numpy."""
    f = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, batch),
                                   has_aux=True))
    (loss, aux), g = f(jax.tree.map(jax.numpy.asarray, arrays))
    return (np.asarray(loss), jax.tree.map(np.asarray, aux)), \
        jax.tree.map(np.asarray, g)


def _check(port_out, ref_out):
    (pl, paux), pg_ = port_out
    (rl, raux), rg = ref_out
    np.testing.assert_allclose(_np(pl), rl, rtol=1e-5, atol=1e-6)
    assert set(paux) == set(raux)
    for k in raux:
        np.testing.assert_allclose(_np(paux[k]), raux[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _close_tree(pg_, rg, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------


def _lm_cfgs(reference, arch, **kw):
    rcfg = reference.registry.get_arch(arch)[0].reduced()
    pcfg = preg.get_arch(arch)[0].reduced()
    kw = dict(residual_dtype="float32", **kw)
    rcfg, pcfg = (dataclasses.replace(c, **kw) for c in (rcfg, pcfg))
    if rcfg.moe is not None:
        rcfg, pcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=8.0))
            for c in (rcfg, pcfg))
    return rcfg, pcfg


def _lm_grads(reference, arch, seq=16, **kw):
    """Both packages' loss and gradient at the fp32 policy."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    T = reference.transformer
    rcfg, pcfg = _lm_cfgs(reference, arch, **kw)
    arrays = _ref_weights(reference, rcfg, 0)
    batch = LMStream(pcfg.vocab, seq, 2, seed=0).batch_at(0)
    T.set_precision(jnp.float32, jnp.float32)
    PT.set_precision(torch.float32, torch.float32)
    try:
        ref = _ref_grad(jax, lambda p, b: T.loss_fn(p, b, rcfg), arrays,
                        batch)
        pp = lm_params_from_arrays(arrays, pcfg, device="cpu")
        port = value_and_grad(lambda p, b: PT.loss_fn(p, b, pcfg), pp,
                              batch)
    finally:
        T.set_precision()
        PT.set_precision()
    return port, ref, pp, pcfg, batch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_grad_equals_reference(reference, arch):
    port, ref, _, pcfg, _ = _lm_grads(reference, arch)
    assert pcfg.remat                       # reduced() keeps remat on
    _check(port, ref)
    if arch == "deepseek-v3-671b":          # MTP's layer is reached
        assert float(port[1]["mtp"]["proj"].abs().max()) > 0
        assert "mtp_nll" in port[0][1]


def test_chunked_attention_grad_equals_reference(reference):
    """``attn_chunk=8`` at seq 32: four KV blocks, each step of the
    online softmax under ``checkpoint`` in the port and ``jax.checkpoint``
    in the reference."""
    port, ref, pp, pcfg, batch = _lm_grads(reference, "qwen3-0.6b", seq=32,
                                           attn_chunk=8)
    assert pcfg.attn_chunk == 8
    _check(port, ref)
    # the same loss as the dense path, to rounding
    PT.set_precision(torch.float32, torch.float32)
    try:
        dense = value_and_grad(
            lambda p, b: PT.loss_fn(p, b, dataclasses.replace(
                pcfg, attn_chunk=0)), pp, batch)
    finally:
        PT.set_precision()
    _close_tree(port[1], dense[1], **GRAD_TOL)


def test_chunked_attention_backward_matches_dense():
    """The chunked path differentiates (the serving step updates its
    score tile in place and could not) and agrees with the dense path,
    fully masked KV slots included."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 11, 4, 8, generator=g, requires_grad=True)
               for _ in range(3))
    kv_mask = torch.ones(2, 11, dtype=torch.int32)
    kv_mask[1, 7:] = 0
    outs = []
    for chunk in (None, 4):
        o = pattn.attention(q, k[:, :, :2], v[:, :, :2], chunk=chunk,
                            kv_mask=kv_mask)
        (gq, gk, gv) = torch.autograd.grad((o * o).sum(), (q, k, v))
        outs.append((o.detach(), gq, gk, gv))
    for a, b in zip(*outs):          # fp32 either way: the blocks' sums
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with torch.no_grad():                    # serving keeps its own path
        o = pattn.attention(q, k[:, :, :2], v[:, :, :2], chunk=4,
                            kv_mask=kv_mask)
    torch.testing.assert_close(o, outs[1][0], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_remat_equals_no_remat(arch):
    cfg = dataclasses.replace(preg.get_arch(arch)[0].reduced(),
                              residual_dtype="float32", attn_chunk=4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    params = PT.init(cfg, seed=1, device="cpu")
    batch = LMStream(cfg.vocab, 12, 2, seed=1).batch_at(0)
    PT.set_precision(torch.float32, torch.float32)
    try:
        outs = [value_and_grad(lambda p, b, c=c: PT.loss_fn(p, b, c),
                               params, batch)
                for c in (cfg, dataclasses.replace(cfg, remat=False))]
    finally:
        PT.set_precision()
    (l1, _), g1 = outs[0]
    (l2, _), g2 = outs[1]
    assert torch.equal(l1, l2)
    for a, b in zip(leaves(g1), leaves(g2)):
        assert torch.equal(a, b)


def test_index_add_paths_pass_gradcheck():
    """The in-place scatter-adds into fresh zeros (the MoE combine and
    SchNet's segment sum) under ``gradcheck`` in float64."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(9, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    seg = torch.tensor([0, 2, 2, 1, 0, 4, 4, 4, 3])
    assert torch.autograd.gradcheck(lambda t: PS._segment_sum(t, seg, 5),
                                    (x,))
    cfg = dataclasses.replace(
        preg.get_arch("deepseek-v3-671b")[0].reduced(), d_model=8,
        moe=dataclasses.replace(preg.get_arch(
            "deepseek-v3-671b")[0].reduced().moe, d_ff=4))
    p = {k: v[0].double() for k, v in pmoe.moe_params(
        cfg, lambda name, shape, spec, init="fanin", param_dtype=None:
        torch.randn(shape, generator=g, dtype=torch.float64) * 0.3,
        LOCAL_PLAN, "moe", 1).items()}
    xs = torch.randn(1, 6, cfg.d_model, generator=g, dtype=torch.float64)
    names = ("w_gate", "w_up", "w_down", "sh_gate", "sh_up", "sh_down")

    def f(*ws):
        return pmoe.moe_ffn({**p, **dict(zip(names, ws))}, xs, cfg,
                            LOCAL_PLAN)

    ws = tuple(p[n].clone().requires_grad_() for n in names)
    assert torch.autograd.gradcheck(f, ws)


# ---------------------------------------------------------------------------
# the recsys and GNN models
# ---------------------------------------------------------------------------


def _recsys_setup(reference, arch):
    rcfg = reference.registry.get_arch(arch)[0].reduced()
    pcfg = preg.get_arch(arch)[0].reduced()
    R = reference.models_recsys
    arrays = np_weights(R.param_shapes(rcfg, reference.sharding.ShardPlan()),
                        0)
    return rcfg, pcfg, arrays


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_grad_equals_reference(reference, arch):
    jax = pytest.importorskip("jax")
    rcfg, pcfg, arrays = _recsys_setup(reference, arch)
    batch = batch_for(pcfg, 16, 0)
    R = reference.models_recsys
    ref = _ref_grad(jax, lambda p, b: R.loss_fn(p, b, rcfg), arrays, batch)
    pp = recsys_params_from_arrays(arrays, pcfg, device="cpu")
    port = value_and_grad(lambda p, b: PR.loss_fn(p, b, pcfg), pp, batch)
    _check(port, ref)


def _gnn_batches():
    g = pg.make_graph(200, 900, 12, n_classes=4, seed=0)
    snd, rcv = g.edge_list()
    return {"node": {"feats": g.feats, "pos": g.pos, "senders": snd,
                     "receivers": rcv, "labels": g.labels},
            "energy": pg.molecule_batch(3, 8, 24, 12, step=0)}


@pytest.mark.parametrize("kind", ["node", "energy"])
def test_schnet_grad_equals_reference(reference, kind):
    jax = pytest.importorskip("jax")
    kw = dict(d_feat=12, n_out=4 if kind == "node" else 1)
    rcfg = dataclasses.replace(
        reference.registry.get_arch("schnet")[0].reduced(), **kw)
    pcfg = dataclasses.replace(preg.get_arch("schnet")[0].reduced(), **kw)
    S = reference.schnet
    arrays = np_weights(S.param_shapes(rcfg, reference.sharding.ShardPlan()),
                        0)
    batch = _gnn_batches()[kind]
    # the reference indexes the batch's arrays with traced ids: hand it
    # jnp arrays
    ref = _ref_grad(jax, lambda p, b: S.loss_fn(p, b, rcfg), arrays,
                    {k: jax.numpy.asarray(v) if isinstance(v, np.ndarray)
                     else v for k, v in batch.items()})
    pp = schnet_params_from_arrays(arrays, pcfg, device="cpu")
    port = value_and_grad(lambda p, b: PS.loss_fn(p, b, pcfg), pp, batch)
    _check(port, ref)


# ---------------------------------------------------------------------------
# the CTR sparse step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2"])
def test_sparse_step_equals_reference(reference, arch):
    """Three sparse steps from the same weights on batches whose ids
    repeat: the table, the row-wise AdaGrad accumulator and the dense
    params (SGD-M) to rtol 1e-5."""
    jax = pytest.importorskip("jax")
    rcfg, pcfg, arrays = _recsys_setup(reference, arch)
    plan = reference.sharding.ShardPlan()
    ro = reference.optim
    rinit, rstep = reference.sparse_embed.make_ctr_sparse_train_step(
        rcfg, plan, ro.sgd(ro.constant_lr(1e-2)), lr_embed=0.05)
    pinit, pstep = make_ctr_sparse_train_step(
        pcfg, LOCAL_PLAN, optim.sgd(optim.constant_lr(1e-2)), lr_embed=0.05)
    rstate = rinit(jax.tree.map(jax.numpy.asarray, arrays))
    pstate = pinit(recsys_params_from_arrays(arrays, pcfg, device="cpu"))
    rstep = jax.jit(rstep)
    for i in range(3):
        batch = batch_for(pcfg, 16, i)
        ids = batch["sparse"].reshape(-1)
        assert np.unique(ids).size < ids.size          # duplicates
        rstate, raux = rstep(rstate, batch)
        pstate, paux = pstep(pstate, batch)
        for k in raux:
            np.testing.assert_allclose(_np(paux[k]), np.asarray(raux[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(pstate.step) == 3
    _close_tree(pstate.params, jax.tree.map(np.asarray, rstate.params),
                **SPARSE_TOL)
    _close_tree(pstate.opt_state, jax.tree.map(np.asarray,
                                               rstate.opt_state),
                **SPARSE_TOL)
    acc = pstate.opt_state["embed_acc"]
    assert acc.dtype == torch.float32 and int((acc > 0).sum()) > 0


def test_rowwise_adagrad_duplicates_see_the_full_sum():
    """Every duplicate id reads the accumulator after all of its rows
    were added, and the updates of duplicates add up."""
    from repro_torch.train.sparse_embed import rowwise_adagrad_update

    table = torch.zeros(4, 2)
    acc = torch.zeros(4)
    ids = torch.tensor([1, 1, 3, -1])
    g = torch.tensor([[1.0, 1.0], [3.0, 3.0], [2.0, 2.0], [0.0, 0.0]])
    t, a = rowwise_adagrad_update(table, acc, ids, g, lr=1.0, eps=0.0)
    assert t is table and a is acc                     # in place
    assert acc.tolist() == [0.0, 10.0, 0.0, 4.0]
    s1 = 1.0 / np.sqrt(10.0)
    np.testing.assert_allclose(table[1].numpy(), [-4 * s1] * 2, rtol=1e-6)
    np.testing.assert_allclose(table[3].numpy(), [-1.0] * 2, rtol=1e-6)
    assert table[0].tolist() == [0.0, 0.0] and table[2].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dcn-v2", "schnet"])
def test_launcher_trains_each_family(arch, tmp_path, capsys):
    from repro_torch.launch.train import main
    from repro_torch.train import checkpoint as C

    d = str(tmp_path)
    res = main(["--arch", arch, "--steps", "3", "--device", "cpu",
                "--batch", "4", "--seq", "16", "--log-every", "1",
                "--ckpt-dir", d])
    assert [h["step"] for h in res.history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in res.history)
    assert C.latest_step(d) == 3
    out = capsys.readouterr().out
    assert "(reduced)" in out and "stragglers:" in out
    res = main(["--arch", arch, "--steps", "4", "--device", "cpu",
                "--batch", "4", "--seq", "16", "--ckpt-dir", d,
                "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in res.history] == [3]
