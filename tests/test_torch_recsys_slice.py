"""The recsys models' serving path on the CPU, held against the reference.

The port's ``data.recsys`` batches and ``models.recsys`` (DLRM, DCN-v2,
DIN, SASRec) against the reference's on the same numpy-seeded inputs, the
reference's weights carried across with
``convert.recsys_params_from_arrays``:

* ``ctr_batch`` / ``din_batch`` / ``sasrec_batch`` (``batch_for``) equal
  the reference's bit for bit, at ``reduced()`` and at full config;
* ``param_specs`` and ``param_shapes`` equal at full size (``meta``
  tensors, no allocation);
* for each arch at ``reduced()``: ``serve_logits``, ``loss_fn`` (loss and
  aux), ``ctr_forward_gathered`` (DLRM / DCN) and ``retrieval_logits``
  (k 8 of 64 candidates) to rtol / atol 1e-5 (``TOL32``), top ids exact;
* DLRM and DCN-v2 with the whole tree in bf16 (the bf16 leaves carried
  bit for bit): both packages promote to fp32 after the gather, so the
  same 1e-5 holds;
* DIN with a fully masked history row (uniform attention over all L
  slots, ``-1e30`` not ``-inf``); SASRec with end-padded sequences (the
  last slot scored, a pad for short rows: the reference's behaviour);
* chunked retrieval against one shot (ids equal, scores to 1e-6);
* a missing, extra or misshapen leaf raises ``ValueError``; the entry
  points need a card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.configs import registry as preg
from repro_torch.convert import recsys_params_from_arrays
from repro_torch.data import recsys as pdata
from repro_torch.distributed.sharding import SINGLE_POD_PLAN
from repro_torch.models import base as pbase
from repro_torch.models import recsys as PR
from repro_torch.models.embedding import take_embeddings

RECSYS_ARCHS = ["dlrm-mlperf", "dcn-v2", "din", "sasrec"]
TOL32 = dict(rtol=1e-5, atol=1e-5)
BATCH = 16
N_CAND = 64
TOP_K = 8
# the leaves drawn 1 + 0.1 normal (norm scales) and 0.1 normal (biases,
# tables); every other leaf a weight, normal / sqrt(fan in)
SCALES = {"ln1", "ln2", "final_ln"}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, dtype=np.float32)


def _fan_in(key: str, shape: tuple) -> int:
    if key in ("w_q", "w_k", "w_v"):          # (L, D, H, dh)
        return shape[1]
    if key == "w_o":                          # (L, H, dh, D)
        return shape[1] * shape[2]
    return shape[-2]


def np_weights(shapes: dict, seed: int, dtype=np.float32) -> dict:
    """A tree of numpy arrays shaped as ``shapes`` (any tree of objects
    with ``.shape``: the reference's ``param_shapes``), numpy-seeded;
    ``dtype`` may be ``ml_dtypes``' bfloat16, as JAX hands it over.
    Faster on the CPU than the reference's ``init``, whose eager ops
    compile one by one."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, sds in tree.items():
            if isinstance(sds, dict):
                out[k] = walk(sds)
                continue
            shape = tuple(sds.shape)
            a = rng.standard_normal(shape).astype(np.float32)
            if k in SCALES:
                a = 1.0 + 0.1 * a
            elif "table" in k or len(shape) == 1 or k.startswith(
                    ("b", "f_b", "cross_b")):
                a = 0.1 * a
            else:
                a = a / np.sqrt(_fan_in(k, shape))
            out[k] = a.astype(dtype)
        return out

    return walk(shapes)


def _cfgs(reference, arch, reduced=True):
    rcfg = reference.registry.get_arch(arch)[0]
    pcfg = preg.get_arch(arch)[0]
    if reduced:
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    return rcfg, pcfg


def _both(reference, arch, dtype=np.float32, seed=0):
    """The reference's and the port's trees on the same numpy weights."""
    jnp = pytest.importorskip("jax.numpy")
    R = reference.models_recsys
    rcfg, pcfg = _cfgs(reference, arch)
    arrays = np_weights(R.param_shapes(rcfg, reference.sharding.ShardPlan()),
                        seed, dtype)
    rp = pbase.tree_map(jnp.asarray, arrays)
    pp = recsys_params_from_arrays(arrays, pcfg, device="cpu")
    return rcfg, pcfg, rp, pp, arrays


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_batches_bit_for_bit(reference, arch, reduced):
    rcfg, pcfg = _cfgs(reference, arch, reduced)
    for step, seed in ((0, 0), (3, 7)):
        mine = pdata.batch_for(pcfg, BATCH, step, seed)
        theirs = reference.data_recsys.batch_for(rcfg, BATCH, step, seed)
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype, k
            assert np.array_equal(mine[k], theirs[k]), k
    with pytest.raises(TypeError):
        pdata.batch_for(preg.get_arch("schnet")[0], 2, 0)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_serve_and_retrieval_batches(arch):
    """``serve_batch`` drops the label (SASRec: the last positive is the
    target); ``retrieval_batch`` keeps the first user against candidates
    0 .. n - 1, DIN's categories ``id % n_cates``."""
    cfg = preg.get_arch(arch)[0].reduced()
    batch = pdata.batch_for(cfg, 4, 2)
    serve = pdata.serve_batch(cfg, batch)
    rb = pdata.retrieval_batch(cfg, batch, 10)
    assert "label" not in serve and np.array_equal(
        rb["candidates"], np.arange(10, dtype=np.int32))
    if arch == "sasrec":
        assert np.array_equal(serve["target_item"], batch["pos"][:, -1])
        assert np.array_equal(rb["seq"], batch["seq"][:1])
    elif arch == "din":
        assert np.array_equal(rb["cand_cates"], np.arange(10) % cfg.n_cates)
        assert rb["hist_items"].shape == (1, cfg.seq_len)
    else:
        assert rb["sparse"].shape == (1, len(cfg.table_sizes))
        assert rb["dense"].shape == (1, cfg.n_dense)
    with pytest.raises(TypeError):
        pdata.retrieval_batch(preg.get_arch("schnet")[0], batch, 10)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _spec(entries) -> tuple:
    return tuple(None if e is None else (tuple(e) if isinstance(e, tuple)
                                         else (e,)) for e in entries)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_param_specs_and_shapes_equal_reference(reference, arch):
    jnp = pytest.importorskip("jax.numpy")
    R = reference.models_recsys
    rcfg, pcfg = _cfgs(reference, arch, reduced=False)
    mine = _paths(PR.param_specs(pcfg, SINGLE_POD_PLAN))
    theirs = _paths(R.param_specs(rcfg, reference.sharding.SINGLE_POD_PLAN))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert _spec(mine[k]) == _spec(theirs[k]), k
    mine = _paths(PR.param_shapes(pcfg))
    theirs = _paths(R.param_shapes(rcfg, reference.sharding.ShardPlan()))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].device.type == "meta"
        assert tuple(mine[k].shape) == tuple(theirs[k].shape), k
        assert str(mine[k].dtype).split(".")[-1] == \
            jnp.dtype(theirs[k].dtype).name, k
    if arch == "sasrec":                     # n_items + 1 rows, no mesh
        assert tuple(PR.param_shapes(pcfg)["item_table"].shape) == \
            (1_000_001, 50)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_params_from_arrays(reference, arch):
    R = reference.models_recsys
    rcfg, pcfg = _cfgs(reference, arch)
    arrays = np_weights(R.param_shapes(rcfg, reference.sharding.ShardPlan()),
                        1)
    tree = recsys_params_from_arrays(arrays, pcfg, device="cpu")
    src, got = _paths(arrays), _paths(tree)
    assert src.keys() == got.keys()
    for k in src:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), src[k]), k
    first = next(iter(arrays))
    with pytest.raises(ValueError, match=first):
        recsys_params_from_arrays(dict(arrays, **{first: arrays[first][:-1]}),
                                  pcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        recsys_params_from_arrays(dict(arrays, extra=arrays[first]), pcfg,
                                  device="cpu")
    short = dict(arrays)
    del short[first]
    with pytest.raises(ValueError, match="keys"):
        recsys_params_from_arrays(short, pcfg, device="cpu")


def test_recsys_init_needs_a_card_unless_asked_for_the_cpu():
    cfg = preg.get_arch("din")[0].reduced()
    p = PR.init(cfg, seed=1, device="cpu")
    assert p["item_table"].device.type == "cpu"
    assert pbase.count_params(p) == pbase.count_params(PR.param_shapes(cfg))
    pb = PR.init(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in pbase.tree_leaves(pb))
    # drawn in fp32, then cast: the bf16 tree is the fp32 one rounded
    assert torch.equal(pb["item_table"], p["item_table"].bfloat16())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PR.init(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recsys_params_from_arrays(
                pbase.tree_map(lambda t: t.numpy(), p), cfg)


# ---------------------------------------------------------------------------
# the four archs at reduced(): serve, loss, gathered forward, retrieval
# ---------------------------------------------------------------------------

_RUNS: dict = {}


def _run(reference, arch, dtype_name="float32"):
    """Both packages' serve, loss, gathered forward and retrieval on the
    reference's weights, once per (arch, dtype)."""
    key = (arch, dtype_name)
    if key in _RUNS:
        return _RUNS[key]
    jnp = pytest.importorskip("jax.numpy")
    R = reference.models_recsys
    dtype = np.float32 if dtype_name == "float32" else jnp.bfloat16
    rcfg, pcfg, rp, pp, _ = _both(reference, arch, dtype)
    batch = pdata.batch_for(pcfg, BATCH, 0)
    serve = pdata.serve_batch(pcfg, batch)
    rb = pdata.retrieval_batch(pcfg, batch, N_CAND)
    out = {"ref": {}, "port": {}}
    out["ref"]["serve"] = R.serve_logits(rp, serve, rcfg)
    out["port"]["serve"] = PR.serve_logits(pp, serve, pcfg)
    out["ref"]["loss"] = R.loss_fn(rp, batch, rcfg)
    out["port"]["loss"] = PR.loss_fn(pp, batch, pcfg)
    out["ref"]["retrieval"] = R.retrieval_logits(rp, rb, rcfg, k=TOP_K)
    out["port"]["retrieval"] = PR.retrieval_logits(pp, rb, pcfg, k=TOP_K)
    if arch in ("dlrm-mlperf", "dcn-v2"):
        rest = {k: v for k, v in rp.items() if k != "table"}
        e = R.take_embeddings(rp["table"], batch["sparse"])
        out["ref"]["gathered"] = R.ctr_forward_gathered(rest, e, batch, rcfg)
        prest = {k: v for k, v in pp.items() if k != "table"}
        pe = take_embeddings(pp["table"], torch.as_tensor(batch["sparse"]))
        out["port"]["gathered"] = PR.ctr_forward_gathered(prest, pe, batch,
                                                          pcfg)
    _RUNS[key] = out
    return out


def _close(port, ref, tol=TOL32):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_serve_logits_equal_reference(reference, arch):
    out = _run(reference, arch)
    assert tuple(out["port"]["serve"].shape) == (BATCH,)
    assert out["port"]["serve"].dtype == torch.float32
    _close(out["port"]["serve"], out["ref"]["serve"])


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_loss_equals_reference(reference, arch):
    out = _run(reference, arch)
    (rl, raux), (pl, paux) = out["ref"]["loss"], out["port"]["loss"]
    assert set(paux) == set(raux)
    for k in raux:
        _close(paux[k], raux[k])
    _close(pl, rl)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2"])
def test_recsys_ctr_forward_gathered_equals_reference(reference, arch):
    out = _run(reference, arch)
    _close(out["port"]["gathered"], out["ref"]["gathered"])
    _close(out["port"]["gathered"], out["port"]["serve"], dict(rtol=0,
                                                               atol=0))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_retrieval_equals_reference(reference, arch):
    out = _run(reference, arch)
    (rs, ri), (ps, pi) = out["ref"]["retrieval"], out["port"]["retrieval"]
    assert tuple(pi.shape) == (TOP_K,) and pi.dtype == torch.int32
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    _close(ps, rs)
    assert (np.diff(ps.numpy()) <= 0).all()          # descending


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2"])
def test_recsys_bf16_tree_equals_reference(reference, arch):
    """The whole tree in bf16 (as DLRM is served on the card): the dense
    input stays fp32, so both packages compute the MLPs and the
    interaction in fp32 on the same bf16 values."""
    out = _run(reference, arch, "bfloat16")
    assert out["port"]["serve"].dtype == torch.float32
    _close(out["port"]["serve"], out["ref"]["serve"])
    _close(out["port"]["loss"][0], out["ref"]["loss"][0])
    (rs, ri), (ps, pi) = out["ref"]["retrieval"], out["port"]["retrieval"]
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    _close(ps, rs)


def test_din_fully_masked_history_row(reference):
    """A history with no item: every score is -1e30, the softmax uniform
    over all L slots (the pad rows' zero embeddings), as the reference's,
    in serving and in retrieval."""
    R = reference.models_recsys
    rcfg, pcfg, rp, pp, _ = _both(reference, "din", seed=2)
    batch = pdata.batch_for(pcfg, 4, 1)
    for key in ("hist_items", "hist_cates"):
        batch[key][1] = -1
    serve = pdata.serve_batch(pcfg, batch)
    _close(PR.serve_logits(pp, serve, pcfg), R.serve_logits(rp, serve, rcfg))
    user = PR._din_user_embed(
        pp, torch.as_tensor(batch["hist_items"][1:2]).long(),
        PR._din_history(pp, torch.as_tensor(batch["hist_items"][1:2]).long(),
                        torch.as_tensor(batch["hist_cates"][1:2]).long()),
        torch.ones((1, 2 * pcfg.embed_dim)))
    assert torch.isfinite(user).all() and not user.any()   # mean of zeros
    rb = pdata.retrieval_batch(pcfg, {k: v[1:2] for k, v in batch.items()},
                               N_CAND)
    (rs, ri), (ps, pi) = (R.retrieval_logits(rp, rb, rcfg, k=TOP_K),
                          PR.retrieval_logits(pp, rb, pcfg, k=TOP_K))
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    _close(ps, rs)


def test_sasrec_end_padded_sequences(reference):
    """``sasrec_batch`` pads at the end and ``serve_logits`` scores the last
    slot, so a short row is scored from a pad position (and a padded target
    scores 0): the reference's behaviour, held as it is."""
    R = reference.models_recsys
    rcfg, pcfg, rp, pp, _ = _both(reference, "sasrec", seed=3)
    batch = pdata.batch_for(pcfg, BATCH, 5)
    padded = batch["seq"][:, -1] < 0
    assert padded.any() and (~padded).any()
    serve = pdata.serve_batch(pcfg, batch)
    got = PR.serve_logits(pp, serve, pcfg)
    _close(got, R.serve_logits(rp, serve, rcfg))
    assert not got[torch.as_tensor(batch["pos"][:, -1] < 0)].any()
    h = PR._sasrec_hidden(pp, batch["seq"], pcfg, SINGLE_POD_PLAN)
    _close(h, R._sasrec_hidden(rp, batch["seq"], rcfg,
                               reference.sharding.ShardPlan()))
    assert torch.equal(PR.user_vectors(pp, batch["seq"], pcfg), h[:, -1])


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_chunked_retrieval_equals_one_shot(arch, monkeypatch):
    """``RETRIEVAL_CHUNK`` candidates at a time (1, 7, 64 of 100) against
    one shot: ids equal, scores to fp32 rounding."""
    cfg = preg.get_arch(arch)[0].reduced()
    params = PR.init(cfg, seed=4, device="cpu")
    batch = pdata.batch_for(cfg, 2, 0)
    rb = pdata.retrieval_batch(cfg, batch, 100)
    assert PR.RETRIEVAL_CHUNK >= 100
    one_s, one_i = PR.retrieval_logits(params, rb, cfg, k=20)
    for chunk in (1, 7, 64):
        monkeypatch.setattr(PR, "RETRIEVAL_CHUNK", chunk)
        s, i = PR.retrieval_logits(params, rb, cfg, k=20)
        assert torch.equal(i, one_i)
        torch.testing.assert_close(s, one_s, rtol=1e-6, atol=1e-6)
    assert len(set(one_i.tolist())) == 20


def test_retrieval_ties_go_to_the_lower_index():
    """``lax.top_k``'s order: equal scores rank by candidate position."""
    cfg = dataclasses.replace(preg.get_arch("sasrec")[0].reduced(),
                              n_items=10)
    params = PR.init(cfg, seed=0, device="cpu")
    params["item_table"][:] = 1.0               # every candidate ties
    rb = {"seq": pdata.batch_for(cfg, 1, 0)["seq"],
          "candidates": np.array([9, 3, 7, 1, 5], np.int32)}
    s, i = PR.retrieval_logits(params, rb, cfg, k=3)
    assert i.tolist() == [9, 3, 7]
    assert torch.equal(s, s[:1].expand(3))


def test_retrieval_example_runs_on_the_cpu():
    """``examples/retrieval_recsys_torch.py`` end to end on the CPU at a
    small item count: it exits 0 and prints its recall@10."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "examples",
                                      "retrieval_recsys_torch.py"),
         "--device", "cpu", "--n-items", "4096"],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert "recall@10 vs exact = " in out.stdout
    r = float(out.stdout.split("recall@10 vs exact = ")[1].split(",")[0])
    assert 0.0 < r <= 1.0


def test_sasrec_items_through_two_level_index_d51():
    """SASRec's items at d 50, MIPS-augmented to 51, through
    ``build_two_level`` (brute top and bottom: the probe chain's plain
    version on the CPU): probing every bucket equals the exact
    ``retrieval_logits`` top-10 (``testing.mips_parity``), and a wrong
    answer is caught."""
    from repro_torch.core.two_level import TwoLevelConfig, build_two_level
    from repro_torch.testing import mips_parity, sasrec_mips_truth

    cfg = dataclasses.replace(preg.get_arch("sasrec")[0].reduced(),
                              n_items=3000, embed_dim=50)
    params = PR.init(cfg, seed=5, device="cpu")
    seq = pdata.batch_for(cfg, 8, 0)["seq"]
    users, exact, items = sasrec_mips_truth(params, seq, cfg)
    aug_items, aug_users, m2 = PR.mips_augment(items, users)
    assert aug_items.shape == (cfg.n_items, 51) and aug_users.shape == (8, 51)
    idx = build_two_level(aug_items, TwoLevelConfig(
        n_clusters=16, kmeans_iters=4), device="cpu")
    _, ann, work = idx.search(aug_users, 10, nprobe=16)
    assert work["candidates"] == 8 * cfg.n_items
    res = mips_parity(ann, exact, users, items, m2)
    assert res["match"] >= 0.99 and res["bad"] == 0, res
    assert res["repeats"] == 0
    far = np.argsort(users[0] @ items.T)[:10]          # the lowest scores
    bad = ann.copy()
    bad[0] = far
    assert mips_parity(bad, exact, users, items, m2)["bad"] > 0
