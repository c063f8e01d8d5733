"""The branches that split work over tp as the reference does, on 4 gloo
CPU ranks over a ``(2, 2)`` mesh, each held against the port's one-card
step and the reference's cell on the same numpy-made weights
(``test_torch_sharded_models.py``'s helpers and tolerances: ids and
argmax exactly, values at 1e-4 of each leaf's max at the fp32 policy).

1. the query heads over tp with K and V computed whole on each rank and
   the heads its queries read kept: granite-34b ``reduced()`` (one KV
   head over tp = 2, a shared slice) and qwen3-0.6b ``reduced()`` with 6
   query and 3 KV heads (one KV index a query head), through the prefill
   cell, the decode cell (a prefill and three steps) and one train step;
2. the queries over their sequence shard: qwen3-14b ``reduced()`` with
   3 query heads and 1 KV head (``attn_shard`` "seq", a 16-token
   sequence), the same three cells, the reference's config replaced the
   same way;
3. the vocabulary-parallel loss alone (``transformer._xent``): logits
   with ties planted in the argmax across and within the vocabulary
   shards, a mask with a zero row, z-loss on and off; loss, accuracy and
   the logits' gradient;
4. DLRM and DCN-v2 ``reduced()`` with one MLP layer of 1024 x 1024 (the
   reference's ``_mlp_params`` splits it over ``("fsdp", "tp")``) and
   ``-1`` padding ids in the lookups, through the serve cell and the
   sparse train cell.

One module-scoped fixture starts the reference's subprocess and the 4
ranks side by side (a ``FileStore`` under the test's tmp dir, 60 s group
timeouts, the ranks joined within 300 s); every test reads their
pickles.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_sharded_models as C
from test_torch_reference import REPO

from repro_torch.configs import registry as preg
from repro_torch.distributed import sharding
from repro_torch.launch import cells as pcells

WORLD = 4
RANK_LIMIT_S = 300
REF_LIMIT_S = 300
# name -> (arch, the fields replaced in its ``reduced()`` config)
LM = {"granite": ("granite-34b", {}),
      "gqa6": ("qwen3-0.6b", dict(n_heads=6, n_kv_heads=3)),
      "odd": ("qwen3-14b", dict(n_heads=3, n_kv_heads=1))}
CTR = {"dlrm": ("dlrm-mlperf", dict(top_mlp=(1024, 1024, 1))),
       "dcn": ("dcn-v2", dict(mlp=(1024, 1024)))}
Z_LOSS = [0.0, 1e-2]


def lm_cfg(get_arch, name):
    arch, kw = LM[name]
    return dataclasses.replace(C.lm_cfg(get_arch, arch), **kw)


def ctr_cfg(get_arch, name):
    arch, kw = CTR[name]
    return dataclasses.replace(get_arch(arch)[0].reduced(), **kw)


def ctr_batch(cfg) -> dict:
    """``test_torch_sharded_models.ctr_batch`` with a ``-1`` (padding)
    id in some rows of two features."""
    b = C.ctr_batch(cfg)
    b["sparse"][::3, 1] = -1
    b["sparse"][1::4, 3] = -1
    return b


def loss_inputs() -> dict:
    """Logits (4, 6, 16) with ties planted in the argmax: across the two
    vocabulary shards (indices 3 and 12) and inside one (9 and 14), each
    with the label on the smaller and on the larger index; a mask whose
    row 2 is zero."""
    rng = np.random.default_rng(11)
    lg = rng.standard_normal((4, 6, 16)).astype(np.float32)
    lb = rng.integers(0, 16, (4, 6)).astype(np.int64)
    for (b, s), (i, j), label in [((0, 0), (3, 12), 12), ((0, 1), (3, 12), 3),
                                  ((1, 0), (9, 14), 14), ((1, 2), (9, 14), 9),
                                  ((3, 5), (0, 15), 0)]:
        lg[b, s, [i, j]] = 5.0
        lb[b, s] = label
    mask = np.ones((4, 6), np.float32)
    mask[2] = 0.0
    mask[3, :2] = 0.0
    return {"logits": lg, "labels": lb, "mask": mask}


# ------------------------------------------------------------- reference
_REF = """
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings; warnings.filterwarnings("ignore")
import numpy as np
import jax
import jax.numpy as jnp
from test_torch_reference import reference_modules
import test_torch_sharded_models as C
import test_torch_tp_split as S

out_path = sys.argv[1]
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
npy = lambda t: jax.tree.map(lambda a: np.asarray(a), t)
out = {}
with reference_modules() as ref:
    cells, T = ref.cells, ref.transformer
    TS = ref.loop.TrainState
    plan = ref.sharding.SINGLE_POD_PLAN.with_mesh(mesh)
    Shape = ref.configs_base.ShapeSpec
    get = ref.registry.get_arch
    T.set_precision(jnp.float32, jnp.float32)

    def jit(cell):
        return jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)

    for name in S.LM:
        cfg = S.lm_cfg(get, name)
        shapes = C.lm_shapes(Shape)
        res = {}
        cell = cells.build_cell(cfg, "lm", plan, shapes["train"])
        st, batch = C.lm_train_inputs(cell, cfg.vocab)
        state = TS(jnp.int32(st["step"]), jax.tree.map(jnp.asarray,
                   st["params"]), jax.tree.map(jnp.asarray,
                   st["opt_state"]), None)
        new, aux = jit(cell)(state, batch)
        res["train"] = {"aux": npy(aux), "params": npy(new.params),
                        "opt_state": npy(new.opt_state)}
        cell = cells.build_cell(cfg, "lm", plan, shapes["prefill"])
        p = C.weights(cell.args[0], 0)
        toks = C.lm_tokens(cfg.vocab, cell.args[1].shape, 2)
        lg, cache = jit(cell)(jax.tree.map(jnp.asarray, p), toks)
        res["prefill"] = {"logits": np.asarray(lg), "cache": npy(
            jax.tree.map(lambda a: a.astype(jnp.float32), cache))}
        cell = cells.build_cell(cfg, "lm", plan, shapes["decode"])
        p = jax.tree.map(jnp.asarray, C.weights(cell.args[0], 0))
        b = cell.args[2].shape[0]
        toks = C.lm_tokens(cfg.vocab, (b, C.PROMPT + C.DECODE_STEPS), 4)
        dcfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        dplan = dataclasses.replace(cells._moe_plan(cfg, plan), fsdp=())
        dcfg = cells.lm_config_for_mesh(dcfg, dplan, shapes["decode"])
        pre = jax.jit(lambda p_, t_: T.prefill(p_, t_, dcfg, dplan,
                                               max_len=C.MAX_LEN),
                      in_shardings=(cell.in_shardings[0],
                                    cell.in_shardings[2]),
                      out_shardings=(cell.out_shardings[0],
                                     cell.out_shardings[1]))
        lg, cache = pre(p, toks[:, :C.PROMPT])
        step = jit(cell)
        logits = [np.asarray(lg)]
        for i in range(C.DECODE_STEPS):
            lg, cache = step(p, cache, toks[:, C.PROMPT + i:C.PROMPT + i + 1])
            logits.append(np.asarray(lg))
        res["decode"] = {"logits": logits}
        out[name] = res

    xi = S.loss_inputs()
    for z in S.Z_LOSS:
        def f(lg):
            loss, aux = ref.layers.softmax_xent(
                lg, jnp.asarray(xi["labels"]), z_loss=z,
                mask=jnp.asarray(xi["mask"]))
            return loss, aux["accuracy"]
        (loss, acc), g = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(xi["logits"]))
        out[f"loss_{z}"] = {"loss": np.asarray(loss),
                            "accuracy": np.asarray(acc),
                            "grad": np.asarray(g)}

    for name in S.CTR:
        cfg = S.ctr_cfg(get, name)
        res = {}
        batch = S.ctr_batch(cfg)
        cell = cells.build_cell(cfg, "recsys", plan,
                                Shape("serve_p99", "serve", dict(batch=16)))
        p = C.weights(cell.args[0], 0)
        sb = {k: batch[k] for k in ("dense", "sparse")}
        res["serve"] = np.asarray(jit(cell)(jax.tree.map(jnp.asarray, p), sb))
        cell = cells.build_cell(cfg, "recsys", plan,
                                Shape("train_batch", "train", dict(batch=16)))
        st = C.ctr_train_inputs(cell)
        state = TS(jnp.int32(st["step"]), jax.tree.map(jnp.asarray,
                   st["params"]), jax.tree.map(jnp.asarray,
                   st["opt_state"]), None)
        new, aux = jit(cell)(state, batch)
        res["train"] = {"aux": npy(aux), "params": npy(new.params),
                        "opt_state": npy(new.opt_state)}
        out[name] = res
with open(out_path, "wb") as fh:
    pickle.dump(out, fh)
"""


# ----------------------------------------------------------------- ranks


def _port_cells(plan) -> dict:
    from repro_torch.configs.base import ShapeSpec

    out = {}
    for name in LM:
        cfg = lm_cfg(preg.get_arch, name)
        out[name] = {k: pcells.build_cell(cfg, "lm", plan, s)
                     for k, s in C.lm_shapes(ShapeSpec).items()}
    for name in CTR:
        cfg = ctr_cfg(preg.get_arch, name)
        out[name] = {
            "serve": pcells.build_cell(cfg, "recsys", plan, ShapeSpec(
                "serve_p99", "serve", dict(batch=16))),
            "train": pcells.build_cell(cfg, "recsys", plan, ShapeSpec(
                "train_batch", "train", dict(batch=16)))}
    return out


def _state_of(cell, st, dev):
    from repro_torch.train.loop import TrainState

    return cell.place((TrainState(
        step=torch.tensor(int(st["step"]), dtype=torch.int32),
        params=C._tensors(st["params"]),
        opt_state=C._tensors(st["opt_state"]), ef_buf=None),), dev)[0]


def _run_cases(plan, dev) -> dict:
    """Every case through the port under ``plan`` (a mesh or none)."""
    from repro_torch.models import transformer as PT

    out = {}
    cs = _port_cells(plan)
    PT.set_precision(torch.float32, torch.float32)
    try:
        for name in LM:
            c, res = cs[name], {}
            cell = c["train"]
            st, batch = C.lm_train_inputs(cell, cell.cfg.vocab)
            res["split"] = {
                "train": PT._attn_split(torch.empty(
                    (2, 16, 1), device="meta"), cell.cfg, cell.plan),
                "kv_select": str(PT._kv_select(cell.cfg, cell.plan))}
            new, aux = cell.step_fn(_state_of(cell, st, dev),
                                    cell.place((None, batch), dev)[1])
            res["train"] = {"aux": C._whole(aux),
                            "params": C._whole(new.params),
                            "opt_state": C._whole(new.opt_state)}
            cell = c["prefill"]
            p = C.weights(cell.args[0], 0)
            toks = C.lm_tokens(cell.cfg.vocab, tuple(cell.args[1].shape), 2)
            lg, cache = cell.step_fn(*cell.place((C._tensors(p), toks), dev))
            res["prefill"] = {"logits": C._whole(lg),
                              "cache": C._whole(cache)}
            cell = c["decode"]
            p = cell.place((C._tensors(C.weights(cell.args[0], 0)),), dev)[0]
            b = cell.args[2].shape[0]
            toks = C.lm_tokens(cell.cfg.vocab,
                               (b, C.PROMPT + C.DECODE_STEPS), 4)
            tk = cell.place((None, None, toks[:, :C.PROMPT]), dev)[2]
            lg, cache = PT.prefill(p, tk, cell.cfg, cell.plan,
                                   max_len=C.MAX_LEN)
            logits = [C._whole(lg)]
            for i in range(C.DECODE_STEPS):
                t1 = cell.place((None, None, toks[:, C.PROMPT + i:
                                              C.PROMPT + i + 1]), dev)[2]
                lg, cache = cell.step_fn(p, cache, t1)
                logits.append(C._whole(lg))
            res["decode"] = {"logits": logits}
            out[name] = res
        xi = loss_inputs()
        for z in Z_LOSS:
            lg = plan.distribute(torch.as_tensor(xi["logits"]), "dp", None,
                                 "tp").requires_grad_()
            lb = plan.distribute(torch.as_tensor(xi["labels"]), "dp", None)
            mk = plan.distribute(torch.as_tensor(xi["mask"]), None, None)
            loss, aux = PT._xent(lg, lb, mk, plan, z)
            loss.backward()
            out[f"loss_{z}"] = {"loss": C._whole(loss),
                                "accuracy": C._whole(aux["accuracy"]),
                                "grad": C._whole(lg.grad)}
        for name in CTR:
            c, res = cs[name], {}
            batch = ctr_batch(c["serve"].cfg)
            cell = c["serve"]
            sb = {k: batch[k] for k in ("dense", "sparse")}
            res["serve"] = C._whole(cell.step_fn(*cell.place(
                (C._tensors(C.weights(cell.args[0], 0)), sb), dev)))
            cell = c["train"]
            new, aux = cell.step_fn(
                _state_of(cell, C.ctr_train_inputs(cell), dev),
                cell.place((None, batch), dev)[1])
            res["train"] = {"aux": C._whole(aux),
                            "params": C._whole(new.params),
                            "opt_state": C._whole(new.opt_state)}
            out[name] = res
    finally:
        PT.set_precision()
    return out


def _rank_main(rank: int, world: int, workdir: str) -> None:
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        plan = sharding.SINGLE_POD_PLAN.with_mesh(mesh)
        out = {"sharded": _run_cases(plan, "cpu")}
        if rank == 0:
            out["one_card"] = _run_cases(sharding.LOCAL_PLAN, "cpu")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 gloo ranks, side by side;
    ``{"ref": ..., "ranks": [...]}``."""
    workdir = str(tmp_path_factory.mktemp("tp_split"))
    ref_path = os.path.join(workdir, "ref.pkl")
    ref = subprocess.Popen([sys.executable, "-c", _REF, ref_path],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=C._env(), cwd=REPO)
    code = textwrap.dedent(f"""
        import sys
        from test_torch_tp_split import _rank_main
        _rank_main(int(sys.argv[1]), {WORLD}, {workdir!r})
    """)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=C._env(), cwd=REPO)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=RANK_LIMIT_S)
        _, err = ref.communicate(timeout=REF_LIMIT_S)
    except subprocess.TimeoutExpired:
        err = "timed out"
    finally:
        for p in procs + [ref]:
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
    assert ref.returncode == 0, (err or "")[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(ref_path, "rb") as f:
        refs = pickle.load(f)
    return {"ref": refs, "ranks": ranks}


# ----------------------------------------------------------------- tests


def _others(runs, name):
    return (runs["ranks"][0]["one_card"][name], runs["ref"][name])


def _gathered(res: dict) -> dict:
    """A rank's results without its own branch record."""
    return {k: {q: w for q, w in v.items() if q != "split"}
            for k, v in res.items()}


def test_every_rank_gathers_the_same_values(runs):
    r0 = _gathered(runs["ranks"][0]["sharded"])
    for r in runs["ranks"][1:]:
        C._bits(_gathered(r["sharded"]), r0)


@pytest.mark.parametrize("name,split,select", [
    ("granite", "heads", ["slice(0, 1, None)"] * 4),
    ("gqa6", "heads", ["[0, 0, 1]", "[1, 2, 2]"] * 2),
    ("odd", "seq", ["None"] * 4)])
def test_each_case_takes_its_branch(runs, name, split, select):
    """granite's one KV head and qwen3's 3 over tp = 2 take the split
    query heads with K and V whole (a shared head; one index a query
    head, the ranks' tp coordinate 0, 1, 0, 1); 3 query heads over 2 the
    sequence shard."""
    got = [r["sharded"][name]["split"] for r in runs["ranks"]]
    assert [g["train"] for g in got] == [split] * 4
    assert [g["kv_select"] for g in got] == select
    assert runs["ranks"][0]["one_card"][name]["split"] == {
        "train": "heads", "kv_select": "None"}


@pytest.mark.parametrize("name", list(LM))
def test_lm_train_step_matches_one_card_and_reference(runs, name):
    mine = runs["ranks"][0]["sharded"][name]["train"]
    for other in _others(runs, name):
        C._aux(mine["aux"], other["train"]["aux"])
        C._close_leaves(mine["params"], other["train"]["params"])
        C._close_leaves(mine["opt_state"], other["train"]["opt_state"])


@pytest.mark.parametrize("name", list(LM))
def test_lm_prefill_cell_matches_one_card_and_reference(runs, name):
    mine = runs["ranks"][0]["sharded"][name]["prefill"]
    for other in _others(runs, name):
        C._logits(mine["logits"], other["prefill"]["logits"])
        C._close_leaves(mine["cache"], other["prefill"]["cache"], 1e-5)


@pytest.mark.parametrize("name", list(LM))
def test_lm_decode_cell_matches_one_card_and_reference(runs, name):
    mine = runs["ranks"][0]["sharded"][name]["decode"]["logits"]
    for other in _others(runs, name):
        theirs = other["decode"]["logits"]
        assert len(mine) == len(theirs) == C.DECODE_STEPS + 1
        for a, b in zip(mine, theirs):
            C._logits(a, b)


@pytest.mark.parametrize("z", Z_LOSS)
def test_vocab_parallel_loss_with_ties(runs, z):
    """Loss and gradient at the step tolerances; the accuracy exactly:
    the planted ties count where the label is the smaller index, on
    either shard."""
    key = f"loss_{z}"
    mine = runs["ranks"][0]["sharded"][key]
    for other in _others(runs, key):
        np.testing.assert_allclose(mine["loss"], other["loss"], **C.TOL)
        assert float(mine["accuracy"]) == float(other["accuracy"])
        C._close_leaves({"g": mine["grad"]}, {"g": other["grad"]})
    xi = loss_inputs()
    arg = xi["logits"].argmax(-1)
    assert arg[0, 0] == 3 and arg[1, 0] == 9 and arg[3, 5] == 0
    want = ((arg == xi["labels"]) * xi["mask"]).sum() / xi["mask"].sum()
    assert float(mine["accuracy"]) == np.float32(want)


@pytest.mark.parametrize("name", list(CTR))
def test_ctr_split_mlp_serve_and_sparse_train(runs, name):
    """The 1024 x 1024 layer over tp, the pads' rows zero in the lookups
    (and their gradient counted from the table's end, as ``jnp``
    indexing does)."""
    mine = runs["ranks"][0]["sharded"][name]
    for other in _others(runs, name):
        C._logits(mine["serve"][:, None], C._f32(other["serve"])[:, None])
        C._aux(mine["train"]["aux"], other["train"]["aux"])
        C._close_leaves(mine["train"]["params"], other["train"]["params"])
        C._close_leaves(mine["train"]["opt_state"],
                        other["train"]["opt_state"])
