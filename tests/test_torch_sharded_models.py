"""Models sharded over a mesh, on the CPU: the port's ``ShardPlan``
placements, its copy of the reference's cell builders
(``repro_torch.launch.cells``) and the sharded serve and train steps.

Three layers, from the inside out:

1. the arithmetic: ``ShardPlan.placements`` of every role of the three
   plans (the two-axis dims too) against the reference's ``p()`` on the
   same mesh shape, every model's parameter specs placeable, a tuple
   against mesh order refused; ``lm_config_for_mesh``, ``_moe_plan``
   (``MULTI_POD_PLAN`` on (2, 2, 2) and (2, 16, 16): kimi's 512 padded
   experts) and ``_lm_optimizer`` against the reference's; every builder
   of the reference's ``launch/cells.py`` present, and each cell's specs
   equal to the reference's ``in_shardings`` / ``out_shardings``;
2. the reference's cells run for real on 4 fake XLA devices over a
   ``(2, 2)`` mesh in one subprocess (fp32 policy, numpy-made weights in
   its layout, a trained optimizer state so a step's update is smooth,
   ROADMAP fault 21): qwen3-0.6b and deepseek-v3 (MoE, MLA, MTP) at
   ``reduced()`` through the prefill cell, the decode cell (a prefill
   and three decode steps) and one train-cell step (qwen3 one
   microbatch of 8, deepseek its ``grad_accum`` of 4 microbatches);
   DLRM and DCN-v2 through the serve cell and the sparse train cell;
   SchNet through the GNN cell on a molecule batch and a node graph (bf16
   messages, as the cell binds them, and the same step at fp32
   messages); Adafactor and AdamW in place on placed leaves; the
   converters' ``plan=``;
3. one module-scoped spawn of 4 gloo ranks (a ``FileStore`` under the
   test's tmp dir, 60 s group timeouts, the ranks joined within 300 s) on
   a ``(2, 2)`` mesh, the same steps through the port's cells, run beside
   the reference's subprocess; each rank gathers every output whole, and
   rank 0 also runs the port's unsharded step.  A sharded checkpoint
   saved by the ranks restores unsharded, and into the reference, bit for
   bit.

Tolerances: logits 1e-5 of their largest magnitude (at least 1; the
sharded heads and hidden units add their partial sums in another order);
losses and aux 1e-5; updated parameters and
optimizer state 1e-4 of each leaf's max; argmax and ids exactly; every
rank's gathered value equal to rank 0's bit for bit; bf16 messages at a
relative L2 of 2**-4 (``test_torch_gnn_slice.py``'s bound).
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

from test_torch_reference import REPO, reference  # noqa: F401  (fixture)

from repro_torch.configs import registry as preg
from repro_torch.distributed import sharding
from repro_torch.launch import cells as pcells

WORLD = 4
RANK_LIMIT_S = 300
REF_LIMIT_S = 300
TOL = dict(rtol=1e-5, atol=1e-5)
LEAF_TOL = 1e-4
BF16_REL_L2 = 2 ** -4
LM = {"qwen3": "qwen3-0.6b", "deepseek": "deepseek-v3-671b"}
CTR = {"dlrm": "dlrm-mlperf", "dcn": "dcn-v2"}
GNN = {"molecule": ("molecule", dict(batch=4, n_nodes=12, n_edges=40,
                                     d_feat=8)),
       "graph": ("full_graph_sm", dict(n_nodes=64, n_edges=296, d_feat=8))}
PROMPT, MAX_LEN, DECODE_STEPS = 12, 20, 3
START_STEP = 100                   # warmup's lr is 0 at step 0
NORMS = {"ln1", "ln2", "q_norm", "k_norm", "q_ln", "kv_ln", "final_norm",
         "norm_h", "norm_e", "final_ln"}


# ---------------------------------------------------------------- cases
# (both processes build every input from these, with numpy)


def lm_cfg(get_arch, arch):
    c = dataclasses.replace(get_arch(arch)[0].reduced(),
                            residual_dtype="float32")
    if c.moe is not None:
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0))
    return c


def lm_shapes(ShapeSpec) -> dict:
    return {"train": ShapeSpec("train", "train", dict(seq=16, batch=8)),
            "prefill": ShapeSpec("prefill", "prefill", dict(seq=16,
                                                            batch=4)),
            "decode": ShapeSpec("decode", "decode", dict(seq=MAX_LEN,
                                                         batch=4))}


def gnn_shape(ShapeSpec, kind):
    name, dims = GNN[kind]
    return ShapeSpec(name, "train", dims)


def _np_dtype(dt):
    if "bfloat16" in str(dt):
        import ml_dtypes
        return ml_dtypes.bfloat16
    return np.dtype(str(dt).replace("torch.", ""))


def _fan_in(key: str, shape: tuple) -> int:
    if key in ("w_q", "w_k", "w_v"):
        return shape[-3]
    if key == "w_o":
        return int(np.prod(shape[-3:-1]))
    return shape[-2]


def weights(shapes, seed: int) -> dict:
    """A parameter tree of numpy arrays in each leaf's dtype (bf16 as
    ``ml_dtypes``' type, as JAX hands it over)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            shape = tuple(v.shape)
            a = rng.standard_normal(shape).astype(np.float32)
            if k in NORMS:
                a = 1.0 + 0.1 * a
            elif len(shape) == 1 or k == "router_bias" or k.startswith(
                    ("b", "f_b", "cross_b", "head_b")):
                a = 0.1 * a
            else:
                a = a / np.sqrt(_fan_in(k, shape))
            out[k] = a.astype(_np_dtype(v.dtype))
        return out

    return walk(shapes)


def trained(opt_state_shapes, seed: int):
    """A trained-looking optimizer state: moments (and AdaGrad sums)
    away from zero, so a step's update is a smooth function of the
    gradient (ROADMAP fault 21)."""
    rng = np.random.default_rng(seed)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        shape = tuple(tree.shape)
        if key == "m":
            a = 1e-3 * rng.standard_normal(shape)
        else:                               # v, embed_acc: positive
            a = 1e-4 * (1.0 + rng.random(shape))
        return a.astype(np.float32)

    return walk(opt_state_shapes)


def lm_tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def ctr_batch(cfg, b: int = 16) -> dict:
    rng = np.random.default_rng(7)
    off = np.concatenate([[0], np.cumsum(cfg.table_sizes)[:-1]])
    sparse = np.stack([rng.integers(0, n, b) for n in cfg.table_sizes],
                      1) + off
    return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(
                np.float32),
            "sparse": sparse.astype(np.int32),
            "label": (rng.random(b) > 0.5).astype(np.float32)}


def gnn_batch(args: dict, cfg, seed: int = 3) -> dict:
    """A batch of the cell's (padded) shapes: random edges, the last few
    padded (-1)."""
    rng = np.random.default_rng(seed)
    n, e = args["feats"].shape[0], args["senders"].shape[0]
    b = {"feats": rng.standard_normal((n, cfg.d_feat)).astype(np.float32),
         "pos": (2 * rng.standard_normal((n, 3))).astype(np.float32),
         "senders": rng.integers(0, n, e).astype(np.int32),
         "receivers": rng.integers(0, n, e).astype(np.int32)}
    b["senders"][-6:] = -1
    if "energy" in args:
        g = args["energy"].shape[0]
        b["graph_ids"] = np.repeat(np.arange(g), n // g).astype(np.int32)
        b["energy"] = rng.standard_normal(g).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, cfg.n_out, n).astype(np.int32)
        b["node_mask"] = (rng.random(n) > 0.2).astype(np.float32)
    return b


def lm_train_inputs(cell, vocab: int, seed: int = 1):
    """(state arrays, batch) of an LM train cell: the cell's batch shape
    (a leading microbatch axis where it accumulates)."""
    st = cell.args[0]
    shp = tuple(cell.args[1]["tokens"].shape)
    toks = lm_tokens(vocab, (int(np.prod(shp[:-1])), shp[-1] + 1), seed)
    batch = {"tokens": toks[:, :-1].reshape(shp),
             "labels": toks[:, 1:].reshape(shp)}
    return {"step": np.int32(START_STEP),
            "params": weights(st.params, 0),
            "opt_state": trained(st.opt_state, 5)}, batch


def ctr_train_inputs(cell):
    st = cell.args[0]
    return {"step": np.int32(START_STEP), "params": weights(st.params, 0),
            "opt_state": trained(st.opt_state, 5)}


# ------------------------------------------------------------- reference
_REF = """
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings; warnings.filterwarnings("ignore")
from functools import partial
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from test_torch_reference import reference_modules
import test_torch_sharded_models as C

out_path = sys.argv[1]
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
npy = lambda t: jax.tree.map(lambda a: np.asarray(a), t)
spec = lambda s: tuple((e,) if isinstance(e, str) else e for e in s.spec)
specs = lambda t: [spec(s) for s in jax.tree.leaves(
    t, is_leaf=lambda x: isinstance(x, NamedSharding))]
out = {}
with reference_modules() as ref:
    cells, T = ref.cells, ref.transformer
    TS = ref.loop.TrainState
    plan = ref.sharding.SINGLE_POD_PLAN.with_mesh(mesh)
    Shape = ref.configs_base.ShapeSpec
    get = ref.registry.get_arch
    T.set_precision(jnp.float32, jnp.float32)

    def put(x, sh):
        return jax.device_put(x, sh)

    def cell_specs(cell):
        return {"in": specs(cell.in_shardings),
                "out": specs(cell.out_shardings),
                "args": [tuple(a.shape) for a in jax.tree.leaves(cell.args)]}

    for name, arch in C.LM.items():
        cfg = C.lm_cfg(get, arch)
        shapes = C.lm_shapes(Shape)
        res = {}
        # train
        cell = cells.build_cell(cfg, "lm", plan, shapes["train"])
        res["train_specs"] = cell_specs(cell)
        st, batch = C.lm_train_inputs(cell, cfg.vocab)
        state = TS(jnp.int32(st["step"]), jax.tree.map(jnp.asarray,
                   st["params"]), jax.tree.map(jnp.asarray,
                   st["opt_state"]), None)
        f = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        new, aux = f(state, batch)
        res["train"] = {"aux": npy(aux), "params": npy(new.params),
                        "opt_state": npy(new.opt_state)}
        # prefill cell
        cell = cells.build_cell(cfg, "lm", plan, shapes["prefill"])
        res["prefill_specs"] = cell_specs(cell)
        p = C.weights(cell.args[0], 0)
        toks = C.lm_tokens(cfg.vocab, cell.args[1].shape, 2)
        f = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        lg, cache = f(jax.tree.map(jnp.asarray, p), toks)
        res["prefill"] = {"logits": np.asarray(lg), "cache": npy(
            jax.tree.map(lambda a: a.astype(jnp.float32), cache))}
        # decode cell: a prefill under its plan, then its steps
        cell = cells.build_cell(cfg, "lm", plan, shapes["decode"])
        res["decode_specs"] = cell_specs(cell)
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
        step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        logits = [np.asarray(lg)]
        for i in range(C.DECODE_STEPS):
            lg, cache = step(p, cache, toks[:, C.PROMPT + i:C.PROMPT + i + 1])
            logits.append(np.asarray(lg))
        res["decode"] = {"logits": logits}
        out[name] = res

    for name, arch in C.CTR.items():
        cfg = get(arch)[0].reduced()
        res = {}
        batch = C.ctr_batch(cfg)
        cell = cells.build_cell(cfg, "recsys", plan,
                                Shape("serve_p99", "serve", dict(batch=16)))
        res["serve_specs"] = cell_specs(cell)
        p = C.weights(cell.args[0], 0)
        f = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        sb = {k: batch[k] for k in ("dense", "sparse")}
        res["serve"] = np.asarray(f(jax.tree.map(jnp.asarray, p), sb))
        cell = cells.build_cell(cfg, "recsys", plan,
                                Shape("train_batch", "train", dict(batch=16)))
        res["train_specs"] = cell_specs(cell)
        st = C.ctr_train_inputs(cell)
        state = TS(jnp.int32(st["step"]), jax.tree.map(jnp.asarray,
                   st["params"]), jax.tree.map(jnp.asarray,
                   st["opt_state"]), None)
        f = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        new, aux = f(state, batch)
        res["train"] = {"aux": npy(aux), "params": npy(new.params),
                        "opt_state": npy(new.opt_state)}
        out[name] = res

    S = ref.schnet
    for kind in C.GNN:
        cfg = get("schnet")[0].reduced()
        cell = cells.build_cell(cfg, "gnn", plan, C.gnn_shape(Shape, kind))
        res = {"specs": cell_specs(cell)}
        st = C.ctr_train_inputs(cell)
        ccfg = dataclasses.replace(cfg, d_feat=C.GNN[kind][1]["d_feat"],
                                   n_out=16 if kind == "graph" else 1)
        batch = C.gnn_batch(cell.args[1], ccfg)
        for dt in ("bfloat16", "float32"):
            c32 = dataclasses.replace(ccfg, message_dtype=dt)
            opt = ref.optim.adamw(ref.optim.warmup_cosine(1e-3, 100, 10_000))
            stepf = ref.loop.make_train_step(partial(S.loss_fn, cfg=c32,
                                                     plan=plan), opt)
            state = TS(jnp.int32(st["step"]), jax.tree.map(
                jnp.asarray, st["params"]), jax.tree.map(
                jnp.asarray, st["opt_state"]), None)
            f = jax.jit(stepf, in_shardings=cell.in_shardings,
                        out_shardings=cell.out_shardings)
            new, aux = f(state, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
            res[dt] = {"aux": npy(aux), "params": npy(new.params),
                       "opt_state": npy(new.opt_state)}
        out["schnet_" + kind] = res
with open(out_path, "wb") as fh:
    pickle.dump(out, fh)
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.path.join(REPO, "tests")]))


# ----------------------------------------------------------------- ranks


def _port_cells(plan):
    """The port's cells of every case, under ``plan``."""
    from repro_torch.configs.base import ShapeSpec

    out = {}
    for name, arch in LM.items():
        cfg = lm_cfg(preg.get_arch, arch)
        shapes = lm_shapes(ShapeSpec)
        out[name] = {k: pcells.build_cell(cfg, "lm", plan, s)
                     for k, s in shapes.items()}
    for name, arch in CTR.items():
        cfg = preg.get_arch(arch)[0].reduced()
        out[name] = {
            "serve": pcells.build_cell(cfg, "recsys", plan, ShapeSpec(
                "serve_p99", "serve", dict(batch=16))),
            "train": pcells.build_cell(cfg, "recsys", plan, ShapeSpec(
                "train_batch", "train", dict(batch=16)))}
    for kind in GNN:
        cfg = preg.get_arch("schnet")[0].reduced()
        out["schnet_" + kind] = {"train": pcells.build_cell(
            cfg, "gnn", plan, gnn_shape(ShapeSpec, kind))}
    return out


def _whole(tree):
    """Every DTensor / tensor leaf gathered whole, as fp32 numpy (ints
    kept)."""
    from repro_torch.train.loop import TrainState

    if isinstance(tree, TrainState):
        return {"step": _whole(tree.step), "params": _whole(tree.params),
                "opt_state": _whole(tree.opt_state)}
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_whole(v) for v in tree]
    t = sharding.whole(tree).detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _run_cases(plan, dev, ckpt_dir=None) -> dict:
    """Every case through the port's cells under ``plan`` (a mesh or
    none); with ``ckpt_dir`` the qwen3 train state is saved there after
    its step and restored again into its own placements."""
    from functools import partial

    from repro_torch.models import schnet as PS
    from repro_torch.models import transformer as PT
    from repro_torch.train import checkpoint as PC
    from repro_torch.train import optim as PO
    from repro_torch.train.loop import TrainState, make_train_step

    def state_of(cell, st):
        return cell.place((TrainState(
            step=torch.tensor(int(st["step"]), dtype=torch.int32),
            params=_tensors(st["params"]), opt_state=_tensors(
                st["opt_state"]), ef_buf=None),), dev)[0]

    out = {}
    cs = _port_cells(plan)
    PT.set_precision(torch.float32, torch.float32)
    try:
        for name in LM:
            c = cs[name]
            res = {}
            st, batch = lm_train_inputs(c["train"], c["train"].cfg.vocab)
            state, bt = state_of(c["train"], st), c["train"].place(
                (None, batch), dev)[1]
            new, aux = c["train"].step_fn(state, bt)
            res["train"] = {"aux": _whole(aux), "params": _whole(new.params),
                            "opt_state": _whole(new.opt_state)}
            if ckpt_dir is not None and name == "qwen3":
                PC.save(ckpt_dir, 1, new)
                back = PC.restore(ckpt_dir, 1, new)
                res["restored"] = _whole(back)
                res["saved"] = _whole(new)
            cell = c["prefill"]
            p = weights(cell.args[0], 0)
            toks = lm_tokens(cell.cfg.vocab, tuple(cell.args[1].shape), 2)
            lg, cache = cell.step_fn(*cell.place((_tensors(p), toks), dev))
            res["prefill"] = {"logits": _whole(lg), "cache": _whole(cache)}
            cell = c["decode"]
            p = cell.place((_tensors(weights(cell.args[0], 0)),), dev)[0]
            b = cell.args[2].shape[0]
            toks = lm_tokens(cell.cfg.vocab, (b, PROMPT + DECODE_STEPS), 4)
            tk = cell.place((None, None, toks[:, :PROMPT]), dev)[2]
            lg, cache = PT.prefill(p, tk, cell.cfg, cell.plan,
                                   max_len=MAX_LEN)
            logits = [_whole(lg)]
            for i in range(DECODE_STEPS):
                t1 = cell.place((None, None,
                                 toks[:, PROMPT + i:PROMPT + i + 1]), dev)[2]
                lg, cache = cell.step_fn(p, cache, t1)
                logits.append(_whole(lg))
            res["decode"] = {"logits": logits}
            out[name] = res
        for name in CTR:
            c = cs[name]
            res = {}
            batch = ctr_batch(c["serve"].cfg)
            cell = c["serve"]
            sb = {k: batch[k] for k in ("dense", "sparse")}
            res["serve"] = _whole(cell.step_fn(*cell.place(
                (_tensors(weights(cell.args[0], 0)), sb), dev)))
            cell = c["train"]
            new, aux = cell.step_fn(state_of(cell, ctr_train_inputs(cell)),
                                    cell.place((None, batch), dev)[1])
            res["train"] = {"aux": _whole(aux), "params": _whole(new.params),
                            "opt_state": _whole(new.opt_state)}
            out[name] = res
        for kind in GNN:
            cell = cs["schnet_" + kind]["train"]
            batch = gnn_batch(cell.args[1], cell.cfg)
            res = {}
            for dt in ("bfloat16", "float32"):
                c32 = dataclasses.replace(cell.cfg, message_dtype=dt)
                opt = PO.adamw(PO.warmup_cosine(1e-3, 100, 10_000))
                step = make_train_step(partial(PS.loss_fn, cfg=c32,
                                               plan=cell.plan), opt)
                new, aux = step(state_of(cell, ctr_train_inputs(cell)),
                                cell.place((None, batch), dev)[1])
                res[dt] = {"aux": _whole(aux), "params": _whole(new.params),
                           "opt_state": _whole(new.opt_state)}
            out["schnet_" + kind] = res
    finally:
        PT.set_precision()
    return out


def _optimizer_cases(plan) -> dict:
    """Adafactor and AdamW applied in place (``optim.apply_in_place``, the
    train step's update) to qwen3's reduced parameters placed by
    their specs (Adafactor's factored dims sharded over the mesh on
    several leaves), with numpy-made gradients placed as the parameters;
    and the converters' ``plan=`` (the whole values back bit for bit)."""
    from repro_torch import convert
    from repro_torch.models import transformer as PT
    from repro_torch.train import optim as PO

    cfg = lm_cfg(preg.get_arch, "qwen3-0.6b")
    specs = PT.param_specs(cfg, plan)
    arrays = weights(PT.param_shapes(cfg, plan), 0)
    grads = weights(PT.param_shapes(cfg, plan), 9)
    out = {}
    for name, opt in (("adafactor", PO.adafactor(PO.constant_lr(1e-2),
                                                 min_dim_factored=8)),
                      ("adamw", PO.adamw(PO.constant_lr(1e-2)))):
        p = convert.lm_params_from_arrays(arrays, cfg, "cpu", plan)
        g = pcells.place_tree(plan, _tensors(grads), specs, "cpu")
        state = opt.init(p)
        PO.apply_in_place(opt, g, state, p, torch.tensor(7))
        out[name] = {"params": _whole(p), "state": _whole(state)}
    p = convert.lm_params_from_arrays(arrays, cfg, "cpu", plan)
    out["converted"] = _whole(p)
    st = convert.train_state_from_arrays(
        {"step": np.int32(3), "params": arrays,
         "opt_state": trained(PO.adamw(PO.constant_lr(1.0)).init(
             PT.param_shapes(cfg)), 5)}, cfg, PO.adamw(PO.constant_lr(1.0)),
        "cpu", plan)
    out["state"] = _whole(st)
    out["arrays"] = arrays
    return out


def _tensors(tree):
    """numpy (bf16 ``ml_dtypes`` too) -> torch, the structure kept."""
    from repro_torch.convert import _leaf_tensor

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    a = np.asarray(tree)
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else \
        torch.from_numpy(np.zeros(0, a.dtype)).dtype
    return _leaf_tensor(a, dt, "cpu")


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
        sharding.REDISTRIBUTES.clear()
        out = {"sharded": _run_cases(plan, "cpu",
                                     os.path.join(workdir, "ckpt")),
               "moves": dict(sharding.REDISTRIBUTES),
               "optim": _optimizer_cases(plan)}
        if rank == 0:
            out["one_card"] = _run_cases(sharding.LOCAL_PLAN, "cpu")
            out["optim_one_card"] = _optimizer_cases(sharding.LOCAL_PLAN)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 gloo ranks, run side by side;
    ``{"ref": ..., "ranks": [...], "ckpt": dir}``."""
    workdir = str(tmp_path_factory.mktemp("sharded_models"))
    ref_path = os.path.join(workdir, "ref.pkl")
    ref = subprocess.Popen([sys.executable, "-c", _REF, ref_path],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=_env(), cwd=REPO)
    code = textwrap.dedent(f"""
        import sys
        from test_torch_sharded_models import _rank_main
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
    return {"ref": refs, "ranks": ranks, "ckpt": os.path.join(workdir,
                                                              "ckpt")}


# --------------------------------------------------------------- helpers


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _close_leaves(mine, theirs, tol=LEAF_TOL):
    """Every leaf within ``tol`` of its max (and a floor) of the other."""
    a, b = _leaves(mine), _leaves(theirs)
    assert [p for p, _ in a] == [p for p, _ in b]
    worst = 0.0
    for (path, x), (_, y) in zip(a, b):
        x, y = _f32(x), _f32(y)
        assert x.shape == y.shape, path
        scale = max(float(np.abs(y).max(initial=0.0)), 1e-6)
        err = float(np.abs(x - y).max(initial=0.0)) / scale
        worst = max(worst, err)
        assert err <= tol, f"{path}: {err} of the leaf's max"
    return worst


def _bits(a, b):
    for (p, x), (q, y) in zip(_leaves(a), _leaves(b)):
        assert p == q
        x, y = np.atleast_1d(x), np.atleast_1d(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), p


def _logits(mine, theirs):
    a, b = _f32(mine), _f32(theirs)
    assert a.shape == b.shape
    bound = TOL["atol"] * max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= bound
    assert np.array_equal(a.argmax(-1), b.argmax(-1))


def _aux(mine, theirs):
    assert set(mine) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(_f32(mine[k]), _f32(theirs[k]), **TOL,
                                   err_msg=k)


def _rel_l2(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _spec_leaves(tree) -> list:
    """A port spec tree's leaves in the reference's pytree order
    (TrainState fields in order, dict keys sorted, ``None`` dropped)."""
    from repro_torch.train.loop import TrainState

    if isinstance(tree, TrainState):
        return [s for f in (tree.step, tree.params, tree.opt_state,
                            tree.ef_buf) for s in _spec_leaves(f)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if pcells._is_spec(tree):
        return [tuple(tree)]
    return [s for t in tree for s in _spec_leaves(t)]


def _meta_leaves(tree) -> list:
    from repro_torch.train.loop import TrainState

    if isinstance(tree, TrainState):
        return [s for f in (tree.step, tree.params, tree.opt_state,
                            tree.ef_buf) for s in _meta_leaves(f)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _meta_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t in tree for s in _meta_leaves(t)]
    return [tuple(tree.shape)]


class _Mesh:
    """A mesh's shape for both packages' plans."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.shape = dict(zip(names, shape))


def _spec(p) -> tuple:
    return tuple((e,) if isinstance(e, str) else e for e in p)


# ------------------------------------------------------------ arithmetic
ROLE_DIMS = ["dp", "fsdp", "tp", "ep", "pp", None, ("dp", "tp"),
             ("pp", "ep"), ("pp", "dp")]
MESHES = {"single": ((2, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}
PLANS = ["SINGLE_POD_PLAN", "MULTI_POD_PLAN", "LOCAL_PLAN"]


@pytest.mark.parametrize("plan,mesh", [
    (p, m) for p in PLANS for m in MESHES
    if not (p == "MULTI_POD_PLAN" and m == "single")])
def test_placements_match_the_reference_specs(reference, plan, mesh):
    """``Shard(d)`` on exactly the mesh dims of dim ``d``'s axes in the
    reference's ``p()``, each axis tuple in mesh order, so DTensor's
    nesting (first mesh dim outermost) is the reference's ``P((a, b))``
    layout."""
    from torch.distributed.tensor import Replicate, Shard

    shape, names = MESHES[mesh]
    m = _Mesh(shape, names)
    mine = getattr(sharding, plan).with_mesh(m)
    theirs = getattr(reference.sharding, plan).with_mesh(m)
    for d in ROLE_DIMS:
        for dims in ((d,), (d, None), (None, d)):
            spec = _spec(theirs.p(*dims))
            assert mine.p(*dims) == spec
            pl = mine.placements(*dims)
            assert len(pl) == len(names)
            for i, axis in enumerate(names):
                want = [j for j, e in enumerate(spec) if e and axis in e]
                assert pl[i] == (Shard(want[0]) if want else Replicate())
            for e in spec:
                if e:
                    at = [names.index(a) for a in e]
                    assert at == sorted(at), (d, e)


def test_regions_are_plain_calls_without_a_mesh():
    """With no mesh bound the one code path is the plain one: no
    placements, no move, the region's function on the values as they
    are, a stacked layer a plain index."""
    plan = sharding.SINGLE_POD_PLAN
    x = torch.arange(12.0).reshape(3, 4)
    assert plan.layout("dp", None) is None
    assert sharding.move(x, plan.layout("dp", None)) is x
    assert plan.constrain(x, "dp", None) is x
    got = sharding.local_region(None, lambda a, b: a * b,
                                [(x, None), (x, None)], None)
    assert torch.equal(got, x * x)
    assert torch.equal(sharding.layer_of(x, 1), x[1])
    assert sharding.local(x) is x and sharding.local_offset(x) == (0, 0)


def test_a_tuple_against_mesh_order_is_refused(reference):
    """No plan role lists its axes against mesh order; a composite dim
    that does (("ep", "pp") on the pod mesh: ("data", "model", "pod"))
    has no plain ``Shard`` layout equal to the reference's and raises."""
    m = _Mesh(*MESHES["multi"])
    plan = sharding.MULTI_POD_PLAN.with_mesh(m)
    assert _spec(reference.sharding.MULTI_POD_PLAN.with_mesh(m).p(
        ("ep", "pp"))) == (("data", "model", "pod"),)
    with pytest.raises(ValueError, match="against the mesh's order"):
        plan.placements(("ep", "pp"))
    with pytest.raises(ValueError, match="bound mesh"):
        sharding.SINGLE_POD_PLAN.placements("dp")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_model_spec_has_placements(mesh):
    """Every parameter, cache and optimizer-state spec of every model
    becomes placements on both meshes (each role in mesh order)."""
    from repro_torch.models import recsys as PR
    from repro_torch.models import schnet as PS
    from repro_torch.models import transformer as PT
    from repro_torch.train import optim as PO

    m = _Mesh(*MESHES[mesh])
    plan = (sharding.MULTI_POD_PLAN if mesh == "multi" else
            sharding.SINGLE_POD_PLAN).with_mesh(m)
    n = 0
    for arch in ["qwen3-0.6b", "qwen3-14b", "granite-34b",
                 "deepseek-v3-671b", "kimi-k2-1t-a32b", "dlrm-mlperf",
                 "dcn-v2", "din", "sasrec", "schnet"]:
        cfg, fam = preg.get_arch(arch)
        mod = {"lm": PT, "recsys": PR, "gnn": PS}[fam]
        specs = mod.param_specs(cfg, plan)
        shapes = mod.param_shapes(cfg, plan)
        trees = [specs, PO.state_specs(PO.adafactor(PO.constant_lr(1.0)),
                                       specs, shapes)]
        if fam == "lm":
            trees.append(PT.cache_specs(cfg, plan))
        for t in trees:
            for s in _spec_leaves(t):
                assert len(plan.spec_placements(s)) == len(m.mesh_dim_names)
                n += 1
    assert n > 400


LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-14b",
                                  "deepseek-v3-671b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_lm_config_moe_plan_and_optimizer_match_reference(reference, arch,
                                                          mesh):
    m = _Mesh(*MESHES[mesh])
    name = "MULTI_POD_PLAN" if mesh == "multi" else "SINGLE_POD_PLAN"
    mine = getattr(sharding, name).with_mesh(m)
    theirs = getattr(reference.sharding, name).with_mesh(m)
    pcfg, rcfg = preg.get_arch(arch)[0], reference.registry.get_arch(arch)[0]
    rc = reference.cells
    pp_, rp_ = pcells._moe_plan(pcfg, mine), rc._moe_plan(rcfg, theirs)
    assert dataclasses.astuple(pp_)[:5] == dataclasses.astuple(rp_)[:5]
    for sname in LM_SHAPES:
        a = pcells.lm_config_for_mesh(pcfg, pp_, preg.get_shape("lm", sname))
        b = rc.lm_config_for_mesh(rcfg, rp_,
                                  reference.registry.get_shape("lm", sname))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for dt in ("float32", "bfloat16"):
        po = pcells._lm_optimizer(dataclasses.replace(pcfg, param_dtype=dt))
        ro = rc._lm_optimizer(dataclasses.replace(rcfg, param_dtype=dt))
        assert po.name == ro.name == ("adafactor" if dt == "bfloat16"
                                      else "adamw")


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 16, 16)])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b"])
def test_moe_plan_widens_ep_across_pods_as_the_reference(reference, arch,
                                                          shape):
    """Expert parallelism takes the pod axis where the padded experts
    divide the whole mesh: kimi's 512 over 8 and 512 ranks, deepseek's
    256 over 8 only."""
    m = _Mesh(shape, ("pod", "data", "model"))
    mine = pcells._moe_plan(preg.get_arch(arch)[0],
                            sharding.MULTI_POD_PLAN.with_mesh(m))
    theirs = reference.cells._moe_plan(
        reference.registry.get_arch(arch)[0],
        reference.sharding.MULTI_POD_PLAN.with_mesh(m))
    assert (mine.ep, mine.pp) == (theirs.ep, theirs.pp)
    widened = preg.get_arch(arch)[0].moe.e_pad % int(np.prod(shape)) == 0
    assert mine.ep == (("pod", "data", "model") if widened
                       else ("data", "model"))
    assert preg.get_arch("kimi-k2-1t-a32b")[0].moe.e_pad == 512


def test_cells_has_every_builder_of_the_reference(reference):
    import inspect

    theirs = {n for n, f in vars(reference.cells).items()
              if (inspect.isfunction(f) or inspect.isclass(f))
              and getattr(f, "__module__", "") == reference.cells.__name__}
    mine = {n for n in vars(pcells)}
    assert theirs <= mine, sorted(theirs - mine)


def test_cells_without_a_mesh_place_nothing():
    from repro_torch.configs.base import ShapeSpec

    cfg = lm_cfg(preg.get_arch, "qwen3-0.6b")
    cell = pcells.build_cell(cfg, "lm", sharding.SINGLE_POD_PLAN,
                             lm_shapes(ShapeSpec)["prefill"])
    assert cell.placements(cell.in_specs) is None
    p, t = cell.place((_tensors(weights(cell.args[0], 0)),
                       lm_tokens(cfg.vocab, (4, 16), 0)), "cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    logits, cache = cell.step_fn(p, t)
    assert tuple(logits.shape) == (4, cfg.vocab)


# ---------------------------------------------- the sharded steps, 4 ranks


def _ref_spec_list(entries):
    return [tuple(e) for e in entries]


@pytest.mark.parametrize("name,kind", [
    ("qwen3", "train"), ("qwen3", "prefill"), ("qwen3", "decode"),
    ("deepseek", "train"), ("deepseek", "prefill"), ("deepseek", "decode"),
    ("dlrm", "serve"), ("dlrm", "train"), ("dcn", "serve"), ("dcn", "train"),
    ("schnet_molecule", None), ("schnet_graph", None)])
def test_cell_specs_and_args_match_reference(runs, name, kind):
    """Each port cell's argument shapes and in / out specs, leaf for leaf
    in the reference's pytree order, equal the reference's."""
    m = sharding.SINGLE_POD_PLAN.with_mesh(_Mesh((2, 2),
                                                 ("data", "model")))
    cell = _port_cells(m)[name][kind or "train"]
    r = runs["ref"][name][f"{kind}_specs" if kind else "specs"]
    assert _meta_leaves(cell.args) == [tuple(s) for s in r["args"]]
    assert _spec_leaves(cell.in_specs) == _ref_spec_list(r["in"])
    assert _spec_leaves(cell.out_specs) == _ref_spec_list(r["out"])


def test_every_rank_gathers_the_same_values(runs):
    r0 = runs["ranks"][0]["sharded"]
    for r in runs["ranks"][1:]:
        _bits(r["sharded"], r0)


@pytest.mark.parametrize("name", list(LM))
def test_lm_train_step_matches_one_card_and_reference(runs, name):
    mine = runs["ranks"][0]["sharded"][name]["train"]
    one = runs["ranks"][0]["one_card"][name]["train"]
    ref = runs["ref"][name]["train"]
    for other in (one, ref):
        _aux(mine["aux"], other["aux"])
        _close_leaves(mine["params"], other["params"])
        _close_leaves(mine["opt_state"], other["opt_state"])


@pytest.mark.parametrize("name", list(LM))
def test_lm_prefill_cell_matches_one_card_and_reference(runs, name):
    mine = runs["ranks"][0]["sharded"][name]["prefill"]
    for other in (runs["ranks"][0]["one_card"][name]["prefill"],
                  runs["ref"][name]["prefill"]):
        _logits(mine["logits"], other["logits"])
        _close_leaves(mine["cache"], other["cache"], 1e-5)


@pytest.mark.parametrize("name", list(LM))
def test_lm_decode_cell_matches_one_card_and_reference(runs, name):
    """A prefill under the decode cell's plan (bf16 weights, no FSDP),
    then three decode steps of the cell: logits every step."""
    mine = runs["ranks"][0]["sharded"][name]["decode"]["logits"]
    for other in (runs["ranks"][0]["one_card"][name]["decode"]["logits"],
                  runs["ref"][name]["decode"]["logits"]):
        assert len(mine) == len(other) == DECODE_STEPS + 1
        for a, b in zip(mine, other):
            _logits(a, b)


@pytest.mark.parametrize("name", list(CTR))
def test_ctr_serve_and_sparse_train_match_one_card_and_reference(runs,
                                                                 name):
    mine = runs["ranks"][0]["sharded"][name]
    for other in (runs["ranks"][0]["one_card"][name], runs["ref"][name]):
        _logits(mine["serve"][:, None], _f32(other["serve"])[:, None])
        _aux(mine["train"]["aux"], other["train"]["aux"])
        _close_leaves(mine["train"]["params"], other["train"]["params"])
        _close_leaves(mine["train"]["opt_state"],
                      other["train"]["opt_state"])


@pytest.mark.parametrize("kind", list(GNN))
def test_schnet_train_step_matches_one_card_and_reference(runs, kind):
    """fp32 messages within the step tolerances; the cell's bf16 messages
    within the bf16 bound of ``test_torch_gnn_slice.py``."""
    name = "schnet_" + kind
    mine = runs["ranks"][0]["sharded"][name]
    for other in (runs["ranks"][0]["one_card"][name], runs["ref"][name]):
        _aux(mine["float32"]["aux"], other["float32"]["aux"])
        _close_leaves(mine["float32"]["params"], other["float32"]["params"])
        _close_leaves(mine["float32"]["opt_state"],
                      other["float32"]["opt_state"])
        for (p, a), (_, b) in zip(_leaves(mine["bfloat16"]["params"]),
                                  _leaves(other["bfloat16"]["params"])):
            assert _rel_l2(a, b) <= BF16_REL_L2, p
        np.testing.assert_allclose(_f32(mine["bfloat16"]["aux"]["loss"]),
                                   _f32(other["bfloat16"]["aux"]["loss"]),
                                   rtol=2 ** -4)


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_optimizers_update_sharded_leaves_as_whole_ones(runs, name):
    """The in-place update of placed leaves equals the one-card update:
    Adafactor's factored means and its update RMS over sharded dims (a
    partial sum over the mesh), AdamW's elementwise rule on each shard."""
    mine = runs["ranks"][0]["optim"][name]
    one = runs["ranks"][0]["optim_one_card"][name]
    _close_leaves(mine["params"], one["params"], 1e-6)
    _close_leaves(mine["state"], one["state"], 1e-6)
    for r in runs["ranks"][1:]:
        _bits(r["optim"][name], runs["ranks"][0]["optim"][name])


def test_converters_place_what_they_build(runs):
    o = runs["ranks"][0]["optim"]
    _bits(o["converted"], {k: v for k, v in _f32_tree(o["arrays"]).items()})
    assert int(o["state"]["step"]) == 3
    _bits(o["state"]["params"], _f32_tree(o["arrays"]))


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return _f32(tree)


def test_the_moves_include_the_expert_all_to_all(runs):
    moves = runs["ranks"][0]["moves"]
    assert moves.get("all_to_all", 0) > 0          # the MoE pair, the cache
    assert moves.get("all_gather", 0) > 0          # FSDP gathers
    assert moves.get("reduce_scatter", 0) > 0      # partial sums to shards


def test_sharded_checkpoint_restores_sharded_unsharded_and_in_reference(
        runs, reference):
    from repro_torch.train import checkpoint as PC

    r0 = runs["ranks"][0]["sharded"]["qwen3"]
    _bits(r0["restored"], r0["saved"])
    saved = r0["saved"]

    def template(tree):
        return {k: template(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else torch.from_numpy(
                np.zeros_like(tree))

    from repro_torch.train.loop import TrainState

    mine = PC.restore(runs["ckpt"], 1, TrainState(
        step=torch.zeros((), dtype=torch.int32),
        params=template(saved["params"]),
        opt_state=template(saved["opt_state"])))
    _bits(_whole(mine), saved)
    jnp = pytest.importorskip("jax.numpy")
    T = reference.loop.TrainState
    tmpl = T(jnp.zeros((), jnp.int32),
             {k: v for k, v in _jnp_tree(jnp, saved["params"]).items()},
             _jnp_tree(jnp, saved["opt_state"]), None)
    theirs = reference.checkpoint.restore(runs["ckpt"], 1, tmpl)
    got = {"step": np.asarray(theirs.step),
           "params": _np_tree(theirs.params),
           "opt_state": _np_tree(theirs.opt_state)}
    _bits(got, saved)


def _jnp_tree(jnp, tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(jnp, v) for k, v in tree.items()}
    return jnp.zeros(np.asarray(tree).shape, np.asarray(tree).dtype)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)

