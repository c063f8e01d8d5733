"""The cells of ``launch/cells.py`` that ``test_torch_sharded_models.py``
does not run over a mesh: the retrieval cell (DLRM, DCN-v2, DIN,
SASRec), DIN's and SASRec's serve and train cells, and the paper's ANN
cell (the bucket-sharded two-level search); and, for ``sharding.move``'s
uneven shards, qwen3-14b's decode cell (its one-token residual
sequence-sharded over tp) and a (5, 3, 7) value moved through every kind
of placement change.

One module-scoped spawn, in the pattern (and with the helpers) of
``test_torch_sharded_models.py``: the reference's ``build_cell`` steps
jitted on 4 fake XLA devices over an Auto ``(2, 2)`` mesh (ROADMAP fault
16) in one subprocess, beside 4 gloo ranks (a ``FileStore`` under the
test's tmp dir, 60 s group timeouts, joined within 300 s) running the
port's cells on a ``(2, 2)`` mesh.  Every rank gathers its outputs whole;
rank 0 also runs the port's unsharded step (the cell under
``LOCAL_PLAN``; for the ANN cell, the four shards' locals run in one
process and merged by ``_merge_gathered``, which is what the cell
computes).

The ANN cell runs a small ``AnnConfig`` (n 4,096, d 16, 64 clusters,
nprobe 8: 2 probes a shard) over buckets packed from a numpy seed (each
row in its nearest of 64 random centroids, -1 and zero rows past a
bucket's members).

Tolerances: ids exactly; logits and retrieval scores within 1e-5 of
their largest magnitude; distances to 1e-5 of ``|q|^2 + |x|^2`` (ROADMAP
faults 2 and 7, the bar of ``test_torch_sharded_slice.py``); train
aux 1e-5 and updated leaves within 1e-4 of each leaf's max (fault 21);
the ANN cell bit for bit against its one-process merge; every rank's
gathered value equal to rank 0's bit for bit.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_reference import REPO, reference  # noqa: F401  (fixture)
from test_torch_sharded_models import (DECODE_STEPS, MAX_LEN, PROMPT,
                                       RANK_LIMIT_S, REF_LIMIT_S,
                                       START_STEP, WORLD, _aux, _bits,
                                       _close_leaves, _env, _f32, _logits,
                                       _Mesh, _tensors, _whole, lm_cfg,
                                       lm_shapes, lm_tokens, trained,
                                       weights)

from repro_torch.configs import registry as preg
from repro_torch.distributed import sharding
from repro_torch.launch import cells as pcells

RECSYS = {"dlrm": "dlrm-mlperf", "dcn": "dcn-v2", "din": "din",
          "sasrec": "sasrec"}
DENSE = ("din", "sasrec")          # the archs whose serve / train cells run
N_CAND = 512                       # the retrieval cell pads to 512 at (2, 2)
BATCH = 16
ANN = dict(name="ann-small", n=4096, d=16, n_clusters=64, top="brute",
           bottom="brute", nprobe=8)
ANN_B, ANN_K = 32, 10
DIST_RTOL = 1e-5
SEQ_LM = "qwen3-14b"               # attn_shard "seq": a one-token residual
UNEVEN = (5, 3, 7)                 # over a (2, 2) mesh: no dim divides


# ---------------------------------------------------------------- cases
# (both processes build every input from these, with numpy)


def shapes(ShapeSpec) -> dict:
    return {"retrieval": ShapeSpec("retrieval_cand", "retrieval",
                                   dict(batch=1, n_candidates=N_CAND)),
            "serve": ShapeSpec("serve_p99", "serve", dict(batch=BATCH)),
            "train": ShapeSpec("train_batch", "train", dict(batch=BATCH)),
            "ann": ShapeSpec("serve_batch", "serve", dict(batch=ANN_B,
                                                          k=ANN_K))}


def _cfg(name: str):
    return preg.get_arch(RECSYS[name])[0].reduced()


def recsys_batch(name: str, seed: int = 3) -> dict:
    from repro_torch.data.recsys import batch_for

    return batch_for(_cfg(name), BATCH, step=seed)


def serve_inputs(name: str) -> dict:
    from repro_torch.data.recsys import serve_batch

    return serve_batch(_cfg(name), recsys_batch(name))


def retrieval_inputs(name: str) -> dict:
    """The first user against ``N_CAND`` candidates drawn from the items
    the reduced tables hold (DLRM / DCN: feature 0's rows)."""
    from repro_torch.data.recsys import retrieval_batch

    cfg = _cfg(name)
    n = cfg.table_sizes[0] if hasattr(cfg, "table_sizes") else cfg.n_items
    b = retrieval_batch(cfg, recsys_batch(name), N_CAND)
    cand = np.random.default_rng(11).integers(0, n, N_CAND).astype(np.int32)
    b["candidates"] = cand
    if "cand_cates" in b:
        b["cand_cates"] = (cand % cfg.n_cates).astype(np.int32)
    return b


def train_inputs(cell):
    st = cell.args[0]
    return {"step": np.int32(START_STEP), "params": weights(st.params, 0),
            "opt_state": trained(st.opt_state, 5)}


def ann_inputs(cell) -> tuple:
    """(cents, bucket_ids, bucket_vecs, queries) in the cell's shapes."""
    K, cap = cell.args[1].shape
    n, d = ANN["n"], ANN["d"]
    rng = np.random.default_rng(21)
    cents = np.zeros((K, d), np.float32)
    cents[:ANN["n_clusters"]] = 3 * rng.standard_normal(
        (ANN["n_clusters"], d))
    x = (cents[rng.integers(0, ANN["n_clusters"], n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    d2 = ((x[:, None, :] - cents[None, :ANN["n_clusters"]]) ** 2).sum(-1)
    home = d2.argmin(1)
    bids = np.full((K, cap), -1, np.int32)
    bvecs = np.zeros((K, cap, d), np.float32)
    for b in range(ANN["n_clusters"]):
        members = np.flatnonzero(home == b)[:cap]
        bids[b, :len(members)] = members
        bvecs[b, :len(members)] = x[members]
    q = (x[rng.integers(0, n, ANN_B)]
         + 0.1 * rng.standard_normal((ANN_B, d))).astype(np.float32)
    return cents, bids, bvecs, q


# ------------------------------------------------------------- reference
_REF = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings; warnings.filterwarnings("ignore")
import numpy as np
import jax
import jax.numpy as jnp
from test_torch_reference import reference_modules
import test_torch_sharded_cells as C

out_path = sys.argv[1]
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
npy = lambda t: jax.tree.map(lambda a: np.asarray(a), t)
out = {}
with reference_modules() as ref:
    cells = ref.cells
    TS = ref.loop.TrainState
    plan = ref.sharding.SINGLE_POD_PLAN.with_mesh(mesh)
    sh = C.shapes(ref.configs_base.ShapeSpec)
    get = ref.registry.get_arch

    def run(cell, *args):
        f = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        with mesh:
            return f(*args)

    for name, arch in C.RECSYS.items():
        cfg = get(arch)[0].reduced()
        res = {}
        cell = cells.build_cell(cfg, "recsys", plan, sh["retrieval"])
        p = jax.tree.map(jnp.asarray, C.weights(cell.args[0], 0))
        res["retrieval"] = npy(run(cell, p, C.retrieval_inputs(name)))
        if name in C.DENSE:
            cell = cells.build_cell(cfg, "recsys", plan, sh["serve"])
            res["serve"] = np.asarray(run(cell, p, C.serve_inputs(name)))
            cell = cells.build_cell(cfg, "recsys", plan, sh["train"])
            st = C.train_inputs(cell)
            state = TS(jnp.int32(st["step"]), jax.tree.map(
                jnp.asarray, st["params"]), jax.tree.map(
                jnp.asarray, st["opt_state"]), None)
            new, aux = run(cell, state, C.recsys_batch(name))
            res["train"] = {"aux": npy(aux), "params": npy(new.params),
                            "opt_state": npy(new.opt_state)}
        out[name] = res
    acfg = ref.configs_base.AnnConfig(**C.ANN)
    cell = cells.build_cell(acfg, "ann", plan, sh["ann"])
    out["ann"] = npy(run(cell, *C.ann_inputs(cell)))

    # qwen3-14b's decode cell: the residual's one token over tp
    import dataclasses
    T = ref.transformer
    T.set_precision(jnp.float32, jnp.float32)
    cfg = C.lm_cfg(get, C.SEQ_LM)
    shape = C.lm_shapes(ref.configs_base.ShapeSpec)["decode"]
    cell = cells.build_cell(cfg, "lm", plan, shape)
    p = jax.tree.map(jnp.asarray, C.weights(cell.args[0], 0))
    b = cell.args[2].shape[0]
    toks = C.lm_tokens(cfg.vocab, (b, C.PROMPT + C.DECODE_STEPS), 4)
    dplan = dataclasses.replace(cells._moe_plan(cfg, plan), fsdp=())
    dcfg = cells.lm_config_for_mesh(
        dataclasses.replace(cfg, param_dtype="bfloat16"), dplan, shape)
    pre = jax.jit(lambda p_, t_: T.prefill(p_, t_, dcfg, dplan,
                                           max_len=C.MAX_LEN),
                  in_shardings=(cell.in_shardings[0], cell.in_shardings[2]),
                  out_shardings=(cell.out_shardings[0],
                                 cell.out_shardings[1]))
    with mesh:
        lg, cache = pre(p, toks[:, :C.PROMPT])
        step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        logits = [np.asarray(lg)]
        for i in range(C.DECODE_STEPS):
            lg, cache = step(p, cache, toks[:, C.PROMPT + i:C.PROMPT + i + 1])
            logits.append(np.asarray(lg))
    out["decode_seq"] = logits
with open(out_path, "wb") as fh:
    pickle.dump(out, fh)
"""


# ----------------------------------------------------------------- ranks


def _port_cells(plan, ann: bool = True) -> dict:
    from repro_torch.configs.base import AnnConfig, ShapeSpec

    sh = shapes(ShapeSpec)
    out = {}
    for name, arch in RECSYS.items():
        cfg = preg.get_arch(arch)[0].reduced()
        kinds = ("retrieval", "serve", "train") if name in DENSE \
            else ("retrieval",)
        out[name] = {k: pcells.build_cell(cfg, "recsys", plan, sh[k])
                     for k in kinds}
    if ann:
        out["ann"] = pcells.build_cell(AnnConfig(**ANN), "ann", plan,
                                       sh["ann"])
    return out


def _ann_one_process(cell, inputs) -> tuple:
    """The cell's four shards' locals in one process, merged: what the
    cell computes over a (2, 2) mesh."""
    K = cell.args[1].shape[0]
    kl = K // WORLD
    nprobe_local = max(1, ANN["nprobe"] // WORLD)
    local = sharding.make_sharded_ivf_fn(ANN_K, nprobe_local, kl,
                                         ANN["n_clusters"])
    cents, bids, bvecs, q = (torch.as_tensor(a) for a in inputs)
    parts = [local(cents[s * kl:(s + 1) * kl], bids[s * kl:(s + 1) * kl],
                   bvecs[s * kl:(s + 1) * kl], q, lin=s)
             for s in range(WORLD)]
    d, i = sharding._merge_gathered(torch.stack([p[0] for p in parts]),
                                    torch.stack([p[1] for p in parts]),
                                    ANN_K)
    return d.numpy(), i.numpy()


def _run_cases(plan, dev) -> dict:
    """Every case through the port's cells under ``plan`` (a mesh or
    none), on weights and states in the (2, 2) mesh cells' shapes (SASRec
    pads its item table to a multiple of tp, so the one-card step takes
    the sharded step's weights)."""
    from repro_torch.train.loop import TrainState

    like = _port_cells(sharding.SINGLE_POD_PLAN.with_mesh(
        _Mesh((2, 2), ("data", "model"))), ann=False)
    out = {}
    for name, cs in _port_cells(plan).items():
        if name == "ann":
            out[name] = _whole(cs.step_fn(*cs.place(ann_inputs(cs), dev)))
            continue
        res = {}
        cell = cs["retrieval"]
        p = _tensors(weights(like[name]["retrieval"].args[0], 0))
        res["retrieval"] = _whole(cell.step_fn(*cell.place(
            (p, retrieval_inputs(name)), dev)))
        if name in DENSE:
            cell = cs["serve"]
            res["serve"] = _whole(cell.step_fn(*cell.place(
                (p, serve_inputs(name)), dev)))
            cell = cs["train"]
            st = train_inputs(like[name]["train"])
            state = cell.place((TrainState(
                step=torch.tensor(int(st["step"]), dtype=torch.int32),
                params=_tensors(st["params"]),
                opt_state=_tensors(st["opt_state"]), ef_buf=None),), dev)[0]
            new, aux = cell.step_fn(state, cell.place(
                (None, recsys_batch(name)), dev)[1])
            res["train"] = {"aux": _whole(aux), "params": _whole(new.params),
                            "opt_state": _whole(new.opt_state)}
        out[name] = res
    return out


def _decode_seq(plan, dev) -> list:
    """qwen3-14b (``attn_shard`` "seq") through the decode cell: a prefill
    under its plan, then its steps; the logits of each."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer as PT

    cfg = lm_cfg(preg.get_arch, SEQ_LM)
    cell = pcells.build_cell(cfg, "lm", plan, lm_shapes(ShapeSpec)["decode"])
    PT.set_precision(torch.float32, torch.float32)
    try:
        p = cell.place((_tensors(weights(cell.args[0], 0)),), dev)[0]
        b = cell.args[2].shape[0]
        toks = lm_tokens(cell.cfg.vocab, (b, PROMPT + DECODE_STEPS), 4)
        tk = cell.place((None, None, toks[:, :PROMPT]), dev)[2]
        lg, cache = PT.prefill(p, tk, cell.cfg, cell.plan, max_len=MAX_LEN)
        logits = [_whole(lg)]
        for i in range(DECODE_STEPS):
            t1 = cell.place((None, None,
                             toks[:, PROMPT + i:PROMPT + i + 1]), dev)[2]
            lg, cache = cell.step_fn(p, cache, t1)
            logits.append(_whole(lg))
    finally:
        PT.set_precision()
    return logits


def _uneven_moves(plan) -> dict:
    """A (5, 3, 7) value over the (2, 2) mesh, no dim dividing its mesh
    dims, moved through every kind of placement change: each layout's
    local shape (against DTensor's own) and the whole value after it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    x = torch.arange(int(np.prod(UNEVEN)), dtype=torch.float32).reshape(
        UNEVEN)
    t = plan.place(x, (("data",), ("model",), None))
    out = {"value": x.numpy(), "layouts": []}
    for want in ([Shard(1), Shard(0)], [Replicate(), Shard(2)],
                 [Shard(0), Shard(0)], [Shard(2), Shard(1)],
                 [Replicate(), Replicate()]):
        t = sharding.move(t, want)
        mine = tuple(t.to_local().shape)
        theirs = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)[0]
        out["layouts"].append((mine, tuple(theirs),
                               sharding.whole(t).numpy()))
    return out


def _rank_main(rank: int, world: int, workdir: str) -> None:
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
        plan = sharding.SINGLE_POD_PLAN.with_mesh(mesh)
        out = {"sharded": _run_cases(plan, "cpu"),
               "decode_seq": _decode_seq(plan, "cpu"),
               "uneven": _uneven_moves(plan)}
        if rank == 0:
            out["one_card"] = _run_cases(sharding.LOCAL_PLAN, "cpu")
            out["decode_seq_one_card"] = _decode_seq(sharding.LOCAL_PLAN,
                                                     "cpu")
            ann = _port_cells(plan)["ann"]
            out["ann_merge"] = _ann_one_process(ann, ann_inputs(ann))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 gloo ranks, side by side:
    ``{"ref": ..., "ranks": [...]}``."""
    workdir = str(tmp_path_factory.mktemp("sharded_cells"))
    ref_path = os.path.join(workdir, "ref.pkl")
    ref = subprocess.Popen([sys.executable, "-c", _REF, ref_path],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=_env(), cwd=REPO)
    code = textwrap.dedent(f"""
        import sys
        from test_torch_sharded_cells import _rank_main
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
    return {"ref": refs, "ranks": ranks}


# ----------------------------------------------------------------- tests


def test_every_rank_gathers_the_same_values(runs):
    r0 = runs["ranks"][0]["sharded"]
    for r in runs["ranks"][1:]:
        _bits(r["sharded"], r0)


@pytest.mark.parametrize("name", list(RECSYS))
def test_retrieval_cell_matches_one_card_and_reference(runs, name):
    """The top 100 of 512 candidates scored on their shards: the ids
    exactly, the scores within 1e-5 of their largest magnitude."""
    mine = runs["ranks"][0]["sharded"][name]["retrieval"]
    for other in (runs["ranks"][0]["one_card"][name]["retrieval"],
                  runs["ref"][name]["retrieval"]):
        _logits(_f32(mine[0])[None], _f32(other[0])[None])
        np.testing.assert_array_equal(np.asarray(mine[1]),
                                      np.asarray(other[1]))


@pytest.mark.parametrize("name", DENSE)
def test_serve_cell_matches_one_card_and_reference(runs, name):
    mine = runs["ranks"][0]["sharded"][name]["serve"]
    for other in (runs["ranks"][0]["one_card"][name]["serve"],
                  runs["ref"][name]["serve"]):
        _logits(_f32(mine)[:, None], _f32(other)[:, None])


@pytest.mark.parametrize("name", DENSE)
def test_train_cell_matches_one_card_and_reference(runs, name):
    """One AdamW step from a trained state, the batch over dp."""
    mine = runs["ranks"][0]["sharded"][name]["train"]
    for other in (runs["ranks"][0]["one_card"][name]["train"],
                  runs["ref"][name]["train"]):
        _aux(mine["aux"], other["aux"])
        _close_leaves(mine["params"], other["params"])
        _close_leaves(mine["opt_state"], other["opt_state"])


def test_ann_cell_matches_its_merge_and_reference(runs):
    """The bucket-sharded two-level search: each rank probes 2 of its 16
    buckets, the shards' top-10 gathered and merged.  Bit for bit the
    four locals merged in one process; the reference's ids exactly, its
    distances to 1e-5 of ``|q|^2 + |x|^2`` (ROADMAP faults 2 and 7: the
    expansion rounds on that scale, which the near-zero distance of a
    query to its own row shows)."""
    d, i = runs["ranks"][0]["sharded"]["ann"]
    md, mi = runs["ranks"][0]["ann_merge"]
    _bits([d, i], [md, mi])
    rd, ri = runs["ref"]["ann"]
    np.testing.assert_array_equal(i, np.asarray(ri))
    assert (i >= 0).all() and d.shape == (ANN_B, ANN_K)
    _, bids, bvecs, q = ann_inputs(_port_cells(sharding.LOCAL_PLAN)["ann"])
    xn = np.zeros(ANN["n"])
    xn[bids[bids >= 0]] = (bvecs.astype(np.float64) ** 2).sum(-1)[bids >= 0]
    scale = (q.astype(np.float64) ** 2).sum(1)[:, None] + xn[i]
    assert (np.abs(d - _f32(rd)) <= DIST_RTOL * scale).all()


def test_ann_cell_without_a_mesh_is_one_shard(runs):
    """Under ``LOCAL_PLAN`` the cell is one shard probing all 8 of its
    buckets: a different search, but every answer a live id."""
    d, i = runs["ranks"][0]["one_card"]["ann"]
    assert d.shape == (ANN_B, ANN_K) and (i >= 0).all()
    assert np.all(np.diff(d, axis=1) >= 0)


def test_seq_sharded_decode_matches_one_card_and_reference(runs):
    """qwen3-14b's residual is sequence-sharded over tp, so in decode its
    one token lies over two ranks, one of them empty (DTensor's chunks;
    the reference's padded layout): a prefill and three decode steps,
    the logits every step."""
    mine = runs["ranks"][0]["decode_seq"]
    for other in (runs["ranks"][0]["decode_seq_one_card"],
                  runs["ref"]["decode_seq"]):
        assert len(mine) == len(other) == DECODE_STEPS + 1
        for a, b in zip(mine, other):
            _logits(a, b)
    for r in runs["ranks"][1:]:
        _bits(r["decode_seq"], mine)


def test_uneven_moves_keep_the_value(runs):
    """Every move of the (5, 3, 7) value leaves each rank DTensor's own
    chunk shape and the whole value unchanged, bit for bit."""
    for r in runs["ranks"]:
        u = r["uneven"]
        for mine, theirs, whole in u["layouts"]:
            assert mine == theirs
            _bits([whole], [u["value"]])
    shapes = {r["uneven"]["layouts"][0][0] for r in runs["ranks"]}
    assert len(shapes) > 1                 # the ranks' chunks differ
