"""Cell builders: (arch x shape x plan) -> a step over placed arguments --
the port of ``repro/launch/cells.py``.

For every cell this module produces a :class:`CellSpec`:

  step_fn        : the step, called on the port's placed arguments
  args           : the arguments' ``meta`` tensors (shape and dtype, no
                   storage), in the reference's pytree layout
  in_specs       : the ``ShardPlan.p`` tuples of each argument leaf (the
                   content of the reference's ``in_shardings``)
  out_specs      : the same for the outputs
  cfg, plan      : the config and plan the step runs under (bound to the
                   mesh: ``lm_config_for_mesh``, ``_moe_plan``, the decode
                   cell's ``fsdp=()`` and bf16 weights)

``CellSpec.placements`` turns a spec tree into DTensor placements and
``CellSpec.place`` places whole values (numpy or tensors, the same on
every rank) by ``in_specs``, so a caller builds the inputs once and each
rank keeps its shards.  With no mesh bound the specs are still the
reference's, the placements are ``None`` and ``place`` moves the values
unplaced to the device.

Where the reference hands ``jit`` its ``donate`` arguments, the port's
train steps update the state in place (``make_train_step``): the state
passed in is consumed.  ``launch/dryrun.py`` runs every cell's step on
its ``meta`` arguments as one rank of a fake process group, and
``launch/step_analysis.py`` accounts for it: the counterparts of the
reference's lowering and compile and of ``hlo_analysis.py``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import (AnnConfig, DCNConfig, DINConfig,
                                      DLRMConfig, LMConfig, SASRecConfig,
                                      SchNetConfig, ShapeSpec)
from repro_torch.distributed.sharding import ShardPlan
from repro_torch.models import recsys as R
from repro_torch.models import schnet as S
from repro_torch.models import transformer as T
from repro_torch.train import optim
from repro_torch.train.loop import TrainState, make_train_step

__all__ = ["build_cell", "CellSpec", "lm_config_for_mesh",
           "build_fleet_cells", "place_tree"]


def _is_spec(x) -> bool:
    """A spec leaf: ``p``'s tuple of per-dim axis tuples (or ``None``)."""
    return isinstance(x, tuple) and all(
        e is None or (isinstance(e, tuple)
                      and all(isinstance(a, str) for a in e)) for e in x)


def _map_spec(fn, spec, *rest):
    """``fn(spec_leaf, *leaves)`` along a spec tree (dicts, TrainStates;
    ``None`` subtrees stay ``None``)."""
    if isinstance(spec, TrainState):
        return TrainState(*[_map_spec(fn, s, *[getattr(r, f.name)
                                               for r in rest])
                            for s, f in zip(
                                (spec.step, spec.params, spec.opt_state,
                                 spec.ef_buf),
                                dataclasses.fields(TrainState))])
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v, *(r[k] for r in rest))
                for k, v in spec.items()}
    if spec is None and not rest:
        return None
    if spec is None and all(r is None for r in rest):
        return None
    if not _is_spec(spec):
        return type(spec)(_map_spec(fn, s, *(r[i] for r in rest))
                          for i, s in enumerate(spec))
    return fn(spec, *rest)


def _shard_tree(plan: ShardPlan, spec_tree):
    """A spec tree's DTensor placements over ``plan``'s mesh (the
    reference's ``NamedSharding`` tree)."""
    return _map_spec(plan.spec_placements, spec_tree)


def place_tree(plan: ShardPlan, values, specs, device=None):
    """Every leaf of ``values`` (numpy or tensor, the whole value) on
    ``device`` and placed over ``plan``'s mesh by its spec."""
    def one(spec, x):
        t = torch.as_tensor(x, device=device)
        return plan.place(t, spec)
    return _map_spec(one, specs, values)


@dataclasses.dataclass
class CellSpec:
    step_fn: Any
    args: tuple
    in_specs: tuple
    out_specs: Any
    cfg: Any = None
    plan: Any = None
    donate: tuple = ()
    note: str = ""

    def placements(self, specs):
        """A spec tree's DTensor placements (``None`` with no mesh)."""
        if self.plan.mesh is None:
            return None
        return _shard_tree(self.plan, specs)

    def place(self, values: tuple, device=None) -> tuple:
        """``values`` (one entry an argument; ``None`` skips one) placed by
        ``in_specs``."""
        return tuple(None if v is None else
                     place_tree(self.plan, v, s, device)
                     for v, s in zip(values, self.in_specs))


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def lm_config_for_mesh(cfg: LMConfig, plan: ShardPlan,
                       shape: ShapeSpec) -> LMConfig:
    """Bind the distribution knobs to the mesh, as the reference: MoE
    dispatch groups = dp, the chunked attention at 4K+ train / prefill
    sequences, the sequence-sharded residual for whole-sequence shapes
    (decode keeps the arch's), remat for training."""
    dp = max(plan.axis_size("dp"), 1)
    seq = shape["seq"]
    chunk = 0
    if shape.kind in ("train", "prefill") and seq >= 4096:
        chunk = min(1024, seq // 4)
    attn_shard = "seq" if shape.kind in ("train", "prefill") \
        else cfg.attn_shard
    return dataclasses.replace(
        cfg,
        moe_groups=dp if cfg.moe else 1,
        attn_chunk=chunk,
        attn_shard=attn_shard,
        scan_layers=True,
        remat=shape.kind == "train",
    )


def _lm_optimizer(cfg: LMConfig):
    # giants: Adafactor (factored second moment) over bf16 parameters
    if cfg.param_dtype == "bfloat16":
        return optim.adafactor(optim.warmup_cosine(1e-4, 2000, 100_000))
    return optim.adamw(optim.warmup_cosine(3e-4, 2000, 100_000))


def _moe_plan(cfg: LMConfig, plan: ShardPlan) -> ShardPlan:
    """Widen expert parallelism across pods when the padded experts
    divide the whole mesh (kimi: 512 experts over 512 ranks)."""
    if cfg.moe and plan.pp:
        full = plan.size_of(("pp", "ep"))
        if cfg.moe.e_pad % full == 0:
            return dataclasses.replace(plan, ep=plan.pp + plan.ep, pp=())
    return plan


def _state_specs(opt, p_specs, p_shapes):
    return TrainState(step=(), params=p_specs,
                      opt_state=optim.state_specs(opt, p_specs, p_shapes),
                      ef_buf=None)


def _state_shapes(opt, p_shapes):
    return TrainState(step=torch.empty((), dtype=torch.int32,
                                       device="meta"),
                      params=p_shapes, opt_state=opt.init(p_shapes),
                      ef_buf=None)


def _lm_train_cell(cfg: LMConfig, plan: ShardPlan, shape: ShapeSpec):
    plan = _moe_plan(cfg, plan)
    cfg = lm_config_for_mesh(cfg, plan, shape)
    b, s = shape["batch"], shape["seq"]
    opt = _lm_optimizer(cfg)
    p_shapes = T.param_shapes(cfg, plan)
    p_specs = T.param_specs(cfg, plan)
    accum = max(1, cfg.grad_accum)
    if accum > 1:
        # microbatched: a leading accum axis, looped inside the step
        assert b % accum == 0, (b, accum)
        bshape = (accum, b // accum, s)
        bspec = plan.p(None, "dp", None)
    else:
        bshape = (b, s)
        bspec = plan.p("dp", None)
    batch_sds = {k: torch.empty(bshape, dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
    batch_spec = {"tokens": bspec, "labels": bspec}
    loss = partial(T.loss_fn, cfg=cfg, plan=plan)
    step = make_train_step(loss, opt, accum=accum)
    aux_spec = {"nll": (), "accuracy": (), "loss": (), "grad_norm": ()}
    if cfg.mtp:
        aux_spec["mtp_nll"] = ()
    state_spec = _state_specs(opt, p_specs, p_shapes)
    return CellSpec(
        step_fn=step,
        args=(_state_shapes(opt, p_shapes), batch_sds),
        in_specs=(state_spec, batch_spec),
        out_specs=(state_spec, aux_spec),
        cfg=cfg, plan=plan, donate=(0,),
    )


def _lm_prefill_cell(cfg: LMConfig, plan: ShardPlan, shape: ShapeSpec):
    plan = _moe_plan(cfg, plan)
    cfg = lm_config_for_mesh(cfg, plan, shape)
    b, s = shape["batch"], shape["seq"]

    def step(params, tokens):
        return T.prefill(params, tokens, cfg, plan)

    return CellSpec(
        step_fn=step,
        args=(T.param_shapes(cfg, plan),
              torch.empty((b, s), dtype=torch.int32, device="meta")),
        in_specs=(T.param_specs(cfg, plan), plan.p("dp", None)),
        out_specs=(plan.p("dp", "tp"), T.cache_specs(cfg, plan)),
        cfg=cfg, plan=plan,
    )


def _lm_decode_cell(cfg: LMConfig, plan: ShardPlan, shape: ShapeSpec):
    # serving plan: no FSDP (the weights stay resident, tp/ep-sharded,
    # rather than gathered for every generated token), bf16 weights
    plan = dataclasses.replace(_moe_plan(cfg, plan), fsdp=())
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    cfg = lm_config_for_mesh(cfg, plan, shape)
    b, s = shape["batch"], shape["seq"]

    def step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg, plan)

    cache_spec = T.cache_specs(cfg, plan)
    return CellSpec(
        step_fn=step,
        args=(T.param_shapes(cfg, plan), T.cache_shapes(cfg, b, s),
              torch.empty((b, 1), dtype=torch.int32, device="meta")),
        in_specs=(T.param_specs(cfg, plan), cache_spec,
                  plan.p("dp", None)),
        out_specs=(plan.p("dp", "tp"), cache_spec),
        cfg=cfg, plan=plan, donate=(1,),
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _gnn_cell(cfg: SchNetConfig, plan: ShardPlan, shape: ShapeSpec):
    n_dev = plan.axis_size("dp") * plan.axis_size("tp")
    dims = shape.dims
    d_feat = dims.get("d_feat", cfg.d_feat)
    cfg = dataclasses.replace(
        cfg, d_feat=d_feat,
        n_out=16 if "batch" not in dims else 1,
        message_dtype="bfloat16",
    )
    if shape.name == "minibatch_lg":
        # padded sampled-subgraph sizes (seeds x fanout closure)
        bn = dims["batch_nodes"]
        f1, f2 = dims["fanout"]
        n_nodes = _pad_to(bn * (1 + f1) + bn * f1 * f2, 256)
        n_edges = _pad_to(bn * f1 + bn * f1 * f2, max(256, n_dev))
        n_graphs = None
    elif shape.name == "molecule":
        g = dims["batch"]
        n_nodes = g * dims["n_nodes"]
        n_edges = _pad_to(g * dims["n_edges"], max(256, n_dev))
        n_graphs = g
    else:
        n_nodes = dims["n_nodes"]
        n_edges = _pad_to(dims["n_edges"], max(256, n_dev))
        n_graphs = None

    edge_spec = plan.p(("dp", "tp"))
    batch_sds = {
        "feats": _meta((n_nodes, d_feat), torch.float32),
        "pos": _meta((n_nodes, 3), torch.float32),
        "senders": _meta((n_edges,), torch.int32),
        "receivers": _meta((n_edges,), torch.int32),
    }
    batch_spec = {"feats": plan.p(None, None), "pos": plan.p(None, None),
                  "senders": edge_spec, "receivers": edge_spec}
    if n_graphs is not None:
        batch_sds["graph_ids"] = _meta((n_nodes,), torch.int32)
        batch_sds["energy"] = _meta((n_graphs,), torch.float32)
        batch_spec["graph_ids"] = plan.p(None)
        batch_spec["energy"] = plan.p(None)
    else:
        batch_sds["labels"] = _meta((n_nodes,), torch.int32)
        batch_sds["node_mask"] = _meta((n_nodes,), torch.float32)
        batch_spec["labels"] = plan.p(None)
        batch_spec["node_mask"] = plan.p(None)

    opt = optim.adamw(optim.warmup_cosine(1e-3, 100, 10_000))
    p_shapes = S.param_shapes(cfg, plan)
    p_specs = S.param_specs(cfg, plan)
    state_spec = _state_specs(opt, p_specs, p_shapes)
    loss = partial(S.loss_fn, cfg=cfg, plan=plan)
    step = make_train_step(loss, opt)
    aux_keys = ["loss", "grad_norm"] + (
        ["accuracy"] if n_graphs is None else [])
    return CellSpec(
        step_fn=step,
        args=(_state_shapes(opt, p_shapes), batch_sds),
        in_specs=(state_spec, batch_spec),
        out_specs=(state_spec, {k: () for k in aux_keys}),
        cfg=cfg, plan=plan, donate=(0,),
    )


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_batch_specs(cfg, b: int, plan: ShardPlan):
    dp = plan.p("dp")
    dp2 = plan.p("dp", None)
    i32, f32 = torch.int32, torch.float32
    if isinstance(cfg, (DLRMConfig, DCNConfig)):
        sds = {"dense": _meta((b, cfg.n_dense), f32),
               "sparse": _meta((b, cfg.n_sparse), i32),
               "label": _meta((b,), f32)}
        spec = {"dense": dp2, "sparse": dp2, "label": dp}
    elif isinstance(cfg, DINConfig):
        sds = {"hist_items": _meta((b, cfg.seq_len), i32),
               "hist_cates": _meta((b, cfg.seq_len), i32),
               "target_item": _meta((b,), i32),
               "target_cate": _meta((b,), i32),
               "label": _meta((b,), f32)}
        spec = {"hist_items": dp2, "hist_cates": dp2, "target_item": dp,
                "target_cate": dp, "label": dp}
    else:  # SASRec
        sds = {k: _meta((b, cfg.seq_len), i32) for k in ("seq", "pos",
                                                          "neg")}
        spec = {"seq": dp2, "pos": dp2, "neg": dp2}
    return sds, spec


def _recsys_train_cell(cfg, plan: ShardPlan, shape: ShapeSpec):
    b = shape["batch"]
    opt = optim.adamw(optim.warmup_cosine(1e-3, 1000, 100_000))
    p_shapes = R.param_shapes(cfg, plan)
    p_specs = R.param_specs(cfg, plan)
    batch_sds, batch_spec = _recsys_batch_specs(cfg, b, plan)
    aux = {"loss": (), "grad_norm": ()}
    if not isinstance(cfg, SASRecConfig):
        aux["accuracy"] = ()

    if isinstance(cfg, (DLRMConfig, DCNConfig)):
        # the sparse-update path: row-wise AdaGrad on the big table
        from repro_torch.train.sparse_embed import make_ctr_sparse_train_step

        init_state_fn, step = make_ctr_sparse_train_step(cfg, plan, opt)
        rest_specs = {k: v for k, v in p_specs.items() if k != "table"}
        rest_shapes = {k: v for k, v in p_shapes.items() if k != "table"}
        rows = p_shapes["table"].shape[0]
        state_sds = init_state_fn(p_shapes)
        state_spec = TrainState(
            step=(), params=p_specs,
            opt_state={
                "dense": optim.state_specs(opt, rest_specs, rest_shapes),
                "embed_acc": plan.div_p((rows,), "tp"),
            },
            ef_buf=None,
        )
    else:
        state_sds = _state_shapes(opt, p_shapes)
        state_spec = _state_specs(opt, p_specs, p_shapes)
        step = make_train_step(partial(R.loss_fn, cfg=cfg, plan=plan), opt)
    return CellSpec(
        step_fn=step,
        args=(state_sds, batch_sds),
        in_specs=(state_spec, batch_spec),
        out_specs=(state_spec, aux),
        cfg=cfg, plan=plan, donate=(0,),
    )


def _recsys_serve_cell(cfg, plan: ShardPlan, shape: ShapeSpec):
    b = shape["batch"]
    if isinstance(cfg, SASRecConfig):
        batch_sds = {"seq": _meta((b, cfg.seq_len), torch.int32),
                     "target_item": _meta((b,), torch.int32)}
        batch_spec = {"seq": plan.p("dp", None),
                      "target_item": plan.p("dp")}
    else:
        batch_sds, batch_spec = _recsys_batch_specs(cfg, b, plan)
        batch_sds.pop("label", None)
        batch_spec.pop("label", None)

    def step(params, batch):
        return R.serve_logits(params, batch, cfg, plan)

    return CellSpec(
        step_fn=step,
        args=(R.param_shapes(cfg, plan), batch_sds),
        in_specs=(R.param_specs(cfg, plan), batch_spec),
        out_specs=plan.p("dp"),
        cfg=cfg, plan=plan,
    )


def _recsys_retrieval_cell(cfg, plan: ShardPlan, shape: ShapeSpec):
    n_dev = plan.size_of(("dp", "tp"))
    # pad the candidate list so it shards across the whole mesh
    c = _pad_to(shape["n_candidates"], max(n_dev, 512))
    k = 100
    cand_spec = plan.p(("dp", "tp"))
    i32 = torch.int32
    rep2 = plan.p(None, None)
    if isinstance(cfg, SASRecConfig):
        batch_sds = {"seq": _meta((1, cfg.seq_len), i32),
                     "candidates": _meta((c,), i32)}
        batch_spec = {"seq": rep2, "candidates": cand_spec}
    elif isinstance(cfg, DINConfig):
        batch_sds = {"hist_items": _meta((1, cfg.seq_len), i32),
                     "hist_cates": _meta((1, cfg.seq_len), i32),
                     "candidates": _meta((c,), i32),
                     "cand_cates": _meta((c,), i32)}
        batch_spec = {"hist_items": rep2, "hist_cates": rep2,
                      "candidates": cand_spec, "cand_cates": cand_spec}
    else:
        batch_sds = {"dense": _meta((1, cfg.n_dense), torch.float32),
                     "sparse": _meta((1, cfg.n_sparse), i32),
                     "candidates": _meta((c,), i32)}
        batch_spec = {"dense": rep2, "sparse": rep2,
                      "candidates": cand_spec}

    def step(params, batch):
        return R.retrieval_logits(params, batch, cfg, plan, k=k)

    return CellSpec(
        step_fn=step,
        args=(R.param_shapes(cfg, plan), batch_sds),
        in_specs=(R.param_specs(cfg, plan), batch_spec),
        out_specs=((), ()),
        cfg=cfg, plan=plan,
    )


# ---------------------------------------------------------------------------
# ANN (paper) cells
# ---------------------------------------------------------------------------


def _ann_cell(cfg: AnnConfig, plan: ShardPlan, shape: ShapeSpec):
    """The distributed two-level search over a bucket-sharded index: each
    rank runs ``make_sharded_ivf_fn``'s local on its buckets (its shard's
    flat index over every mesh axis), then the shards' top-k are gathered
    and merged, as the reference's ``shard_map``."""
    from repro_torch.distributed.sharding import (_merge_gathered,
                                                  _mesh_slot,
                                                  make_sharded_ivf_fn)

    mesh = plan.mesh
    axes = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    n_dev = int(np.prod(mesh.mesh.shape)) if mesh is not None else 1
    b, k = shape["batch"], shape["k"]
    K = _pad_to(cfg.n_clusters, n_dev)
    cap = _pad_to(int(np.ceil(2.5 * cfg.n / cfg.n_clusters)), 8)
    nprobe_local = max(1, cfg.nprobe // n_dev)
    local = make_sharded_ivf_fn(k, nprobe_local, K // n_dev,
                                cfg.n_clusters)

    coll, slot = _mesh_slot(mesh, axes, ())

    def step(cents, bucket_ids, bucket_vecs, q):
        tabs = [t.to_local() if hasattr(t, "to_local") else t
                for t in (cents, bucket_ids, bucket_vecs, q)]
        d, i = local(*tabs, lin=slot.lin)
        if coll is None:
            return d, i
        return _merge_gathered(*coll.gather_corpus(d, i), k)

    f32 = torch.float32
    row = (axes or None, None)
    return CellSpec(
        step_fn=step,
        args=(_meta((K, cfg.d), f32), _meta((K, cap), torch.int32),
              _meta((K, cap, cfg.d), f32), _meta((b, cfg.d), f32)),
        in_specs=(row, row, row + (None,), (None, None)),
        out_specs=((None, None), (None, None)),
        cfg=cfg, plan=plan,
        note=f"distributed two-level search: {K} buckets x cap {cap}, "
             f"nprobe_local={nprobe_local}",
    )


# ---------------------------------------------------------------------------


def build_cell(cfg, family: str, plan: ShardPlan,
               shape: ShapeSpec) -> CellSpec:
    if family == "lm":
        if shape.dims.get("subquadratic_required"):
            raise ValueError(
                "long_500k requires sub-quadratic attention; all assigned "
                "LM archs are full softmax attention -> listed skip")
        if shape.kind == "train":
            return _lm_train_cell(cfg, plan, shape)
        if shape.kind == "prefill":
            return _lm_prefill_cell(cfg, plan, shape)
        return _lm_decode_cell(cfg, plan, shape)
    if family == "gnn":
        return _gnn_cell(cfg, plan, shape)
    if family == "recsys":
        if shape.kind == "train":
            return _recsys_train_cell(cfg, plan, shape)
        if shape.kind == "retrieval":
            return _recsys_retrieval_cell(cfg, plan, shape)
        return _recsys_serve_cell(cfg, plan, shape)
    if family == "ann":
        return _ann_cell(cfg, plan, shape)
    raise ValueError(family)


def build_fleet_cells(cfg, family: str, meshes, shape: ShapeSpec) -> list:
    """One :class:`CellSpec` per mesh of a serving fleet (meshes from
    ``launch.mesh.make_cell_meshes``), each with its own role plan: N
    replicas of one cell, identical up to the mesh."""
    from repro_torch.launch.mesh import make_plan

    return [build_cell(cfg, family, make_plan(mesh), shape)
            for mesh in meshes]
