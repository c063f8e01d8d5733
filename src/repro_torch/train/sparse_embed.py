"""Sparse embedding training: row-wise AdaGrad on the touched rows only --
the port of ``repro/train/sparse_embed.py``.

The dense path would hold a full (rows x dim) fp32 gradient for the table
plus AdamW's m and v; the sparse step differentiates with respect to the
*gathered rows* and scatters the update, with one AdaGrad accumulator a
row:

  state : acc (rows,) fp32
  step  : g_e = dLoss/d(gathered rows)  (B, F, D)
          acc[ids]   += mean(g_e^2, -1)          (every row first)
          table[ids] -= lr * g_e / sqrt(acc[ids] + eps)

Every duplicate of an id adds its ``mean(g^2)`` into ``acc`` before any
row reads it back, so each duplicate sees the full sum, and the updates
of duplicates add up -- the reference's scatter-add semantics, in three
batched ops (never a loop over rows: Criteo's small tables repeat an id
thousands of times in 65,536 rows).  Dense (MLP / cross) params keep
their regular optimizer.

Unlike the reference, which returns new arrays, ``table`` and ``acc`` are
updated in place (``index_add_``) and returned: DLRM's bf16 table is
48 GB, and a copy of it does not fit beside it on an 80 GB card.  On the
card ``index_add_`` adds with atomics, so the sums over duplicate ids
land in another order than on the CPU (fp32: equal to rounding); a bf16
table's atomics add in bf16, one rounding each duplicate.  A negative id
counts from the end of the table, as ``jnp`` indexing does.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed.sharding import local_region, move
from repro_torch.models import recsys as R
from repro_torch.models.embedding import take_embeddings
from repro_torch.train.loop import TrainState, value_and_grad
from repro_torch.train.optim import Optimizer, apply_in_place

__all__ = ["make_ctr_sparse_train_step", "rowwise_adagrad_update"]


@torch.no_grad()
def rowwise_adagrad_update(table, acc, ids, g_rows, *, lr: float,
                           eps: float = 1e-8):
    """Scatter row-wise AdaGrad, in place.  ids (...,), g_rows (..., D);
    returns (table, acc)."""
    flat_ids = ids.reshape(-1).long()
    flat_ids = torch.where(flat_ids < 0, flat_ids + table.shape[0],
                           flat_ids)
    flat_g = g_rows.reshape(-1, g_rows.shape[-1]).float()
    row_g2 = torch.mean(flat_g * flat_g, dim=-1)
    acc.index_add_(0, flat_ids, row_g2)
    scale = lr * torch.rsqrt(acc[flat_ids] + eps)
    upd = (scale[:, None] * flat_g).to(table.dtype)
    table.index_add_(0, flat_ids, -upd)
    return table, acc


def _sharded_adagrad(plan, table, acc, ids, g_rows, *, lr: float):
    """``rowwise_adagrad_update`` of a DTensor table whose rows are whole
    on every rank (DLRM / DCN shard its columns over tp): each rank adds
    every row's ``mean(g^2)`` into a whole copy of ``acc`` (the same sums
    in the same order everywhere) and updates its own columns of the
    table in place; ``acc`` goes back to its own placements."""
    tp = tuple(table.placements)
    if any(isinstance(q, Shard) and q.dim == 0 for q in tp):
        raise NotImplementedError(
            f"a row-sharded table {tp}: the sparse step updates whole rows")
    gd = g_rows.dim()
    cols = tuple(Shard(gd - 1) if isinstance(q, Shard) else Replicate()
                 for q in tp)
    rep = tuple(Replicate() for _ in tp)

    def local(table_l, acc_l, ids_l, g_full, g_cols):
        acc_l = acc_l.clone()
        flat_ids = ids_l.reshape(-1).long()
        flat_ids = torch.where(flat_ids < 0, flat_ids + table_l.shape[0],
                               flat_ids)
        flat_g = g_full.reshape(-1, g_full.shape[-1]).float()
        acc_l.index_add_(0, flat_ids, torch.mean(flat_g * flat_g, dim=-1))
        scale = lr * torch.rsqrt(acc_l[flat_ids] + 1e-8)
        g_c = g_cols.reshape(-1, g_cols.shape[-1]).float()
        table_l.index_add_(0, flat_ids,
                           -(scale[:, None] * g_c).to(table_l.dtype))
        return table_l, acc_l

    with torch.no_grad():
        new_table, new_acc = local_region(
            plan.mesh, local,
            [(table, tp), (acc, rep), (ids, rep), (g_rows, rep),
             (g_rows, cols)], [tp, rep])
    return new_table, move(new_acc, acc.placements)


def _sharded_gather(plan, table, ids):
    """The rows of ``ids`` (over dp) from a column-sharded table, over
    the batch's shards and the table's columns."""
    tp = tuple(table.placements)
    nd = ids.dim() + 1
    ip = plan.placements("dp", *([None] * (ids.dim() - 1)))
    out = tuple(Shard(nd - 1) if isinstance(q, Shard) else p
                for q, p in zip(tp, ip))
    return local_region(plan.mesh, take_embeddings, [(table, tp), (ids, ip)],
                        out)


def make_ctr_sparse_train_step(cfg, plan, opt_dense: Optimizer,
                               lr_embed: float = 0.01,
                               grad_clip: float = 1.0):
    """Train step for DLRM/DCN: dense params via ``opt_dense``, the table
    via sparse row-wise AdaGrad.  State: opt_state = {"dense": ...,
    "embed_acc": (rows,) fp32}.  Returns (init_state, train_step)."""

    def init_state(params) -> TrainState:
        rest = {k: v for k, v in params.items() if k != "table"}
        table = params["table"]
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=table.device),
            params=params,
            opt_state={
                "dense": opt_dense.init(rest),
                "embed_acc": torch.zeros((table.shape[0],),
                                         dtype=torch.float32,
                                         device=table.device),
            },
            ef_buf=None,
        )

    def train_step(state: TrainState, batch):
        params = state.params
        table = params["table"]
        rest = {k: v for k, v in params.items() if k != "table"}
        ids = torch.as_tensor(batch["sparse"], dtype=torch.int64,
                              device=table.device)
        if plan.mesh is None:
            e = take_embeddings(table, ids)
        else:
            ids = plan.distribute(ids, "dp", None)
            e = _sharded_gather(plan, table, ids)

        def loss_of(p, b):
            logits = R.ctr_forward_gathered(p["rest"], p["e"], b, cfg, plan)
            return R.loss_from_logits(logits, b["label"], plan)

        (_, aux), g = value_and_grad(loss_of, {"rest": rest, "e": e},
                                     batch)
        # the dense leaves in place, as the reference's donated step
        gnorm = apply_in_place(opt_dense, g["rest"], state.opt_state["dense"],
                               rest, state.step, max_norm=grad_clip)
        if plan.mesh is None:
            new_table, new_acc = rowwise_adagrad_update(
                table, state.opt_state["embed_acc"], ids, g["e"],
                lr=lr_embed)
        else:
            new_table, new_acc = _sharded_adagrad(
                plan, table, state.opt_state["embed_acc"], ids, g["e"],
                lr=lr_embed)
        aux = dict(aux)
        aux["grad_norm"] = gnorm
        return TrainState(
            step=state.step + 1,
            params={**rest, "table": new_table},
            opt_state={"dense": state.opt_state["dense"],
                       "embed_acc": new_acc},
            ef_buf=None,
        ), aux

    return init_state, train_step
