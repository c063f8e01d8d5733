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
from torch.distributed.tensor import Shard

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
    on every rank (DLRM / DCN shard its columns over tp), in place, each
    rank on its own shards: every row's ``mean(g^2)`` is a partial sum
    over the ranks holding its columns, all-reduced, and gathered over dp
    with the ids (every dp rank holds the same rows and applies every
    row's update); each rank adds them into its own rows of ``acc`` in the
    ids' order, and updates its columns of every touched row.  Only the
    per-row terms and the gradient's own columns move."""
    tp = tuple(table.placements)
    if any(isinstance(q, Shard) and q.dim == 0 for q in tp):
        raise NotImplementedError(
            f"a row-sharded table {tp}: the sparse step updates whole rows")
    rows, width = table.shape
    cols = "tp" if g_rows.dim() - 1 in plan.sharded_dims(g_rows, "tp") \
        else None
    acc_tp = 0 in plan.sharded_dims(acc, "tp")
    a0, na = plan.chunk(rows, "tp") if acc_tp else (0, rows)
    row, rep = plan.layout("dp", None), plan.layout(None, None)

    def over_tp(pl, split):
        return plan.partial(pl, "tp") if split else pl

    def flat(i):
        i = i.reshape(-1).long()
        return torch.where(i < 0, i + rows, i)

    def add(acc_l, ids_l, g2):
        # acc's own rows only: another rank's ids add +0.0 to a clamped row
        at = flat(ids_l) - a0
        mine = (at >= 0) & (at < na)
        at = at.clamp(0, na - 1)
        acc_l.index_add_(0, at, torch.where(mine, g2.reshape(-1), 0.0))
        return acc_l, torch.where(mine, acc_l[at], 0.0)

    def update(table_l, ids_l, acc_at, g_l):
        scale = lr * torch.rsqrt(acc_at + 1e-8)
        g_c = g_l.reshape(-1, g_l.shape[-1]).float()
        table_l.index_add_(0, flat(ids_l),
                           -(scale[:, None] * g_c).to(table_l.dtype))
        return table_l

    with torch.no_grad():
        g2 = local_region(plan.mesh,
                          lambda g: (g.float() * g.float()).sum(-1) / width,
                          [(g_rows, plan.layout("dp", None, cols))],
                          over_tp(row, cols))
        g2, ids_all = move(move(g2, row), rep), move(ids, rep)
        new_acc, acc_at = local_region(
            plan.mesh, add, [(acc, tuple(acc.placements)), (ids_all, rep),
                             (g2, rep)],
            [tuple(acc.placements), over_tp(plan.layout(None), acc_tp)])
        acc_at = move(acc_at, plan.layout(None))
        new_table = local_region(
            plan.mesh, update,
            [(table, tp), (ids_all, rep), (acc_at, plan.layout(None)),
             (g_rows, plan.layout(None, None, cols))], tp)
    return new_table, new_acc


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
            e = R._take(table, ids, plan)

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
