"""RecSys ranking/retrieval models: DLRM, DCN-v2, DIN, SASRec — the port
of ``repro/models/recsys.py``, in plain PyTorch (the reference computes
them in plain ``jnp``: gathers, MLPs, einsums; no Pallas kernel).

Shared anatomy (taxonomy §RecSys): huge sparse embedding tables ->
feature-interaction op (dot / cross / target-attn / causal self-attn) ->
small MLP.  Tables: DLRM/DCN fuse all 26 Criteo tables into one array with
offsets (one gather) column-sharded over tp; DIN/SASRec tables (dims 18/50,
% 16 != 0) row-shard over tp.  The parameter names, key paths, shapes and
specs are the reference's, so ``convert.recsys_params_from_arrays``
carries its weights across leaf for leaf.

``retrieval_logits`` is the paper-integration point: factorized models
(DIN/SASRec) score 1 M candidates as user·item — exactly the paper's ANN
problem; the serving layer can swap the exact dot-top-k for the two-level
index (DESIGN.md §5).  DLRM/DCN score candidates through the full joint
MLP (exact bulk scoring, shardable over candidates).  The reference spreads
the candidates over the mesh; on one card the port walks them in chunks of
``RETRIEVAL_CHUNK`` (each candidate is scored on its own, so the chunks give
the one-shot answer), then takes the top k of all scores with
``stable_topk`` (``lax.top_k``'s order: descending, ties to the lower
index).

Dtypes follow ``jnp``'s promotion: a product of a bf16 and an fp32
operand computes in fp32 (``_mm``), as does a concatenation, so a tree cast
to bf16 keeps its fp32 dense inputs and the MLPs run in fp32 on the
up-cast weights, as in the reference.  Batches are numpy dicts (or
tensors); they are moved to the parameters' device.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.analysis.annotations import hot_path
from repro_torch.configs.base import (DCNConfig, DINConfig, DLRMConfig,
                                      SASRecConfig)
from repro_torch.distributed.sharding import (LOCAL_PLAN, ShardPlan, local,
                                              local_region, move, whole)
from repro_torch.kernels.common import stable_topk
from repro_torch.models import base
from repro_torch.models.attention import _ein, attention
from repro_torch.models.embedding import concat_table_offsets, take_embeddings
from repro_torch.models.layers import rms_norm

__all__ = ["init", "param_specs", "param_shapes", "loss_fn",
           "serve_logits", "ctr_forward_gathered", "retrieval_logits",
           "user_vectors", "mips_augment", "RETRIEVAL_CHUNK"]

# candidates scored at a time by retrieval_logits: DIN's target attention
# holds about 150 KB of activations a candidate (L 100 x 144 wide input,
# the 80-wide hidden layer), so 65,536 candidates take about 10 GB where
# one shot over 1M would take 90 GB
RETRIEVAL_CHUNK = 1 << 16


def _mm(x, w):
    """``x @ w`` with ``jnp``'s promotion (bf16 against fp32 -> fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _cat(parts, dim: int):
    """``jnp.concatenate``: every part promoted to the common dtype."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts], dim=dim)


def _device(params) -> torch.device:
    return next(t for t in base.tree_leaves(params)
                if isinstance(t, torch.Tensor)).device


def _ids(x, dev) -> torch.Tensor:
    """Integer ids (numpy or tensor) as int64 on ``dev``."""
    return torch.as_tensor(x, dtype=torch.int64, device=dev)


def _dense(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _leaf(x, plan: ShardPlan, dev, dtype=torch.int64):
    """A batch leaf in ``dtype``: under a bound mesh a DTensor over dp
    (placed first unless it is one), else a tensor on ``dev``."""
    if plan.mesh is None:
        return torch.as_tensor(x, device=dev).to(dtype)
    nd = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    return _place(x, plan, plan.p("dp", *[None] * (nd - 1)), dev).to(dtype)


def _take(table, ids, plan: ShardPlan):
    """``take_embeddings`` of ``ids`` (over dp) from a table at its
    reference placement, each rank looking up its own rows locally: a
    table whose columns lie over tp (DLRM, DCN-v2) gives each rank its
    columns of its rows (the embedding dim stays over tp); one whose rows
    lie over tp (DIN's items) gives the rows it holds, zeros elsewhere,
    all-reduced over tp; a whole one its rows.  ``-1`` pads, as
    ``take_embeddings``."""
    if plan.mesh is None:
        return take_embeddings(table, ids)
    lead = [None] * (ids.dim() - 1)
    ip, out = plan.layout("dp", *lead), plan.layout("dp", *lead, None)
    dims = plan.sharded_dims(table, "tp")
    if 1 in dims:
        return local_region(plan.mesh, take_embeddings,
                            [(table, plan.layout(None, "tp")), (ids, ip)],
                            plan.layout("dp", *lead, "tp"))
    if 0 in dims:
        r0, n = plan.chunk(table.shape[0], "tp")

        def mine(t, i):
            at = i - r0
            return take_embeddings(t, torch.where((i >= 0) & (at >= 0)
                                                  & (at < n), at, -1))

        return move(local_region(plan.mesh, mine,
                                 [(table, plan.layout("tp", None)),
                                  (ids, ip)], plan.partial(out, "tp")), out)
    return local_region(plan.mesh, take_embeddings,
                        [(table, plan.layout(None, None)), (ids, ip)], out)


def _mlp_params(mk, plan, prefix, dims):
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        # shard a dim only when the mesh axis divides it AND the matrix is
        # big enough to matter: sharding DIN's 144x80 attention MLP over tp
        # made XLA all-gather the (1M, 100, 144) candidate activations
        # instead of the 46 KB weight (3.6 GB/chip — EXPERIMENTS.md §Perf)
        if a * b >= 1 << 20:
            w_spec = plan.div_p((a, b), "fsdp", "tp")
        else:
            w_spec = plan.p(None, None)
        p[f"w{i}"] = mk(f"{prefix}/w{i}", (a, b), w_spec)
        p[f"b{i}"] = mk(f"{prefix}/b{i}", (b,), plan.p(None), init="zeros")
    return p


def _n_layers(p) -> int:
    return len([k for k in p if k.startswith("w")])


def _run(p, x, lo: int, hi: int, n: int, act, final_act,
         pending: bool = False):
    """Layers ``lo`` .. ``hi - 1`` of an ``n``-layer MLP on ``x``
    (``pending``: ``x`` is layer ``lo``'s product, its bias and activation
    still to come)."""
    for i in range(lo, hi):
        if not (pending and i == lo):
            x = _mm(x, p[f"w{i}"])
        x = x + p[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def _mlp_apply(p, x, *, act=torch.relu, final_act=None):
    n = _n_layers(p)
    return _run(p, x, 0, n, n, act, final_act)


def _mlp(p, x, plan: ShardPlan, *, act=torch.relu, final_act=None,
         pending: bool = False, cols_out: bool = False):
    """``_mlp_apply`` on the rows' shards (``x`` over dp, whole over tp),
    each layer at the reference's placement.  A run of whole layers is one
    region in which tp is idle (every rank of a model row does the same
    work).  A layer whose columns lie over tp (``_mlp_params`` splits the
    large ones over ``("fsdp", "tp")``) computes its shard of the output
    columns after the FSDP gather, and the next layer reads that shard by
    its rows: a partial sum over tp, all-reduced before its bias
    (Megatron's pairing; the activations move over tp, never the weight).
    ``pending``: ``x`` is layer 0's product, its bias and activation still
    to come; ``cols_out``: the last layer's columns stay over tp (DLRM's
    bottom MLP, whose output meets the table's columns).  With no mesh,
    ``_mlp_apply``."""
    n = _n_layers(p)
    if plan.mesh is None:
        return _run(p, x, 0, n, n, act, final_act, pending)
    row, cols = plan.layout("dp", None), plan.layout("dp", "tp")

    def split(j):
        return 1 in plan.sharded_dims(p[f"w{j}"], "tp") or \
            (cols_out and j == n - 1)

    i = 0
    while True:
        j = i + pending
        while j < n and not split(j):
            j += 1
        # layers i .. j - 1 whole; layer j (if any) by its columns' shard
        keys = {f"b{q}": plan.layout(None) for q in range(i, min(j + 1, n))}
        keys.update({f"w{q}": plan.layout(None, None)
                     for q in range(i + pending, min(j + 1, n))})
        if j < n:
            keys.update({f"w{j}": plan.layout(None, "tp"),
                         f"b{j}": plan.layout("tp")})
        names = list(keys)

        def fn(x_, *ws, i=i, j=j, pend=pending, names=names):
            return _run(dict(zip(names, ws)), x_, i, min(j + 1, n), n, act,
                        final_act, pend)

        x = local_region(plan.mesh, fn,
                         [(x, row)] + [(p[k], pl) for k, pl in keys.items()],
                         row if j == n else cols)
        if j >= n - 1:
            # the end: a last split layer's columns gathered (or kept)
            return x if j == n or cols_out else move(x, row)
        # layer j + 1 reads the columns' shard by its rows
        w = p[f"w{j + 1}"]
        x = local_region(plan.mesh, _mm,
                         [(x, cols), (w, plan.layout("tp", None))],
                         plan.partial(row, "tp"))
        x, i, pending = move(x, row), j + 1, True


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


def _dlrm_params(cfg: DLRMConfig, mk, plan):
    _, total = concat_table_offsets(cfg.table_sizes)
    d = cfg.embed_dim
    return {
        "table": mk("table", (total, d), plan.div_p((total, d), None, "tp"),
                    init=("normal", 0.01)),
        "bot": _mlp_params(mk, plan, "bot",
                           (cfg.n_dense,) + tuple(cfg.bot_mlp)),
        "top": _mlp_params(mk, plan, "top",
                           (_dlrm_top_in(cfg),) + tuple(cfg.top_mlp)),
    }


def _dlrm_top_in(cfg: DLRMConfig):
    f = cfg.n_sparse + 1
    return f * (f - 1) // 2 + cfg.embed_dim


def _dlrm_forward(params, dense, sparse, cfg: DLRMConfig, plan, e=None):
    """dense (B, 13), sparse (B, 26) global-offset ids -> logit (B,).

    ``e`` optionally carries pre-gathered embeddings — the sparse-update
    training path differentiates w.r.t. the gathered rows instead of the
    whole table (train/sparse_embed.py).

    Under a bound mesh the rows lie over dp and, where the table's columns
    lie over tp, so do the embeddings' (``_take``): the bottom MLP's last
    layer gives each rank the same columns of ``z0``, the ``bfd,bgd``
    interaction is a partial sum over tp, and the top MLP's first layer
    reads each rank's shard of its input (its columns of ``z0`` and its
    chunk of the interaction's pairs) by its rows, a partial sum too.
    With no mesh every shard is the whole and this is the plain forward.
    """
    if e is None:
        e = _take(params["table"], sparse, plan)           # (B, 26, D)
    cols = 2 in plan.sharded_dims(e, "tp")
    d = "tp" if cols else None
    z0 = _mlp(params["bot"], dense, plan, act=torch.relu,
              final_act=torch.relu, cols_out=cols)         # (B, D)
    zl, row, row3 = (plan.layout("dp", d), plan.layout("dp", None),
                     plan.layout("dp", None, None))

    def partial(pl):
        return plan.partial(pl, "tp") if cols else pl

    def interact(z0_, e_):
        z = _cat([z0_[:, None, :], e_], 1)                 # (B, 27, D)
        return torch.einsum("bfd,bgd->bfg", z, z)          # (B, 27, 27)

    inter = move(local_region(plan.mesh, interact,
                              [(z0, zl), (e, plan.layout("dp", None, d))],
                              partial(row3)), row3)
    f = cfg.n_sparse + 1
    iu, ju = np.triu_indices(f, k=1)
    c0, nc = plan.chunk(cfg.embed_dim, "tp") if cols else (0, cfg.embed_dim)
    f0, nf = plan.chunk(len(iu), "tp") if cols else (0, len(iu))
    iu, ju = iu[f0:f0 + nf], ju[f0:f0 + nf]

    def first(z0_, inter_, w0):
        flat = inter_[:, torch.as_tensor(iu, device=z0_.device),
                      torch.as_tensor(ju, device=z0_.device)]   # (B, 351)
        top = cfg.embed_dim + f0
        return _mm(_cat([z0_, flat], 1),
                   torch.cat([w0[c0:c0 + nc], w0[top:top + nf]]))

    h0 = local_region(plan.mesh, first,
                      [(z0, zl), (inter, row3),
                       (params["top"]["w0"], plan.layout(None, None))],
                      partial(row))
    return _mlp(params["top"], move(h0, row), plan, pending=True)[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2
# ---------------------------------------------------------------------------


def _dcn_params(cfg: DCNConfig, mk, plan):
    _, total = concat_table_offsets(cfg.table_sizes)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    p = {
        "table": mk("table", (total, cfg.embed_dim),
                    plan.div_p((total, cfg.embed_dim), None, "tp"),
                    init=("normal", 0.01)),
        "mlp": _mlp_params(mk, plan, "mlp", (d0,) + tuple(cfg.mlp) + (1,)),
    }
    for i in range(cfg.n_cross_layers):
        p[f"cross_w{i}"] = mk(f"cross_w{i}", (d0, d0),
                              plan.div_p((d0, d0), "fsdp", "tp"))
        p[f"cross_b{i}"] = mk(f"cross_b{i}", (d0,), plan.p(None),
                              init="zeros")
    return p


def _dcn_forward(params, dense, sparse, cfg: DCNConfig, plan, e=None):
    """The cross layers need each row's whole ``x0``: under a bound mesh
    the looked-up rows (not the table) are gathered over tp where the
    table's columns lie, the cross layers run whole on every rank of a
    model row, and the MLP splits as ``_mlp``."""
    if e is None:
        e = _take(params["table"], sparse, plan)           # (B, 26, D)
    row = plan.layout("dp", None)
    names = [k for k in params if k.startswith("cross_")]

    def cross(dense_, e_, *ws):
        w = dict(zip(names, ws))
        x0 = _cat([dense_, e_.reshape(e_.shape[0], -1)], 1)
        x = x0
        for i in range(cfg.n_cross_layers):
            xw = _mm(x, w[f"cross_w{i}"]) + w[f"cross_b{i}"]
            x = x0 * xw + x                                 # DCN-v2 cross
        return x

    x = local_region(plan.mesh, cross,
                     [(dense, row), (e, plan.layout("dp", None, None))]
                     + [(params[k], plan.layout(*[None] * params[k].dim()))
                        for k in names], row)
    return _mlp(params["mlp"], x, plan)[:, 0]


# ---------------------------------------------------------------------------
# DIN
# ---------------------------------------------------------------------------


def _din_params(cfg: DINConfig, mk, plan):
    d = cfg.embed_dim
    att_in = 4 * 2 * d                                      # [et,eh,et-eh,et*eh]
    mlp_in = 2 * 2 * d                                      # [user_sum, target]
    return {
        "item_table": mk("item_table", (cfg.n_items, d),
                         plan.div_p((cfg.n_items, d), "tp", None),
                         init=("normal", 0.01)),
        "cate_table": mk("cate_table", (cfg.n_cates, d), plan.p(None, None),
                         init=("normal", 0.01)),
        "att": _mlp_params(mk, plan, "att",
                           (att_in,) + tuple(cfg.attn_mlp) + (1,)),
        "mlp": _mlp_params(mk, plan, "mlp",
                           (mlp_in,) + tuple(cfg.mlp) + (1,)),
    }


def _din_history(params, hist_items, hist_cates):
    """(B, L, 2D) history embeddings [item | category]."""
    return _cat([take_embeddings(params["item_table"], hist_items),
                 take_embeddings(params["cate_table"], hist_cates)], -1)


def _din_user_embed(params, hist_items, eh, target_e):
    """Target attention over history -> (T, 2D) user interest vectors.

    ``eh`` (B, L, 2D) and ``hist_items`` (B, L) broadcast against
    ``target_e`` (T, 2D): B == T pairs each target with its own history
    (serving), B == 1 scores T candidates against one user's history (the
    reference's ``vmap`` in ``retrieval_logits``).  A fully masked history
    row gets ``-1e30`` everywhere, so its softmax is uniform over all L
    slots, as in the reference."""
    et = target_e[:, None, :]                               # (T, 1, 2D)
    etb, ehb = torch.broadcast_tensors(et, eh)
    att_in = _cat([etb, ehb, etb - ehb, etb * ehb], -1)
    scores = _mlp_apply(params["att"], att_in,
                        act=torch.sigmoid)[..., 0]          # (T, L)
    scores = torch.where(hist_items >= 0, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return (w[..., None] * ehb).sum(dim=1)                  # (T, 2D)


def _din_forward(params, batch, cfg: DINConfig, plan):
    """The item rows looked up from the table at its placement
    (``_take``: over tp's rows, a masked local lookup and an all-reduce),
    then the target attention and the MLP on each rank's rows with the
    small leaves gathered whole (``_rows``)."""
    dev = _device(params)
    ids = {k: _leaf(batch[k], plan, dev) for k in
           ("target_item", "target_cate", "hist_items", "hist_cates")}
    rows = {"ti": _take(params["item_table"], ids["target_item"], plan),
            "hi": _take(params["item_table"], ids["hist_items"], plan),
            "hist_items": ids["hist_items"]}
    rest = {k: v for k, v in params.items() if k != "item_table"}

    def fn(p, b, c, pl):
        et = _cat([b["ti"], take_embeddings(p["cate_table"],
                                            b["target_cate"])], -1)
        eh = _cat([b["hi"], take_embeddings(p["cate_table"],
                                            b["hist_cates"])], -1)
        user = _din_user_embed(p, b["hist_items"], eh, et)
        return _mlp_apply(p["mlp"], _cat([user, et], -1))[:, 0]

    return _rows(fn, rest, {**rows, "target_cate": ids["target_cate"],
                            "hist_cates": ids["hist_cates"]}, cfg, plan,
                 out=plan.layout("dp"))


# ---------------------------------------------------------------------------
# SASRec
# ---------------------------------------------------------------------------


def _sasrec_params(cfg: SASRecConfig, mk, plan):
    d = cfg.embed_dim
    L = (cfg.n_blocks,)
    sp = lambda *dims: plan.p(None, *dims)   # noqa: E731  (the reference's)
    # +1 pad row for -1 ids; round rows up so tp row-sharding divides
    tp_n = max(plan.size_of("tp"), 1)
    rows = -(-(cfg.n_items + 1) // tp_n) * tp_n
    return {
        "item_table": mk("item_table", (rows, d),
                         plan.div_p((rows, d), "tp", None),
                         init=("normal", 0.01)),
        "pos_table": mk("pos_table", (cfg.seq_len, d), plan.p(None, None),
                        init=("normal", 0.01)),
        "blocks": {
            "ln1": mk("blocks/ln1", L + (d,), sp(None), init="ones"),
            "ln2": mk("blocks/ln2", L + (d,), sp(None), init="ones"),
            "w_q": mk("blocks/w_q", L + (d, cfg.n_heads, d // cfg.n_heads),
                      sp(None, None, None)),
            "w_k": mk("blocks/w_k", L + (d, cfg.n_heads, d // cfg.n_heads),
                      sp(None, None, None)),
            "w_v": mk("blocks/w_v", L + (d, cfg.n_heads, d // cfg.n_heads),
                      sp(None, None, None)),
            "w_o": mk("blocks/w_o", L + (cfg.n_heads, d // cfg.n_heads, d),
                      sp(None, None, None)),
            "f_w1": mk("blocks/f_w1", L + (d, d), sp(None, None)),
            "f_b1": mk("blocks/f_b1", L + (d,), sp(None), init="zeros"),
            "f_w2": mk("blocks/f_w2", L + (d, d), sp(None, None)),
            "f_b2": mk("blocks/f_b2", L + (d,), sp(None), init="zeros"),
        },
        "final_ln": mk("final_ln", (d,), plan.p(None), init="ones"),
    }


def _sasrec_hidden(params, seq, cfg: SASRecConfig, plan):
    """seq (B, L) item ids (-1 pad) -> hidden (B, L, D)."""
    seq = _ids(seq, _device(params))
    valid = seq >= 0
    x = take_embeddings(params["item_table"], seq)
    x = x + params["pos_table"][None, : seq.shape[1]]
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    kv_mask = valid.to(torch.int32)
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in params["blocks"].items()}
        h = rms_norm(x, bp["ln1"])
        q = _ein("bsd,dhk->bshk", h, bp["w_q"])
        k = _ein("bsd,dhk->bshk", h, bp["w_k"])
        v = _ein("bsd,dhk->bshk", h, bp["w_v"])
        o = attention(q, k, v, causal=True, kv_mask=kv_mask)
        x = x + _ein("bshk,hkd->bsd", o, bp["w_o"])
        h = rms_norm(x, bp["ln2"])
        f = torch.relu(_mm(h, bp["f_w1"]) + bp["f_b1"])
        x = x + _mm(f, bp["f_w2"]) + bp["f_b2"]
    return rms_norm(x, params["final_ln"])


def user_vectors(params, seq, cfg: SASRecConfig,
                 plan: ShardPlan = LOCAL_PLAN) -> torch.Tensor:
    """SASRec's user tower: the last slot's hidden state of each sequence
    (B, D), the vector ``retrieval_logits`` scores candidates with (and
    the query a two-level index over ``mips_augment``'s rows is searched
    with)."""
    return _sasrec_hidden(params, seq, cfg, plan)[:, -1]


def _sasrec_terms(params, batch, cfg: SASRecConfig, plan):
    """Per-position BCE over (positive next item, sampled negative), and
    the positions' mask."""
    dev = _device(params)
    h = _sasrec_hidden(params, batch["seq"], cfg, plan)     # (B, L, D)
    pos = _ids(batch["pos"], dev)
    pos_e = take_embeddings(params["item_table"], pos)
    neg_e = take_embeddings(params["item_table"], _ids(batch["neg"], dev))
    pos_s = (h * pos_e).sum(-1)
    neg_s = (h * neg_e).sum(-1)
    mask = (pos >= 0).float()
    return -(F.logsigmoid(pos_s) + F.logsigmoid(-neg_s)), mask


def _sasrec_reduce(loss, mask):
    loss = (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss}


def _ctr_reduce(logits, y):
    loss = torch.mean(
        torch.clamp(logits, min=0) - logits * y
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    acc = torch.mean(((logits > 0) == (y > 0.5)).float())
    return loss, {"loss": loss, "accuracy": acc}


# ---------------------------------------------------------------------------
# unified API
# ---------------------------------------------------------------------------

_PARAM_FNS = {
    DLRMConfig: _dlrm_params,
    DCNConfig: _dcn_params,
    DINConfig: _din_params,
    SASRecConfig: _sasrec_params,
}


def _param_fn(cfg, mk, plan):
    return _PARAM_FNS[type(cfg)](cfg, mk, plan)


def init(cfg, seed: int = 0, plan: ShardPlan = LOCAL_PLAN, *,
         dtype=torch.float32, device=None):
    """The parameter tree, initialised from ``seed`` on ``device``
    (``None``: the card), every leaf in ``dtype`` (the reference's fp32
    by default; bf16 draws in fp32 chunks, so a 48 GB bf16 table needs no
    96 GB fp32 copy)."""
    return base.build_params(partial(_param_fn, plan=plan), cfg, seed,
                             dtype=dtype, device=device, plan=plan)


def param_specs(cfg, plan: ShardPlan):
    return base.build_specs(partial(_param_fn, plan=plan), cfg)


def param_shapes(cfg, plan: ShardPlan = LOCAL_PLAN):
    """``meta`` tensors of every parameter's shape and dtype."""
    return base.build_shapes(partial(_param_fn, plan=plan), cfg)


@hot_path
def serve_logits(params, batch, cfg, plan: ShardPlan = LOCAL_PLAN):
    """Pointwise CTR logits for a request batch; under a bound mesh over
    the rows' shards (dp), the tables and the large MLP layers at their
    reference placements (``_take``, ``_mlp``; SASRec: ``_rows``)."""
    dev = _device(params)
    if isinstance(cfg, (DLRMConfig, DCNConfig)):
        fwd = _dlrm_forward if isinstance(cfg, DLRMConfig) else _dcn_forward
        return fwd(params, _leaf(batch["dense"], plan, dev, torch.float32),
                   _leaf(batch["sparse"], plan, dev), cfg, plan)
    if isinstance(cfg, DINConfig):
        return _din_forward(params, batch, cfg, plan)
    if isinstance(cfg, SASRecConfig):
        return _rows(_sasrec_serve, params, batch, cfg, plan,
                     out=plan.layout("dp"))
    raise TypeError(type(cfg))


@hot_path
def _sasrec_serve(params, batch, cfg, plan: ShardPlan):
    h = _sasrec_hidden(params, batch["seq"], cfg, plan)
    e = take_embeddings(params["item_table"],
                        _ids(batch["target_item"], _device(params)))
    return (h[:, -1] * e).sum(-1)


@hot_path
def loss_fn(params, batch, cfg, plan: ShardPlan = LOCAL_PLAN):
    """BCE with logits against batch['label'] (SASRec: in-sequence BCE).
    Under a bound mesh the per-row terms come from each batch shard and
    are gathered and reduced as on one card."""
    if isinstance(cfg, SASRecConfig):
        terms = _rows(_sasrec_terms, params, batch, cfg, plan,
                      out=[plan.layout("dp", None)] * 2)
        return _reduce(_sasrec_reduce, terms, ["loss"], plan)
    return loss_from_logits(serve_logits(params, batch, cfg, plan),
                            batch["label"], plan)


@hot_path
def ctr_forward_gathered(rest, e, batch, cfg, plan: ShardPlan = LOCAL_PLAN):
    """DLRM/DCN forward with pre-gathered embeddings (sparse-update path).

    ``rest`` is the param tree minus the table (table may be absent).
    Under a bound mesh ``e`` (B, F, D) lies over the batch's shards and
    its columns over tp, as the table's (``_take``), and stays there:
    DLRM's interaction reads it as a partial sum, DCN-v2 gathers the rows
    whole; the large MLP layers keep their columns over tp (``_mlp``)."""
    fwd = _dlrm_forward if isinstance(cfg, DLRMConfig) else _dcn_forward
    dev = local(e).device
    return fwd(rest, _leaf(batch["dense"], plan, dev, torch.float32), None,
               cfg, plan, e=e)


@hot_path
def retrieval_logits(params, batch, cfg, plan: ShardPlan = LOCAL_PLAN,
                     k: int = 100):
    """Score 1 user against n_candidates items; return (scores, ids) top-k.

    Factorized models (DIN/SASRec): user vector . candidate embeddings — the
    paper's exact ANN problem (swap in the two-level index at serve time).
    Joint models (DLRM/DCN): full forward over candidate-expanded rows.
    The candidates are scored ``RETRIEVAL_CHUNK`` at a time (each on its
    own, so any chunk gives the same scores up to the products' rounding);
    under a bound mesh each rank scores its shard of them, over
    ("dp", "tp"), and every rank takes the top k of all of them (the
    reference's replicated output).
    """
    spec = plan.p(("dp", "tp"))
    scores = _rows(
        lambda p, b, c, pl: _retrieval_scores(p, b, c, pl)[0], params,
        batch, cfg, plan, specs={"candidates": spec, "cand_cates": spec},
        out=plan.layout(("dp", "tp")))
    cand = batch["candidates"]
    cand = whole(cand) if isinstance(cand, DTensor) else \
        torch.as_tensor(cand, dtype=torch.int32, device=local(scores).device)
    neg, ids = stable_topk(-whole(scores).float()[None], k)
    # highest-scoring candidates, descending
    return -neg[0], cand.to(torch.int32)[ids[0]]


def _retrieval_scores(params, batch, cfg, plan: ShardPlan):
    """Every candidate's score, and the candidates (int32)."""
    dev = _device(params)
    cand = torch.as_tensor(batch["candidates"], dtype=torch.int32,
                           device=dev)                       # (C,) item ids
    cand_l = cand.long()
    if isinstance(cfg, SASRecConfig):
        h = user_vectors(params, batch["seq"], cfg, plan)          # (1, D)

        def score(sl):
            e = take_embeddings(params["item_table"], cand_l[sl])
            e = plan.constrain(e, ("dp", "tp"), None)
            return _mm(h, e.T)[0]
    elif isinstance(cfg, DINConfig):
        hist_items = _ids(batch["hist_items"], dev)
        eh = _din_history(params, hist_items, _ids(batch["hist_cates"], dev))
        cates = _ids(batch["cand_cates"], dev)

        def score(sl):
            et = _cat(
                [take_embeddings(params["item_table"], cand_l[sl]),
                 take_embeddings(params["cate_table"], cates[sl])], -1,
            )                                               # (c, 2D)
            et = plan.constrain(et, ("dp", "tp"), None)
            # user tower depends on the target (target attention): the
            # attention per candidate over the shared history embeddings
            user = _din_user_embed(params, hist_items, eh, et)   # (c, 2D)
            x = _cat([user, et], -1)
            return _mlp_apply(params["mlp"], x)[:, 0]
    elif isinstance(cfg, (DLRMConfig, DCNConfig)):
        dense1 = _dense(batch["dense"], dev)
        sparse1 = _ids(batch["sparse"], dev)
        fwd = _dlrm_forward if isinstance(cfg, DLRMConfig) else _dcn_forward

        def score(sl):
            c = cand_l[sl].shape[0]
            dense = dense1.expand(c, dense1.shape[-1])
            sparse = sparse1.expand(c, sparse1.shape[-1]).clone()
            # candidate id replaces the item feature column (feature 0)
            sparse[:, 0] = cand_l[sl]
            sparse = plan.constrain(sparse, ("dp", "tp"), None)
            return fwd(params, dense, sparse, cfg, plan)
    else:
        raise TypeError(type(cfg))
    step = RETRIEVAL_CHUNK
    scores = torch.cat([score(slice(s, s + step))
                        for s in range(0, cand.shape[0], step)])
    return scores, cand


# ---------------------------------------------------------------------------
# rows over the mesh: each rank scores its shard of the rows
# ---------------------------------------------------------------------------


def _place(x, plan: ShardPlan, spec, dev):
    """A batch leaf (numpy, tensor or DTensor) placed by ``spec`` (no
    mesh: a tensor on ``dev``)."""
    if isinstance(x, DTensor):
        return x
    return plan.place(torch.as_tensor(x, device=dev), spec)


def _rows(fn, params, batch, cfg, plan: ShardPlan, *, out, specs=None):
    """``fn(params, batch, cfg, plan)``, with no mesh bound the plain
    call.  Under a bound mesh ``fn(..., LOCAL_PLAN)`` runs on every rank's
    shard of the rows: each batch leaf over dp (or by ``specs``, where a
    leaf it does not name is replicated), every leaf of ``params`` whole
    on each rank.  The callers pass the small leaves: DIN looks its item
    rows up first (``_take``); SASRec's table and the retrieval path's
    tables are gathered whole (SASRec's lookups of every position would
    move more bytes than its table; the retrieval's candidates lie over
    dp and tp).  ``out``: the output's placements (a list of them for
    several outputs)."""
    if plan.mesh is None:
        return fn(params, batch, cfg, plan)
    p_leaves = base.tree_leaves(params)
    dev = p_leaves[0].device
    keys = list(batch)
    ins = []
    for k in keys:
        nd = np.ndim(batch[k]) if not isinstance(batch[k], torch.Tensor) \
            else batch[k].dim()
        spec = plan.p("dp", *([None] * (nd - 1))) if specs is None else \
            specs.get(k, plan.p(*([None] * nd)))
        ins.append((_place(batch[k], plan, spec, dev),
                    plan.spec_placements(spec)))
    ins += [(w, plan.placements(*([None] * w.dim()))) for w in p_leaves]
    n_b, n_p = len(keys), len(p_leaves)

    def on_rank(*xs):
        it = iter(xs[n_b:n_b + n_p])
        args = (base.tree_map(lambda _: next(it), params),
                dict(zip(keys, xs[:n_b])), cfg, LOCAL_PLAN)
        return fn(*args)

    return local_region(plan.mesh, on_rank, ins, out)


def loss_from_logits(logits, label, plan: ShardPlan = LOCAL_PLAN):
    """The CTR loss and its aux from the logits (over dp under a mesh)
    and the labels (numpy, a tensor or a DTensor over dp), reduced as on
    one card."""
    y = _place(label, plan, plan.p("dp"), local(logits).device)
    y = local_region(plan.mesh, lambda t: t.float(),
                     [(y, plan.layout("dp"))], plan.layout("dp"))
    return _reduce(_ctr_reduce, (logits, y), ["accuracy", "loss"], plan)


def _reduce(fn, parts, names, plan: ShardPlan):
    """``fn`` of the row terms gathered whole on every rank: the loss and
    its aux (``names``, sorted) as on one card, replicated; the aux as
    local tensors."""
    ins = [(t, plan.layout(*([None] * t.dim()))) for t in parts]

    def on_rank(*ts):
        loss, aux = fn(*ts)
        return (loss,) + tuple(aux[k] for k in names)

    out = local_region(plan.mesh, on_rank, ins,
                       [plan.layout()] * (1 + len(names)))
    return out[0], {k: local(v) for k, v in zip(names, out[1:])}


def mips_augment(items: np.ndarray, users: np.ndarray):
    """MIPS -> L2 reduction (Bachrach et al.), as
    ``examples/retrieval_recsys.py`` serves a factorized model through the
    two-level index: items (N, d) gain a column sqrt(M^2 - ||v||^2), users
    (B, d) a zero, so ||u~ - v~||^2 = ||u||^2 + M^2 - 2 u.v and the L2
    nearest item is the largest inner product.  Returns (items (N, d + 1),
    users (B, d + 1), M^2), fp32 numpy."""
    norms2 = (items * items).sum(1, keepdims=True)
    m2 = norms2.max()
    aug_items = np.concatenate(
        [items, np.sqrt(np.maximum(m2 - norms2, 0.0))], axis=1
    ).astype(np.float32)
    aug_users = np.concatenate(
        [users, np.zeros((users.shape[0], 1))], axis=1
    ).astype(np.float32)
    return aug_items, aug_users, float(m2)
