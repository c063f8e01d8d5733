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

from repro_torch.analysis.annotations import hot_path
from repro_torch.configs.base import (DCNConfig, DINConfig, DLRMConfig,
                                      SASRecConfig)
from repro_torch.distributed.sharding import LOCAL_PLAN, ShardPlan
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


def _mlp_apply(p, x, *, act=torch.relu, final_act=None):
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = _mm(x, p[f"w{i}"]) + p[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


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
    """
    if e is None:
        e = take_embeddings(params["table"], sparse)       # (B, 26, D)
    z0 = _mlp_apply(params["bot"], dense, act=torch.relu,
                    final_act=torch.relu)                  # (B, D)
    z = _cat([z0[:, None, :], e], 1)                       # (B, 27, D)
    inter = torch.einsum("bfd,bgd->bfg", z, z)             # (B, 27, 27)
    f = z.shape[1]
    iu, ju = np.triu_indices(f, k=1)
    flat = inter[:, torch.as_tensor(iu, device=z.device),
                 torch.as_tensor(ju, device=z.device)]     # (B, 351)
    x = _cat([z0, flat], 1)
    return _mlp_apply(params["top"], x)[:, 0]


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
    if e is None:
        e = take_embeddings(params["table"], sparse)       # (B, 26, D)
    x0 = _cat([dense, e.reshape(e.shape[0], -1)], 1)
    x = x0
    for i in range(cfg.n_cross_layers):
        xw = _mm(x, params[f"cross_w{i}"]) + params[f"cross_b{i}"]
        x = x0 * xw + x                                     # DCN-v2 cross
    return _mlp_apply(params["mlp"], x)[:, 0]


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
    dev = _device(params)
    et = _cat(
        [take_embeddings(params["item_table"],
                         _ids(batch["target_item"], dev)),
         take_embeddings(params["cate_table"],
                         _ids(batch["target_cate"], dev))], -1,
    )                                                       # (B, 2D)
    hist_items = _ids(batch["hist_items"], dev)
    eh = _din_history(params, hist_items, _ids(batch["hist_cates"], dev))
    user = _din_user_embed(params, hist_items, eh, et)
    x = _cat([user, et], -1)
    return _mlp_apply(params["mlp"], x)[:, 0]


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


def _sasrec_loss(params, batch, cfg: SASRecConfig, plan):
    """BCE over (positive next item, sampled negative) per position."""
    dev = _device(params)
    h = _sasrec_hidden(params, batch["seq"], cfg, plan)     # (B, L, D)
    pos = _ids(batch["pos"], dev)
    pos_e = take_embeddings(params["item_table"], pos)
    neg_e = take_embeddings(params["item_table"], _ids(batch["neg"], dev))
    pos_s = (h * pos_e).sum(-1)
    neg_s = (h * neg_e).sum(-1)
    mask = (pos >= 0).float()
    loss = -(F.logsigmoid(pos_s) + F.logsigmoid(-neg_s))
    loss = (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss}


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
                             dtype=dtype, device=device)


def param_specs(cfg, plan: ShardPlan):
    return base.build_specs(partial(_param_fn, plan=plan), cfg)


def param_shapes(cfg, plan: ShardPlan = LOCAL_PLAN):
    """``meta`` tensors of every parameter's shape and dtype."""
    return base.build_shapes(partial(_param_fn, plan=plan), cfg)


@hot_path
def serve_logits(params, batch, cfg, plan: ShardPlan = LOCAL_PLAN):
    """Pointwise CTR logits for a request batch."""
    dev = _device(params)
    if isinstance(cfg, DLRMConfig):
        return _dlrm_forward(params, _dense(batch["dense"], dev),
                             _ids(batch["sparse"], dev), cfg, plan)
    if isinstance(cfg, DCNConfig):
        return _dcn_forward(params, _dense(batch["dense"], dev),
                            _ids(batch["sparse"], dev), cfg, plan)
    if isinstance(cfg, DINConfig):
        return _din_forward(params, batch, cfg, plan)
    if isinstance(cfg, SASRecConfig):
        h = _sasrec_hidden(params, batch["seq"], cfg, plan)
        e = take_embeddings(params["item_table"],
                            _ids(batch["target_item"], dev))
        return (h[:, -1] * e).sum(-1)
    raise TypeError(type(cfg))


@hot_path
def loss_fn(params, batch, cfg, plan: ShardPlan = LOCAL_PLAN):
    """BCE with logits against batch['label'] (SASRec: in-sequence BCE)."""
    if isinstance(cfg, SASRecConfig):
        return _sasrec_loss(params, batch, cfg, plan)
    logits = serve_logits(params, batch, cfg, plan)
    y = _dense(batch["label"], logits.device)
    loss = torch.mean(
        torch.clamp(logits, min=0) - logits * y
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    acc = torch.mean(((logits > 0) == (y > 0.5)).float())
    return loss, {"loss": loss, "accuracy": acc}


@hot_path
def ctr_forward_gathered(rest, e, batch, cfg, plan: ShardPlan = LOCAL_PLAN):
    """DLRM/DCN forward with pre-gathered embeddings (sparse-update path).

    ``rest`` is the param tree minus the table (table may be absent)."""
    fwd = _dlrm_forward if isinstance(cfg, DLRMConfig) else _dcn_forward
    dev = e.device
    return fwd(rest, _dense(batch["dense"], dev), _ids(batch["sparse"], dev),
               cfg, plan, e=e)


@hot_path
def retrieval_logits(params, batch, cfg, plan: ShardPlan = LOCAL_PLAN,
                     k: int = 100):
    """Score 1 user against n_candidates items; return (scores, ids) top-k.

    Factorized models (DIN/SASRec): user vector . candidate embeddings — the
    paper's exact ANN problem (swap in the two-level index at serve time).
    Joint models (DLRM/DCN): full forward over candidate-expanded rows.
    The candidates are scored ``RETRIEVAL_CHUNK`` at a time (each on its
    own, so any chunk gives the same scores up to the products' rounding).
    """
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
    neg, ids = stable_topk(-scores.float()[None], k)
    return -neg[0], cand[ids[0]]   # highest-scoring candidates, descending


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
