"""Decoder-only LM covering all five transformer archs: the port of
``repro/models/transformer.py``.

  qwen3-14b / qwen3-0.6b : GQA + qk-norm + SwiGLU
  granite-34b            : MQA (kv=1) + GELU MLP (2-matrix, code model)
  deepseek-v3-671b       : MLA + MoE(256e top-8, 1 shared) + MTP
  kimi-k2-1t-a32b        : MLA + MoE(384e top-8, 1 shared)

Functional, as the reference: ``init(cfg, seed, device=...)`` builds the
parameter tree (nested dicts of tensors, repeated layers stacked
``(L, ...)`` per stack -- the reference's layout leaf for leaf, so
``convert.lm_params_from_arrays`` carries its weights across unchanged)
and ``param_specs`` its ``ShardPlan.p`` twin; ``loss_fn`` / ``prefill`` /
``decode_step`` read the tree and return new values.  Layers run in a
Python loop over each stack (dense first, then MoE), each layer's slice a
view.  The forward runs in the dtype policy of ``set_precision``
(``COMPUTE_DTYPE`` for the layer math, ``CACHE_DTYPE`` for the KV cache;
bf16 both by default, fp32 where a test separates logic from rounding),
the residual stream in ``cfg.residual_dtype``.

The decode cache is written in place: ``decode_step`` stores the new K/V
(MLA: latent and rope key) of each row at ``lengths`` with one indexed
write (the reference selects a one-hot over the whole cache, a TPU SPMD
workaround that reads and writes every slot; the values written are the
same) and returns the same cache tensors with ``lengths + 1``.  MLA decode
uses the absorbed-latent path, so the cache holds (kv_lora + rope) per
token.

One code path serves one card and a mesh.  Each stretch of a layer
between two of the reference's ``with_sharding_constraint`` calls is a
``sharding.local_region``: with no mesh bound (``LOCAL_PLAN``) it is the
plain call on plain tensors.  Under a bound mesh (``plan.with_mesh``;
``launch.cells`` binds the reference's cells) the parameters are DTensors
placed by ``param_specs``, the tokens are placed over ``dp``, and each
region's inputs are moved to the constraint's placements first: the FSDP
gathers, the sequence-sharded residual (``_res_constrain``), the MoE
all-to-all (``moe.py``) and the vocabulary-sharded logits.  Attention
splits over ``tp`` by two head rules (``_attn_split``): where the query
heads divide tp they split, with the KV heads split too where those
divide it, else the whole K and V weights on each rank and the KV heads
its query heads read taken from them (``_kv_select``); where the query
heads do not divide tp and the residual's sequence lies over it, each
rank attends with its own sequence shard of the queries against the
gathered K and V (``_attention_seq``).  The loss is vocabulary-parallel
(``_xent``): the logits stay sharded over tp and only per-token terms
are all-reduced.  DTensor's own sharding propagation is not relied on
(its rules for these ops differ between torch releases and several are
missing).

``loss_fn`` is differentiable (``repro_torch.train`` takes its gradient
with ``torch.autograd``).  ``cfg.remat`` is read as the reference reads it:
when it is set and a gradient is wanted, each layer (and the MTP layer)
runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
the counterpart of ``jax.checkpoint``, so the backward recomputes a
layer's activations from its input; the recompute gives the same forward
(MoE routing is a deterministic top-k).  ``cfg.scan_layers`` has no
counterpart: the reference chooses between ``lax.scan`` and an unrolled
loop, and here a loop over the stack is a loop.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.annotations import hot_path
from repro_torch.configs.base import LMConfig
from repro_torch.distributed.sharding import (LOCAL_PLAN, ShardPlan,
                                              layer_of, local, local_offset,
                                              local_region, move)
from repro_torch.models import base
from repro_torch.models.attention import _ein, attention, decode_attention
from repro_torch.models.layers import (gelu_mlp, rms_norm, rope, rope_tables,
                                       swiglu, xent_reduce, xent_shard_max,
                                       xent_shard_terms, xent_token)
from repro_torch.models.moe import moe_ffn, moe_params

__all__ = ["init", "param_specs", "param_shapes", "loss_fn", "prefill",
           "decode_step", "cache_shapes", "cache_specs", "LMConfig",
           "set_precision"]

# precision policy: compute dtype for layer math, storage dtype for the KV
# cache.  bf16/bf16 in production; tests flip to fp32 to separate numerics
# from logic.
COMPUTE_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16


def set_precision(compute=torch.bfloat16, cache=torch.bfloat16):
    global COMPUTE_DTYPE, CACHE_DTYPE
    COMPUTE_DTYPE = compute
    CACHE_DTYPE = cache


MTP_WEIGHT = 0.3


# ---------------------------------------------------------------------------
# parameter description
# ---------------------------------------------------------------------------


def _attn_params(cfg: LMConfig, mk, plan: ShardPlan, prefix: str, L: int):
    d = cfg.d_model

    def pp(*dims):
        return plan.p(None, *dims)

    tp_n = max(plan.axis_size("tp"), 1)
    kv_tp = "tp" if cfg.n_kv_heads % tp_n == 0 else None
    q_tp = "tp" if cfg.n_heads % tp_n == 0 else None
    p = {
        "ln1": mk(f"{prefix}/ln1", (L, d), pp(None), init="ones"),
        "ln2": mk(f"{prefix}/ln2", (L, d), pp(None), init="ones"),
    }
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        p.update({
            "w_dq": mk(f"{prefix}/w_dq", (L, d, m.q_lora_rank),
                       pp("fsdp", None)),
            "q_ln": mk(f"{prefix}/q_ln", (L, m.q_lora_rank), pp(None),
                       init="ones"),
            "w_uq": mk(f"{prefix}/w_uq", (L, m.q_lora_rank, cfg.n_heads, qk),
                       pp(None, q_tp, None)),
            "w_dkv": mk(f"{prefix}/w_dkv", (L, d, m.kv_lora_rank),
                        pp("fsdp", None)),
            "kv_ln": mk(f"{prefix}/kv_ln", (L, m.kv_lora_rank), pp(None),
                        init="ones"),
            "w_kr": mk(f"{prefix}/w_kr", (L, d, m.qk_rope_head_dim),
                       pp("fsdp", None)),
            "w_uk": mk(f"{prefix}/w_uk",
                       (L, m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim),
                       pp(None, q_tp, None)),
            "w_uv": mk(f"{prefix}/w_uv",
                       (L, m.kv_lora_rank, cfg.n_heads, m.v_head_dim),
                       pp(None, q_tp, None)),
            "w_o": mk(f"{prefix}/w_o",
                      (L, cfg.n_heads, m.v_head_dim, d),
                      pp(q_tp, None, "fsdp")),
        })
    else:
        dh = cfg.d_head
        p.update({
            "w_q": mk(f"{prefix}/w_q", (L, d, cfg.n_heads, dh),
                      pp("fsdp", q_tp, None)),
            "w_k": mk(f"{prefix}/w_k", (L, d, cfg.n_kv_heads, dh),
                      pp("fsdp", kv_tp, None)),
            "w_v": mk(f"{prefix}/w_v", (L, d, cfg.n_kv_heads, dh),
                      pp("fsdp", kv_tp, None)),
            "w_o": mk(f"{prefix}/w_o", (L, cfg.n_heads, dh, d),
                      pp(q_tp, None, "fsdp")),
        })
        if cfg.qk_norm:
            p["q_norm"] = mk(f"{prefix}/q_norm", (L, dh), pp(None),
                             init="ones")
            p["k_norm"] = mk(f"{prefix}/k_norm", (L, dh), pp(None),
                             init="ones")
    return p


def _mlp_params(cfg: LMConfig, mk, plan, prefix: str, L: int, d_ff: int):
    d = cfg.d_model

    def pp(*dims):
        return plan.p(None, *dims)

    if cfg.mlp_kind == "gelu":
        return {
            "w_up": mk(f"{prefix}/w_up", (L, d, d_ff), pp("fsdp", "tp")),
            "w_down": mk(f"{prefix}/w_down", (L, d_ff, d),
                         pp("tp", "fsdp")),
        }
    return {
        "w_gate": mk(f"{prefix}/w_gate", (L, d, d_ff), pp("fsdp", "tp")),
        "w_up": mk(f"{prefix}/w_up", (L, d, d_ff), pp("fsdp", "tp")),
        "w_down": mk(f"{prefix}/w_down", (L, d_ff, d), pp("tp", "fsdp")),
    }


def _param_fn(cfg: LMConfig, mk, plan: ShardPlan):
    d, v = cfg.d_model, cfg.vocab
    n_dense = cfg.n_dense_layers if cfg.moe else cfg.n_layers
    n_moe = cfg.n_moe_layers
    params = {
        "embed": mk("embed", (v, d), plan.p("tp", "fsdp"),
                    init=("normal", 0.02)),
        "final_norm": mk("final_norm", (d,), plan.p(None), init="ones"),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = mk("unembed", (d, v), plan.p("fsdp", "tp"))
    if n_dense:
        params["dense_layers"] = {
            **_attn_params(cfg, mk, plan, "dense/attn", n_dense),
            **_mlp_params(cfg, mk, plan, "dense/mlp", n_dense, cfg.d_ff),
        }
    if n_moe:
        params["moe_layers"] = {
            **_attn_params(cfg, mk, plan, "moe/attn", n_moe),
            **moe_params(cfg, mk, plan, "moe/mlp", n_moe),
        }
    if cfg.mtp:
        params["mtp"] = {
            "proj": mk("mtp/proj", (2 * d, d), plan.p("fsdp", None)),
            "norm_h": mk("mtp/norm_h", (d,), plan.p(None), init="ones"),
            "norm_e": mk("mtp/norm_e", (d,), plan.p(None), init="ones"),
            **_attn_params(cfg, mk, plan, "mtp/attn", 1),
            **_mlp_params(cfg, mk, plan, "mtp/mlp", 1,
                          cfg.moe.d_ff * 8 if cfg.moe else cfg.d_ff),
        }
    return params


def _param_dtype(cfg: LMConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def init(cfg: LMConfig, seed: int = 0, plan: ShardPlan = LOCAL_PLAN,
         device=None):
    """The parameter tree, initialised from ``seed`` on ``device``
    (``None``: the card)."""
    return base.build_params(partial(_param_fn, plan=plan), cfg, seed,
                             dtype=_param_dtype(cfg), device=device,
                             plan=plan)


def param_specs(cfg: LMConfig, plan: ShardPlan):
    return base.build_specs(partial(_param_fn, plan=plan), cfg)


def param_shapes(cfg: LMConfig, plan: ShardPlan = LOCAL_PLAN):
    """``meta`` tensors of every parameter's shape and dtype."""
    return base.build_shapes(partial(_param_fn, plan=plan), cfg,
                             dtype=_param_dtype(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
#
# Each stretch of a layer between two of the reference's constraints is one
# ``sharding.local_region``: with no mesh bound it calls its function on the
# tensors as they are; under a mesh it first moves every input to the
# placements of the reference's constraint (``plan.layout``: the FSDP
# gathers, the heads over tp, the sequence-sharded residual, the vocabulary
# over tp) and runs the function on each rank's shards.  A stretch whose
# heads or hidden units lie over tp returns a partial sum over tp, reduced
# where it meets the residual.  The functions below the regions take plain
# tensors.


def _res_dims(x, cfg: LMConfig, plan: ShardPlan) -> tuple:
    """The residual's roles: its sequence over tp for ``attn_shard``
    "seq", where the sequence divides tp.  A decode step's one token does
    not: the reference pads it to tp rows, and here it stays whole over
    tp, since a region's shards are even (``local_region``)."""
    if cfg.attn_shard == "seq" and \
            x.shape[1] % max(plan.axis_size("tp"), 1) == 0:
        return ("dp", "tp", None)
    return ("dp", None, None)


def _res_constrain(x, cfg: LMConfig, plan: ShardPlan):
    return plan.constrain(x, *_res_dims(x, cfg, plan))


def _residual_add(x, y, cfg: LMConfig, plan: ShardPlan):
    """``x + y`` in the residual's placements (``y`` may be a partial
    sum over tp)."""
    pl = plan.layout(*_res_dims(x, cfg, plan))
    return local_region(plan.mesh, torch.add, [(x, pl), (y, pl)], pl)


def _head_roles(cfg: LMConfig, plan: ShardPlan):
    """The reference's ``(q_tp, kv_tp)``: "tp" where the query (KV)
    heads divide tp, else None."""
    tp_n = max(plan.axis_size("tp"), 1)
    q_tp = "tp" if cfg.n_heads % tp_n == 0 else None
    kv_tp = "tp" if cfg.n_kv_heads % tp_n == 0 else None
    return q_tp, kv_tp


def _attn_split(x, cfg: LMConfig, plan: ShardPlan) -> str:
    """How one layer's attention splits its work over tp, as the
    reference's constraints place it: "heads" where the query heads
    divide tp (their projections and attention over tp; MLA's heads too),
    "seq" where they do not and the residual's sequence lies over tp
    (GQA under ``attn_shard`` "seq": each rank attends with its own
    sequence shard of the queries), else "whole" (every head on every
    rank: a decode step's one token)."""
    if _head_roles(cfg, plan)[0]:
        return "heads"
    if cfg.attn_kind != "mla" and _res_dims(x, cfg, plan)[1] == "tp":
        return "seq"
    return "whole"


def _kv_select(cfg: LMConfig, plan: ShardPlan):
    """Where the query heads split over tp and the KV heads do not
    (qwen3-0.6b's 8 over 16, granite's one): the KV heads this rank's
    query heads read under GQA's map ``h -> h // (H / n_kv)``, out of the
    whole ``w_k`` / ``w_v`` each rank holds (the reference's replicated K
    and V).  A slice where they all read one head (tp a multiple of
    n_kv), else one index a query head; None where nothing is
    selected."""
    q_tp, kv_tp = _head_roles(cfg, plan)
    if cfg.attn_kind == "mla" or not q_tp or kv_tp:
        return None
    h0, hq = plan.chunk(cfg.n_heads, "tp")
    group = cfg.n_heads // cfg.n_kv_heads
    idx = [(h0 + j) // group for j in range(hq)]
    if len(set(idx)) == 1:
        return slice(idx[0], idx[0] + 1)
    return idx


def _head_tp(cfg: LMConfig, plan: ShardPlan, split: str) -> tuple:
    """The roles of the query heads and of the KV heads under ``split``
    (MLA's per-head K and V follow its query heads)."""
    if split != "heads":
        return None, None
    q_tp, kv_tp = _head_roles(cfg, plan)
    return q_tp, q_tp if cfg.attn_kind == "mla" else kv_tp


def _weights(p: dict, roles: dict, plan: ShardPlan) -> list:
    return [(p[k], plan.layout(*r)) for k, r in roles.items()]


def _attn_roles(cfg: LMConfig, q, kv) -> dict:
    """The layer-sliced attention weights and their roles where the
    reference's ``_gather_fsdp`` / head constraints put them (``q`` /
    ``kv``: the query and KV heads' roles, "tp" or None)."""
    if cfg.attn_kind == "mla":
        return {"w_dq": (None, None), "q_ln": (None,),
                "w_uq": (None, q, None), "w_dkv": (None, None),
                "kv_ln": (None,), "w_kr": (None, None),
                "w_uk": (None, q, None), "w_uv": (None, q, None),
                "w_o": (q, None, None)}
    roles = {"w_q": (None, q, None), "w_k": (None, kv, None),
             "w_v": (None, kv, None), "w_o": (q, None, None)}
    if cfg.qk_norm:
        roles.update(q_norm=(None,), k_norm=(None,))
    return roles


def _batch(x, plan: ShardPlan, dtype, dev):
    """A batch leaf (numpy or tensor) as ``dtype`` on ``dev``, placed over
    dp under a mesh (a DTensor as it is)."""
    if isinstance(x, DTensor):
        return x.to(dtype)
    t = torch.as_tensor(x, device=dev).to(dtype)
    return plan.distribute(t, "dp", *([None] * (t.dim() - 1)))


def _rope_dim(cfg: LMConfig) -> int:
    return cfg.mla.qk_rope_head_dim if cfg.attn_kind == "mla" \
        else cfg.d_head


def _positions(s: int, cfg: LMConfig, dev):
    return rope_tables(torch.arange(s, dtype=torch.int64, device=dev),
                       _rope_dim(cfg), cfg.rope_theta)


# the layer math, on plain tensors ----------------------------------------


def _mla_query(h, w_dq, q_ln, w_uq, cfg: LMConfig, cos, sin):
    """MLA's query of hidden ``h``: (no-rope part, roped part)."""
    return _mla_query_heads(rms_norm(h @ w_dq, q_ln), w_uq, cfg, cos, sin)


def _mla_query_heads(cq, w_uq, cfg: LMConfig, cos, sin):
    """MLA's query of its normed latent ``cq``: (no-rope part, roped
    part)."""
    m = cfg.mla
    q = torch.einsum("bsr,rhk->bshk", cq, w_uq)
    return q[..., : m.qk_nope_head_dim], \
        rope(q[..., m.qk_nope_head_dim:], cos, sin)


def _mla_latent(h, w_dkv, w_kr, kv_ln, cos, sin):
    """MLA's cache entries of hidden ``h``: the normed kv latent and the
    roped key shared by every head (B, S, rope)."""
    ckv = rms_norm(h @ w_dkv, kv_ln)
    return ckv, _rope_key(h @ w_kr, cos, sin)


def _rope_key(kr, cos, sin):
    """MLA's key shared by every head (B, S, rope), roped."""
    return rope(kr[:, :, None], cos, sin)[:, :, 0]


def _gqa_q(h, w_q, q_norm, cos, sin):
    q = torch.einsum("bsd,dhk->bshk", h, w_q)
    if q_norm is not None:
        q = rms_norm(q, q_norm)
    return rope(q, cos, sin)


def _gqa_kv(h, w_k, w_v, k_norm, cos, sin):
    """GQA's cache entries of hidden ``h``: the roped keys and the
    values."""
    k = torch.einsum("bsd,dhk->bshk", h, w_k)
    v = torch.einsum("bsd,dhk->bshk", h, w_v)
    if k_norm is not None:
        k = rms_norm(k, k_norm)
    return rope(k, cos, sin), v


def _attention_block(p, h, cfg: LMConfig, cos, sin, kv_sel=None):
    """GQA.  h: post-ln1 hidden (B, S, D) -> attn output (B, S, D).
    ``p`` is the layer's attention weights cast to the compute dtype
    (MLA: ``_mla_latents`` and ``_mla_block``); ``kv_sel``
    (``_kv_select``): the KV heads the query heads read, the only ones
    projected (their slice of the whole ``w_k`` / ``w_v``)."""
    q = _gqa_q(h, p["w_q"], p.get("q_norm"), cos, sin)
    w_k, w_v = p["w_k"], p["w_v"]
    if kv_sel is not None:
        w_k, w_v = w_k[:, kv_sel], w_v[:, kv_sel]
    k, v = _gqa_kv(h, w_k, w_v, p.get("k_norm"), cos, sin)
    o = attention(q, k, v, causal=True, chunk=cfg.attn_chunk or None)
    return torch.einsum("bshk,hkd->bsd", o, p["w_o"])


def _mla_latents(p, h):
    """MLA's low-rank projections of hidden ``h``, every head's: the
    normed query and kv latents and the key shared by every head, before
    its rope."""
    return (rms_norm(h @ p["w_dq"], p["q_ln"]),
            rms_norm(h @ p["w_dkv"], p["kv_ln"]), h @ p["w_kr"])


def _mla_block(p, cq, ckv, kr, cfg: LMConfig, cos, sin):
    """MLA's heads from its latents (``_mla_latents``) -> attn output
    (B, S, D); ``p`` the layer's up and output projections, cast."""
    m = cfg.mla
    q_nope, q_rope = _mla_query_heads(cq, p["w_uq"], cfg, cos, sin)
    k_rope = _rope_key(kr, cos, sin)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    k = torch.cat(
        [k_nope, k_rope[:, :, None].expand(*k_nope.shape[:3],
                                           k_rope.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o = attention(q, k, v, causal=True, chunk=cfg.attn_chunk or None,
                  scale=scale)
    return torch.einsum("bshk,hkd->bsd", o, p["w_o"])


def _mlp_block(p, h, cfg: LMConfig):
    if cfg.mlp_kind == "gelu":
        return gelu_mlp(h, p["w_up"], p["w_down"])
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


# the regions ------------------------------------------------------------


def _attention(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin):
    """ln1 and the attention block of one layer, over the batch's shards
    and as ``_attn_split`` splits it: the heads' shard (a partial sum over
    tp), the queries' sequence shard (``_attention_seq``) or every head."""
    split = _attn_split(x, cfg, plan)
    if split == "seq":
        return _attention_seq(p, x, cfg, plan, cos, sin)
    if cfg.attn_kind == "mla":
        return _attention_mla(p, x, cfg, plan, cos, sin, split)
    q_tp, kv_tp = _head_tp(cfg, plan, split)
    roles = {"ln1": (None,), **_attn_roles(cfg, q_tp, kv_tp)}
    names = list(roles)
    cdt, xdt = COMPUTE_DTYPE, x.dtype
    kv_sel = _kv_select(cfg, plan)

    def fn(x_, *ws):
        w = dict(zip(names, ws))
        h = rms_norm(x_, w["ln1"]).to(cdt)
        return _attention_block(base.cast_tree(w, cdt), h, cfg, cos, sin,
                                kv_sel).to(xdt)

    flat = plan.layout("dp", None, None)
    return local_region(plan.mesh, fn,
                        [(x, flat)] + _weights(p, roles, plan),
                        plan.partial(flat, "tp") if q_tp else flat)


def _attention_mla(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin,
                   split: str):
    """ln1 and MLA in two regions, as the reference's program splits it:
    the low-rank projections (``_mla_latents``) on the residual's own
    shard (its sequence shard over tp, where it lies there), then the
    latents gathered whole over tp (2,112 of kimi-k2's 7,168 widths) and
    the heads on the heads' shard (a partial sum over tp) or, where they
    do not divide tp, every head."""
    q_tp, _ = _head_tp(cfg, plan, split)
    roles = _attn_roles(cfg, q_tp, q_tp)
    low = ("w_dq", "q_ln", "w_dkv", "kv_ln", "w_kr")
    heads = [k for k in roles if k not in low]
    cdt, xdt = COMPUTE_DTYPE, x.dtype

    def latents(x_, ln1, *ws):
        h = rms_norm(x_, ln1).to(cdt)
        return _mla_latents(base.cast_tree(dict(zip(low, ws)), cdt), h)

    def block(cq, ckv, kr, *ws):
        pc = base.cast_tree(dict(zip(heads, ws)), cdt)
        return _mla_block(pc, cq, ckv, kr, cfg, cos, sin).to(xdt)

    res = plan.layout(*_res_dims(x, cfg, plan))
    lat = local_region(
        plan.mesh, latents,
        [(x, res), (p["ln1"], plan.layout(None))]
        + _weights(p, {k: roles[k] for k in low}, plan), [res] * 3)
    flat = plan.layout("dp", None, None)
    return local_region(
        plan.mesh, block, [(t, flat) for t in lat]
        + _weights(p, {k: roles[k] for k in heads}, plan),
        plan.partial(flat, "tp") if q_tp else flat)


def _seq_shard(s: int, plan: ShardPlan, cos, sin):
    """This rank's sequence shard over tp: its global positions and
    their rope tables."""
    s0, n = plan.chunk(s, "tp")
    pos = torch.arange(s0, s0 + n, dtype=torch.int64, device=cos.device)
    return pos, cos[s0:s0 + n], sin[s0:s0 + n]


def _attention_seq(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin):
    """GQA attention with the queries over their sequence shard (the
    query heads do not divide tp; the residual's sequence lies over it):
    each rank projects Q, K and V of its own tokens with the whole
    weights, K and V of the whole sequence are gathered over tp, and each
    rank attends with its queries, the causal mask at their global
    positions.  The output stays on the residual's sequence shard."""
    pos, cl, sl = _seq_shard(x.shape[1], plan, cos, sin)
    roles = {"ln1": (None,), **_attn_roles(cfg, None, None)}
    w_o = roles.pop("w_o")
    names = list(roles)
    cdt, xdt = COMPUTE_DTYPE, x.dtype
    chunk = cfg.attn_chunk or None

    def qkv(x_, *ws):
        w = dict(zip(names, ws))
        pc = base.cast_tree(w, cdt)
        h = rms_norm(x_, w["ln1"]).to(cdt)
        return (_gqa_q(h, pc["w_q"], pc.get("q_norm"), cl, sl),) + _gqa_kv(
            h, pc["w_k"], pc["w_v"], pc.get("k_norm"), cl, sl)

    def att(q, k, v, w_o_):
        o = attention(q, k, v, causal=True, chunk=chunk, q_pos=pos)
        return torch.einsum("bshk,hkd->bsd", o, w_o_.to(cdt)).to(xdt)

    seq, heads = plan.layout("dp", "tp", None), plan.layout("dp", "tp",
                                                            None, None)
    q, k, v = local_region(plan.mesh, qkv,
                           [(x, seq)] + _weights(p, roles, plan),
                           [heads] * 3)
    whole = plan.layout("dp", None, None, None)
    return local_region(plan.mesh, att,
                        [(q, heads), (k, whole), (v, whole),
                         (p["w_o"], plan.layout(*w_o))], seq)


def _mlp(p, x, cfg: LMConfig, plan: ShardPlan, *, moe: bool):
    """ln2 and the MLP of one layer (dense: the hidden units over tp, a
    partial sum; MoE: ``moe_ffn``'s regions and all-to-all)."""
    cdt, xdt = COMPUTE_DTYPE, x.dtype
    flat = plan.layout("dp", None, None)
    ln2 = [(x, flat), (p["ln2"], plan.layout(None))]
    if moe:
        h = local_region(plan.mesh, lambda x_, ln: rms_norm(x_, ln).to(cdt),
                         ln2, flat)
        return moe_ffn(p, h, cfg, plan, cast=cdt, out_dtype=xdt)
    if cfg.mlp_kind == "gelu":
        roles = {"w_up": (None, "tp"), "w_down": ("tp", None)}
    else:
        roles = {"w_gate": (None, "tp"), "w_up": (None, "tp"),
                 "w_down": ("tp", None)}
    names = list(roles)

    def fn(x_, ln, *ws):
        h = rms_norm(x_, ln).to(cdt)
        return _mlp_block(base.cast_tree(dict(zip(names, ws)), cdt), h,
                          cfg).to(xdt)

    return local_region(plan.mesh, fn, ln2 + _weights(p, roles, plan),
                        plan.partial(flat, "tp"))


def _layer(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin, *, moe: bool):
    x = _residual_add(x, _attention(p, x, cfg, plan, cos, sin), cfg, plan)
    return _residual_add(x, _mlp(p, x, cfg, plan, moe=moe), cfg, plan)


def _run_layer(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin, *,
               moe: bool):
    """``_layer``, under ``checkpoint`` when ``cfg.remat`` is set and a
    gradient is wanted (the residual stream carries one whenever the
    parameters do)."""
    if cfg.remat and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(_layer, p, x, cfg, plan, cos, sin, moe=moe,
                          use_reentrant=False)
    return _layer(p, x, cfg, plan, cos, sin, moe=moe)


def _res_dtype(cfg: LMConfig):
    return torch.bfloat16 if cfg.residual_dtype == "bfloat16" \
        else torch.float32


def _stacks(params: dict):
    """(stack, is_moe, n_layers) per stack, in layer order: the dense
    stack, then the MoE stack (``_stacked_layer_params``)."""
    return [(params[name], name == "moe_layers",
             next(iter(params[name].values())).shape[0])
            for name in ("dense_layers", "moe_layers") if name in params]


def _layer_params(stack: dict, i: int) -> dict:
    return {k: layer_of(v, i) for k, v in stack.items()}


def _embed(params: dict, tokens, cfg: LMConfig, plan: ShardPlan):
    """The token rows of the (gathered) table over the batch's shards."""
    rdt = _res_dtype(cfg)
    x = local_region(plan.mesh, lambda e, t: e[t].to(rdt),
                     [(params["embed"], plan.layout(None, None)),
                      (tokens, plan.layout("dp", None))],
                     plan.layout("dp", None, None))
    return _res_constrain(x, cfg, plan)


def _final(params: dict, x, plan: ShardPlan):
    """The final norm over the batch's shards (the whole sequence)."""
    flat = plan.layout("dp", None, None)
    return local_region(plan.mesh, rms_norm,
                        [(x, flat), (params["final_norm"], plan.layout(None))],
                        flat)


def _backbone(params: dict, tokens, cfg: LMConfig, plan: ShardPlan, cos,
              sin):
    """tokens (B, S) -> final-norm hidden (B, S, D)."""
    x = _embed(params, tokens, cfg, plan)
    for stack, moe, n in _stacks(params):
        for i in range(n):
            x = _run_layer(_layer_params(stack, i), x, cfg, plan, cos, sin,
                           moe=moe)
    return _final(params, x, plan)


def _logits(params: dict, h, cfg: LMConfig, plan: ShardPlan, last=False):
    """The logits, the vocabulary over tp; ``last``: the last position
    only, (B, V)."""
    if cfg.tie_embeddings:
        w, wdims, tied = params["embed"], ("tp", None), True
    else:
        w, wdims, tied = params["unembed"], (None, "tp"), False
    cdt = COMPUTE_DTYPE

    def fn(h_, w_):
        if last:
            h_ = h_[:, -1:, :]
        w_ = w_.T if tied else w_
        lg = h_.to(cdt) @ w_.to(cdt)
        return lg[:, 0] if last else lg

    out = plan.layout("dp", "tp") if last else plan.layout("dp", None, "tp")
    return local_region(plan.mesh, fn,
                        [(h, plan.layout("dp", None, None)),
                         (w, plan.layout(*wdims))], out)


def _xent(logits, labels, mask, plan: ShardPlan, z_loss: float):
    """``softmax_xent`` over vocabulary-parallel logits (dp, None, tp), as
    the reference reduces them: each rank's terms on its vocabulary shard,
    joined by all-reduces over tp of the max, of the sum of ``exp`` and
    of the label's logit (taken where the label falls in the shard); the
    log-sum-exp and the z-loss come from the reduced terms.  The
    prediction is the smallest global index that attains the global max
    (``jnp.argmax``'s ties), by an all-reduce min.  The max is a constant
    for the gradient and a sum's gradient comes back whole on every rank,
    so the backward is exact.  Then the masked token means, as on one
    card."""
    v = logits.shape[-1]
    v0, _ = plan.chunk(v, "tp")
    vocab, row = plan.layout("dp", None, "tp"), plan.layout("dp", None)
    m = move(local_region(plan.mesh, xent_shard_max, [(logits, vocab)],
                          plan.partial(row, "tp", "max")), row)
    parts = local_region(plan.mesh,
                         lambda lg, lb, m_: xent_shard_terms(lg, lb, m_, v0,
                                                             v),
                         [(logits, vocab), (labels, row), (m, row)],
                         [plan.partial(row, "tp", op)
                          for op in ("sum", "sum", "min")])
    nll, hit = local_region(plan.mesh,
                            lambda *t: xent_token(*t, z_loss),
                            [(m, row)] + [(move(t, row), row) for t in parts]
                            + [(labels, row)], [row, row])
    rep = plan.layout(None, None)
    ins = [(nll, rep), (hit, rep)]
    if mask is not None:
        ins.append((mask, rep))
    loss, acc = local_region(plan.mesh, lambda *t: _pair(xent_reduce(*t)),
                             ins, [plan.layout(), plan.layout()])
    return loss, {"nll": loss, "accuracy": acc}


def _pair(out):
    loss, aux = out
    return loss, aux["accuracy"]


@hot_path
def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            plan: ShardPlan = LOCAL_PLAN):
    """batch: {tokens (B,S), labels (B,S), mask optional} -> (loss, aux)."""
    dev = params["embed"].device
    tokens = _batch(batch["tokens"], plan, torch.int64, dev)
    labels = _batch(batch["labels"], plan, torch.int64, dev)
    mask = batch.get("mask")
    if mask is not None:
        mask = plan.constrain(_batch(mask, plan, torch.float32, dev), None,
                              None)
    cos, sin = _positions(tokens.shape[1], cfg, dev)
    h = _backbone(params, tokens, cfg, plan, cos, sin)
    loss, aux = _xent(_logits(params, h, cfg, plan), labels, mask, plan,
                      1e-4)
    if cfg.mtp and "mtp" in params:
        mtp_loss = _mtp_loss(params, h, tokens, labels, cfg, plan, mask,
                             cos, sin)
        aux["mtp_nll"] = mtp_loss
        loss = loss + MTP_WEIGHT * mtp_loss
    aux["loss"] = loss
    return loss, {k: local(v) for k, v in aux.items()}


def _shift(t):
    """``t`` shifted left by one position, its last entry repeated."""
    return torch.cat([t[:, 1:], t[:, -1:]], dim=1)


def _mtp_loss(params: dict, h, tokens, labels, cfg: LMConfig,
              plan: ShardPlan, mask, cos, sin):
    """DeepSeek-V3 MTP (depth 1): predict token t+2 from h_t ++ emb_{t+1}."""
    p = params["mtp"]
    rdt = _res_dtype(cfg)
    row = plan.layout("dp", None)

    def inp(h_, tok, e, nh, ne, proj):
        # condition on the next token's embedding
        e_ = e[_shift(tok)].to(rdt)
        hin = torch.cat([rms_norm(h_, nh), rms_norm(e_, ne)], dim=-1)
        return _ein("bse,ed->bsd", hin, proj)

    x = local_region(plan.mesh, inp,
                     [(h, plan.layout("dp", None, None)), (tokens, row),
                      (params["embed"], plan.layout(None, None)),
                      (p["norm_h"], plan.layout(None)),
                      (p["norm_e"], plan.layout(None)),
                      (p["proj"], plan.layout(None, None))],
                     plan.layout("dp", None, None))
    x = _res_constrain(x, cfg, plan)
    lp = {k: layer_of(v, 0) for k, v in p.items()
          if k not in ("proj", "norm_h", "norm_e")}
    x = _run_layer(lp, x, cfg, plan, cos, sin, moe=False)
    logits = _logits(params, _final(params, x, plan), cfg, plan)
    # labels for t+2: shift labels left by one
    l2 = local_region(plan.mesh, _shift, [(labels, row)], row)
    m2 = torch.ones(tuple(tokens.shape), dtype=torch.float32,
                    device=local(tokens).device)
    m2[:, -2:] = 0.0
    m2 = plan.distribute(m2, None, None)
    if mask is not None:
        rep = plan.layout(None, None)
        m2 = local_region(plan.mesh, torch.mul, [(m2, rep), (mask, rep)],
                          rep)
    loss, _ = _xent(logits, l2, m2, plan, 0.0)
    return loss


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _cache_layout(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """name -> (shape, dtype) of the decode cache."""
    L = cfg.n_layers
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return {
            "ckv": ((L, batch, max_len, m.kv_lora_rank), CACHE_DTYPE),
            "krope": ((L, batch, max_len, m.qk_rope_head_dim), CACHE_DTYPE),
            "lengths": ((batch,), torch.int32),
        }
    kv = (L, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": (kv, CACHE_DTYPE), "v": (kv, CACHE_DTYPE),
            "lengths": ((batch,), torch.int32)}


def cache_shapes(cfg: LMConfig, batch: int, max_len: int):
    """``meta`` tensors of the decode cache (shape and dtype)."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in _cache_layout(cfg, batch, max_len).items()}


def _cache_roles(cfg: LMConfig) -> dict:
    """Cache sharding: batch over dp, sequence over tp."""
    if cfg.attn_kind == "mla":
        return {"ckv": (None, "dp", "tp", None),
                "krope": (None, "dp", "tp", None), "lengths": ("dp",)}
    return {"k": (None, "dp", "tp", None, None),
            "v": (None, "dp", "tp", None, None), "lengths": ("dp",)}


def _cache_names(cfg: LMConfig) -> tuple:
    return ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")


def cache_specs(cfg: LMConfig, plan: ShardPlan):
    return {k: plan.p(*r) for k, r in _cache_roles(cfg).items()}


def _kv(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin, max_len: int):
    """The cache entries of one prefill layer in the cache dtype, zeros
    past the prompt to ``max_len``: GQA's roped K and V of every KV head,
    MLA's latent and rope key.  Where the residual's sequence lies over tp
    and the prompt fills the cache, each rank computes its own tokens'
    entries, already in the cache's placement (as the reference's K and V
    of the sequence-sharded hidden); else the whole sequence, GQA's KV
    heads over tp where they divide it."""
    cdt = COMPUTE_DTYPE
    s = x.shape[1]
    seq = _res_dims(x, cfg, plan)[1] == "tp" and s == max_len
    if seq:
        _, cos, sin = _seq_shard(s, plan, cos, sin)
    kv = None if seq else _head_roles(cfg, plan)[1]
    if cfg.attn_kind == "mla":
        roles = {"ln1": (None,), "w_dkv": (None, None), "kv_ln": (None,),
                 "w_kr": (None, None)}
        out = plan.layout("dp", "tp" if seq else None, None)
    else:
        roles = {"ln1": (None,), "w_k": (None, kv, None),
                 "w_v": (None, kv, None)}
        if cfg.qk_norm:
            roles["k_norm"] = (None,)
        out = plan.layout("dp", "tp" if seq else None, kv, None)
    names = list(roles)

    def pad(t):
        t = t.to(CACHE_DTYPE)
        if seq or t.shape[1] == max_len:
            return t
        return F.pad(t, [0, 0] * (t.dim() - 2) + [0, max_len - t.shape[1]])

    def fn(x_, *ws):
        w = dict(zip(names, ws))
        pc = base.cast_tree(w, cdt)
        h = rms_norm(x_, w["ln1"]).to(cdt)
        if cfg.attn_kind == "mla":
            a, c = _mla_latent(h, pc["w_dkv"], pc["w_kr"], w["kv_ln"], cos,
                               sin)
        else:
            a, c = _gqa_kv(h, pc["w_k"], pc["w_v"], w.get("k_norm"), cos,
                           sin)
        return pad(a), pad(c)

    x_pl = plan.layout(*_res_dims(x, cfg, plan)) if seq else \
        plan.layout("dp", None, None)
    return local_region(plan.mesh, fn, [(x, x_pl)] + _weights(p, roles, plan),
                        [out, out])


@hot_path
def prefill(params: dict, tokens, cfg: LMConfig,
            plan: ShardPlan = LOCAL_PLAN, max_len: Optional[int] = None):
    """Full-sequence forward building the decode cache.

    Returns (last_logits (B, V), cache).  The cache's sequence axis is
    ``max_len`` long (defaults to S), zeros past S.
    """
    dev = params["embed"].device
    tokens = _batch(tokens, plan, torch.int64, dev)
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    cos, sin = _positions(s, cfg, dev)
    x = _embed(params, tokens, cfg, plan)
    roles = _cache_roles(cfg)
    cache = {k: plan.zeros(shape, dt, dev, *roles[k])
             for k, (shape, dt) in _cache_layout(cfg, b, max_len).items()}
    names = _cache_names(cfg)
    layer = 0
    for stack, moe, n in _stacks(params):
        for i in range(n):
            lp = _layer_params(stack, i)
            for name, part in zip(names, _kv(lp, x, cfg, plan, cos, sin,
                                             max_len)):
                part = move(part, plan.layout(*roles[name][1:]))
                local(cache[name])[layer].copy_(local(part))
            x = _layer(lp, x, cfg, plan, cos, sin, moe=moe)
            layer += 1
    logits = _logits(params, _final(params, x, plan), cfg, plan, last=True)
    local(cache["lengths"]).fill_(s)
    return logits, cache


def _slots(lengths, s: int, offset: int = 0, total=None):
    """Where each row's new entry lands in a cache block of ``s`` slots
    that starts at ``offset`` of a ``total``-slot cache (default: the
    block is the cache): (rows, the clamped slot, whether to write).  A
    row whose length is past the cache, or whose slot lies outside the
    block, keeps its slots, as the reference's one-hot write does.  No
    host sync; computed once a decode step for every layer's writes."""
    total = s if total is None else total
    rows = torch.arange(lengths.shape[0], dtype=torch.int64,
                        device=lengths.device)
    pos = lengths.long()
    keep = lengths < total
    if offset or s < total:
        pos = pos - offset
        keep = keep & (pos >= 0) & (pos < s)
    return rows, torch.clamp(pos, min=0, max=s - 1), keep


def _write_slot(buf, slots, new):
    """``buf[b, slot[b]] = new[b, 0]`` for every row to write, in place
    (``slots``: ``_slots`` of ``buf``'s sequence)."""
    rows, idx, keep = slots
    keep = keep.view((buf.shape[0],) + (1,) * (buf.dim() - 2))
    buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                 buf[rows, idx])


def _write(buf, layer: int, slots, new, plan: ShardPlan):
    """``_write_slot`` of ``new`` (B, 1, ...) into layer ``layer`` of a
    stacked cache (L, B, S, ...), in place: into this rank's block, the
    cache sharded as its specs shard it."""
    new = move(new, plan.layout("dp", *([None] * (buf.dim() - 2))))
    _write_slot(local(buf)[layer], slots, local(new))


def _cache_layer(buf, layer: int, plan: ShardPlan, *dims):
    """One layer of a stacked cache (a view of its shards), moved to
    ``dims``."""
    return move(layer_of(buf, layer), plan.layout(*dims))


def _decode_attention(lp, cache, layer: int, x, lengths, slots, cos, sin,
                      cfg: LMConfig, plan: ShardPlan):
    """The attention of one decode layer: the new slot's entries over the
    batch's (and heads') shards, written into each rank's cache block,
    then the attention over the whole cached sequence with the query heads
    over tp where they divide it (a partial sum there; where the KV heads
    do not divide tp each rank computes the new entries of every KV head,
    the same on every rank, and reads the ones its query heads need:
    ``_kv_select``).  GQA: standard cached attention.  MLA:
    absorbed-latent attention -- the query is projected into the
    kv-latent space (q @ W_uk), so the cache holds only (kv_lora + rope)
    per token and W_uv is applied to the attended latent."""
    cdt, xdt = COMPUTE_DTYPE, x.dtype
    q_tp, kv_tp = _head_tp(cfg, plan, _attn_split(x, cfg, plan))
    flat = plan.layout("dp", None, None)
    heads = plan.layout("dp", None, q_tp, None)
    kv_heads = plan.layout("dp", None, kv_tp, None)
    row = (lengths, plan.layout("dp"))
    ins = [(x, flat), (cos, flat), (sin, flat), row]
    names = _cache_names(cfg)
    if cfg.attn_kind == "mla":
        m = cfg.mla
        roles = {"ln1": (None,), "w_dq": (None, None), "q_ln": (None,),
                 "w_uq": (None, q_tp, None), "w_uk": (None, q_tp, None),
                 "w_dkv": (None, None), "kv_ln": (None,),
                 "w_kr": (None, None)}
        outs = [heads, heads, flat, flat]
    else:
        roles = {"ln1": (None,), "w_q": (None, q_tp, None),
                 "w_k": (None, kv_tp, None), "w_v": (None, kv_tp, None)}
        if cfg.qk_norm:
            roles.update(q_norm=(None,), k_norm=(None,))
        outs = [heads, kv_heads, kv_heads]
    qn = list(roles)

    def new_fn(x_, cos_, sin_, len_, *ws):
        w = dict(zip(qn, ws))
        pc = base.cast_tree(w, cdt)
        h = rms_norm(x_, w["ln1"]).to(cdt)
        if cfg.attn_kind == "mla":
            q_nope, q_rope = _mla_query(h, pc["w_dq"], w["q_ln"],
                                        pc["w_uq"], cfg, cos_, sin_)
            # absorbed: q_lat = q_nope @ W_uk -> score in latent space
            q_lat = torch.einsum("bshk,rhk->bshr", q_nope, pc["w_uk"])
            return (q_lat, q_rope) + _mla_latent(
                h, pc["w_dkv"], pc["w_kr"], w["kv_ln"], cos_, sin_)
        q = _gqa_q(h, pc["w_q"], w.get("q_norm"), cos_, sin_)
        return (q,) + _gqa_kv(h, pc["w_k"], pc["w_v"], w.get("k_norm"),
                              cos_, sin_)

    new = local_region(plan.mesh, new_fn, ins + _weights(lp, roles, plan),
                       outs)
    _write(cache[names[0]], layer, slots, new[-2], plan)
    _write(cache[names[1]], layer, slots, new[-1], plan)
    if cfg.attn_kind == "mla":
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

        def att(q_lat, q_rope, ckv, krope, len_, w_uv, w_o):
            s1 = _ein("bshr,btr->bhst", q_lat, ckv)
            s2 = _ein("bshk,btk->bhst", q_rope, krope)
            sc = (s1 + s2).float() * scale
            valid = torch.arange(ckv.shape[1], dtype=torch.int64,
                                 device=ckv.device)[None, :] <= len_[:, None]
            sc = sc.masked_fill(~valid[:, None, None, :], -1e30)
            pr = torch.softmax(sc, dim=-1).to(cdt)
            ctx_lat = _ein("bhst,btr->bshr", pr, ckv)
            o = _ein("bshr,rhk->bshk", ctx_lat, w_uv.to(cdt))
            return _ein("bshk,hkd->bsd", o, w_o.to(cdt)).to(xdt)

        ins = [(new[0], heads), (new[1], heads),
               (_cache_layer(cache[names[0]], layer, plan, "dp", None, None),
                flat),
               (_cache_layer(cache[names[1]], layer, plan, "dp", None, None),
                flat),
               row, (lp["w_uv"], plan.layout(None, q_tp, None)),
               (lp["w_o"], plan.layout(q_tp, None, None))]
    else:
        kv_sel = _kv_select(cfg, plan)

        def att(q, kc, vc, len_, w_o):
            if kv_sel is not None:
                kc, vc = kc[:, :, kv_sel], vc[:, :, kv_sel]
            o = decode_attention(q, kc, vc, len_ + 1)
            return _ein("bshk,hkd->bsd", o, w_o.to(cdt)).to(xdt)

        kv = ("dp", None, kv_tp, None)
        ins = [(new[0], heads),
               (_cache_layer(cache[names[0]], layer, plan, *kv), kv_heads),
               (_cache_layer(cache[names[1]], layer, plan, *kv), kv_heads),
               row, (lp["w_o"], plan.layout(q_tp, None, None))]
    return local_region(plan.mesh, att, ins,
                        plan.partial(flat, "tp") if q_tp else flat)


@hot_path
def decode_step(params: dict, cache: dict, tokens, cfg: LMConfig,
                plan: ShardPlan = LOCAL_PLAN):
    """One decode step: tokens (B, 1) + cache -> (logits (B, V), cache').

    ``cache``'s tensors take the new slot in place; the returned cache
    shares them, with ``lengths + 1`` (``_decode_attention``)."""
    dev = params["embed"].device
    tokens = _batch(tokens, plan, torch.int64, dev)
    lengths = cache["lengths"]
    rows = plan.layout("dp")
    # (B, 1, rope/2) tables at each row's position, broadcast over heads
    flat = plan.layout("dp", None, None)
    cos, sin = local_region(
        plan.mesh,
        lambda n: rope_tables(n[:, None], _rope_dim(cfg), cfg.rope_theta),
        [(lengths, rows)], [flat, flat])
    x = _embed(params, tokens, cfg, plan)                      # (B, 1, D)
    # every layer's cache block lies as the first's
    blk = cache[_cache_names(cfg)[0]]
    slots = _slots(local(lengths), local(blk).shape[2],
                   local_offset(blk)[2], blk.shape[2])
    layer = 0
    for stack, moe, n in _stacks(params):
        for i in range(n):
            lp = _layer_params(stack, i)
            a = _decode_attention(lp, cache, layer, x, lengths, slots, cos,
                                  sin, cfg, plan)
            x = _residual_add(x, a, cfg, plan)
            x = _residual_add(x, _mlp(lp, x, cfg, plan, moe=moe), cfg, plan)
            layer += 1
    logits = _logits(params, _final(params, x, plan), cfg, plan, last=True)
    nxt = local_region(plan.mesh, lambda n: n + 1, [(lengths, rows)], rows)
    return logits, {**cache, "lengths": nxt}
