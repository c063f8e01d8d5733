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

``plan.constrain`` marks the reference's sharding constraints; with no
mesh bound it is the identity, and the port serves and trains a model on
one card.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.annotations import hot_path
from repro_torch.configs.base import LMConfig
from repro_torch.distributed.sharding import LOCAL_PLAN, ShardPlan
from repro_torch.models import base
from repro_torch.models.attention import _ein, attention, decode_attention
from repro_torch.models.layers import (gelu_mlp, rms_norm, rope, rope_tables,
                                       softmax_xent, swiglu)
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
                             dtype=_param_dtype(cfg), device=device)


def param_specs(cfg: LMConfig, plan: ShardPlan):
    return base.build_specs(partial(_param_fn, plan=plan), cfg)


def param_shapes(cfg: LMConfig, plan: ShardPlan = LOCAL_PLAN):
    """``meta`` tensors of every parameter's shape and dtype."""
    return base.build_shapes(partial(_param_fn, plan=plan), cfg,
                             dtype=_param_dtype(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _res_constrain(x, cfg: LMConfig, plan: ShardPlan):
    if cfg.attn_shard == "seq":
        return plan.constrain(x, "dp", "tp", None)
    return plan.constrain(x, "dp", None, None)


def _head_roles(cfg: LMConfig, plan: ShardPlan):
    tp_n = max(plan.axis_size("tp"), 1)
    q_tp = "tp" if cfg.n_heads % tp_n == 0 else None
    kv_tp = "tp" if cfg.n_kv_heads % tp_n == 0 else None
    return q_tp, kv_tp


def _gather_fsdp(plan: ShardPlan, w, *dims):
    """The reference's FSDP weight gather before use (a constraint that
    replicates the fsdp axes)."""
    return plan.constrain(w, *dims)


def _tokens(tokens, device) -> torch.Tensor:
    """Token ids (numpy or tensor) as int64 on the parameters' device."""
    return torch.as_tensor(tokens, device=device).long()


def _rope_dim(cfg: LMConfig) -> int:
    return cfg.mla.qk_rope_head_dim if cfg.attn_kind == "mla" \
        else cfg.d_head


def _attention_block(p, h, cfg: LMConfig, plan: ShardPlan, cos, sin):
    """h: post-ln1 hidden (B, S, D) -> attn output (B, S, D).  ``p`` is
    the layer's slice cast to the compute dtype."""
    chunk = cfg.attn_chunk or None
    q_tp, kv_tp = _head_roles(cfg, plan)
    if cfg.attn_kind == "mla":
        m = cfg.mla
        w_dq = _gather_fsdp(plan, p["w_dq"], None, None)
        w_dkv = _gather_fsdp(plan, p["w_dkv"], None, None)
        w_kr = _gather_fsdp(plan, p["w_kr"], None, None)
        w_o = _gather_fsdp(plan, p["w_o"], q_tp, None, None)
        cq = rms_norm(h @ w_dq, p["q_ln"])
        q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
        q_nope = q[..., : m.qk_nope_head_dim]
        q_rope = rope(q[..., m.qk_nope_head_dim:], cos, sin)
        ckv = rms_norm(h @ w_dkv, p["kv_ln"])
        k_rope = rope((h @ w_kr)[:, :, None, :], cos, sin)   # (B,S,1,rope)
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
        k = torch.cat(
            [k_nope, k_rope.expand(*k_nope.shape[:3], k_rope.shape[-1])],
            dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        q = plan.constrain(q, "dp", None, q_tp, None)
        k = plan.constrain(k, "dp", None, q_tp, None)
        v = plan.constrain(v, "dp", None, q_tp, None)
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        o = attention(q, k, v, causal=True, chunk=chunk, scale=scale)
        return torch.einsum("bshk,hkd->bsd", o, w_o)
    w_q = _gather_fsdp(plan, p["w_q"], None, q_tp, None)
    w_k = _gather_fsdp(plan, p["w_k"], None, kv_tp, None)
    w_v = _gather_fsdp(plan, p["w_v"], None, kv_tp, None)
    w_o = _gather_fsdp(plan, p["w_o"], q_tp, None, None)
    q = torch.einsum("bsd,dhk->bshk", h, w_q)
    k = torch.einsum("bsd,dhk->bshk", h, w_k)
    v = torch.einsum("bsd,dhk->bshk", h, w_v)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    q = plan.constrain(q, "dp", None, q_tp, None)
    k = plan.constrain(k, "dp", None, kv_tp, None)
    v = plan.constrain(v, "dp", None, kv_tp, None)
    o = attention(q, k, v, causal=True, chunk=chunk)
    return torch.einsum("bshk,hkd->bsd", o, w_o)


def _mlp_block(p, h, cfg: LMConfig, plan: ShardPlan, *, moe: bool):
    if moe:
        return moe_ffn(p, h, cfg, plan)
    if cfg.mlp_kind == "gelu":
        return gelu_mlp(h, _gather_fsdp(plan, p["w_up"], None, "tp"),
                        _gather_fsdp(plan, p["w_down"], "tp", None))
    return swiglu(h, _gather_fsdp(plan, p["w_gate"], None, "tp"),
                  _gather_fsdp(plan, p["w_up"], None, "tp"),
                  _gather_fsdp(plan, p["w_down"], "tp", None))


def _layer(p, x, cfg: LMConfig, plan: ShardPlan, cos, sin, *, moe: bool):
    cdt = COMPUTE_DTYPE
    pc = base.cast_tree(p, cdt)
    h = rms_norm(x, p["ln1"]).to(cdt)
    x = x + _attention_block(pc, h, cfg, plan, cos, sin).to(x.dtype)
    x = _res_constrain(x, cfg, plan)
    h = rms_norm(x, p["ln2"]).to(cdt)
    x = x + _mlp_block(pc, h, cfg, plan, moe=moe).to(x.dtype)
    return _res_constrain(x, cfg, plan)


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


def _layer_slice(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def _embed(params: dict, tokens, cfg: LMConfig, plan: ShardPlan):
    x = params["embed"][tokens].to(_res_dtype(cfg))
    return _res_constrain(x, cfg, plan)


def _backbone(params: dict, tokens, cfg: LMConfig, plan: ShardPlan):
    """tokens (B, S) -> final-norm hidden (B, S, D)."""
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg, plan)
    cos, sin = rope_tables(
        torch.arange(s, dtype=torch.int64, device=tokens.device),
        _rope_dim(cfg), cfg.rope_theta)
    for stack, moe, n in _stacks(params):
        for i in range(n):
            x = _run_layer(_layer_slice(stack, i), x, cfg, plan, cos, sin,
                           moe=moe)
    return rms_norm(x, params["final_norm"])


def _logits(params: dict, h, cfg: LMConfig, plan: ShardPlan):
    if cfg.tie_embeddings:
        w = plan.constrain(params["embed"], "tp", None).T
    else:
        w = _gather_fsdp(plan, params["unembed"], None, "tp")
    logits = h.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)
    return plan.constrain(logits, "dp", None, "tp")


@hot_path
def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            plan: ShardPlan = LOCAL_PLAN):
    """batch: {tokens (B,S), labels (B,S), mask optional} -> (loss, aux)."""
    dev = params["embed"].device
    tokens = _tokens(batch["tokens"], dev)
    labels = _tokens(batch["labels"], dev)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    h = _backbone(params, tokens, cfg, plan)
    logits = _logits(params, h, cfg, plan)
    loss, aux = softmax_xent(logits, labels, z_loss=1e-4, mask=mask)
    if cfg.mtp and "mtp" in params:
        mtp_loss = _mtp_loss(params, h, tokens, labels, cfg, plan, mask)
        aux["mtp_nll"] = mtp_loss
        loss = loss + MTP_WEIGHT * mtp_loss
    aux["loss"] = loss
    return loss, aux


def _mtp_loss(params: dict, h, tokens, labels, cfg: LMConfig,
              plan: ShardPlan, mask):
    """DeepSeek-V3 MTP (depth 1): predict token t+2 from h_t ++ emb_{t+1}."""
    p = params["mtp"]
    s = tokens.shape[1]
    # shift: condition on the next token's embedding
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    e = params["embed"][nxt].to(_res_dtype(cfg))
    hin = torch.cat([rms_norm(h, p["norm_h"]), rms_norm(e, p["norm_e"])],
                    dim=-1)
    x = _ein("bse,ed->bsd", hin, _gather_fsdp(plan, p["proj"], None, None))
    x = _res_constrain(x, cfg, plan)
    cos, sin = rope_tables(
        torch.arange(s, dtype=torch.int64, device=tokens.device),
        _rope_dim(cfg), cfg.rope_theta)
    lp = {k: v[0] for k, v in p.items()
          if k not in ("proj", "norm_h", "norm_e")}
    x = _run_layer(lp, x, cfg, plan, cos, sin, moe=False)
    logits = _logits(params, rms_norm(x, params["final_norm"]), cfg, plan)
    # labels for t+2: shift labels left by one
    l2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
    m2 = torch.ones(l2.shape, dtype=torch.float32, device=l2.device)
    m2[:, -2:] = 0.0
    if mask is not None:
        m2 = m2 * mask
    loss, _ = softmax_xent(logits, l2, mask=m2)
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


def cache_specs(cfg: LMConfig, plan: ShardPlan):
    """Cache sharding: batch over dp, sequence over tp."""
    if cfg.attn_kind == "mla":
        return {
            "ckv": plan.p(None, "dp", "tp", None),
            "krope": plan.p(None, "dp", "tp", None),
            "lengths": plan.p("dp"),
        }
    return {
        "k": plan.p(None, "dp", "tp", None, None),
        "v": plan.p(None, "dp", "tp", None, None),
        "lengths": plan.p("dp"),
    }


@hot_path
def prefill(params: dict, tokens, cfg: LMConfig,
            plan: ShardPlan = LOCAL_PLAN, max_len: Optional[int] = None):
    """Full-sequence forward building the decode cache.

    Returns (last_logits (B, V), cache).  The cache's sequence axis is
    ``max_len`` long (defaults to S), zeros past S.
    """
    dev = params["embed"].device
    tokens = _tokens(tokens, dev)
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    x = _embed(params, tokens, cfg, plan)
    cos, sin = rope_tables(torch.arange(s, dtype=torch.int64, device=dev),
                           _rope_dim(cfg), cfg.rope_theta)
    cache = {k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in _cache_layout(cfg, b, max_len).items()}
    names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    _, kv_tp = _head_roles(cfg, plan)
    layer = 0
    for stack, moe, n in _stacks(params):
        for i in range(n):
            lp = _layer_slice(stack, i)
            cdt = COMPUTE_DTYPE
            h = rms_norm(x, lp["ln1"]).to(cdt)
            lpc = base.cast_tree(lp, cdt)
            if cfg.attn_kind == "mla":
                a = rms_norm(
                    h @ _gather_fsdp(plan, lpc["w_dkv"], None, None),
                    lp["kv_ln"])
                c = rope((h @ _gather_fsdp(plan, lpc["w_kr"], None, None)
                          )[:, :, None], cos, sin)[:, :, 0]
            x_new = _layer(lp, x, cfg, plan, cos, sin, moe=moe)
            if cfg.attn_kind != "mla":
                w_k = _gather_fsdp(plan, lpc["w_k"], None, kv_tp, None)
                w_v = _gather_fsdp(plan, lpc["w_v"], None, kv_tp, None)
                a = torch.einsum("bsd,dhk->bshk", h, w_k)
                c = torch.einsum("bsd,dhk->bshk", h, w_v)
                if cfg.qk_norm:
                    a = rms_norm(a, lp["k_norm"])
                a = rope(a, cos, sin)
            cache[names[0]][layer, :, :s] = a
            cache[names[1]][layer, :, :s] = c
            x = x_new
            layer += 1
    h = rms_norm(x, params["final_norm"])
    logits = _logits(params, h[:, -1:, :], cfg, plan)[:, 0]
    cache["lengths"].fill_(s)
    return logits, cache


def _write_slot(buf, lengths, new):
    """``buf[b, lengths[b]] = new[b, 0]`` for every row, in place; a row
    whose length is past the cache keeps its slots, as the reference's
    one-hot write does.  No host sync."""
    b, s = buf.shape[0], buf.shape[1]
    rows = torch.arange(b, dtype=torch.int64, device=buf.device)
    idx = torch.clamp(lengths.long(), max=s - 1)
    keep = (lengths < s).view((b,) + (1,) * (buf.dim() - 2))
    buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                 buf[rows, idx])


def _decode_layer(lp: dict, cache: dict, layer: int, x, cfg: LMConfig,
                  plan: ShardPlan, cos, sin, lengths, moe: bool):
    cdt = COMPUTE_DTYPE
    h = rms_norm(x, lp["ln1"]).to(cdt)
    lpc = base.cast_tree(lp, cdt)
    q_tp, kv_tp = _head_roles(cfg, plan)
    w_o = _gather_fsdp(plan, lpc["w_o"], q_tp, None, None)
    if cfg.attn_kind == "mla":
        m = cfg.mla
        ckv, krope = cache["ckv"][layer], cache["krope"][layer]
        w_dq = _gather_fsdp(plan, lpc["w_dq"], None, None)
        w_dkv = _gather_fsdp(plan, lpc["w_dkv"], None, None)
        w_kr = _gather_fsdp(plan, lpc["w_kr"], None, None)
        cq = rms_norm(h @ w_dq, lp["q_ln"])
        q = torch.einsum("bsr,rhk->bshk", cq, lpc["w_uq"])
        q_nope = q[..., : m.qk_nope_head_dim]
        q_rope = rope(q[..., m.qk_nope_head_dim:], cos, sin)
        _write_slot(ckv, lengths, rms_norm(h @ w_dkv, lp["kv_ln"]))
        _write_slot(krope, lengths,
                    rope((h @ w_kr)[:, :, None], cos, sin)[:, :, 0])
        # absorbed: q_lat = q_nope @ W_uk -> score in latent space
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, lpc["w_uk"])
        s1 = _ein("bshr,btr->bhst", q_lat, ckv)
        s2 = _ein("bshk,btk->bhst", q_rope, krope)
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        sc = (s1 + s2).float() * scale
        valid = torch.arange(ckv.shape[1], dtype=torch.int64,
                             device=x.device)[None, :] <= lengths[:, None]
        sc = sc.masked_fill(~valid[:, None, None, :], -1e30)
        pr = torch.softmax(sc, dim=-1).to(cdt)
        ctx_lat = _ein("bhst,btr->bshr", pr, ckv)
        o = _ein("bshr,rhk->bshk", ctx_lat, lpc["w_uv"])
    else:
        kc, vc = cache["k"][layer], cache["v"][layer]
        q = torch.einsum("bsd,dhk->bshk", h,
                         _gather_fsdp(plan, lpc["w_q"], None, q_tp, None))
        k1 = torch.einsum("bsd,dhk->bshk", h,
                          _gather_fsdp(plan, lpc["w_k"], None, kv_tp, None))
        v1 = torch.einsum("bsd,dhk->bshk", h,
                          _gather_fsdp(plan, lpc["w_v"], None, kv_tp, None))
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"])
            k1 = rms_norm(k1, lp["k_norm"])
        q = rope(q, cos, sin)
        k1 = rope(k1, cos, sin)
        _write_slot(kc, lengths, k1)
        _write_slot(vc, lengths, v1)
        o = decode_attention(q, kc, vc, lengths + 1)
    attn_out = _ein("bshk,hkd->bsd", o, w_o)
    x = x + attn_out.to(x.dtype)
    h2 = rms_norm(x, lp["ln2"]).to(cdt)
    return x + _mlp_block(lpc, h2, cfg, plan, moe=moe).to(x.dtype)


@hot_path
def decode_step(params: dict, cache: dict, tokens, cfg: LMConfig,
                plan: ShardPlan = LOCAL_PLAN):
    """One decode step: tokens (B, 1) + cache -> (logits (B, V), cache').

    GQA: standard cached attention.  MLA: absorbed-latent attention -- the
    query is projected into the kv-latent space (q @ W_uk), so the cache
    holds only (kv_lora + rope) per token and W_uv is applied to the
    attended latent.  ``cache``'s tensors take the new slot in place;
    the returned cache shares them, with ``lengths + 1``.
    """
    dev = params["embed"].device
    tokens = _tokens(tokens, dev)
    lengths = cache["lengths"]
    x = _embed(params, tokens, cfg, plan)                     # (B, 1, D)
    # (B, 1, rope/2) tables at each row's position, broadcast over heads
    cos, sin = rope_tables(lengths[:, None], _rope_dim(cfg), cfg.rope_theta)
    layer = 0
    for stack, moe, n in _stacks(params):
        for i in range(n):
            x = _decode_layer(_layer_slice(stack, i), cache, layer, x, cfg,
                              plan, cos, sin, lengths, moe)
            layer += 1
    h = rms_norm(x, params["final_norm"])
    logits = _logits(params, h, cfg, plan)[:, 0]
    return logits, {**cache, "lengths": lengths + 1}
