"""Attention: dense, chunked (online softmax), and single-token decode.

Port of ``repro/models/attention.py`` (the reference reaches no Pallas
kernel here: its LM path is plain ``jnp``).  GQA throughout: q is
grouped as ``(B, S, n_kv, H / n_kv, dh)``, so query head ``h`` reads KV
head ``h // (H / n_kv)`` (MQA = 1 kv head).  The chunked path is the
reference's scan over KV blocks carrying the running (max, denominator,
accumulator) in fp32, so the (Sq, Sk) score tile never materialises for
long contexts.  Scores are cast to fp32 after the product in the compute
dtype, and probabilities back to ``q``'s dtype before the PV product.

Masked scores are ``-1e30``, not ``-inf``: a fully masked row gives a
uniform softmax, as in the reference, never NaN.  The chunked path pads
the last block as the reference does, so such a row counts the padded
slots too.

Where the work runs.  The dense path (``chunk`` None or at least Sk, no
scan in the reference either) is plain torch.  The chunked path with no
gradient wanted (serving: ``prefill``, the forward of a no-grad call)
goes to ``kernels.ops.chunked_attention_op``: on the card the
hand-written ``attention_chunked`` kernel, on the CPU the plain block
loop ``kernels.ref.chunked_attention_ref``.  When a gradient is wanted
(training) the plain block loop runs on every device, its block step
under ``torch.utils.checkpoint`` as the reference wraps its scan step in
``jax.checkpoint``.  The choice depends on autograd only, never on a
build or a launch failing: a kernel that cannot launch raises.  The
decode attention goes to ``kernels.ops.decode_attention_op``: on the card
``attention_decode``, which reads the cache in place, on the CPU the
plain version ``kernels.ref.decode_attention_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.annotations import hot_path
from repro_torch.kernels.ops import chunked_attention_op, decode_attention_op
from repro_torch.kernels.ref import _ein, _group, chunked_attention_ref

__all__ = ["attention", "decode_attention"]

_NEG = -1e30


@hot_path
def attention(
    q,                                   # (B, Sq, Hq, dh)
    k,                                   # (B, Sk, Hkv, dh)
    v,                                   # (B, Sk, Hkv, dv)
    *,
    causal: bool = True,
    chunk: Optional[int] = None,         # KV block size; None = dense
    q_pos=None,                          # (Sq,) global positions
    kv_mask=None,                        # (B, Sk) 1 = valid
    scale: Optional[float] = None,
):
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    if chunk is None or chunk >= sk:
        dev = q.device
        qg = _group(q, hkv)                               # (B,Sq,G,R,dh)
        qp = torch.arange(sq, dtype=torch.int64, device=dev) \
            if q_pos is None else q_pos.to(dev)
        kp = torch.arange(sk, dtype=torch.int64, device=dev)
        s = _ein("bqgrd,bkgd->bgrqk", qg, k).float() * scale
        if causal:
            s = s.masked_fill(~(qp[:, None] >= kp[None, :]), _NEG)
        if kv_mask is not None:
            s = s.masked_fill(~(kv_mask[:, None, None, None, :] > 0), _NEG)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = _ein("bgrqk,bkgd->bqgrd", p, v)
        return o.reshape(b, sq, hq, -1)

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if grad:
        return chunked_attention_ref(q, k, v, causal=causal, chunk=chunk,
                                     q_pos=q_pos, kv_mask=kv_mask,
                                     scale=scale)
    return chunked_attention_op(q, k, v, causal=causal, chunk=chunk,
                                scale=scale, q_pos=q_pos, kv_mask=kv_mask)


@hot_path
def decode_attention(
    q,                                   # (B, 1, Hq, dh)
    k_cache,                             # (B, S, Hkv, dh)
    v_cache,                             # (B, S, Hkv, dv)
    lengths,                             # (B,) valid cache length each
    *,
    scale: Optional[float] = None,
):
    """One-token attention over a KV cache."""
    scale = scale if scale is not None else k_cache.shape[-1] ** -0.5
    return decode_attention_op(q, k_cache, v_cache, lengths, scale=scale)
