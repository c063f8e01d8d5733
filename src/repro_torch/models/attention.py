"""Attention: dense, chunked (online softmax), and single-token decode.

Port of ``repro/models/attention.py``, in plain PyTorch (the reference
reaches no Pallas kernel here).  GQA throughout: q is grouped as
``(B, S, n_kv, H / n_kv, dh)``, so query head ``h`` reads KV head
``h // (H / n_kv)`` (MQA = 1 kv head).  The chunked path is a loop over
KV blocks carrying the running (max, denominator, accumulator) in fp32,
so the (Sq, Sk) score tile never materialises for long contexts; like
the reference it computes every block.  Scores are cast to fp32 after
the product in the compute dtype, and probabilities back to ``q``'s
dtype before the PV product.

Masked scores are ``-1e30``, not ``-inf``: a fully masked row gives a
uniform softmax, as in the reference, never NaN.  The chunked path pads
the last block as the reference does, so such a row counts the padded
slots too.

The chunked path's block step (``_block_step``) runs in one of two
modes, with the same numbers.  Serving (no gradient wanted) updates each
block's score tile in place, so a 32K prefill holds one tile.  When a
gradient is wanted the step is out of place and runs under
``torch.utils.checkpoint``, as the reference wraps its scan step in
``jax.checkpoint``: the backward recomputes each block's probabilities
from the carried (max, denominator, accumulator) instead of saving every
block's tile, which would rebuild the whole (Sq, Sk) matrix in fp32.
The recompute stops after the step's last op that saves a tensor (the
checkpoint's early stop), so the step rescales its accumulator before the
P.V product: the recompute then runs the scores and probabilities only,
as XLA's remat of the reference's step does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.annotations import hot_path

__all__ = ["attention", "decode_attention"]

_NEG = -1e30


def _ein(eq: str, a, b):
    """``einsum`` with numpy's type promotion (``jnp.einsum`` of a bf16
    and an fp32 operand computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _group(q, n_kv: int):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


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
    dev = q.device
    scale = scale if scale is not None else dh ** -0.5
    qg = _group(q, hkv)                                   # (B,Sq,G,R,dh)
    qp = torch.arange(sq, dtype=torch.int64, device=dev) if q_pos is None \
        else q_pos.to(dev)
    kp = torch.arange(sk, dtype=torch.int64, device=dev)

    if chunk is None or chunk >= sk:
        s = _ein("bqgrd,bkgd->bgrqk", qg, k).float() * scale
        if causal:
            s = s.masked_fill(~(qp[:, None] >= kp[None, :]), _NEG)
        if kv_mask is not None:
            s = s.masked_fill(~(kv_mask[:, None, None, None, :] > 0), _NEG)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = _ein("bgrqk,bkgd->bqgrd", p, v)
        return o.reshape(b, sq, hq, -1)

    n_blk = -(-sk // chunk)
    pad = n_blk * chunk - sk
    kpad = F.pad(k, (0, 0, 0, 0, 0, pad))
    vpad = F.pad(v, (0, 0, 0, 0, 0, pad))
    kvm = torch.ones((b, sk), dtype=torch.bool, device=dev) \
        if kv_mask is None else kv_mask.to(dev) > 0
    kvm = F.pad(kvm, (0, pad))
    dv = v.shape[-1]
    g, r = hkv, hq // hkv
    cdt = torch.promote_types(q.dtype, k.dtype)
    pdt = torch.promote_types(q.dtype, v.dtype)
    # (B, G, R*Sq, dh): one product a block per (batch, kv head)
    qh = qg.permute(0, 2, 3, 1, 4).reshape(b, g, r * sq, dh).to(cdt)
    m = torch.full((b, g, r, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, g, r, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, g, r, sq, dv), dtype=torch.float32, device=dev)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for blk in range(n_blk):
        lo = blk * chunk
        kc = kpad[:, lo:lo + chunk].permute(0, 2, 3, 1).to(cdt)  # B,G,dh,C
        vc = vpad[:, lo:lo + chunk].permute(0, 2, 1, 3).to(pdt)  # B,G,C,dv
        mask = ~kvm[:, lo:lo + chunk][:, None, None, None, :]
        if causal:
            kpos = lo + torch.arange(chunk, dtype=torch.int64, device=dev)
            mask = mask | ~(qp[:, None] >= kpos[None, :])
        if grad:
            m, l, acc = checkpoint(_block_step, qh, kc, vc, mask, m, l, acc,
                                   scale, q.dtype, False, use_reentrant=False)
        else:
            m, l, acc = _block_step(qh, kc, vc, mask, m, l, acc, scale,
                                    q.dtype, True)
    o = acc / torch.clamp(l[..., None], min=1e-30)
    o = o.permute(0, 3, 1, 2, 4)                           # (B,Sq,G,R,dv)
    return o.reshape(b, sq, hq, dv).to(q.dtype)


def _block_step(qh, kc, vc, mask, m, l, acc, scale: float, qdt,
                inplace: bool):
    """One KV block of the online softmax: scores (B, G, R, Sq, C) in
    fp32, ``mask`` True where a slot is masked; returns the carried (max,
    denominator, accumulator).  ``inplace`` (no autograd: serving) updates
    the score tile in place; the same numbers either way."""
    b, g, r, sq = m.shape
    chunk = kc.shape[-1]
    s = torch.matmul(qh, kc).view(b, g, r, sq, chunk).float()
    if inplace:
        s = s.mul_(scale).masked_fill_(mask, _NEG)
    else:
        s = (s * scale).masked_fill(mask, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    if inplace:
        p = s.sub_(m_new[..., None]).exp_()
    else:
        p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    # the rescale before the product: it is the step's last op that saves
    # a tensor, so the checkpoint's recompute stops ahead of P.V, whose
    # result the backward never reads (as XLA drops it from its remat)
    acc = acc * corr[..., None]
    pv = torch.matmul(p.to(qdt).to(vc.dtype).view(b, g, r * sq, chunk),
                      vc).view(b, g, r, sq, -1)
    return m_new, l, acc + pv.float()


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
    b, s, hkv, dh = k_cache.shape
    hq = q.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = _group(q, hkv)                                   # (B,1,G,R,dh)
    sc = _ein("bqgrd,bkgd->bgrqk", qg, k_cache).float() * scale
    valid = torch.arange(s, dtype=torch.int64,
                         device=q.device)[None, :] < lengths[:, None]
    sc = sc.masked_fill(~valid[:, None, None, None, :], _NEG)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    o = _ein("bgrqk,bkgd->bqgrd", p, v_cache)
    return o.reshape(b, 1, hq, -1)
