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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
    for blk in range(n_blk):
        lo = blk * chunk
        kc = kpad[:, lo:lo + chunk].permute(0, 2, 3, 1).to(cdt)  # B,G,dh,C
        vc = vpad[:, lo:lo + chunk].permute(0, 2, 1, 3).to(pdt)  # B,G,C,dv
        mc = kvm[:, lo:lo + chunk]
        kpos = lo + torch.arange(chunk, dtype=torch.int64, device=dev)
        s = torch.matmul(qh, kc).view(b, g, r, sq, chunk)
        s = s.float().mul_(scale)
        if causal:
            s.masked_fill_(~(qp[:, None] >= kpos[None, :]), _NEG)
        s.masked_fill_(~mc[:, None, None, None, :], _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(q.dtype).to(pdt).view(b, g, r * sq, chunk),
                          vc).view(b, g, r, sq, dv)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-30)
    o = o.permute(0, 3, 1, 2, 4)                           # (B,Sq,G,R,dv)
    return o.reshape(b, sq, hq, dv).to(q.dtype)


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
