"""Shared NN layers: RMSNorm, RoPE, activations, losses.

Port of ``repro/models/layers.py``.  ``jax.nn.gelu`` defaults to the tanh
approximation, so ``gelu_mlp`` asks torch for it (torch's default is the
exact erf form).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "rope_tables", "swiglu", "gelu_mlp",
           "softmax_xent", "xent_shard_max", "xent_shard_terms",
           "xent_token", "xent_terms", "xent_reduce", "shifted_softplus"]


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32, cast back to the input dtype (LLaMA convention)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def rope_tables(positions, dim: int, theta: float = 1e6):
    """(..., dim/2) cos/sin tables for rotate-half RoPE."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv              # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin):
    """Rotate-half RoPE.

    x: (..., S, H, dim); cos/sin: (S, dim/2) or (B, S, dim/2) -- a head
    axis is inserted second-to-last so the tables broadcast over heads.
    The products run in fp32 (the tables' dtype) and the result is cast
    back to ``x``'s dtype, as in the reference.
    """
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos.unsqueeze(-2)
    sin = sin.unsqueeze(-2)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """LLaMA-style gated MLP: down( silu(x@gate) * (x@up) )."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def gelu_mlp(x, w_up, w_down):
    """2-matrix GELU MLP (granite-34b code-model style), tanh GELU."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def shifted_softplus(x):
    """SchNet's ssp(x) = ln(0.5 e^x + 0.5)."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def xent_shard_max(logits):
    """The largest logit of each token over a vocabulary shard, in fp32: a
    constant for the gradient."""
    return logits.detach().float().amax(dim=-1)


def xent_shard_terms(logits, labels, m, v0: int, vocab: int):
    """``softmax_xent``'s per-token terms over one vocabulary shard (the
    columns ``v0`` .. of a ``vocab``-wide row), given ``m``, the largest
    logit over the whole vocabulary: the sum of ``exp(logit - m)``, the
    label's logit where the label falls in the shard (else 0), and the
    smallest index in the shard that attains ``m`` (else ``vocab``).
    Summed (the first two) and min-reduced (the third) over the shards,
    they are the whole row's; one shard of the whole row is that row."""
    lf = logits.float()
    n = lf.shape[-1]
    se = torch.exp(lf - m[..., None]).sum(dim=-1)
    at = labels.long() - v0
    mine = (at >= 0) & (at < n)
    ll = torch.gather(lf, -1, at.clamp(0, n - 1)[..., None])[..., 0]
    ll = torch.where(mine, ll, torch.zeros((), device=lf.device))
    lo = lf.detach()
    top = torch.where(lo.amax(dim=-1) == m, lo.argmax(dim=-1) + v0, vocab)
    return se, ll, top


def xent_token(m, se, ll, top, labels, z_loss: float = 0.0):
    """Per-token (nll with z-loss, argmax == label as 0 / 1) from the
    whole row's terms of ``xent_shard_terms``; the log-sum-exp is
    ``log(se) + m``."""
    lse = torch.log(se) + m
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return nll, (top == labels).float()


def xent_terms(logits, labels, *, z_loss: float = 0.0):
    """Per-token (nll with z-loss, argmax == label) of ``softmax_xent``:
    the whole row as one shard.  The argmax is the smallest index that
    attains the max (``jnp.argmax``'s ties)."""
    m = xent_shard_max(logits)
    se, ll, top = xent_shard_terms(logits, labels, m, 0, logits.shape[-1])
    return xent_token(m, se, ll, top, labels, z_loss)


def xent_reduce(nll, hit, mask=None):
    """``softmax_xent``'s masked token means of ``xent_terms``."""
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = (hit * mask).sum() / denom
    return loss, {"nll": loss, "accuracy": acc}


def softmax_xent(logits, labels, *, z_loss: float = 0.0, mask=None):
    """Token-mean cross entropy in fp32 with optional z-loss.

    logits (..., V) any float dtype; labels integer (...); mask
    broadcastable to labels (1 = count).  Returns (loss_scalar, aux dict).
    """
    nll, hit = xent_terms(logits, labels, z_loss=z_loss)
    return xent_reduce(nll, hit, mask)
