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
           "softmax_xent", "xent_terms", "xent_reduce", "shifted_softplus"]


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


def xent_terms(logits, labels, *, z_loss: float = 0.0):
    """Per-token (nll with z-loss, argmax == label) of ``softmax_xent``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return nll, lf.argmax(dim=-1) == labels


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
