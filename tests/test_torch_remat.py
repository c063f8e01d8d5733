"""Remat that recomputes only what the backward reads, on the CPU.

The LM's train step runs each layer under ``torch.utils.checkpoint`` and
the chunked attention's block step under a second one, as the reference
wraps its layer and its scan step in ``jax.checkpoint``.  A checkpoint's
recompute stops after the last op that saves a tensor; XLA's remat drops
recomputed values the backward never reads.  So the block step rescales
its accumulator before its P.V product, and its recompute runs the
scores and probabilities only.

1. the chunked attention's matmul FLOPs, counted: a forward's QK and PV,
   the backward's recompute of QK alone, the four gradient products;
2. its gradients bit for bit those of the same step run without the
   block step's checkpoint (the recompute gives the values it saves).

The whole loss's gradients with and without the layer's remat are held
bit for bit in ``tests/test_torch_train_models.py``.  The block loop
with its checkpoint lives in ``kernels/ref.py`` (``chunked_attention_ref``),
where ``models/attention.py`` sends every call that wants a gradient.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ref as kref
from repro_torch.models import attention as attn_mod

B, S, HQ, HKV, DH, CHUNK = 2, 48, 4, 2, 8, 16


def _qkv(seed: int = 0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(                        # noqa: E731
        rng.standard_normal(s).astype(np.float32)).requires_grad_()
    return t(B, S, HQ, DH), t(B, S, HKV, DH), t(B, S, HKV, DH)


def _grads(q, k, v, seed: int = 1):
    o = attn_mod.attention(q, k, v, causal=True, chunk=CHUNK)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        tuple(o.shape)).astype(np.float32))
    return torch.autograd.grad((o * g).sum(), (q, k, v))


def test_block_step_recompute_skips_the_pv_product():
    """Per block, 2 F forward (QK, PV), F recomputed (QK alone), 4 F in
    the gradients (dP, dV, dQ, dK); F = 2 B Hq S CHUNK DH."""
    q, k, v = _qkv()
    with FlopCounterMode(display=False) as fc:
        _grads(q, k, v)
    blocks = -(-S // CHUNK)
    f = 2 * B * HQ * S * CHUNK * DH
    assert fc.get_total_flops() == blocks * (2 + 1 + 4) * f


def test_block_step_checkpoint_changes_no_bit(monkeypatch):
    q, k, v = _qkv()
    with_ckpt = _grads(q, k, v)
    monkeypatch.setattr(kref, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    plain = _grads(q, k, v)
    for a, b in zip(with_ckpt, plain):
        assert torch.equal(a, b)
