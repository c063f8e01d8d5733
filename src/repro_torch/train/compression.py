"""Gradient compression: int8 quantization with error feedback -- the port
of ``repro/train/compression.py``.

Gradients are quantized to int8 with an absmax scale before the
data-parallel reduction; the quantization residual is carried in an
error-feedback buffer (Seide et al. / EF-SGD) so the bias vanishes over
steps.  ``torch.round`` rounds half to even, as ``jnp.round``.

  * ``make_ef_transform`` -- the gradient transform inside the train step
    (``make_train_step(compress=True)``).
  * ``compressed_psum`` -- the compressed mean over a ``torch.distributed``
    group: every rank all-gathers the int8 payloads and the fp32 scales,
    then dequantizes and takes the mean locally (1 byte an element plus
    one scale a rank on the wire, against 4 bytes for an fp32
    all-reduce).  The reference runs it inside ``shard_map`` over a mesh
    axis; here the axis is the group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.train.tree import map_trees, pick

__all__ = ["quantize_int8", "dequantize_int8", "make_ef_transform",
           "compressed_psum"]


def quantize_int8(x, axis=None):
    """int8 absmax quantization.  ``axis=None``: one scale for the tensor
    (the collective payload layout).  ``axis`` (int or tuple): a scale a
    slice, with ``keepdim`` so dequantization is a broadcast multiply."""
    xf = x.float()
    if axis is None:
        scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    else:
        scale = torch.clamp(torch.amax(torch.abs(xf), dim=axis,
                                       keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def make_ef_transform():
    """Returns (init(grads) -> buf, apply(grads, buf) -> (grads', buf')).

    Matrices quantize with one scale a leading-axis row (a scale an output
    channel), vectors with one scale, as the reference."""

    def init(grads):
        return map_trees(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)

    @torch.no_grad()
    def apply(grads, buf):
        def one(g, e):
            corrected = g.float() + e
            axis = (tuple(range(1, corrected.dim()))
                    if corrected.dim() > 1 else None)
            q, s = quantize_int8(corrected, axis=axis)
            deq = dequantize_int8(q, s)
            return deq.to(g.dtype), corrected - deq

        out = map_trees(one, grads, buf)
        return pick(out, 0), pick(out, 1)

    return init, apply


def compressed_psum(x, group=None):
    """int8 all-gather + local reduce: the mean of ``x`` over the ranks of
    ``group`` (the default group when ``None``), in ``x``'s dtype."""
    q, scale = quantize_int8(x)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale.reshape(1), group=group)
    deq = torch.stack(qs).float() * torch.cat(ss).reshape(
        (n,) + (1,) * x.dim())
    return deq.mean(dim=0).to(x.dtype)
