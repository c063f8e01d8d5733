"""Wrapper of the CUDA per-query candidate-tile top-k kernel.

Replaces ``repro/kernels/bucket_topk.py::candidate_topk_pallas``; the
kernel is ``csrc/candidate_topk.cu`` (its header note gives the design
and the bound).  Each query row scores its own ``(C, D)`` candidate tile
and merges it into an optionally carried running best — how the IVF
probe chain carries state from one launch to the next.  CUDA tensors
only; the plain version is ``ref.candidate_topk_ref`` and
``ops.candidate_topk_op`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import KMAX, LaunchCounter, list_len

__all__ = ["candidate_topk", "LAUNCHES"]

LAUNCHES = LaunchCounter("candidate_topk")

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("candidate_topk").candidate_topk_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def candidate_topk(queries: torch.Tensor, vecs: torch.Tensor,
                   ids: torch.Tensor, k: int = 10, *, best_d=None,
                   best_i=None):
    """Returns (dists (B, k) ascending fp32, ids (B, k) int32).

    ``vecs`` (B, C, D) float32 and ``ids`` (B, C) int32 are each query's
    candidates, ``id < 0`` marking a dead slot.  With ``best_d``/``best_i``
    (B, k) the result is their merge with the tile, otherwise the list
    starts from the ``(inf, -1)`` sentinel; ``k`` may exceed C.  Raises for
    a CPU tensor, a wrong dtype or shape, ``k`` beyond ``KMAX``, or a
    failed launch.
    """
    tensors = [queries, vecs, ids] + [t for t in (best_d, best_i)
                                      if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("candidate_topk takes CUDA tensors; the plain "
                         "version is ref.candidate_topk_ref")
    if (best_d is None) != (best_i is None):
        raise ValueError("pass both best_d and best_i, or neither")
    if queries.dtype != torch.float32 or vecs.dtype != torch.float32:
        raise TypeError("candidate_topk takes float32 queries and vecs")
    if ids.dtype != torch.int32:
        raise TypeError("candidate_topk takes int32 ids")
    if vecs.dim() != 3:
        raise ValueError(f"vecs has shape {tuple(vecs.shape)}, not (B, C, D)")
    B, C, D = vecs.shape
    if tuple(queries.shape) != (B, D) or tuple(ids.shape) != (B, C):
        raise ValueError(f"queries {tuple(queries.shape)} / ids "
                         f"{tuple(ids.shape)} do not match vecs {(B, C, D)}")
    if k > KMAX:
        raise ValueError(f"k={k} exceeds the kernel's KMAX={KMAX}")
    if best_d is not None:
        if best_d.dtype != torch.float32 or best_i.dtype != torch.int32:
            raise TypeError("best_d/best_i must be float32/int32")
        if tuple(best_d.shape) != (B, k) or tuple(best_i.shape) != (B, k):
            raise ValueError(f"best lists must be {(B, k)}")
        best_d, best_i = best_d.contiguous(), best_i.contiguous()
    dev = queries.device
    q, v, i = queries.contiguous(), vecs.contiguous(), ids.contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i
    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), v.data_ptr(), i.data_ptr(),
                None if best_d is None else best_d.data_ptr(),
                None if best_i is None else best_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), B, C, D, k, list_len(k),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"candidate_topk launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return out_d, out_i
