"""Wrapper of the CUDA fused L2 + streaming top-k kernel.

Replaces ``repro/kernels/l2_topk.py::l2_topk_pallas``; the kernel is
``csrc/l2_topk.cu`` (its header note gives the design and the bound).
This module checks the operands, allocates the outputs and the per-split
partial lists, chooses the split count, launches on PyTorch's current
stream and counts launches.  It takes CUDA tensors only; the plain
version is ``ref.l2_topk_ref`` and ``ops.l2_topk_op`` picks between them
by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (KMAX, LaunchCounter, list_len,
                                        pad_sentinel, valid_operand)

__all__ = ["l2_topk", "LAUNCHES", "splits_for"]

LAUNCHES = LaunchCounter("l2_topk")

BN = 128        # rows per tile in csrc/l2_topk.cu
BQ = 64         # queries per block tile in csrc/l2_topk.cu
MAX_D = 512     # the staged query tile must fit in shared memory

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.library("l2_topk")
        f = lib.l2_topk_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.l2_topk_selectors.restype = ctypes.c_int
        _fn = (f, int(lib.l2_topk_selectors()))
    return _fn


def splits_for(b: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits of N, rows per split): about two blocks per SM over all
    query tiles, each split a whole number of BN-row tiles."""
    tiles = -(-n // BN)
    q_tiles = -(-b // BQ)
    s = max(1, min(tiles, (2 * sm_count) // q_tiles))
    rows = -(-tiles // s) * BN
    return -(-n // rows), rows


def l2_topk(queries: torch.Tensor, db: torch.Tensor, k: int = 10, *,
            valid=None):
    """Returns (dists (B, k) ascending fp32, ids (B, k) int32).

    ``valid`` is an optional (N,) liveness mask; dead rows never rank.
    ``k`` is clamped to N and the requested width restored with the
    ``(inf, -1)`` sentinel.  Raises for a CPU tensor, a wrong dtype or
    shape, ``k`` beyond ``KMAX`` after the clamp, or a failed launch.
    """
    if queries.device.type != "cuda" or db.device.type != "cuda":
        raise ValueError("l2_topk takes CUDA tensors; the plain version is "
                         "ref.l2_topk_ref")
    if queries.dtype != torch.float32 or db.dtype != torch.float32:
        raise TypeError("l2_topk takes float32 queries and db")
    if queries.dim() != 2 or db.dim() != 2 or queries.shape[1] != db.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(db.shape)}"
                         " are not (B, D) x (N, D)")
    B, D = queries.shape
    N = db.shape[0]
    if D > MAX_D:
        raise ValueError(f"d={D} exceeds the kernel's {MAX_D}")
    k_eff = min(k, N)
    if k_eff > KMAX:
        raise ValueError(f"k={k_eff} exceeds the kernel's KMAX={KMAX}")
    dev = queries.device
    q = queries.contiguous()
    x = db.contiguous()
    v = valid_operand(valid, N, dev)
    out_d = torch.empty((B, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k_eff), dtype=torch.int32, device=dev)
    if B == 0 or k_eff == 0:
        return pad_sentinel(out_d, out_i, k, k_eff)
    fn, selectors = _launcher()
    kt = list_len(k_eff)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = splits_for(B, N, sm)
    part_d = torch.empty((B, splits * selectors, kt), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((B, splits * selectors, kt), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), x.data_ptr(),
                None if v is None else v.data_ptr(),
                part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), B, N, D, k_eff, kt, splits, rows,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"l2_topk launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return pad_sentinel(out_d, out_i, k, k_eff)
