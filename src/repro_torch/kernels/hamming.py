"""Wrapper of the CUDA packed-bit Hamming scan + exact top-k kernel.

Replaces ``repro/kernels/hamming.py::hamming_topk_pallas``; the kernel is
``csrc/hamming_topk.cu`` (its header note gives the design and the
bound): a histogram select in three passes, exact for any ``k`` up to N.
This module checks the operands, chooses how many warps share each
query's rows, allocates the outputs and the (query, warp, distance)
count table, launches on PyTorch's current stream and counts launches.
CUDA tensors only; the plain version is ``ref.hamming_topk_ref`` and
``ops.hamming_topk_op`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (LaunchCounter, empty_result,
                                        pad_sentinel, valid_operand)

__all__ = ["hamming_topk", "LAUNCHES"]

LAUNCHES = LaunchCounter("hamming_topk")

WARPS = 8              # warps per block in csrc/hamming_topk.cu
MAX_W = 8              # words per code: 256 bits, 257 distance bins
MAX_B = 65535          # queries ride the grid's y dimension

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("hamming_topk").hamming_topk_launch
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def blocks_for(b: int, n: int, sm_count: int) -> tuple[int, int]:
    """(blocks per query, rows per warp): about four blocks per SM over
    all queries, each warp at least 128 rows, rows a multiple of 32."""
    blocks = max(1, min(-(-n // (WARPS * 128)), (4 * sm_count) // max(b, 1)))
    rows = -(-n // (blocks * WARPS))
    return blocks, -(-rows // 32) * 32


def hamming_topk(qcodes: torch.Tensor, codes: torch.Tensor, k: int = 10, *,
                 valid=None):
    """Returns (hamming dists (B, k) ascending fp32, ids (B, k) int32).

    ``qcodes`` (B, W) and ``codes`` (N, W) are int32 words of packed bits
    (W <= 8), ``valid`` an optional (N,) liveness mask.  Any ``k``: it is
    clamped to N and the requested width restored with the ``(inf, -1)``
    sentinel.  Ties break on the id, so the answer equals a stable sort of
    the flat scan.  Raises for a CPU tensor, a wrong dtype or shape, or a
    failed launch.
    """
    if qcodes.device.type != "cuda" or codes.device.type != "cuda":
        raise ValueError("hamming_topk takes CUDA tensors; the plain version "
                         "is ref.hamming_topk_ref")
    if qcodes.dtype != torch.int32 or codes.dtype != torch.int32:
        raise TypeError("hamming_topk takes int32 packed codes")
    if qcodes.dim() != 2 or codes.dim() != 2 or (
            qcodes.shape[1] != codes.shape[1]):
        raise ValueError(f"shapes {tuple(qcodes.shape)} x "
                         f"{tuple(codes.shape)} are not (B, W) x (N, W)")
    B, W = qcodes.shape
    N = codes.shape[0]
    if not 1 <= W <= MAX_W:
        raise ValueError(f"W={W} outside the kernel's range 1..{MAX_W}")
    if B > MAX_B:
        raise ValueError(f"B={B} exceeds the kernel's {MAX_B} queries")
    k_eff = min(k, N)
    dev = qcodes.device
    if B == 0 or k_eff == 0:
        return empty_result(B, k, dev)
    q, c = qcodes.contiguous(), codes.contiguous()
    v = valid_operand(valid, N, dev)
    blocks, rows = blocks_for(
        B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    hist = torch.empty((B, blocks * WARPS, 32 * W + 1), dtype=torch.int32,
                       device=dev)
    out_d = torch.empty((B, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k_eff), dtype=torch.int32, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), c.data_ptr(),
                None if v is None else v.data_ptr(), hist.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), B, N, W, k_eff, blocks,
                rows, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hamming_topk launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return pad_sentinel(out_d, out_i, k, k_eff)
