"""Wrapper of the CUDA packed-bit Hamming scan + exact top-k kernel.

Replaces ``repro/kernels/hamming.py::hamming_topk_pallas``; the kernel is
``csrc/hamming_topk.cu`` (its header note gives the design and the
bound): a histogram select in three passes, exact for any ``k`` up to N,
over a grid of (row splits) x (groups of ``G`` queries) that reads each
staged code once a group.  This module checks the operands, chooses the
splits (``plan``), allocates the outputs and the (query, split, distance)
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

__all__ = ["hamming_topk", "plan", "LAUNCHES"]

LAUNCHES = LaunchCounter("hamming_topk")

G = 32                 # queries a group in csrc/hamming_topk.cu
RUN = 32               # rows a run of the emit pass; splits are whole runs
MIN_ROWS = 2048        # rows a split at least, where N allows
BLOCKS_PER_SM = 4
MAX_W = 8              # words per code: 256 bits, 257 distance bins
MAX_B = 65535 * G      # query groups ride the grid's y dimension

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("hamming_topk").hamming_topk_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def plan(b: int, n: int, sm_count: int) -> tuple[int, int, int]:
    """(query groups, splits of N, rows a split): about ``BLOCKS_PER_SM``
    blocks an SM over all groups, each split at least ``MIN_ROWS`` rows
    (where N has them) and a whole number of runs, and no split empty."""
    groups = -(-b // G)
    s = max(1, min(-(-n // MIN_ROWS), (BLOCKS_PER_SM * sm_count) // groups))
    rows = -(-n // s)
    rows = -(-rows // RUN) * RUN
    return groups, -(-n // rows), rows


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
    # the kernel stages codes and liveness by 16-byte copies
    q, c = qcodes.contiguous(), _aligned(codes.contiguous())
    v = valid_operand(valid, N, dev)
    v = None if v is None else _aligned(v)
    _, splits, rows = plan(
        B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    hist = torch.empty((B, splits, 32 * W + 1), dtype=torch.int32,
                       device=dev)
    thr = torch.empty((B,), dtype=torch.int32, device=dev)
    out_d = torch.empty((B, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k_eff), dtype=torch.int32, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), c.data_ptr(),
                None if v is None else v.data_ptr(), hist.data_ptr(),
                thr.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B, N, W,
                k_eff, splits, rows,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hamming_topk launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return pad_sentinel(out_d, out_i, k, k_eff)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where its data does not start 16-byte
    aligned (a view at an offset)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
