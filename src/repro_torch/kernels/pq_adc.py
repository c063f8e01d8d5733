"""Wrapper of the CUDA PQ asymmetric-distance (ADC) scan + top-k kernel.

Replaces ``repro/kernels/pq_adc.py::pq_adc_topk_pallas``; the kernel is
``csrc/pq_adc_topk.cu`` (its header note gives the design and the bound).
This module checks the operands, chooses the split count, allocates the
outputs and the per-split partial lists, launches on PyTorch's current
stream and counts launches; a ``k`` above ``KMAX_PQ`` is served in passes
of ``KMAX_PQ`` (``common.topk_passes``), each one counted launch.  CUDA
tensors only; the plain version is ``ref.pq_adc_topk_ref`` and
``ops.pq_adc_topk_op`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (KMAX_PQ, LaunchCounter, empty_result,
                                        list_len, pad_sentinel, topk_passes,
                                        valid_operand)
from repro_torch.kernels.l2_topk import ptr

__all__ = ["pq_adc_topk", "LAUNCHES"]

LAUNCHES = LaunchCounter("pq_adc_topk")

WARPS = 4              # warps per block (one query) in csrc/pq_adc_topk.cu
CODEWORDS = 256
MAX_M = 24             # the block's staged LUT (M KB) fits one SM's 227 KB
BLOCKS_PER_SM = 4      # the grid's aim: 4 blocks of 4 warps per SM
MIN_ROWS = 32 * WARPS * 8   # a split gives each warp at least 8 passes

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("pq_adc_topk").pq_adc_topk_launch
        f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def splits_for(b: int, n: int, sm_count: int) -> int:
    """Splits of N across blocks: enough (query, split) blocks for about
    ``BLOCKS_PER_SM`` a SM (1 at B = 1,024 on 132 SMs, whose queries alone
    give 7.8 blocks a SM; 9 at B = 64), and no more than one split a
    ``MIN_ROWS`` rows.  Every split is scanned by the block's 4 warps, and
    every split and warp keeps a list of its own, so splitting past what
    fills the card costs more merging than it gains."""
    want = -(-BLOCKS_PER_SM * sm_count // max(b, 1))
    return max(1, min(want, -(-n // MIN_ROWS)))


def pq_adc_topk(lut: torch.Tensor, codes: torch.Tensor, k: int = 10, *,
                valid=None):
    """Returns (adc dists (B, k) ascending fp32, ids (B, k) int32).

    ``lut`` (B, M, 256) float32 holds each query's subspace distances,
    ``codes`` (N, M) the codes (uint8, or an integer type with values in
    0..255), ``valid`` an optional (N,) liveness mask.  ``k`` is clamped to
    N and the requested width restored with the ``(inf, -1)`` sentinel; any
    ``k`` is served (above ``KMAX_PQ`` in passes).  Raises for a CPU tensor,
    a wrong dtype or shape, or a failed launch.
    """
    if lut.device.type != "cuda" or codes.device.type != "cuda":
        raise ValueError("pq_adc_topk takes CUDA tensors; the plain version "
                         "is ref.pq_adc_topk_ref")
    if lut.dtype != torch.float32:
        raise TypeError("pq_adc_topk takes a float32 lut")
    if codes.dtype.is_floating_point or codes.dtype == torch.bool:
        raise TypeError("pq_adc_topk takes integer codes")
    if lut.dim() != 3 or codes.dim() != 2 or lut.shape[2] != CODEWORDS or (
            lut.shape[1] != codes.shape[1]):
        raise ValueError(f"shapes {tuple(lut.shape)} x {tuple(codes.shape)} "
                         f"are not (B, M, {CODEWORDS}) x (N, M)")
    B, M, _ = lut.shape
    N = codes.shape[0]
    if not 1 <= M <= MAX_M:
        raise ValueError(f"M={M} outside the kernel's range 1..{MAX_M}")
    k_eff = min(k, N)
    dev = lut.device
    if B == 0 or k_eff == 0:
        return empty_result(B, k, dev)
    lt = lut.contiguous()
    c = codes.to(torch.uint8).contiguous()
    if c.data_ptr() % 8:             # the kernel reads rows 8 bytes at a time
        c = c.clone()
    v = valid_operand(valid, N, dev)
    splits = splits_for(
        B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    rows = -(-N // splits)
    fn = _launcher()

    def run(kr, after_d, after_i):
        kt = list_len(kr, KMAX_PQ)
        out_d = torch.empty((B, kr), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, kr), dtype=torch.int32, device=dev)
        part_d = part_i = None
        if splits > 1:
            part_d = torch.empty((B, splits, kt), dtype=torch.float32,
                                 device=dev)
            part_i = torch.empty((B, splits, kt), dtype=torch.int32,
                                 device=dev)
        with torch.cuda.device(dev):
            rc = fn(lt.data_ptr(), c.data_ptr(), ptr(v), ptr(after_d),
                    ptr(after_i), ptr(part_d), ptr(part_i), out_d.data_ptr(),
                    out_i.data_ptr(), B, N, M, kr, kt, splits, rows,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pq_adc_topk launch failed: CUDA error {rc}")
        LAUNCHES.inc()
        return out_d, out_i

    out_d, out_i = topk_passes(run, B, k_eff, KMAX_PQ, dev)
    return pad_sentinel(out_d, out_i, k, k_eff)
