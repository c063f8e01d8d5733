"""Wrappers of the CUDA fused L2 + streaming top-k kernels (fp32, int8).

Replace ``repro/kernels/l2_topk.py::l2_topk_pallas`` and
``l2_topk_int8_pallas``; the kernels are the ``F32Rows`` and ``Int8Rows``
instantiations of ``csrc/l2_topk.cu`` (its header note gives the design
and the bounds).  This module checks the operands, allocates the outputs
and the per-split partial lists, chooses the split count, launches on
PyTorch's current stream and counts launches.  It takes CUDA tensors
only; the plain versions are ``ref.l2_topk_ref`` / ``ref.l2_topk_int8_ref``
and ``ops`` picks between kernel and plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (KMAX, LaunchCounter, empty_result,
                                        list_len, pad_sentinel, valid_operand)

__all__ = ["l2_topk", "l2_topk_int8", "LAUNCHES", "INT8_LAUNCHES",
           "library", "splits_for", "scan_outputs", "check_scan",
           "stream_handle"]

LAUNCHES = LaunchCounter("l2_topk")
INT8_LAUNCHES = LaunchCounter("l2_topk_int8")

BN = 128        # rows per tile in csrc/l2_topk.cu; bm25_topk.cu splits by it
BQ = 64         # queries per block tile in both
MAX_D = 512     # the staged query tile must fit in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def library():
    """The ``l2_topk`` library with its three launchers' signatures set
    (the hybrid one is wrapped by ``kernels.bm25``)."""
    global _lib
    if _lib is None:
        lib = _build.library("l2_topk")
        for fn, argtypes in (
                (lib.l2_topk_launch, [_P] * 7 + [_I] * 7 + [_P]),
                (lib.l2_topk_int8_launch, [_P] * 8 + [_I] * 7 + [_P]),
                (lib.hybrid_topk_launch, [_P] * 12 + [_I] * 9 + [_P])):
            fn.argtypes = argtypes
            fn.restype = _I
        lib.l2_topk_selectors.restype = _I
        _lib = lib
    return _lib


def splits_for(b: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits of N, rows per split): about two blocks per SM over all
    query tiles, each split a whole number of BN-row tiles."""
    tiles = -(-n // BN)
    q_tiles = -(-b // BQ)
    s = max(1, min(tiles, (2 * sm_count) // q_tiles))
    rows = -(-tiles // s) * BN
    return -(-n // rows), rows


def scan_outputs(b: int, n: int, k_eff: int, selectors: int, dev):
    """Outputs and partial lists of a split scan over ``n`` rows:
    ``(out_d, out_i, part_d, part_i, kt, splits, rows per split)``."""
    kt = list_len(k_eff)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = splits_for(b, n, sm)
    out_d = torch.empty((b, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_eff), dtype=torch.int32, device=dev)
    part_d = torch.empty((b, splits * selectors, kt), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((b, splits * selectors, kt), dtype=torch.int32,
                         device=dev)
    return out_d, out_i, part_d, part_i, kt, splits, rows


def check_scan(name: str, queries, n: int, k: int) -> int:
    """Checks shared by the dense scans; returns ``k`` clamped to N."""
    if queries.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 queries")
    if queries.dim() != 2:
        raise ValueError(f"queries have shape {tuple(queries.shape)}, "
                         "not (B, D)")
    if queries.shape[1] > MAX_D:
        raise ValueError(f"d={queries.shape[1]} exceeds the kernel's {MAX_D}")
    k_eff = min(k, n)
    if k_eff > KMAX:
        raise ValueError(f"k={k_eff} exceeds the kernel's KMAX={KMAX}")
    return k_eff


def stream_handle(dev) -> int:
    """PyTorch's current stream on ``dev``, as the launchers take it."""
    return torch.cuda.current_stream(dev).cuda_stream


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
    if db.dtype != torch.float32:
        raise TypeError("l2_topk takes a float32 db")
    if db.dim() != 2 or queries.dim() != 2 or (
            queries.shape[1] != db.shape[1]):
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(db.shape)}"
                         " are not (B, D) x (N, D)")
    B, D = queries.shape
    N = db.shape[0]
    k_eff = check_scan("l2_topk", queries, N, k)
    dev = queries.device
    if B == 0 or k_eff == 0:
        return empty_result(B, k, dev)
    q, x = queries.contiguous(), db.contiguous()
    v = valid_operand(valid, N, dev)
    lib = library()
    out_d, out_i, part_d, part_i, kt, splits, rows = scan_outputs(
        B, N, k_eff, lib.l2_topk_selectors(), dev)
    with torch.cuda.device(dev):
        rc = lib.l2_topk_launch(
            q.data_ptr(), x.data_ptr(), None if v is None else v.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), B, N, D, k_eff, kt, splits, rows,
            stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"l2_topk launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return pad_sentinel(out_d, out_i, k, k_eff)


def l2_topk_int8(queries: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, k: int = 10, *, valid=None):
    """The int8-footprint scan: ``codes`` (N, D) int8 and ``scales`` (N,)
    float32 with ``row ~= scale * codes``; queries stay float32.  Same
    contract and errors as :func:`l2_topk`."""
    if any(t.device.type != "cuda" for t in (queries, codes, scales)):
        raise ValueError("l2_topk_int8 takes CUDA tensors; the plain version "
                         "is ref.l2_topk_int8_ref")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("l2_topk_int8 takes int8 codes and float32 scales")
    if codes.dim() != 2 or queries.dim() != 2 or (
            queries.shape[1] != codes.shape[1]) or (
            tuple(scales.shape) != (codes.shape[0],)):
        raise ValueError(f"shapes {tuple(queries.shape)} x "
                         f"{tuple(codes.shape)} x {tuple(scales.shape)} are "
                         "not (B, D) x (N, D) x (N,)")
    B, D = queries.shape
    N = codes.shape[0]
    k_eff = check_scan("l2_topk_int8", queries, N, k)
    dev = queries.device
    if B == 0 or k_eff == 0:
        return empty_result(B, k, dev)
    q, c, s = queries.contiguous(), codes.contiguous(), scales.contiguous()
    v = valid_operand(valid, N, dev)
    lib = library()
    out_d, out_i, part_d, part_i, kt, splits, rows = scan_outputs(
        B, N, k_eff, lib.l2_topk_selectors(), dev)
    with torch.cuda.device(dev):
        rc = lib.l2_topk_int8_launch(
            q.data_ptr(), c.data_ptr(), s.data_ptr(),
            None if v is None else v.data_ptr(), part_d.data_ptr(),
            part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B, N, D,
            k_eff, kt, splits, rows, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"l2_topk_int8 launch failed: CUDA error {rc}")
    INT8_LAUNCHES.inc()
    return pad_sentinel(out_d, out_i, k, k_eff)
