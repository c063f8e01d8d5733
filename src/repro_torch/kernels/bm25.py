"""Wrappers of the CUDA BM25 and hybrid (semantic + lexical) scans.

Replace ``repro/kernels/bm25.py::bm25_topk_pallas`` (the kernel is
``csrc/bm25_topk.cu``) and ``hybrid_topk_pallas`` (the ``HybridRows``
instantiation of ``csrc/l2_topk.cu``'s fp32 tile loop, whose d2 it
shares).  Both look each document's slab up in a dictionary of the
block's query terms (in groups of queries when the tile holds more
distinct terms than its hit rows) and read per-term hits, the device
functions of ``csrc/lexical.cuh``; both give the same bits.  A ``k`` above
``KMAX`` is served in passes (``common.topk_passes``), each one counted
launch.

Documents carry fixed-shape postings slabs (``core.lexical``): ``terms``
(N, S) int32, -1 padded, and ``tf_sat`` (N, S) float32; queries carry
(B, T) term ids and weights.

The hybrid blend ``alpha`` is a (1, 1) float32 tensor on the card, read
by the kernel: sweeping it builds nothing and never reads it back to the
host.  CUDA tensors only; the plain versions are ``ref.bm25_topk_ref`` /
``ref.hybrid_topk_ref`` and ``ops`` picks between kernel and plain
version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, l2_topk
from repro_torch.kernels.common import (KMAX, LaunchCounter, empty_result,
                                        pad_sentinel, topk_passes,
                                        valid_operand)
from repro_torch.kernels.l2_topk import ptr

__all__ = ["bm25_topk", "hybrid_topk", "LAUNCHES", "HYBRID_LAUNCHES",
           "SLAB_MAX", "MAX_T"]

LAUNCHES = LaunchCounter("bm25_topk")
HYBRID_LAUNCHES = LaunchCounter("hybrid_topk")

SLAB_MAX = 16   # widest slab row (rt::SLAB_MAX in csrc/lexical.cuh)
MAX_T = 64      # query term slots staged in shared memory

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("bm25_topk")
        lib.bm25_topk_launch.argtypes = ([ctypes.c_void_p] * 11
                                         + [ctypes.c_int] * 8
                                         + [ctypes.c_void_p])
        lib.bm25_topk_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_lexical(name, q_terms, q_weights, terms, tf_sat):
    """Operand checks shared by both scans; returns (B, T, N, S)."""
    if q_terms.dtype != torch.int32 or terms.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 term ids")
    if q_weights.dtype != torch.float32 or tf_sat.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 weights and tf_sat")
    if q_terms.dim() != 2 or terms.dim() != 2 or (
            q_weights.shape != q_terms.shape) or tf_sat.shape != terms.shape:
        raise ValueError(f"{name}: q_terms/q_weights must be (B, T) and "
                         "terms/tf_sat (N, S)")
    (B, T), (N, S) = q_terms.shape, terms.shape
    if S > SLAB_MAX:
        raise ValueError(f"{name}: slabs of {S} slots exceed the kernel's "
                         f"{SLAB_MAX}")
    if T > MAX_T:
        raise ValueError(f"{name}: {T} query term slots exceed {MAX_T}")
    return B, T, N, S


def bm25_topk(q_terms: torch.Tensor, q_weights: torch.Tensor,
              terms: torch.Tensor, tf_sat: torch.Tensor, k: int = 10, *,
              valid=None):
    """Returns (ranking dists = -bm25 (B, k) ascending fp32, ids (B, k)
    int32).  ``valid`` (N,) masks dead rows; ``k`` is clamped to N and
    restored with the ``(inf, -1)`` sentinel; any ``k`` is served (above
    ``KMAX`` in passes).  Raises for a CPU tensor, a wrong dtype or shape,
    slabs wider than ``SLAB_MAX``, or a failed launch."""
    tensors = (q_terms, q_weights, terms, tf_sat)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("bm25_topk takes CUDA tensors; the plain version is "
                         "ref.bm25_topk_ref")
    B, T, N, S = _check_lexical("bm25_topk", *tensors)
    k_eff = min(k, N)
    dev = q_terms.device
    if B == 0 or k_eff == 0:
        return empty_result(B, k, dev)
    qt, qw, t, f = (x.contiguous() for x in tensors)
    v = valid_operand(valid, N, dev)
    lib = _library()

    def run(kr, after_d, after_i):
        out_d, out_i, part_d, part_i, kt, splits, rows = l2_topk.scan_outputs(
            B, N, kr, dev)
        with torch.cuda.device(dev):
            rc = lib.bm25_topk_launch(
                qt.data_ptr(), qw.data_ptr(), t.data_ptr(), f.data_ptr(),
                ptr(v), ptr(after_d), ptr(after_i), part_d.data_ptr(),
                part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B, N,
                T, S, kr, kt, splits, rows, l2_topk.stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"bm25_topk launch failed: CUDA error {rc}")
        LAUNCHES.inc()
        return out_d, out_i

    out_d, out_i = topk_passes(run, B, k_eff, KMAX, dev)
    return pad_sentinel(out_d, out_i, k, k_eff)


def hybrid_topk(queries: torch.Tensor, db: torch.Tensor,
                q_terms: torch.Tensor, q_weights: torch.Tensor,
                terms: torch.Tensor, tf_sat: torch.Tensor,
                alpha: torch.Tensor, k: int = 10, *, valid=None):
    """Fused ``alpha * l2sq - (1 - alpha) * bm25`` top-k: (dists (B, k)
    ascending fp32, ids (B, k) int32).  ``alpha`` is a (1, 1) float32 CUDA
    tensor.  Same contract and errors as :func:`bm25_topk`, plus the
    dense operands' of ``l2_topk``."""
    tensors = (queries, db, q_terms, q_weights, terms, tf_sat, alpha)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("hybrid_topk takes CUDA tensors; the plain version "
                         "is ref.hybrid_topk_ref")
    if db.dtype != torch.float32 or alpha.dtype != torch.float32:
        raise TypeError("hybrid_topk takes a float32 db and alpha")
    if alpha.numel() != 1:
        raise ValueError("alpha must be a (1, 1) tensor")
    B, T, N, S = _check_lexical("hybrid_topk", q_terms, q_weights, terms,
                                tf_sat)
    if db.dim() != 2 or tuple(queries.shape[:1]) != (B,) or (
            db.shape[0] != N) or queries.dim() != 2 or (
            queries.shape[1] != db.shape[1]):
        raise ValueError(f"hybrid_topk: queries {tuple(queries.shape)} / db "
                         f"{tuple(db.shape)} do not match the term operands "
                         f"(B={B}, N={N})")
    D = queries.shape[1]
    k_eff = l2_topk.check_scan("hybrid_topk", queries, N, k)
    dev = queries.device
    if B == 0 or k_eff == 0:
        return empty_result(B, k, dev)
    q, x, qt, qw, t, f, a = (x_.contiguous() for x_ in tensors)
    v = valid_operand(valid, N, dev)
    lib = l2_topk.library()

    def run(kr, after_d, after_i):
        out_d, out_i, part_d, part_i, kt, splits, rows = l2_topk.scan_outputs(
            B, N, kr, dev)
        with torch.cuda.device(dev):
            rc = lib.hybrid_topk_launch(
                q.data_ptr(), x.data_ptr(), qt.data_ptr(), qw.data_ptr(),
                t.data_ptr(), f.data_ptr(), a.data_ptr(), ptr(v),
                ptr(after_d), ptr(after_i),
                l2_topk.shared_bound(B, dev).data_ptr(), part_d.data_ptr(),
                part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B, N,
                D, T, S, kr, kt, splits, rows, l2_topk.stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"hybrid_topk launch failed: CUDA error {rc}")
        HYBRID_LAUNCHES.inc()
        return out_d, out_i

    out_d, out_i = topk_passes(run, B, k_eff, KMAX, dev)
    return pad_sentinel(out_d, out_i, k, k_eff)
