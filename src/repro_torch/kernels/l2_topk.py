"""Wrappers of the CUDA fused L2 + streaming top-k kernels (fp32, int8).

Replace ``repro/kernels/l2_topk.py::l2_topk_pallas`` and
``l2_topk_int8_pallas``; the kernels are the ``F32Rows`` and ``Int8Rows``
instances of the tile loop of ``csrc/l2_topk.cu`` (shared with the hybrid
scan, ``kernels.bm25``; its header note gives the design and the bounds).
This module checks the operands, allocates the outputs and the per-split
partial lists, chooses the split count, launches on PyTorch's current
stream and counts launches.  A ``k`` above ``KMAX`` is served in passes of
``KMAX`` (``common.topk_passes``), each one counted launch.  It takes CUDA
tensors only; the plain versions are ``ref.l2_topk_ref`` /
``ref.l2_topk_int8_ref`` and ``ops`` picks between kernel and plain version
by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (KMAX, LaunchCounter, empty_result,
                                        list_len, pad_sentinel, topk_passes,
                                        valid_operand)

__all__ = ["l2_topk", "l2_topk_int8", "LAUNCHES", "INT8_LAUNCHES",
           "library", "splits_for", "scan_outputs", "check_scan",
           "stream_handle", "ptr", "shared_bound", "tile_smem_bytes",
           "SMEM_MAX"]

LAUNCHES = LaunchCounter("l2_topk")
INT8_LAUNCHES = LaunchCounter("l2_topk_int8")

BN = 128        # rows per tile of the fp32 and int8 scans; splits are whole tiles
BQ = 64         # queries per block tile in every scan

# The tile loop of csrc/l2_topk.cu (namespace tile): its shared memory does
# not depend on d, since rows and queries are staged BK dims at a time
# through a ring of STAGES buffers (one more for int8 rows, whose chunks
# are widened to fp32 one step ahead, into two fp32 chunks).
TILE_BK = 16
TILE_STAGES = 3
TILE_LDK = TILE_BK + 4
TILE_LIST = 32
HYBRID_BN = 64      # rows a tile of the hybrid scan
UCAP = 257          # hit rows of the lexical dictionary (csrc/lexical.cuh)
SLAB_MAX = 16
DICT_BITS_MAX = 12
SMEM_MAX = 232448   # bytes of shared memory a block may use on sm_90


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def tile_smem_bytes(rows: str, t: int = 0) -> int:
    """Shared memory of one block of the tile loop for ``rows`` "f32",
    "hybrid" (with ``t`` query term slots) or "int8": ``tile::layout`` of
    ``csrc/l2_topk.cu``."""
    hybrid, int8 = rows == "hybrid", rows == "int8"
    bn = HYBRID_BN if hybrid else BN
    row_bytes = bn * TILE_BK if int8 else 4 * bn * TILE_LDK
    ring = TILE_STAGES + 1 if int8 else TILE_STAGES
    parts = [ring * (row_bytes + 4 * BQ * TILE_LDK)]    # the staged chunks
    if int8:
        parts.append(2 * 4 * bn * TILE_LDK)            # the widened chunks
    parts += [4 * BQ * (bn + 4),                       # the distance tile
              4 * BQ * TILE_LIST, 4 * BQ * TILE_LIST,  # the query lists
              4 * bn, 4 * BQ, 4 * BQ]                  # row norms, bounds
    if hybrid:
        bits = 1
        while (1 << bits) < 2 * BQ * t and bits < DICT_BITS_MAX:
            bits += 1
        groups = BQ // (256 // bn)
        parts += [4 * UCAP * bn, 8 * BQ * t, 4 << bits, 4 << bits,
                  2 * SLAB_MAX * bn, 4 * SLAB_MAX * bn, SLAB_MAX * bn,
                  4 * (2 * groups + BQ)]
    return sum(_up16(p) for p in parts)


_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def library():
    """The ``l2_topk`` library with its three launchers' signatures set
    (the hybrid one is wrapped by ``kernels.bm25``)."""
    global _lib
    if _lib is None:
        lib = _build.library("l2_topk")
        for fn, argtypes in (
                (lib.l2_topk_launch, [_P] * 10 + [_I] * 7 + [_P]),
                (lib.l2_topk_int8_launch, [_P] * 11 + [_I] * 7 + [_P]),
                (lib.hybrid_topk_launch, [_P] * 15 + [_I] * 9 + [_P])):
            fn.argtypes = argtypes
            fn.restype = _I
        lib.l2_tile_smem_bytes.argtypes = [_I] * 3
        lib.l2_tile_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def splits_for(b: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits of N, rows per split): about two blocks per SM over all
    query tiles, each split a whole number of BN-row tiles (so of the
    hybrid's and BM25's 64-row tiles too)."""
    tiles = -(-n // BN)
    q_tiles = -(-b // BQ)
    s = max(1, min(tiles, (2 * sm_count) // q_tiles))
    rows = -(-tiles // s) * BN
    return -(-n // rows), rows


def scan_outputs(b: int, n: int, k_eff: int, dev):
    """Outputs and partial lists (one a query and split) of a split scan
    over ``n`` rows: ``(out_d, out_i, part_d, part_i, kt, splits, rows per
    split)``."""
    kt = list_len(k_eff)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = splits_for(b, n, sm)
    out_d = torch.empty((b, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_eff), dtype=torch.int32, device=dev)
    part_d = torch.empty((b, splits, kt), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, kt), dtype=torch.int32, device=dev)
    return out_d, out_i, part_d, part_i, kt, splits, rows


def check_scan(name: str, queries, n: int, k: int) -> int:
    """Checks shared by the dense scans; returns ``k`` clamped to N."""
    if queries.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 queries")
    if queries.dim() != 2:
        raise ValueError(f"queries have shape {tuple(queries.shape)}, "
                         "not (B, D)")
    return min(k, n)


def stream_handle(dev) -> int:
    """PyTorch's current stream on ``dev``, as the launchers take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def ptr(t) -> "int | None":
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


# +inf as the tile's order key: the splits' shared bound before any split
# has a k-th distance
_INF_KEY = 0x7F800000


def shared_bound(b: int, dev) -> torch.Tensor:
    """The (B,) int32 scratch the tile shares its bound on each query's
    k-th distance through, +inf to start a pass."""
    return torch.full((b,), _INF_KEY, dtype=torch.int32, device=dev)


def l2_topk(queries: torch.Tensor, db: torch.Tensor, k: int = 10, *,
            valid=None):
    """Returns (dists (B, k) ascending fp32, ids (B, k) int32).

    ``valid`` is an optional (N,) liveness mask; dead rows never rank.
    ``k`` is clamped to N and the requested width restored with the
    ``(inf, -1)`` sentinel; any ``k`` is served (above ``KMAX`` in passes).
    Raises for a CPU tensor, a wrong dtype or shape, or a failed launch.
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

    def run(kr, after_d, after_i):
        out_d, out_i, part_d, part_i, kt, splits, rows = scan_outputs(
            B, N, kr, dev)
        with torch.cuda.device(dev):
            rc = lib.l2_topk_launch(
                q.data_ptr(), x.data_ptr(), ptr(v), ptr(after_d),
                ptr(after_i), shared_bound(B, dev).data_ptr(),
                part_d.data_ptr(), part_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), B, N, D, kr, kt, splits,
                rows, stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"l2_topk launch failed: CUDA error {rc}")
        LAUNCHES.inc()
        return out_d, out_i

    out_d, out_i = topk_passes(run, B, k_eff, KMAX, dev)
    return pad_sentinel(out_d, out_i, k, k_eff)


def l2_topk_int8(queries: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, k: int = 10, *, valid=None):
    """The int8-footprint scan: ``codes`` (N, D) int8 and ``scales`` (N,)
    float32 with ``row ~= scale * codes``; queries stay float32.  Same
    contract and errors as :func:`l2_topk`; any d."""
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

    def run(kr, after_d, after_i):
        out_d, out_i, part_d, part_i, kt, splits, rows = scan_outputs(
            B, N, kr, dev)
        with torch.cuda.device(dev):
            rc = lib.l2_topk_int8_launch(
                q.data_ptr(), c.data_ptr(), s.data_ptr(), ptr(v),
                ptr(after_d), ptr(after_i), shared_bound(B, dev).data_ptr(),
                part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), B, N, D, kr, kt, splits, rows,
                stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"l2_topk_int8 launch failed: CUDA error {rc}")
        INT8_LAUNCHES.inc()
        return out_d, out_i

    out_d, out_i = topk_passes(run, B, k_eff, KMAX, dev)
    return pad_sentinel(out_d, out_i, k, k_eff)
