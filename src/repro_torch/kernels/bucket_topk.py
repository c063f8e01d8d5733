"""Wrappers of the CUDA candidate-row top-k kernel: one probe step, or the
whole probe chain.

Replaces ``repro/kernels/bucket_topk.py::candidate_topk_pallas``; the
kernel is ``csrc/candidate_topk.cu`` (its header note gives the design
and the bound).  Two entries share its device code and its launch count:

* ``candidate_topk``: each query row scores its own ``(C, D)`` candidate
  tile and merges it into an optionally carried running best (the Pallas
  kernel's contract);
* ``bucket_probe_topk``: each query scores the slots of its probed buckets
  in one scan and one merge, the rows read inside the kernel, from
  ``bucket_vecs`` by (bucket, slot) or from ``db`` by entity id.  On
  disjoint buckets it equals the chain of ``candidate_topk`` steps bit for
  bit.

Both check the operands, choose the split count, allocate the outputs and
the per-block partial lists, launch on PyTorch's current stream and count
one launch of ``candidate_topk`` per pass: one a call up to ``KMAX``, and
``ceil(k / KMAX)`` above it (``common.topk_passes``).  CUDA tensors only;
the plain versions are ``ref.candidate_topk_ref`` /
``ref.bucket_probe_topk_ref`` and ``ops`` picks between kernel and plain
version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (KMAX, LaunchCounter, empty_result,
                                        list_len, topk_passes)
from repro_torch.kernels.l2_topk import ptr

__all__ = ["candidate_topk", "bucket_probe_topk", "splits_for", "LAUNCHES"]

LAUNCHES = LaunchCounter("candidate_topk")

MAX_D = 8192          # the query row in the scan block's shared memory
MIN_SEGMENT = 64      # slots a tile segment holds at least
BLOCKS_PER_SM = 4     # tile segments: enough blocks for this many a SM

_fns: dict = {}


_P, _I = ctypes.c_void_p, ctypes.c_int
# each extern "C" launcher's arguments; the last is the stream
_ARGTYPES = {
    "candidate_topk_launch": [_P] * 5 + [_I] + [_P] * 6 + [_I] * 7 + [_P],
    "bucket_probe_topk_launch": [_P] * 4 + [_I] + [_P] * 6 + [_I] * 7 + [_P],
}


def _launcher(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.library("candidate_topk"), name)
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def splits_for(b: int, c: int, sm_count: int) -> int:
    """Segments of a query's C slots: about ``BLOCKS_PER_SM`` blocks a SM
    over the batch, each segment at least ``MIN_SEGMENT`` slots."""
    want = -(-BLOCKS_PER_SM * sm_count // max(b, 1))
    return max(1, min(-(-c // MIN_SEGMENT), want))


def _check_cuda(name: str, plain: str, tensors) -> None:
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors; the plain version is "
                         f"ref.{plain}")


def _rows_operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 rows, 16-byte aligned: the kernel reads float4s
    where D is a multiple of 4, so the rounding depends on D alone."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def candidate_topk(queries: torch.Tensor, vecs: torch.Tensor,
                   ids: torch.Tensor, k: int = 10, *, best_d=None,
                   best_i=None):
    """Returns (dists (B, k) ascending fp32, ids (B, k) int32).

    ``vecs`` (B, C, D) float32 and ``ids`` (B, C) int32 are each query's
    candidates, ``id < 0`` marking a dead slot.  With ``best_d``/``best_i``
    (B, k) the result is their merge with the tile, otherwise the list
    starts from the ``(inf, -1)`` sentinel; ``k`` may exceed C, and any
    ``k`` is served (above ``KMAX`` in passes).  A pair seen twice is
    emitted once.  Raises for a CPU tensor, a wrong dtype or shape, or a
    failed launch.
    """
    tensors = [queries, vecs, ids] + [t for t in (best_d, best_i)
                                      if t is not None]
    _check_cuda("candidate_topk", "candidate_topk_ref", tensors)
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
    if D > MAX_D:
        raise ValueError(f"D={D} exceeds the kernel's MAX_D={MAX_D}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if best_d is not None:
        if best_d.dtype != torch.float32 or best_i.dtype != torch.int32:
            raise TypeError("best_d/best_i must be float32/int32")
        if tuple(best_d.shape) != (B, k) or tuple(best_i.shape) != (B, k):
            raise ValueError(f"best lists must be {(B, k)}")
        best_d, best_i = best_d.contiguous(), best_i.contiguous()
    dev = queries.device
    if B == 0:
        return empty_result(B, k, dev)
    q, v, i = queries.contiguous(), _rows_operand(vecs), ids.contiguous()
    splits = splits_for(
        B, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    per = -(-C // splits)
    fn = _launcher("candidate_topk_launch")

    def run(kr, after_d, after_i):
        kt = list_len(kr)
        part_d = torch.empty((B, splits, kt), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, splits, kt), dtype=torch.int32, device=dev)
        out_d = torch.empty((B, kr), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, kr), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = fn(q.data_ptr(), v.data_ptr(), i.data_ptr(), ptr(best_d),
                    ptr(best_i), k, ptr(after_d), ptr(after_i),
                    part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                    out_i.data_ptr(), B, C, D, kr, kt, splits, per,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"candidate_topk launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES.inc()
        return out_d, out_i

    return topk_passes(run, B, k, KMAX, dev)


def bucket_probe_topk(queries: torch.Tensor, probe: torch.Tensor,
                      bucket_ids: torch.Tensor, k: int = 10, *,
                      bucket_vecs=None, db=None):
    """Returns (dists (B, k) ascending fp32, ids (B, k) int32): the top-k
    of the union of each query's probed buckets.

    ``probe`` (B, nprobe) integer holds bucket numbers in ``0..K-1`` (a
    number outside that range probes nothing); ``bucket_ids`` (K, cap)
    int32 the entity ids, ``-1`` marking a dead slot anywhere in a row.
    The rows are ``bucket_vecs`` (K, cap, D) float32 by (bucket, slot), or
    ``db`` (N, D) float32 by entity id: exactly one of the two.  A pair
    seen twice (a bucket probed twice) is emitted once; ``k`` may exceed
    the live candidates, and any ``k`` is served (above ``KMAX`` in
    passes).  Raises for a CPU tensor, a wrong dtype or shape, or a failed
    launch.
    """
    if (bucket_vecs is None) == (db is None):
        raise ValueError("pass exactly one of bucket_vecs and db")
    rows = bucket_vecs if db is None else db
    _check_cuda("bucket_probe_topk", "bucket_probe_topk_ref",
                [queries, probe, bucket_ids, rows])
    if queries.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError("bucket_probe_topk takes float32 queries and rows")
    if bucket_ids.dtype != torch.int32:
        raise TypeError("bucket_probe_topk takes int32 bucket_ids")
    if probe.dtype.is_floating_point or probe.dtype == torch.bool:
        raise TypeError("bucket_probe_topk takes integer probe ids")
    if queries.dim() != 2 or probe.dim() != 2 or bucket_ids.dim() != 2:
        raise ValueError("queries, probe and bucket_ids must be 2-d")
    B, D = queries.shape
    K, cap = bucket_ids.shape
    nprobe = probe.shape[1]
    if probe.shape[0] != B:
        raise ValueError(f"probe {tuple(probe.shape)} does not match "
                         f"{B} queries")
    if db is None and tuple(rows.shape) != (K, cap, D):
        raise ValueError(f"bucket_vecs {tuple(rows.shape)} is not "
                         f"{(K, cap, D)}")
    if db is not None and (rows.dim() != 2 or rows.shape[1] != D):
        raise ValueError(f"db {tuple(rows.shape)} is not (N, {D})")
    if D > MAX_D:
        raise ValueError(f"D={D} exceeds the kernel's MAX_D={MAX_D}")
    if nprobe > 65535:
        raise ValueError(f"nprobe={nprobe} exceeds the grid's 65535")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    dev = queries.device
    if B == 0:
        return empty_result(B, k, dev)
    q, r = queries.contiguous(), _rows_operand(rows)
    p = probe.to(torch.int32).contiguous()
    bids = bucket_ids.contiguous()
    fn = _launcher("bucket_probe_topk_launch")

    def run(kr, after_d, after_i):
        kt = list_len(kr)
        part_d = torch.empty((B, nprobe, kt), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, nprobe, kt), dtype=torch.int32, device=dev)
        out_d = torch.empty((B, kr), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, kr), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = fn(q.data_ptr(), p.data_ptr(), bids.data_ptr(), r.data_ptr(),
                    int(db is not None), ptr(after_d), ptr(after_i),
                    part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                    out_i.data_ptr(), B, nprobe, K, cap, D, kr, kt,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bucket_probe_topk launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES.inc()
        return out_d, out_i

    return topk_passes(run, B, k, KMAX, dev)
