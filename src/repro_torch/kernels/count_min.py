"""Wrapper of the CUDA count-min sketch update kernel.

Runs the reference's jitted ``_update`` of ``repro/adaptive/sketch.py``
(no Pallas kernel there: one XLA program) as one launch: the decay, the
hash, the adds in batch order and the heavy-hitter re-rank; the kernel is
``csrc/count_min.cu``, whose header note gives the phases, the design and
the bound.  This module checks the operands, allocates the outputs and the
scratch in one block, hands the batch over, launches on PyTorch's current
stream (the sketch makes its own stream current) and counts launches.

The batch reaches the card without a blocking copy: up to ``INLINE`` ids
and weights travel in the launch's parameters; a larger batch is packed
into one pinned buffer from PyTorch's caching host allocator and copied
with ``non_blocking=True`` (the allocator keeps the buffer until the copy
has run), so an update is one launch and at most one asynchronous copy.
CUDA tensors only; the plain version is ``ref.count_min_update_ref`` and
``ops.count_min_update_op`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LaunchCounter, ids32

__all__ = ["count_min_update", "scratch_words", "INLINE", "SLICE",
           "LAUNCHES"]

LAUNCHES = LaunchCounter("count_min")

INLINE = 256       # ids a batch passes by value (csrc/count_min.cu: INLINE)
SLICE = 1024       # cells a copy block decays (csrc/count_min.cu: SLICE)

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("count_min").count_min_launch
        f.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def scratch_words(depth: int, topk: int, m: int) -> int:
    """Words of the kernel's scratch (``csrc/count_min.cu``:
    ``scratch_words``): the batch's columns and folded values, then the
    candidates, their estimates, and their columns and old cells."""
    return 2 * depth * m + (topk + m) * (2 + 2 * depth)


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"count_min takes CUDA tensors: {name} is on "
                         f"{t.device}; the plain version is "
                         "ref.count_min_update_ref")
    if t.dtype != dtype:
        raise TypeError(f"count_min: {name} is {t.dtype}, not {dtype}")
    return t.contiguous()


def count_min_update(table: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     hh_ids: torch.Tensor, ids, weights, decay: float):
    """One sketch update in one launch.

    ``table`` (depth, width) fp32 with width a power of two, ``a`` / ``b``
    (depth,) int64 holding the rows' uint32 multipliers, ``hh_ids`` (topk,)
    int32, all on one card; ``ids`` and ``weights`` (m,) on the host (any
    integer ids, taken by their low 32 bits; float32 weights), ``decay`` a
    float32 value.  Returns the new (table, hh_ids (topk,) int32, hh_est
    (topk,) fp32): fresh tensors, views of one allocation whose tail is
    the kernel's scratch; the inputs are never written.  Raises for a CPU
    tensor, a wrong dtype or shape, or a failed launch.
    """
    t = _operand(table, torch.float32, "table")
    if t.dim() != 2:
        raise ValueError(f"table has shape {tuple(t.shape)}, not (depth, "
                         "width)")
    depth, width = t.shape
    if width < 1 or width & (width - 1) or width > 1 << 30:
        raise ValueError(f"count_min: width {width} is not a power of two "
                         "up to 2**30")
    a = _operand(a, torch.int64, "a")
    b = _operand(b, torch.int64, "b")
    hh = _operand(hh_ids, torch.int32, "hh_ids")
    if a.shape != (depth,) or b.shape != (depth,) or hh.dim() != 1:
        raise ValueError("count_min: a and b must be (depth,), hh_ids "
                         "(topk,)")
    x = ids32(ids)
    w = np.ascontiguousarray(np.asarray(weights, np.float32).ravel())
    m, topk = x.size, hh.shape[0]
    if w.size != m:
        raise ValueError(f"count_min: {m} ids and {w.size} weights")
    dev = t.device
    cells = depth * width
    # the table, the estimates, the ids, then the kernel's scratch, which
    # it uses only where it does not fit in its shared memory
    flat = torch.empty((cells + 2 * topk + scratch_words(depth, topk, m),),
                       dtype=torch.float32, device=dev)
    new_table = flat[:cells].view(depth, width)
    hh_est = flat[cells:cells + topk]
    new_ids = flat[cells + topk:cells + 2 * topk].view(torch.int32)
    staged = None
    if m > INLINE:
        packed = np.concatenate([x, w.view(np.int32)])
        staged = torch.from_numpy(packed).pin_memory().to(
            dev, non_blocking=True)
    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(t.data_ptr(), a.data_ptr(), b.data_ptr(), hh.data_ptr(),
                None if staged is not None else x.ctypes.data,
                None if staged is not None else w.ctypes.data,
                None if staged is None else staged.data_ptr(),
                new_table.data_ptr(), new_ids.data_ptr(), hh_est.data_ptr(),
                flat.data_ptr() + 4 * (cells + 2 * topk), depth,
                int(width).bit_length() - 1, topk, m, float(decay),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"count_min launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return new_table, new_ids, hh_est
