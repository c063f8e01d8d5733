"""Wrapper of the CUDA tree beam descent kernel.

Runs the reference's compiled ``lax.while_loop`` descent of
``repro/core/tree.py::tree_search`` (no Pallas kernel there: XLA's loop)
as one launch; the kernel is ``csrc/tree_descent.cu``, whose header note
gives the step, the per-row exit and why it equals the reference's batch
exit, the design and the bound.  This module checks the operands,
allocates the outputs, launches on PyTorch's current stream and counts
launches.  CUDA tensors only; the plain version is
``ref.tree_descent_ref`` and ``ops.tree_descent_op`` picks between them by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LaunchCounter

__all__ = ["tree_descent", "smem_bytes", "LAUNCHES", "MAX_SMEM"]

LAUNCHES = LaunchCounter("tree_descent")

MAX_SMEM = 227 * 1024      # dynamic shared memory a block on the H100

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("tree_descent").tree_descent_launch
        f.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def smem_bytes(d: int, w: int) -> int:
    """Dynamic shared memory a block takes: the query (d) and the beam's
    nodes, priorities, margins, flags and 2W candidates (8W words)."""
    return 4 * (d + 8 * w)


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"tree_descent takes CUDA tensors: {name} is on "
                         f"{t.device}; the plain version is "
                         "ref.tree_descent_ref")
    if t.dtype != dtype:
        raise TypeError(f"tree_descent: {name} is {t.dtype}, not {dtype}")
    return t.contiguous()


def tree_descent(arrays: dict, queries: torch.Tensor, *, kind: str,
                 beam_width: int, max_steps: int, roots=None):
    """The beam descent and its leaf gather in one launch.

    ``arrays`` are a tree's (or a forest's) tensors
    (``FlatTree.device_arrays``), ``queries`` (R, d) fp32, ``roots`` an
    optional (R,) start node a row.  Returns (nodes (R, W), steps (R,),
    internal_visits (R,), candidates (R, W leaf) with -1 pads, their count
    (R,)), all int32.  Raises for a CPU tensor, a wrong kind, dtype or
    shape, or a failed launch.
    """
    if kind not in ("rp", "kd"):
        raise ValueError(f"tree_descent: unknown kind {kind!r}")
    W = int(beam_width)
    if W < 1 or max_steps < 0:
        raise ValueError(f"tree_descent: beam_width {W} and max_steps "
                         f"{max_steps} must be >= 1 and >= 0")
    q = _operand(queries, torch.float32, "queries")
    if q.dim() != 2:
        raise ValueError(f"queries have shape {tuple(q.shape)}, not (R, d)")
    R, d = q.shape
    children = _operand(arrays["children"], torch.int32, "children")
    tau = _operand(arrays["tau"], torch.float32, "tau")
    leaf_row = _operand(arrays["leaf_row"], torch.int32, "leaf_row")
    leaf_ents = _operand(arrays["leaf_entities"], torch.int32,
                         "leaf_entities")
    N = tau.shape[0]
    if children.shape != (N, 2) or leaf_row.shape != (N,) or (
            leaf_ents.dim() != 2):
        raise ValueError("tree tables are not children (N, 2), tau (N,), "
                         "leaf_row (N,), leaf_entities (L, leaf)")
    if kind == "kd":
        split = _operand(arrays["dims"], torch.int32, "dims")
        if split.shape != (N,):
            raise ValueError(f"dims have shape {tuple(split.shape)}, not "
                             f"({N},)")
        proj, dims = None, split
    else:
        proj = _operand(arrays["proj"], torch.float32, "proj")
        if proj.shape != (N, d):
            raise ValueError(f"proj has shape {tuple(proj.shape)}, not "
                             f"({N}, {d})")
        dims = None
    r = None
    if roots is not None:
        r = _operand(roots, torch.int32, "roots")
        if r.shape != (R,):
            raise ValueError(f"roots have shape {tuple(r.shape)}, not ({R},)")
    if smem_bytes(d, W) > MAX_SMEM:
        raise ValueError(f"tree_descent: d={d} and W={W} need "
                         f"{smem_bytes(d, W)} B of shared memory, above "
                         f"{MAX_SMEM}")
    leaf = leaf_ents.shape[1]
    dev = q.device
    nodes = torch.empty((R, W), dtype=torch.int32, device=dev)
    steps = torch.empty((R,), dtype=torch.int32, device=dev)
    visits = torch.empty((R,), dtype=torch.int32, device=dev)
    cand = torch.empty((R, W * leaf), dtype=torch.int32, device=dev)
    n_cand = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return nodes, steps, visits, cand, n_cand

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(children.data_ptr(), tau.data_ptr(), ptr(proj), ptr(dims),
                q.data_ptr(), ptr(r), leaf_row.data_ptr(),
                leaf_ents.data_ptr(), nodes.data_ptr(), steps.data_ptr(),
                visits.data_ptr(), cand.data_ptr(), n_cand.data_ptr(), R, d,
                W, int(max_steps), leaf,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tree_descent launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return nodes, steps, visits, cand, n_cand
