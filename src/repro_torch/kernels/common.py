"""Shared helpers of the search kernels and their plain versions.

Mirrors ``repro/kernels/common.py``.  The result contract every kernel
keeps: ``k`` is clamped to the candidate count where the kernel says so,
dead rows (``valid == 0`` or ``id < 0``) never rank, unfilled slots come
back as the ``(inf, -1)`` sentinel, and ties break on ``(distance, id)``.
The device-side running top-k lives in ``csrc/topk_common.cuh``.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["INF", "KMAX", "LaunchCounter", "list_len", "merge_topk",
           "pad_sentinel", "stable_topk", "valid_operand"]

INF = float("inf")

# Compile-time ceiling on k in the CUDA kernels (rt::KMAX in
# csrc/topk_common.cuh); the wrappers refuse a larger k.
KMAX = 32


def list_len(k: int) -> int:
    """Register-list length a kernel instantiates for ``k`` (8, 16, 32)."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"k={k} outside the kernels' range 1..{KMAX}")
    return 8 if k <= 8 else 16 if k <= 16 else 32


class LaunchCounter:
    """Counts a kernel's launches: its wrapper adds one where it launches
    the kernel and nowhere else, so a run can show that the main path
    went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


def stable_topk(d: torch.Tensor, k: int):
    """The ``k`` smallest of each row, ascending, ties toward the lower
    column: ``lax.top_k(-d, k)``'s order.  ``torch.topk`` breaks ties
    differently, so the port never uses it."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def merge_topk(best_d, best_i, tile_d, tile_i, k: int):
    """Merge a (B, T) score tile into the running (B, K) best lists under
    the kernels' rule: ascending on the (distance, id) pair.

    K iterative masked mins over ``[best | tile]``, as
    ``repro.kernels.common.merge_topk``: equal distances go to the smaller
    id, and every copy of the selected (distance, id) pair is retired, so
    a duplicated candidate is emitted once.
    """
    cat_d = torch.cat([best_d, tile_d], dim=1)
    cat_i = torch.cat([best_i, tile_i], dim=1)
    imax = torch.iinfo(torch.int32).max
    out_d, out_i = [], []
    for _ in range(k):
        md = cat_d.min(dim=1).values
        tie = cat_d == md[:, None]
        mi = torch.where(tie, cat_i, imax).min(dim=1).values
        out_d.append(md)
        out_i.append(mi)
        cat_d = torch.where(tie & (cat_i == mi[:, None]), INF, cat_d)
    return torch.stack(out_d, dim=1), torch.stack(out_i, dim=1)


def valid_operand(valid, n: int, device) -> "torch.Tensor | None":
    """Liveness mask as the (n,) int32 kernel operand; ``None`` means all
    ``n`` rows live (the kernels take a null pointer for that)."""
    if valid is None:
        return None
    v = torch.as_tensor(valid, device=device)
    if v.shape != (n,):
        raise ValueError(f"valid has shape {tuple(v.shape)}, expected ({n},)")
    return v.to(torch.int32).contiguous()


def pad_sentinel(d, i, k: int, k_eff: int):
    """Restore the caller's requested ``k`` after an internal clamp: the
    impossible slots are the documented ``(inf, -1)`` sentinel."""
    if k_eff == k:
        return d, i
    b = d.shape[0]
    return (torch.cat([d, d.new_full((b, k - k_eff), INF)], dim=1),
            torch.cat([i, i.new_full((b, k - k_eff), -1)], dim=1))
