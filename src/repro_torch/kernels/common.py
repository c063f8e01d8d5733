"""Shared helpers of the search kernels and their plain versions.

Mirrors ``repro/kernels/common.py``.  The result contract every kernel
keeps: ``k`` is clamped to the candidate count where the kernel says so,
dead rows (``valid == 0`` or ``id < 0``) never rank, unfilled slots come
back as the ``(inf, -1)`` sentinel, and ties break on ``(distance, id)``.
The device-side running top-k lives in ``csrc/topk_common.cuh``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["INF", "KMAX", "KMAX_PQ", "LAUNCH_COUNTERS", "LaunchCounter",
           "empty_result", "ids32", "list_len", "merge_topk", "pad_sentinel",
           "popcount32", "stable_topk", "topk_passes", "valid_operand"]

INF = float("inf")

# The longest register list of one pass of the CUDA kernels
# (csrc/topk_common.cuh): the dense scans instantiate lists of up to 32
# entries, the PQ scan up to 64 (its nprobe sweep reaches 64).  A larger k
# takes ceil(k / KMAX) passes (topk_passes); the Hamming scan has no list.
KMAX = 32
KMAX_PQ = 64
_ID_MAX = torch.iinfo(torch.int32).max


def list_len(k: int, kmax: int = KMAX) -> int:
    """Register-list length a kernel instantiates for ``k`` (8, 16, 32,
    and 64 where ``kmax`` allows it)."""
    if not 1 <= k <= kmax:
        raise ValueError(f"k={k} outside the kernels' range 1..{kmax}")
    return 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 else 64


# every kernel's counter by kernel name, so a run can reset and read all
LAUNCH_COUNTERS: "dict[str, LaunchCounter]" = {}


class LaunchCounter:
    """Counts a kernel's launches: its wrapper adds one where it launches
    the kernel and nowhere else, so a run can show that the main path
    went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        LAUNCH_COUNTERS[name] = self

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
    differently, so the port never uses it.

    The sort key is ``d + 0.0``, which turns -0.0 into +0.0: the card's
    radix sort would otherwise rank -0.0 before +0.0, while the kernels
    (and the CPU sort) hold them equal and break the tie on the column.
    A lexical distance is -0.0 for an unmatched document, and a hybrid
    one at alpha = 0 is -0.0 or +0.0 with the sign of the rounded L2
    term.  The values come back from ``d`` itself, signs intact."""
    _, idx = torch.sort(d + 0.0, dim=1, stable=True)
    idx = idx[:, :k]
    return torch.gather(d, 1, idx), idx


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


def topk_passes(run, b: int, k: int, kmax: int, device):
    """The top-``k`` of a kernel whose list holds at most ``kmax`` pairs, in
    ``ceil(k / kmax)`` passes.

    ``run(kr, after_d, after_i)`` launches the kernel once for ``kr <=
    kmax`` pairs a query, each pair strictly after ``(after_d[b],
    after_i[b])`` in the (distance, id) order (``None``: no bound), and
    returns its ``(B, kr)`` lists.  Pass r is bounded by each query's last
    pair of pass r - 1 and fills columns ``r kmax ..`` of the result; a
    query whose list ended in the ``(inf, -1)`` sentinel is bounded by
    ``(inf, int32 max)``, after which nothing ranks, so the rest of its row
    is sentinels too.  Everything stays on the device: no pass waits for
    the host.  A pair repeated in the candidates has one (distance, id),
    so both copies fall in the same pass, which emits it once."""
    if k <= kmax:
        return run(k, None, None)
    out_d = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)
    after_d = after_i = None
    for c0 in range(0, k, kmax):
        kr = min(kmax, k - c0)
        d, i = run(kr, after_d, after_i)
        out_d[:, c0:c0 + kr] = d
        out_i[:, c0:c0 + kr] = i
        last_d, last_i = d[:, -1], i[:, -1]
        done = last_i < 0
        after_d = torch.where(done, INF, last_d).contiguous()
        after_i = torch.where(done, _ID_MAX, last_i).to(torch.int32)
        after_i = after_i.contiguous()
    return out_d, out_i


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (the branch-free
    SWAR sequence of ``repro.kernels.common.popcount32``), computed in
    int64 so that no step overflows; returns int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


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


def empty_result(b: int, k: int, device):
    """(B, k) of the ``(inf, -1)`` sentinel: a scan over no rows."""
    return (torch.full((b, k), INF, device=device),
            torch.full((b, k), -1, dtype=torch.int32, device=device))


def ids32(ids) -> np.ndarray:
    """The low 32 bits of each integer id as an int32, as the reference's
    32-bit arrays hold it (JAX's default integers): an id in [2**31,
    2**32) is negative there, and 2**32 + 3 is 3.  Computed in int64, so
    no cast has to wrap."""
    x = np.asarray(ids, dtype=np.int64).ravel()
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).astype(np.int32)
