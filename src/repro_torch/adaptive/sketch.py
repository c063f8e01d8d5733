"""Fixed-shape decayed count-min sketch with heavy-hitter tracking, in torch.

Port of ``repro/adaptive/sketch.py``.  The table, the hash multipliers
and the heavy-hitter arrays are tensors on an explicit device (the card
unless the caller passes ``device="cpu"``):

  * **exponential decay** -- counts are multiplied by
    ``0.5 ** (m / halflife)`` per ``m``-observation batch (``m`` the real
    batch size, before padding), so the sketch tracks the *recent*
    likelihood that drift detection needs;
  * **heavy hitters** -- a top-k id / estimate pair kept inside the same
    update (candidates: the current top-k, then the batch), a cheap read
    of the current head without a full table scan.

Hashing is multiply-shift over uint32 (width a power of two).  Torch has
no dependable uint32 multiply on every backend, so the hash runs in
int64: ``((a * x + b) & 0xFFFFFFFF) >> shift``.  The int64 product wraps
in two's complement and its low 32 bits are exact, so the columns are the
reference's.

The reference's scatter-add runs its updates one after another in batch
order.  ``index_put_(accumulate=True)`` may add duplicates in another
order, or sum them before adding (and does so differently on the card and
on the CPU), so the update adds in passes: pass ``p`` holds the ``p``-th
occurrence of every table cell in batch order, each cell at most once a
pass.  Every device then rounds exactly as the reference does, weighted
or not.  The passes are planned on the host from the batch's columns
(the same multiply-shift in numpy uint64, where it cannot wrap), so an
update never waits for the card: the estimator observes every served
request, cache hits included, under one lock.  Batches are padded to the
next power of two (id -1, weight 0), as the reference pads them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.common import stable_topk

__all__ = ["CountMinSketch"]

_LOW32 = 0xFFFFFFFF


def _hash(ids: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          width: int) -> torch.Tensor:
    """Multiply-shift universal hash -> (depth, m) int64 column indices.
    ``ids`` int64 (taken mod 2**32, as the reference's uint32 cast);
    ``a`` / ``b`` int64 holding uint32 values."""
    shift = 32 - int(np.log2(width))
    x = ids & _LOW32
    h = (a[:, None] * x[None, :] + b[:, None]) & _LOW32
    return h >> shift


def _query(table: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Conservative estimates of ``ids`` (int64, on the table's device);
    0 for id < 0."""
    depth, width = table.shape
    valid = ids >= 0
    h = _hash(torch.where(valid, ids, 0), a, b, width)
    rows = torch.arange(depth, device=table.device)[:, None]
    est = table[rows, h].amin(dim=0)
    return torch.where(valid, est, 0.0)


def _host_columns(ids: np.ndarray, a: np.ndarray, b: np.ndarray,
                  width: int) -> np.ndarray:
    """``_hash`` on the host: (depth, m) columns of int64 ``ids`` with the
    uint32 multipliers held as uint64 (a * x + b < 2**64: no wrap)."""
    shift = np.uint64(32 - int(np.log2(width)))
    x = (ids & _LOW32).astype(np.uint64)
    h = (a[:, None] * x[None, :] + b[:, None]) & np.uint64(_LOW32)
    return (h >> shift).astype(np.int64)


def _passes(cells: np.ndarray, w: np.ndarray):
    """Order the adds ``cells`` (flat table indices, in batch order) and
    their weights into passes that each touch a cell at most once, the
    ``p``-th pass holding every cell's ``p``-th add.  Returns (cells,
    weights, adds a pass)."""
    order = np.argsort(cells, kind="stable")
    s = cells[order]
    pos = np.arange(s.size)
    new_run = np.ones(s.size, bool)
    new_run[1:] = s[1:] != s[:-1]
    rank = pos - np.maximum.accumulate(np.where(new_run, pos, 0))
    by_rank = np.argsort(rank, kind="stable")
    return s[by_rank], w[order][by_rank], np.bincount(rank).tolist()


def _update(table, a, b, hh_ids, ids, cells, vals, counts, decay: float):
    """One batch: decay, the adds in their passes, re-rank the heavy
    hitters.  Returns new tensors (the old ones are never mutated, so a
    reader holding them sees one consistent state)."""
    table = table * decay
    flat = table.view(-1)
    lo = 0
    for c in counts:
        sl = cells[lo:lo + c]
        flat[sl] = flat[sl] + vals[lo:lo + c]
        lo += c

    # heavy hitters: re-rank the current top-k and the batch ids by their
    # fresh estimates; duplicates are masked so one id holds one slot
    cand = torch.cat([hh_ids, ids.to(torch.int32)])
    est = _query(table, a, b, cand.long())
    est = torch.where(cand >= 0, est, -torch.inf)
    order = torch.argsort(cand, stable=True)
    sc = cand[order]
    dup_sorted = torch.zeros_like(sc, dtype=torch.bool)
    dup_sorted[1:] = (sc[1:] == sc[:-1]) & (sc[1:] >= 0)
    dup = torch.zeros_like(dup_sorted)
    dup[order] = dup_sorted
    est = torch.where(dup, -torch.inf, est)
    # lax.top_k's order: largest first, ties to the lower index
    neg, top_i = stable_topk(-est[None], hh_ids.shape[0])
    top_est, top_i = -neg[0], top_i[0]
    gone = torch.isneginf(top_est)
    new_ids = torch.where(gone, -1, cand[top_i]).to(torch.int32)
    new_est = torch.where(gone, 0.0, top_est)
    return table, new_ids, new_est


class CountMinSketch:
    """Decayed CMS + top-k heavy hitters over int entity ids.

    ``halflife`` is measured in observations: after ``halflife`` more
    observations an old count has decayed to half its weight; ``None``
    disables decay.  Updates pad the batch to the next power of two.
    """

    def __init__(self, *, width: int = 4096, depth: int = 4,
                 topk: int = 64, halflife: Optional[float] = None,
                 seed: int = 0, device=None):
        if width & (width - 1):
            raise ValueError(f"width must be a power of two, got {width}")
        self.device = resolve(device)
        rng = np.random.default_rng(seed)
        self.width = width
        self.depth = depth
        self.halflife = halflife
        # the reference's draws: odd uint32 multipliers and uint32 offsets
        a = rng.integers(1, 2**32, size=depth, dtype=np.uint32) | 1
        b = rng.integers(0, 2**32, size=depth, dtype=np.uint32)
        self._a = torch.as_tensor(a.astype(np.int64), device=self.device)
        self._b = torch.as_tensor(b.astype(np.int64), device=self.device)
        self._a_host, self._b_host = a.astype(np.uint64), b.astype(np.uint64)
        self.table = torch.zeros((depth, width), dtype=torch.float32,
                                 device=self.device)
        self.hh_ids = torch.full((topk,), -1, dtype=torch.int32,
                                 device=self.device)
        self.hh_est = torch.zeros((topk,), dtype=torch.float32,
                                  device=self.device)
        self.n_observed = 0.0      # decayed total weight in the table

    def columns(self, ids: np.ndarray) -> np.ndarray:
        """(depth, m) hash columns of ``ids`` (for tests and tools)."""
        t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return _hash(t, self._a, self._b, self.width).cpu().numpy()

    def update(self, ids: np.ndarray, weights: Optional[np.ndarray] = None):
        """Fold a batch of observed entity ids into the sketch."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if ids.size == 0:
            return
        w = (np.ones(ids.size, np.float32) if weights is None
             else np.asarray(weights, np.float32).ravel())
        # decay follows the real observation count, computed before the
        # power-of-two padding, so the halflife does not depend on batching
        decay = (1.0 if self.halflife is None
                 else float(0.5 ** (ids.size / self.halflife)))
        m = 1
        while m < ids.size:
            m <<= 1
        pad = m - ids.size
        if pad:
            ids = np.pad(ids, (0, pad), constant_values=-1)
            w = np.pad(w, (0, pad))
        # the adds: invalid (and pad) ids hash as id 0 with weight 0, as
        # in the reference
        valid = ids >= 0
        h = _host_columns(np.where(valid, ids, 0), self._a_host,
                          self._b_host, self.width)
        cells, vals, counts = _passes(
            (np.arange(self.depth)[:, None] * self.width + h).reshape(-1),
            np.broadcast_to(np.where(valid, w, np.float32(0.0)),
                            h.shape).reshape(-1))
        dev = self.device
        self.table, self.hh_ids, self.hh_est = _update(
            self.table, self._a, self._b, self.hh_ids,
            torch.as_tensor(ids, device=dev),
            torch.as_tensor(cells, device=dev),
            torch.as_tensor(vals, device=dev), counts,
            float(np.float32(decay)))
        self.n_observed = self.n_observed * decay + float(w.sum())

    def query(self, ids: np.ndarray) -> np.ndarray:
        """Conservative count estimates for ``ids`` (0 for id < 0)."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if ids.size == 0:
            return np.zeros(0, np.float32)
        return _query(self.table, self._a, self._b,
                      torch.as_tensor(ids, device=self.device)).cpu().numpy()

    def heavy_hitters(self) -> "tuple[np.ndarray, np.ndarray]":
        """(ids, estimates) of the current top-k, highest first."""
        ids = self.hh_ids.cpu().numpy()
        est = self.hh_est.cpu().numpy()
        keep = ids >= 0
        return ids[keep], est[keep]

    def reset(self) -> None:
        self.table = torch.zeros_like(self.table)
        self.hh_ids = torch.full_like(self.hh_ids, -1)
        self.hh_est = torch.zeros_like(self.hh_est)
        self.n_observed = 0.0
