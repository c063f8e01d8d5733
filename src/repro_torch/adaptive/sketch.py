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

Hashing is multiply-shift over uint32 (width a power of two).  Ids are
read as the reference holds them, in JAX's default 32-bit integers: an
id's low 32 bits as an int32 give its validity and its hash input, so an
id in [2**31, 2**32) is invalid (hashed as 0 with weight 0, never a heavy
hitter) and 2**32 + 3 counts as 3; ``n_observed`` still adds every
weight, as the reference's does.

An update is ``kernels.ops.count_min_update_op``: on the card one launch
of ``csrc/count_min.cu`` (the reference's jitted ``_update``: the decay,
the hash, each cell's adds in batch order, the heavy-hitter re-rank), its
batch passed in the launch's parameters (up to 256 ids) or by one
asynchronous copy from pinned memory; on the CPU the plain version, its
adds planned on the host in batch order.  Updates replace the table and
the heavy hitters, never write them, so a reader holding a table sees one
consistent state.

On the card the sketch owns one CUDA stream, and every update and every
read (``query``, ``heavy_hitters``, the estimator's snapshot query) runs
on it, so successive updates from any threads stay in the order they were
made, whatever stream the caller has current, and reads come after them.
An update never waits for the card: it allocates, launches and returns.
The ``table`` / ``hh_ids`` / ``hh_est`` attributes make the caller's
current stream wait for the sketch's stream (on the card, not the host)
before handing the tensor out.  Batches are padded to the next power of
two (id -1, weight 0), as the reference pads them.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.ref import count_min_hash, count_min_query_ref

__all__ = ["CountMinSketch", "SketchBatch"]


class SketchBatch(NamedTuple):
    """A batch ready for :meth:`CountMinSketch.apply`: ids and weights
    padded to a power of two, the decay of its real size, and its weight
    sum (all host values, made with no state of the sketch)."""
    ids: np.ndarray
    weights: np.ndarray
    decay: float
    weight_sum: float


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
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        with self._on_stream():
            self._a = torch.as_tensor(a.astype(np.int64), device=self.device)
            self._b = torch.as_tensor(b.astype(np.int64), device=self.device)
            self._table = torch.zeros((depth, width), dtype=torch.float32,
                                      device=self.device)
            self._hh_ids = torch.full((topk,), -1, dtype=torch.int32,
                                      device=self.device)
            self._hh_est = torch.zeros((topk,), dtype=torch.float32,
                                       device=self.device)
        self.n_observed = 0.0      # decayed total weight in the table

    def _on_stream(self):
        """The sketch's stream made current (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _handed_out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` for a reader on the caller's current stream: that stream
        waits for the sketch's (an event on the card, no host wait), and
        the allocator keeps ``t``'s memory until the reader's work ran."""
        if self._stream is not None:
            cur = torch.cuda.current_stream(self.device)
            if cur != self._stream:
                cur.wait_stream(self._stream)
                t.record_stream(cur)
        return t

    @property
    def table(self) -> torch.Tensor:
        return self._handed_out(self._table)

    @property
    def hh_ids(self) -> torch.Tensor:
        return self._handed_out(self._hh_ids)

    @property
    def hh_est(self) -> torch.Tensor:
        return self._handed_out(self._hh_est)

    def snapshot(self) -> torch.Tensor:
        """The current table, for :meth:`query`'s ``table`` later (updates
        replace it, never write it)."""
        return self._table

    def columns(self, ids: np.ndarray) -> np.ndarray:
        """(depth, m) hash columns of ``ids`` (for tests and tools)."""
        with self._on_stream():
            t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
            return count_min_hash(t, self._a, self._b,
                                  self.width).cpu().numpy()

    def prepare(self, ids: np.ndarray,
                weights: Optional[np.ndarray] = None
                ) -> Optional[SketchBatch]:
        """A batch of observed entity ids, ready for :meth:`apply`; None for
        an empty one."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if ids.size == 0:
            return None
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
        return SketchBatch(ids, w, decay, float(w.sum()))

    def apply(self, batch: Optional[SketchBatch]) -> None:
        """Fold a :meth:`prepare`d batch in: one ``count_min_update_op`` on
        the sketch's stream."""
        if batch is None:
            return
        with self._on_stream():
            self._table, self._hh_ids, self._hh_est = ops.count_min_update_op(
                self._table, self._a, self._b, self._hh_ids, batch.ids,
                batch.weights, float(np.float32(batch.decay)))
        self.n_observed = self.n_observed * batch.decay + batch.weight_sum

    def update(self, ids: np.ndarray, weights: Optional[np.ndarray] = None):
        """Fold a batch of observed entity ids into the sketch."""
        self.apply(self.prepare(ids, weights))

    def query(self, ids, *, table: Optional[torch.Tensor] = None
              ) -> np.ndarray:
        """Conservative count estimates for ``ids`` (0 for an invalid id),
        from the current table or from ``table``, one :meth:`snapshot` of
        it; ``ids`` a host array or an int64 tensor on the sketch's
        device."""
        if not torch.is_tensor(ids):
            ids = np.asarray(ids, dtype=np.int64).ravel()
        if len(ids) == 0:
            return np.zeros(0, np.float32)
        with self._on_stream():
            t = torch.as_tensor(ids, device=self.device)
            return count_min_query_ref(
                self._table if table is None else table, self._a, self._b,
                t).cpu().numpy()

    def heavy_hitters(self) -> "tuple[np.ndarray, np.ndarray]":
        """(ids, estimates) of the current top-k, highest first."""
        with self._on_stream():
            ids = self._hh_ids.cpu().numpy()
            est = self._hh_est.cpu().numpy()
        keep = ids >= 0
        return ids[keep], est[keep]

    def reset(self) -> None:
        with self._on_stream():
            self._table = torch.zeros_like(self._table)
            self._hh_ids = torch.full_like(self._hh_ids, -1)
            self._hh_est = torch.zeros_like(self._hh_est)
        self.n_observed = 0.0
