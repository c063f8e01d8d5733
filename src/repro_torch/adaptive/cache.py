"""Likelihood-aware exact-match result cache (TinyLFU-style admission).

Port of ``repro/adaptive/cache.py``: host numpy, as in the reference.
``key_for`` gives the reference's bytes, because fleet affinity routing
(``repro_torch.serve.fleet.query_key``) and the cache share that digest.

Skewed traffic means the same head queries recur; an exact-match cache in
front of the engine turns those into O(1) hits.  A plain LRU is easily
flushed by the long tail, so admission is *frequency-gated* (TinyLFU): a
small host-side count-min sketch estimates each key's recent popularity,
and a new result only displaces the LRU victim when it has been seen at
least as often — one-off queries never evict head entries.

Staleness contract: results are only valid for one index *generation*.
``invalidate_all()`` (wired into ``ServingCell.apply_updates``) clears
the cache and bumps the generation; an ``offer`` carrying a stale
generation token is dropped, closing the race where a search computed
against the old index finishes after the swap and would otherwise
re-insert a stale result.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

__all__ = ["FrequencyAdmissionCache"]


class _HostSketch:
    """Tiny host-side CMS with periodic halving (TinyLFU aging)."""

    def __init__(self, width: int, depth: int, reset_every: int, seed: int):
        rng = np.random.default_rng(seed)
        self.width = width
        self.table = np.zeros((depth, width), np.float32)
        self._salt = rng.integers(1, 2**63 - 1, size=depth).astype(np.uint64)
        self._ops = 0
        self._reset_every = reset_every

    def _cols(self, h: int) -> np.ndarray:
        h64 = np.uint64(h)                 # uint64 wraparound arithmetic
        mix = self._salt * h64 + (self._salt >> np.uint64(7))
        return (mix % np.uint64(self.width)).astype(np.int64)

    def bump(self, h: int) -> None:
        self.table[np.arange(self.table.shape[0]), self._cols(h)] += 1.0
        self._ops += 1
        if self._ops >= self._reset_every:
            self.table *= 0.5
            self._ops = 0

    def estimate(self, h: int) -> float:
        return float(
            self.table[np.arange(self.table.shape[0]), self._cols(h)].min())


class FrequencyAdmissionCache:
    """Exact-match query -> result cache with frequency-gated admission."""

    def __init__(self, capacity: int = 1024, *, sketch_width: int = 8192,
                 sketch_depth: int = 4, seed: int = 0):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._lru: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self._sketch = _HostSketch(sketch_width, sketch_depth,
                                   reset_every=8 * capacity, seed=seed)
        self.generation = 0
        self.hits = 0
        self.misses = 0
        self.admitted = 0
        self.rejected = 0

    # ------------------------------------------------------------------
    @staticmethod
    def key_for(query: np.ndarray, extra: bytes = b"") -> bytes:
        """Stable key over the query's bytes, dtype and shape.

        ``extra`` folds request options that change the answer — filter
        digest, search mode, hybrid alpha — into the key, so a filtered
        result can never satisfy an unfiltered request (or vice versa)
        for the same query vector."""
        q = np.ascontiguousarray(query)
        h = hashlib.blake2b(digest_size=16)
        h.update(str(q.dtype).encode())
        h.update(str(q.shape).encode())
        h.update(q.tobytes())
        if extra:
            h.update(extra)
        return h.digest()

    @staticmethod
    def _int_of(key: bytes) -> int:
        return int.from_bytes(key[:8], "little", signed=False)

    def get(self, key: bytes):
        """Cached result or None; every lookup also trains the sketch."""
        h = self._int_of(key)
        with self._lock:
            self._sketch.bump(h)
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return hit[1]
            self.misses += 1
            return None

    def offer(self, key: bytes, value, generation: Optional[int] = None
              ) -> bool:
        """Insert under frequency admission; stale generations dropped."""
        h = self._int_of(key)
        with self._lock:
            if generation is not None and generation != self.generation:
                return False                     # computed pre-invalidation
            if key in self._lru:
                self._lru[key] = (h, value)
                self._lru.move_to_end(key)
                return True
            if len(self._lru) >= self.capacity:
                victim_key, (victim_h, _) = next(iter(self._lru.items()))
                if self._sketch.estimate(h) < \
                        self._sketch.estimate(victim_h):
                    self.rejected += 1
                    return False
                self._lru.pop(victim_key)
            self._lru[key] = (h, value)
            self.admitted += 1
            return True

    def invalidate_all(self) -> None:
        """Drop every entry and bump the generation (index mutated)."""
        with self._lock:
            self._lru.clear()
            self.generation += 1

    def __len__(self) -> int:
        return len(self._lru)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses,
                "admitted": self.admitted, "rejected": self.rejected,
                "size": len(self._lru), "generation": self.generation,
            }
