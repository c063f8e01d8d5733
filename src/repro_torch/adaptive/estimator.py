"""Online likelihood estimation + drift detection from serving traffic.

Port of ``repro/adaptive/estimator.py``.  The sketch lives on an explicit
device (the card unless ``device="cpu"``), and :meth:`drift` queries all
``n`` entity ids there; the exact mode (``width=None``) keeps host numpy
counts through :func:`repro_torch.core.likelihood.
decayed_empirical_likelihood`, as the reference does.

``OnlineLikelihoodEstimator`` consumes the entity ids a serving engine
returns (its top-1 per query by default — the entity the traffic was
*for*, in the paper's entity-retrieval reading) and maintains:

  * a smoothed, exponentially-decayed likelihood vector over the corpus,
    backed either by a :class:`repro_torch.adaptive.sketch.CountMinSketch`
    (default — O(width) memory, batches with search) or by exact decayed
    counts (``width=None`` — O(N) memory, exact);
  * drift metrics against a *reference* likelihood — the vector the
    current index was (re)boosted with: total variation in [0, 1] and
    KL divergence in bits.

The maintenance scheduler polls :meth:`drift` and, past a threshold,
feeds :meth:`likelihood` into ``reboost`` and calls
:meth:`set_reference` so drift measures distance from the *deployed*
tree again.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.adaptive.sketch import CountMinSketch
from repro_torch.core.likelihood import decayed_empirical_likelihood

__all__ = ["OnlineLikelihoodEstimator"]


class OnlineLikelihoodEstimator:
    """Turns returned entity ids into a likelihood estimate + drift.

    ``halflife`` (observations) controls how fast old traffic fades;
    ``smoothing`` is the Laplace term shared with
    :func:`repro_torch.core.likelihood.empirical_likelihood`.  Thread-safe:
    the engine worker calls :meth:`observe` while a maintenance thread
    calls :meth:`drift`/:meth:`likelihood`.  ``device`` places the sketch
    (the card unless ``device="cpu"``).
    """

    def __init__(
        self,
        n_entities: int,
        *,
        reference: Optional[np.ndarray] = None,
        halflife: float = 4096.0,
        smoothing: Optional[float] = None,
        width: Optional[int] = 4096,
        depth: int = 4,
        topk: int = 64,
        seed: int = 0,
        device=None,
    ):
        if n_entities <= 0:
            raise ValueError("n_entities must be positive")
        self.n = int(n_entities)
        self.halflife = float(halflife)
        if smoothing is None:
            # total pseudo-mass ~= 10% of the steady decayed observation
            # mass (halflife/ln2), spread over all entities.  A fixed
            # per-entity constant looks harmless but at n >> mass it
            # swamps the estimate: likelihood() goes ~uniform, reboosts
            # boost nothing, and a reference stored from it never matches
            # the raw-count drift again.
            steady = (self.halflife / np.log(2.0)
                      if np.isfinite(self.halflife) else self.n)
            smoothing = 0.1 * steady / self.n
        self.smoothing = float(smoothing)
        self._lock = threading.Lock()
        self.sketch: Optional[CountMinSketch] = None
        self._counts: Optional[np.ndarray] = None
        if width is None:
            self._counts = np.zeros(self.n, np.float64)
        else:
            self.sketch = CountMinSketch(
                width=width, depth=depth, topk=topk,
                halflife=halflife, seed=seed, device=device)
        self._all_ids = self._ids_of(self.n)
        self.set_reference(reference)
        self.n_total = 0           # raw (undecayed) observation count

    # ------------------------------------------------------------------
    def set_reference(self, p: Optional[np.ndarray]) -> None:
        """Likelihood the deployed index was (re)boosted with."""
        if p is None:
            ref = np.full(self.n, 1.0 / self.n)
        else:
            ref = np.asarray(p, np.float64)
            if ref.shape[0] != self.n:
                raise ValueError(
                    f"reference has {ref.shape[0]} entries for "
                    f"{self.n} entities")
            # tiny floor only (not the full Laplace term, which would
            # visibly distort an already-normalized vector): keeps the KL
            # finite when the reference has exact zeros
            ref = np.maximum(ref, 0.0) + 1e-12
            ref = ref / ref.sum()
        with self._lock:
            self._ref = ref

    def resize(self, n_entities: int) -> None:
        """Grow to a larger corpus after ``add_entities``.

        New entities start with zero observed and (near-)zero reference
        mass, so traffic on them reads as drift — which it is.  Ids at or
        beyond the old ``n`` were dropped by :meth:`observe` until the
        resize (the maintenance scheduler resizes before every reboost).
        Shrinking is rejected: deletes keep ids stable, they don't
        compact the id space.
        """
        n_new = int(n_entities)
        if n_new < self.n:
            raise ValueError(
                f"cannot shrink estimator from {self.n} to {n_new}")
        if n_new == self.n:
            return
        with self._lock:
            extra = n_new - self.n
            if self._counts is not None:
                self._counts = np.concatenate(
                    [self._counts, np.zeros(extra)])
            ref = np.concatenate([self._ref, np.full(extra, 1e-12)])
            self._ref = ref / ref.sum()
            self.n = n_new
            self._all_ids = self._ids_of(self.n)

    def _ids_of(self, n: int):
        """Every entity id, where :meth:`drift` queries them: on the
        sketch's device (none in the exact mode)."""
        if self.sketch is None:
            return None
        with self.sketch._on_stream():
            return torch.arange(n, dtype=torch.int64,
                                device=self.sketch.device)

    def observe(self, ids: np.ndarray,
                weights: Optional[np.ndarray] = None) -> int:
        """Fold a batch of returned entity ids in; returns #valid ids."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        keep = (ids >= 0) & (ids < self.n)
        ids = ids[keep]
        if weights is not None:
            weights = np.asarray(weights, np.float64).ravel()[keep]
        if ids.size == 0:
            return 0
        # the host's share (padding, the decay) before the lock; under it
        # only the update itself, one launch on the card
        batch = (self.sketch.prepare(ids, weights)
                 if self.sketch is not None else None)
        with self._lock:
            if self.sketch is not None:
                self.sketch.apply(batch)
            else:
                _, self._counts = decayed_empirical_likelihood(
                    ids, self.n, self.halflife, self.smoothing,
                    prior_counts=self._counts, return_counts=True)
            self.n_total += int(ids.size)
        return int(ids.size)

    @property
    def n_observed(self) -> float:
        """Decayed observation mass currently in the estimate."""
        if self.sketch is not None:
            return float(self.sketch.n_observed)
        return float(self._counts.sum())

    def likelihood(self) -> np.ndarray:
        """Smoothed decayed likelihood over all ``n`` entities."""
        counts = self._raw_counts()
        p = counts + self.smoothing
        return p / p.sum()

    def current_raw(self) -> np.ndarray:
        """Raw normalized decayed counts — the drift gauge's view.

        Use this (not the Laplace-smoothed :meth:`likelihood`) as the new
        reference when re-anchoring after maintenance: :meth:`drift`
        compares raw counts, and at low observation mass the smoothing
        blend would read as residual drift forever.
        """
        counts = self._raw_counts()
        s = counts.sum()
        return counts / s if s > 0 else np.full(self.n, 1.0 / self.n)

    def heavy_hitters(self) -> tuple[np.ndarray, np.ndarray]:
        """Current head of the traffic (ids, decayed count estimates)."""
        if self.sketch is not None:
            return self.sketch.heavy_hitters()
        order = np.argsort(self._counts)[::-1][:64]
        keep = self._counts[order] > 0
        return order[keep], self._counts[order][keep]

    def _counts_and_ref(self) -> tuple[np.ndarray, np.ndarray]:
        """Decayed counts + reference captured under ONE lock hold.

        The lock only covers the snapshot: the sketch's table is replaced
        (never mutated) by updates, so the O(n) full-corpus query runs
        outside the lock (on the sketch's device and stream, after every
        update made before the snapshot) and the serving worker's
        observe() is never blocked behind it.
        """
        with self._lock:
            ref = self._ref
            ids = self._all_ids
            if self.sketch is None:
                return self._counts.copy(), ref
            table = self.sketch.snapshot()
        counts = self.sketch.query(ids, table=table).astype(np.float64)
        return counts, ref

    def _raw_counts(self) -> np.ndarray:
        return self._counts_and_ref()[0]

    def drift(self, head: int = 256) -> dict:
        """Distance of current traffic from the deployed reference.

        Computed on *raw* normalized decayed counts (not the smoothed
        likelihood — Laplace pseudo-mass would shrink every signal toward
        uniform by a mass-dependent factor) over the union of both sides'
        top-``head`` entities, with everything else lumped into one tail
        bucket: per-entity tail counts are 0/1 sampling noise, but the
        *head moving* is exactly the drift a reboost can exploit.

        ``tv``  — head-lumped total variation in raw-traffic units [0, 1];
        ``kl``  — head-lumped KL divergence in bits (floored, finite);
        ``n_observed`` — decayed observation mass behind the estimate
        (gate maintenance on it: drift of a fresh estimator is noise).
        """
        # counts and reference snapshotted under ONE lock acquisition
        # (_counts_and_ref): a concurrent resize() grows both, and mixing
        # lengths across the boundary would index out of range
        counts, ref = self._counts_and_ref()
        mass = float(counts.sum())
        if mass <= 0:
            return {"tv": 0.0, "kl": 0.0, "n_observed": 0.0}
        p = counts / mass
        k = min(head, self.n)
        hp = np.argpartition(p, -k)[-k:]
        hr = np.argpartition(ref, -k)[-k:]
        idx = np.union1d(hp, hr)
        ph, rh = p[idx], ref[idx]
        pt, rt = max(1.0 - ph.sum(), 0.0), max(1.0 - rh.sum(), 0.0)
        tv = 0.5 * float(np.abs(ph - rh).sum() + abs(pt - rt))
        eps = 1e-12
        nz = ph > eps
        kl = float((ph[nz] * np.log2(ph[nz]
                                     / np.maximum(rh[nz], eps))).sum())
        if pt > eps:
            kl += float(pt * np.log2(pt / max(rt, eps)))
        return {"tv": tv, "kl": kl, "n_observed": self.n_observed}
