"""Drift-triggered background index maintenance.

Port of ``repro/adaptive/maintenance.py``: host code, as in the
reference, chaining the port's ``reboost`` / ``rebalance`` and a
backend's ``apply_updates``.

``MaintenanceScheduler`` closes the serving -> index loop: a daemon
thread polls the estimator's drift against the likelihood the deployed
index was boosted with and, past a threshold, runs the incremental
maintenance chain *off* the serving path:

    p_new = estimator.likelihood()
    index.reboost(p_new)          # top-level re-split, subtrees reused
    index.rebalance()             # drifted-bucket Lloyd step     
    engine.apply_updates(target)  # republish under the backend's lock:
                                  # pops the index's delta manifest so
                                  # only dirty buckets ship (also
                                  # invalidates the result cache)
    estimator.set_reference(p_new)

The serving loop is never blocked: ``reboost`` builds off to the side
and swaps a reference; ``apply_updates`` re-places device arrays under
the existing ``ShardedSearchBackend`` lock (in-flight batches finish on
the old arrays).  For engines serving a host-resident index,
``HostIndexBackend`` provides the same ``apply_updates`` surface as the
sharded backend so cache invalidation and republish work identically.

**Fleet-leader mode.** ``engine`` may be a
:class:`repro_torch.serve.fleet.CellRouter` instead of a single engine: the
scheduler then IS the fleet's maintenance leader.  The estimator is
shared by every cell (it is internally locked), so there is exactly one
drift decision for the whole fleet; the router's ``apply_updates`` pops
the index's delta manifest exactly once and fans the same manifest out
to every cell with a rolling drain (one cell republishes while its
siblings absorb the traffic).  Nothing in the scheduler changes —
running one scheduler per cell would instead race N ``pop_delta()``
calls against each other and republish N different manifests.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.analysis.annotations import guarded_by
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["HostIndexBackend", "MaintenanceScheduler"]


class HostIndexBackend:
    """``queries (B, d) -> (dists, ids)`` over an in-process index.

    The engine-facing twin of ``ShardedSearchBackend`` for single-host
    serving: a callable with ``apply_updates`` so the engine's cache
    invalidation and the scheduler's republish path work unchanged.
    ``index`` is anything with ``.search(queries, k, **kw)`` returning
    ``(dists, ids, work)`` — ``SearchIndex`` or ``TwoLevelIndex``.
    """

    def __init__(self, index, *, k: int = 10, **search_kw):
        self.index = index
        self.k = k
        self.search_kw = search_kw
        self.last_delta = None

    def __call__(self, queries):
        idx = self.index           # snapshot: apply_updates swaps the ref
        d, i, _ = idx.search(np.asarray(queries), self.k, **self.search_kw)
        return np.asarray(d), np.asarray(i)

    def apply_updates(self, index, delta=None, **kw) -> dict:
        """Swap the served index reference.

        A host-resident index republishes by reference, so a delta
        manifest costs nothing to "apply" — it is accepted (and recorded
        as ``last_delta``) so the engine/scheduler delta path works
        identically against host and sharded backends, and returns the
        same stats shape (zero bytes: nothing crossed a device boundary).
        """
        self.index = index
        self.last_delta = delta
        return {"mode": "swap", "bytes": 0, "full_bytes": 0,
                "reason": None}


class MaintenanceScheduler:
    """Background drift watcher driving reboost/rebalance/republish.

    Parameters
    ----------
    estimator : OnlineLikelihoodEstimator (drift + likelihood source)
    index     : object with ``reboost(p)`` — ``SearchIndex`` or
                ``TwoLevelIndex``; ``rebalance()`` is chained when present
    engine    : optional ``ServingEngine`` — republished to via
                ``apply_updates`` (which also invalidates its cache).
                Passing a ``repro_torch.serve.fleet.CellRouter`` here makes
                this scheduler the fleet's maintenance *leader*: one
                drift decision (shared estimator), one ``pop_delta()``,
                the same manifest rolled across every cell
    cache     : optional cache to invalidate when no engine is given
    publish_target : maps the index to the ``apply_updates`` target
                (identity by default: a ``TwoLevelIndex`` is what
                ``ShardedSearchBackend`` re-places)
    interval_s : poll period; ``None`` disables the thread (tests drive
                :meth:`check_now` directly)
    drift_threshold : trigger level on ``metric`` ("tv" or "kl")
    min_observations : decayed observation mass required before a trigger
                (drift of an empty estimator is noise)
    rebalance : chain ``index.rebalance()`` after reboost; "auto" enables
                it only for two-level indexes (a single-tree rebalance is
                a full rebuild — exactly what reboost avoids)
    """

    def __init__(
        self,
        estimator,
        index,
        *,
        engine=None,
        cache=None,
        publish_target: Optional[Callable[[Any], Any]] = None,
        interval_s: Optional[float] = 1.0,
        drift_threshold: float = 0.3,
        metric: str = "tv",
        min_observations: float = 256.0,
        cooldown_observations: Optional[float] = None,
        rebalance: "bool | str" = "auto",
        reboost_kw: Optional[dict] = None,
        on_event: Optional[Callable[[dict], None]] = None,
    ):
        if metric not in ("tv", "kl"):
            raise ValueError(f"metric must be 'tv' or 'kl', got {metric!r}")
        self.estimator = estimator
        self.index = index
        self.engine = engine
        self.cache = cache
        self.publish_target = publish_target or (lambda idx: idx)
        self.interval = interval_s
        self.drift_threshold = drift_threshold
        self.metric = metric
        self.min_observations = min_observations
        # debounce: require this much fresh traffic between triggers so a
        # noisy drift estimate can't thrash reboosts back-to-back
        self.cooldown_observations = (
            min_observations if cooldown_observations is None
            else cooldown_observations)
        self._last_trigger_n = -float("inf")
        if rebalance == "auto":
            rebalance = (getattr(index, "two_level", None) is not None
                         or hasattr(index, "bucket_ids"))
        self.rebalance = bool(rebalance)
        self.reboost_kw = reboost_kw or {}
        self.on_event = on_event
        self.events: list[dict] = []
        self.last_error: Optional[BaseException] = None
        # scheduler telemetry: the live drift reading and estimator mass
        # become gauges (polled by dashboards between triggers), trigger
        # outcomes become a counter + duration histogram
        self.metrics = MetricsRegistry()
        self._g_drift = self.metrics.gauge("drift")
        self._g_mass = self.metrics.gauge("estimator_mass")
        self._c_reboosts = self.metrics.counter("reboosts")
        self._h_maint = self.metrics.histogram("maintenance_ms",
                                               lo=1e-2, hi=1e7)
        # serializes triggers: the daemon loop and direct check_now()
        # callers race on the cooldown watermark and the event log
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if interval_s is not None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    @property
    def n_reboosts(self) -> int:
        return self._c_reboosts.value

    def check_now(self) -> Optional[dict]:
        """One synchronous drift check; returns the event dict if it
        triggered maintenance, else None.  Serialized under the
        scheduler lock — a manual call racing the daemon loop must not
        double-trigger inside one cooldown window."""
        with self._lock:
            d = self.estimator.drift()
            self._g_drift.set(float(d[self.metric]))
            self._g_mass.set(float(d["n_observed"]))
            if d["n_observed"] < self.min_observations:
                return None
            n_total = getattr(self.estimator, "n_total", 0)
            if n_total - self._last_trigger_n < self.cooldown_observations:
                return None
            if d[self.metric] <= self.drift_threshold:
                return None
            self._last_trigger_n = n_total
            return self._trigger(d)

    @guarded_by("_lock")
    def _trigger(self, drift: dict) -> dict:
        tracer = get_tracer()
        with tracer.span("maint.trigger",
                         drift=round(float(drift[self.metric]), 4)):
            t0 = time.perf_counter()
            # the corpus may have grown since the estimator was sized
            # (add_entities keeps ids stable and appends) — grow with it
            # so the likelihood vector matches the index
            n_idx = getattr(self.index, "n", None)
            if n_idx is None and hasattr(self.index, "db"):
                n_idx = int(self.index.db.shape[0])
            if (n_idx and hasattr(self.estimator, "resize")
                    and n_idx > getattr(self.estimator, "n", n_idx)):
                self.estimator.resize(n_idx)
            p_new = self.estimator.likelihood()
            with tracer.span("maint.reboost"):
                reboost_stats = self.index.reboost(p_new, **self.reboost_kw)
            rebalance_stats = None
            if self.rebalance and hasattr(self.index, "rebalance"):
                with tracer.span("maint.rebalance"):
                    rebalance_stats = self.index.rebalance()
            republish = None
            if self.engine is not None:
                # the engine pops the target's delta manifest
                # (delta="auto") and the backend ships only the dirty
                # slices — a reboost that re-split every bucket
                # degenerates to a full re-place via the backend's size
                # threshold, a localized rebalance ships a handful of
                # bucket slabs.  Fleet routers / cells emit their own
                # maint.fanout / republish spans underneath this one.
                republish = self.engine.apply_updates(
                    self.publish_target(self.index))
            elif self.cache is not None:
                self.cache.invalidate_all()
            # re-anchor on the RAW estimate (what drift() compares
            # against); the smoothed p_new fed to reboost would read as
            # residual drift at low observation mass
            if hasattr(self.estimator, "current_raw"):
                self.estimator.set_reference(self.estimator.current_raw())
            else:
                self.estimator.set_reference(p_new)
            duration_s = time.perf_counter() - t0
            event = {
                "drift": drift,
                "reboost": reboost_stats,
                "rebalance": rebalance_stats,
                "republish": republish,
                "duration_s": duration_s,
                "t": time.time(),
            }
            self.events.append(event)
            self._c_reboosts.inc()
            self._h_maint.observe(duration_s * 1e3)
        if self.on_event is not None:
            self.on_event(event)
        return event

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check_now()
            except Exception as e:       # keep the daemon alive; surface
                with self._lock:         # the error through stats/tests
                    self.last_error = e

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
