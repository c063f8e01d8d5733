"""Multi-cell fleet tier: routed admission, cross-cell hedging, fan-out.

Port of ``repro/serve/fleet.py``, host code as in the reference.  One
:class:`repro_torch.serve.cell.ServingCell` serves one backend placement;
fleet-scale traffic needs N of them with a router in front.
:class:`CellRouter` provides:

  * **admission control** — a cell whose queue is deeper than
    ``max_queue_depth`` is not dispatched to; when every live cell is
    saturated the request is shed with :class:`FleetOverloadError`
    (``retriable = True``: the condition is load, not a broken fleet);
  * **cache-affinity + load-aware dispatch** — the preferred cell is
    chosen by rendezvous (highest-random-weight) hashing of a stable
    query key, so a recurring head query always lands on the same cell
    and that cell's TinyLFU cache sees a coherent head; when the
    preferred cell is saturated the request spills to the least-loaded
    open cell (counted in ``rerouted``).  When a cell goes down only
    its keys remap;
  * **cross-cell hedging** — after ``hedge_ms`` without a result the
    request is duplicated onto a *different* cell (``hedge_cell``);
    first responder wins, the loser is cancelled;
  * **fail-fast rerouting** — a :class:`repro_torch.serve.cell.
    CellFailure` marks the cell down and re-dispatches the request to a
    surviving cell at once (``rerouted``); no request is lost to a
    single-cell failure;
  * **leader fan-out** — :meth:`CellRouter.apply_updates` pops the
    target's :class:`repro_torch.core.delta.DeltaManifest` **once** and
    applies that same manifest to every cell with a *rolling drain*: one
    cell at a time stops admitting, drains its queue, republishes and
    rejoins while the others absorb its traffic.  A
    ``MaintenanceScheduler`` pointed at the router (one shared
    estimator, one drift decision) is the fleet's maintenance leader.

A cell serves either the pre-manifest or the post-manifest index
(manifest application is atomic per cell under its backend's lock,
idempotent and superset-safe), never a torn mix, and every cell's result
cache is invalidated at its own swap.

In the port one process is one rank: a router reaches the cells whose
root is its own process — cells on one card in one process
(:func:`build_fleet`), or a cell over ranks built on that cell's root by
``ServingCell.sharded(mesh=...)`` and passed to :class:`CellRouter`.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.adaptive.cache import FrequencyAdmissionCache
from repro_torch.analysis.annotations import guarded_by
from repro_torch.core.delta import merge_manifests
from repro_torch.obs.metrics import Histogram, MetricsRegistry, merge_snapshots
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.cell import (
    CellFailure,
    EngineStats,
    ServingCell,
    _opts_extra,
)

__all__ = ["CellRouter", "FleetOverloadError", "build_fleet", "query_key"]


class FleetOverloadError(RuntimeError):
    """Every live cell is at ``max_queue_depth`` (or no cell is live):
    the request was shed, not enqueued.  ``retriable`` signals the
    client to back off and retry — shedding is a load condition, not a
    broken fleet."""

    retriable = True


def _mix64(x: int) -> int:
    """splitmix64 finalizer: cheap, well-distributed 64-bit mixing for
    rendezvous scores."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def query_key(query: np.ndarray) -> int:
    """Stable 64-bit routing key over the query's bytes/dtype/shape —
    the same digest the result cache keys on, so affinity routing and
    cache keying agree byte-for-byte."""
    return int.from_bytes(
        FrequencyAdmissionCache.key_for(query)[:8], "little", signed=False)


def _salt_of(name: str) -> int:
    import hashlib

    return int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=8).digest(), "little")


class CellRouter:
    """Routes single-query requests across a fleet of serving cells."""

    def __init__(self, cells: Sequence[ServingCell], *,
                 max_queue_depth: int = 64,
                 hedge_ms: Optional[float] = None):
        """``hedge_ms=None`` disables cross-cell hedging (a request
        waits on its primary until ``timeout``); a float arms it."""
        cells = list(cells)
        if not cells:
            raise ValueError("CellRouter needs at least one cell")
        names = [c.name for c in cells]
        if len(set(names)) != len(names):
            raise ValueError(f"cell names must be unique, got {names}")
        self.cells = cells
        self._by_name = {c.name: c for c in cells}
        self._salts = {c.name: _salt_of(c.name) for c in cells}
        self.max_queue_depth = max_queue_depth
        self.hedge_ms = hedge_ms
        # one lock for all routing state: caller threads (search),
        # the leader (apply_updates drain marks), and stats() readers
        self._lock = threading.Lock()
        self._down: dict[str, BaseException] = {}
        self._draining: set[str] = set()
        # per-down-cell record of fan-outs it missed: a list of
        # DeltaManifest (replayable) or None (that fan-out had no
        # manifest — only a full re-place can cover it); consumed by
        # revive()'s replay together with the last published target
        self._missed: dict[str, list] = {}
        self._last_publish: Optional[tuple] = None
        # routing telemetry lives in a fixed-footprint registry: the
        # route-latency histogram replaces the old unbounded list
        self.metrics = MetricsRegistry()
        self._h_route = self.metrics.histogram("route_ms")
        self._c_shed = self.metrics.counter("shed")
        self._c_rerouted = self.metrics.counter("rerouted")
        self._c_hedge_cell = self.metrics.counter("hedge_cell")
        self._c_cancelled = self.metrics.counter("cancelled")
        self._c_resyncs = self.metrics.counter("resyncs")

    # -- registry-backed compatibility counters ------------------------
    @property
    def shed(self) -> int:
        return self._c_shed.value

    @property
    def rerouted(self) -> int:
        return self._c_rerouted.value

    @property
    def hedge_cell(self) -> int:
        return self._c_hedge_cell.value

    @property
    def n_cancelled(self) -> int:
        return self._c_cancelled.value

    @property
    def n_resyncs(self) -> int:
        return self._c_resyncs.value

    # -- routing policy (all under self._lock) -------------------------
    @guarded_by("_lock")
    def _routable(self, exclude=()) -> list:
        """Live cells preferred in non-draining order: draining cells
        are only routed to when nothing else is left (a 1-cell fleet
        must keep admitting through its own maintenance)."""
        alive = [c for c in self.cells
                 if c.name not in self._down and c.name not in exclude]
        ready = [c for c in alive if c.name not in self._draining]
        return ready or alive

    def _rendezvous(self, key: int, cells: list) -> ServingCell:
        """Highest-random-weight choice: stable per key, minimal remap
        when the candidate set changes (only the lost cell's keys
        move)."""
        return max(cells, key=lambda c: _mix64(key ^ self._salts[c.name]))

    @guarded_by("_lock")
    def _admit(self, key: int) -> ServingCell:
        """Admission decision for one request: preferred-by-affinity,
        spill to least-loaded, shed when saturated."""
        open_cells = self._routable()
        if not open_cells:
            self._c_shed.inc()
            raise FleetOverloadError("no live cells in the fleet")
        pref = self._rendezvous(key, open_cells)
        if pref.depth() < self.max_queue_depth:
            return pref
        alt = min(open_cells, key=lambda c: c.depth())
        if alt.depth() < self.max_queue_depth:
            self._c_rerouted.inc()
            return alt
        self._c_shed.inc()
        raise FleetOverloadError(
            f"all {len(open_cells)} live cells at "
            f"max_queue_depth={self.max_queue_depth}")

    @guarded_by("_lock")
    def _pick_open(self, key: int, exclude=()) -> Optional[ServingCell]:
        """Best alternative cell for a hedge or a failure re-dispatch;
        None when no un-tried open cell remains."""
        open_cells = [c for c in self._routable(exclude)
                      if c.depth() < self.max_queue_depth]
        if not open_cells:
            return None
        return self._rendezvous(key, open_cells)

    @guarded_by("_lock")
    def _mark_down(self, name: str, error: BaseException) -> None:
        if name in self._by_name:
            self._down[name] = error

    def preferred_cell(self, query: np.ndarray) -> Optional[ServingCell]:
        """The cell affinity routing would pick right now (load
        ignored) — what a client cache-warms against, and what tests
        pin routing expectations on."""
        key = query_key(query)
        with self._lock:
            open_cells = self._routable()
        if not open_cells:
            return None
        return self._rendezvous(key, open_cells)

    def down_cells(self) -> dict:
        """name -> error for every cell currently marked down."""
        with self._lock:
            return dict(self._down)

    def revive(self, name: str) -> Optional[dict]:
        """Put a repaired cell back into rotation (its keys rendezvous
        back to it; survivors' cache heads are untouched).

        A down cell missed every fan-out since it failed, so before it
        rejoins the router **replays** what it missed against the last
        published target: the missed manifests merged into one covering
        window (:func:`repro_torch.core.delta.merge_manifests` — idempotent,
        superset-safe), or a forced full re-place when any missed
        fan-out had no manifest.  The replay happens while the cell is
        still marked down (no request can reach the stale index); if it
        raises, the cell *stays* down.  Returns the replay's republish
        stats, or None when nothing was missed.
        """
        cell = self._by_name.get(name)
        with self._lock:
            if name not in self._down:
                return None
            missed = self._missed.pop(name, [])
            publish = self._last_publish
        stats = None
        if cell is not None and missed and publish is not None:
            target, kw = publish
            if any(m is None for m in missed):
                manifest = None          # forces a full re-place
            else:
                manifest = merge_manifests(missed)
            try:
                with get_tracer().span("maint.revive", cell=name,
                                       missed=len(missed)):
                    stats = cell.apply_updates(target, delta=manifest, **kw)
            except BaseException:
                with self._lock:     # keep the record for a retry
                    self._missed[name] = missed + self._missed.get(name, [])
                raise
            self._c_resyncs.inc()
        with self._lock:
            self._down.pop(name, None)
        return stats

    # -- request path --------------------------------------------------
    def search(self, query: np.ndarray, timeout: float = 30.0, *,
               filter=None, mode: str = "semantic", alpha: float = 0.5,
               q_terms=None, q_weights=None):
        """Route one query through the fleet; returns ``(dists, ids)``.

        ``filter``/``mode``/``alpha``/``q_terms``/``q_weights`` are the
        filtered + hybrid search options (docs/filtering.md), forwarded
        with every dispatch — primary, hedge, and failure re-dispatch all
        carry the same options, and the per-cell cache key folds them in
        so results from different option sets never alias.  Affinity
        routing stays keyed on the query vector alone: a head query hits
        the same cell whatever it filters by, keeping one cell's cache
        hot for all of that query's variants.

        Raises :class:`FleetOverloadError` when shed at admission,
        :class:`TimeoutError` when no cell answered in ``timeout``
        seconds (all in-flight copies are cancelled), and
        :class:`RuntimeError` when every dispatched cell failed and no
        open cell remains to re-dispatch to.

        The whole routed request runs under a ``route`` span whose
        ``trace_id`` is threaded through every cell dispatch, so the
        per-request ``queue``/``batch``/``dispatch``/``kernel`` spans
        recorded by the worker threads key back to it; the span's
        ``outcome`` attribute ends as ``ok``/``hedged``/``rerouted``/
        ``shed``/``cancelled``.
        """
        tracer = get_tracer()
        key = query_key(query)
        with tracer.span("route") as rsp:
            trace_id = rsp.trace_id
            try:
                with tracer.span("admission"):
                    with self._lock:
                        primary = self._admit(key)
            except FleetOverloadError:
                rsp.set(outcome="shed")
                raise
            rsp.set(cell=primary.name)
            # per-cell exact-match cache, checked against the affinity
            # target: recurring head queries short-circuit here, and the
            # generation token makes a post-swap offer of a pre-swap
            # result impossible (see FrequencyAdmissionCache)
            opt_kw = dict(filter_spec=filter, mode=mode, alpha=alpha,
                          q_terms=q_terms, q_weights=q_weights)
            ckey = cgen = None
            if primary.cache is not None:
                ckey = primary.cache.key_for(
                    query, _opts_extra(filter, mode, alpha))
                cgen = primary.cache.generation
                hit = primary.cache.get(ckey)
                if hit is not None:
                    if primary.estimator is not None:
                        # hits are head traffic: the shared drift
                        # estimator must see them (same contract as
                        # ServingCell.search)
                        try:
                            primary.estimator.observe(
                                np.asarray(hit[1])[:1])
                        except Exception:
                            pass
                    rsp.set(outcome="cache-hit")
                    return hit
            t0 = time.perf_counter()
            deadline = t0 + timeout
            hedge_at = (t0 + self.hedge_ms / 1e3
                        if self.hedge_ms is not None else None)
            cancelled = threading.Event()
            fut = primary.submit(query, cancelled=cancelled,
                                 trace_id=trace_id, **opt_kw)
            tried = {primary.name}
            outstanding = 1
            hedged = rerouted = False
            last_error: Optional[CellFailure] = None
            while True:
                now = time.perf_counter()
                if now >= deadline:
                    # abandon every in-flight copy: the cell workers
                    # drop cancelled requests instead of computing them
                    cancelled.set()
                    self._c_cancelled.inc()
                    rsp.set(outcome="cancelled")
                    tracer.instant("cancel", trace_id=trace_id)
                    raise TimeoutError(
                        f"fleet search timed out after {timeout}s "
                        f"(tried cells: {sorted(tried)})")
                wait_until = deadline
                if hedge_at is not None and hedge_at < wait_until:
                    wait_until = hedge_at
                try:
                    out = fut.get(timeout=max(wait_until - now, 1e-4))
                except queue.Empty:
                    if hedge_at is not None and \
                            time.perf_counter() >= hedge_at:
                        hedge_at = None     # hedge fires at most once
                        with self._lock:
                            alt = self._pick_open(key, exclude=tried)
                        if alt is not None:
                            self._c_hedge_cell.inc()
                            hedged = True
                            tracer.instant("hedge-cell", cell=alt.name,
                                           trace_id=trace_id)
                            # same future, same cancelled flag: first
                            # responder wins, the loser is dropped by
                            # its own cell's worker
                            alt.submit(query, future=fut,
                                       cancelled=cancelled,
                                       trace_id=trace_id, **opt_kw)
                            tried.add(alt.name)
                            outstanding += 1
                    continue
                if isinstance(out, CellFailure):
                    outstanding -= 1
                    last_error = out
                    with self._lock:
                        self._mark_down(out.cell, out.error)
                        alt = self._pick_open(key, exclude=tried)
                    if alt is not None:
                        self._c_rerouted.inc()
                        rerouted = True
                        tracer.instant("reroute", failed=out.cell,
                                       cell=alt.name, trace_id=trace_id)
                        alt.submit(query, future=fut, cancelled=cancelled,
                                   trace_id=trace_id, **opt_kw)
                        tried.add(alt.name)
                        outstanding += 1
                    elif outstanding <= 0:
                        raise RuntimeError(
                            f"every dispatched cell failed "
                            f"(tried: {sorted(tried)})"
                        ) from last_error.error
                    continue
                # success: cancel the hedge loser (if any) and record
                # the end-to-end routed latency
                cancelled.set()
                self._h_route.observe((time.perf_counter() - t0) * 1e3)
                rsp.set(outcome=("hedged" if hedged
                                 else "rerouted" if rerouted else "ok"))
                if primary.cache is not None:
                    primary.cache.offer(ckey, out, generation=cgen)
                return out

    # -- leader fan-out ------------------------------------------------
    def apply_updates(self, target, *, delta="auto",
                      drain_timeout_s: float = 10.0, **kw):
        """Fan one index republish out to every cell, rolling.

        ``delta="auto"`` pops the target's accumulated
        :class:`repro_torch.core.delta.DeltaManifest` exactly **once** and
        hands the same manifest to every cell — the fleet-leader
        contract (one drift decision upstream, one pop here, N
        idempotent applications).  Cells republish one at a time: the
        cell is marked draining (admission prefers its siblings), its
        queue drains (bounded by ``drain_timeout_s``), it applies the
        manifest under its backend's lock, then rejoins.  Down cells
        are skipped (recorded as ``mode="skipped"``), but the manifest
        they missed is remembered per cell so :meth:`revive` can replay
        the merged window (or force a full re-place) before the cell
        rejoins — a revived cell never serves a stale index.

        Returns ``{"mode", "bytes", "full_bytes", "cells"}`` where
        ``cells`` maps cell name to its backend's republish stats and
        the aggregate mode is ``"full"`` if any cell fell back to a
        full re-place, else ``"delta"`` if any shipped a delta.
        """
        tracer = get_tracer()
        if delta == "auto":
            delta = (target.pop_delta()
                     if hasattr(target, "pop_delta") else None)
        per_cell: dict[str, dict] = {}
        with self._lock:
            self._last_publish = (target, dict(kw))
        with tracer.span("maint.fanout", cells=len(self.cells),
                         manifest=delta is not None):
            for cell in self.cells:
                with self._lock:
                    skip = cell.name in self._down
                    if skip:
                        # remember what this down cell missed so
                        # revive() can replay it before the cell rejoins
                        self._missed.setdefault(cell.name,
                                                []).append(delta)
                    else:
                        self._draining.add(cell.name)
                if skip:
                    per_cell[cell.name] = {
                        "mode": "skipped", "bytes": 0,
                        "full_bytes": 0, "reason": "down"}
                    continue
                try:
                    with tracer.span("maint.drain", cell=cell.name):
                        t_end = time.perf_counter() + drain_timeout_s
                        while (cell.depth() > 0
                               and time.perf_counter() < t_end):
                            time.sleep(1e-3)
                    # cell.apply_updates emits its own "republish" span
                    st = cell.apply_updates(target, delta=delta, **kw)
                    per_cell[cell.name] = st if isinstance(st, dict) else {}
                finally:
                    with self._lock:
                        self._draining.discard(cell.name)
        modes = {s.get("mode") for s in per_cell.values()}
        mode = ("full" if "full" in modes
                else "delta" if "delta" in modes
                else "none")
        return {
            "mode": mode,
            "bytes": sum(int(s.get("bytes", 0)) for s in per_cell.values()),
            "full_bytes": sum(int(s.get("full_bytes", 0))
                              for s in per_cell.values()),
            "cells": per_cell,
        }

    # -- telemetry -----------------------------------------------------
    def registries(self) -> dict:
        """Prefix -> :class:`MetricsRegistry` for every component in the
        fleet: the router's own, each cell's, and each cell backend's
        (when it exposes one) — the unit :meth:`metrics_snapshot` and
        :meth:`exposition` aggregate over."""
        parts = {"router.": self.metrics}
        for c in self.cells:
            parts[f"{c.name}."] = c.metrics
            bm = getattr(c.search_fn, "metrics", None)
            if isinstance(bm, MetricsRegistry):
                parts[f"{c.name}.backend."] = bm
        return parts

    def metrics_snapshot(self) -> dict:
        """One JSON-safe snapshot over every registry in the fleet."""
        return merge_snapshots(self.registries())

    def exposition(self) -> str:
        """Prometheus text exposition over every registry in the fleet."""
        return "".join(reg.exposition(prefix=prefix)
                       for prefix, reg in sorted(self.registries().items()))

    def _fleet_stages(self, per_cell: dict) -> dict:
        """Fleet-level per-stage summaries: identically-bucketed stage
        histograms merged across cells, plus the router's route span."""
        stages: dict = {}
        for stage, source, hname in (
                ("queue", "cell", "queue_ms"),
                ("batch", "cell", "batch_ms"),
                ("dispatch", "cell", "dispatch_ms"),
                ("kernel", "backend", "kernel_ms"),
                ("rerank", "backend", "rerank_ms")):
            hists = []
            for c in self.cells:
                reg = (c.metrics if source == "cell"
                       else getattr(c.search_fn, "metrics", None))
                if not isinstance(reg, MetricsRegistry):
                    continue
                h = reg.get(hname)
                if h is not None and h.count:
                    hists.append(h)
            if hists:
                stages[stage] = Histogram.merged(hname, hists).stats_dict()
        if self._h_route.count:
            stages["route"] = self._h_route.stats_dict()
        return stages

    def stats(self) -> EngineStats:
        """Fleet-level :class:`EngineStats`: percentiles over routed
        end-to-end latencies, routing counters, and a per-cell
        breakdown in ``.cells``."""
        a = self._h_route
        shed = self._c_shed.value
        rerouted = self._c_rerouted.value
        hedge_cell = self._c_hedge_cell.value
        cancelled = self._c_cancelled.value
        resyncs = self._c_resyncs.value
        per_cell = {c.name: c.stats() for c in self.cells}
        vals = list(per_cell.values())
        hedges = sum(s.hedges for s in vals)
        ch = sum(s.cache_hits for s in vals)
        cm = sum(s.cache_misses for s in vals)
        cancelled += sum(s.cancelled for s in vals)
        rb = sum(s.republished_bytes for s in vals)
        # delta_fraction needs the raw full-bytes denominators, which
        # the cells keep privately; recompute from their gauges
        rfb = sum(c.republish_full_bytes for c in self.cells)
        frac = rb / rfb if rfb else 0.0
        # drift is fleet-global: the estimator is shared, so any cell's
        # reading is THE reading
        drift = max((s.drift for s in vals), default=0.0)
        n_w = sum(s.n for s in vals)
        queue_ms = (sum(s.queue_ms * s.n for s in vals) / n_w
                    if n_w else 0.0)
        batch_sizes: list = []
        for s in vals:
            batch_sizes.extend(s.batch_sizes[-25:])
        common = dict(batch_sizes=batch_sizes, hedges=hedges,
                      cache_hits=ch, cache_misses=cm, drift=drift,
                      republished_bytes=rb, delta_fraction=frac,
                      cancelled=cancelled, shed=shed, rerouted=rerouted,
                      hedge_cell=hedge_cell, resyncs=resyncs,
                      cells=per_cell, stages=self._fleet_stages(per_cell))
        if a.count == 0:
            return EngineStats(0, 0, 0, 0, 0, queue_ms, **common)
        return EngineStats(
            n=a.count,
            p50_ms=a.quantile(0.5),
            p90_ms=a.quantile(0.9),
            p99_ms=a.quantile(0.99),
            mean_ms=a.mean(),
            queue_ms=queue_ms,
            **common,
        )

    def close(self):
        for cell in self.cells:
            cell.close()


def build_fleet(devices, target, *, kind: str = "auto", k: int = 10,
                cache_capacity: Optional[int] = None, estimator=None,
                backend_kw: Optional[dict] = None,
                cell_kw: Optional[dict] = None,
                **router_kw) -> CellRouter:
    """Fleet constructor: one ``ShardedSearchBackend`` a cell, a per-cell
    TinyLFU cache (affinity routing keeps each head coherent) and ONE
    shared estimator, so the maintenance leader makes a single fleet-wide
    drift decision (``OnlineLikelihoodEstimator`` is internally locked,
    safe to share across cell workers).

    ``devices`` holds one entry a cell: the device its backend is placed
    on.  This is the single-process form of the reference's list of
    disjoint meshes: on one card every entry is ``cuda:0`` (the
    reference's ``share_devices=True``), each cell its own placement.
    A cell over several ranks is built by ``ServingCell.sharded(target,
    mesh=...)`` on every rank of its mesh; the root's cell is then passed
    to :class:`CellRouter` by the process that holds it (the other ranks
    follow).
    """
    from repro_torch.distributed.backend import ShardedSearchBackend

    cells = []
    for i, dev in enumerate(devices):
        fn = ShardedSearchBackend(target, kind=kind, k=k, device=dev,
                                  **(backend_kw or {}))
        cache = (FrequencyAdmissionCache(cache_capacity)
                 if cache_capacity else None)
        cells.append(ServingCell(
            fn, name=f"cell{i}", cache=cache, estimator=estimator,
            **(cell_kw or {})))
    return CellRouter(cells, **router_kw)
