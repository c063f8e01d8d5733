"""Single-replica serving cell: request queue, micro-batcher, latency stats.

Port of the core of ``repro/serve/cell.py``.  A :class:`ServingCell`
wraps one search function:

  * micro-batching: collect up to ``max_batch`` requests or
    ``max_wait_ms`` (whichever first) and pad the batch to the next power
    of two, so the backend sees a handful of shapes;
  * per-request latency tracking (P50/P90/P99, queue vs compute split) in
    a fixed-footprint :class:`repro_torch.obs.metrics.MetricsRegistry`,
    plus ``queue``/``batch``/``dispatch`` spans;
  * cancellation: a request abandoned by its caller (timeout) is dropped
    by the batch worker instead of computed, and never lands in the
    latency or queue-wait stats;
  * fail-fast failure: a backend exception does not strand the batch —
    every request in it receives a :class:`CellFailure`, and
    :meth:`ServingCell.search` re-raises the error;
  * request options: ``filter`` / ``mode`` / ``alpha`` / ``q_terms`` /
    ``q_weights`` pass through to the backend.  One backend dispatch
    carries one filter, mode and alpha, so a collected batch is served
    as one dispatch per distinct option set, the lexical operands of its
    requests stacked and padded.

  * online updates: :meth:`ServingCell.apply_updates` pops the target's
    delta manifest and hands it to the backend, which scatters the dirty
    slices in place under its lock while the cell keeps serving;
  * across ranks: ``ServingCell.sharded(target, mesh=...)`` runs the cell
    on the mesh's root rank; the other ranks follow its backend's calls.

The result cache (which must fold the option key into its own key),
likelihood estimator, hedging (and with it the hedge replica's
``apply_updates``) and the fleet tier are later slices (ROADMAP.md,
module item 4).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.distributed.backend import MODES
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["ServingCell", "EngineStats", "CellFailure"]


@dataclasses.dataclass
class CellFailure:
    """Future value: the backend raised while computing the batch that
    held this request."""

    cell: str
    error: BaseException


def _opts_key(filter_spec, mode: str, alpha: float) -> tuple:
    """Hashable key of the request options that change the answer
    (filter predicates, search mode, hybrid alpha): ``()`` for a default
    semantic unfiltered request, so those all batch together."""
    if mode == "semantic" and (filter_spec is None or filter_spec.empty):
        return ()
    fkey = (b"" if filter_spec is None or filter_spec.empty
            else filter_spec.key())
    return (fkey, mode, np.float32(alpha).tobytes())


@dataclasses.dataclass
class _Request:
    query: np.ndarray
    t_enqueue: float
    future: "queue.Queue"
    cancelled: threading.Event
    trace_id: int = 0
    # the micro-batch grouping key (``_opts_key``) and the options
    opts: tuple = ()
    filter_spec: "object | None" = None
    mode: str = "semantic"
    alpha: float = 0.5
    q_terms: "np.ndarray | None" = None
    q_weights: "np.ndarray | None" = None


@dataclasses.dataclass
class EngineStats:
    """Read-only view over the cell's metrics registry, built fresh by
    :meth:`ServingCell.stats`."""

    n: int
    p50_ms: float
    p90_ms: float
    p99_ms: float
    mean_ms: float
    queue_ms: float
    batch_sizes: list
    # requests whose caller timed out before a result was computed; they
    # are dropped by the worker and excluded from the percentiles above
    cancelled: int = 0
    # stage name (queue/batch/dispatch/kernel/rerank) -> {"n", "p50_ms",
    # "p99_ms", "mean_ms"}; kernel/rerank come from the backend's registry
    stages: "dict | None" = None
    # batches the worker collected, and the backend dispatches it made for
    # them: one per distinct option set in a batch
    collected_batches: int = 0
    dispatches: int = 0


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class ServingCell:
    """search_fn(queries (B, d)) -> (dists (B, k), ids (B, k))."""

    def __init__(self, search_fn: Callable, *, name: str = "cell0",
                 max_batch: int = 64, max_wait_ms: float = 2.0):
        self.search_fn = search_fn
        self.name = name
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.metrics = MetricsRegistry()
        self._h_latency = self.metrics.histogram("latency_ms")
        self._h_queue = self.metrics.histogram("queue_ms")
        self._h_batch = self.metrics.histogram("batch_ms")
        self._h_dispatch = self.metrics.histogram("dispatch_ms")
        self._h_bsize = self.metrics.histogram("batch_size", lo=1.0,
                                               hi=4096.0)
        self._c_cancelled = self.metrics.counter("cancelled")
        self._c_failures = self.metrics.counter("backend_failures")
        self._c_collected = self.metrics.counter("collected_batches")
        # last-100 batch sizes for EngineStats.batch_sizes (bounded)
        self._recent_batches: deque = deque(maxlen=100)
        self._failure: Optional[BaseException] = None
        # guards the failure slot and the recent-batch deque; the metric
        # instruments are internally locked
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @classmethod
    def sharded(cls, target, *, kind: str = "auto", k: int = 10,
                mesh=None, axes=("data", "model"), query_axes=(),
                nprobe_local: int = 2, beam_width: int = 8,
                headroom: float = 1.0, delta_updates: bool = True,
                fused: bool = True, device=None,
                **cell_kw) -> "Optional[ServingCell]":
        """Cell over a :class:`repro_torch.distributed.backend.
        ShardedSearchBackend` (corpus or index placed once, on the card
        unless ``device`` says otherwise); ``headroom`` > 1 reserves room
        for later ``apply_updates`` calls, ``beam_width`` and
        ``delta_updates`` configure the forest kind.  ``cell_kw`` passes
        through to the cell (``max_batch``, ``max_wait_ms``, ``name``).

        With a ``mesh`` (every rank calls this with the same arguments)
        each rank places its shard over ``axes`` / ``query_axes``; the
        mesh's root rank gets the cell, whose backend leads, and every
        other rank follows the root's calls here until the cell is closed,
        then gets None."""
        from repro_torch.distributed.backend import ShardedSearchBackend

        fn = ShardedSearchBackend(
            target, kind=kind, k=k, mesh=mesh, axes=axes,
            query_axes=query_axes, nprobe_local=nprobe_local,
            beam_width=beam_width, headroom=headroom,
            delta_updates=delta_updates, fused=fused, device=device)
        if mesh is not None and not fn._coll.root:
            fn.follow()
            return None
        return cls(fn.lead(), **cell_kw)

    def apply_updates(self, target, *, delta="auto", **kw):
        """Swap in a mutated corpus or index without stopping the cell.

        Delegates to the backend's ``apply_updates``: placement happens
        under the backend's lock, in-flight batches finish against the old
        tables and later batches see the new ones.  ``delta="auto"`` pops
        the target's :class:`repro_torch.core.delta.DeltaManifest`
        (``pop_delta()``) once and hands it to the backend, which ships
        only the dirty slices when it can; ``delta=None`` forces a full
        re-place, and an explicit manifest lets the caller manage popping.
        Returns the backend's republish stats (``mode`` / ``bytes`` /
        ``full_bytes`` / ``reason``).  This cell serves one backend: the
        hedge replica the reference also updates, and a backend whose
        followers would need the update too (the fleet's leader-driven
        delta fan-out), are ROADMAP.md's module item 4.
        """
        if getattr(self.search_fn, "leads", False):
            raise NotImplementedError(
                "apply_updates on a cell whose backend leads followers on "
                "other ranks: the followers' update is the fleet tier's "
                "delta fan-out (ROADMAP.md, module item 4)")
        if not hasattr(self.search_fn, "apply_updates"):
            raise TypeError(
                f"search_fn {type(self.search_fn).__name__} has no "
                "apply_updates; only pre-placed backends support online "
                "mutation")
        if delta == "auto":
            delta = (target.pop_delta()
                     if hasattr(target, "pop_delta") else None)
        dkw = {} if delta is None else {"delta": delta}
        with get_tracer().span("republish", cell=self.name) as sp:
            stats = self.search_fn.apply_updates(target, **dkw, **kw)
            if isinstance(stats, dict):
                sp.set(mode=stats.get("mode"),
                       bytes=int(stats.get("bytes", 0)))
        return stats if isinstance(stats, dict) else None

    @property
    def n_cancelled(self) -> int:
        return self._c_cancelled.value

    # ------------------------------------------------------------------
    def submit(self, query: np.ndarray, *,
               cancelled: Optional[threading.Event] = None,
               trace_id: int = 0, filter_spec=None, mode: str = "semantic",
               alpha: float = 0.5, q_terms=None,
               q_weights=None) -> "queue.Queue":
        """Enqueue one request; returns the future its result lands in.
        Once ``cancelled`` is set the worker drops the request.  The
        options pass through to the backend; the worker batches only
        requests that share ``filter_spec``, ``mode`` and ``alpha``.

        Raises :class:`ValueError` for an unknown ``mode``, and for a
        lexical or hybrid request without ``q_terms`` and ``q_weights`` of
        one length, so that one bad request never fails the dispatch it
        would share with other callers' requests."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode != "semantic":
            if q_terms is None or q_weights is None:
                raise ValueError(f"mode={mode!r} requires q_terms and "
                                 "q_weights")
            q_terms = np.asarray(q_terms, np.int32).reshape(-1)
            q_weights = np.asarray(q_weights, np.float32).reshape(-1)
            if q_terms.size != q_weights.size:
                raise ValueError(
                    f"q_terms has {q_terms.size} slots, q_weights "
                    f"{q_weights.size}")
        fut: "queue.Queue" = queue.Queue()
        self.q.put(_Request(
            query=query, t_enqueue=time.perf_counter(), future=fut,
            cancelled=cancelled if cancelled is not None
            else threading.Event(), trace_id=trace_id,
            opts=_opts_key(filter_spec, mode, alpha),
            filter_spec=filter_spec, mode=mode, alpha=alpha,
            q_terms=q_terms if mode != "semantic" else None,
            q_weights=q_weights if mode != "semantic" else None))
        return fut

    def failure(self) -> Optional[BaseException]:
        """Last backend exception, or None while healthy."""
        with self._stats_lock:
            return self._failure

    def search(self, query: np.ndarray, timeout: float = 30.0, *,
               filter=None, mode: str = "semantic", alpha: float = 0.5,
               q_terms=None, q_weights=None):
        """Blocking single-query call.

        ``filter`` (a ``FilterSpec``), ``mode`` (``"semantic"`` /
        ``"lexical"`` / ``"hybrid"``), ``alpha`` and the lexical operands
        ``q_terms`` / ``q_weights`` (one query's term ids and weights)
        pass through to the backend.

        Raises :class:`TimeoutError` when no result arrives in ``timeout``
        seconds; the abandoned request is cancelled, so the worker drops
        it and it never lands in the latency stats.
        """
        tracer = get_tracer()
        cancelled = threading.Event()
        trace_id = tracer.new_trace_id()
        fut = self.submit(query, cancelled=cancelled, trace_id=trace_id,
                          filter_spec=filter, mode=mode, alpha=alpha,
                          q_terms=q_terms, q_weights=q_weights)
        try:
            out = fut.get(timeout=timeout)
        except queue.Empty:
            cancelled.set()
            self._c_cancelled.inc()
            tracer.instant("cancel", cell=self.name, trace_id=trace_id)
            raise TimeoutError(
                f"search timed out after {timeout}s (batch worker "
                "stalled or search_fn hung)") from None
        if isinstance(out, CellFailure):
            raise RuntimeError(
                f"cell {out.cell!r} backend failed") from out.error
        return out

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        # a backend leading other ranks releases their follow() loops
        stop = getattr(self.search_fn, "stop_followers", None)
        if stop is not None:
            stop()
        # a closed cell must not strand queued requests: fail them fast
        fail = CellFailure(cell=self.name,
                           error=RuntimeError(f"cell {self.name} closed"))
        while True:
            try:
                self.q.get_nowait().future.put(fail)
            except queue.Empty:
                break

    # ------------------------------------------------------------------
    def _collect(self) -> "tuple[list[_Request], float]":
        """Returns (batch, t_first): the requests collected and the
        instant the first one was dequeued."""
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return [], 0.0
        t_first = time.perf_counter()
        batch = [first]
        deadline = t_first + self.max_wait
        while len(batch) < self.max_batch:
            rem = deadline - time.perf_counter()
            if rem <= 0:
                break
            try:
                batch.append(self.q.get(timeout=rem))
            except queue.Empty:
                break
        return batch, t_first

    def _run(self):
        while not self._stop.is_set():
            collected, t_first = self._collect()
            # requests abandoned by their caller are dropped here
            collected = [r for r in collected if not r.cancelled.is_set()]
            if not collected:
                continue
            self._c_collected.inc()
            # one backend dispatch carries one filter/mode/alpha: serve
            # one group per distinct option set, in arrival order
            groups: "dict[tuple, list[_Request]]" = {}
            for r in collected:
                groups.setdefault(r.opts, []).append(r)
            for batch in groups.values():
                self._serve_batch(batch, t_first)

    def _serve_batch(self, batch: "list[_Request]", t_first: float):
        tracer = get_tracer()
        qs = np.stack([r.query for r in batch])
        b = qs.shape[0]
        bb = _bucket(b)
        if bb > b:
            qs = np.pad(qs, ((0, bb - b), (0, 0)))
        t0 = time.perf_counter()
        for r in batch:
            tracer.record_span("queue", r.t_enqueue, t_first,
                               trace_id=r.trace_id, cell=self.name)
        tracer.record_span("batch", t_first, t0, trace_id=batch[0].trace_id,
                           cell=self.name, size=b, bucket=bb)
        try:
            with tracer.span("dispatch", trace_id=batch[0].trace_id,
                             cell=self.name, size=b, bucket=bb):
                kw = self._group_kw(batch, bb)
                # a plain callable backend only ever sees the bare call
                d, i = (self.search_fn(qs, **kw) if kw
                        else self.search_fn(qs))
        except Exception as e:
            # fail fast, keep the worker alive: every request in the batch
            # gets a CellFailure instead of timing out
            self._c_failures.inc()
            with self._stats_lock:
                self._failure = e
            fail = CellFailure(cell=self.name, error=e)
            for r in batch:
                r.future.put(fail)
            return
        t1 = time.perf_counter()
        served = [(j, r) for j, r in enumerate(batch)
                  if not r.cancelled.is_set()]
        # telemetry before resolving futures: a caller that reads its
        # result and then calls stats() sees this batch
        for _, r in served:
            self._h_latency.observe((t1 - r.t_enqueue) * 1e3)
            self._h_queue.observe((t_first - r.t_enqueue) * 1e3)
        self._h_batch.observe((t0 - t_first) * 1e3)
        self._h_dispatch.observe((t1 - t0) * 1e3)
        self._h_bsize.observe(b)
        with self._stats_lock:
            self._recent_batches.append(b)
        for j, r in served:
            r.future.put((np.asarray(d[j]), np.asarray(i[j])))

    @staticmethod
    def _group_kw(batch: "list[_Request]", bb: int) -> dict:
        """Backend keyword arguments for one option group: the shared
        filter/mode/alpha plus the stacked per-request lexical operands,
        term rows padded to the group's power-of-two slot width with
        -1 / 0 (so the batch's pad queries score nothing)."""
        r0 = batch[0]
        if not r0.opts:
            return {}
        kw = {"filter_spec": r0.filter_spec, "mode": r0.mode,
              "alpha": r0.alpha}
        if r0.mode != "semantic":
            slots = _bucket(max(r.q_terms.size for r in batch))
            qt = np.full((bb, slots), -1, np.int32)
            qw = np.zeros((bb, slots), np.float32)
            for j, r in enumerate(batch):
                qt[j, :r.q_terms.size] = r.q_terms
                qw[j, :r.q_weights.size] = r.q_weights
            kw["q_terms"] = qt
            kw["q_weights"] = qw
        return kw

    # ------------------------------------------------------------------
    def _stage_stats(self) -> dict:
        stages = {
            "queue": self._h_queue.stats_dict(),
            "batch": self._h_batch.stats_dict(),
            "dispatch": self._h_dispatch.stats_dict(),
        }
        bm = getattr(self.search_fn, "metrics", None)
        if isinstance(bm, MetricsRegistry):
            for hname, stage in (("kernel_ms", "kernel"),
                                 ("rerank_ms", "rerank")):
                h = bm.get(hname)
                if h is not None and h.count:
                    stages[stage] = h.stats_dict()
        return stages

    def stats(self) -> EngineStats:
        lat = self._h_latency
        cancelled = self._c_cancelled.value
        with self._stats_lock:
            batch_sizes = list(self._recent_batches)
        stages = self._stage_stats()
        counts = {"collected_batches": self._c_collected.value,
                  "dispatches": self._h_bsize.count}
        if lat.count == 0:
            return EngineStats(0, 0, 0, 0, 0, 0, [], cancelled=cancelled,
                               stages=stages, **counts)
        return EngineStats(
            n=lat.count,
            p50_ms=lat.quantile(0.5),
            p90_ms=lat.quantile(0.9),
            p99_ms=lat.quantile(0.99),
            mean_ms=lat.mean(),
            queue_ms=self._h_queue.mean(),
            batch_sizes=batch_sizes,
            cancelled=cancelled,
            stages=stages,
            **counts,
        )
