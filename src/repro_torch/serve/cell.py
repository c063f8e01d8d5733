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
    :meth:`ServingCell.search` re-raises the error.

The result cache, likelihood estimator, hedging, filter/mode options,
``apply_updates`` and the fleet tier are later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["ServingCell", "EngineStats", "CellFailure"]


@dataclasses.dataclass
class CellFailure:
    """Future value: the backend raised while computing the batch that
    held this request."""

    cell: str
    error: BaseException


@dataclasses.dataclass
class _Request:
    query: np.ndarray
    t_enqueue: float
    future: "queue.Queue"
    cancelled: threading.Event
    trace_id: int = 0


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
                nprobe_local: int = 2, headroom: float = 1.0,
                fused: bool = True, device=None,
                **cell_kw) -> "ServingCell":
        """Cell over a :class:`repro_torch.distributed.backend.
        ShardedSearchBackend` (corpus or index placed once, on the card
        unless ``device`` says otherwise); ``cell_kw`` passes through to
        the cell (``max_batch``, ``max_wait_ms``, ``name``)."""
        from repro_torch.distributed.backend import ShardedSearchBackend

        fn = ShardedSearchBackend(
            target, kind=kind, k=k, nprobe_local=nprobe_local,
            headroom=headroom, fused=fused, device=device)
        return cls(fn, **cell_kw)

    @property
    def n_cancelled(self) -> int:
        return self._c_cancelled.value

    # ------------------------------------------------------------------
    def submit(self, query: np.ndarray, *,
               cancelled: Optional[threading.Event] = None,
               trace_id: int = 0) -> "queue.Queue":
        """Enqueue one request; returns the future its result lands in.
        Once ``cancelled`` is set the worker drops the request."""
        fut: "queue.Queue" = queue.Queue()
        self.q.put(_Request(
            query=query, t_enqueue=time.perf_counter(), future=fut,
            cancelled=cancelled if cancelled is not None
            else threading.Event(), trace_id=trace_id))
        return fut

    def failure(self) -> Optional[BaseException]:
        """Last backend exception, or None while healthy."""
        with self._stats_lock:
            return self._failure

    def search(self, query: np.ndarray, timeout: float = 30.0):
        """Blocking single-query call.

        Raises :class:`TimeoutError` when no result arrives in ``timeout``
        seconds; the abandoned request is cancelled, so the worker drops
        it and it never lands in the latency stats.
        """
        tracer = get_tracer()
        cancelled = threading.Event()
        trace_id = tracer.new_trace_id()
        fut = self.submit(query, cancelled=cancelled, trace_id=trace_id)
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
            batch = [r for r in collected if not r.cancelled.is_set()]
            if batch:
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
                d, i = self.search_fn(qs)
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
        if lat.count == 0:
            return EngineStats(0, 0, 0, 0, 0, 0, [], cancelled=cancelled,
                               stages=stages)
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
        )
