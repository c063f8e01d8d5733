"""Request tracing: spans, propagated trace ids, Chrome-trace export.

A copy of ``repro/obs/trace.py``, which is framework-agnostic.

The fleet's request path crosses three thread domains — the caller
(router admission), the cell's batch worker (micro-batch assembly +
backend dispatch), and the backend's device work — so a single latency
number can't say *where* a p99 went.  A :class:`Tracer` records
**spans** (named, timed intervals with attributes) into a bounded ring
buffer and exports them as Chrome-trace JSON, which Perfetto
(https://ui.perfetto.dev) renders as a per-thread timeline.

Two recording modes cover the two threading shapes:

* :meth:`Tracer.span` — a context manager for work done on the current
  thread.  Spans nest via a thread-local stack; a child inherits its
  parent's ``trace_id`` so every event of one request shares an id.
* :meth:`Tracer.record_span` — explicit ``(t_start, t_end)`` recording
  for intervals that *end* on a different thread than they began (the
  queue wait starts at ``submit`` on the caller thread and ends when
  the batch worker picks the request up — the worker records it).

The span taxonomy instrumented across the stack (``route`` >
``admission``, ``queue``, ``batch`` > ``dispatch`` > ``kernel`` >
``rerank``, plus ``maint.*`` and ``republish``) is catalogued in
``docs/observability.md``.

Design constraints, inherited from the serving stack's invariants:

* **bounded memory** — the ring holds ``capacity`` events; sustained
  traffic overwrites the oldest (``n_dropped`` counts evictions);
* **host only** — tracing is pure host bookkeeping (two
  ``perf_counter`` calls and a dict append per span); it launches and
  waits for nothing on the device;
* **never throws into the traced path** — a span body's exception is
  tagged on the span (``error`` attribute) and re-raised untouched.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

__all__ = ["Tracer", "get_tracer", "set_tracer"]


class _Span:
    """Mutable handle yielded by :meth:`Tracer.span`; ``set(**attrs)``
    attaches attributes that land in the exported event's ``args``."""

    __slots__ = ("name", "span_id", "trace_id", "parent_id", "t0",
                 "tid", "attrs")

    def __init__(self, name, span_id, trace_id, parent_id, t0, tid,
                 attrs):
        self.name = name
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t0 = t0
        self.tid = tid
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """Yielded when tracing is disabled: absorbs ``set`` calls."""

    __slots__ = ()
    trace_id = 0
    span_id = 0

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class Tracer:
    """Bounded in-process span recorder with Chrome-trace export."""

    def __init__(self, capacity: int = 32768, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self._n_emitted = 0
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._t0 = time.perf_counter()
        self._wall0 = time.time()

    # -- id / context plumbing -----------------------------------------
    def new_trace_id(self) -> int:
        return next(self._ids)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> Optional[_Span]:
        st = self._stack()
        return st[-1] if st else None

    # -- recording -----------------------------------------------------
    @contextmanager
    def span(self, name: str, *, trace_id: Optional[int] = None, **attrs):
        """Time a block on the current thread; nests under the
        enclosing span and inherits its ``trace_id`` unless one is
        passed explicitly."""
        if not self.enabled:
            yield _NULL
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        if trace_id is None:
            trace_id = parent.trace_id if parent else self.new_trace_id()
        sp = _Span(name, next(self._ids), trace_id,
                   parent.span_id if parent else 0,
                   time.perf_counter(), threading.get_ident(),
                   dict(attrs))
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            stack.pop()
            self._emit(sp.name, sp.t0, time.perf_counter(), sp.trace_id,
                       sp.span_id, sp.parent_id, sp.tid, sp.attrs)

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    trace_id: int = 0, tid: Optional[int] = None,
                    **attrs) -> None:
        """Record an already-timed interval (``perf_counter`` seconds).

        The cross-thread form: the queue wait is *started* by the
        caller's ``submit`` and *recorded* by the batch worker, under
        the worker's tid, keyed back to the request by ``trace_id``.
        """
        if not self.enabled:
            return
        parent = self.current_span()
        self._emit(name, t_start, t_end, trace_id,
                   next(self._ids), parent.span_id if parent else 0,
                   tid if tid is not None else threading.get_ident(),
                   attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker (hedge fired, compile happened, ...)."""
        if not self.enabled:
            return
        parent = self.current_span()
        now = time.perf_counter()
        ev = {"ph": "i", "s": "t", "name": name, "pid": 0,
              "tid": threading.get_ident(),
              "ts": (now - self._t0) * 1e6,
              "args": dict(attrs,
                           trace_id=parent.trace_id if parent else 0)}
        with self._lock:
            self._events.append(ev)
            self._n_emitted += 1

    def _emit(self, name, t0, t1, trace_id, span_id, parent_id, tid,
              attrs) -> None:
        args = dict(attrs)
        args["trace_id"] = trace_id
        args["span_id"] = span_id
        if parent_id:
            args["parent"] = parent_id
        ev = {"ph": "X", "name": name, "cat": "repro", "pid": 0,
              "tid": tid, "ts": (t0 - self._t0) * 1e6,
              "dur": max((t1 - t0) * 1e6, 0.0), "args": args}
        with self._lock:
            self._events.append(ev)
            self._n_emitted += 1

    # -- introspection / export ----------------------------------------
    @property
    def n_dropped(self) -> int:
        with self._lock:
            return max(0, self._n_emitted - len(self._events))

    def events(self, name: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e["name"] == name]

    def span_names(self) -> set:
        with self._lock:
            return {e["name"] for e in self._events}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._n_emitted = 0

    def footprint_capacity(self) -> int:
        """The hard event cap — the bounded-memory contract."""
        return self.capacity

    def to_chrome(self) -> dict:
        """Chrome-trace JSON object: load at ui.perfetto.dev or
        chrome://tracing.  ``ts`` is microseconds from tracer start."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "repro_torch.obs.trace",
                "wall_time_origin_unix_s": self._wall0,
                "events_dropped": self.n_dropped,
            },
        }

    def export(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome(), f)
        return path


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-wide default tracer (components take ``tracer=`` to
    override; benchmarks install a fresh one via :func:`set_tracer`)."""
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process default; returns the previous tracer so callers
    can restore it (``finally: set_tracer(old)``)."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, tracer
    return old
