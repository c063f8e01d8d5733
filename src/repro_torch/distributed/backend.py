"""Sharded search as a ``ServingCell`` backend.

Port of the brute/IVF part of ``repro/distributed/backend.py``.  The
expensive work happens once, at construction: pad the corpus or index
tables and place them on the device.  The per-batch hot path is query
placement, the per-shard local (the CUDA kernels on the card) and the
copy of the merged top-k back to the host.

    cell = ServingCell.sharded(index, k=10, nprobe_local=32)   # on the card
    backend = ShardedSearchBackend(db, kind="brute")           # explicit

Telemetry: ``kernel_ms`` (queue and device execution of the search, up
to the stream synchronise) and ``rerank_ms`` (copy back to the host)
histograms, a ``dispatches`` counter, and ``kernel``/``rerank`` spans.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distributed.sharding import (
    _brute_device_arrays,
    _ivf_device_arrays,
    make_sharded_brute_fn,
    make_sharded_ivf_fn,
)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["ShardedSearchBackend"]


class ShardedSearchBackend:
    """Callable ``queries (B, d) -> (dists (B, k), ids (B, k))``, numpy.

    ``target`` is either a raw ``(N, d)`` corpus (exact scan) or a built
    ``TwoLevelIndex`` (IVF over its brute bottom); ``kind="auto"`` picks
    accordingly.  ``headroom`` > 1 reserves rows (brute) or bucket width
    (IVF) for an index that grows; ``alive`` (brute) masks tombstoned
    rows.  ``fused=False`` runs the unfused plain ops instead of the
    kernels.  Runs on the card unless ``device`` says otherwise.
    """

    def __init__(self, target, *, kind: str = "auto", k: int = 10,
                 nprobe_local: int = 2, headroom: float = 1.0, alive=None,
                 fused: bool = True, device=None):
        self.device = resolve(device)
        self.k = k
        self.fused = fused
        self.nprobe_local = nprobe_local
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self._h_kernel = self.metrics.histogram("kernel_ms")
        self._h_rerank = self.metrics.histogram("rerank_ms")
        self._c_dispatches = self.metrics.counter("dispatches")

        if kind == "auto":
            if isinstance(target, np.ndarray) or not hasattr(
                    target, "bucket_ids"):
                kind = "brute"
            else:
                kind = "ivf"
        self.kind = kind
        if kind == "brute":
            n = int(np.shape(target)[0])
            self._rows = int(np.ceil(n * headroom))
            self._fn = make_sharded_brute_fn(k, self._rows, fused=fused)
        elif kind == "ivf":
            n_buckets, cap = target.bucket_ids.shape
            self._cap = int(np.ceil(cap * headroom))
            self._fn = make_sharded_ivf_fn(k, nprobe_local, int(n_buckets),
                                           fused=fused)
        elif kind == "forest":
            raise NotImplementedError(
                "kind='forest' (tree/QLBT bottom): see ROADMAP.md, 'Modules "
                "still to port'")
        else:
            raise ValueError(f"unknown backend kind {kind!r}")
        self._place(target, alive=alive)

    def _place(self, target, alive=None) -> None:
        """Pad and place ``target`` on the device in the recorded shapes."""
        with self._lock:
            if self.kind == "brute":
                db_host = np.asarray(getattr(target, "db", target),
                                     np.float32)
                self._args = _brute_device_arrays(
                    db_host, self.device, rows=self._rows, alive=alive)
            else:
                self._args = _ivf_device_arrays(target, self.device,
                                                cap=self._cap)

    def __call__(self, queries):
        tracer = get_tracer()
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        B = int(q.shape[0])
        t0 = time.perf_counter()
        # kernel: enqueue + device execution; the synchronise runs outside
        # the lock so the span measures device time, not the enqueue
        with tracer.span("kernel", kind=self.kind, b=B):
            with self._lock:
                d, i = self._fn(*self._args, q)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()
        # rerank: pull the merged top-k back to the host
        with tracer.span("rerank", kind=self.kind):
            out = d.cpu().numpy(), i.cpu().numpy()
        t2 = time.perf_counter()
        self._c_dispatches.inc()
        self._h_kernel.observe((t1 - t0) * 1e3)
        self._h_rerank.observe((t2 - t1) * 1e3)
        return out
