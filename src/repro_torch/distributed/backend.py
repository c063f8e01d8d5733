"""Sharded search as a ``ServingCell`` backend.

Port of the brute/IVF part of ``repro/distributed/backend.py``, with its
filter, lexical, hybrid and int8 options.  The expensive work happens
once, at construction: pad the corpus or index tables (and the postings
slabs) and place them on the device.  The per-batch hot path is query
placement, the per-shard local (the CUDA kernels on the card) and the
copy of the merged top-k back to the host.

    cell = ServingCell.sharded(index, k=10, nprobe_local=32)   # on the card
    backend = ShardedSearchBackend(db, kind="brute")           # explicit
    backend(q, filter_spec=FilterSpec.range("pct", 0, 4))
    backend(q, mode="hybrid", alpha=0.5, q_terms=qt, q_weights=qw)

Filters are data, not shapes: a ``FilterSpec`` compiles (once per
``key()``, until the next placement) to the brute kind's ``valid``
operand ANDed with the entity mask, or to the IVF kind's ``bucket_ids``
with filtered slots set to -1, and the same kernels scan it.

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
    _brute_int8_device_arrays,
    _ivf_device_arrays,
    _lexical_device_arrays,
    make_sharded_brute_fn,
    make_sharded_hybrid_fn,
    make_sharded_ivf_fn,
    make_sharded_lexical_fn,
)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["ShardedSearchBackend", "MODES"]

MODES = ("semantic", "lexical", "hybrid")
_MASK_CACHE = 64     # compiled filter operands kept per placement


class ShardedSearchBackend:
    """Callable ``queries (B, d) -> (dists (B, k), ids (B, k))``, numpy.

    ``target`` is either a raw ``(N, d)`` corpus (exact scan) or a built
    ``TwoLevelIndex`` (IVF over its buckets; ``kind="forest"``, a tree or
    QLBT bottom, is not ported yet); ``kind="auto"`` picks accordingly.  ``headroom`` > 1 reserves rows (brute) or bucket width
    (IVF) for an index that grows; ``alive`` (brute) masks tombstoned
    rows.  ``fused=False`` runs the unfused plain ops instead of the
    kernels.  ``precision="int8"`` (brute, fused) scans per-row-scaled
    int8 codes.  ``metadata`` (a ``MetadataTable``, default the target's)
    enables ``filter_spec=``; ``lexical`` (``LexicalSlabs``, default the
    target's; brute f32 only) enables the lexical and hybrid modes.  Runs
    on the card unless ``device`` says otherwise.
    """

    def __init__(self, target, *, kind: str = "auto", k: int = 10,
                 nprobe_local: int = 2, headroom: float = 1.0, alive=None,
                 fused: bool = True, precision: str = "f32", metadata=None,
                 lexical=None, device=None):
        self.device = resolve(device)
        self.k = k
        self.fused = fused
        self.precision = precision
        self.nprobe_local = nprobe_local
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self._h_kernel = self.metrics.histogram("kernel_ms")
        self._h_rerank = self.metrics.histogram("rerank_ms")
        self._c_dispatches = self.metrics.counter("dispatches")
        # filter surface: the metadata snapshot pinned at placement and
        # the compiled mask operand per FilterSpec digest, both cleared
        # on every placement
        self.metadata_src = metadata
        self.lexical_src = lexical
        self._meta = None
        self._fmask_cache: dict = {}
        self._host_valid = None          # brute: placed valid, numpy bool
        self._host_bids = None           # ivf: placed bucket ids, numpy
        self._lex_args = None
        self._fn_lex = self._fn_hyb = None
        self._n = 0                      # real corpus rows last placed

        if kind == "auto":
            if isinstance(target, np.ndarray) or not hasattr(
                    target, "bucket_ids"):
                kind = "brute"
            elif getattr(target, "forest", None) is not None:
                kind = "forest"
            else:
                kind = "ivf"
        self.kind = kind
        if precision not in ("f32", "int8"):
            raise ValueError(
                f"precision must be 'f32' or 'int8', got {precision!r}")
        if precision == "int8" and kind != "brute":
            raise ValueError(
                "precision='int8' is only supported for the brute kind")
        if kind == "brute":
            n = int(np.shape(getattr(target, "db", target))[0])
            self._rows = int(np.ceil(n * headroom))
            self._fn = make_sharded_brute_fn(k, self._rows, fused=fused,
                                             precision=precision)
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
        if self.lexical_src is None:
            self.lexical_src = getattr(target, "lexical", None)
        if self.lexical_src is not None:
            if kind != "brute" or precision != "f32":
                raise ValueError(
                    "lexical slabs (lexical / hybrid modes) require "
                    "kind='brute', precision='f32'")
            self._fn_lex = make_sharded_lexical_fn(k, self._rows,
                                                   fused=fused)
            self._fn_hyb = make_sharded_hybrid_fn(k, self._rows, fused=fused)
        self._place(target, alive=alive)

    def _place(self, target, alive=None) -> None:
        """Pad and place ``target`` (and its slabs) on the device in the
        recorded shapes; pin the metadata the next filters will see."""
        with self._lock:
            dev = self.device
            if self.kind == "brute":
                db_host = np.asarray(getattr(target, "db", target),
                                     np.float32)
                self._n = n = db_host.shape[0]
                if self.precision == "int8":
                    self._args = _brute_int8_device_arrays(
                        db_host, dev, rows=self._rows, alive=alive)
                else:
                    self._args = _brute_device_arrays(
                        db_host, dev, rows=self._rows, alive=alive)
                self._host_valid = self._args[-1].cpu().numpy() != 0
                if self.lexical_src is not None:
                    slabs = self.lexical_src
                    if slabs.n_docs != n:
                        raise ValueError(
                            f"lexical slabs hold {slabs.n_docs} rows for a "
                            f"{n}-row corpus")
                    self._lex_args = _lexical_device_arrays(
                        slabs.terms, slabs.tf_sat, dev, rows=self._rows,
                        alive=alive)[:2]
            else:
                self._n = int(target.db.shape[0])
                self._args = _ivf_device_arrays(target, dev, cap=self._cap)
                self._host_bids = self._args[1].cpu().numpy()
            self._refresh_meta(target)

    def _refresh_meta(self, target) -> None:
        """Pin the metadata the next filtered queries see and drop every
        compiled mask (caller holds the lock)."""
        meta = (self.metadata_src if self.metadata_src is not None
                else getattr(target, "metadata", None))
        self._meta = meta.snapshot() if meta is not None else None
        self._fmask_cache.clear()

    def _filter_operand(self, filter_spec) -> torch.Tensor:
        """Compile a ``FilterSpec`` to this kind's mask operand, cached
        per digest until the next placement (caller holds the lock).

        brute (and lexical / hybrid): the entity mask ANDed into the
        placed ``valid`` row operand.  ivf: filtered entities' slots in
        ``bucket_ids`` set to -1, which the probe scan already skips.
        Same shapes and dtypes as the unfiltered operands.
        """
        key = filter_spec.key()
        hit = self._fmask_cache.get(key)
        if hit is not None:
            return hit
        if self.kind == "brute":
            emask = filter_spec.mask(self._meta, self._host_valid.shape[0])
            host = (self._host_valid & emask).astype(np.int32)
        else:
            emask = filter_spec.mask(self._meta, max(self._n, 1))
            b = self._host_bids
            live = (b >= 0) & emask[np.clip(b, 0, emask.shape[0] - 1)]
            host = np.where(live, b, -1).astype(np.int32)
        dev = torch.as_tensor(host, device=self.device)
        if len(self._fmask_cache) >= _MASK_CACHE:
            self._fmask_cache.clear()
        self._fmask_cache[key] = dev
        return dev

    def __call__(self, queries, *, filter_spec=None, mode: str = "semantic",
                 alpha: float = 0.5, q_terms=None, q_weights=None):
        """Search.  ``filter_spec`` (a ``FilterSpec``) restricts results to
        matching entities; ``mode`` is ``"semantic"`` (dense scan),
        ``"lexical"`` (BM25 over the postings slabs, ``queries`` unused) or
        ``"hybrid"`` (``alpha * l2sq - (1 - alpha) * bm25``).  The last two
        need a backend built with lexical slabs and per-query
        ``q_terms`` / ``q_weights`` (``core.lexical.query_operands``)."""
        tracer = get_tracer()
        if filter_spec is not None and filter_spec.empty:
            filter_spec = None
        if mode not in MODES:
            raise ValueError(
                f"mode must be 'semantic', 'lexical', or 'hybrid', "
                f"got {mode!r}")
        dev = self.device
        if mode != "semantic":
            if self._fn_lex is None:
                raise ValueError(
                    f"mode={mode!r} requires a backend built with lexical "
                    "slabs (kind='brute', lexical=...)")
            if q_terms is None or q_weights is None:
                raise ValueError(
                    f"mode={mode!r} requires q_terms/q_weights (see "
                    "repro_torch.core.lexical.query_operands)")
            qt = torch.as_tensor(np.asarray(q_terms, np.int32), device=dev)
            qw = torch.as_tensor(np.asarray(q_weights, np.float32),
                                 device=dev)
            B = int(qt.shape[0])
        if mode != "lexical":
            q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
            B = int(q.shape[0])
        t0 = time.perf_counter()
        # kernel: enqueue + device execution; the synchronise runs outside
        # the lock so the span measures device time, not the enqueue
        with tracer.span("kernel", kind=self.kind, b=B):
            with self._lock:
                args = self._args
                if filter_spec is not None:
                    fdev = self._filter_operand(filter_spec)
                    if self.kind == "brute":     # valid is the last operand
                        args = args[:-1] + (fdev,)
                    else:                        # ivf: bucket_ids
                        args = (args[0], fdev, args[2])
                if mode == "semantic":
                    d, i = self._fn(*args, q)
                elif mode == "lexical":
                    d, i = self._fn_lex(*self._lex_args, args[1], qt, qw)
                else:
                    # the blend is a (1, 1) operand on the card, read by
                    # the kernel
                    a_dev = torch.full((1, 1), float(alpha),
                                       dtype=torch.float32, device=dev)
                    d, i = self._fn_hyb(args[0], *self._lex_args, args[1],
                                        q, qt, qw, a_dev)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        t1 = time.perf_counter()
        # rerank: pull the merged top-k back to the host
        with tracer.span("rerank", kind=self.kind):
            out = d.cpu().numpy(), i.cpu().numpy()
        t2 = time.perf_counter()
        self._c_dispatches.inc()
        self._h_kernel.observe((t1 - t0) * 1e3)
        self._h_rerank.observe((t2 - t1) * 1e3)
        return out
