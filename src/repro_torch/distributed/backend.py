"""Sharded search as a ``ServingCell`` backend.

Port of ``repro/distributed/backend.py``: the brute, IVF and forest
kinds, with their filter, lexical, hybrid and int8 options and the
online update path.  The expensive work happens once, at construction:
pad the corpus or index tables (and the postings slabs) and place them
on the device.  The per-batch hot path is query placement, the per-shard
local (the CUDA kernels on the card) and the copy of the merged top-k
back to the host.

    cell = ServingCell.sharded(index, k=10, nprobe_local=32)   # on the card
    backend = ShardedSearchBackend(db, kind="brute")           # explicit
    backend(q, filter_spec=FilterSpec.range("pct", 0, 4))
    backend(q, mode="hybrid", alpha=0.5, q_terms=qt, q_weights=qw)

Over a ``DeviceMesh`` (``mesh=``, one process a card) each rank places
only its shard of the corpus or index (``axes``), scans its block of the
batch (``query_axes``), and the shards' top-k meet in an all-gather
(``sharding.MeshCollective``); every rank calls the backend with the same
arguments and gets the whole answer.  A served cell runs on the mesh's
root: the root's backend ``lead()``s, sending each call's header and
queries to the other ranks, which ``follow()`` until
``stop_followers()``.  Collectives are issued in one order on every rank:
one thread, under the backend lock.

Filters are data, not shapes: a ``FilterSpec`` compiles (once per
``key()``, until the next placement) to the brute kind's ``valid``
operand ANDed with the entity mask, or to the IVF and forest kinds'
``bucket_ids`` with filtered slots set to -1, and the same kernels scan it.

Online updates: :meth:`ShardedSearchBackend.apply_updates` re-places a
mutated corpus or index (``add_entities`` / ``delete_entities`` /
``refresh_forest`` / ``rebalance`` / ``reboost``) into the shapes
recorded at construction (``headroom`` > 1 reserves growth room; a
mutation that outgrows it raises and the caller rebuilds the backend).
With a manifest (``delta=target.pop_delta()``) only what it names is
shipped: appended rows and liveness flips for the brute kind, dirty
bucket rows for IVF, dirty bucket *slabs* for the forest kind (whose
tables reserve a fixed node and leaf window per bucket when
``delta_updates=True``).  The delta is a scatter into the placed tensors,
in place on the current stream under the backend lock: the tensors keep
their storage and nothing is allocated at a table's size.  It falls back
to a full re-place when the manifest cannot prove coverage (``version``),
is marked ``full``, or its payload exceeds ``delta_max_fraction`` of the
full re-place (``threshold``).  Every apply returns ``{"mode", "bytes",
"full_bytes", "reason"}``, counted as the reference counts them (a
liveness flag is one byte), and feeds the ``republished_bytes`` /
``republish_full_bytes`` / ``delta_applies`` / ``full_applies`` counters
and a ``republish.place`` span.

Telemetry: ``kernel_ms`` (queue and device execution of the search, up
to the stream synchronise) and ``rerank_ms`` (copy back to the host)
histograms, a ``dispatches`` counter, and ``kernel``/``rerank`` spans.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distributed.sharding import (
    MeshCollective,
    ShardSlot,
    _brute_device_arrays,
    _brute_int8_device_arrays,
    _check_disjoint,
    _forest_device_arrays,
    _ivf_device_arrays,
    _ivf_host_bids,
    _lexical_device_arrays,
    _pad_batch,
    _pad_terms,
    forest_shard_shapes,
    make_sharded_brute_fn,
    make_sharded_forest_fn,
    make_sharded_hybrid_fn,
    make_sharded_ivf_fn,
    make_sharded_lexical_fn,
    search_blocks,
    slice_forest_delta,
    slice_ivf_delta,
)
from repro_torch.kernels.ops import quantize_rows_int8
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["ShardedSearchBackend", "MODES"]

MODES = ("semantic", "lexical", "hybrid")
_MASK_CACHE = 64     # compiled filter operands kept per placement

# order of the forest kind's placed tables (the local's arguments before
# the queries)
_FOREST_ARGS = ("cents", "valid", "roots", "bucket_ids", "bvecs",
                "proj", "dims", "tau", "children", "leaf_row",
                "leaf_entities")


def _pow2(n: int) -> int:
    return max(1, 1 << (max(n, 1) - 1).bit_length())


class ShardedSearchBackend:
    """Callable ``queries (B, d) -> (dists (B, k), ids (B, k))``, numpy.

    ``target`` is either a raw ``(N, d)`` corpus (exact scan) or a built
    ``TwoLevelIndex`` (IVF for a brute bottom, the forest descent for a
    tree or QLBT bottom); ``kind="auto"`` picks accordingly.
    ``headroom`` > 1 reserves rows (brute), bucket width (IVF) or node and
    leaf room (forest) for an index that grows; ``alive`` (brute) masks
    tombstoned rows.  ``beam_width`` is the forest descent's beam.
    ``delta_updates`` (forest) lays the forest out in per-bucket slabs so
    that dirty buckets can be shipped alone; ``delta_max_fraction`` is the
    payload share of a full re-place past which a delta falls back to
    one.  ``fused=False`` runs the unfused plain ops instead of the
    kernels.  ``precision="int8"`` (brute, fused) scans per-row-scaled
    int8 codes.  ``metadata`` (a ``MetadataTable``, default the target's)
    enables ``filter_spec=``; ``lexical`` (``LexicalSlabs``, default the
    target's; brute f32 only) enables the lexical and hybrid modes.  Runs
    on the card unless ``device`` says otherwise.

    ``mesh`` (a ``DeviceMesh``) shards the target over its ``axes`` and
    the batch over ``query_axes`` (disjoint; the reference's defaults),
    one shard a rank, on this rank's device; every call is collective.
    ``stats`` of ``apply_updates`` count the whole payload, as the
    reference counts it at the same shard count.  ``shard`` (a
    ``ShardSlot``, no mesh) places one shard of such a layout with no
    collective: the single-process shard loop of ``repro_torch.testing``.
    """

    def __init__(self, target, *, kind: str = "auto", k: int = 10,
                 mesh=None, axes=("data", "model"), query_axes=(),
                 nprobe_local: int = 2, beam_width: int = 8,
                 headroom: float = 1.0, alive=None,
                 delta_updates: bool = True,
                 delta_max_fraction: float = 0.5,
                 fused: bool = True, precision: str = "f32", metadata=None,
                 lexical=None, device=None, shard: Optional[ShardSlot] = None):
        self.device = resolve(device, mesh)
        self.mesh = mesh
        self.axes, self.query_axes = tuple(axes), tuple(query_axes)
        if mesh is not None:
            self._coll = MeshCollective(mesh, self.axes, self.query_axes)
            self.slot = self._coll.slot
        else:
            _check_disjoint(self.axes, self.query_axes)
            self._coll = None
            self.slot = shard if shard is not None else ShardSlot()
        self.n_dev = self.slot.n_dev
        self._leading = False            # root of a mesh with followers
        self._stopped = False            # its followers were released
        self.k = k
        self.delta_updates = delta_updates
        self.delta_max_fraction = delta_max_fraction
        self.fused = fused
        self.precision = precision
        self.nprobe_local = nprobe_local
        self.beam_width = beam_width
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self._h_kernel = self.metrics.histogram("kernel_ms")
        self._h_rerank = self.metrics.histogram("rerank_ms")
        self._c_dispatches = self.metrics.counter("dispatches")
        self._c_repub = self.metrics.counter("republished_bytes")
        self._c_repub_full = self.metrics.counter("republish_full_bytes")
        self._c_delta = self.metrics.counter("delta_applies")
        self._c_full = self.metrics.counter("full_applies")
        # filter surface: the metadata snapshot pinned at placement and
        # the compiled mask operand per FilterSpec digest, both cleared
        # on every placement
        self.metadata_src = metadata
        self.lexical_src = lexical
        self._meta = None
        self._fmask_cache: dict = {}
        self._host_valid = None          # brute: placed valid, numpy bool
        self._host_bids = None           # ivf/forest: placed bucket ids
        self._lex_args = None
        self._fn_lex = self._fn_hyb = None
        self._n = 0                      # real corpus rows last placed
        self._version: Optional[int] = None
        self._full_bytes = 0             # bytes of a full re-place
        self.last_republish: Optional[dict] = None

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
            # rows a shard: the reservation split over the shards
            self._rows = -(-int(np.ceil(n * headroom)) // self.n_dev)
            self._fn = make_sharded_brute_fn(k, self._rows, fused=fused,
                                             precision=precision)
        elif kind == "ivf":
            n_buckets, cap = target.bucket_ids.shape
            self._K = int(n_buckets)
            self._cap = int(np.ceil(cap * headroom))
            self._kloc = -(-self._K // self.n_dev)     # buckets a shard
            self._fn = make_sharded_ivf_fn(k, nprobe_local, self._kloc,
                                           self._K, fused=fused)
        elif kind == "forest":
            self._shapes = forest_shard_shapes(
                target, self.n_dev, headroom,
                layout="slab" if delta_updates else "packed")
            self._fn = make_sharded_forest_fn(
                k, nprobe_local, beam_width, self._shapes.leaf_sz,
                self._shapes.max_depth, fused=fused)
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
        with self._lock:
            self._place(target, alive=alive)

    # -- counters ------------------------------------------------------
    @property
    def republished_bytes(self) -> int:
        """Cumulative bytes shipped by applies."""
        return self._c_repub.value

    @property
    def republish_full_bytes(self) -> int:
        """What full re-places would have cost."""
        return self._c_repub_full.value

    @property
    def n_delta_applies(self) -> int:
        return self._c_delta.value

    @property
    def n_full_applies(self) -> int:
        return self._c_full.value

    # ------------------------------------------------------------------
    def _place(self, target, alive=None) -> None:
        """Pad and place ``target`` (and its slabs) on the device in the
        recorded shapes; pin the metadata the next filters will see
        (caller holds the lock)."""
        dev, lin, S = self.device, self.slot.lin, self.n_dev
        if self.kind == "brute":
            db_host = np.asarray(getattr(target, "db", target), np.float32)
            self._n = n = db_host.shape[0]
            rows_all = self._rows * S
            if self.precision == "int8":
                *self._args, valid = _brute_int8_device_arrays(
                    db_host, dev, rows=self._rows, alive=alive, lin=lin,
                    n_dev=S)
                # int8 codes, fp32 scales, a one-byte liveness flag a row
                self._full_bytes = rows_all * (db_host.shape[1] + 4 + 1)
            else:
                *self._args, valid = _brute_device_arrays(
                    db_host, dev, rows=self._rows, alive=alive, lin=lin,
                    n_dev=S)
                self._full_bytes = rows_all * (4 * db_host.shape[1] + 1)
            self._args = tuple(self._args)
            self._host_valid = valid != 0        # every shard's rows
            if self.lexical_src is not None:
                slabs = self.lexical_src
                if slabs.n_docs != n:
                    raise ValueError(
                        f"lexical slabs hold {slabs.n_docs} rows for a "
                        f"{n}-row corpus; append_docs must track "
                        "add_entities")
                self._lex_args = _lexical_device_arrays(
                    slabs.terms, slabs.tf_sat, dev, rows=self._rows,
                    lin=lin, n_dev=S)
                self._full_bytes += S * sum(int(t.nbytes)
                                            for t in self._lex_args)
        elif self.kind == "ivf":
            if int(target.bucket_ids.shape[0]) != self._K:
                raise ValueError(
                    f"cluster count changed ({target.bucket_ids.shape[0]} "
                    f"!= {self._K}); rebuild the backend")
            self._n = int(target.db.shape[0])
            *self._args, self._host_bids = _ivf_device_arrays(
                target, dev, cap=self._cap, lin=lin, n_dev=S)
            self._args = tuple(self._args)
            self._full_bytes = S * sum(int(t.nbytes) for t in self._args)
        else:
            placed, host = _forest_device_arrays(target, dev,
                                                 shapes=self._shapes,
                                                 lin=lin, n_dev=S)
            self._n = int(target.db.shape[0])
            self._args = tuple(placed[name] for name in _FOREST_ARGS)
            # every shard's tables have this shard's shapes
            self._full_bytes = S * sum(int(host[name].nbytes)
                                       for name in _FOREST_ARGS)
            sh = self._shapes
            self._host_bids = _ivf_host_bids(target, sh.cap, S).reshape(
                S, sh.kloc, sh.cap)
        self._version = getattr(target, "mutation_version", None)
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
        placed ``valid`` row operand.  ivf / forest: filtered entities'
        slots in ``bucket_ids`` set to -1, which the scan already skips.
        Same shapes and dtypes as the unfiltered operands.  The mask is
        compiled over every shard and this rank's slice is placed.
        """
        key = filter_spec.key()
        hit = self._fmask_cache.get(key)
        if hit is not None:
            return hit
        lin = self.slot.lin
        if self.kind == "brute":
            emask = filter_spec.mask(self._meta, self._host_valid.shape[0])
            host = (self._host_valid & emask).astype(np.int32)
            host = host[lin * self._rows:(lin + 1) * self._rows]
        else:
            emask = filter_spec.mask(self._meta, max(self._n, 1))
            b = self._host_bids
            live = (b >= 0) & emask[np.clip(b, 0, emask.shape[0] - 1)]
            host = np.where(live, b, -1).astype(np.int32)
            host = (host[lin * self._kloc:(lin + 1) * self._kloc]
                    if self.kind == "ivf" else host[lin:lin + 1])
        dev = torch.as_tensor(host, device=self.device)
        if len(self._fmask_cache) >= _MASK_CACHE:
            self._fmask_cache.clear()
        self._fmask_cache[key] = dev
        return dev

    # ------------------------------------------------------------------
    # delta apply: in-place scatters into the placed tensors
    # ------------------------------------------------------------------
    def _bucket_payload_bytes(self) -> int:
        """Exact payload of one dirty bucket (every slab and row shape is
        fixed), so an over-threshold manifest is refused before its
        slices are cut."""
        if self.kind == "ivf":
            d = int(self._args[0].shape[1])
            return 4 * (d + self._cap + self._cap * d + 1)
        sh = self._shapes
        d = int(self._args[0].shape[2])
        ns, ls = sh.node_slab, sh.leaf_slab
        return (4 * (ns * d + ns + ns + ns * 2 + ns      # node tables
                     + ls * sh.leaf_sz                   # leaf slab
                     + 1 + d + sh.cap + sh.cap * d       # bucket row
                     + 2)                                # shard/slot
                + 1)                                     # valid flag

    def _delta_payload(self, target, alive, delta):
        """Host payload for the manifest, or (None, reason) when the delta
        path cannot cover this update."""
        if self.kind == "brute":
            if delta.dirty_buckets.size:
                return None, "bucket-delta-on-flat-corpus"
            if delta.base_n > self._n:
                return None, "version"
            if (self._version is not None
                    and delta.base_version > self._version):
                # a gap in the manifest chain means missed tombstones
                return None, "version"
            db = np.asarray(getattr(target, "db", target), np.float32)
            n = db.shape[0]
            if n > self._rows * self.n_dev:
                return None, "outgrew"        # the full place raises
            new = np.arange(delta.base_n, n, dtype=np.int32)
            vals = db[delta.base_n:n]
            pay = {"rows": new, "n": n}
            if self.precision == "int8":
                pay["vals8"], pay["vscales"] = quantize_rows_int8(vals)
                vals_bytes = int(pay["vals8"].nbytes + pay["vscales"].nbytes)
            else:
                pay["vals"] = vals
                vals_bytes = int(vals.nbytes)
            if self._lex_args is not None:
                slabs = self.lexical_src
                if slabs is None or slabs.n_docs != n:
                    return None, "lexical-misaligned"
                pay["lex_terms"] = np.asarray(slabs.terms[delta.base_n:n],
                                              np.int32)
                pay["lex_tf"] = np.asarray(slabs.tf_sat[delta.base_n:n],
                                           np.float32)
                # counted as the reference ships them: padded to a power
                # of two of rows
                vals_bytes += (_pow2(new.size) * 4
                               * (pay["lex_terms"].shape[1]
                                  + pay["lex_tf"].shape[1]))
            if alive is not None:
                # the caller's complete liveness truth: the whole mask is
                # the payload
                valid = np.arange(self._rows * self.n_dev) < n
                valid[:n] &= np.asarray(alive, bool)
                if delta.tombstones.size:
                    valid[delta.tombstones] = False
                pay["valid"] = valid
                pay["bytes"] = int(vals_bytes + new.nbytes + valid.size)
            else:
                # appends and tombstones ship two index vectors; the
                # placed mask keeps the bits of earlier windows
                pay["tomb"] = np.asarray(delta.tombstones, np.int32)
                pay["bytes"] = int(vals_bytes + new.nbytes
                                   + pay["tomb"].nbytes)
            return pay, None
        if self._version is None or delta.base_version > self._version:
            return None, "version"
        if self.kind == "ivf":
            if int(target.bucket_ids.shape[0]) != self._K:
                return None, "outgrew"
            pay = slice_ivf_delta(target, self._cap, delta.dirty_buckets)
            pay["bytes"] = sum(int(v.nbytes) for v in pay.values())
            pay["n"] = int(target.db.shape[0])
            return pay, None
        if not self.delta_updates:
            return None, "packed-layout"
        pay = slice_forest_delta(target, self._shapes, delta.dirty_buckets)
        pay["bytes"] = sum(int(np.asarray(v).nbytes) for v in pay.values())
        pay["n"] = int(target.db.shape[0])
        return pay, None

    def _put(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t if dtype is None else t.to(dtype)

    def _mine(self, rows: np.ndarray, per_shard: int):
        """(mask of ``rows`` on this rank's shard, their local indices as
        a device tensor): global row or bucket ``r`` lives on shard
        ``r // per_shard``."""
        rows = np.asarray(rows)
        mine = rows // per_shard == self.slot.lin
        return mine, self._put(rows[mine] - self.slot.lin * per_shard,
                               torch.long)

    def _apply_lex_delta(self, pay, mine, rows) -> None:
        """Scatter appended postings-slab rows next to their vectors."""
        if self._lex_args is None or "lex_terms" not in pay:
            return
        self._lex_args[0][rows] = self._put(pay["lex_terms"][mine])
        self._lex_args[1][rows] = self._put(pay["lex_tf"][mine])

    def _apply_delta(self, pay) -> None:
        """Scatter this rank's part of the payload into the placed
        tensors, in place (caller holds the lock); the host mirrors the
        filters read cover every shard."""
        if self.kind == "brute":
            R = self._rows
            mine, rows = self._mine(pay["rows"], R)
            if self.precision == "int8":
                codes, scales, valid = self._args
                codes[rows] = self._put(pay["vals8"][mine])
                scales[rows] = self._put(pay["vscales"][mine])
            else:
                db, valid = self._args
                db[rows] = self._put(pay["vals"][mine])
                self._apply_lex_delta(pay, mine, rows)
            if "valid" in pay:
                lo = self.slot.lin * R
                valid.copy_(self._put(pay["valid"][lo:lo + R], torch.int32))
                self._host_valid = np.asarray(pay["valid"], bool).copy()
            else:
                # liveness is cumulative on the device: appended rows flip
                # alive, tombstones dead, the rest keep their bits
                valid[rows] = 1
                valid[self._mine(pay["tomb"], R)[1]] = 0
                self._mirror_brute_liveness(pay)
        elif self.kind == "ivf":
            mine, rows = self._mine(pay["rows"], self._kloc)
            cents, bids, bvecs = self._args
            cents[rows] = self._put(pay["cents"][mine])
            bids[rows] = self._put(pay["bucket_ids"][mine])
            bvecs[rows] = self._put(pay["bvecs"][mine])
            self._host_bids[pay["rows"]] = pay["bucket_ids"]
        else:
            # a slab on another shard (or past the last) is not this
            # rank's; the placed tables keep the shard dimension, length 1
            shard = np.asarray(pay["shard"])
            mine = shard == self.slot.lin
            if mine.any():
                sl = self._put(pay["slot"][mine], torch.long)
                sh = torch.zeros_like(sl)
                ns, ls = self._shapes.node_slab, self._shapes.leaf_slab
                nrow = (sl[:, None] * ns
                        + torch.arange(ns, device=self.device)[None, :])
                lrow = (sl[:, None] * ls
                        + torch.arange(ls, device=self.device)[None, :])
                t = dict(zip(_FOREST_ARGS, self._args))
                for name in ("cents", "valid", "roots", "bucket_ids",
                             "bvecs"):
                    t[name][sh, sl] = self._put(pay[name][mine])
                for name in ("proj", "dims", "tau", "children", "leaf_row"):
                    t[name][sh[:, None], nrow] = self._put(pay[name][mine])
                t["leaf_entities"][sh[:, None], lrow] = self._put(
                    pay["leaf_entities"][mine])
            ok = shard < self.n_dev
            if ok.any():
                self._host_bids[shard[ok], pay["slot"][ok]] = \
                    pay["bucket_ids"][ok]
        self._n = pay["n"]

    def _mirror_brute_liveness(self, pay) -> None:
        """Replay the device liveness flips on the host mirror the filter
        compiler reads (appends flip alive, tombstones flip dead)."""
        self._host_valid[pay["rows"]] = True
        self._host_valid[pay["tomb"]] = False

    # ------------------------------------------------------------------
    def apply_updates(self, target, alive=None, delta=None) -> dict:
        """Serve a mutated corpus or index.

        With ``delta`` (a :class:`repro_torch.core.delta.DeltaManifest`,
        e.g. from ``target.pop_delta()``): scatter only the manifest's
        dirty slices into the placed tensors, in place, falling back to a
        full re-place whenever the manifest cannot prove coverage or its
        payload is no cheaper than bulk.  Without ``delta``: re-pad and
        re-place everything into the shapes recorded at construction.
        Either way raises ``ValueError`` when the mutation outgrew the
        reservation (rebuild the backend with more ``headroom``).
        ``alive`` (brute kind only) marks tombstoned corpus rows.

        Returns ``{"mode", "bytes", "full_bytes", "reason"}``: ``mode`` is
        ``"delta"``, ``"full"`` or ``"noop"``; ``bytes`` is what was
        shipped; ``full_bytes`` is what a full re-place ships.
        """
        with get_tracer().span("republish.place", kind=self.kind) as sp:
            with self._lock:
                stats = self._apply_locked(target, alive, delta)
                self.last_republish = stats
            self._c_repub.inc(stats["bytes"])
            self._c_repub_full.inc(stats["full_bytes"])
            if stats["mode"] == "delta":
                self._c_delta.inc()
            elif stats["mode"] == "full":
                self._c_full.inc()
            sp.set(mode=stats["mode"], bytes=stats["bytes"])
        return stats

    def _apply_locked(self, target, alive, delta) -> dict:
        reason = None
        if delta is None:
            reason = "no-manifest"
        elif delta.full:
            reason = "manifest-full"
        else:
            covered = (self._version is not None
                       and delta.base_version <= self._version)
            if delta.empty and (covered or self.kind == "brute"):
                self._version = delta.version
                self._refresh_meta(target)
                return {"mode": "noop", "bytes": 0,
                        "full_bytes": self._full_bytes, "reason": None}
            if (self.kind in ("ivf", "forest") and self.delta_updates
                    and delta.dirty_buckets.size * self._bucket_payload_bytes()
                    > self.delta_max_fraction * self._full_bytes):
                # the payload size is exact up front: don't cut the slices
                # of a delta that can't win
                reason = "threshold"
            else:
                pay, reason = self._delta_payload(target, alive, delta)
            if reason is None:
                if pay["bytes"] > self.delta_max_fraction * self._full_bytes:
                    reason = "threshold"
                else:
                    self._apply_delta(pay)
                    self._version = delta.version
                    self._refresh_meta(target)
                    return {"mode": "delta", "bytes": pay["bytes"],
                            "full_bytes": self._full_bytes, "reason": None}
        self._place(target, alive=alive)
        return {"mode": "full", "bytes": self._full_bytes,
                "full_bytes": self._full_bytes, "reason": reason}

    def __call__(self, queries, *, filter_spec=None, mode: str = "semantic",
                 alpha: float = 0.5, q_terms=None, q_weights=None):
        """Search.  ``filter_spec`` (a ``FilterSpec``) restricts results to
        matching entities; ``mode`` is ``"semantic"`` (dense scan),
        ``"lexical"`` (BM25 over the postings slabs, ``queries`` unused) or
        ``"hybrid"`` (``alpha * l2sq - (1 - alpha) * bm25``).  The last two
        need a backend built with lexical slabs and per-query
        ``q_terms`` / ``q_weights`` (``core.lexical.query_operands``).
        Over a mesh the call is collective (or, on a leading root, sent to
        the followers first)."""
        if filter_spec is not None and filter_spec.empty:
            filter_spec = None
        if mode not in MODES:
            raise ValueError(
                f"mode must be 'semantic', 'lexical', or 'hybrid', "
                f"got {mode!r}")
        if mode != "semantic":
            if self._fn_lex is None:
                raise ValueError(
                    f"mode={mode!r} requires a backend built with lexical "
                    "slabs (kind='brute', lexical=...)")
            if q_terms is None or q_weights is None:
                raise ValueError(
                    f"mode={mode!r} requires q_terms/q_weights (see "
                    "repro_torch.core.lexical.query_operands)")
        ops, B = self._operands(queries, q_terms, q_weights, mode,
                                self.slot.n_q)
        return self._search(ops, B, filter_spec, mode, alpha)

    def _operands(self, queries, q_terms, q_weights, mode: str, n_q: int):
        """The per-query operands of ``mode`` -- queries (float32), term
        ids (int32, pads -1), term weights -- padded on the host to a
        multiple of ``n_q`` rows and placed; and the batch size B."""
        host = []
        if mode != "lexical":
            host.append(_pad_batch(queries, n_q))
        if mode != "semantic":
            host.extend(_pad_terms(q_terms, q_weights, n_q))
        B = len(queries) if mode != "lexical" else len(q_terms)
        return tuple(torch.as_tensor(h, device=self.device)
                     for h in host), B

    def _local(self, filter_spec, mode: str, alpha: float):
        """This shard's local for one option set: ``call(*operand
        block) -> (B, k)`` top-k with global ids (caller holds the lock,
        or owns the backend)."""
        args = self._args
        if filter_spec is not None:
            fdev = self._filter_operand(filter_spec)
            if self.kind == "brute":             # valid is the last operand
                args = args[:-1] + (fdev,)
            elif self.kind == "ivf":             # bucket_ids
                args = (args[0], fdev, args[2])
            else:                                # forest: bucket_ids
                args = args[:3] + (fdev,) + args[4:]
        lin = self.slot.lin
        if mode == "semantic":
            return lambda q: self._fn(*args, q, lin=lin)
        if mode == "lexical":
            return lambda qt, qw: self._fn_lex(*self._lex_args, args[1], qt,
                                               qw, lin=lin)
        # the blend is a (1, 1) operand on the card, read by the kernel
        a_dev = torch.full((1, 1), float(alpha), dtype=torch.float32,
                           device=self.device)
        return lambda q, qt, qw: self._fn_hyb(
            args[0], *self._lex_args, args[1], q, qt, qw, a_dev, lin=lin)

    def _search(self, ops, B: int, filter_spec, mode: str, alpha: float):
        tracer = get_tracer()
        dev = self.device
        t0 = time.perf_counter()
        # kernel: enqueue + device execution; the synchronise runs outside
        # the lock so the span measures device time, not the enqueue
        with tracer.span("kernel", kind=self.kind, b=B):
            with self._lock:
                if self._stopped:
                    raise RuntimeError("this backend released its followers "
                                       "(stop_followers); its collectives "
                                       "would wait for them")
                # compiled before the followers hear of the call: a
                # request that fails to compile fails on the root alone
                call = self._local(filter_spec, mode, alpha)
                if self._leading:
                    self._send({"stop": False, "B": B, "mode": mode,
                                "alpha": alpha, "filter": filter_spec,
                                "operands": [(tuple(o.shape), o.dtype)
                                             for o in ops]}, ops)
                d, i = search_blocks(call, ops, B, self.k, self.slot,
                                     self._coll)
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

    # ------------------------------------------------------------------
    # serving across ranks: the root leads, the other ranks follow
    # ------------------------------------------------------------------
    @property
    def leads(self) -> bool:
        """True while this root backend sends its calls to followers."""
        return self._leading

    def lead(self) -> "ShardedSearchBackend":
        """Make this backend, on the mesh's root rank, send every call's
        header (B, mode, alpha, filter) and operands to the other ranks,
        which run :meth:`follow`.  A mesh of one rank has no followers."""
        if self._coll is None or self._coll.size == 1:
            return self
        if not self._coll.root:
            raise RuntimeError("only the mesh's root rank leads; the other "
                               "ranks follow()")
        self._leading = True
        return self

    def _send(self, header: dict, ops=()) -> None:
        """Broadcast a call from the root (caller holds the lock)."""
        self._coll.broadcast_object(header)
        for o in ops:
            self._coll.broadcast(o)

    def follow(self) -> int:
        """Serve the root's calls on a non-root rank: receive each call's
        header and operands and join its collectives, until the root's
        :meth:`stop_followers`.  Returns the calls served.  A follower
        waits in a broadcast, so a root idle past the group's timeout
        fails its followers."""
        if self._coll is None or self._coll.root:
            raise RuntimeError("follow() runs on the non-root ranks of a "
                               "mesh")
        served = 0
        while True:
            h = self._coll.broadcast_object(None)
            if h["stop"]:
                return served
            ops = tuple(self._coll.broadcast(
                torch.empty(shape, dtype=dtype, device=self.device))
                for shape, dtype in h["operands"])
            with self._lock:
                search_blocks(self._local(h["filter"], h["mode"],
                                          h["alpha"]),
                              ops, h["B"], self.k, self.slot, self._coll)
            served += 1

    def stop_followers(self) -> None:
        """End the followers' :meth:`follow` loops (a no-op unless this
        backend leads)."""
        with self._lock:
            if self._leading:
                self._send({"stop": True})
                self._leading, self._stopped = False, True
