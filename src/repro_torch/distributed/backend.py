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
under the backend lock.  An update on a leading root sends each follower
its share (below), and a root that has made no call for a quarter of its
groups' timeout sends a heartbeat the followers skip, so an idle root
does not fail them; a dead one still does, after the timeout.

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
and a ``republish.place`` span.  Across ranks the root cuts every rank's
part: a follower receives only its rows, buckets or slabs of the delta
(or its shard, for a full re-place), point to point, with the index
mirrors the filter compiler reads and the appended metadata rows in the
broadcast header; a rank that fails its part fails the update on every
rank, and the backend then refuses to serve.

On the card each backend runs on a CUDA stream of its own, searches and
scatters alike (under its lock), so that one backend's synchronise does
not wait for another's kernels when several share a card.

Telemetry: ``kernel_ms`` (queue and device execution of the search, up
to the stream synchronise) and ``rerank_ms`` (copy back to the host)
histograms, a ``dispatches`` counter, and ``kernel``/``rerank`` spans.
The first call of each dispatch signature (mode, padded operand shape,
dtype) pays the one-time costs: it feeds the ``compile_signatures``
counter, the ``first_call_ms`` histogram and a ``compile-signature``
instant.  ``jit_cache_size`` and ``delta_cache_size`` count the compiled
variants the recompile gate (``repro_torch.analysis``) watches, and
``roofline_report`` puts the measured kernel time beside the analytic
bytes of one dispatch.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.annotations import guarded_by
from repro_torch.core.metadata import MetadataTable
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
from repro_torch.kernels import _build
from repro_torch.kernels.ops import quantize_rows_int8
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = ["ShardedSearchBackend", "MODES"]

MODES = ("semantic", "lexical", "hybrid")
_MASK_CACHE = 64     # compiled filter operands kept per placement
# a leading root idle for this share of its groups' timeout sends a
# heartbeat (every second where the timeout cannot be read)
_HEARTBEAT_SHARE = 0.25
_HEARTBEAT_UNKNOWN_S = 1.0

# order of the forest kind's placed tables (the local's arguments before
# the queries)
_FOREST_ARGS = ("cents", "valid", "roots", "bucket_ids", "bvecs",
                "proj", "dims", "tau", "children", "leaf_row",
                "leaf_entities")


def _pow2(n: int) -> int:
    return max(1, 1 << (max(n, 1) - 1).bit_length())


def _scatter_signature(kind: str, part: dict) -> tuple:
    """The shape bucket of one delta scatter, as the reference's jitted
    scatter pads it: each index vector's length to a power of two (the
    brute kind's whole-mask liveness is one fixed shape)."""
    if kind == "brute":
        live = ("valid" if "valid" in part
                else _pow2(np.asarray(part["tomb"]).size))
        return kind, _pow2(np.asarray(part["rows"]).size), live
    key = "rows" if kind == "ivf" else "slot"
    return kind, _pow2(np.asarray(part[key]).size)


def _nbytes(obj) -> int:
    """Bytes of the arrays in a (nested) update message."""
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return int(obj.nbytes) if isinstance(obj, np.ndarray) else 0


def _meta_message(old, new):
    """What a follower needs to turn its metadata snapshot (equal to
    ``old``) into ``new``: the appended rows when ``new`` extends ``old``
    (the table is append-only), else the whole table; None without one."""
    if new is None:
        return None
    cols = {c: new.column(c) for c in new.column_names}
    if (old is not None and old.column_names == new.column_names
            and old.n_rows <= new.n_rows
            and all(np.array_equal(cols[c][:old.n_rows], old.column(c))
                    for c in cols)):
        return {"append": {c: v[old.n_rows:] for c, v in cols.items()}}
    return {"table": cols}


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
        self._h_first = self.metrics.histogram("first_call_ms", lo=1e-2,
                                               hi=1e7)
        self._c_dispatches = self.metrics.counter("dispatches")
        self._c_sigs = self.metrics.counter("compile_signatures")
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
        # compiled variants: the dispatch signatures already served (the
        # first call of each paid the one-time costs), the placements that
        # changed the device tables' shapes, the pow2-bucketed scatter
        # shapes of the deltas applied, and the kernel libraries loaded
        # before this backend existed
        self._seen_sigs: set = set()
        self._table_shapes: Optional[tuple] = None
        self._reshapes = 0
        self._delta_sigs: set = set()
        self._libs0 = _build.loaded()
        # the card: one stream a backend, for searches and scatters alike
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # across ranks: the root's heartbeat, the bytes its last update
        # sent each follower, a follower's record of the updates it took,
        # and the reason this backend refuses to serve after a failed one
        self._beat: Optional[threading.Thread] = None
        self._beat_stop = threading.Event()
        self._beat_s: Optional[float] = None
        self._last_send = time.monotonic()
        self.beats = 0                   # heartbeats sent or skipped
        self.last_fanout: Optional[dict] = None
        self.updates: list = []
        self._failed: Optional[str] = None

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
        with self._lock, self._on_stream():
            self._place(target, alive=alive)
            self._sync()

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
    def _on_stream(self):
        """This backend's stream as the current one (the card), or
        nothing (the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        """Wait for this backend's device work."""
        if self._stream is not None:
            self._stream.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _tables(self, target, alive, lin: int, device) -> dict:
        """Shard ``lin`` of ``target`` padded into the recorded shapes and
        placed on ``device``: ``{"args", "lex", "mirror", "n",
        "full_bytes"}``, ``mirror`` the host copy of every shard's
        ``valid`` (brute) or bucket ids (ivf / forest) that filters
        compile against."""
        S = self.n_dev
        lex = None
        if self.kind == "brute":
            db_host = np.asarray(getattr(target, "db", target), np.float32)
            n = db_host.shape[0]
            rows_all = self._rows * S
            if self.precision == "int8":
                *args, valid = _brute_int8_device_arrays(
                    db_host, device, rows=self._rows, alive=alive, lin=lin,
                    n_dev=S)
                # int8 codes, fp32 scales, a one-byte liveness flag a row
                full = rows_all * (db_host.shape[1] + 4 + 1)
            else:
                *args, valid = _brute_device_arrays(
                    db_host, device, rows=self._rows, alive=alive, lin=lin,
                    n_dev=S)
                full = rows_all * (4 * db_host.shape[1] + 1)
            mirror = valid != 0                  # every shard's rows
            if self.lexical_src is not None:
                slabs = self.lexical_src
                if slabs.n_docs != n:
                    raise ValueError(
                        f"lexical slabs hold {slabs.n_docs} rows for a "
                        f"{n}-row corpus; append_docs must track "
                        "add_entities")
                lex = _lexical_device_arrays(
                    slabs.terms, slabs.tf_sat, device, rows=self._rows,
                    lin=lin, n_dev=S)
                full += S * sum(int(t.nbytes) for t in lex)
        elif self.kind == "ivf":
            if int(target.bucket_ids.shape[0]) != self._K:
                raise ValueError(
                    f"cluster count changed ({target.bucket_ids.shape[0]} "
                    f"!= {self._K}); rebuild the backend")
            n = int(target.db.shape[0])
            *args, mirror = _ivf_device_arrays(target, device, cap=self._cap,
                                               lin=lin, n_dev=S)
            full = S * sum(int(t.nbytes) for t in args)
        else:
            placed, host = _forest_device_arrays(target, device,
                                                 shapes=self._shapes,
                                                 lin=lin, n_dev=S)
            n = int(target.db.shape[0])
            args = [placed[name] for name in _FOREST_ARGS]
            # every shard's tables have this shard's shapes
            full = S * sum(int(host[name].nbytes) for name in _FOREST_ARGS)
            sh = self._shapes
            mirror = _ivf_host_bids(target, sh.cap, S).reshape(
                S, sh.kloc, sh.cap)
        return {"args": tuple(args), "lex": lex, "mirror": mirror, "n": n,
                "full_bytes": full}

    @guarded_by("_lock")
    def _install(self, t: dict) -> None:
        """Make ``t`` (``_tables``' result; host arrays as a follower
        receives them) the placed tables (caller holds the lock)."""
        self._args = tuple(self._put(a) for a in t["args"])
        self._lex_args = (None if t["lex"] is None
                          else tuple(self._put(a) for a in t["lex"]))
        shapes = tuple((tuple(a.shape), str(a.dtype))
                       for a in self._args + (self._lex_args or ()))
        if self._table_shapes is not None and shapes != self._table_shapes:
            self._reshapes += 1
        self._table_shapes = shapes
        if self.kind == "brute":
            self._host_valid = t["mirror"]
        else:
            self._host_bids = t["mirror"]
        self._n, self._full_bytes = t["n"], t["full_bytes"]

    @guarded_by("_lock")
    def _place(self, target, alive=None) -> None:
        """Pad and place ``target`` (and its slabs) on the device in the
        recorded shapes; pin the metadata the next filters will see
        (caller holds the lock)."""
        self._install(self._tables(target, alive, self.slot.lin,
                                   self.device))
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
        a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        t = torch.as_tensor(a, device=self.device)
        return t if dtype is None else t.to(dtype)

    def _cut(self, pay: dict, lin: int) -> dict:
        """Shard ``lin``'s part of a delta payload: its rows, buckets or
        slabs, at local indices (what that rank scatters, and all it is
        sent)."""
        if self.kind == "brute":
            R = self._rows
            rows = np.asarray(pay["rows"])
            mine = rows // R == lin
            out = {"rows": rows[mine] - lin * R}
            for key in ("vals", "vals8", "vscales", "lex_terms", "lex_tf"):
                if key in pay:
                    out[key] = pay[key][mine]
            if "valid" in pay:
                out["valid"] = pay["valid"][lin * R:(lin + 1) * R]
            else:
                tomb = np.asarray(pay["tomb"])
                out["tomb"] = tomb[tomb // R == lin] - lin * R
            return out
        if self.kind == "ivf":
            rows = np.asarray(pay["rows"])
            mine = rows // self._kloc == lin
            out = {name: pay[name][mine]
                   for name in ("cents", "bucket_ids", "bvecs")}
            out["rows"] = rows[mine] - lin * self._kloc
            return out
        mine = np.asarray(pay["shard"]) == lin
        return {name: np.asarray(pay[name])[mine]
                for name in ("slot",) + _FOREST_ARGS}

    def _mirror_part(self, pay: dict) -> dict:
        """The payload's index vectors over every shard, which the host
        mirrors the filter compiler reads need."""
        if self.kind == "brute":
            if "valid" in pay:
                return {"valid": pay["valid"]}
            return {"rows": pay["rows"], "tomb": pay["tomb"]}
        if self.kind == "ivf":
            return {"rows": pay["rows"], "bucket_ids": pay["bucket_ids"]}
        return {"shard": pay["shard"], "slot": pay["slot"],
                "bucket_ids": pay["bucket_ids"]}

    @guarded_by("_lock")
    def _scatter(self, part: dict) -> None:
        """Scatter this rank's part (``_cut``) into the placed tensors, in
        place (caller holds the lock, on this backend's stream)."""
        self._delta_sigs.add(_scatter_signature(self.kind, part))
        if self.kind == "brute":
            rows = self._put(part["rows"], torch.long)
            if self.precision == "int8":
                codes, scales, valid = self._args
                codes[rows] = self._put(part["vals8"])
                scales[rows] = self._put(part["vscales"])
            else:
                db, valid = self._args
                db[rows] = self._put(part["vals"])
                if self._lex_args is not None and "lex_terms" in part:
                    self._lex_args[0][rows] = self._put(part["lex_terms"])
                    self._lex_args[1][rows] = self._put(part["lex_tf"])
            if "valid" in part:
                valid.copy_(self._put(part["valid"], torch.int32))
            else:
                # liveness is cumulative on the device: appended rows flip
                # alive, tombstones dead, the rest keep their bits
                valid[rows] = 1
                valid[self._put(part["tomb"], torch.long)] = 0
        elif self.kind == "ivf":
            rows = self._put(part["rows"], torch.long)
            cents, bids, bvecs = self._args
            cents[rows] = self._put(part["cents"])
            bids[rows] = self._put(part["bucket_ids"])
            bvecs[rows] = self._put(part["bvecs"])
        elif part["slot"].size:
            # the placed tables keep the shard dimension, length 1
            sl = self._put(part["slot"], torch.long)
            sh = torch.zeros_like(sl)
            ns, ls = self._shapes.node_slab, self._shapes.leaf_slab
            nrow = (sl[:, None] * ns
                    + torch.arange(ns, device=self.device)[None, :])
            lrow = (sl[:, None] * ls
                    + torch.arange(ls, device=self.device)[None, :])
            t = dict(zip(_FOREST_ARGS, self._args))
            for name in ("cents", "valid", "roots", "bucket_ids", "bvecs"):
                t[name][sh, sl] = self._put(part[name])
            for name in ("proj", "dims", "tau", "children", "leaf_row"):
                t[name][sh[:, None], nrow] = self._put(part[name])
            t["leaf_entities"][sh[:, None], lrow] = self._put(
                part["leaf_entities"])

    @guarded_by("_lock")
    def _mirror_update(self, m: dict) -> None:
        """Replay a payload's index vectors (``_mirror_part``) on the host
        mirrors of every shard."""
        if self.kind == "brute":
            if "valid" in m:
                self._host_valid = np.asarray(m["valid"], bool).copy()
            else:
                self._host_valid[m["rows"]] = True
                self._host_valid[m["tomb"]] = False
        elif self.kind == "ivf":
            self._host_bids[m["rows"]] = m["bucket_ids"]
        else:
            shard, slot = np.asarray(m["shard"]), np.asarray(m["slot"])
            ok = shard < self.n_dev          # past the last shard: no slab
            if ok.any():
                self._host_bids[shard[ok], slot[ok]] = \
                    np.asarray(m["bucket_ids"])[ok]

    @guarded_by("_lock")
    def _apply_delta(self, pay) -> None:
        """This rank's part of the payload into the placed tensors, every
        shard's index vectors into the host mirrors (caller holds the
        lock)."""
        self._scatter(self._cut(pay, self.slot.lin))
        self._mirror_update(self._mirror_part(pay))
        self._n = pay["n"]

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

        On a leading root (:meth:`lead`) the followers take the same
        update under the same lock hold: each receives its own part (its
        rows, buckets or slabs of the delta, or its shard of a full
        re-place); their tables then equal what a backend built with
        ``shard=`` on the mutated target holds.  If any rank fails its
        part, every rank raises and this backend refuses to serve.

        Returns ``{"mode", "bytes", "full_bytes", "reason"}``: ``mode`` is
        ``"delta"``, ``"full"`` or ``"noop"``; ``bytes`` is what was
        shipped; ``full_bytes`` is what a full re-place ships (both over
        every shard, as the reference counts them).
        """
        with get_tracer().span("republish.place", kind=self.kind) as sp:
            with self._lock, self._on_stream():
                self._check_serving()
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

    def _plan(self, target, alive, delta):
        """(mode, delta payload or None, fallback reason) of an update."""
        if delta is None:
            return "full", None, "no-manifest"
        if delta.full:
            return "full", None, "manifest-full"
        covered = (self._version is not None
                   and delta.base_version <= self._version)
        if delta.empty and (covered or self.kind == "brute"):
            return "noop", None, None
        if (self.kind in ("ivf", "forest") and self.delta_updates
                and delta.dirty_buckets.size * self._bucket_payload_bytes()
                > self.delta_max_fraction * self._full_bytes):
            # the payload size is exact up front: don't cut the slices of
            # a delta that can't win
            return "full", None, "threshold"
        pay, reason = self._delta_payload(target, alive, delta)
        if reason is None and (pay["bytes"]
                               > self.delta_max_fraction * self._full_bytes):
            reason = "threshold"
        if reason is not None:
            return "full", None, reason
        return "delta", pay, None

    @guarded_by("_lock")
    def _apply_locked(self, target, alive, delta) -> dict:
        """Apply on this rank first: a payload or placement that fails here
        fails before any follower hears of it; then the followers'
        parts."""
        old_meta = self._meta
        mode, pay, reason = self._plan(target, alive, delta)
        if mode == "full":
            self._place(target, alive=alive)
        else:
            if mode == "delta":
                self._apply_delta(pay)
            self._version = delta.version
            self._refresh_meta(target)
        self._sync()
        if self._leading:
            self._update_followers(mode, pay, target, alive, old_meta)
        if mode == "noop":
            return {"mode": "noop", "bytes": 0,
                    "full_bytes": self._full_bytes, "reason": None}
        return {"mode": mode,
                "bytes": pay["bytes"] if mode == "delta" else self._full_bytes,
                "full_bytes": self._full_bytes, "reason": reason}

    @guarded_by("_lock")
    def _update_followers(self, mode: str, pay, target, alive,
                          old_meta) -> None:
        """Send every follower its part of the update this root just
        applied, then count the ranks that failed theirs (caller holds the
        lock).  The header (broadcast) carries the shared state: every
        shard's index vectors for the host mirrors and the appended
        metadata rows; each follower's part goes to it alone."""
        if mode == "full":
            mirror = (self._host_valid if self.kind == "brute"
                      else self._host_bids)
        else:
            mirror = None if mode == "noop" else self._mirror_part(pay)
        self._send({"stop": False, "update": mode, "n": self._n,
                    "version": self._version, "full_bytes": self._full_bytes,
                    "mirror": mirror,
                    "meta": _meta_message(old_meta, self._meta)})
        sent, error = {}, None
        for rank, lin in self._coll.followers():
            if error is None:
                try:
                    if mode == "full":
                        t = self._tables(target, alive, lin,
                                         torch.device("cpu"))
                        part = {"args": [a.numpy() for a in t["args"]],
                                "lex": (None if t["lex"] is None else
                                        [a.numpy() for a in t["lex"]])}
                    elif mode == "delta":
                        part = self._cut(pay, lin)
                    else:
                        part = {}
                except Exception as e:
                    error = f"{type(e).__name__}: {e}"
            msg = {"error": error} if error is not None else part
            dist.send_object_list([msg], dst=rank)
            sent[rank] = _nbytes(msg)
        self.last_fanout = {"mode": mode, "bytes_to_rank": sent}
        failed = self._coll.total(error is not None, self.device)
        if failed:
            self._fail(f"an update failed on {failed} rank(s) of the mesh"
                       + (f" ({error})" if error else ""))
            raise RuntimeError(self._failed)

    @guarded_by("_lock")
    def _take_update(self, h: dict) -> None:
        """A follower's side of :meth:`_update_followers` (caller holds the
        lock, on this backend's stream)."""
        error = None
        try:
            box = [None]
            dist.recv_object_list(box, src=self._coll.root_rank)
            part = box[0]
            if "error" in part:
                raise RuntimeError("the root could not cut this rank's "
                                   f"part: {part['error']}")
            if h["update"] == "full":
                self._install(dict(part, mirror=h["mirror"], n=h["n"],
                                   full_bytes=h["full_bytes"]))
            elif h["update"] == "delta":
                self._scatter(part)
                self._mirror_update(h["mirror"])
            self._n, self._version = h["n"], h["version"]
            self._set_meta(h["meta"])
            self._sync()
            self.updates.append({"mode": h["update"],
                                 "part_bytes": _nbytes(part),
                                 "header_bytes": _nbytes(h)})
        except Exception as e:
            error = e
        failed = self._coll.total(error is not None, self.device)
        if failed:
            self._fail(f"an update failed on {failed} rank(s) of the mesh")
            raise RuntimeError(self._failed) from error

    def _set_meta(self, msg) -> None:
        """Install a ``_meta_message`` on this follower's snapshot and drop
        every compiled mask."""
        if msg is None:
            self._meta = None
        elif "append" in msg:
            self._meta = MetadataTable(
                {c: np.concatenate([self._meta.column(c), v])
                 for c, v in msg["append"].items()})
        else:
            self._meta = MetadataTable(msg["table"])
        self._fmask_cache.clear()

    @guarded_by("_lock")
    def _fail(self, why: str) -> None:
        """Refuse to serve from now on: some rank's tables are not this
        update's (caller holds the lock)."""
        self._failed = why
        self._leading = False
        self._beat_stop.set()

    def _check_serving(self) -> None:
        if self._failed is not None:
            raise RuntimeError(f"this backend no longer serves: {self._failed};"
                               " rebuild it")
        if self._stopped:
            raise RuntimeError("this backend released its followers "
                               "(stop_followers); its collectives would "
                               "wait for them")

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
        multiple of ``n_q`` rows (placed by the search, on this backend's
        stream); and the batch size B."""
        host = []
        if mode != "lexical":
            host.append(_pad_batch(queries, n_q))
        if mode != "semantic":
            host.extend(_pad_terms(q_terms, q_weights, n_q))
        B = len(queries) if mode != "lexical" else len(q_terms)
        return tuple(host), B

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
        t0 = time.perf_counter()
        # kernel: enqueue + device execution; the synchronise runs outside
        # the lock so the span measures device time, not the enqueue
        with tracer.span("kernel", kind=self.kind, b=B):
            with self._lock, self._on_stream():
                self._check_serving()
                sig = (mode, tuple(ops[0].shape), str(ops[0].dtype))
                first = sig not in self._seen_sigs
                if first:
                    self._seen_sigs.add(sig)
                # compiled before the followers hear of the call: a
                # request that fails to compile fails on the root alone
                call = self._local(filter_spec, mode, alpha)
                ops = tuple(self._put(o) for o in ops)
                if self._leading:
                    self._send({"stop": False, "B": B, "mode": mode,
                                "alpha": alpha, "filter": filter_spec,
                                "operands": [(tuple(o.shape), o.dtype)
                                             for o in ops]}, ops)
                d, i = search_blocks(call, ops, B, self.k, self.slot,
                                     self._coll)
            self._sync()
        t1 = time.perf_counter()
        # rerank: pull the merged top-k back to the host
        with tracer.span("rerank", kind=self.kind):
            out = d.cpu().numpy(), i.cpu().numpy()
        t2 = time.perf_counter()
        self._c_dispatches.inc()
        self._h_kernel.observe((t1 - t0) * 1e3)
        self._h_rerank.observe((t2 - t1) * 1e3)
        if first:
            # the first dispatch of this signature paid the one-time
            # costs; record it with the signature that caused it
            self._c_sigs.inc()
            self._h_first.observe((t1 - t0) * 1e3)
            tracer.instant("compile-signature", kind=self.kind,
                           shape=str(list(sig[1])), dtype=sig[2],
                           ms=round((t1 - t0) * 1e3, 3))
        return out

    # ------------------------------------------------------------------
    # compiled variants and the roofline
    # ------------------------------------------------------------------
    def jit_cache_size(self) -> int:
        """Compiled variants of this backend: the port's meaning of the
        reference's jit cache size, which the recompile gate watches.
        The sum of three counts:

        * the distinct dispatch signatures (mode, padded operand shape,
          dtype) served;
        * the placements whose device-table shapes differ from the
          previous placement's: a re-place within the headroom keeps its
          shapes and does not count, tables of another shape (another
          width, or an outgrown reservation) do;
        * the kernel libraries loaded since construction.
        """
        return (len(self._seen_sigs) + self._reshapes
                + _build.loaded() - self._libs0)

    def delta_cache_size(self) -> int:
        """Distinct power-of-two-bucketed scatter shapes that
        ``apply_updates`` has used: the counterpart of the size of the
        reference's jitted delta scatter's cache."""
        return len(self._delta_sigs)

    def roofline_report(self, b: int = 1, *, peak_bw: float = 0.0) -> dict:
        """Analytic bytes/FLOPs of one dispatch of ``b`` queries
        (``obs.profile.backend_cost``) beside the *measured* kernel time
        (the p50 of ``kernel_ms``).

        ``analytic_frac`` is the model's useful-byte fraction;
        ``achieved_gbps`` divides the moved bytes by the measured time;
        with ``peak_bw`` (bytes/s) ``measured_frac`` is the useful bytes
        a second over that peak.  ``bound_ms`` is the least time the
        H100 (``obs.profile.H100_*``) could take for the moved bytes and
        the FLOPs, and ``bound_by`` says which of the two sets it.
        """
        from repro_torch.obs.profile import (H100_FP32_FLOPS_PER_S,
                                             H100_HBM_BYTES_PER_S, H100_NAME,
                                             backend_cost)

        common = dict(fused=self.fused, precision=self.precision,
                      n_rows=self._n, b=b, k=self.k)
        if self.kind == "brute":
            cost = backend_cost("brute", d=int(self._args[0].shape[1]),
                                **common)
        elif self.kind == "ivf":
            cost = backend_cost(
                "ivf", d=int(self._args[0].shape[1]),
                n_probe_rows=self.nprobe_local * self.n_dev * self._cap,
                n_centroids=self._kloc * self.n_dev, **common)
        else:
            cents = self._args[0]                 # (1, Kloc, d)
            cost = backend_cost(
                "forest", d=int(cents.shape[2]),
                n_probe_rows=(self.nprobe_local * self.n_dev
                              * self._shapes.cap),
                n_centroids=self.n_dev * int(cents.shape[1]), **common)
        t_bytes = cost["bytes_moved"] / H100_HBM_BYTES_PER_S
        t_ops = cost["flops"] / H100_FP32_FLOPS_PER_S
        cost.update(card=H100_NAME, bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        med_ms = self._h_kernel.quantile(0.5) if self._h_kernel.count else 0.0
        cost["measured_kernel_ms_p50"] = med_ms
        if med_ms > 0:
            bps = cost["bytes_moved"] / (med_ms / 1e3)
            cost["achieved_gbps"] = bps / 1e9
            if peak_bw > 0:
                cost["measured_frac"] = (
                    cost["useful_bytes"] / (med_ms / 1e3)) / peak_bw
        return cost

    # ------------------------------------------------------------------
    # serving across ranks: the root leads, the other ranks follow
    # ------------------------------------------------------------------
    @property
    def leads(self) -> bool:
        """True while this root backend sends its calls to followers."""
        return self._leading

    def lead(self) -> "ShardedSearchBackend":
        """Make this backend, on the mesh's root rank, send every call's
        header (B, mode, alpha, filter) and operands, and every update's
        parts, to the other ranks, which run :meth:`follow`.  While no call
        has been sent for a quarter of the shortest timeout of the mesh's
        groups a heartbeat is sent, so a root idle past the timeout does
        not fail its followers.  A mesh of one rank has no followers."""
        if self._coll is None or self._coll.size == 1:
            return self
        if not self._coll.root:
            raise RuntimeError("only the mesh's root rank leads; the other "
                               "ranks follow()")
        if self._leading:
            return self
        timeout = self._coll.timeout_s(self.device)
        self._beat_s = (_HEARTBEAT_SHARE * timeout if timeout is not None
                        else _HEARTBEAT_UNKNOWN_S)
        with self._lock:
            self._leading = True
            self._last_send = time.monotonic()
        self._beat = threading.Thread(target=self._heartbeat, daemon=True)
        self._beat.start()
        return self

    def _heartbeat(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._beat_stop.wait(self._beat_s / 2):
            with self._lock:
                if (self._leading and time.monotonic() - self._last_send
                        >= self._beat_s):
                    self._send({"stop": False, "beat": True})
                    self.beats += 1

    @guarded_by("_lock")
    def _send(self, header: dict, ops=()) -> None:
        """Broadcast a call from the root (caller holds the lock)."""
        self._coll.broadcast_object(header)
        for o in ops:
            self._coll.broadcast(o)
        self._last_send = time.monotonic()

    def follow(self, on_update=None) -> int:
        """Serve the root's calls on a non-root rank: receive each call's
        header and operands and join its collectives, and take each
        update's part, until the root's :meth:`stop_followers`.  Heartbeats
        are skipped (and counted in ``beats``).  ``on_update(self)`` runs
        after each update this rank took.  Returns the calls served.
        Raises when an update failed on any rank; a root silent past the
        groups' timeout (dead: a live root sends heartbeats) fails the
        wait."""
        if self._coll is None or self._coll.root:
            raise RuntimeError("follow() runs on the non-root ranks of a "
                               "mesh")
        served = 0
        while True:
            h = self._coll.broadcast_object(None)
            if h["stop"]:
                return served
            if h.get("beat"):
                with self._lock:
                    self.beats += 1
                continue
            with self._lock, self._on_stream():
                if "update" in h:
                    self._take_update(h)
                else:
                    ops = tuple(self._coll.broadcast(
                        torch.empty(shape, dtype=dtype, device=self.device))
                        for shape, dtype in h["operands"])
                    search_blocks(self._local(h["filter"], h["mode"],
                                              h["alpha"]),
                                  ops, h["B"], self.k, self.slot, self._coll)
                    served += 1
            if "update" in h and on_update is not None:
                on_update(self)

    def stop_followers(self) -> None:
        """End the followers' :meth:`follow` loops (a no-op unless this
        backend leads)."""
        with self._lock:
            if self._leading:
                self._send({"stop": True})
                self._leading, self._stopped = False, True
        self._beat_stop.set()
        if self._beat is not None and self._beat is not threading.current_thread():
            self._beat.join(timeout=5)
