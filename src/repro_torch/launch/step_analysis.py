"""Per-rank accounting of one step: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses a compiled program's HLO text.  The port has no
program text, so :func:`analyze_step` runs the step once and watches what
one rank does (in the dry run on ``meta`` tensors, where nothing is
computed and no storage is held).  It returns the keys of
``analyze_hlo`` that have a meaning here:

* ``matmul_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention), the
  reference's FLOPs of every ``dot``; ``matmul_flops_by_op`` splits it;
* ``mem_bytes_proxy``: twice the result bytes (read and write) of every
  op that is neither a view nor an allocation alone (``empty``), the
  reference's ``_MEM_OPS`` proxy.  Eager torch fuses no elementwise chain,
  so every elementwise result counts, where the reference skips those
  XLA would fuse;
* ``collective_bytes`` and ``collective_counts`` by kind, under the
  reference's names: ``sharding.COLLECTIVE_BYTES`` (the moves and gathers
  the port issues by hand) and the functional collectives DTensor issues
  on its own (the backward of a replicated value), each at the
  reference's rule, the result's bytes with an all-reduce doubled;
  ``all_to_all_exchange_bytes`` is what a true all-to-all would move for
  the port's ``all-to-all`` moves (ROADMAP fault 22);
* ``peak_liveness``: the most bytes of storage the step held at once
  beyond its arguments, and the largest buffers live at that point
  (``(op, bytes, shape)``).  Each storage an op makes is counted from
  that op until it is freed (a ``weakref.finalize`` on the storage), as
  the reference frees an HLO buffer after its last use.  A sort along a
  dim longer than ``SMALL_SORT`` also holds, while it runs, what the
  card's segmented radix sort allocates beside its results (an iota of
  the indices, and alternate buffers of the keys and the indices): the
  bytes of its values plus twice those of its indices (measured on the
  card: the sift-1m ANN cell's (1,024, 8,192) probe sort, PERF.md §6).
  torch's ``MemTracker`` sees ``meta`` storages too and finds the same
  peak (the tests hold the two equal), but it reports peaks by module
  and category, not the buffers live at the peak, and takes no
  workspace charge.

A Python loop runs every iteration (layers, microbatches, probe steps),
so each is counted as it runs: the reference's while-loop trip-count
correction has no counterpart here.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import sharding

__all__ = ["analyze_step", "StepAccounting", "KINDS", "SMALL_SORT",
           "tensor_leaves", "local_bytes"]

# the reference's collective kinds (``hlo_analysis._COLLECTIVES``)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# DTensor's own collectives, by the reference's kind
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_coalesced":
               "all-reduce", "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}

# ops that allocate and write nothing
_ALLOC_ONLY = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like"}

# the longest dim torch sorts in place on the card (its bitonic sort);
# longer ones go through a segmented radix sort with a workspace
SMALL_SORT = 4096


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_leaves(tree) -> list:
    """The tensors of a step's arguments or result (dicts in sorted key
    order, lists, tuples, ``TrainState``); other leaves dropped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "tree_flatten"):
        tree = tree.tree_flatten()[0]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


def local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``: each DTensor's local shard,
    each plain tensor whole."""
    return sum(_nbytes(_local(t)) for t in tensor_leaves(tree))


class StepAccounting(TorchDispatchMode):
    """The byte proxy, DTensor's collectives and the live storages of
    every op dispatched while it is active (see the module docstring).
    ``known`` storages (the arguments') are never counted as made."""

    def __init__(self, known=(), top_n: int = 12):
        super().__init__()
        self.top_n = top_n
        self.mem_bytes = 0
        self.coll_bytes: Counter = Counter()
        self.coll_counts: Counter = Counter()
        self._seen = weakref.WeakSet()
        for t in known:
            self._seen.add(_local(t).untyped_storage())
        self._live: dict = {}
        self._next = 0
        self.cur = 0
        self.peak = 0
        self.peak_buffers: list = []

    def _free(self, key: int) -> None:
        self.cur -= self._live.pop(key)[1]

    def _track(self, name: str, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        key = self._next
        self._next += 1
        self._live[key] = (name, n, tuple(t.shape))
        weakref.finalize(st, self._free, key)
        self.cur += n
        self._at_peak()

    def _at_peak(self, extra=None) -> None:
        """A new peak when the live bytes (and ``extra``, a transient
        ``(op, bytes, shape)``) pass the last one."""
        cur = self.cur + (extra[1] if extra else 0)
        if cur > self.peak:
            self.peak = cur
            live = list(self._live.values()) + ([extra] if extra else [])
            self.peak_buffers = sorted(live, key=lambda v: -v[1])[
                :self.top_n]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, name = func.namespace, func._opname
        outs = [_local(t) for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind = _FUNCTIONAL[name]
            size = sum(_nbytes(t) for t in outs)
            self.coll_bytes[kind] += (2 if kind == "all-reduce" else 1) * size
            self.coll_counts[kind] += 1
        if func.is_view or name in _ALLOC_ONLY:
            return out
        self.mem_bytes += 2 * sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(f"{ns}.{name}", t)
        if name == "sort":
            dim = (kwargs or {}).get("dim", args[1] if len(args) > 1
                                     and isinstance(args[1], int) else -1)
            values, idx = outs
            if values.dim() and values.shape[dim] > SMALL_SORT:
                self._at_peak((f"{ns}.sort workspace",
                               _nbytes(values) + 2 * _nbytes(idx),
                               tuple(values.shape)))
        return out


def _reset_counters() -> None:
    for c in (sharding.REDISTRIBUTES, sharding.COLLECTIVE_BYTES,
              sharding.COLLECTIVE_COUNTS, sharding.EXCHANGE_BYTES):
        c.clear()


def analyze_step(step, args, top_n: int = 12) -> dict:
    """Run ``step(*args)`` once and account for it (module docstring).
    Returns ``{"analysis": {...}, "out": step's result}``; the sharding
    counters are reset before the step and read after it."""
    _reset_counters()
    acc = StepAccounting(tensor_leaves(args), top_n)
    with FlopCounterMode(display=False) as flops, acc:
        out = step(*args)
    by_op = {str(k): int(v) for k, v in
             flops.get_flop_counts().get("Global", {}).items()}
    coll = {k: int(acc.coll_bytes[k]) for k in KINDS}
    counts = {k: int(acc.coll_counts[k]) for k in KINDS}
    for kind, n in sharding.COLLECTIVE_BYTES.items():
        coll[kind.replace("_", "-")] += int(n)
    for kind, n in sharding.COLLECTIVE_COUNTS.items():
        counts[kind.replace("_", "-")] += int(n)
    coll["total"] = sum(coll[k] for k in KINDS)
    analysis = {
        "matmul_flops": float(flops.get_total_flops()),
        "matmul_flops_by_op": by_op,
        "mem_bytes_proxy": float(acc.mem_bytes),
        "collective_bytes": coll,
        "collective_counts": counts,
        "all_to_all_exchange_bytes": int(
            sharding.EXCHANGE_BYTES["all_to_all"]),
        "moves": dict(sharding.REDISTRIBUTES),
        "peak_liveness": {
            "peak_bytes": int(acc.peak),
            "top_buffers": [list(b) for b in acc.peak_buffers],
        },
    }
    return {"analysis": analysis, "out": out}
