"""Per-entity metadata columns and the filter predicate surface.

A copy of ``repro/core/metadata.py`` (numpy only), kept here so the port
imports nothing of the reference.  ``FilterSpec.key()`` gives the same
bytes in both packages.

* :class:`MetadataTable` — fixed-dtype int32 columns, one row per
  entity, append-only alongside the corpus (rows never move; deletes are
  tombstones carried by the index ``alive`` mask, not by the table).
* :class:`FilterSpec` — a frozen conjunction of equality / range /
  set-membership predicates over named columns, compiled by
  :meth:`FilterSpec.mask` to a per-row boolean mask.  The mask is data,
  never shape: the backend ANDs it into the ``valid`` row operand (brute,
  lexical, hybrid) or masks ``bucket_ids`` slots to ``-1`` (IVF), so a
  filtered query runs the same kernels on the same shapes.

Staleness: a backend snapshots the table at placement and compiles
filter masks from that snapshot, so a filter sees metadata as of the
last placement — the staleness window of the vectors themselves.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

__all__ = ["MetadataTable", "FilterSpec"]


class MetadataTable:
    """Named int32 columns, one row per entity. Append-only."""

    def __init__(self, columns: "dict[str, np.ndarray]"):
        self._cols: "dict[str, np.ndarray]" = {}
        n = None
        for name, col in columns.items():
            a = np.ascontiguousarray(col, dtype=np.int32)
            if a.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D")
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    f"column {name!r} has {a.shape[0]} rows, expected {n}")
            self._cols[name] = a
        self._n = 0 if n is None else int(n)

    # ---------------- read surface ----------------
    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def column_names(self) -> "tuple[str, ...]":
        return tuple(self._cols)

    def column(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(
                f"unknown metadata column {name!r}; "
                f"have {sorted(self._cols)}")
        return self._cols[name]

    def footprint_bytes(self) -> int:
        return sum(c.nbytes for c in self._cols.values())

    # ---------------- mutation surface ----------------
    def append_rows(self, rows: "Optional[dict[str, np.ndarray]]",
                    count: int, *, fill: int = 0) -> None:
        """Append ``count`` rows; missing columns get ``fill``."""
        rows = rows or {}
        unknown = set(rows) - set(self._cols)
        if unknown:
            raise KeyError(f"unknown metadata columns {sorted(unknown)}")
        for name, col in self._cols.items():
            if name in rows:
                a = np.ascontiguousarray(rows[name], dtype=np.int32)
                if a.shape != (count,):
                    raise ValueError(
                        f"column {name!r}: expected {count} new rows, "
                        f"got shape {a.shape}")
            else:
                a = np.full(count, fill, dtype=np.int32)
            self._cols[name] = np.concatenate([col, a])
        self._n += count

    def snapshot(self) -> "MetadataTable":
        """Deep copy — what a backend pins at placement time."""
        return MetadataTable(
            {k: v.copy() for k, v in self._cols.items()})

    def __repr__(self) -> str:
        return (f"MetadataTable(n_rows={self._n}, "
                f"columns={list(self._cols)})")


_OPS = ("eq", "range", "isin")


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """A conjunction of predicates over metadata columns.

    ``predicates`` is a tuple of tuples:

    * ``("eq", col, value)`` — ``col == value``
    * ``("range", col, lo, hi)`` — ``lo <= col <= hi`` (inclusive)
    * ``("isin", col, (v0, v1, ...))`` — membership

    Instances are hashable and order-sensitive; :meth:`key` gives a
    stable digest for cache keys (the backend's mask cache).
    """

    predicates: "tuple[tuple, ...]" = ()

    # ---------------- constructors ----------------
    @staticmethod
    def eq(col: str, value: int) -> "FilterSpec":
        return FilterSpec((("eq", col, int(value)),))

    @staticmethod
    def range(col: str, lo: int, hi: int) -> "FilterSpec":
        return FilterSpec((("range", col, int(lo), int(hi)),))

    @staticmethod
    def isin(col: str, values) -> "FilterSpec":
        vals = tuple(sorted(int(v) for v in values))
        return FilterSpec((("isin", col, vals),))

    def __and__(self, other: "FilterSpec") -> "FilterSpec":
        return FilterSpec(self.predicates + other.predicates)

    def __post_init__(self):
        for p in self.predicates:
            if not p or p[0] not in _OPS:
                raise ValueError(f"bad predicate {p!r}")

    # ---------------- compilation ----------------
    def mask(self, table: "Optional[MetadataTable]", n: int) -> np.ndarray:
        """Row mask of length ``n`` (True = row passes every predicate).

        ``n`` may exceed ``table.n_rows`` (headroom rows in a placed
        backend); rows beyond the table are False — they hold no entity
        yet, so no predicate can admit them.
        """
        out = np.ones(n, dtype=bool)
        if not self.predicates:
            return out
        if table is None:
            raise ValueError(
                "FilterSpec with predicates needs a MetadataTable")
        m = min(n, table.n_rows)
        out[m:] = False
        for p in self.predicates:
            col = table.column(p[1])[:m]
            if p[0] == "eq":
                pm = col == p[2]
            elif p[0] == "range":
                pm = (col >= p[2]) & (col <= p[3])
            else:  # isin
                pm = np.isin(col, np.asarray(p[2], dtype=np.int32))
            out[:m] &= pm
        return out

    def key(self) -> bytes:
        """Stable 16-byte digest (mask caches, result-cache keys)."""
        h = hashlib.blake2b(digest_size=16)
        for p in self.predicates:
            h.update(repr(p).encode())
        return h.digest()

    @property
    def empty(self) -> bool:
        return not self.predicates

    def describe(self) -> str:
        if not self.predicates:
            return "unfiltered"
        return " AND ".join(
            f"{p[1]}=={p[2]}" if p[0] == "eq"
            else f"{p[2]}<={p[1]}<={p[3]}" if p[0] == "range"
            else f"{p[1]} in {list(p[2])}"
            for p in self.predicates)
