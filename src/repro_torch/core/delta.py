"""Delta manifests: *what changed* in a mutable index since its last publish.

Port of ``repro/core/delta.py`` (numpy only, as there).  Every mutation
of an index records which buckets it dirtied and which entities it
tombstoned; ``pop_delta()`` emits the accumulated record, and
``ShardedSearchBackend.apply_updates(target, delta=...)`` scatters only
the dirty slices into the placed tensors.

Design rules the consumers rely on:

* **The manifest is metadata, not payload.**  It names dirty buckets /
  tombstones / appended row ranges; the bytes are sliced from the
  *current* index state at apply time, so applying a manifest (or a
  superset of one already applied) is idempotent.
* **Versions are one monotone counter per index.**  ``base_version`` is
  the index's ``mutation_version`` when the previous manifest was popped;
  a backend that last placed at version ``v`` may apply any manifest with
  ``base_version <= v`` and must re-place fully otherwise.
* **Append-only rows.**  ``db`` rows never move (deletes are tombstones),
  so the changed rows of a flat corpus are ``[base_n, n)`` plus the
  validity flips named by ``tombstones``.

The array fields default through ``default_factory`` (the reference's
ndarray defaults do not load on Python 3.12).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DeltaManifest", "DeltaLog", "merge_manifests"]


def _empty() -> np.ndarray:
    return np.zeros(0, dtype=np.int64)


def merge_manifests(manifests) -> "DeltaManifest":
    """Collapse a version-ordered run of manifests into one covering
    window: the union of dirty buckets / tombstones over
    ``[first.base_version, last.version)``.  ``full`` is sticky."""
    ms = sorted(manifests, key=lambda m: m.base_version)
    if not ms:
        raise ValueError("merge_manifests needs at least one manifest")
    return DeltaManifest(
        base_version=ms[0].base_version,
        version=ms[-1].version,
        base_n=ms[0].base_n,
        n=ms[-1].n,
        dirty_buckets=np.unique(np.concatenate(
            [np.asarray(m.dirty_buckets, np.int64) for m in ms])),
        tombstones=np.unique(np.concatenate(
            [np.asarray(m.tombstones, np.int64) for m in ms])),
        lsh_rows_appended=sum(m.lsh_rows_appended for m in ms),
        full=any(m.full for m in ms),
    )


@dataclasses.dataclass(frozen=True)
class DeltaManifest:
    """What changed in an index between two published versions.

    base_version : ``mutation_version`` the delta applies on top of
    version      : ``mutation_version`` after applying it
    base_n       : corpus rows at ``base_version`` (appends = [base_n, n))
    n            : corpus rows at ``version``
    dirty_buckets: sorted unique bucket ids whose membership, centroid,
                   vectors or per-bucket tree changed
    tombstones   : entity ids deleted in the window
    lsh_rows_appended : packed LSH code rows appended
    full         : the window holds a change deltas cannot express
                   (a whole-tree rebuild): consumers must re-place
    """

    base_version: int
    version: int
    base_n: int
    n: int
    dirty_buckets: np.ndarray = dataclasses.field(default_factory=_empty)
    tombstones: np.ndarray = dataclasses.field(default_factory=_empty)
    lsh_rows_appended: int = 0
    full: bool = False

    @property
    def empty(self) -> bool:
        """True when the window holds no change at all."""
        return (not self.full
                and self.dirty_buckets.size == 0
                and self.tombstones.size == 0
                and self.lsh_rows_appended == 0
                and self.n == self.base_n)

    def describe(self) -> str:
        if self.full:
            kind = "full"
        elif self.empty:
            kind = "empty"
        else:
            kind = "delta"
        return (f"{kind} v{self.base_version}->v{self.version}: "
                f"{self.dirty_buckets.size} dirty buckets, "
                f"{self.tombstones.size} tombstones, "
                f"rows {self.base_n}->{self.n}")


@dataclasses.dataclass
class DeltaLog:
    """Mutable accumulator behind ``pop_delta()``: mutations call the
    ``mark_*`` helpers and ``pop`` snapshots and resets it.  Single
    writer, as the index's mutations are."""

    base_version: int
    base_n: int
    dirty: set = dataclasses.field(default_factory=set)
    tombstones: list = dataclasses.field(default_factory=list)
    lsh_rows: int = 0
    full: bool = False

    def mark_buckets(self, buckets) -> None:
        self.dirty.update(int(b) for b in np.atleast_1d(buckets))

    def mark_tombstones(self, ids) -> None:
        self.tombstones.extend(int(e) for e in np.atleast_1d(ids))

    def mark_full(self) -> None:
        self.full = True

    def pop(self, version: int, n: int) -> DeltaManifest:
        man = DeltaManifest(
            base_version=self.base_version,
            version=version,
            base_n=self.base_n,
            n=n,
            dirty_buckets=np.sort(
                np.fromiter(self.dirty, dtype=np.int64, count=len(self.dirty))
            ),
            tombstones=np.unique(
                np.fromiter(self.tombstones, dtype=np.int64,
                            count=len(self.tombstones))
            ),
            lsh_rows_appended=self.lsh_rows,
            full=self.full,
        )
        self.base_version = version
        self.base_n = n
        self.dirty = set()
        self.tombstones = []
        self.lsh_rows = 0
        self.full = False
        return man
