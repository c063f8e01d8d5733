"""Declarative annotations read by the port's static checkers: a copy of
``repro/analysis/annotations.py`` plus the compile-path marker.

``@guarded_by("lock_attr")`` documents that a method must only run while
``self.<lock_attr>`` is held.  At runtime it is a no-op (nothing on the
serving hot path); the lock checker (``repro_torch.analysis.locks``)
reads it two ways:

* the method body is analysed as if the lock were held, and
* every call site of the method inside the class must itself be
  dominated by ``with self.<lock_attr>:`` (or sit in another
  ``@guarded_by`` method for the same lock).

``__init__`` is exempt everywhere: the object is unpublished there, so
writes and guarded-method calls are safe by happens-before.

``@hot_path`` marks a function that runs once per dispatch (a shard's
local, ``search_blocks``, the kernel dispatchers).  The reference finds
its hot code by ``jax.jit``; the port has no tracing, so the compile-path
lint (``repro_torch.analysis.torchlint``) checks the functions carrying
this marker.  It is a no-op at runtime too.
"""
from __future__ import annotations

__all__ = ["guarded_by", "hot_path"]


def guarded_by(lock_attr: str):
    """Mark a method as requiring ``self.<lock_attr>`` to be held."""

    def deco(fn):
        fn.__guarded_by__ = lock_attr
        return fn

    return deco


def hot_path(fn):
    """Mark ``fn`` as per-dispatch code for the compile-path lint."""
    fn.__hot_path__ = True
    return fn
