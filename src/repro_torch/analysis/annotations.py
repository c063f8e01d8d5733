"""Declarative concurrency annotations: the port's copy of
``repro/analysis/annotations.py``.

``@guarded_by("lock_attr")`` documents that a method must only run while
``self.<lock_attr>`` is held.  At runtime it is a no-op (nothing on the
serving hot path); a static lock checker reads the ``__guarded_by__``
attribute it sets:

* the method body is analysed as if the lock were held, and
* every call site of the method inside the class must itself be
  dominated by ``with self.<lock_attr>:`` (or sit in another
  ``@guarded_by`` method for the same lock).

``__init__`` is exempt everywhere: the object is unpublished there, so
writes and guarded-method calls are safe by happens-before.
"""
from __future__ import annotations

__all__ = ["guarded_by"]


def guarded_by(lock_attr: str):
    """Mark a method as requiring ``self.<lock_attr>`` to be held."""

    def deco(fn):
        fn.__guarded_by__ = lock_attr
        return fn

    return deco
