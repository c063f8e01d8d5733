"""Lock-discipline checker: every write to a shared attribute must be
dominated by the class's designated lock.  A copy of
``repro/analysis/locks.py``: on the same source both give the same
findings.  The port's designated locks are the backend's ``_lock``
(``distributed/backend.py``), the estimator's, cache's and maintenance
scheduler's (``adaptive/``), the cell's ``_stats_lock``
(``serve/cell.py``) and the router's ``_lock`` (``serve/fleet.py``).

The serving stack runs three kinds of threads against the same objects --
the engine's micro-batch worker, the maintenance daemon, and caller
threads invoking ``search``/``apply_updates``/``stats``.  This pass
checks, per class:

1. **Designated locks** -- attributes assigned ``threading.Lock()`` /
   ``RLock()`` / ``Condition()`` in ``__init__`` (e.g. ``self._lock``).
   Classes without one are skipped: no declared discipline, nothing to
   enforce (attach a lock or a ``@guarded_by`` method to opt in).
2. **Guarded attributes** -- inferred: any attribute written under
   ``with self.<lock>:`` (or inside a ``@guarded_by``-annotated method)
   anywhere in the class, outside ``__init__``, is shared mutable state
   guarded by that lock.
3. **Write sites** -- plain assigns, aug-assigns, subscript stores, and
   mutator-method calls (``append``/``extend``/``pop``/``update``/...)
   on a guarded attribute.  Each must be dominated by the guarding
   lock's ``with`` block or sit in a method annotated
   ``@guarded_by("<lock>")``.

Rules:

``unguarded-write``
    A write to a guarded attribute outside the lock.
``unguarded-call``
    A call to a ``@guarded_by`` method from class code that does not
    hold the lock.
``unknown-lock``
    ``@guarded_by("x")`` naming an attribute that is not a designated
    lock of the class.

Exemptions baked into the model (not suppressions):

* ``__init__`` -- the object is unpublished; happens-before on thread
  start makes initialization writes safe.
* Nested ``def``s inside a method are analyzed with an *empty* held-lock
  set even when the enclosing block holds the lock: closures here are
  thread targets (``_dispatch``'s hedge primary) and run later, without
  the lock.
* **Internally-locked instruments** -- attributes assigned from a
  ``repro_torch.obs`` constructor in ``__init__`` (``MetricsRegistry()``,
  ``Tracer()``, ``Counter``/``Gauge``/``Histogram``, or a registry's
  ``counter()``/``gauge()``/``histogram()`` get-or-create).  Every obs
  instrument owns a private lock and serializes its own mutations, so
  the class-level lock discipline does not apply to them -- no
  ``# repro: allow`` waiver needed at the call sites.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import STATIC_RULES, Finding

__all__ = ["check_module"]

STATIC_RULES.update({
    "unguarded-write":
        "write to a lock-guarded attribute outside the designated lock",
    "unguarded-call":
        "call to a @guarded_by method without holding its lock",
    "unknown-lock":
        "@guarded_by names an attribute that is not a designated lock",
})

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "add", "discard", "setdefault",
             "appendleft", "popleft"}
# repro_torch.obs instrument constructors: classes (MetricsRegistry(),
# Tracer(), Counter/Gauge/Histogram(...)) and the registry's
# get-or-create methods (self.metrics.counter("x"), ...).  An attribute
# initialized from one of these in __init__ is *internally locked* -- the
# instrument serializes its own mutations -- so the class's lock
# discipline is not inferred from (or enforced on) writes to it.
_OBS_CTORS = {"MetricsRegistry", "Tracer", "Counter", "Gauge",
              "Histogram", "counter", "gauge", "histogram"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _call_name(node: ast.AST) -> Optional[str]:
    """Terminal callee name of a Call (``a.b.c(...)`` -> ``c``)."""
    if not isinstance(node, ast.Call):
        return None
    path = node.func
    return path.attr if isinstance(path, ast.Attribute) else \
        path.id if isinstance(path, ast.Name) else None


def _is_lock_ctor(node: ast.AST) -> bool:
    return _call_name(node) in _LOCK_CTORS


def _is_obs_ctor(node: ast.AST) -> bool:
    return _call_name(node) in _OBS_CTORS


def _guarded_by_of(fn: ast.FunctionDef) -> Optional[str]:
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            name = dec.func.attr if isinstance(dec.func, ast.Attribute) \
                else dec.func.id if isinstance(dec.func, ast.Name) else None
            if name == "guarded_by" and dec.args and \
                    isinstance(dec.args[0], ast.Constant) and \
                    isinstance(dec.args[0].value, str):
                return dec.args[0].value
    return None


def _iter_writes(node: ast.AST):
    """Yield ``(attr, node)`` for every self-attribute write in ``node``
    (non-recursive into nested defs -- caller controls that)."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from _targets(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        yield from _targets(node.target)
    elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        call = node.value
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _MUTATORS:
            attr = _self_attr(call.func.value)
            if attr is not None:
                yield attr, node


def _targets(t: ast.AST):
    if isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _targets(e)
        return
    if isinstance(t, ast.Starred):
        yield from _targets(t.value)
        return
    attr = _self_attr(t)
    if attr is not None:
        yield attr, t
        return
    # subscript store on a self attribute: self.x[k] = v
    if isinstance(t, ast.Subscript):
        attr = _self_attr(t.value)
        if attr is not None:
            yield attr, t


class _ClassChecker:
    def __init__(self, path: str, cls: ast.ClassDef, findings: list):
        self.path = path
        self.cls = cls
        self.findings = findings
        self.methods = [n for n in cls.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))]
        self.locks = self._designated_locks()
        self.internally_locked = self._internally_locked()
        self.guarded_methods = {m.name: g for m in self.methods
                                if (g := _guarded_by_of(m)) is not None}

    def _init_assigns(self, pred):
        out = set()
        for m in self.methods:
            if m.name != "__init__":
                continue
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and pred(node.value):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            out.add(attr)
        return out

    def _designated_locks(self) -> set:
        return self._init_assigns(_is_lock_ctor)

    def _internally_locked(self) -> set:
        """Attrs holding a repro_torch.obs instrument: each owns a private
        lock, so the class lock discipline is neither inferred from nor
        enforced on writes to them."""
        return self._init_assigns(_is_obs_ctor)

    # -- pass 1: infer guarded attributes ------------------------------
    def _infer_guarded(self) -> dict:
        """attr -> set of locks it has been seen written under."""
        guarded: dict[str, set] = {}

        def note(attr, lock):
            if attr in self.internally_locked:
                return
            guarded.setdefault(attr, set()).add(lock)

        for m in self.methods:
            if m.name == "__init__":
                continue
            held0 = set()
            g = self.guarded_methods.get(m.name)
            if g in self.locks:
                held0.add(g)
            self._walk_infer(m.body, held0, note)
        return guarded

    def _walk_infer(self, body, held: set, note) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_infer(stmt.body, set(), note)
                continue
            if isinstance(stmt, ast.With):
                inner = set(held)
                for item in stmt.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.locks:
                        inner.add(attr)
                self._walk_infer(stmt.body, inner, note)
                continue
            for attr, _node in _iter_writes(stmt):
                for lock in held:
                    note(attr, lock)
            # recurse into compound statements, preserving held set
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk_infer(sub, held, note)
            for h in getattr(stmt, "handlers", ()):
                self._walk_infer(h.body, held, note)

    # -- pass 2: check every write / guarded call ----------------------
    def check(self) -> None:
        for name, lock in self.guarded_methods.items():
            if lock not in self.locks:
                m = next(m for m in self.methods if m.name == name)
                self.findings.append(Finding(
                    "unknown-lock", self.path, m.lineno, m.col_offset + 1,
                    f"@guarded_by('{lock}') on {self.cls.name}.{name} "
                    f"names no designated lock of the class "
                    f"(designated: {sorted(self.locks) or 'none'})"))
        if not self.locks:
            return
        guarded = self._infer_guarded()
        for m in self.methods:
            if m.name == "__init__":
                continue
            held0 = set()
            g = self.guarded_methods.get(m.name)
            if g in self.locks:
                held0.add(g)
            self._walk_check(m, m.body, held0, guarded)

    def _walk_check(self, method, body, held: set, guarded: dict) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # closures may run on another thread, without the lock
                self._walk_check(method, stmt.body, set(), guarded)
                continue
            if isinstance(stmt, ast.With):
                inner = set(held)
                for item in stmt.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.locks:
                        inner.add(attr)
                self._walk_check(method, stmt.body, inner, guarded)
                continue
            for attr, node in _iter_writes(stmt):
                if attr in self.internally_locked:
                    continue
                locks_for = guarded.get(attr)
                if locks_for and not (held & locks_for):
                    self.findings.append(Finding(
                        "unguarded-write", self.path, node.lineno,
                        node.col_offset + 1,
                        f"{self.cls.name}.{method.name} writes "
                        f"self.{attr} without holding "
                        f"{'/'.join(sorted(locks_for))} (other sites "
                        "write it under the lock)"))
            # scan only this statement's own expressions for guarded
            # calls -- sub-statements are visited by the recursion below,
            # with their correct held-lock set
            compound = isinstance(stmt, (ast.If, ast.While, ast.For,
                                         ast.Try))
            if compound:
                headers = [getattr(stmt, "test", None),
                           getattr(stmt, "iter", None)]
                exprs = [h for h in headers if h is not None]
            else:
                exprs = [stmt]
            for expr in exprs:
                for node in ast.walk(expr):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute):
                        callee = _self_attr(node.func)
                        lock = self.guarded_methods.get(callee)
                        if lock in self.locks and lock not in held:
                            self.findings.append(Finding(
                                "unguarded-call", self.path, node.lineno,
                                node.col_offset + 1,
                                f"{self.cls.name}.{method.name} calls "
                                f"@guarded_by('{lock}') method "
                                f"self.{callee}() without holding "
                                f"self.{lock}"))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk_check(method, sub, held, guarded)
            for h in getattr(stmt, "handlers", ()):
                self._walk_check(method, h.body, held, guarded)


def check_module(path: str, tree: ast.Module) -> list:
    findings: list = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            _ClassChecker(path, node, findings).check()
    return findings
