"""Compile-path lint for the port: AST rules over ``@hot_path`` bodies,
the counterpart of ``repro/analysis/jaxlint.py``.

The serving latency the port claims assumes the per-dispatch path never
waits for the card before the copy-back and never mints a new compiled
variant.  The reference finds its hot code by ``jax.jit``; nothing is
traced here, so a function that runs once per dispatch carries the
``@hot_path`` marker (``repro_torch.analysis.annotations``) and this pass
reads those bodies.  The rules keep the reference's ids where the
meaning carries over:

``host-sync``
    Inside a hot function: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` of a tensor, ``torch.cuda.synchronize()`` or any
    ``.synchronize()``, ``float()/int()/bool()`` of a tensor, or
    ``np.asarray``/``np.array`` of a tensor.  Each blocks the host on
    the card.  The sanctioned waits (the backend's stream synchronise
    and the copy-back of the merged top-k) sit outside hot functions.
``traced-branch``
    A Python ``if`` / ``while`` / ``assert`` (or conditional expression)
    on a tensor's *value* in hot code: ``bool()`` of a tensor, a hidden
    sync on the card.  ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device``,
    ``.requires_grad``, ``.numel()`` / ``.dim()`` / ``.size()``,
    ``len()``, ``torch.is_grad_enabled()`` (autograd's mode) and an
    identity test (``is None``) are static.
``implicit-dtype``
    ``torch.tensor`` / ``as_tensor`` / ``zeros`` / ``ones`` / ``full`` /
    ``empty`` / ``arange`` without a ``dtype`` in hot code.  The default
    follows the arguments (``arange`` of ints is int64, of a float
    fp32), which lets a dtype drift into a dispatch signature.
``scatter-not-in-place``
    Anywhere: an out-of-place ``index_put`` / ``scatter`` /
    ``index_copy`` / ``masked_scatter`` whose result is assigned back to
    the tensor it was called on (the same name, attribute or item).  It
    copies the whole placed table, where the port's contract is an
    in-place update (``index_put_``, ``t[rows] = v``).  The counterpart
    of ``scatter-not-donated``.
``non-pow2-pad``
    A function that calls a hot function (or a backend's local) pads an
    operand's leading dimension to a size not derived from a
    shape-bucketing helper (``_pow2`` / ``_bucket`` /
    ``_grid_pad`` / ``bit_length`` / ceil-to-multiple): every distinct
    size is a new dispatch signature.

The reference's ``missing-static-argnames`` has no counterpart
(:data:`NO_COUNTERPART`): nothing is traced, so no argument is static or
not; a branch on a hot function's tensor parameter is a
``traced-branch``.

Taint model (intra-function, as the reference's): a hot function's
parameters hold tensors unless annotated with another type (``lin:
int``); ``torch.*`` call results and anything computed from a tensor
are tensors; the static attributes and calls above are not.  Helpers
only *called* from hot code are out of scope unless marked.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import STATIC_RULES, Finding

__all__ = ["NO_COUNTERPART", "check_module"]

STATIC_RULES.update({
    "host-sync": "host synchronization on a tensor in @hot_path code",
    "traced-branch": "Python branch on a tensor's value in @hot_path code",
    "implicit-dtype":
        "torch tensor creation without an explicit dtype in @hot_path code",
    "scatter-not-in-place":
        "out-of-place scatter assigned back to the tensor it copies",
    "non-pow2-pad":
        "pad at a hot-path call not derived from a shape-bucketing helper",
})

# reference rule ids with no port counterpart, and why (--list-rules)
NO_COUNTERPART = {
    "missing-static-argnames":
        "nothing is traced in the port, so no argument is static; a branch "
        "on a hot function's tensor parameter is a traced-branch",
}

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad"}
_STATIC_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                   "stride", "is_contiguous", "get_device", "bit_length"}
_STATIC_CALLS = {"len", "isinstance", "type", "range", "enumerate", "zip",
                 "getattr", "hasattr", "torch.device", "torch.Size",
                 "torch.finfo", "torch.iinfo", "torch.is_tensor",
                 "torch.is_grad_enabled"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAST_FUNCS = {"float", "int", "bool", "complex"}
# creation calls and the positional index at which their dtype may come
# (None: keyword only)
_CREATIONS = {"tensor": None, "as_tensor": 1, "zeros": None, "ones": None,
              "full": None, "empty": None, "arange": None}
_SCATTERS = {"index_put", "scatter", "index_copy", "masked_scatter"}
_BUCKET_HELPERS = {"_pow2", "_bucket", "_grid_pad", "_pad_batch",
                   "_pad_terms", "next_pow2", "pow2", "next_power_of_2"}
_PAD_FUNCS = {"pad"}
# attributes holding hot callables (a backend's per-mode locals) and the
# entry that runs them
_HOT_CALLEES = {"_fn", "_fn_lex", "_fn_hyb", "search_blocks"}


def _attr_path(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute/name chain, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_torch_path(path: Optional[str]) -> bool:
    return bool(path) and path.split(".")[0] == "torch"


def _is_np_path(path: Optional[str]) -> bool:
    return bool(path) and path.split(".")[0] in ("np", "numpy")


def _is_hot(fn: ast.AST) -> bool:
    return any(_attr_path(d) in ("hot_path", "annotations.hot_path")
               for d in fn.decorator_list)


def _static_annotation(arg: ast.arg) -> bool:
    """A parameter annotated with a type other than a tensor holds no
    tensor."""
    if arg.annotation is None:
        return False
    return "Tensor" not in ast.unparse(arg.annotation)


class _TaintChecker:
    """Walks one hot function body, tracking which local names hold
    tensors, and emits host-sync / traced-branch / implicit-dtype
    findings."""

    def __init__(self, path: str, fn: ast.FunctionDef, findings: list):
        self.path = path
        self.fn = fn
        self.findings = findings
        args = fn.args
        params = (args.posonlyargs + args.args + args.kwonlyargs
                  + [a for a in (args.vararg, args.kwarg) if a is not None])
        self.tainted = {a.arg for a in params
                        if a.arg != "self" and not _static_annotation(a)}

    # -- taint ---------------------------------------------------------
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            fpath = _attr_path(node.func)
            if fpath in _STATIC_CALLS:
                return False
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _STATIC_METHODS:
                    return False
                if self.is_tainted(node.func.value):
                    return True                  # tensor.method(...)
            if _is_torch_path(fpath):
                return True                      # torch.fn(...) -> tensor
            return (any(self.is_tainted(a) for a in node.args)
                    or any(self.is_tainted(kw.value)
                           for kw in node.keywords))
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False                     # identity reads no value
            return self.is_tainted(node.left) or \
                any(self.is_tainted(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return any(self.is_tainted(n)
                       for n in (node.test, node.body, node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        return False

    def _bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)

    # -- rules ---------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            rule, self.path, node.lineno, node.col_offset + 1, msg))

    def _check_call(self, node: ast.Call) -> None:
        fpath = _attr_path(node.func)
        where = f"hot-path '{self.fn.name}'"
        if fpath == "torch.cuda.synchronize" or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "synchronize"):
            self._emit("host-sync", node,
                       f"{ast.unparse(node.func)}() inside {where} waits "
                       "for the card -- synchronise outside the dispatch")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and \
                self.is_tainted(node.func.value):
            self._emit("host-sync", node,
                       f".{node.func.attr}() on a tensor inside {where} "
                       "blocks on the card -- keep the value on the device "
                       "or move the copy out of the hot path")
        elif fpath in _CAST_FUNCS and node.args and \
                self.is_tainted(node.args[0]):
            self._emit("host-sync", node,
                       f"{fpath}() of a tensor inside {where} forces a "
                       "host sync -- keep it a tensor")
        elif _is_np_path(fpath) and fpath.split(".")[-1] in (
                "asarray", "array") and node.args and \
                self.is_tainted(node.args[0]):
            self._emit("host-sync", node,
                       f"{fpath}() copies a tensor to the host inside "
                       f"{where}")
        if _is_torch_path(fpath):
            base = fpath.split(".")[-1]
            if base in _CREATIONS and fpath.count(".") == 1:
                pos = _CREATIONS[base]
                has_dtype = any(kw.arg == "dtype" for kw in node.keywords) \
                    or (pos is not None and len(node.args) > pos)
                if not has_dtype:
                    self._emit(
                        "implicit-dtype", node,
                        f"torch.{base}(...) without an explicit dtype inside "
                        f"{where} -- the default follows the arguments and "
                        "can drift into a dispatch signature")

    def _branch_rule(self, node, test: ast.AST, kind: str) -> None:
        if self.is_tainted(test):
            self._emit(
                "traced-branch", node,
                f"Python {kind} on a tensor's value inside hot-path "
                f"'{self.fn.name}' -- bool() of a tensor waits for the "
                "card; use torch.where or decide on the host")

    def run(self) -> None:
        self._walk(self.fn.body)

    def _walk(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _exprs_in(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_call(sub)
            elif isinstance(sub, ast.IfExp):
                self._branch_rule(sub, sub.test, "conditional expression")

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs per dispatch too
            _TaintChecker(self.path, stmt, self.findings).run()
            return
        if isinstance(stmt, ast.Assign):
            self._exprs_in(stmt.value)
            t = self.is_tainted(stmt.value)
            for target in stmt.targets:
                self._bind(target, t)
            return
        if isinstance(stmt, ast.AugAssign):
            self._exprs_in(stmt.value)
            if self.is_tainted(stmt.value):
                self._bind(stmt.target, True)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._exprs_in(stmt.value)
            self._bind(stmt.target, self.is_tainted(stmt.value))
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._exprs_in(stmt.test)
            self._branch_rule(stmt, stmt.test,
                              "if" if isinstance(stmt, ast.If) else "while")
            self._walk(stmt.body)
            self._walk(stmt.orelse)
            return
        if isinstance(stmt, ast.Assert):
            self._exprs_in(stmt.test)
            self._branch_rule(stmt, stmt.test, "assert")
            return
        if isinstance(stmt, ast.For):
            self._exprs_in(stmt.iter)
            self._bind(stmt.target, self.is_tainted(stmt.iter))
            self._walk(stmt.body)
            self._walk(stmt.orelse)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._exprs_in(item.context_expr)
            self._walk(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body)
            for h in stmt.handlers:
                self._walk(h.body)
            self._walk(stmt.orelse)
            self._walk(stmt.finalbody)
            return
        # Return / Expr / Raise / Pass / etc: just scan calls
        self._exprs_in(stmt)


# ---------------------------------------------------------------------------
# scatter-not-in-place: an out-of-place scatter assigned back to its source
# ---------------------------------------------------------------------------


def _check_scatters(path: str, tree: ast.Module, findings: list) -> None:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            continue
        call, target = node.value, node.targets[0]
        fpath = _attr_path(call.func)
        source = None
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _SCATTERS and not _is_torch_path(fpath):
            source = call.func.value                  # t = t.scatter(...)
        elif _is_torch_path(fpath) and fpath.split(".")[-1] in _SCATTERS \
                and call.args:
            source = call.args[0]                     # t = torch.scatter(t,)
        if source is None or ast.unparse(source) != ast.unparse(target):
            continue
        op = fpath.split(".")[-1] if fpath else call.func.attr
        findings.append(Finding(
            "scatter-not-in-place", path, node.lineno, node.col_offset + 1,
            f"'{ast.unparse(target)} = ...{op}(...)' copies the whole "
            f"tensor to change a few rows -- update it in place "
            f"({op}_ or an indexed assignment)"))


# ---------------------------------------------------------------------------
# non-pow2-pad: pads feeding hot callables must come from a bucketer
# ---------------------------------------------------------------------------


def _const_names(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_bucketed_expr(node: ast.AST, bucketed: set) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fpath = _attr_path(sub.func)
            if fpath and fpath.split(".")[-1] in _BUCKET_HELPERS:
                return True
            if isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "bit_length":
                return True
        if isinstance(sub, ast.Name) and sub.id in bucketed:
            return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult):
            # ceil-to-multiple: -(-a // b) * b
            for side in (sub.left, sub.right):
                if any(isinstance(x, ast.BinOp)
                       and isinstance(x.op, ast.FloorDiv)
                       for x in ast.walk(side)):
                    return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, int):
            if sub.value > 0 and (sub.value & (sub.value - 1)) == 0:
                return True
    return False


def _check_pads(path: str, fn: ast.FunctionDef, hot_names: set,
                findings: list) -> None:
    calls_hot = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            fpath = _attr_path(node.func)
            if fpath is not None and fpath.split(".")[-1] in hot_names:
                calls_hot = True
    if not calls_hot:
        return
    bucketed: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                _is_bucketed_expr(node.value, bucketed):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bucketed.add(t.id)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        fpath = _attr_path(node.func)
        if fpath is None or fpath.split(".")[-1] not in _PAD_FUNCS \
                or len(node.args) < 2:
            continue
        size_expr = node.args[1]
        if not _const_names(size_expr):
            continue                      # constant pad: shape is fixed
        if _is_bucketed_expr(size_expr, bucketed):
            continue
        findings.append(Finding(
            "non-pow2-pad", path, node.lineno, node.col_offset + 1,
            f"'{fn.name}' pads an operand of a hot-path call to a size not "
            "derived from a shape-bucketing helper (_pow2/_bucket/"
            "_grid_pad/ceil-to-multiple) -- every distinct size is a new "
            "dispatch signature"))


def check_module(path: str, tree: ast.Module) -> list:
    findings: list = []
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    hot = [fn for fn in fns if _is_hot(fn)]
    hot_names = _HOT_CALLEES | {fn.name for fn in hot}
    nested = {id(n) for fn in hot for n in ast.walk(fn) if n is not fn}
    for fn in fns:
        if _is_hot(fn):
            if id(fn) not in nested:     # a hot parent walks its children
                _TaintChecker(path, fn, findings).run()
        elif id(fn) not in nested:
            _check_pads(path, fn, hot_names, findings)
    _check_scatters(path, tree, findings)
    return findings
