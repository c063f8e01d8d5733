"""The port's analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* The snippets of ``tests/test_analysis.py``'s suppression and lock
  tests go through both packages' ``core`` (and so ``locks``); the
  suppression snippets are written once for JAX and once for the port
  (``@jax.jit`` -> ``@hot_path``, ``jnp.zeros`` -> ``torch.zeros``, on
  the same lines and columns).  Findings must be equal: rule, line and
  column, active and suppressed.
* Both lock checkers over every file of ``src/repro_torch``: equal, and
  empty.
* Each ``torchlint`` rule: snippets that fire and snippets that stay
  quiet.
* The recompile gate's seeded cases over a CPU backend's
  ``jit_cache_size``, the seven registered entry points (names and step
  labels equal the reference's), the whole gate on the CPU (``[]``, as
  the reference's gate on the same names, its mesh built with Auto axes,
  ROADMAP fault 16), and the CLI.

Every comparison is exact: these are counts and source positions.
"""
from __future__ import annotations

import ast
import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_reference import REPO, reference_modules

from repro_torch.analysis import locks as port_locks
from repro_torch.analysis import run_static_analysis
from repro_torch.analysis.core import iter_py_files
from repro_torch.analysis.recompile import Plan, run_entry_point
from repro_torch.analysis.registry import ENTRY_POINTS, register_entry_point
from repro_torch.distributed.backend import ShardedSearchBackend

PORT_SRC = os.path.join(REPO, "src", "repro_torch")
PORT_FILES = [os.path.relpath(p, REPO) for p in iter_py_files([PORT_SRC])]
SEVEN = ("brute-delta-scatter", "filtered-sharded-search",
         "fleet-router-search", "fused-sharded-search",
         "sharded-brute-search", "sharded-forest-search",
         "sharded-ivf-search")


@pytest.fixture(scope="module")
def ref():
    """The reference's analysis modules, loaded for this module only."""
    with reference_modules() as ns:
        for name in ("core", "locks", "recompile", "registry"):
            setattr(ns, "a_" + name,
                    importlib.import_module(f"repro.analysis.{name}"))
        yield ns


def _write(tmp_path, source, name):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return str(p)


def _positions(findings):
    return sorted((f.rule, f.line, f.col) for f in findings)


# ---------------------------------------------------------------------------
# the reference's suppression and lock snippets through both packages
# ---------------------------------------------------------------------------

_LOCKED_CLASS = """
    import threading
    from repro.analysis.annotations import guarded_by

    class Engine:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0          # __init__ writes are exempt
            self.items = []
            self.total = 0

        def good(self):
            with self._lock:
                self.count = 1
                self.items.append(1)
                self.total += 1

        def bad_assign(self):
            self.count = 2

        def bad_mutator(self):
            self.items.append(2)

        def bad_augassign(self):
            self.total += 2
"""

LOCK_SNIPPETS = {
    "three-unguarded-write-kinds": _LOCKED_CLASS,
    "guarded-by-satisfies": """
        import threading
        from repro.analysis.annotations import guarded_by

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def caller(self):
                with self._lock:
                    self._bump()

            @guarded_by("_lock")
            def _bump(self):
                self.count += 1
    """,
    "unguarded-call": """
        import threading
        from repro.analysis.annotations import guarded_by

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def caller(self):
                self._bump()

            @guarded_by("_lock")
            def _bump(self):
                self.count += 1
    """,
    "unknown-lock": """
        import threading
        from repro.analysis.annotations import guarded_by

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            @guarded_by("_mutex")
            def bump(self):
                with self._lock:
                    self.count += 1
    """,
    "closure-without-lock": """
        import threading

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def tick(self):
                with self._lock:
                    self.count += 1

            def dispatch(self):
                with self._lock:
                    def primary():
                        self.count += 1
                    return primary
    """,
    "class-without-lock": """
        class Plain:
            def __init__(self):
                self.count = 0

            def bump(self):
                self.count += 1
    """,
    "obs-instruments-exempt": """
        import threading
        from repro.obs.metrics import MetricsRegistry, Histogram

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.metrics = MetricsRegistry()
                self._h = self.metrics.histogram("latency_ms")
                self._c = self.metrics.counter("hits")
                self.samples = []

            def locked_path(self):
                with self._lock:
                    self._h = Histogram("latency_ms")
                    self.samples.append(1)

            def unlocked_path(self):
                self._h = Histogram("latency_ms")
                self._c = self.metrics.counter("hits")
                self.samples.append(2)
    """,
}

SUPPRESSION_SNIPPETS = {
    "same-line": """
        import jax, jax.numpy as jnp

        @jax.jit
        def f(x):
            return jnp.zeros(4) + x  # repro: allow(implicit-dtype): seeded
    """,
    "line-above": """
        import jax, jax.numpy as jnp

        @jax.jit
        def f(x):
            # repro: allow(implicit-dtype): seeded
            return jnp.zeros(4) + x
    """,
    "bare-allow": """
        import jax, jax.numpy as jnp

        @jax.jit
        def f(x):
            return jnp.zeros(4) + x  # repro: allow(implicit-dtype)
    """,
    "unknown-rule-id": """
        x = 1  # repro: allow(made-up-rule): no such rule
    """,
    "unused-suppression": """
        x = 1  # repro: allow(host-sync): nothing to suppress here
    """,
    "no-leak-to-far-lines": """
        import jax, jax.numpy as jnp

        # repro: allow(implicit-dtype): too far away to cover

        @jax.jit
        def f(x):
            return jnp.zeros(4) + x
    """,
}


def _to_port(source: str) -> str:
    """The JAX snippet's counterpart on the same lines and columns."""
    return (source.replace(
        "import jax, jax.numpy as jnp",
        "import torch; from repro_torch.analysis import hot_path")
        .replace("@jax.jit", "@hot_path")
        .replace("jnp.zeros", "torch.zeros")
        .replace("from repro.", "from repro_torch."))


@pytest.mark.parametrize("name", sorted(LOCK_SNIPPETS) +
                         sorted(SUPPRESSION_SNIPPETS))
def test_snippet_findings_equal_the_reference(ref, tmp_path, name):
    src = LOCK_SNIPPETS.get(name) or SUPPRESSION_SNIPPETS[name]
    theirs = ref.a_core.run_static_analysis(
        [_write(tmp_path, src, "ref_mod.py")])
    mine = run_static_analysis(
        [_write(tmp_path, _to_port(src), "port_mod.py")])
    for t, m in zip(theirs, mine):          # active, then suppressed
        assert _positions(m) == _positions(t)
    assert theirs[0] or theirs[1] or name in ("guarded-by-satisfies",
                                              "class-without-lock")


@pytest.mark.parametrize("path", PORT_FILES)
def test_both_lock_checkers_agree_and_are_clean(ref, path):
    tree = ast.parse(open(os.path.join(REPO, path), encoding="utf-8").read())
    theirs = ref.a_locks.check_module(path, tree)
    mine = port_locks.check_module(path, tree)
    assert _positions(mine) == _positions(theirs)
    assert mine == [], "\n".join(f.format() for f in mine)


def test_port_tree_is_clean():
    active, suppressed = run_static_analysis([PORT_SRC])
    assert active == [], "\n".join(f.format() for f in active)
    assert suppressed == []


# ---------------------------------------------------------------------------
# torchlint: each rule fires on its snippet and stays quiet on the fix
# ---------------------------------------------------------------------------

_HEAD = ("import numpy as np\nimport torch\n"
         "from repro_torch.analysis.annotations import hot_path\n")

LINT_CASES = [
    # (rule, body, fires)
    ("host-sync", """
        @hot_path
        def f(x, k: int):
            return x.sum().item() + k
     """, True),
    ("host-sync", """
        @hot_path
        def f(x):
            d = torch.where(x > 0, x, 0.0)
            return d.cpu()
     """, True),
    ("host-sync", """
        @hot_path
        def f(x):
            torch.cuda.synchronize()
            return x
     """, True),
    ("host-sync", """
        @hot_path
        def f(x, stream: object):
            stream.synchronize()
            return x
     """, True),
    ("host-sync", """
        @hot_path
        def f(x):
            return float(x.max()) + np.asarray(x).sum()
     """, True),
    ("host-sync", """
        @hot_path
        def f(x, n_q: int):
            b = x.shape[0] // n_q
            return x[:b] * float(n_q) + int(x.numel())
     """, False),
    ("host-sync", """
        def not_hot(x):
            return x.cpu().numpy()
     """, False),
    ("traced-branch", """
        @hot_path
        def f(x):
            if (x > 0).any():
                return x
            return -x
     """, True),
    ("traced-branch", """
        @hot_path
        def f(x, lin: int = 0):
            while x.sum() > 0:
                x = x - 1
            assert x.min() >= 0
            return x
     """, True),
    ("traced-branch", """
        @hot_path
        def f(x, valid=None, lin: int = 0):
            if valid is None or x.shape[0] == 0 or len(x) > 4:
                return x
            if lin and x.ndim == 2 and x.device.type == "cuda":
                return x[valid]
            return x if x.numel() else valid
     """, False),
    ("traced-branch", """
        @hot_path
        def f(x, w):
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, w))
            if grad:
                return x * w
            return x
     """, False),
    ("traced-branch", """
        @hot_path
        def f(x, w):
            if torch.is_grad_enabled() and (x * w).sum() > 0:
                return x * w
            return x
     """, True),
    ("implicit-dtype", """
        @hot_path
        def f(x):
            return x + torch.arange(x.shape[0], device=x.device)
     """, True),
    ("implicit-dtype", """
        @hot_path
        def f(x):
            return x + torch.zeros((1, 1)) + torch.as_tensor([1.0])
     """, True),
    ("implicit-dtype", """
        @hot_path
        def f(x):
            a = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
            b = torch.full((1, 1), 2.0, dtype=torch.float32)
            return x + a + b + torch.as_tensor([1], torch.int32)
     """, False),
    ("scatter-not-in-place", """
        def apply(self, rows, vals):
            self.table = self.table.index_put((rows,), vals)
     """, True),
    ("scatter-not-in-place", """
        def apply(t, idx, src):
            t = torch.scatter(t, 0, idx, src)
            return t
     """, True),
    ("scatter-not-in-place", """
        def apply(self, rows, vals, idx, src, order):
            self.table.index_put_((rows,), vals)
            self.table[rows] = vals
            fresh = torch.zeros((4, 4), dtype=torch.bool).scatter(1, order,
                                                                  src)
            return fresh
     """, False),
    ("non-pow2-pad", """
        def call(self, qs):
            b = qs.shape[0]
            qs = np.pad(qs, ((0, b + 3 - b), (0, 0)))
            return self._fn(qs)
     """, True),
    ("non-pow2-pad", """
        def call(self, qs, n_q):
            b = qs.shape[0]
            bb = _pow2(b)
            qs = np.pad(qs, ((0, bb - b), (0, 0)))
            qm = np.pad(qs, ((0, -(-b // n_q) * n_q - b), (0, 0)))
            return self._fn(qs), search_blocks(qm)
     """, False),
    ("non-pow2-pad", """
        def no_hot_call(qs):
            return np.pad(qs, ((0, qs.shape[0] + 3), (0, 0)))
     """, False),
]


@pytest.mark.parametrize("case", range(len(LINT_CASES)),
                         ids=[f"{r}-{'fires' if f else 'quiet'}-{i}"
                              for i, (r, _, f) in enumerate(LINT_CASES)])
def test_torchlint_rule(tmp_path, case):
    rule, body, fires = LINT_CASES[case]
    path = _write(tmp_path, _HEAD + textwrap.dedent(body), "mod.py")
    active, _ = run_static_analysis([path])
    got = [f.rule for f in active]
    if fires:
        assert got and set(got) == {rule}, got
    else:
        assert got == [], [f.format() for f in active]


def test_torchlint_waiver_reads_as_the_references(tmp_path):
    path = _write(tmp_path, _HEAD + textwrap.dedent("""
        @hot_path
        def f(x):
            # repro: allow(host-sync): the copy-back ends the dispatch
            return x.cpu()
    """), "mod.py")
    active, suppressed = run_static_analysis([path])
    assert active == [] and [f.rule for f in suppressed] == ["host-sync"]


def test_list_rules_names_the_rule_without_a_counterpart():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--list-rules"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0
    lines = out.stdout.splitlines()
    dead = [ln for ln in lines if ln.startswith("missing-static-argnames")]
    assert len(dead) == 1 and "reference only" in dead[0]
    for rid in ("host-sync", "traced-branch", "implicit-dtype",
                "scatter-not-in-place", "non-pow2-pad", "unguarded-write",
                "recompile"):
        assert any(ln.startswith(rid + " ") for ln in lines), rid


# ---------------------------------------------------------------------------
# the recompile gate: seeded cases over a CPU backend's jit_cache_size
# ---------------------------------------------------------------------------


def _brute(n=48, d=8):
    rng = np.random.default_rng(0)
    db = rng.normal(size=(n, d)).astype(np.float32)
    return ShardedSearchBackend(db, kind="brute", k=4, headroom=2.0,
                                device="cpu"), rng


def _q(rng, b, dtype=np.float32, d=8):
    return rng.normal(size=(b, d)).astype(dtype)


def _plan(steps, be, warmup=1):
    return Plan(steps=steps, cache_size=be.jit_cache_size,
                warmup_steps=warmup)


def _rules(found):
    return sorted(f.rule for f in found)


def test_gate_varying_batch_shape_triggers():
    be, rng = _brute()

    def make_plan():
        return _plan([("warmup", lambda: be(_q(rng, 4))),
                      ("grown-shape", lambda: be(_q(rng, 5)))], be)

    found = run_entry_point("seeded-shape", make_plan)
    assert _rules(found) == ["recompile"]
    assert "grown-shape" in found[0].message
    assert "(1 -> 2 cached variants)" in found[0].message


def test_gate_dtype_change_is_cast_away():
    """The reference's dtype trigger cannot reach a dispatch signature
    here: the backend casts every batch to float32 on the host, so a
    float64 batch after a float32 warm-up is the same variant."""
    be, rng = _brute()

    def make_plan():
        return _plan([("warmup", lambda: be(_q(rng, 4))),
                      ("dtype-change", lambda: be(_q(rng, 4, np.float64)))],
                     be)

    assert run_entry_point("seeded-dtype", make_plan) == []
    assert be.jit_cache_size() == 1


def test_gate_operand_dtype_change_triggers():
    """A mode whose operands have another dtype (the lexical mode's int32
    term ids after float32 queries) is a new signature."""
    from repro_torch.core.lexical import build_lexical_slabs, query_operands

    rng = np.random.default_rng(0)
    db = rng.normal(size=(48, 8)).astype(np.float32)
    docs = [list(rng.integers(0, 16, 4)) for _ in range(48)]
    slabs = build_lexical_slabs(docs, 16)
    be = ShardedSearchBackend(db, kind="brute", k=4, lexical=slabs,
                              device="cpu")
    qt, qw = query_operands(docs[:4], slabs)

    def make_plan():
        return _plan(
            [("warmup", lambda: be(_q(rng, 4))),
             ("int32-operands", lambda: be(None, mode="lexical", q_terms=qt,
                                           q_weights=qw))], be)

    found = run_entry_point("seeded-operand-dtype", make_plan)
    assert _rules(found) == ["recompile"]


def test_gate_stable_shapes_stay_quiet():
    be, rng = _brute()
    x = _q(rng, 4)

    def make_plan():
        return _plan([("warmup", lambda: be(x)),
                      ("repeat-1", lambda: be(x + 1)),
                      ("repeat-2", lambda: be(x + 2))], be)

    assert run_entry_point("seeded-stable", make_plan) == []


def test_gate_reshaped_placement_triggers():
    """A re-place within the headroom keeps the tables' shapes; a corpus
    of another width does not, and counts."""
    be, rng = _brute()
    x = _q(rng, 4)

    def make_plan():
        return _plan(
            [("warmup", lambda: be(x)),
             ("re-place", lambda: be.apply_updates(_q(rng, 60))),
             ("wider-rows", lambda: be.apply_updates(_q(rng, 60, d=16)))],
            be)

    found = run_entry_point("seeded-reshape", make_plan)
    assert _rules(found) == ["recompile"]
    assert "wider-rows" in found[0].message


def test_gate_multi_bucket_warmup_is_respected():
    be, rng = _brute()

    def make_plan():
        return _plan([("warmup-a", lambda: be(_q(rng, 4))),
                      ("warmup-b", lambda: be(_q(rng, 8))),
                      ("replay-a", lambda: be(_q(rng, 4))),
                      ("replay-b", lambda: be(_q(rng, 8)))], be, warmup=2)

    assert run_entry_point("seeded-two-buckets", make_plan) == []


def test_gate_plan_factory_failure_is_a_finding():
    def make_plan():
        raise RuntimeError("boom")

    found = run_entry_point("seeded-broken", make_plan)
    assert _rules(found) == ["entry-point-error"]
    assert "boom" in found[0].message


def test_gate_step_failure_is_a_finding():
    be, _ = _brute()

    def bad_step():
        raise ValueError("step boom")

    def make_plan():
        return _plan([("bad", bad_step)], be)

    found = run_entry_point("seeded-bad-step", make_plan)
    assert _rules(found) == ["entry-point-error"]
    assert "step boom" in found[0].message


def test_register_entry_point_shadowing():
    before = dict(ENTRY_POINTS)
    try:
        @register_entry_point("seeded-shadow")
        def _seed(device=None):
            return Plan(steps=[], cache_size=lambda: 0)

        assert ENTRY_POINTS["seeded-shadow"] is _seed

        @register_entry_point("seeded-shadow")
        def _seed2(device=None):
            return Plan(steps=[], cache_size=lambda: 0)

        assert ENTRY_POINTS["seeded-shadow"] is _seed2
    finally:
        ENTRY_POINTS.clear()
        ENTRY_POINTS.update(before)


# ---------------------------------------------------------------------------
# the seven entry points, the whole gate, the CLI
# ---------------------------------------------------------------------------


def test_seven_entry_points_are_the_references(ref):
    assert tuple(sorted(ENTRY_POINTS)) == SEVEN
    assert tuple(sorted(ref.a_registry.ENTRY_POINTS)) == SEVEN


def test_gate_on_the_cpu_finds_nothing_as_the_references(ref, monkeypatch):
    import jax

    from repro_torch.analysis.recompile import run_recompile_gate

    assert run_recompile_gate(device="cpu") == []
    auto = jax.sharding.AxisType.Auto
    monkeypatch.setattr(ref.a_registry, "_mesh1", lambda: jax.make_mesh(
        (1,), ("data",), axis_types=(auto,)))
    assert ref.a_recompile.run_recompile_gate(SEVEN) == []


@pytest.mark.parametrize("strict", [False, True])
def test_cli_exits_zero_on_the_port(strict):
    cmd = [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"]
    if strict:
        cmd += ["--strict", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=REPO,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stderr.strip().startswith("0 finding(s)")


def test_cli_exits_one_on_a_finding(tmp_path):
    path = _write(tmp_path, _HEAD + textwrap.dedent("""
        @hot_path
        def f(x):
            return x.item()
    """), "mod.py")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", path],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 1
    assert ": host-sync: " in out.stdout
