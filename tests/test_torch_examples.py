"""The port's examples on the CPU: ``examples/quickstart_torch.py``
against the reference's ``examples/quickstart.py`` (the same protocol
choice and the same ids), and ``examples/edge_serving_torch.py``, whose
every served answer must equal ``SearchIndex.search`` on the same index,
below the §5.3 threshold (the tree) and above it (the two-level index,
PQ top and brute bottom, the example's default kind)."""
from __future__ import annotations

import os
import runpy

import numpy as np
import pytest

from test_torch_reference import REPO, _modules_after, reference  # noqa: F401

EXAMPLES = os.path.join(REPO, "examples")


def _example(name: str) -> dict:
    return runpy.run_path(os.path.join(EXAMPLES, name), run_name="example")


def test_quickstart_matches_the_reference(reference, capsys):
    """The reference's script run as it stands (its module-level code,
    with the reference loaded) and the port's on the CPU: QLBT chosen by
    both, the beam search's ids equal on every query and slot."""
    ns = runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"),
                        run_name="reference_quickstart")
    theirs = capsys.readouterr().out
    mine = _example("quickstart_torch.py")["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert mine["kind"] == ns["index"].spec.kind == "qlbt"
    ids = np.asarray(ns["ids"])
    np.testing.assert_array_equal(mine["ids"], ids)
    # distances to 1e-5 of |q|^2 + |x|^2, the scale the expansion rounds
    # on (ROADMAP faults 2 and 7)
    q, db = (np.asarray(ns[k], np.float64) for k in ("queries", "db"))
    scale = (q ** 2).sum(1)[:, None] + (db ** 2).sum(1)[ids]
    assert (np.abs(mine["dists"] - np.asarray(ns["dists"]))
            <= 1e-5 * scale).all()
    for line in ("protocol chose: qlbt", "recall@10 = ",
                 "recall@10 vs exact-NN = "):
        assert line in out and line in theirs
    assert out.splitlines()[1] == theirs.splitlines()[1]     # recall@10


@pytest.mark.parametrize("n,kind", [(20_000, "tree"), (40_000, "two_level")])
def test_edge_serving_answers_are_the_index_answers(n, kind, capsys):
    """64 requests at 500 qps through the engine (a hedged replica):
    every served answer, in the order submitted, equals the index's own
    search of the same queries; the recall line is printed."""
    res = _example("edge_serving_torch.py")["main"](
        ["--n", str(n), "--n-requests", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    index = res["index"]
    assert index.spec.kind == kind
    d, i, _ = index.search(res["queries"], 10, nprobe=16)
    np.testing.assert_array_equal(res["ids"], i)
    # distances to 1e-5 of |q|^2 + |x|^2, the file's rule: a micro-batch
    # the load splits otherwise rounds the (qn + xn) - 2 q.x expansion by
    # a unit at its magnitude (ROADMAP fault 7)
    q = np.asarray(res["queries"], np.float64)
    db = np.asarray(index.db, np.float64)
    scale = (q ** 2).sum(1)[:, None] + (db ** 2).sum(1)[i]
    assert (np.abs(np.asarray(res["dists"], np.float64) - d)
            <= 1e-5 * scale).all()
    assert "recall@10 = " in out and "paper SLO (P90 < 80 ms)" in out
    r = float(out.split("recall@10 = ")[1].split()[0])
    assert 0.0 < r <= 1.0
    if kind == "two_level":
        assert index.spec.two_level.top == "pq"
        assert index.spec.two_level.bottom == "brute"


@pytest.mark.parametrize("code", [
    "import examples.quickstart_torch, examples.edge_serving_torch, "
    "repro_torch.kernels.ops",
    "import repro_torch.launch.dryrun, repro_torch.launch.step_analysis, "
    "repro_torch.kernels.ops",
    "import repro_torch.kernels.tree_descent, repro_torch.core.tree, "
    "repro_torch.core, repro_torch.kernels.ops",
])
def test_new_modules_import_neither_jax_nor_reference(code):
    mods = _modules_after(code)
    assert "repro_torch.kernels.ops" in mods
    assert not any(m == "jax" or m.startswith("jax.") for m in mods)
    assert not any(m == "repro" or m.startswith("repro.") for m in mods)
