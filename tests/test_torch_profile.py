"""The port's profiling layer (``repro_torch.obs.profile`` and the
backend's accounting) against the reference's, on the CPU.

* ``backend_cost`` returns the reference's dict for every kind and
  option (brute f32 / int8, fused / unfused, IVF, forest).
* The same sequence of batch sizes through a port backend and a
  reference backend counts the same ``compile_signatures``, the same
  number of ``first_call_ms`` observations and the same compiled
  variants.
* ``roofline_report``'s analytic fields equal the reference's for each
  kind, on the registry's corpora (the reference's index carried across,
  so both place tables of one shape).
* ``profile_entry_points`` replays the seven entry points with the
  reference's step labels and, step for step, the reference's variant
  counts.
* ``install_compile_hooks`` is idempotent and mirrors a library load.

All comparisons are exact: counts and analytic sums, not device
arithmetic.  The reference backends get a one-device mesh with Auto axes
(ROADMAP fault 16).
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from test_torch_forest_slice import carry
from test_torch_reference import REPO, reference_modules

from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.obs import PROFILE, Tracer, set_tracer
from repro_torch.obs.profile import (backend_cost, install_compile_hooks,
                                     profile_entry_points)

ANALYTIC = ("kind", "fused", "precision", "useful_bytes", "bytes_moved",
            "flops", "analytic_frac", "estimate")
SIZES = [4, 4, 3, 8, 4, 3]


def _mesh():
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((1,), ("data",), axis_types=(auto,))


@pytest.fixture(scope="module")
def ref():
    with reference_modules() as ns:
        ns.profile = importlib.import_module("repro.obs.profile")
        ns.registry = importlib.import_module("repro.analysis.registry")
        yield ns


@pytest.mark.parametrize("kind, fused, precision, extra", [
    ("brute", True, "f32", {}),
    ("brute", False, "f32", {}),
    ("brute", True, "int8", {}),
    ("ivf", True, "f32", dict(n_probe_rows=4 * 40, n_centroids=4)),
    ("ivf", False, "f32", dict(n_probe_rows=4 * 40, n_centroids=4)),
    ("forest", True, "f32", dict(n_probe_rows=4 * 96, n_centroids=4)),
])
@pytest.mark.parametrize("b", [1, 64])
def test_backend_cost_equals_the_references(ref, kind, fused, precision,
                                            extra, b):
    kw = dict(fused=fused, precision=precision, n_rows=1_000_000, d=128,
              b=b, k=10, **extra)
    assert backend_cost(kind, **kw) == ref.profile.backend_cost(kind, **kw)


def _corpus(rng, n):
    c = rng.normal(size=(8, 8)) * 4
    return (c[rng.integers(0, 8, n)]
            + rng.normal(size=(n, 8))).astype(np.float32)


def _pair(ref, kind: str, **kw):
    """(port backend, reference backend) on the registry's corpora: the
    brute corpus, or the reference's index carried across."""
    rng = np.random.default_rng(7)
    if kind == "brute":
        target = ref_target = _corpus(rng, 96)
    else:
        _, ref_target = ref.registry._index(
            rng, "brute" if kind == "ivf" else "qlbt")
        target = carry(ref_target)
    port = ShardedSearchBackend(target, kind=kind, k=5, device="cpu", **kw)
    theirs = ref.backend.ShardedSearchBackend(
        _mesh(), ref_target, kind=kind, k=5, axes=("data",), **kw)
    return port, theirs, rng


KINDS = [("brute", dict(headroom=2.0)),
         ("brute", dict(headroom=2.0, precision="int8")),
         ("brute", dict(headroom=2.0, fused=False)),
         ("ivf", dict(nprobe_local=4, headroom=2.0)),
         ("forest", dict(nprobe_local=4, beam_width=8, headroom=1.5))]
KIND_IDS = ["brute", "brute-int8", "brute-unfused", "ivf", "forest"]


@pytest.mark.parametrize("kind, kw", KINDS, ids=KIND_IDS)
def test_first_calls_count_as_the_references(ref, kind, kw):
    port, theirs, rng = _pair(ref, kind, **kw)
    for b in SIZES:
        q = _corpus(rng, b)
        port(q)
        theirs(q)
    for name in ("compile_signatures", "dispatches"):
        assert port.metrics.counter(name).value == \
            theirs.metrics.counter(name).value
    assert port.metrics.get("first_call_ms").count == \
        theirs.metrics.get("first_call_ms").count == 3
    assert port.jit_cache_size() == theirs.jit_cache_size() == 3


@pytest.mark.parametrize("kind, kw", KINDS, ids=KIND_IDS)
def test_roofline_analytic_fields_equal_the_references(ref, kind, kw):
    port, theirs, rng = _pair(ref, kind, **kw)
    q = _corpus(rng, 4)
    port(q)
    theirs(q)
    for b in (1, 4, 64):
        mine = port.roofline_report(b=b, peak_bw=3.35e12)
        want = theirs.roofline_report(b=b, peak_bw=3.35e12)
        assert {f: mine[f] for f in ANALYTIC} == \
            {f: want[f] for f in ANALYTIC}
        assert mine["measured_kernel_ms_p50"] > 0
        assert mine["bound_by"] in ("bytes", "operations")
        assert mine["bound_ms"] > 0


def test_compile_signature_instants_name_their_shape():
    rng = np.random.default_rng(0)
    be = ShardedSearchBackend(_corpus(rng, 64), kind="brute", k=5,
                              device="cpu")
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        for b in SIZES:
            be(_corpus(rng, b))
    finally:
        set_tracer(old)
    got = [(e["args"]["shape"], e["args"]["dtype"])
           for e in tracer.events("compile-signature")]
    assert got == [("[4, 8]", "float32"), ("[3, 8]", "float32"),
                   ("[8, 8]", "float32")]


def test_profile_entry_points_replay_as_the_references(ref, monkeypatch):
    mine = profile_entry_points(device="cpu")
    monkeypatch.setattr(ref.registry, "_mesh1", _mesh)
    theirs = ref.profile.profile_entry_points()
    assert sorted(mine) == sorted(theirs)
    for name in theirs:
        assert "error" not in mine[name], mine[name]
        assert [(s["label"], s["cache_size"], s["new_compiles"])
                for s in mine[name]["steps"]] == \
            [(s["label"], s["cache_size"], s["new_compiles"])
             for s in theirs[name]["steps"]]
        assert mine[name]["compiles"] == theirs[name]["compiles"]
        assert PROFILE.get(f"entry.{name}.step_ms").count >= \
            len(mine[name]["steps"])


def test_install_compile_hooks_is_idempotent_and_mirrors_a_load():
    from repro_torch.kernels import _build

    assert install_compile_hooks() is True
    n = len(_build._listeners)
    assert install_compile_hooks() is True
    assert len(_build._listeners) == n
    builds = PROFILE.counter("kernel_builds").value
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        # what build_all calls for each library it loads
        for fn in _build._listeners:
            fn("l2_topk", 12.5, True)
    finally:
        set_tracer(old)
    assert PROFILE.counter("kernel_builds").value == builds + 1
    assert PROFILE.get("kernel_build_ms").count >= 1
    (ev,) = tracer.events("kernel-build")
    assert ev["args"]["library"] == "l2_topk" and ev["args"]["ms"] == 12.5


def test_obs_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "trace.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.smoke", "--device", "cpu",
         "--out", str(out)], capture_output=True, text=True, timeout=300,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert run.returncode == 0, run.stdout + run.stderr
    assert "obs smoke OK: 64 requests" in run.stdout
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"route", "queue", "batch", "dispatch", "kernel",
            "compile-signature"} <= names
