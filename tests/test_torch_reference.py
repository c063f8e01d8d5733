"""The reference loader for the port's tests, and the port's boundaries.

The JAX package ``repro`` is the reference, and it does not import on
Python 3.12 as it stands: ``repro/core/delta.py`` declares dataclass
fields with an ``np.ndarray`` default, which 3.12's ``dataclasses``
rejects.  The reference is not edited.  ``reference_modules`` loads it
for one test module at a time:

1. it takes every ``repro`` / ``repro.*`` entry out of ``sys.modules``
   and remembers it;
2. it wraps ``dataclasses.dataclass`` so that an ndarray default becomes
   a ``default_factory``, only while the reference imports;
3. it restores ``dataclasses.dataclass``;
4. on exit it puts ``sys.modules`` back exactly as it was.

So the JAX test files a worker runs afterwards import (or fail to import)
exactly as they would without this module, whatever order the files run
in.  Nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = (
    "repro.core.brute", "repro.core.kmeans", "repro.core.two_level",
    "repro.core.metrics", "repro.kernels.common", "repro.kernels.ref",
    "repro.kernels.l2_topk", "repro.kernels.bucket_topk",
    "repro.distributed.sharding", "repro.distributed.backend",
    "repro.data.synthetic",
)


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


def _ndarray_safe(orig):
    """``dataclasses.dataclass`` with ndarray defaults turned into
    ``default_factory`` (a fresh copy per instance)."""

    def patch(cls):
        for name in cls.__dict__.get("__annotations__", {}):
            v = cls.__dict__.get(name)
            if isinstance(v, np.ndarray):
                setattr(cls, name, dataclasses.field(default_factory=v.copy))
        return cls

    def dataclass(cls=None, /, **kw):
        if cls is None:
            return lambda c: orig(patch(c), **kw)
        return orig(patch(cls), **kw)

    return dataclass


@contextlib.contextmanager
def reference_modules():
    """Yields a namespace of the reference modules (short names, e.g.
    ``ns.ref``, ``ns.two_level``), loaded fresh; restores ``sys.modules``
    and ``dataclasses.dataclass`` afterwards."""
    saved = {n: m for n, m in sys.modules.items() if _is_reference(n)}
    for n in saved:
        del sys.modules[n]
    orig = dataclasses.dataclass
    dataclasses.dataclass = _ndarray_safe(orig)
    try:
        mods = {name.rsplit(".", 1)[1]: importlib.import_module(name)
                for name in _REFERENCE}
    finally:
        dataclasses.dataclass = orig
    try:
        yield types.SimpleNamespace(**mods)
    finally:
        for n in [n for n in sys.modules if _is_reference(n)]:
            del sys.modules[n]
        sys.modules.update(saved)


@pytest.fixture(scope="module")
def reference():
    with reference_modules() as ns:
        yield ns


def test_loader_restores_dataclass_and_modules():
    orig = dataclasses.dataclass
    before = {n: m for n, m in sys.modules.items() if _is_reference(n)}
    with reference_modules() as ns:
        assert dataclasses.dataclass is orig
        assert ns.two_level.TwoLevelIndex is not None
        # the shimmed class still behaves: each instance gets its own array
        from repro.core.delta import DeltaManifest
        a = DeltaManifest(base_version=0, version=0, base_n=0, n=0)
        b = DeltaManifest(base_version=0, version=0, base_n=0, n=0)
        assert a.dirty_buckets.size == 0
        assert a.dirty_buckets is not b.dirty_buckets
    assert dataclasses.dataclass is orig
    after = {n: m for n, m in sys.modules.items() if _is_reference(n)}
    assert after.keys() == before.keys()
    assert all(after[n] is before[n] for n in before)


def test_loader_leaves_a_failing_import_failing():
    """Outside the loader the reference keeps its own behaviour on this
    interpreter: the ndarray default is rejected as before."""
    with reference_modules():
        pass
    code = ("import dataclasses, numpy as np\n"
            "try:\n"
            "    @dataclasses.dataclass\n"
            "    class C:\n"
            "        a: np.ndarray = np.zeros(0)\n"
            "    print('accepted')\n"
            "except ValueError:\n"
            "    print('rejected')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    assert out == "rejected"


def _modules_after(code: str) -> set:
    """``sys.modules`` keys after running ``code`` in a fresh interpreter
    with the repo's ``src`` (and root) on the path."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + REPO)
    out = subprocess.run(
        [sys.executable, "-c",
         code + "\nimport sys; print('\\n'.join(sorted(sys.modules)))"],
        capture_output=True, text=True, timeout=120, check=True, env=env,
        cwd=REPO).stdout
    return set(out.split())


@pytest.mark.parametrize("code", [
    "import repro_torch.serve.cell, repro_torch.distributed.backend, "
    "repro_torch.convert, repro_torch.core.kmeans, repro_torch.kernels.ops",
    "import chip_smoke",
])
def test_port_imports_neither_jax_nor_reference(code):
    mods = _modules_after(code)
    assert "repro_torch.kernels.ops" in mods
    assert not any(m == "jax" or m.startswith("jax.") for m in mods)
    assert not any(_is_reference(m) for m in mods)


def test_default_device_is_the_card_or_raises():
    from repro_torch.device import default_device, resolve

    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()
        with pytest.raises(RuntimeError):
            resolve(None)
    assert resolve("cpu") == torch.device("cpu")


def test_entry_points_honour_cpu_and_refuse_without_a_card():
    from repro_torch.core.brute import brute_search
    from repro_torch.core.two_level import TwoLevelConfig, build_two_level
    from repro_torch.distributed.backend import ShardedSearchBackend
    from repro_torch.serve.cell import ServingCell

    rng = np.random.default_rng(0)
    db = rng.normal(size=(256, 8)).astype(np.float32)
    q = db[:4] + 0.01
    be = ShardedSearchBackend(db, kind="brute", k=3, device="cpu")
    assert all(t.device.type == "cpu" for t in be._args)
    _, i = be(q)
    assert (i[:, 0] == np.arange(4)).all()
    _, bi = brute_search(q, db, 3, device="cpu")
    assert (bi == i).all()
    idx = build_two_level(db, TwoLevelConfig(n_clusters=8, kmeans_iters=2),
                          device="cpu")
    assert idx.device == torch.device("cpu")
    cell = ServingCell.sharded(idx, k=3, nprobe_local=8, device="cpu")
    try:
        assert cell.search(q[0], timeout=30)[1][0] == 0
    finally:
        cell.close()
    if not torch.cuda.is_available():
        for call in (lambda: ShardedSearchBackend(db, kind="brute"),
                     lambda: brute_search(q, db, 3),
                     lambda: build_two_level(db, TwoLevelConfig(n_clusters=8)),
                     lambda: ServingCell.sharded(db, kind="brute")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_ops_send_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import bucket_topk, l2_topk, ops, ref

    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(3, 8)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(40, 8)).astype(np.float32))
    n0 = l2_topk.LAUNCHES.count
    d, i = ops.l2_topk_op(q, x, 4)
    dr, ir = ref.l2_topk_ref(q, x, 4)
    assert torch.equal(i, ir) and torch.equal(d, dr)
    assert l2_topk.LAUNCHES.count == n0
    vecs = x[:30].reshape(3, 10, 8)
    ids = torch.arange(30, dtype=torch.int32).reshape(3, 10)
    n1 = bucket_topk.LAUNCHES.count
    d, i = ops.candidate_topk_op(q, vecs, ids, 4)
    dr, ir = ref.candidate_topk_ref(q, vecs, ids, 4)
    assert torch.equal(i, ir) and torch.equal(d, dr)
    assert bucket_topk.LAUNCHES.count == n1
    # the kernel wrappers themselves never take a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        l2_topk.l2_topk(q, x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_topk.candidate_topk(q, vecs, ids, 4)


def test_two_level_refuses_unported_levels_and_mutation():
    from repro_torch.convert import index_from_arrays
    from repro_torch.core.two_level import TwoLevelConfig, build_two_level

    db = np.zeros((64, 4), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_two_level(db, TwoLevelConfig(n_clusters=4, top="pq"),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_two_level(db, TwoLevelConfig(n_clusters=4, bottom="qlbt"),
                        device="cpu")
    with pytest.raises(ValueError):
        build_two_level(db, TwoLevelConfig(n_clusters=4, top="nope"),
                        device="cpu")
    idx = index_from_arrays(
        {"db": db, "centroids": db[:4], "bucket_counts": np.full(4, 16),
         "bucket_ids": np.arange(64, dtype=np.int32).reshape(4, 16)},
        {"n_clusters": 4}, device="cpu")
    assert (idx.entity_bucket == np.repeat(np.arange(4), 16)).all()
    for name in ("add_entities", "delete_entities", "rebalance", "reboost",
                 "pop_delta"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(idx, name)()
