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
    "repro.core.metrics", "repro.core.metadata", "repro.core.lexical",
    "repro.kernels.common", "repro.kernels.ref", "repro.kernels.ops",
    "repro.kernels.l2_topk", "repro.kernels.bucket_topk",
    "repro.kernels.bm25", "repro.distributed.sharding",
    "repro.distributed.backend", "repro.serve.cell",
    "repro.data.synthetic", "repro.core.pq", "repro.core.lsh",
    "repro.core.tree", "repro.core.likelihood", "repro.core.protocol",
    "repro.core.index", "repro.kernels.pq_adc", "repro.kernels.hamming",
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
    "import repro_torch.core.metadata, repro_torch.core.lexical, "
    "repro_torch.kernels.bm25, repro_torch.kernels.ops",
    "import repro_torch.core.index, repro_torch.core.protocol, "
    "repro_torch.core.tree, repro_torch.core.pq, repro_torch.core.lsh, "
    "repro_torch.core.likelihood, repro_torch.kernels.pq_adc, "
    "repro_torch.kernels.hamming, repro_torch.kernels.ops",
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
    from repro_torch.core.index import auto_build_index
    from repro_torch.core.lsh import lsh_build, lsh_search
    from repro_torch.core.pq import pq_search, pq_train
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
    small = auto_build_index(db, device="cpu")
    assert small.spec.kind == "tree" and small.device == torch.device("cpu")
    assert small.search(q, 3)[1][:, 0].tolist() == [0, 1, 2, 3]
    lsh = lsh_build(db, 32)
    assert lsh_search(lsh, db, q, 3, n_candidates=64,
                      device="cpu")[1][:, 0].tolist() == [0, 1, 2, 3]
    if not torch.cuda.is_available():
        for call in (lambda: ShardedSearchBackend(db, kind="brute"),
                     lambda: brute_search(q, db, 3),
                     lambda: build_two_level(db, TwoLevelConfig(n_clusters=8)),
                     lambda: ServingCell.sharded(db, kind="brute"),
                     lambda: auto_build_index(db),
                     lambda: lsh_search(lsh, db, q, 3),
                     lambda: pq_search(pq_train(db, 4, iters=1,
                                                device="cpu"), q, 3)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_ops_send_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import (bm25, bucket_topk, common, hamming,
                                     l2_topk, ops, pq_adc, ref)

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
    codes, scales = (torch.as_tensor(a)
                     for a in ops.quantize_rows_int8(x.numpy()))
    terms = torch.as_tensor(rng.integers(-1, 20, (40, 6)).astype(np.int32))
    tf = torch.as_tensor(rng.random((40, 6)).astype(np.float32))
    qt = torch.as_tensor(rng.integers(-1, 20, (3, 4)).astype(np.int32))
    qw = torch.as_tensor(rng.random((3, 4)).astype(np.float32))
    alpha = torch.full((1, 1), 0.3)
    lut = torch.as_tensor(rng.random((3, 8, 256)).astype(np.float32))
    pq_codes = torch.as_tensor(rng.integers(0, 256, (40, 8)).astype(np.uint8))
    qcodes = torch.as_tensor(rng.integers(-2**31, 2**31, (3, 2)).astype(
        np.int32))
    hcodes = torch.as_tensor(rng.integers(-2**31, 2**31, (40, 2)).astype(
        np.int32))
    counts = {n: c.count for n, c in common.LAUNCH_COUNTERS.items()}
    for op, plain, args in (
            (ops.l2_topk_int8_op, ref.l2_topk_int8_ref, (q, codes, scales)),
            (ops.bm25_topk_op, ref.bm25_topk_ref, (qt, qw, terms, tf)),
            (ops.hybrid_topk_op, ref.hybrid_topk_ref,
             (q, x, qt, qw, terms, tf, alpha)),
            (ops.pq_adc_topk_op, ref.pq_adc_topk_ref, (lut, pq_codes)),
            (ops.hamming_topk_op, ref.hamming_topk_ref, (qcodes, hcodes))):
        d, i = op(*args, 4)
        dr, ir = plain(*args, 4)
        assert torch.equal(i, ir) and torch.equal(d, dr)
    assert {n: c.count for n, c in common.LAUNCH_COUNTERS.items()} == counts
    assert {"l2_topk", "l2_topk_int8", "candidate_topk", "bm25_topk",
            "hybrid_topk", "pq_adc_topk", "hamming_topk"} <= set(
                common.LAUNCH_COUNTERS)
    # the kernel wrappers themselves never take a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        l2_topk.l2_topk(q, x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_topk.candidate_topk(q, vecs, ids, 4)
    with pytest.raises(ValueError, match="CUDA"):
        l2_topk.l2_topk_int8(q, codes, scales, 4)
    with pytest.raises(ValueError, match="CUDA"):
        bm25.bm25_topk(qt, qw, terms, tf, 4)
    with pytest.raises(ValueError, match="CUDA"):
        bm25.hybrid_topk(q, x, qt, qw, terms, tf, alpha, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc.pq_adc_topk(lut, pq_codes, 4)
    with pytest.raises(ValueError, match="CUDA"):
        hamming.hamming_topk(qcodes, hcodes, 4)


def test_two_level_refuses_unported_levels_and_mutation():
    """Every top and bottom level is ported; mutation is not, and refuses
    on the two-level index, the unified index and a tree, naming the
    ROADMAP item."""
    from repro_torch.convert import index_from_arrays
    from repro_torch.core.index import SearchIndex
    from repro_torch.core.protocol import IndexSpec
    from repro_torch.core.tree import build_rp_tree
    from repro_torch.core.two_level import TwoLevelConfig, build_two_level

    db = np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32)
    with pytest.raises(ValueError):
        build_two_level(db, TwoLevelConfig(n_clusters=4, top="nope"),
                        device="cpu")
    with pytest.raises(ValueError):
        build_two_level(db, TwoLevelConfig(n_clusters=4, bottom="nope"),
                        device="cpu")
    idx = index_from_arrays(
        {"db": db, "centroids": db[:4], "bucket_counts": np.full(4, 16),
         "bucket_ids": np.arange(64, dtype=np.int32).reshape(4, 16)},
        {"n_clusters": 4}, device="cpu")
    assert (idx.entity_bucket == np.repeat(np.arange(4), 16)).all()
    tree = build_rp_tree(db)
    one = SearchIndex(spec=IndexSpec("tree"), db=db, tree=tree, device="cpu")
    two = SearchIndex(spec=IndexSpec("two_level"), db=db, two_level=idx)
    for obj, names in (
            (idx, ("add_entities", "delete_entities", "refresh_forest",
                   "rebalance", "reboost", "pop_delta")),
            (one, ("add_entities", "delete_entities", "rebalance", "reboost",
                   "pop_delta", "rebuild_with_likelihood")),
            (two, ("add_entities", "delete_entities", "reboost")),
            (tree, ("reboost", "drop_entities"))):
        for name in names:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                getattr(obj, name)()
