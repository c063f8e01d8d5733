"""Card tests of the port's CUDA kernels: each kernel against its plain
version, and one small IVF serve through the kernels.

Marked ``gpu``; each test decides inside itself whether a card is there
and skips with the reason when not.  Run on the card with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: the kernels sum in another order than PyTorch's ops, so
distances agree to |d_k - d_p| <= 1e-5 * (qn + xn); ids agree exactly on
these inputs (continuous random data, no near-ties at these sizes).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.data.synthetic import make_corpus, make_queries
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.kernels import bucket_topk, l2_topk, ref
from repro_torch.kernels.common import merge_topk
from repro_torch.serve.cell import ServingCell

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close(kd, ki, pd, pi, scale):
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    assert np.array_equal(np.isinf(kd), np.isinf(pd))
    assert (ki == pi).all()
    fin = np.isfinite(pd)
    assert (np.abs(kd[fin] - pd[fin])
            <= REL * np.broadcast_to(scale, pd.shape)[fin]).all()


@pytest.mark.parametrize("b,n,d,k,valid", [
    (1, 100, 8, 5, None),
    (4, 77, 8, 5, None),          # N not a multiple of the row tile
    (3, 6, 8, 10, None),          # k > N: sentinel pad
    (4, 50, 8, 5, "dead"),
    (6, 120, 8, 7, "half"),
    (70, 5000, 128, 32, "half"),  # two query tiles, several splits
])
def test_l2_topk_kernel_matches_plain(dev, b, n, d, k, valid):
    rng = np.random.default_rng(b * 1000 + n)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    v = None
    if valid == "dead":
        v = torch.zeros(n, dtype=torch.int32, device=dev)
    elif valid == "half":
        v = torch.as_tensor((rng.random(n) > .5).astype(np.int32), device=dev)
    before = l2_topk.LAUNCHES.count
    kd, ki = l2_topk.l2_topk(q, x, k, valid=v)
    pd, pi = ref.l2_topk_ref(q, x, k, valid=v)
    torch.cuda.synchronize()
    assert l2_topk.LAUNCHES.count == before + 1
    scale = ((q * q).sum(1)[:, None] + (x * x).sum(1).max()).cpu().numpy()
    _close(kd, ki, pd, pi, scale)


@pytest.mark.parametrize("case", ["dead", "k>C", "carried", "all_dead"])
def test_candidate_topk_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(8)
    B, C, D, k = 5, 37, 8, 6
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    q = t(rng.normal(size=(B, D)).astype(np.float32))
    vecs = t(rng.normal(size=(B, C, D)).astype(np.float32))
    ids = rng.integers(0, 500, size=(B, C)).astype(np.int32)
    ids[:, ::5] = -1
    ids = t(ids)
    kw = {}
    if case == "k>C":
        vecs, ids, k = vecs[:, :20].contiguous(), ids[:, :20].contiguous(), 24
    elif case == "carried":
        kw = dict(best_d=t(np.sort(rng.random((B, k)).astype(np.float32)
                                   * .5, axis=1)),
                  best_i=t(rng.integers(1000, 2000, size=(B, k))
                           .astype(np.int32)))
    elif case == "all_dead":
        ids = torch.full_like(ids, -1)
    kd, ki = bucket_topk.candidate_topk(q, vecs, ids, k, **kw)
    pd, pi = ref.candidate_topk_ref(q, vecs, ids, k, **kw)
    torch.cuda.synchronize()
    scale = ((q * q).sum(1) + (vecs * vecs).sum(-1).amax(1))[:, None]
    _close(kd, ki, pd, pi, scale.cpu().numpy())


def test_candidate_topk_duplicate_emitted_once(dev):
    rng = np.random.default_rng(9)
    B, C, D, k = 4, 30, 16, 8
    q = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32), device=dev)
    vecs = torch.as_tensor(rng.normal(size=(B, C, D)).astype(np.float32),
                           device=dev)
    vecs[:, 1::2] = vecs[:, 0:-1:2]
    ids = torch.arange(C, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    ids[:, 1::2] = ids[:, 0:-1:2]
    kd, ki = bucket_topk.candidate_topk(q, vecs, ids, k)
    sent_d = torch.full((B, k), float("inf"), device=dev)
    sent_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    pd, pi = merge_topk(sent_d, sent_i, batched_l2sq(vecs, q), ids, k)
    torch.cuda.synchronize()
    for row in ki.cpu().numpy():
        assert len(set(row.tolist())) == k
    scale = ((q * q).sum(1) + (vecs * vecs).sum(-1).amax(1))[:, None]
    _close(kd, ki, pd, pi, scale.cpu().numpy())


def test_kernels_reject_cpu_tensors_and_large_k(dev):
    q = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):
        l2_topk.l2_topk(q.cpu(), torch.zeros((10, 8)), 3)
    with pytest.raises(ValueError):
        l2_topk.l2_topk(q, torch.zeros((100, 8), device=dev), 33)


def test_small_ivf_serve_runs_through_the_kernels(dev):
    db = make_corpus("sift", scale=0.016, seed=0)
    queries = make_queries(db, 64, seed=1)
    idx = build_two_level(db, TwoLevelConfig(n_clusters=64, seed=0),
                          device=dev)
    backend = ShardedSearchBackend(idx, kind="ivf", nprobe_local=8, k=10)
    before = bucket_topk.LAUNCHES.count
    cell = ServingCell(backend, max_batch=16)
    try:
        served = [cell.search(q, timeout=60) for q in queries[:16]]
    finally:
        cell.close()
    assert bucket_topk.LAUNCHES.count > before
    plain = ShardedSearchBackend(idx, kind="ivf", nprobe_local=8, k=10,
                                 device="cpu")(queries[:16])
    ids = np.stack([s[1] for s in served])
    # sift-range rows round d2 by about one unit in either expansion, so
    # a neighbour pair closer than that may swap (two of 160 slots)
    assert (ids == plain[1]).mean() >= 0.95
    assert cell.stats().n == 16
