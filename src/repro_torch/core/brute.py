"""Exact (brute-force) top-k search.

Port of ``repro/core/brute.py``.  The distance expansions keep the
reference's exact term order, which is what keeps the fused and unfused
paths of the port in step: ``pairwise_l2sq`` is ``(qn + xn) - 2 q.x``
and ``batched_l2sq`` is ``(vn - 2 v.q) + qn``.  The CUDA ``l2_topk``
kernel is the fused tile loop of the first; this module is the plain
version, the CPU path and the chunked ground-truth scan.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.common import stable_topk

__all__ = ["l2_topk_exact", "brute_search", "pairwise_l2sq", "batched_l2sq"]


def pairwise_l2sq(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 via the matmul expansion."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)           # (B, 1)
    xn = torch.sum(x * x, dim=-1)                         # (N,)
    return qn + xn[None, :] - 2.0 * (q @ x.T)


def batched_l2sq(vecs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, C, d) candidates x (B, d) queries -> (B, C) squared L2; the
    per-query candidate-tile counterpart of ``pairwise_l2sq``."""
    return (
        torch.sum(vecs * vecs, dim=-1)
        - 2.0 * torch.einsum("bcd,bd->bc", vecs, q)
        + torch.sum(q * q, dim=-1, keepdim=True)
    )


def l2_topk_exact(queries: torch.Tensor, db: torch.Tensor, k: int,
                  chunk: int = 65536):
    """Exact top-k by streaming db chunks with a running merge.

    Returns (dists (B, k) ascending, ids (B, k)); rows past the end of the
    corpus never rank.
    """
    queries = queries.to(torch.float32)
    db = db.to(torch.float32)
    B = queries.shape[0]
    n = db.shape[0]
    chunk = min(chunk, n)
    best_d = queries.new_full((B, k), float("inf"))
    best_i = torch.full((B, k), -1, dtype=torch.int32, device=queries.device)
    for start in range(0, n, chunk):
        xs = db[start:start + chunk]
        d2 = pairwise_l2sq(queries, xs)                   # (B, <=chunk)
        ids = torch.arange(start, start + xs.shape[0], dtype=torch.int32,
                           device=queries.device)
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, ids.expand(B, -1)], dim=1)
        best_d, sel = stable_topk(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i


def brute_search(queries: np.ndarray, db: np.ndarray, k: int,
                 chunk: int = 65536, *, device=None):
    """Host wrapper returning numpy (dists, ids); runs on the card unless
    ``device`` says otherwise."""
    dev = resolve(device)
    d, i = l2_topk_exact(
        torch.as_tensor(np.asarray(queries, np.float32), device=dev),
        torch.as_tensor(np.asarray(db, np.float32), device=dev), k,
        min(chunk, db.shape[0]))
    return d.cpu().numpy(), i.cpu().numpy()
