"""K-means for two-level partitioning (paper §3.2 step 2).

Port of ``repro/core/kmeans.py``: Lloyd iterations with chunked
assignment (matmul-expanded L2) and ``index_add_`` centroid updates, plus
the mini-batch mode for large corpora.  The host-side
``np.random.default_rng(seed)`` streams (initial centroids, mini-batch
draws) are the reference's, call for call, so a build from the same seed
samples the same rows.  The (chunk x k) assignment product is a plain
``torch.matmul`` in full fp32, as the reference leaves it to XLA outside
any kernel.

On the card ``index_add_`` sums with atomics in no fixed order, so
centroids can differ from run to run in the last bits; builds are held to
the reference by invariants, not bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import require_fp32_matmul, resolve

__all__ = ["KMeansResult", "kmeans_fit", "kmeans_assign", "pad_to_multiple"]


@dataclasses.dataclass
class KMeansResult:
    centroids: np.ndarray       # (k, d) float32
    assignments: np.ndarray     # (n,) int32
    inertia: float
    n_iter: int


def pad_to_multiple(x: np.ndarray, m: int, axis: int = 0, value=0.0):
    """``x`` padded along ``axis`` with ``value`` to a multiple of ``m``
    rows, and the unpadded length."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value), n


def _assign_chunked(x: torch.Tensor, c: torch.Tensor, chunk: int):
    """argmin_j ||x_i - c_j||^2 over row chunks -> (ids int32, sq-dists)."""
    c_norm = torch.sum(c * c, dim=1)                      # (k,)
    ids, best = [], []
    for s in range(0, x.shape[0], chunk):
        xi = x[s:s + chunk]
        d2 = c_norm[None, :] - 2.0 * (xi @ c.T)           # (chunk, k) + const
        ids.append(torch.argmin(d2, dim=1).to(torch.int32))
        best.append(torch.amin(d2, dim=1) + torch.sum(xi * xi, dim=1))
    return torch.cat(ids), torch.cat(best)


def _assign_topm_chunked(x: torch.Tensor, c: torch.Tensor, m: int,
                         chunk: int):
    """The m nearest centroids of each row, ascending, ties toward the
    lower centroid id: ``stable_topk``'s order, found by m rounds of a
    first-occurrence min that retires the column it picks.  m is small
    (4 for the capped fill) against k (up to 32,768), so m row passes
    cost far less than sorting every row of the (chunk, k) tile."""
    c_norm = torch.sum(c * c, dim=1)
    ids, dist = [], []
    for s in range(0, x.shape[0], chunk):
        xi = x[s:s + chunk]
        d2 = c_norm[None, :] - 2.0 * (xi @ c.T)
        vals, sels = [], []
        for _ in range(m):
            v, sel = torch.min(d2, dim=1)
            vals.append(v)
            sels.append(sel)
            d2.scatter_(1, sel[:, None], float("inf"))
        ids.append(torch.stack(sels, dim=1).to(torch.int32))
        dist.append(torch.stack(vals, dim=1)
                    + torch.sum(xi * xi, dim=1, keepdim=True))
    return torch.cat(ids), torch.cat(dist)


def _assign_topm(x: np.ndarray, centroids: np.ndarray, m: int,
                 chunk: int = 4096, *, device=None):
    """Host helper: m nearest centroids per row (ids, sq-dists), numpy."""
    dev = resolve(device)
    require_fp32_matmul()
    xt = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                         device=dev)
    ct = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    ids, d2 = _assign_topm_chunked(xt, ct, m, min(chunk, max(1, x.shape[0])))
    return ids.cpu().numpy(), d2.cpu().numpy()


def kmeans_assign(x: np.ndarray, centroids: np.ndarray, chunk: int = 4096,
                  *, device=None):
    """Host helper: nearest-centroid ids for (possibly huge) x, numpy."""
    dev = resolve(device)
    require_fp32_matmul()
    xt = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                         device=dev)
    ct = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    a, d2 = _assign_chunked(xt, ct, chunk)
    return a.cpu().numpy(), d2.cpu().numpy()


def _lloyd_iter(x: torch.Tensor, c: torch.Tensor, k: int, chunk: int):
    a, d2 = _assign_chunked(x, c, chunk)
    sums = torch.zeros_like(c).index_add_(0, a, x)
    cnts = torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(
        0, a, torch.ones(a.shape[0], dtype=torch.float32, device=x.device))
    new_c = torch.where(cnts[:, None] > 0,
                        sums / torch.clamp(cnts, min=1.0)[:, None], c)
    return new_c, a, d2.sum(), cnts


def _init_centroids(rng: np.random.Generator, x: np.ndarray, k: int,
                    init: str) -> np.ndarray:
    n = x.shape[0]
    if init == "random" or k >= n:
        ids = rng.choice(n, size=min(k, n), replace=False)
        c = x[ids]
        if k > n:  # degenerate: duplicate
            c = np.concatenate([c, c[rng.integers(0, n, k - n)]], 0)
        return c.astype(np.float32)
    if init == "kmeans++":  # exact D^2 sampling; fine for k <= ~4096
        ids = [int(rng.integers(0, n))]
        d2 = ((x - x[ids[0]]) ** 2).sum(1)
        for _ in range(k - 1):
            probs = d2 / (d2.sum() + 1e-30)
            nxt = int(rng.choice(n, p=probs))
            ids.append(nxt)
            d2 = np.minimum(d2, ((x - x[nxt]) ** 2).sum(1))
        return x[np.asarray(ids)].astype(np.float32)
    raise ValueError(f"unknown init {init!r}")


def kmeans_fit(
    x: np.ndarray,
    k: int,
    *,
    iters: int = 15,
    chunk: int = 4096,
    seed: int = 0,
    init: str = "random",
    minibatch: int | None = None,
    tol: float = 1e-4,
    device=None,
) -> KMeansResult:
    """Lloyd (or mini-batch) k-means, on the card unless ``device`` says
    otherwise.  The corpus is moved to the device once; mini-batch rows
    are drawn on the host with the reference's rng and gathered there.

    ``minibatch``: if set, each iteration runs Lloyd on a fresh uniform
    sample of that size (Sculley-style), then a final full assignment —
    used for the 2^13..2^15-cluster builds on 1M+ corpora.
    """
    dev = resolve(device)
    require_fp32_matmul()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(_init_centroids(rng, x, k, init), device=dev)
    xt = torch.as_tensor(x, device=dev)
    chunk = min(chunk, max(1, n))

    prev = np.inf
    it = 0
    for it in range(1, iters + 1):
        if minibatch is not None and minibatch < n:
            rows = rng.choice(n, size=minibatch, replace=False)
            sample = xt[torch.as_tensor(rows, device=dev)]
        else:
            sample = xt
        # the reference drops the ragged tail: Lloyd runs on the largest
        # chunk-multiple prefix of the sample (the whole sample if smaller)
        m = (sample.shape[0] // chunk) * chunk
        if m == 0:
            sp, local_chunk = sample, sample.shape[0]
        else:
            sp, local_chunk = sample[:m], chunk
        new_c, _, inertia, _ = _lloyd_iter(sp, c, k, local_chunk)
        inertia = float(inertia)
        shift = float(torch.max(torch.abs(new_c - c)))
        c = new_c
        if shift < tol or abs(prev - inertia) < tol * max(prev, 1.0):
            break
        prev = inertia

    a, d2 = _assign_chunked(xt, c, chunk)
    return KMeansResult(centroids=c.cpu().numpy(),
                        assignments=a.cpu().numpy(),
                        inertia=float(d2.sum()), n_iter=it)
