"""Radius-graph construction with the paper's two-level machinery: the
port of ``repro/core/graph_build.py``.

SchNet (and molecular GNNs generally) need a neighbor list within a cutoff
radius.  Building it is literally a nearest-neighbor search — the paper's
bucketed two-level scan applies directly (DESIGN.md §5): k-means the atom
positions into buckets, probe each atom's nearest buckets, keep pairs
within the cutoff.  Brute fallback for small systems.

The brute method and the per-atom candidate filter are the reference's
numpy; the two-level method's k-means and bucket probe (``kmeans_fit``,
``_assign_topm``) run on ``device`` (``None``: the card).  The brute
method touches no device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.kmeans import _assign_topm, kmeans_fit
from repro_torch.device import resolve

__all__ = ["radius_graph"]


def radius_graph(
    positions: np.ndarray,
    cutoff: float,
    *,
    max_neighbors: int | None = None,
    method: str = "auto",
    n_buckets: int | None = None,
    nprobe: int = 8,
    seed: int = 0,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (senders, receivers) int32 edge lists, i != j, |xi-xj|<=cutoff.

    method: "brute" | "two_level" | "auto" (two_level for n > 4096).
    """
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    n = pos.shape[0]
    if method == "auto":
        method = "two_level" if n > 4096 else "brute"
    if method == "brute":
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        src, dst = np.nonzero(d2 <= cutoff * cutoff)
        return _cap(src, dst, d2, max_neighbors, n)

    dev = resolve(device)
    k = n_buckets or max(8, n // 128)
    km = kmeans_fit(pos, k, iters=8, seed=seed, device=dev)
    # candidate buckets per atom
    top_b, _ = _assign_topm(pos, km.centroids, min(nprobe, k), device=dev)
    # bucket membership lists
    order = np.argsort(km.assignments, kind="stable")
    counts = np.bincount(km.assignments, minlength=k)
    offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    members = order.astype(np.int32)

    srcs, dsts = [], []
    c2 = cutoff * cutoff
    for i in range(n):
        cand = np.concatenate(
            [members[offsets[b] : offsets[b + 1]] for b in top_b[i]]
        )
        cand = cand[cand != i]
        d2 = ((pos[cand] - pos[i]) ** 2).sum(-1)
        keep = d2 <= c2
        cand, d2 = cand[keep], d2[keep]
        if max_neighbors is not None and cand.size > max_neighbors:
            sel = np.argsort(d2)[:max_neighbors]
            cand = cand[sel]
        srcs.append(np.full(cand.size, i, dtype=np.int32))
        dsts.append(cand)
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    return src, dst


def _cap(src, dst, d2, max_neighbors, n):
    if max_neighbors is None:
        return src.astype(np.int32), dst.astype(np.int32)
    out_s, out_d = [], []
    for i in range(n):
        m = src == i
        di = d2[i, dst[m]]
        keep = np.argsort(di)[:max_neighbors]
        out_s.append(np.full(keep.size, i, dtype=np.int32))
        out_d.append(dst[m][keep].astype(np.int32))
    return np.concatenate(out_s), np.concatenate(out_d)
