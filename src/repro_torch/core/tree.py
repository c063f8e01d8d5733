"""Flattened projection trees: balanced SPPT, QLBT (paper Alg. 1), kd-tree.

Port of ``repro/core/tree.py``.  The builders are numpy on the host, as in
the reference (index construction is offline in the paper too): they are
copies, so a build from the same inputs and seed gives the reference's
arrays exactly.  Search is the batched, level-synchronous beam descent in
plain PyTorch on the card: queries walk the structure-of-arrays node table
in lockstep with gathers, the beam plays multi-probe backtracking
(priority = accumulated split margin), and the gathered leaves are
reranked exactly.

The reference runs the descent as a ``lax.while_loop`` that exits when
every beam has bottomed out.  Here that exit test would be a host sync
each step, so the descent runs its ``max_steps`` steps: once every beam
has bottomed out a further step is the identity (no node is internal, the
priorities are already sorted and the sort is stable, and ``steps`` /
``internal_visits`` do not move), so the result is the same.

The incremental re-boost (``FlatTree.reboost``) and tombstone deletes
(``FlatTree.drop_entities``) belong to mutation, a later slice: they raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.kernels.common import pad_sentinel, stable_topk

__all__ = [
    "FlatTree",
    "build_rp_tree",
    "build_qlbt",
    "build_kd_tree",
    "tree_search",
    "TreeSearchResult",
]

LATER_MUTATION = ("ROADMAP.md, 'Modules still to port': mutation and "
                  "delta republish")
_TREE_FIELDS = ("proj", "dims", "tau", "children", "leaf_row",
                "leaf_entities")


@dataclasses.dataclass
class FlatTree:
    """Structure-of-arrays tree. Node 0 is the root.

    kind        : "rp" (dense random projections) or "kd" (coordinate splits)
    proj        : (n_nodes, d) float32 for "rp"; unused for "kd"
    dims        : (n_nodes,) int32 split coordinate for "kd"; unused for "rp"
    tau         : (n_nodes,) float32 split threshold
    children    : (n_nodes, 2) int32, -1 for leaves
    leaf_row    : (n_nodes,) int32 row into ``leaf_entities`` (-1 = internal)
    leaf_entities : (n_leaves, leaf_size) int32 entity ids, -1 padded
    depth       : (n_nodes,) int32 node depth (root = 0)
    entity_depth: (n_entities,) int32 leaf depth of each entity
    """

    kind: str
    proj: np.ndarray
    dims: np.ndarray
    tau: np.ndarray
    children: np.ndarray
    leaf_row: np.ndarray
    leaf_entities: np.ndarray
    depth: np.ndarray
    entity_depth: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.tau.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_entities.shape[0])

    @property
    def leaf_size(self) -> int:
        return int(self.leaf_entities.shape[1])

    @property
    def max_depth(self) -> int:
        return int(self.depth.max()) if self.n_nodes else 0

    def expected_depth(self, p: np.ndarray) -> float:
        """E[Depth(X)] under query likelihood p — the paper's objective."""
        p = np.asarray(p, dtype=np.float64)
        return float((p / p.sum() * self.entity_depth).sum())

    def footprint_bytes(self) -> int:
        tot = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                tot += v.nbytes
        return tot

    def device_arrays(self, device) -> dict:
        """The tensors ``tree_search`` reads, on ``device``."""
        return {name: torch.as_tensor(getattr(self, name), device=device)
                for name in _TREE_FIELDS}

    def reboost(self, *args, **kwargs):
        raise NotImplementedError(f"FlatTree.reboost: see {LATER_MUTATION}")

    def drop_entities(self, *args, **kwargs):
        raise NotImplementedError(
            f"FlatTree.drop_entities: see {LATER_MUTATION}")


# ---------------------------------------------------------------------------
# Builders (host-side numpy; vectorized per node)
# ---------------------------------------------------------------------------


def _likelihood_tau(alpha: np.ndarray, p: np.ndarray) -> tuple[float, int]:
    """tau* = argmin_tau |sum_{alpha<=tau} p - sum_{alpha>tau} p| (Alg.1 l.7).

    Returns (tau, n_left). Ties broken toward the more count-balanced split
    so degenerate all-on-one-side splits never occur.
    """
    order = np.argsort(alpha, kind="stable")
    a_sorted = alpha[order]
    prefix = np.cumsum(p[order])
    total = prefix[-1]
    # candidate split after position i (left = [0..i]); forbid empty sides
    m = alpha.size
    gap = np.abs(2.0 * prefix[:-1] - total)
    best = int(np.argmin(gap))
    tau = float(0.5 * (a_sorted[best] + a_sorted[best + 1]))
    # guard: equal projections collapse a side; nudge split point
    n_left = int(np.searchsorted(a_sorted, tau, side="right"))
    if n_left == 0 or n_left == m:
        n_left = m // 2
        tau = float(0.5 * (a_sorted[n_left - 1] + a_sorted[n_left]))
    return tau, n_left



def _median_tau(alpha: np.ndarray) -> float:
    a_sorted = np.sort(alpha)
    m = alpha.size
    return float(0.5 * (a_sorted[(m - 1) // 2] + a_sorted[m // 2]))


def _greedy_depth_tau(
    alpha: np.ndarray, p: np.ndarray, leaf_size: int
) -> tuple[float, int, float]:
    """Beyond-paper split: directly minimize the greedy expected-depth bound

        cost(i) = P_L log2(max(N_L/leaf,1)) + P_R log2(max(N_R/leaf,1))

    over all split positions (the paper's §3.1 objective applied one level
    at a time, instead of the mass-balance proxy).  Returns
    (tau, n_left, -cost) — higher score is better.
    """
    order = np.argsort(alpha, kind="stable")
    a_sorted = alpha[order]
    prefix = np.cumsum(p[order])
    total = prefix[-1]
    m = alpha.size
    n_l = np.arange(1, m, dtype=np.float64)
    n_r = m - n_l
    p_l = prefix[:-1]
    p_r = total - p_l
    cost = p_l * np.log2(np.maximum(n_l / leaf_size, 1.0)) + \
        p_r * np.log2(np.maximum(n_r / leaf_size, 1.0))
    best = int(np.argmin(cost))
    tau = float(0.5 * (a_sorted[best] + a_sorted[best + 1]))
    n_left = int(np.searchsorted(a_sorted, tau, side="right"))
    if n_left == 0 or n_left == m:
        n_left = m // 2
        tau = float(0.5 * (a_sorted[n_left - 1] + a_sorted[n_left]))
    return tau, n_left, float(-cost[best])


def _build_projection_tree(
    emb: np.ndarray,
    p: Optional[np.ndarray],
    *,
    leaf_size: int,
    n_candidates: int,
    boost_depth: int,
    lam: float,
    seed: int,
    boosted: bool,
    objective: str = "massbalance",
) -> FlatTree:
    """Shared recursive builder for balanced SPPT and QLBT (Alg. 1)."""
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    n, d = emb.shape
    if p is None:
        p = np.full(n, 1.0 / n, dtype=np.float64)
    else:
        p = np.asarray(p, dtype=np.float64)
        p = p / p.sum()
    rng = np.random.default_rng(seed)

    proj_rows, tau_vals, children, depths, leaf_rows = [], [], [], [], []
    leaf_tables: list[np.ndarray] = []
    entity_depth = np.zeros(n, dtype=np.int32)

    # stack of (entity_ids, depth, parent_slot, which_child)
    stack = [(np.arange(n, dtype=np.int64), 0, -1, 0)]
    while stack:
        ids, depth, parent, side = stack.pop()
        slot = len(tau_vals)
        if parent >= 0:
            children[parent][side] = slot
        m = ids.size
        if m <= leaf_size:
            proj_rows.append(np.zeros(d, dtype=np.float32))
            tau_vals.append(0.0)
            children.append([-1, -1])
            depths.append(depth)
            leaf_rows.append(len(leaf_tables))
            row = np.full(leaf_size, -1, dtype=np.int32)
            row[:m] = ids
            leaf_tables.append(row)
            entity_depth[ids] = depth
            continue

        sub = emb[ids]                      # (m, d)
        sub_p = p[ids]
        # Alg.1 l.4: K random unit projections
        v = rng.normal(size=(n_candidates, d)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        alphas = sub @ v.T                  # (m, K)

        sigma2 = alphas.var(axis=0)         # Alg.1 l.10
        use_boost = boosted and depth <= boost_depth
        taus = np.empty(n_candidates, dtype=np.float64)
        n_lefts = np.empty(n_candidates, dtype=np.int64)
        if use_boost and objective == "greedy":
            # beyond-paper: direct greedy E[depth] minimization per split
            neg_cost = np.empty(n_candidates)
            for i in range(n_candidates):
                taus[i], n_lefts[i], neg_cost[i] = _greedy_depth_tau(
                    alphas[:, i], sub_p, leaf_size
                )
            sig_hat = sigma2 / (sigma2.max() + 1e-12)
            c_hat = neg_cost - neg_cost.min()
            c_hat = c_hat / (c_hat.max() + 1e-12)
            score = lam * sig_hat + (1.0 - lam) * c_hat
        elif use_boost:
            for i in range(n_candidates):
                taus[i], n_lefts[i] = _likelihood_tau(alphas[:, i], sub_p)
            n_rights = m - n_lefts
            b = np.maximum(n_lefts / n_rights, n_rights / n_lefts)  # Alg.1 l.9
            # scale-free normalization (DESIGN.md §1): sigma^2 -> [0,1],
            # b in [1, inf) -> 1 - 1/b in [0, 1)
            sig_hat = sigma2 / (sigma2.max() + 1e-12)
            b_hat = 1.0 - 1.0 / b
            score = lam * sig_hat + (1.0 - lam) * b_hat       # Alg.1 l.12
        else:
            for i in range(n_candidates):
                taus[i] = _median_tau(alphas[:, i])
                n_lefts[i] = int((alphas[:, i] <= taus[i]).sum())
            score = sigma2                                     # Alg.1 l.14

        best = int(np.argmax(score))                           # Alg.1 l.17
        alpha, tau = alphas[:, best], taus[best]
        left_mask = alpha <= tau
        if left_mask.all() or not left_mask.any():   # duplicate-point guard
            half = m // 2
            order = np.argsort(alpha, kind="stable")
            left_mask = np.zeros(m, dtype=bool)
            left_mask[order[:half]] = True

        proj_rows.append(v[best])
        tau_vals.append(float(tau))
        children.append([-1, -1])
        depths.append(depth)
        leaf_rows.append(-1)
        stack.append((ids[left_mask], depth + 1, slot, 0))
        stack.append((ids[~left_mask], depth + 1, slot, 1))

    n_nodes = len(tau_vals)
    return FlatTree(
        kind="rp",
        proj=np.stack(proj_rows),
        dims=np.zeros(n_nodes, dtype=np.int32),
        tau=np.asarray(tau_vals, dtype=np.float32),
        children=np.asarray(children, dtype=np.int32),
        leaf_row=np.asarray(leaf_rows, dtype=np.int32),
        leaf_entities=(
            np.stack(leaf_tables)
            if leaf_tables
            else np.zeros((0, leaf_size), np.int32)
        ),
        depth=np.asarray(depths, dtype=np.int32),
        entity_depth=entity_depth,
    )


def build_rp_tree(
    emb: np.ndarray,
    *,
    leaf_size: int = 8,
    n_candidates: int = 8,
    seed: int = 0,
) -> FlatTree:
    """Balanced randomized SPPT — the paper's baseline tree (SmallER)."""
    return _build_projection_tree(
        emb, None, leaf_size=leaf_size, n_candidates=n_candidates,
        boost_depth=-1, lam=1.0, seed=seed, boosted=False,
    )


def build_qlbt(
    emb: np.ndarray,
    p: np.ndarray,
    *,
    leaf_size: int = 8,
    n_candidates: int = 8,
    boost_depth: int = 3,
    lam: float = 0.5,
    seed: int = 0,
    objective: str = "massbalance",
) -> FlatTree:
    """Query Likelihood Boosted Tree — paper Algorithm 1.

    ``boost_depth`` is the paper's early-stop level l (=3): below it the
    builder reverts to balanced (count-median, variance-scored) splits.
    ``lam`` trades projection variance against count-unbalance (grid-searched
    in the paper).  ``objective``: "massbalance" = paper Alg. 1 (tau from
    equal-probability split, score from unbalance ratio); "greedy" =
    beyond-paper direct greedy minimization of E[depth] (DESIGN.md §2,
    recorded separately in EXPERIMENTS.md).
    """
    return _build_projection_tree(
        emb, p, leaf_size=leaf_size, n_candidates=n_candidates,
        boost_depth=boost_depth, lam=lam, seed=seed, boosted=True,
        objective=objective,
    )


def build_kd_tree(
    points: np.ndarray, *, leaf_size: int = 8
) -> FlatTree:
    """Array kd-tree for low-dim top-level features (paper §3.2, geo)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    n, d = points.shape
    dims_l, tau_vals, children, depths, leaf_rows = [], [], [], [], []
    leaf_tables: list[np.ndarray] = []
    entity_depth = np.zeros(n, dtype=np.int32)
    stack = [(np.arange(n, dtype=np.int64), 0, -1, 0)]
    while stack:
        ids, depth, parent, side = stack.pop()
        slot = len(tau_vals)
        if parent >= 0:
            children[parent][side] = slot
        m = ids.size
        if m <= leaf_size:
            dims_l.append(0)
            tau_vals.append(0.0)
            children.append([-1, -1])
            depths.append(depth)
            leaf_rows.append(len(leaf_tables))
            row = np.full(leaf_size, -1, dtype=np.int32)
            row[:m] = ids
            leaf_tables.append(row)
            entity_depth[ids] = depth
            continue
        sub = points[ids]
        dim = int(np.argmax(sub.max(0) - sub.min(0)))   # widest spread
        alpha = sub[:, dim]
        tau = _median_tau(alpha)
        left_mask = alpha <= tau
        if left_mask.all() or not left_mask.any():
            order = np.argsort(alpha, kind="stable")
            left_mask = np.zeros(m, dtype=bool)
            left_mask[order[: m // 2]] = True
        dims_l.append(dim)
        tau_vals.append(tau)
        children.append([-1, -1])
        depths.append(depth)
        leaf_rows.append(-1)
        stack.append((ids[left_mask], depth + 1, slot, 0))
        stack.append((ids[~left_mask], depth + 1, slot, 1))
    n_nodes = len(tau_vals)
    return FlatTree(
        kind="kd",
        proj=np.zeros((n_nodes, 1), dtype=np.float32),
        dims=np.asarray(dims_l, dtype=np.int32),
        tau=np.asarray(tau_vals, dtype=np.float32),
        children=np.asarray(children, dtype=np.int32),
        leaf_row=np.asarray(leaf_rows, dtype=np.int32),
        leaf_entities=(
            np.stack(leaf_tables)
            if leaf_tables
            else np.zeros((0, leaf_size), np.int32)
        ),
        depth=np.asarray(depths, dtype=np.int32),
        entity_depth=entity_depth,
    )


# ---------------------------------------------------------------------------
# Batched beam search (PyTorch, on the card unless the tensors are on the CPU)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeSearchResult:
    ids: torch.Tensor              # (B, k) int32 entity ids (-1 pad)
    dists: torch.Tensor            # (B, k) float32 squared L2
    steps: torch.Tensor            # (B,) int32 descent iterations per query
    internal_visits: torch.Tensor  # (B,) int32 internal-node dot products
    candidates: torch.Tensor       # (B,) int32 exact distance evals (leaf scan)


def _split_margin(kind: str, arrays: dict, nodes: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """alpha = proj[node]·q - tau[node]   (or coordinate split for kd)."""
    if kind == "kd":
        dim = arrays["dims"][nodes].long()                # (B, W)
        coord = torch.gather(q, 1, dim)                   # (B, W)
        return coord - arrays["tau"][nodes]
    pv = arrays["proj"][nodes]                            # (B, W, d)
    return torch.einsum("bwd,bd->bw", pv, q) - arrays["tau"][nodes]


def tree_search(
    arrays: dict,
    db: torch.Tensor,
    queries: torch.Tensor,
    *,
    kind: str = "rp",
    beam_width: int = 8,
    k: int = 10,
    max_steps: int = 64,
    rerank: bool = True,
    roots: Optional[torch.Tensor] = None,
) -> TreeSearchResult:
    """Batched multi-probe descent + exact rerank of gathered leaves.

    ``arrays`` are a tree's (or a forest's) tensors
    (:meth:`FlatTree.device_arrays`), on the device of ``db`` and
    ``queries``.  Beam priority = accumulated negative split margin along
    the path (the near child inherits the parent's priority; the far child
    pays |alpha|).  ``roots`` optionally gives a per-query start node
    (forest descent in the two-level index); default is node 0.  Top-k
    selections are stable sorts, so ties go to the lower column as
    ``lax.top_k``'s do.
    """
    queries = queries.to(torch.float32)
    dev = queries.device
    B = queries.shape[0]
    W = beam_width
    children = arrays["children"]
    leaf_row = arrays["leaf_row"]
    leaf_entities = arrays["leaf_entities"]
    leaf_size = leaf_entities.shape[1]
    neg_inf = float("-inf")

    nodes = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    nodes[:, 0] = 0 if roots is None else roots.to(torch.int32)
    prios = torch.full((B, W), neg_inf, dtype=torch.float32, device=dev)
    prios[:, 0] = 0.0
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    visits = torch.zeros(B, dtype=torch.int32, device=dev)

    for _ in range(max_steps):
        safe = torch.clamp(nodes, min=0).long()
        valid = nodes >= 0
        left = children[safe, 0]
        right = children[safe, 1]
        active = valid & (left >= 0)                      # internal, live
        alpha = _split_margin(kind, arrays, safe, queries)
        near = torch.where(alpha <= 0, left, right)
        far = torch.where(alpha <= 0, right, left)
        # slot A: internal -> near child (same prio); leaf -> itself
        a_nodes = torch.where(active, near, nodes)
        a_prios = torch.where(valid, prios, neg_inf)
        # slot B: internal -> far child (prio - |alpha|); leaf/pad -> dead
        b_nodes = torch.where(active, far, -1)
        b_prios = torch.where(active, prios - torch.abs(alpha), neg_inf)
        cand_nodes = torch.cat([a_nodes, b_nodes], dim=1)
        cand_prios = torch.cat([a_prios, b_prios], dim=1)
        neg_top, top_i = stable_topk(-cand_prios, W)      # largest first
        new_nodes = torch.gather(cand_nodes, 1, top_i)
        nodes = torch.where(neg_top == float("inf"), -1, new_nodes)
        prios = -neg_top
        steps = steps + active.any(dim=1).to(torch.int32)
        visits = visits + active.sum(dim=1).to(torch.int32)

    # gather leaf entity ids
    safe = torch.clamp(nodes, min=0).long()
    rows = torch.where(nodes >= 0, leaf_row[safe], -1)    # (B, W)
    ents = torch.where(rows[..., None] >= 0,
                       leaf_entities[torch.clamp(rows, min=0).long()],
                       -1)                                # (B, W, leaf)
    cand = ents.reshape(B, W * leaf_size)
    n_cand = (cand >= 0).sum(dim=1).to(torch.int32)

    if not rerank:
        return TreeSearchResult(cand, torch.zeros(cand.shape, device=dev),
                                steps, visits, n_cand)

    vecs = db[torch.clamp(cand, min=0).long()]            # (B, C, d)
    diff2 = torch.where(cand >= 0, batched_l2sq(vecs, queries), float("inf"))
    # leaves partition entities, so ids are unique by construction
    k_eff = min(k, cand.shape[1])
    d, idx = stable_topk(diff2, k_eff)
    ids = torch.gather(cand, 1, idx)
    ids = torch.where(torch.isinf(d), -1, ids)
    d, ids = pad_sentinel(d, ids, k, k_eff)
    return TreeSearchResult(ids, d, steps, visits, n_cand)
