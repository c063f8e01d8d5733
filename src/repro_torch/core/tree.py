"""Flattened projection trees: balanced SPPT, QLBT (paper Alg. 1), kd-tree.

Port of ``repro/core/tree.py``.  The builders are numpy on the host, as in
the reference (index construction is offline in the paper too): they are
copies, so a build from the same inputs and seed gives the reference's
arrays exactly.  Search is the batched beam descent over the
structure-of-arrays node table, the beam playing multi-probe backtracking
(priority = accumulated split margin), then an exact rerank of the
gathered leaves.

The reference runs the descent as one compiled ``lax.while_loop`` that
exits when every beam has bottomed out or ``steps.max()`` reaches
``max_steps``.  Here it is ``kernels.ops.tree_descent_op``: on the card
one launch of ``csrc/tree_descent.cu``, the leaf gather included, each
row stopping on its own when none of its live slots is internal or its
steps reach ``max_steps``; on the CPU the plain loop with the
reference's exit.  The two exits agree row for row: once a row's beam
holds only leaves and dead slots a further step is the identity (no node
is internal, the priorities are already sorted and the sort is stable,
and ``steps`` / ``internal_visits`` do not move), so a row's active steps
form a prefix of the loop and the row ends where the batch loop leaves
it.

The incremental re-boost (``FlatTree.reboost``: the top levels re-split
over frontier subtrees for a new likelihood, straddlers floated) and
tombstone deletes (``FlatTree.drop_entities``) are host numpy too:
copies of the reference's arithmetic and rng use, so a re-boosted tree
is the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.kernels.common import pad_sentinel, stable_topk
from repro_torch.kernels import ops as kernel_ops

__all__ = [
    "FlatTree",
    "build_rp_tree",
    "build_qlbt",
    "build_kd_tree",
    "tree_search",
    "TreeSearchResult",
]

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

    def reboost(
        self,
        emb: np.ndarray,
        p: np.ndarray,
        *,
        boost_depth: int = 3,
        frontier_depth: Optional[int] = None,
        n_candidates: int = 8,
        lam: float = 0.5,
        max_move: float = 0.3,
        seed: int = 0,
    ) -> "FlatTree":
        """Incremental QLBT re-boost: rebuild only the top levels for a new
        likelihood ``p``, reusing whole subtrees below.

        The subtrees rooted at ``frontier_depth`` (default
        ``boost_depth + 3``) become atomic *items*: each keeps its internal
        structure and is summarized by its live-entity mean embedding and
        its total likelihood mass.  The levels above the frontier are
        rebuilt over those items, scored by the greedy expected-depth
        objective (§3.1 one level at a time), so subtrees that got hot
        under the drifted traffic move shallower and cold ones sink —
        without re-running the entity-level build the frontier subtrees
        already paid for.  Candidates per rebuilt node are (a) fresh
        random projections with taus refined against the items' entity
        clouds (``_refine_tau``), (b) the original splits above the
        frontier that are empirically clean for the node's item set, and
        (c) the items' deepest common original ancestor as a guaranteed
        fallback.  A fresh hyperplane may straddle an item; the straddling
        entities are not misrouted but *floated*: removed from their home
        subtree's leaf and re-inserted, by their own split margins, into a
        leaf on the side they actually route to.  ``max_move`` caps the
        likelihood mass a single split may float.

        ``emb``/``p`` are indexed by the ids stored in ``leaf_entities``
        (global ids for forest bucket trees); tombstoned ids should carry
        zero mass.  Cost is O(n * n_candidates * d * log M) for M frontier
        items — only the ~log2(M) rebuilt top levels touch entities, vs
        every level of a full ``build_qlbt``, hence measurably cheaper.
        Returns a new tree; ``self`` is left untouched (callers swap the
        reference atomically so concurrent searches never see a
        half-built table).
        """
        if self.kind != "rp":
            raise ValueError("reboost supports projection trees only")
        if self.n_nodes <= 1:
            return dataclasses.replace(self)
        if frontier_depth is None:
            # aim for items of ~8 leaves: fine enough granularity that mass
            # balance can isolate hot regions, coarse enough that the bulk
            # of the structure is reused
            n_live = int((self.leaf_entities >= 0).sum())
            frontier_depth = max(
                boost_depth + 3,
                int(np.ceil(np.log2(max(n_live / (8 * self.leaf_size), 2)))))
        frontier_depth = max(1, frontier_depth)
        emb = np.ascontiguousarray(emb, dtype=np.float32)
        p = np.asarray(p, dtype=np.float64)
        d = emb.shape[1]

        # ---- 1. find frontier roots (depth == frontier or shallower leaf)
        # and the internal nodes above them (whose splits are recyclable)
        roots: list[int] = []
        tops: list[int] = []
        walk = [0]
        while walk:
            g = walk.pop()
            if self.children[g, 0] < 0 or self.depth[g] >= frontier_depth:
                roots.append(g)
            else:
                tops.append(g)
                walk.append(int(self.children[g, 0]))
                walk.append(int(self.children[g, 1]))
        if len(roots) <= 1:
            return dataclasses.replace(self)

        # ---- 2. summarize each frontier subtree: nodes, live entity ids,
        # mass, representative.  Entity masses get a uniform floor so cold
        # entities still count against misrouting thresholds.
        rng = np.random.default_rng(seed)
        sub_nodes: list[list[int]] = []
        sub_ids: list[np.ndarray] = []
        reps = np.zeros((len(roots), d), dtype=np.float32)
        mass = np.zeros(len(roots), dtype=np.float64)
        for j, f in enumerate(roots):
            nodes = []
            walk = [f]
            ent: list[np.ndarray] = []
            while walk:
                g = walk.pop()
                nodes.append(g)
                if self.children[g, 0] >= 0:
                    walk.append(int(self.children[g, 1]))
                    walk.append(int(self.children[g, 0]))
                else:
                    row = self.leaf_entities[self.leaf_row[g]]
                    ent.append(row[row >= 0])
            sub_nodes.append(nodes)
            ids = (np.concatenate(ent) if ent
                   else np.zeros(0, np.int64)).astype(np.int64)
            sub_ids.append(ids)
            if ids.size:
                reps[j] = emb[ids].mean(axis=0)
                mass[j] = float(p[ids].sum())
        if mass.sum() <= 0:
            mass = np.ones_like(mass)
        n_ent_total = int(sum(ids.size for ids in sub_ids))
        w_floor = 0.25 * mass.sum() / max(n_ent_total, 1)

        # root->frontier paths (incl. the frontier root itself): the deepest
        # common ancestor's original split is always a *clean* fallback
        # candidate — every item sits wholly on one side by construction
        parent = np.full(self.n_nodes, -1, dtype=np.int64)
        for g in range(self.n_nodes):
            for c in self.children[g]:
                if c >= 0:
                    parent[c] = g
        paths: list[np.ndarray] = []
        for f in roots:
            pth = [int(f)]
            g = int(f)
            while parent[g] >= 0:
                g = int(parent[g])
                pth.append(g)
            paths.append(np.asarray(pth[::-1], dtype=np.int64))

        # item side per recycled original split: -1 all-left, +1 all-right,
        # 0 straddling.  A split that leaves no item straddling routes every
        # entity of every item consistently — reusing those (in any order)
        # is what lets the rebuilt top adapt depths with zero misrouting.
        top_proj = self.proj[tops].astype(np.float32)      # (G, d)
        top_tau = self.tau[tops].astype(np.float32)        # (G,)
        M, G = len(roots), len(tops)
        item_side = np.zeros((M, G), dtype=np.int8)
        for j in range(M):
            if sub_ids[j].size == 0:
                a = reps[j] @ top_proj.T <= top_tau
                item_side[j] = np.where(a, -1, 1)
                continue
            le = (emb[sub_ids[j]] @ top_proj.T) <= top_tau[None, :]
            cnt = le.sum(axis=0)
            item_side[j] = np.where(
                cnt == sub_ids[j].size, -1, np.where(cnt == 0, 1, 0))

        # ---- 3. rebuild the top over items with likelihood-balanced splits.
        # Entities whose own projection disagrees with their item's side
        # become *floaters*: they leave their home subtree (slot blanked at
        # splice time) and descend by their own margins into a leaf on the
        # side they actually route to — so a fresh mass-balancing hyperplane
        # never misroutes a query, it just relocates the few straddlers.
        proj_rows, tau_vals, children, depths, leaf_rows = [], [], [], [], []
        leaf_tables: list[list[int]] = []     # variable width; padded at end

        def splice(item: int, home: np.ndarray, floats: np.ndarray,
                   at_depth: int, parent: int, side: int):
            """Copy item's subtree, blank floated-away ids, insert floaters."""
            base = len(tau_vals)
            if parent >= 0:
                children[parent][side] = base
            nodes = sub_nodes[item]
            local = {g: i for i, g in enumerate(nodes)}
            root_depth = int(self.depth[nodes[0]])
            row_of: dict[int, int] = {}
            for g in nodes:
                proj_rows.append(self.proj[g])
                tau_vals.append(float(self.tau[g]))
                c0, c1 = self.children[g]
                children.append([
                    -1 if c0 < 0 else base + local[int(c0)],
                    -1 if c1 < 0 else base + local[int(c1)],
                ])
                depths.append(at_depth + int(self.depth[g]) - root_depth)
                lr = int(self.leaf_row[g])
                if lr >= 0:
                    row_of[g] = len(leaf_tables)
                    leaf_rows.append(len(leaf_tables))
                    leaf_tables.append(self.leaf_entities[lr].tolist())
                else:
                    leaf_rows.append(-1)
            gone = np.setdiff1d(sub_ids[item], home)
            if gone.size:
                gs = set(gone.tolist())
                for g, ri in row_of.items():
                    row = leaf_tables[ri]
                    for t, x in enumerate(row):
                        if x in gs:
                            row[t] = -1
            if floats.size:
                # level-synchronous batched descent to each float's leaf
                cur = np.full(floats.size, nodes[0], dtype=np.int64)
                active = self.children[cur, 0] >= 0
                while active.any():
                    g = cur[active]
                    a = np.einsum("ed,ed->e", emb[floats[active]],
                                  self.proj[g]) - self.tau[g]
                    cur[active] = np.where(
                        a <= 0, self.children[g, 0], self.children[g, 1])
                    active = self.children[cur, 0] >= 0
                for e, g in zip(floats.tolist(), cur.tolist()):
                    row = leaf_tables[row_of[g]]
                    try:
                        row[row.index(-1)] = e
                    except ValueError:
                        row.append(e)

        empty = np.zeros(0, dtype=np.int64)
        all_home = np.concatenate(
            [ids for ids in sub_ids if ids.size]) if n_ent_total else empty
        ent_item = np.full(emb.shape[0], -1, dtype=np.int64)
        for j, ids in enumerate(sub_ids):
            ent_item[ids] = j
        pos_of = np.full(len(roots), -1, dtype=np.int64)

        stack = [(np.arange(len(roots), dtype=np.int64),
                  all_home, empty, 0, -1, 0)]
        while stack:
            items, home_ids, float_ids, depth, parent, side = stack.pop()
            if items.size == 1:
                splice(int(items[0]), home_ids, float_ids, depth, parent,
                       side)
                continue
            slot = len(tau_vals)
            if parent >= 0:
                children[parent][side] = slot
            r = reps[items]
            pos_of[items] = np.arange(items.size)
            seg = pos_of[ent_item[home_ids]]
            m_items = np.bincount(
                seg, weights=p[home_ids], minlength=items.size)
            if m_items.sum() <= 0:
                m_items = np.ones_like(m_items)
            ids_cat = home_ids
            w_ent = p[ids_cat] + w_floor
            E_sub = emb[ids_cat]
            # threshold refinement runs on a bounded subsample — the floats
            # at the *chosen* split are still computed over every entity
            refine_cap = 2048
            if ids_cat.size > refine_cap:
                sel = rng.choice(ids_cat.size, refine_cap, replace=False)
            else:
                sel = np.arange(ids_cat.size)
            w_ref, seg_ref = w_ent[sel], seg[sel]

            # candidate list: (proj, tau, left_mask, misroute, sigma2)
            cand: list[tuple] = []

            # (a) fresh likelihood-balanced projections (Alg.1 l.4-12 over
            # items), taus refined against entity clouds
            v = rng.normal(size=(n_candidates, d)).astype(np.float32)
            v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
            alphas = r @ v.T                      # (m, K) rep projections
            a_ent_ref = emb[ids_cat[sel]] @ v.T   # (E', K) sampled ent proj
            sigma2_f = alphas.var(axis=0)
            for i in range(n_candidates):
                tau_i, nl_i = _likelihood_tau(alphas[:, i], m_items)
                order = np.argsort(alphas[:, i], kind="stable")
                side_left = np.zeros(items.size, dtype=bool)
                side_left[order[:nl_i]] = True
                tau_i, mis_i = _refine_tau(
                    alphas[:, i], nl_i, tau_i,
                    a_ent_ref[:, i], w_ref, side_left[seg_ref])
                mask = alphas[:, i] <= tau_i
                if mask.all() or not mask.any():
                    mask = side_left
                cand.append((v[i], tau_i, mask, mis_i, float(sigma2_f[i])))

            # (b) recycled original splits that are clean for this item set
            # (no straddler, both sides present) — zero misroute candidates
            # that let mass balance reorder the hierarchy
            sides = item_side[items]              # (m, G)
            usable = ((sides != 0).all(axis=0)
                      & (sides == -1).any(axis=0)
                      & (sides == 1).any(axis=0))
            for g in np.nonzero(usable)[0]:
                mask = sides[:, g] == -1
                a_rep = r @ top_proj[g]
                cand.append((top_proj[g], float(top_tau[g]), mask,
                             0.0, float(a_rep.var())))

            if len(cand) == n_candidates:
                # no clean recycled split: fall back to the deepest common
                # original ancestor (paths are root-prefixes, so the LCA is
                # the last shared node; its children each hold >= 1 item)
                pth = np.stack([paths[int(j)][: min(
                    paths[int(jj)].size for jj in items)] for j in items])
                div = int(np.argmin((pth == pth[0]).all(axis=0)))
                lca = int(pth[0, div - 1])
                mask = pth[:, div] == self.children[lca, 0]
                lp = self.proj[lca].astype(np.float32)
                lt = float(self.tau[lca])
                left_ent = mask[seg_ref]
                a_lca = emb[ids_cat[sel]] @ lp
                mis = float(w_ref[np.where(
                    left_ent, a_lca > lt, a_lca <= lt)].sum()
                    / (float(w_ref.sum()) or 1.0))
                cand.append((lp, lt, mask, mis, float((r @ lp).var())))

            misroute = np.asarray([c[3] for c in cand])
            sigma2 = np.asarray([c[4] for c in cand])
            n_l = np.asarray([int(c[2].sum()) for c in cand], np.float64)
            m_l = np.asarray([float(m_items[c[2]].sum()) for c in cand])
            n_r = items.size - n_l
            # greedy expected-depth objective at item granularity (the §3.1
            # objective one level at a time, cf. _greedy_depth_tau): a side
            # with item count N needs ~log2 N more splits, weighted by the
            # likelihood mass routed there — what reboost exists to shrink
            m_tot = float(m_items.sum())
            p_l = m_l / m_tot
            cost = (p_l * np.log2(np.maximum(n_l, 1.0))
                    + (1.0 - p_l) * np.log2(np.maximum(n_r, 1.0)))
            c_hat = (cost - cost.min()) / (np.ptp(cost) + 1e-12)
            sig_hat = sigma2 / (sigma2.max() + 1e-12)
            # "misroute" is now a *movement* budget: straddlers are floated
            # to the side they route to instead of being lost, so candidates
            # within the budget compete on the depth objective
            eligible = misroute <= max(misroute.min() + 1e-12, max_move)
            score = lam * sig_hat + (1.0 - lam) * (1.0 - c_hat)
            score = np.where(eligible, score, -np.inf)
            best = int(np.argmax(score))
            proj_best, tau, left_mask = cand[best][0], cand[best][1], \
                cand[best][2]

            # split entities: home entities follow their item unless their
            # own projection disagrees — those float to their routed side
            a_home = E_sub @ proj_best <= tau     # True = routes left
            it_left = left_mask[seg]
            go_l = it_left & a_home
            go_r = ~it_left & ~a_home
            f_l = [home_ids[~it_left & a_home]]
            f_r = [home_ids[it_left & ~a_home]]
            if float_ids.size:
                a_f = emb[float_ids] @ proj_best <= tau
                f_l.append(float_ids[a_f])
                f_r.append(float_ids[~a_f])
            proj_rows.append(proj_best)
            tau_vals.append(float(tau))
            children.append([-1, -1])
            depths.append(depth)
            leaf_rows.append(-1)
            stack.append((items[left_mask], home_ids[go_l],
                          np.concatenate(f_l), depth + 1, slot, 0))
            stack.append((items[~left_mask], home_ids[go_r],
                          np.concatenate(f_r), depth + 1, slot, 1))

        # split overfull leaves (float insertions) into small median-split
        # subtrees so the leaf table width — and with it the rerank load —
        # stays bounded by the original leaf size
        for g in range(len(tau_vals)):
            ri = leaf_rows[g]
            if ri < 0:
                continue
            row = [x for x in leaf_tables[ri] if x >= 0]
            if len(row) <= self.leaf_size:
                continue
            ids = np.asarray(row, dtype=np.int64)
            sub = _build_projection_tree(
                emb[ids], None, leaf_size=self.leaf_size, n_candidates=4,
                boost_depth=-1, lam=1.0, seed=seed + g, boosted=False)

            def remap(c: int) -> int:
                return -1 if c < 0 else (g if c == 0 else base + c - 1)

            base = len(tau_vals)
            proj_rows[g] = sub.proj[0]
            tau_vals[g] = float(sub.tau[0])
            children[g] = [remap(int(sub.children[0, 0])),
                           remap(int(sub.children[0, 1]))]
            leaf_tables[ri] = []
            leaf_rows[g] = -1
            d0 = depths[g]
            for t in range(1, sub.n_nodes):
                proj_rows.append(sub.proj[t])
                tau_vals.append(float(sub.tau[t]))
                children.append([remap(int(sub.children[t, 0])),
                                 remap(int(sub.children[t, 1]))])
                depths.append(d0 + int(sub.depth[t]))
                lr = int(sub.leaf_row[t])
                if lr >= 0:
                    leaf_rows.append(len(leaf_tables))
                    leaf_tables.append(
                        [int(ids[x]) if x >= 0 else -1
                         for x in sub.leaf_entities[lr]])
                else:
                    leaf_rows.append(-1)

        # compact the leaf table: the overfull-split pass orphans replaced
        # rows, and downstream forest sharding requires every row in a
        # tree's segment to be referenced (dense [0, n_leaves) windows)
        packed: list[list[int]] = []
        for g, ri in enumerate(leaf_rows):
            if ri >= 0:
                leaf_rows[g] = len(packed)
                packed.append(leaf_tables[ri])
        leaf_tables = packed

        n_nodes = len(tau_vals)
        depth_arr = np.asarray(depths, dtype=np.int32)
        if leaf_tables:
            width = max(self.leaf_size,
                        max(len(row) for row in leaf_tables))
            leaf_ents = np.full((len(leaf_tables), width), -1, np.int32)
            for t, row in enumerate(leaf_tables):
                leaf_ents[t, : len(row)] = row
        else:
            leaf_ents = np.zeros((0, self.leaf_size), np.int32)
        leaf_row_arr = np.asarray(leaf_rows, dtype=np.int32)
        # entity_depth is only meaningful when leaf ids index it directly
        # (single trees); forest bucket trees keep their (unused, already
        # remapped-away) table — mirroring _bucket_tree.
        if self.entity_depth.shape[0] == emb.shape[0]:
            entity_depth = self.entity_depth.copy()
            for g in range(n_nodes):
                if leaf_row_arr[g] >= 0:
                    ids = leaf_ents[leaf_row_arr[g]]
                    entity_depth[ids[ids >= 0]] = depth_arr[g]
        else:
            entity_depth = self.entity_depth.copy()
        return FlatTree(
            kind="rp",
            proj=np.stack(proj_rows),
            dims=np.zeros(n_nodes, dtype=np.int32),
            tau=np.asarray(tau_vals, dtype=np.float32),
            children=np.asarray(children, dtype=np.int32),
            leaf_row=leaf_row_arr,
            leaf_entities=leaf_ents,
            depth=depth_arr,
            entity_depth=entity_depth,
        )

    def drop_entities(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone-delete: blank the leaf slots holding ``ids`` in place.

        The split structure is untouched (it becomes stale, not wrong): a
        descent can still route through regions the dropped entities shaped,
        but the dropped ids can never be returned.  This is the cheap half
        of the mutation model — rebuild (``build_qlbt``/``build_rp_tree``)
        when enough mass has been dropped that depth quality matters.
        Returns the leaf-table rows that were masked.  The delta manifest
        does not record them — the tombstoned *entity ids* fully describe
        the change, and host-resident serving republishes by reference.
        """
        ids = np.asarray(ids)
        if ids.size == 0 or self.leaf_entities.size == 0:
            return np.zeros(0, dtype=np.int64)
        mask = np.isin(self.leaf_entities, ids) & (self.leaf_entities >= 0)
        self.leaf_entities[mask] = -1
        return np.unique(np.nonzero(mask)[0]).astype(np.int64)


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


def _refine_tau(
    alpha: np.ndarray,
    n_left: int,
    tau: float,
    a_ent: np.ndarray,
    w_ent: np.ndarray,
    left_ent: np.ndarray,
) -> tuple[float, float]:
    """Slide ``tau`` inside the boundary gap to minimize misrouted mass.

    ``alpha`` (m,) are item-representative projections whose mass-balanced
    partition (lowest ``n_left`` by alpha go left) is already fixed;
    ``a_ent``/``w_ent``/``left_ent`` ((E,)) are the items' *entity*
    projections, likelihood masses, and assigned sides.  A threshold set
    between representatives can still cut through an item's entity cloud,
    silently misrouting the query-time descent toward the wrong subtree;
    we sweep every breakpoint of the wrong-side-mass step function that
    keeps the representative partition intact (tau strictly between the
    boundary reps) and return (tau, misrouted-mass fraction).  The
    fraction is exact, so the caller can reject candidates whose clouds
    straddle any admissible threshold.
    """
    order = np.argsort(alpha, kind="stable")
    lo = float(alpha[order[n_left - 1]])
    hi = float(alpha[order[n_left]])
    total = float(w_ent.sum())
    if total <= 0:
        return tau, 0.0
    o = np.argsort(a_ent, kind="stable")
    a_s, w_s, l_s = a_ent[o], w_ent[o], left_ent[o]
    # f[k] = wrong-side mass for tau in [a_s[k], a_s[k+1})
    f = w_s[l_s].sum() + np.cumsum(np.where(l_s, -w_s, w_s))
    mids = 0.5 * (a_s[:-1] + a_s[1:])
    ok = (mids > lo) & (mids < hi)
    if not ok.any():                       # boundary gap holds no entities
        t = 0.5 * (lo + hi)
        k = int(np.searchsorted(a_s, t, side="right")) - 1
        mis = float(f[k]) if k >= 0 else float(w_s[l_s].sum())
        return t, mis / total
    fk = f[:-1][ok]
    best = int(np.argmin(fk))
    return float(mids[ok][best]), float(fk[best] / total)


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
    ``lax.top_k``'s do.  The descent and the leaf gather are
    ``tree_descent_op`` (one kernel launch on the card); the rerank
    gathers the candidates' rows and sorts their exact distances.
    """
    queries = queries.to(torch.float32)
    dev = queries.device
    _, steps, visits, cand, n_cand = kernel_ops.tree_descent_op(
        arrays, queries, kind=kind, beam_width=beam_width,
        max_steps=max_steps, roots=roots)

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
