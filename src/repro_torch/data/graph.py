"""Graph data: synthetic corpora at the assigned shapes + a real CSR
uniform neighbor sampler (required for minibatch_lg — taxonomy §GNN).
A copy of ``repro/data/graph.py`` (numpy only), so the same seeds give
the reference's graphs, samples and batches bit for bit.

Synthetic graphs are degree-skewed (preferential-attachment flavored) so
sampled subgraphs have realistic fanout variance.  Node features carry a
planted community signal for the classification loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CSRGraph", "make_graph", "NeighborSampler", "molecule_batch",
           "pad_edges"]


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray        # (N+1,) int64
    indices: np.ndarray       # (E,) int32 neighbor ids
    feats: np.ndarray         # (N, F) float32
    labels: np.ndarray        # (N,) int32
    pos: np.ndarray           # (N, 3) float32 (for SchNet distance filters)

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        senders = np.repeat(
            np.arange(self.n_nodes, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )
        return senders, self.indices


def make_graph(n_nodes: int, n_edges: int, d_feat: int, *,
               n_classes: int = 16, seed: int = 0) -> CSRGraph:
    """Degree-skewed random graph with community-structured features."""
    rng = np.random.default_rng(seed)
    # heavy-tailed out-degrees summing ~ n_edges
    deg = rng.zipf(1.5, size=n_nodes).astype(np.float64)
    deg = np.maximum(1, np.round(deg * n_edges / deg.sum())).astype(np.int64)
    # adjust to exact edge count
    diff = n_edges - int(deg.sum())
    if diff != 0:
        idx = rng.choice(n_nodes, size=abs(diff))
        np.add.at(deg, idx, np.sign(diff))
        deg = np.maximum(deg, 1)
    e = int(deg.sum())
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    comm = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    # neighbors biased to same community
    indices = np.empty(e, dtype=np.int32)
    same = rng.random(e) < 0.6
    rand_all = rng.integers(0, n_nodes, size=e).astype(np.int32)
    indices[:] = rand_all
    # community-preserving rewire (vectorized approximation): map same-comm
    # edges to a random node with the sender's community via sorted pools
    order = np.argsort(comm, kind="stable")
    comm_sorted = comm[order]
    starts = np.searchsorted(comm_sorted, np.arange(n_classes))
    ends = np.searchsorted(comm_sorted, np.arange(n_classes), side="right")
    senders = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    sc = comm[senders]
    pool_size = np.maximum(ends[sc] - starts[sc], 1)
    draw = starts[sc] + (rng.random(e) * pool_size).astype(np.int64)
    indices[same] = order[draw[same]].astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32) * 0.5
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats += centers[comm]
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 4.0
    pos += rng.normal(size=(n_classes, 3)).astype(np.float32)[comm] * 4.0
    return CSRGraph(indptr=indptr, indices=indices, feats=feats,
                    labels=comm, pos=pos)


class NeighborSampler:
    """Uniform k-hop fanout sampler over CSR (GraphSAGE-style).

    ``sample(seeds)`` returns a padded subgraph dict ready for the SchNet
    step: local node features/positions, local edge list, seed mask.
    """

    def __init__(self, graph: CSRGraph, fanout: tuple[int, ...],
                 seed: int = 0):
        self.g = graph
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, k: int):
        g = self.g
        deg = (g.indptr[nodes + 1] - g.indptr[nodes]).astype(np.int64)
        # uniform with replacement (standard GraphSAGE); deg==0 -> self-loop
        draw = (self.rng.random((nodes.size, k)) *
                np.maximum(deg, 1)[:, None]).astype(np.int64)
        nbr = g.indices[(g.indptr[nodes][:, None] + draw)]
        nbr = np.where(deg[:, None] > 0, nbr, nodes[:, None])
        src = np.repeat(nodes, k).astype(np.int32)
        return src, nbr.reshape(-1).astype(np.int32)

    def sample(self, seeds: np.ndarray) -> dict:
        """Returns a local-id subgraph with edges from all hops."""
        seeds = np.asarray(seeds, dtype=np.int32)
        frontier = seeds
        all_src, all_dst = [], []
        for k in self.fanout:
            s, d = self._sample_neighbors(frontier, k)
            all_src.append(s)
            all_dst.append(d)
            frontier = np.unique(d)
        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)
        nodes, inv = np.unique(np.concatenate([seeds, src, dst]),
                               return_inverse=True)
        n_seed = seeds.size
        src_l = inv[n_seed : n_seed + src.size].astype(np.int32)
        dst_l = inv[n_seed + src.size :].astype(np.int32)
        seed_l = inv[:n_seed].astype(np.int32)
        g = self.g
        return {
            "feats": g.feats[nodes],
            "pos": g.pos[nodes],
            # message direction: neighbor -> seed side
            "senders": dst_l,
            "receivers": src_l,
            "labels": g.labels[nodes],
            "seed_local": seed_l,
            "node_ids": nodes,
        }


def pad_edges(batch: dict, n_nodes: int, n_edges: int) -> dict:
    """Pad a sampled subgraph to fixed (n_nodes, n_edges) for jit reuse."""
    out = dict(batch)
    cn = batch["feats"].shape[0]
    ce = batch["senders"].shape[0]
    if cn > n_nodes or ce > n_edges:
        raise ValueError(f"subgraph ({cn},{ce}) exceeds pad ({n_nodes},"
                         f"{n_edges})")
    out["feats"] = np.pad(batch["feats"], ((0, n_nodes - cn), (0, 0)))
    out["pos"] = np.pad(batch["pos"], ((0, n_nodes - cn), (0, 0)))
    out["labels"] = np.pad(batch["labels"], (0, n_nodes - cn))
    out["node_mask"] = (np.arange(n_nodes) < cn).astype(np.float32)
    out["senders"] = np.pad(batch["senders"], (0, n_edges - ce),
                            constant_values=-1)
    out["receivers"] = np.pad(batch["receivers"], (0, n_edges - ce),
                              constant_values=-1)
    return out


def molecule_batch(n_graphs: int, n_nodes: int, n_edges: int, d_feat: int,
                   step: int, seed: int = 0, cutoff: float = 10.0) -> dict:
    """Batched small molecules, flattened with graph_ids (shape `molecule`).

    Edges come from `core.graph_build.radius_graph` — the paper-technique
    integration point for SchNet (DESIGN.md §5).
    """
    from repro_torch.core.graph_build import radius_graph

    rng = np.random.default_rng((seed, step))
    feats, pos, snd, rcv, gid, energy = [], [], [], [], [], []
    off = 0
    for g in range(n_graphs):
        p = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 2.5
        f = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
        s, r = radius_graph(p, cutoff, method="brute",
                            max_neighbors=max(2, n_edges // n_nodes))
        if s.size > n_edges:
            sel = rng.choice(s.size, size=n_edges, replace=False)
            s, r = s[sel], r[sel]
        pad = n_edges - s.size
        s = np.pad(s + off, (0, pad), constant_values=-1)
        r = np.pad(r + off, (0, pad), constant_values=-1)
        feats.append(f)
        pos.append(p)
        snd.append(s)
        rcv.append(r)
        gid.append(np.full(n_nodes, g, dtype=np.int32))
        # planted energy: sum of pairwise 1/d within cutoff (LJ-flavored)
        d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1) + 1e-6)
        energy.append(np.float32((1.0 / d[d < cutoff]).sum() / n_nodes))
    return {
        "feats": np.concatenate(feats),
        "pos": np.concatenate(pos),
        "senders": np.concatenate(snd),
        "receivers": np.concatenate(rcv),
        "graph_ids": np.concatenate(gid),
        "energy": np.asarray(energy, dtype=np.float32),
    }
