"""EmbeddingBag and fused-table helpers: the port of
``repro/models/embedding.py``.

``embedding_bag`` is a gather plus a masked reduction, as in the
reference (``-1`` pads a bag), so it needs no ``nn.EmbeddingBag`` layout.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["embedding_bag", "take_embeddings", "concat_table_offsets"]


def take_embeddings(table, ids):
    """Row gather with -1 = padding (returns zeros)."""
    ids = torch.as_tensor(ids, device=table.device)
    out = table[ids.clamp(min=0)]
    return torch.where((ids >= 0)[..., None], out, torch.zeros_like(out))


def embedding_bag(table, ids, *, weights=None, mode: str = "sum"):
    """ids (..., L) with -1 padding -> (..., D) reduced embeddings."""
    ids = torch.as_tensor(ids, device=table.device)
    e = take_embeddings(table, ids)                       # (..., L, D)
    if weights is not None:
        e = e * weights[..., None]
    if mode == "sum":
        return e.sum(dim=-2)
    if mode == "mean":
        n = torch.clamp((ids >= 0).sum(dim=-1, keepdim=True), min=1)
        return e.sum(dim=-2) / n
    if mode == "max":
        e = e.masked_fill(~(ids >= 0)[..., None], -torch.inf)
        out = e.amax(dim=-2)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(f"unknown mode {mode!r}")


def concat_table_offsets(table_sizes):
    """Offsets for fusing per-feature tables into one big table.

    MLPerf-DLRM-style: 26 tables become one (sum_rows, D) array; feature
    j's id i maps to row offsets[j] + i -- one gather instead of 26.
    """
    off = np.zeros(len(table_sizes), dtype=np.int64)
    np.cumsum(np.asarray(table_sizes)[:-1], out=off[1:])
    return off, int(sum(table_sizes))
