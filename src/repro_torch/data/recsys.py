"""Synthetic recsys batches (Criteo-like CTR + behavior sequences): a copy
of ``repro/data/recsys.py`` (numpy only), so the same seed and step give
the reference's batches bit for bit.

Stateless per-step generation like `data.lm` — (seed, step) determines the
batch.  Labels follow a planted logistic model over a few latent factors so
training has signal.

``sasrec_batch`` pads a sequence at its end (``-1``), and
``models.recsys.serve_logits`` scores the last slot, so a padded sequence
is scored from a pad position: the reference's behaviour, kept for parity
(ROADMAP.md, faults).

``serve_batch`` and ``retrieval_batch`` (the port's own) cut a
``batch_for`` batch into what ``models.recsys.serve_logits`` and
``retrieval_logits`` take.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import (DCNConfig, DINConfig, DLRMConfig,
                                      SASRecConfig)
from repro_torch.models.embedding import concat_table_offsets

__all__ = ["ctr_batch", "din_batch", "sasrec_batch", "batch_for",
           "serve_batch", "retrieval_batch"]


def ctr_batch(cfg, batch: int, step: int, seed: int = 0) -> dict:
    """DLRM/DCN batch: dense (B,13), sparse (B,26) global-offset ids."""
    rng = np.random.default_rng((seed, step))
    offsets, _ = concat_table_offsets(cfg.table_sizes)
    dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    cols = []
    for j, size in enumerate(cfg.table_sizes):
        # Zipf-ish id popularity
        ids = np.minimum(
            rng.zipf(1.2, size=batch) - 1, size - 1
        ).astype(np.int64)
        cols.append(offsets[j] + ids)
    sparse = np.stack(cols, axis=1).astype(np.int64)
    w = np.sin(np.arange(cfg.n_dense)) * 0.5
    logit = dense @ w + 0.1 * ((sparse.sum(1) % 7) - 3)
    label = (logit + rng.normal(size=batch) > 0).astype(np.float32)
    return {"dense": dense, "sparse": sparse.astype(np.int32),
            "label": label}


def din_batch(cfg: DINConfig, batch: int, step: int, seed: int = 0) -> dict:
    rng = np.random.default_rng((seed, step))
    L = cfg.seq_len
    hist = rng.integers(0, cfg.n_items, size=(batch, L)).astype(np.int32)
    lens = rng.integers(L // 4, L + 1, size=batch)
    hist[np.arange(L)[None, :] >= lens[:, None]] = -1
    hist_c = np.where(hist >= 0, hist % cfg.n_cates, -1).astype(np.int32)
    target = rng.integers(0, cfg.n_items, size=batch).astype(np.int32)
    target_c = (target % cfg.n_cates).astype(np.int32)
    # planted signal: click if target's category appears in history
    match = (hist_c == target_c[:, None]).any(axis=1)
    label = np.where(
        match, (rng.random(batch) < 0.8), (rng.random(batch) < 0.2)
    ).astype(np.float32)
    return {"hist_items": hist, "hist_cates": hist_c,
            "target_item": target, "target_cate": target_c, "label": label}


def sasrec_batch(cfg: SASRecConfig, batch: int, step: int,
                 seed: int = 0) -> dict:
    rng = np.random.default_rng((seed, step))
    L = cfg.seq_len
    # random-walk sequences over a ring of items (structure to learn)
    start = rng.integers(0, cfg.n_items, size=batch)
    steps = rng.integers(1, 5, size=(batch, L + 1))
    seq_full = (start[:, None] + np.cumsum(steps, axis=1)) % cfg.n_items
    seq = seq_full[:, :L].astype(np.int32)
    pos = seq_full[:, 1 : L + 1].astype(np.int32)
    neg = rng.integers(0, cfg.n_items, size=(batch, L)).astype(np.int32)
    lens = rng.integers(2, L + 1, size=batch)
    mask = np.arange(L)[None, :] >= lens[:, None]
    seq[mask] = -1
    pos[mask] = -1
    return {"seq": seq, "pos": pos, "neg": neg}


def batch_for(cfg, batch: int, step: int, seed: int = 0) -> dict:
    if isinstance(cfg, (DLRMConfig, DCNConfig)):
        return ctr_batch(cfg, batch, step, seed)
    if isinstance(cfg, DINConfig):
        return din_batch(cfg, batch, step, seed)
    if isinstance(cfg, SASRecConfig):
        return sasrec_batch(cfg, batch, step, seed)
    raise TypeError(type(cfg))


def serve_batch(cfg, batch: dict) -> dict:
    """A ``batch_for`` batch as ``serve_logits`` takes it: the label
    dropped; SASRec scores each sequence's last positive as its target."""
    if isinstance(cfg, SASRecConfig):
        return {"seq": batch["seq"], "target_item": batch["pos"][:, -1]}
    return {k: v for k, v in batch.items() if k != "label"}


def retrieval_batch(cfg, batch: dict, n_candidates: int) -> dict:
    """The first user of a ``batch_for`` batch against candidates
    ``0 .. n_candidates - 1`` (DIN's categories ``id % n_cates``), as
    ``retrieval_logits`` takes them."""
    cand = np.arange(n_candidates, dtype=np.int32)
    if isinstance(cfg, SASRecConfig):
        return {"seq": batch["seq"][:1], "candidates": cand}
    if isinstance(cfg, DINConfig):
        return {"hist_items": batch["hist_items"][:1],
                "hist_cates": batch["hist_cates"][:1], "candidates": cand,
                "cand_cates": (cand % cfg.n_cates).astype(np.int32)}
    if isinstance(cfg, (DLRMConfig, DCNConfig)):
        return {"dense": batch["dense"][:1], "sparse": batch["sparse"][:1],
                "candidates": cand}
    raise TypeError(type(cfg))
