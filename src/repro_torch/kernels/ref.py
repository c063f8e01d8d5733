"""Plain PyTorch versions of the ported kernels (the ``ref.py`` contract).

Port of the l2 and candidate parts of ``repro/kernels/ref.py``.  Each
function computes its kernel's result with no tiling; ``ops`` runs it for
tensors on the CPU, the tests hold it against the reference, and
``chip_smoke.py`` holds each kernel against it on the card.

``k`` is clamped to the candidate count, slots with no live candidate
come back as ``(inf, -1)``, and the distance expansions are exactly
``core.brute``'s, so the fused path equals the unfused one on the CPU.
Top-k is a stable sort over id-ordered columns (``lax.top_k``'s tie
order), never ``torch.topk``.

Tie rule: the kernels rank on the (distance, id) pair.  On an id-ordered
scan (``l2_topk``) that is the same order.  ``candidate_topk_ref`` keeps
the reference oracle's column order (carried best first, then the tile),
so it agrees with the kernel wherever ids are distinct and distances
untied — true on the IVF path, whose buckets are disjoint.
"""
from __future__ import annotations

import torch

from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels.common import INF, pad_sentinel, stable_topk

__all__ = ["l2_topk_ref", "candidate_topk_ref"]


def _finish(d2: torch.Tensor, k: int):
    """top-k + sentinel masking + clamp-restoring pad; ids are the scan
    positions."""
    k_eff = min(k, d2.shape[1])
    d, ids = stable_topk(d2, k_eff)
    ids = torch.where(torch.isinf(d), -1, ids.to(torch.int32))
    return pad_sentinel(d, ids, k, k_eff)


def _apply_valid(d2: torch.Tensor, valid):
    if valid is None:
        return d2
    live = torch.as_tensor(valid, device=d2.device).to(torch.int32) != 0
    return torch.where(live[None, :], d2, INF)


def l2_topk_ref(queries, db, k: int = 10, *, valid=None):
    q = queries.to(torch.float32)
    x = db.to(torch.float32)
    return _finish(_apply_valid(pairwise_l2sq(q, x), valid), k)


def candidate_topk_ref(queries, vecs, ids, k: int = 10, *,
                       best_d=None, best_i=None):
    """Per-query candidate tiles with an optional carried running best
    (the IVF probe-chain pattern); the literal ops of the unfused IVF
    local."""
    q = queries.to(torch.float32)
    v = vecs.to(torch.float32)
    ids = ids.to(torch.int32)
    d2 = torch.where(ids >= 0, batched_l2sq(v, q), INF)
    if best_d is not None:
        cat_d = torch.cat([best_d.to(torch.float32), d2], dim=1)
        cat_i = torch.cat([best_i.to(torch.int32), ids], dim=1)
        d, sel = stable_topk(cat_d, k)
        out_i = torch.gather(cat_i, 1, sel)
    else:
        k_eff = min(k, ids.shape[1])
        d, sel = stable_topk(d2, k_eff)
        d, out_i = pad_sentinel(d, torch.gather(ids, 1, sel), k, k_eff)
    return d, torch.where(torch.isinf(d), -1, out_i)
