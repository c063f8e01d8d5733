"""Device dispatch of the ported kernels (mirrors ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version in ``ref``.  There is no fallback
from one to the other and no switch that forces either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bucket_topk, l2_topk, ref

__all__ = ["l2_topk_op", "candidate_topk_op"]


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def l2_topk_op(queries, db, k: int = 10, *, valid=None):
    """Fused brute-force L2 top-k: (dists ascending, ids)."""
    if _on_card(queries):
        return l2_topk.l2_topk(queries, db, k, valid=valid)
    return ref.l2_topk_ref(queries, db, k, valid=valid)


def candidate_topk_op(queries, vecs, ids, k: int = 10, *,
                      best_d=None, best_i=None):
    """Per-query candidate-tile L2 top-k with optional carried best (IVF
    probe chains): (dists ascending, ids)."""
    if _on_card(queries):
        return bucket_topk.candidate_topk(queries, vecs, ids, k,
                                          best_d=best_d, best_i=best_i)
    return ref.candidate_topk_ref(queries, vecs, ids, k,
                                  best_d=best_d, best_i=best_i)
