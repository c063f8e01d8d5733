"""Footprint-reduced LSH (paper §3.2 bottom-level option 3).

Port of ``repro/core/lsh.py``.  Sign-random-projection LSH with a *fixed,
shared* projection set (one (d, n_bits) matrix reused by every bucket
instead of per-bucket hash tables).  Codes are bit-packed into int32
lanes; search = XOR + popcount Hamming ranking through the hand-written
``hamming_topk`` kernel, then exact rerank of the shortlist.

``pack_bits`` and ``lsh_build`` are numpy copies of the reference's, so
the same inputs give the same codes; the query bits of ``lsh_search`` are
computed the same way, on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.brute import batched_l2sq
from repro_torch.device import resolve
from repro_torch.kernels.common import stable_topk
from repro_torch.kernels.ops import hamming_topk_op

__all__ = ["LSHIndex", "lsh_build", "pack_bits", "lsh_search"]


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, n_bits) {0,1} -> (N, ceil(n_bits/32)) int32 little-endian."""
    n, nb = bits.shape
    pad = (-nb) % 32
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    b = bits.reshape(n, -1, 32).astype(np.uint64)
    weights = (1 << np.arange(32, dtype=np.uint64))
    packed = (b * weights).sum(axis=2)
    return packed.astype(np.uint32).view(np.int32).reshape(n, -1)


@dataclasses.dataclass
class LSHIndex:
    proj: np.ndarray      # (d, n_bits) float32 — the fixed shared projections
    codes: np.ndarray     # (N, W) int32 packed sign bits
    n_bits: int

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])

    def footprint_bytes(self) -> int:
        return self.proj.nbytes + self.codes.nbytes


def lsh_build(x: np.ndarray, n_bits: int = 64, seed: int = 0,
              proj: np.ndarray | None = None) -> LSHIndex:
    x = np.ascontiguousarray(x, dtype=np.float32)
    d = x.shape[1]
    if proj is None:
        rng = np.random.default_rng(seed)
        proj = rng.normal(size=(d, n_bits)).astype(np.float32)
        proj /= np.linalg.norm(proj, axis=0, keepdims=True)
    bits = (x @ proj > 0).astype(np.uint8)
    return LSHIndex(proj=proj, codes=pack_bits(bits), n_bits=n_bits)


def lsh_search(
    index: LSHIndex,
    db: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    n_candidates: int = 128,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Hamming shortlist of ``n_candidates`` (the ``hamming_topk`` kernel on
    the card) then exact rerank to top-k.  ``db`` is a numpy array or a
    tensor (a tensor already on ``device`` is not copied)."""
    dev = resolve(device)
    q = np.ascontiguousarray(queries, dtype=np.float32)
    qbits = (q @ index.proj > 0).astype(np.uint8)
    n_candidates = min(n_candidates, index.n)
    _, cand = hamming_topk_op(
        torch.as_tensor(pack_bits(qbits), device=dev),
        torch.as_tensor(index.codes, device=dev), n_candidates)
    # exact rerank
    qt = torch.as_tensor(q, device=dev)
    vecs = torch.as_tensor(db, dtype=torch.float32, device=dev)[
        cand.long()]                                      # (B, C, d)
    d, sel = stable_topk(batched_l2sq(vecs, qt), min(k, n_candidates))
    ids = torch.gather(cand, 1, sel)
    return d.cpu().numpy(), ids.cpu().numpy()
