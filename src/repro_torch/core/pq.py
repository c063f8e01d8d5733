"""Product quantization (paper §2/§3.2 — top-level index over centroids).

Port of ``repro/core/pq.py``.  Classic Jégou-style PQ: split d dims into M
subspaces, k-means a 256-entry codebook per subspace (the port's
``kmeans_fit``, on the card unless ``device`` says otherwise), encode
vectors as M uint8 codes.  Query-time asymmetric distance computation
(ADC) builds a (M, 256) LUT of exact subspace distances and scores a code
as ``sum_m LUT[m, code[n, m]]``; the scan and its top-k are the
hand-written ``pq_adc_topk`` kernel (``kernels.ops.pq_adc_topk_op``),
which sums the M entries in order (the reference's jnp path leaves the
order to XLA, so scores agree to rounding, not bitwise).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans_assign, kmeans_fit
from repro_torch.device import resolve
from repro_torch.kernels.ops import pq_adc_topk_op
from repro_torch.kernels.ref import pq_adc_scores_ref

__all__ = ["ProductQuantizer", "pq_train", "adc_lut", "adc_scores",
           "pq_search"]


@dataclasses.dataclass
class ProductQuantizer:
    codebooks: np.ndarray   # (M, 256, d_sub) float32
    codes: np.ndarray       # (N, M) uint8
    d: int

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])

    def footprint_bytes(self) -> int:
        return self.codebooks.nbytes + self.codes.nbytes


def _subspaces(x: np.ndarray, m: int) -> np.ndarray:
    n, d = x.shape
    if d % m:
        x = np.pad(x, ((0, 0), (0, m - d % m)))
    return x.reshape(n, m, -1)


def pq_train(
    x: np.ndarray,
    m: int = 8,
    n_codes: int = 256,
    *,
    iters: int = 12,
    seed: int = 0,
    train_sample: int | None = 200_000,
    device=None,
) -> ProductQuantizer:
    """Train per-subspace codebooks and encode the full corpus.  The rows
    sampled and the initial codewords are the reference's (same host
    rng); the Lloyd steps run on ``device``, so codebooks agree with the
    reference's to rounding, not bitwise."""
    dev = resolve(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    subs = _subspaces(x, m)                               # (n, m, ds)
    rng = np.random.default_rng(seed)
    if train_sample is not None and train_sample < n:
        sel = rng.choice(n, size=train_sample, replace=False)
    else:
        sel = slice(None)
    books, codes = [], []
    for j in range(m):
        km = kmeans_fit(np.ascontiguousarray(subs[sel, j]), min(n_codes, n),
                        iters=iters, seed=seed + j, device=dev)
        cb = km.centroids
        if cb.shape[0] < n_codes:                          # tiny corpora
            cb = np.concatenate(
                [cb, np.repeat(cb[-1:], n_codes - cb.shape[0], 0)], 0
            )
        books.append(cb)
        a, _ = kmeans_assign(np.ascontiguousarray(subs[:, j]), cb,
                             device=dev)
        codes.append(a.astype(np.uint8))
    return ProductQuantizer(
        codebooks=np.stack(books), codes=np.stack(codes, axis=1), d=d
    )


def adc_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(B, M, 256) exact subspace distances query→codewords."""
    B = queries.shape[0]
    m, _, ds = codebooks.shape
    d = m * ds
    q = queries.to(torch.float32)
    if q.shape[1] != d:
        q = torch.nn.functional.pad(q, (0, d - q.shape[1]))
    qs = q.reshape(B, m, ds)
    diff = qs[:, :, None, :] - codebooks[None]            # (B, M, 256, ds)
    return torch.sum(diff * diff, dim=-1)


def adc_scores(lut: torch.Tensor, codes: torch.Tensor,
               chunk: int = 131072) -> torch.Tensor:
    """(B, N) approximate distances ``sum_m lut[b, m, codes[n, m]]``,
    ``chunk`` codes at a time (the reference's jnp oracle of the
    ``pq_adc`` scan); the M entries are summed in order from 0.0, as the
    kernel's plain version sums them."""
    n = codes.shape[0]
    out = torch.empty((lut.shape[0], n), dtype=torch.float32,
                      device=lut.device)
    for r0 in range(0, n, max(1, min(chunk, n))):
        out[:, r0:r0 + chunk] = pq_adc_scores_ref(lut, codes[r0:r0 + chunk])
    return out


def pq_search(
    pq: ProductQuantizer, queries: np.ndarray, k: int, *, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """ADC top-k over all codes (approximate dists, ids), through the
    ``pq_adc_topk`` kernel on the card."""
    dev = resolve(device)
    lut = adc_lut(torch.as_tensor(np.asarray(queries, np.float32),
                                  device=dev),
                  torch.as_tensor(pq.codebooks, device=dev))
    d, i = pq_adc_topk_op(lut, torch.as_tensor(pq.codes, device=dev),
                          min(k, pq.n))
    return d.cpu().numpy(), i.cpu().numpy()
