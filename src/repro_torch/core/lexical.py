"""Fixed-shape BM25 postings slabs + the pure-numpy lexical oracle.

Port of ``repro/core/lexical.py`` (numpy only), kept here so the port
imports nothing of the reference.  Documents carry their term data as
fixed-shape slabs:

* ``terms``  — ``(N, S)`` int32, the up-to-``S`` highest-tf term ids of
  each document in ascending id order, ``-1``-padded;
* ``tf_sat`` — ``(N, S)`` f32, the saturated term-frequency factor
  ``tf * (k1 + 1) / (tf + k1 * (1 - b + b * len_d / avg_len))``.

The ranking distance is ``-score`` with ``score = sum_t idf_t *
tf_sat(t, d)`` over the query's unique terms, so lower is better and the
``(inf, -1)`` sentinel contract carries over.  ``idf`` and ``avg_len``
are frozen at build time.

The reference builds the slabs with two Python loops over the documents;
here the same arithmetic runs vectorised over a flat token array (one
sort for the per-document term counts), which gives identical arrays
(held by ``tests/test_torch_options_slice.py``) and builds a million
documents in seconds.  Two of the reference's rules are kept exactly:
``len_d`` in ``avg_len`` counts every token of the document while the
per-document ``len_d`` counts its non-negative ones, and a document with
more than ``S`` distinct terms keeps its highest-tf terms, ties toward
the lower id.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LexicalSlabs", "build_lexical_slabs", "build_lexical_slabs_flat",
           "query_operands", "bm25_dists"]


@dataclasses.dataclass
class LexicalSlabs:
    terms: np.ndarray        # (N, S) int32, -1 padded
    tf_sat: np.ndarray       # (N, S) f32, saturated tf factor
    idf: np.ndarray          # (V,) f32, frozen at build
    k1: float
    b: float
    avg_len: float           # frozen at build

    @property
    def n_docs(self) -> int:
        return int(self.terms.shape[0])

    @property
    def slots(self) -> int:
        return int(self.terms.shape[1])

    @property
    def n_vocab(self) -> int:
        return int(self.idf.shape[0])

    def footprint_bytes(self) -> int:
        return self.terms.nbytes + self.tf_sat.nbytes + self.idf.nbytes

    def append_docs(self, docs) -> None:
        """Append one slab row per document (term-id sequences), scored
        under the frozen idf / avg_len."""
        tokens, offsets = _flatten_docs(docs)
        t, s = _slab_rows(tokens, offsets, self.slots, self.k1, self.b,
                          self.avg_len)
        self.terms = np.concatenate([self.terms, t])
        self.tf_sat = np.concatenate([self.tf_sat, s])


def _flatten_docs(docs) -> "tuple[np.ndarray, np.ndarray]":
    """Term-id sequences -> (tokens (total,) int64, offsets (n + 1,))."""
    lens = np.fromiter((len(d) for d in docs), dtype=np.int64,
                       count=len(docs))
    offsets = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if not offsets[-1]:
        return np.zeros(0, np.int64), offsets
    tokens = np.concatenate([np.asarray(d, dtype=np.int64).reshape(-1)
                             for d in docs if len(d)])
    return tokens, offsets


def _term_counts(tokens, offsets):
    """Per document, its distinct term ids ascending with their counts:
    (doc, term, count) arrays sorted by (doc, term)."""
    n = offsets.size - 1
    doc = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    order = np.lexsort((tokens, doc))
    d, t = doc[order], tokens[order]
    if not d.size:
        return d, t, np.zeros(0, np.int64)
    new = np.ones(d.size, dtype=bool)
    new[1:] = (d[1:] != d[:-1]) | (t[1:] != t[:-1])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, d.size))
    return d[starts], t[starts], counts


def _slab_rows(tokens, offsets, slots: int, k1: float, b: float,
               avg_len: float):
    n = offsets.size - 1
    terms = np.full((n, slots), -1, dtype=np.int32)
    tf_sat = np.zeros((n, slots), dtype=np.float32)
    doc, term, tf = _term_counts(tokens, offsets)
    pos = term >= 0
    doc, term, tf = doc[pos], term[pos], tf[pos]
    length = np.bincount(doc, weights=tf, minlength=n)
    # keep the highest-tf terms: rank within the document by (-tf, id)
    by_tf = np.lexsort((term, -tf, doc))
    first = np.searchsorted(doc[by_tf], doc[by_tf], side="left")
    keep = np.empty(doc.size, dtype=bool)
    keep[by_tf] = (np.arange(doc.size) - first) < slots
    doc, term, tf = doc[keep], term[keep], tf[keep]
    slot = np.arange(doc.size) - np.searchsorted(doc, doc, side="left")
    k1n = k1 * (1.0 - b + b * (length / max(avg_len, 1e-9)))
    terms[doc, slot] = term.astype(np.int32)
    tf_sat[doc, slot] = (tf * (k1 + 1.0) / (tf + k1n[doc])).astype(np.float32)
    return terms, tf_sat


def build_lexical_slabs_flat(tokens, offsets, n_vocab: int, *,
                             slots: int = 16, k1: float = 1.2,
                             b: float = 0.75) -> LexicalSlabs:
    """:func:`build_lexical_slabs` over flat documents: document ``i`` is
    ``tokens[offsets[i]:offsets[i + 1]]``."""
    tokens = np.asarray(tokens, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    n = offsets.size - 1
    _, term, _ = _term_counts(tokens, offsets)
    df = np.bincount(term[(term >= 0) & (term < n_vocab)],
                     minlength=n_vocab).astype(np.int64)
    lengths = np.diff(offsets).astype(np.float64)
    avg_len = float(lengths.mean()) if n else 1.0
    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)
    terms, tf_sat = _slab_rows(tokens, offsets, slots, k1, b, avg_len)
    return LexicalSlabs(terms=terms, tf_sat=tf_sat, idf=idf,
                        k1=float(k1), b=float(b), avg_len=avg_len)


def build_lexical_slabs(docs, n_vocab: int, *, slots: int = 16,
                        k1: float = 1.2, b: float = 0.75) -> LexicalSlabs:
    """Build slabs + corpus statistics from term-id sequences."""
    tokens, offsets = _flatten_docs(docs)
    return build_lexical_slabs_flat(tokens, offsets, n_vocab, slots=slots,
                                    k1=k1, b=b)


def query_operands(q_docs, slabs: LexicalSlabs, *, slots: int = 8):
    """Fixed-shape query operands: ``(B, T)`` unique term ids (-1 pad)
    and their idf weights.  Terms beyond ``slots`` are dropped highest-
    idf-first-kept (rarest terms carry the score)."""
    bsz = len(q_docs)
    qt = np.full((bsz, slots), -1, dtype=np.int32)
    qw = np.zeros((bsz, slots), dtype=np.float32)
    for i, doc in enumerate(q_docs):
        ids = np.unique(np.asarray(doc, dtype=np.int64))
        ids = ids[(ids >= 0) & (ids < slabs.n_vocab)]
        w = slabs.idf[ids]
        if ids.size > slots:
            keep = np.argsort(-w, kind="stable")[:slots]
            keep.sort()
            ids, w = ids[keep], w[keep]
        qt[i, :ids.size] = ids.astype(np.int32)
        qw[i, :ids.size] = w.astype(np.float32)
    return qt, qw


def bm25_dists(terms: np.ndarray, tf_sat: np.ndarray,
               q_terms: np.ndarray, q_weights: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle: ``(B, N)`` ranking distances (``-score``)."""
    bsz, tq = q_terms.shape
    score = np.zeros((bsz, terms.shape[0]), dtype=np.float32)
    for t in range(tq):
        qt = q_terms[:, t]                                   # (B,)
        m = (terms[None, :, :] == qt[:, None, None])         # (B, N, S)
        m &= qt[:, None, None] >= 0
        score += (m * tf_sat[None, :, :]).sum(-1) * q_weights[:, t:t + 1]
    return -score
