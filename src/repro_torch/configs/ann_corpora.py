"""The paper's own serving corpora (§4.1), copied from
``repro/configs/ann_corpora.py`` with the ``AnnConfig`` fields they use.

radio-station : 10 K x 256  (private VA traffic; QLBT territory, <30 K)
sift-1m       : 1 M  x 128  (public SIFT; two-level PQ+brute, 2^13 buckets)
deep-10m      : 10 M x 96   (public DEEP subset; two-level, 2^15 buckets)

This slice serves the brute top level only; ``top="pq"`` is the paper's
choice for the two large corpora and waits for the PQ port.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AnnConfig", "RADIO_STATION", "SIFT_1M", "DEEP_10M"]


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    name: str
    n: int
    d: int
    n_clusters: int
    top: str = "pq"
    bottom: str = "brute"
    nprobe: int = 32


RADIO_STATION = AnnConfig(name="radio-station", n=10_000, d=256,
                          n_clusters=128, top="brute", bottom="brute",
                          nprobe=8)
SIFT_1M = AnnConfig(name="sift-1m", n=1_000_000, d=128, n_clusters=8192,
                    top="pq", bottom="brute", nprobe=32)
DEEP_10M = AnnConfig(name="deep-10m", n=10_000_000, d=96, n_clusters=32768,
                     top="pq", bottom="brute", nprobe=32)
