"""Serving launcher for the paper's ANN corpora, on the card.

Port of ``repro/launch/serve.py``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch sift-1m \
      --scale 0.05 --n-requests 256 [--device cpu]

Builds the arch's configured two-level index (``configs/ann_corpora.py``)
over a synthetic corpus at ``--scale`` of the paper size and serves
single-query requests through the micro-batching engine, reporting recall
and latency percentiles against the paper's bar (P90 < 80 ms, recall@10
> 0.8).  Before that summary it prints the search function's first calls:
``compile_signatures`` (distinct batch shapes) and ``first_call_ms`` (the
time of each shape's first call, which pays the one-time costs) beside
the later calls' p50, since all requests are submitted at once and the
first batch's one-time costs land in every request's latency.  Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

ARCHS = ("radio-station", "sift-1m", "deep-10m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sift-1m", choices=ARCHS)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--n-requests", type=int, default=256)
    ap.add_argument("--nprobe", type=int, default=None)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs.ann_corpora import (DEEP_10M, RADIO_STATION,
                                                 SIFT_1M)
    from repro_torch.core.brute import brute_search
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.core.two_level import TwoLevelConfig, build_two_level
    from repro_torch.data.synthetic import make_corpus, make_queries
    from repro_torch.device import resolve
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve.engine import ServingEngine

    dev = resolve(args.device)
    cfg = {"radio-station": RADIO_STATION, "sift-1m": SIFT_1M,
           "deep-10m": DEEP_10M}[args.arch]
    name = {"radio-station": "radio_station", "sift-1m": "sift",
            "deep-10m": "deep"}[args.arch]
    db = np.asarray(make_corpus(name, scale=args.scale, seed=0))
    n = db.shape[0]
    n_clusters = max(16, int(cfg.n_clusters * min(1.0, args.scale * 2)))
    print(f"{args.arch}: corpus {n} x {db.shape[1]}, "
          f"{n_clusters} buckets, top={cfg.top} bottom={cfg.bottom}")
    t0 = time.time()
    idx = build_two_level(db, TwoLevelConfig(
        n_clusters=n_clusters, top=cfg.top, bottom=cfg.bottom,
        kmeans_iters=6, kmeans_minibatch=min(131072, n)), device=dev)
    print(f"built in {time.time() - t0:.1f}s")

    nprobe = args.nprobe or cfg.nprobe

    metrics = MetricsRegistry()
    seen: set = set()

    def search_fn(qs):
        # called by the engine's one batch worker: no lock for ``seen``
        t0 = time.perf_counter()
        d, i, _ = idx.search(qs, args.k, nprobe=nprobe)
        ms = (time.perf_counter() - t0) * 1e3
        sig = (tuple(qs.shape), str(qs.dtype))
        if sig in seen:
            metrics.histogram("later_call_ms").observe(ms)
        else:
            seen.add(sig)
            metrics.counter("compile_signatures").inc()
            metrics.histogram("first_call_ms", lo=1e-2,
                              hi=1e7).observe(ms)
        return d, i

    eng = ServingEngine(search_fn, max_batch=64, max_wait_ms=3.0)
    q = make_queries(db, args.n_requests, seed=1)
    futs = [eng.submit(q[j]) for j in range(args.n_requests)]
    outs = [f.get(timeout=300) for f in futs]
    st = eng.stats()
    eng.close()
    ids = np.stack([o[1] for o in outs])
    _, gt = brute_search(q, db, args.k, device=dev)
    r = recall_at_k(ids, gt)
    first = metrics.histogram("first_call_ms", lo=1e-2, hi=1e7)
    later = metrics.histogram("later_call_ms")
    print(f"first calls: compile_signatures "
          f"{metrics.counter('compile_signatures').value} first_call_ms "
          f"n {first.count} sum {first.sum:.1f}; "
          f"later calls {later.count} p50 {later.quantile(0.5):.1f}ms")
    print(f"recall@{args.k} = {r:.3f}  "
          f"p50={st.p50_ms:.1f}ms p90={st.p90_ms:.1f}ms "
          f"p99={st.p99_ms:.1f}ms")
    print(f"paper bars: recall>0.8 {'PASS' if r > 0.8 else 'FAIL'}; "
          f"P90<80ms {'PASS' if st.p90_ms < 80 else 'FAIL'}")
    return {"recall": r, "p50_ms": st.p50_ms, "p90_ms": st.p90_ms,
            "p99_ms": st.p99_ms, "n": n, "n_clusters": n_clusters,
            "compile_signatures": metrics.counter("compile_signatures").value,
            "first_call_ms_sum": first.sum,
            "later_call_ms_p50": later.quantile(0.5)}


if __name__ == "__main__":
    main()
