"""End-to-end serving on the PyTorch port (the counterpart of
``examples/edge_serving.py``, with its defaults): build the index the
§5.3 protocol picks over a catalog and serve batched requests through
the micro-batching ``ServingEngine`` with latency tracking and a hedged
replica.

  PYTHONPATH=src python examples/edge_serving_torch.py [--n 200000]
      [--qps 500] [--device cpu]

Runs on the card unless ``--device`` names another device.  From 30K
entities the protocol picks the paper's two-level index, PQ top and
brute bottom: the PQ top scores the centroid codes with ``pq_adc_topk``
and the brute bottom scans the probed buckets with the probe chain
(``candidate_topk``), each a hand-written kernel on the card and its
plain version on the CPU.  Below 30K it picks the balanced tree.
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.core.brute import brute_search
from repro_torch.core.index import auto_build_index
from repro_torch.core.metrics import recall_at_k
from repro_torch.data.synthetic import make_corpus, make_queries
from repro_torch.device import resolve
from repro_torch.serve.engine import ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--n-requests", type=int, default=512)
    ap.add_argument("--qps", type=float, default=500.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    print(f"building corpus ({args.n} x 128)...")
    db = np.asarray(make_corpus("sift", scale=args.n / 1_000_000, seed=0))
    t0 = time.time()
    index = auto_build_index(db, device=dev)    # §5.3 -> two-level PQ+brute
    print(f"index: {index.spec.kind} ({index.spec.reason}) "
          f"built in {time.time() - t0:.1f}s, "
          f"footprint {index.footprint_bytes(include_db=False) / 2**20:.1f}"
          f" MiB (+vectors)")

    def search_fn(qs):
        d, i, _ = index.search(qs, 10, nprobe=16)
        return d, i

    # replica for hedged requests (same index here; a second host in prod)
    engine = ServingEngine(search_fn, max_batch=64, max_wait_ms=3.0,
                           hedge_fn=search_fn, hedge_ms=250.0)

    queries = make_queries(db, args.n_requests, seed=1)
    print(f"replaying {args.n_requests} requests at ~{args.qps} qps...")
    futs = []

    def submit_all():
        for j in range(args.n_requests):
            futs.append(engine.submit(queries[j]))
            time.sleep(1.0 / args.qps)

    t = threading.Thread(target=submit_all)
    t.start()
    t.join()
    try:
        outs = [f.get(timeout=120) for f in futs]
        stats = engine.stats()
    finally:
        engine.close()

    ids = np.stack([o[1] for o in outs])
    _, gt = brute_search(queries, db, 10, device=dev)
    print(f"recall@10 = {recall_at_k(ids, gt):.3f}")
    print(f"latency: p50={stats.p50_ms:.1f}ms p90={stats.p90_ms:.1f}ms "
          f"p99={stats.p99_ms:.1f}ms (queue {stats.queue_ms:.1f}ms), "
          f"hedges={stats.hedges}")
    print(f"batch sizes (last): {stats.batch_sizes[-8:]}")
    ok = stats.p90_ms < 80.0
    print(f"paper SLO (P90 < 80 ms): {'MET' if ok else 'MISSED'}")
    return {"index": index, "queries": queries,
            "dists": np.stack([o[0] for o in outs]), "ids": ids,
            "stats": stats}


if __name__ == "__main__":
    main()
