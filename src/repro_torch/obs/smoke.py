"""Observability smoke check, the counterpart of ``tools/obs_smoke.py``:
drive a short workload through the port's fleet, then assert that the
telemetry surfaces are live -- the metrics snapshot serialises to JSON
and carries nonzero key series, the Prometheus exposition round-trips
through the parser, and the Chrome-trace export holds the request span
taxonomy.  The trace is written to ``build/obs_trace.json`` at the root
of the checkout (or ``--out``), a Perfetto-loadable file.

    PYTHONPATH=src python -m repro_torch.obs.smoke [--device cpu]

Two IVF cells (``build_fleet``) over a small synthetic index serve the
requests, on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[3] / "build" / "obs_trace.json"
N_REQUESTS = 64
N, D, K = 512, 16, 8
# the stage series every routed request must feed (router + per cell +
# per cell backend)
KEY_SERIES = ("latency_ms", "queue_ms", "batch_ms", "dispatch_ms",
              "kernel_ms")
SPANS = {"route", "admission", "queue", "batch", "dispatch", "kernel",
         "rerank"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.smoke")
    ap.add_argument("--device", default=None,
                    help="torch device of the cells (default: the card)")
    ap.add_argument("--out", default=str(OUT),
                    help="where the Chrome trace is written")
    args = ap.parse_args(argv)

    from repro_torch.core.two_level import TwoLevelConfig, build_two_level
    from repro_torch.obs import Tracer, parse_exposition, set_tracer
    from repro_torch.serve.fleet import build_fleet

    rng = np.random.default_rng(0)
    db = rng.normal(size=(N, D)).astype(np.float32)
    idx = build_two_level(db, TwoLevelConfig(
        n_clusters=K, kmeans_iters=2, kmeans_minibatch=None),
        device=args.device)
    tracer = Tracer(capacity=8192)
    prev = set_tracer(tracer)
    router = build_fleet([args.device] * 2, idx, k=5,
                         backend_kw={"nprobe_local": 2},
                         cell_kw={"max_wait_ms": 0.5})
    try:
        for _ in range(N_REQUESTS):
            router.search(rng.normal(size=(D,)).astype(np.float32),
                          timeout=30.0)
        st = router.stats()

        # 1. snapshot parses as JSON and the key series are nonzero
        snap = json.loads(json.dumps(router.metrics_snapshot()))
        for series in KEY_SERIES:
            keys = [k for k in snap if k.endswith(series)]
            total = sum(snap[k].get("count", 0) for k in keys)
            if not (keys and total > 0):
                raise AssertionError(
                    f"key series {series!r} is missing or empty: {keys}")
        route = [k for k in snap if k.endswith("route_ms")]
        if not (route and snap[route[0]]["count"] == N_REQUESTS):
            raise AssertionError(f"route_ms does not count {N_REQUESTS}")

        # 2. exposition round-trips through the scrape-side parser
        back = parse_exposition(router.exposition())
        if not any(v.get("type") == "histogram" and v.get("count")
                   for v in back.values()):
            raise AssertionError("no live histogram scraped")

        # 3. the trace export carries the request span taxonomy
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        tracer.export(args.out)
        with open(args.out, encoding="utf-8") as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        if not SPANS <= names:
            raise AssertionError(f"trace missing spans: {SPANS - names}")
        if not (st.n == N_REQUESTS and st.stages["queue"]["n"] > 0):
            raise AssertionError(f"stats count {st.n} requests")
    finally:
        set_tracer(prev)
        router.close()
    print(f"obs smoke OK: {N_REQUESTS} requests, "
          f"{len(tracer.events())} trace events -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
