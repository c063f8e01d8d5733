"""Where the host time of one observed id goes, on the card.

A served cache hit calls ``OnlineLikelihoodEstimator.observe`` with one
id: the estimator filters it, ``CountMinSketch.prepare`` pads it and
computes the decay, and under the estimator's lock ``CountMinSketch.apply``
makes the sketch's stream current and calls ``count_min.count_min_update``,
which checks its operands, allocates the new table, the heavy hitters and
the scratch in one block and launches ``csrc/count_min.cu``.  This times
each layer of that ladder on its own, innermost first, each over
``--calls`` calls on the host clock with a synchronise before and after:

* ``launch``: the C launcher alone, on preallocated outputs;
* ``empty``: the one allocation and its three views;
* ``stream_ctx`` / ``device_ctx``: entering and leaving
  ``torch.cuda.stream`` / ``torch.cuda.device``;
* ``wrapper``: ``count_min.count_min_update``;
* ``apply``: ``CountMinSketch.apply`` of a prepared batch;
* ``update``: ``CountMinSketch.update`` (``prepare`` and ``apply``);
* ``observe``: ``OnlineLikelihoodEstimator.observe``.

The ladder runs ``--rounds`` times (the spread between rounds is the
noise) and prints one JSON line with the card's name and power limit.

    python tools/observe_cost_torch.py            # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.adaptive import OnlineLikelihoodEstimator  # noqa: E402
from repro_torch.kernels import count_min  # noqa: E402


def _us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(calls):
        fn(j)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def ladder(est, ids, calls: int) -> dict:
    sk = est.sketch
    dev = sk.device
    with sk._on_stream():
        table, hh = sk.snapshot(), sk._hh_ids
    torch.cuda.current_stream(dev).wait_stream(sk._stream)
    depth, width = table.shape
    topk = hh.shape[0]
    x = np.zeros(1, np.int32)
    w = np.ones(1, np.float32)
    flat = torch.empty((depth * width + 2 * topk + depth + 2 * (topk + 1),),
                       dtype=torch.float32, device=dev)
    fn = count_min._launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = flat.data_ptr() + 4 * (depth * width + 2 * topk)

    def launch(j):
        fn(table.data_ptr(), sk._a.data_ptr(), sk._b.data_ptr(),
           hh.data_ptr(), x.ctypes.data, w.ctypes.data, None,
           flat.data_ptr(), flat.data_ptr() + 4 * (depth * width + topk),
           flat.data_ptr() + 4 * depth * width, scratch, depth,
           width.bit_length() - 1, topk, 1, 1.0, stream)

    def empty(j):
        f = torch.empty(flat.shape, dtype=torch.float32, device=dev)
        f[:depth * width].view(depth, width)
        f[depth * width:depth * width + topk]
        f[depth * width + topk:depth * width + 2 * topk].view(torch.int32)

    def ctx(make):
        def run(j):
            with make():
                pass
        return run

    batch = sk.prepare(ids[:1])
    out = {
        "launch": _us(launch, calls),
        "empty": _us(empty, calls),
        "stream_ctx": _us(ctx(lambda: torch.cuda.stream(sk._stream)), calls),
        "device_ctx": _us(ctx(lambda: torch.cuda.device(dev)), calls),
        "wrapper": _us(lambda j: count_min.count_min_update(
            table, sk._a, sk._b, hh, ids[j:j + 1], w, 1.0), calls),
        "apply": _us(lambda j: sk.apply(batch), calls),
        "update": _us(lambda j: sk.update(ids[j:j + 1]), calls),
        "observe": _us(lambda j: est.observe(ids[j:j + 1]), calls),
    }
    return {k: round(v, 2) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="entities (the sift-1m corpus)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    est = OnlineLikelihoodEstimator(args.n, width=4096, halflife=4096.0)
    ids = np.random.default_rng(0).integers(0, args.n, args.calls)
    for j in range(64):                        # build, load, warm up
        est.observe(ids[j:j + 1])
    rounds = [ladder(est, ids, args.calls) for _ in range(args.rounds)]
    print(json.dumps({"card": smi, "calls": args.calls,
                      "us_a_call": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
