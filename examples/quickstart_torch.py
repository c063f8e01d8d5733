"""Quickstart on the PyTorch port: the paper's protocol end to end (the
counterpart of ``examples/quickstart.py``, with its data and settings).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device`` names another device.  A 10K
catalog with known traffic is below the §5.3 threshold, so the protocol
picks QLBT and the search is its beam descent; the exact top-10 comes
from the brute scan (``l2_topk``'s hand-written kernel on the card, its
plain version on the CPU).
"""
import argparse

import numpy as np

from repro_torch.core.brute import brute_search
from repro_torch.core.index import auto_build_index
from repro_torch.core.likelihood import sample_queries, simulate_beta_likelihood
from repro_torch.core.metrics import recall_at_k
from repro_torch.device import resolve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    rng = np.random.default_rng(0)

    # 1. an entity catalog (10K radio-station-like embeddings)
    centers = rng.normal(size=(64, 128)).astype(np.float32) * 4
    db = (centers[rng.integers(0, 64, 10_000)]
          + rng.normal(size=(10_000, 128))).astype(np.float32)

    # 2. skewed query traffic (paper §4.2)
    p = simulate_beta_likelihood(rng, 10_000, 0.1, 8.0)

    # 3. §5.3 protocol: <30K entities + traffic known -> QLBT
    index = auto_build_index(db, p=p, device=dev)
    print(f"protocol chose: {index.spec.kind} — {index.spec.reason}")

    # 4. search
    queries, truth = sample_queries(rng, db, p, 256, noise_scale=0.05)
    dists, ids, work = index.search(queries, k=10, beam_width=16)
    print(f"recall@10 = {recall_at_k(ids, truth):.3f}")
    print(f"mean work/query = "
          f"{(work['internal_visits'] + work['candidates']) / 256:.0f} "
          f"distance evals (vs {db.shape[0]} brute-force)")

    # 5. sanity: exact search agrees
    _, exact = brute_search(queries, db, 10, device=dev)
    print(f"recall@10 vs exact-NN = {recall_at_k(ids, exact):.3f}")
    return {"kind": index.spec.kind, "dists": dists, "ids": ids,
            "exact": exact}


if __name__ == "__main__":
    main()
