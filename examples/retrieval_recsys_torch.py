"""Recsys retrieval with the paper's index (DESIGN.md §5), on the PyTorch
port: a SASRec user tower scores its candidates — exact dot-product top-k
vs the two-level ANN index over the item embeddings (the counterpart of
``examples/retrieval_recsys.py``, with its settings: SASRec reduced to
100,000 items at d 32, 512 clusters, brute top and bottom, nprobe 64).

  PYTHONPATH=src python examples/retrieval_recsys_torch.py [--device cpu]
      [--n-items N] [--seed S]

Runs on the card unless ``--device`` names another device.  The two-level
index's brute bottom is the probe chain (``candidate_topk``'s hand-written
kernel on the card; its plain version on the CPU), over the items
augmented to d + 1 (MIPS -> L2).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.two_level import TwoLevelConfig, build_two_level
from repro_torch.data.recsys import sasrec_batch
from repro_torch.device import resolve
from repro_torch.kernels.common import stable_topk
from repro_torch.models import recsys as R

N_USERS = 8
K = 10


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--n-items", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg, _ = get_arch("sasrec")
    cfg = dataclasses.replace(cfg.reduced(), n_items=args.n_items,
                              embed_dim=32)
    params = R.init(cfg, seed=args.seed, device=dev)
    print(f"SASRec items={cfg.n_items} d={cfg.embed_dim} on {dev}")

    batch = sasrec_batch(cfg, N_USERS, step=0)
    with torch.no_grad():
        user_t = R.user_vectors(params, batch["seq"], cfg)    # (8, d) users
    items_t = params["item_table"][: cfg.n_items]
    user, items = user_t.cpu().numpy(), items_t.cpu().numpy()
    # MIPS -> L2 reduction: items gain sqrt(M^2 - ||v||^2), users 0
    aug_items, aug_user, _ = R.mips_augment(items, user)

    _sync(dev)
    t0 = time.perf_counter()
    _, exact = stable_topk(-(user_t @ items_t.T), K)
    exact_top = exact.cpu().numpy()
    t_exact = time.perf_counter() - t0

    # MIPS over IVF needs wider probing than plain L2 (inner-product mass
    # spreads across buckets when item norms are near-uniform)
    cfgi = TwoLevelConfig(n_clusters=512, top="brute", bottom="brute",
                          kmeans_iters=8, kmeans_minibatch=50_000)
    t0 = time.perf_counter()
    index = build_two_level(aug_items, cfgi, device=dev)
    _sync(dev)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, ann_top, work = index.search(aug_user, K, nprobe=64)
    t_ann = time.perf_counter() - t0

    r = recall_at_k(ann_top, exact_top)
    print(f"exact scoring: {t_exact * 1e3:.0f} ms for {N_USERS} users")
    print(f"two-level ANN: build {t_build:.1f}s, query {t_ann * 1e3:.0f} ms, "
          f"recall@10 vs exact = {r:.3f}, "
          f"candidates/query = {work['candidates'] / N_USERS:.0f} "
          f"(vs {cfg.n_items} exact)")


if __name__ == "__main__":
    main()
