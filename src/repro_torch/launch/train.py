"""Training launcher, on the card: the port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 100 --reduced [--device cpu]

With ``--reduced`` (the default) the arch's same-family reduced config
trains for real.  Each family is bound as the reference binds it: an LM
on ``LMStream`` batches, a recsys model on ``batch_for`` batches, SchNet
(``d_feat`` 32, 8 classes) on one fixed 2,000-node graph.  AdamW with
``warmup_cosine(3e-4, 20, steps)``, gradient clipping at 1.0, the
watchdog, and checkpoints in ``--ckpt-dir`` (``--resume`` restores the
latest committed step) come from ``repro_torch.train``.  Runs on the card
unless ``--device cpu``.  ``main`` returns the ``TrainResult``.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve
    from repro_torch.models.base import count_params
    from repro_torch.train import checkpoint as C
    from repro_torch.train import optim
    from repro_torch.train.fault import Watchdog
    from repro_torch.train.loop import init_state, make_train_step, train

    dev = resolve(args.device)
    cfg, family = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    if family == "lm":
        from repro_torch.data.lm import LMStream
        from repro_torch.models import transformer as M

        params = M.init(cfg, seed=0, device=dev)
        batch_at = LMStream(cfg.vocab, args.seq, args.batch, seed=0).batch_at
    elif family == "recsys":
        from repro_torch.data.recsys import batch_for
        from repro_torch.models import recsys as M

        params = M.init(cfg, seed=0, device=dev)

        def batch_at(step):
            return batch_for(cfg, args.batch, step)
    elif family == "gnn":
        from repro_torch.data.graph import make_graph
        from repro_torch.models import schnet as M

        cfg = dataclasses.replace(cfg, d_feat=32, n_out=8)
        params = M.init(cfg, seed=0, device=dev)
        g = make_graph(2000, 10000, 32, n_classes=8, seed=0)
        snd, rcv = g.edge_list()
        fixed = {"feats": g.feats, "pos": g.pos, "senders": snd,
                 "receivers": rcv, "labels": g.labels}

        def batch_at(step):
            return fixed
    else:
        raise SystemExit(f"train launcher does not apply to family "
                         f"{family!r} (ANN corpora are built, not trained)")

    def loss(p, b):
        return M.loss_fn(p, b, cfg)

    print(f"{args.arch} ({'reduced' if args.reduced else 'full'}): "
          f"{count_params(params) / 1e6:.2f}M params on {dev}")
    opt = optim.adamw(optim.warmup_cosine(3e-4, 20, args.steps))
    state = init_state(params, opt)
    if args.resume and args.ckpt_dir:
        last = C.latest_step(args.ckpt_dir)
        if last is not None:
            state = C.restore(args.ckpt_dir, last, state)
            print(f"resumed from step {last}")
    wd = Watchdog()
    res = train(state, make_train_step(loss, opt), batch_at, args.steps,
                log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                watchdog=wd)
    for h in res.history:
        print("  ", h)
    print(f"stragglers: {len(wd.events)}")
    return res


if __name__ == "__main__":
    main()
