"""Train a small LM end to end on the card with the port's substrate:
AdamW, gradient clipping, checkpointing, the watchdog, deterministic
restart -- the PyTorch counterpart of ``examples/train_lm.py``.  (~25M
params by default; use --layers/--d-model to scale toward 100M.)

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.base import LMConfig
from repro_torch.data.lm import LMStream
from repro_torch.device import resolve
from repro_torch.models import transformer as T
from repro_torch.models.base import count_params
from repro_torch.train import optim
from repro_torch.train.fault import Watchdog
from repro_torch.train.loop import init_state, make_train_step, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = LMConfig(
        name="tiny", n_layers=args.layers, d_model=args.d_model,
        n_heads=max(4, args.d_model // 64), n_kv_heads=2,
        d_head=64, d_ff=4 * args.d_model, vocab=8192, qk_norm=True,
        remat=False,
    )
    params = T.init(cfg, seed=0, device=dev)
    print(f"model: {count_params(params) / 1e6:.1f}M params on {dev}")

    opt = optim.adamw(optim.warmup_cosine(3e-4, 20, args.steps))
    state = init_state(params, opt)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    stream = LMStream(cfg.vocab, args.seq, args.batch, seed=0)
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "repro_torch_lm_ckpt")
    wd = Watchdog()
    res = train(state, step, stream.batch_at, args.steps, log_every=20,
                ckpt_dir=ckpt, ckpt_every=100, watchdog=wd)
    for h in res.history:
        print(f"step {h['step']:4d}  loss {h['loss']:.3f}  "
              f"acc {h['accuracy']:.3f}  gnorm {h['grad_norm']:.2f}")
    print(f"mean step time: {np.mean(res.step_times[5:]) * 1e3:.0f} ms; "
          f"stragglers flagged: {len(wd.events)}; checkpoints in {ckpt}")
    return res


if __name__ == "__main__":
    main()
