"""Time the port's one-card LM decode step, for comparing two source trees.

qwen3-0.6b at full width and depth in bf16 (seed 0) prefills 2 x 4,096
random tokens, takes 8 warm-up steps, then 64 greedy decode steps, each
timed with CUDA events.  Prints one line ``AB {"label", "mean_ms",
"p50_ms", "min_ms"}``.  The step is host-bound, so compare two trees
only within one machine's run, alternating them:

    for s in P C C P; do
      d=$([ $s = P ] && echo parent/src || echo src)
      python3 tools/decode_ab_torch.py --src $d --label $s
    done
"""
from __future__ import annotations

import argparse
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src",
                    help="the source tree holding repro_torch")
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch("qwen3-0.6b")[0]
    dev = torch.device("cuda", 0)
    params = {k: ({a: b.to(torch.bfloat16) for a, b in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in T.init(cfg, seed=0, device=dev).items()}
    gen = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 4096), generator=gen).to(dev)
    warm = 8
    ms = []
    with torch.no_grad():
        lg, cache = T.prefill(params, toks, cfg,
                              max_len=4096 + args.steps + warm)
        nxt = lg.argmax(-1, keepdim=True)
        for i in range(warm + args.steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            lg, cache = T.decode_step(params, cache, nxt, cfg)
            nxt = lg.argmax(-1, keepdim=True)
            b.record()
            b.synchronize()
            if i >= warm:
                ms.append(a.elapsed_time(b))
    ms.sort()
    print("AB", json.dumps({"label": args.label,
                            "mean_ms": sum(ms) / len(ms),
                            "p50_ms": ms[len(ms) // 2], "min_ms": ms[0]}))


if __name__ == "__main__":
    main()
