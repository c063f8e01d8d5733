"""How far one LM step on one device moves under another fp32 summation
order, with ``init``'s weights and with the attention projections at
their true fan-in (``repro_torch.testing.attention_at_true_fan_in``).

granite-34b (no qk-norm) with its depth cut to 2 layers and its widths
cut to ``--d-model`` (d_ff 4x, the vocabulary 8x; its 48 query heads of
width 128 and its one KV head kept; ``--d-model 6144`` is its full
width), fp32 policy, seed 0: a prefill of 2 x ``--seq`` tokens and 4
decode steps, run twice under two summation orders.  ``--device cpu``:
1 against ``--threads`` BLAS threads on the host.  ``--device cuda``:
the card (TF32 off) against the host's BLAS on the same weights and
tokens.  Prints one line a weight scale: each step's largest logit
difference over the logits' largest magnitude, the share of positions
whose argmax agrees, and the std of the first layer's attention scores.

    PYTHONPATH=src python tools/fan_in_conditioning_torch.py
    PYTHONPATH=src python tools/fan_in_conditioning_torch.py \\
        --device cuda --d-model 6144 --seq 512
"""
from __future__ import annotations

import argparse
import dataclasses


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args()
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rms_norm
    from repro_torch.testing import attention_at_true_fan_in

    d, s = args.d_model, args.seq
    cfg = dataclasses.replace(get_arch("granite-34b")[0], n_layers=2,
                              d_model=d, d_ff=4 * d, vocab=8 * d,
                              residual_dtype="float32")
    T.set_precision(torch.float32, torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    toks = torch.as_tensor(LMStream(cfg.vocab, s + 4, 2, seed=2)
                           .batch_at(0)["tokens"])
    if args.device == "cuda":
        orders = (("the host's BLAS", "cpu", None),
                  ("the card", "cuda", None))
    else:
        orders = (("1 thread", "cpu", 1),
                  (f"{args.threads} threads", "cpu", args.threads))

    def to(t, dev):
        return ({k: to(v, dev) for k, v in t.items()}
                if isinstance(t, dict) else t.to(dev))

    def run(p, dev):
        pd = to(p, dev)
        tk = toks.to(dev)
        lg, cache = T.prefill(pd, tk[:, :s], cfg, max_len=s + 4)
        steps = [lg.float().cpu()]
        for i in range(4):
            lg, cache = T.decode_step(pd, cache, tk[:, s + i:s + i + 1], cfg)
            steps.append(lg.float().cpu())
        return steps

    try:
        for scale in ("init", "true fan-in"):
            p = T.init(cfg, seed=0, device="cpu")
            if scale != "init":
                attention_at_true_fan_in(p, cfg)
            lp = {k: v[0] for k, v in p["dense_layers"].items()}
            cos, sin = T._positions(s, cfg, "cpu")
            h = rms_norm(p["embed"][toks[:, :s]], lp["ln1"])
            q = T._gqa_q(h, lp["w_q"], None, cos, sin)
            k, _ = T._gqa_kv(h, lp["w_k"], lp["w_v"], None, cos, sin)
            scores = torch.einsum("bshk,btk->bhst", q, k[:, :, 0]) \
                * cfg.d_head ** -0.5
            runs = []
            for _, dev, n in orders:
                if n is not None:
                    torch.set_num_threads(n)
                runs.append(run(p, dev))
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(*runs)]
            agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                     for a, b in zip(*runs)]
            print(f"granite-34b d_model {d}, {scale} weights: first-layer "
                  f"score std {float(scores.std()):.2f}; logits moved by "
                  f"{orders[0][0]} vs {orders[1][0]} (prefill 2 x {s}, 4 "
                  f"decode steps), of the logits' max: "
                  f"{['%.2e' % e for e in errs]}; argmax agrees "
                  f"{['%.4f' % a for a in agree]}", flush=True)
            del p
    finally:
        T.set_precision()
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
