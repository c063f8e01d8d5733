"""granite-34b [dense] 88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code  [arXiv:2405.04324; hf]

Granite-34B-Code is MQA (kv=1) with a 2-matrix GELU MLP — with a gated
3-matrix MLP the listed dims would give ~46B params, with GELU they give
~34B, matching the model card.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    qk_norm=False,
    mlp_kind="gelu",
    rope_theta=1e5,
    attn_shard="heads",      # 48 % 16 == 0
    grad_accum=2,            # 88-layer carry stack: activation memory /2
    residual_dtype="bfloat16",  # halves TP all-reduce + carry bytes (§Perf)
)
FAMILY = "lm"
