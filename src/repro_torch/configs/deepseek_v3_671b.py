"""deepseek-v3-671b [moe] 61L d_model=7168 128H d_ff=2048(experts)
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]

First 3 layers are dense FFN (d_ff=18432); MLA dims per the V3 report.
Trains with bf16 params + Adafactor so optimizer state fits 16 GB/chip on
the 256/512-chip meshes (DESIGN.md §4).
"""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: per-head latent KV (cache is shared)
    d_head=128,
    d_ff=18432,              # dense (first-3) layers
    vocab=129280,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  n_experts_padded=256, capacity_factor=1.25,
                  routed_scaling=2.5, score_fn="sigmoid"),
    n_dense_layers=3,
    mtp=True,
    rope_theta=1e4,
    param_dtype="bfloat16",
    attn_shard="heads",      # 128 % 16 == 0
    grad_accum=4,            # microbatching: activation memory /4
    residual_dtype="bfloat16",  # halves TP all-reduce + carry bytes (§Perf)
)
FAMILY = "lm"
