"""kimi-k2-1t-a32b [moe] 61L d_model=7168 64H d_ff=2048(experts)
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified]

DeepSeek-V3-style MLA MoE with 64 heads and 384 routed experts; first layer
dense.  384 experts are padded to 512 for 256-way expert parallelism
(DESIGN.md §4 — dummy experts receive no tokens; the FLOP overhead shows up
in the roofline MODEL_FLOPS ratio).
"""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=64,
    d_head=128,
    d_ff=18432,              # dense (first) layer
    vocab=163840,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
                  n_experts_padded=512, capacity_factor=1.25,
                  routed_scaling=2.5, score_fn="sigmoid"),
    n_dense_layers=1,
    mtp=False,
    rope_theta=5e4,
    param_dtype="bfloat16",
    attn_shard="heads",      # 64 % 16 == 0
    grad_accum=4,            # microbatching: activation memory /4
    residual_dtype="bfloat16",  # halves TP all-reduce + carry bytes (§Perf)
)
FAMILY = "lm"
