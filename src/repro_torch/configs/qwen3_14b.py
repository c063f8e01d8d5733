"""qwen3-14b [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    mlp_kind="swiglu",
    rope_theta=1e6,
    # 40 heads % 16 mesh != 0 -> sequence-sharded attention (DESIGN.md §4)
    attn_shard="seq",
    residual_dtype="bfloat16",  # halves TP all-reduce + carry bytes (§Perf)
)
FAMILY = "lm"
