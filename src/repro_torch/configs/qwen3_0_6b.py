"""qwen3-0.6b [dense] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,              # qwen3 family uses head_dim 128 (q: 1024->2048)
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    mlp_kind="swiglu",
    rope_theta=1e6,
    tie_embeddings=True,     # qwen3-0.6b ties embed/unembed
    attn_shard="heads",      # 16 % 16 == 0
)
FAMILY = "lm"
