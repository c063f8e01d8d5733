"""din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn  [arXiv:1706.06978; paper]"""
from repro_torch.configs.base import DINConfig

CONFIG = DINConfig(
    name="din",
    n_items=1_000_000,       # Alibaba-scale item vocabulary
    n_cates=10_000,
    embed_dim=18,
    seq_len=100,
    attn_mlp=(80, 40),
    mlp=(200, 80),
)
FAMILY = "recsys"
