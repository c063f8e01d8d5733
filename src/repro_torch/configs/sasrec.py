"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq  [arXiv:1808.09781; paper]"""
from repro_torch.configs.base import SASRecConfig

CONFIG = SASRecConfig(
    name="sasrec",
    n_items=1_000_000,       # retrieval_cand scores 1M candidates
    embed_dim=50,
    n_blocks=2,
    n_heads=1,
    seq_len=50,
)
FAMILY = "recsys"
