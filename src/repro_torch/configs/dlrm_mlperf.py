"""dlrm-mlperf [recsys] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot —
MLPerf DLRM benchmark config (Criteo 1TB)  [arXiv:1906.00091; paper]"""
from repro_torch.configs.base import DLRMConfig

CONFIG = DLRMConfig(name="dlrm-mlperf")
FAMILY = "recsys"
