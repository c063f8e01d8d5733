"""dcn-v2 [recsys] n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512 interaction=cross  [arXiv:2008.13535; paper]"""
from repro_torch.configs.base import DCNConfig

CONFIG = DCNConfig(name="dcn-v2")
FAMILY = "recsys"
