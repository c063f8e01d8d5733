"""schnet [gnn] n_interactions=3 d_hidden=64 rbf=300 cutoff=10
[arXiv:1706.08566; paper]"""
from repro_torch.configs.base import SchNetConfig

CONFIG = SchNetConfig(
    name="schnet",
    n_interactions=3,
    d_hidden=64,
    n_rbf=300,
    cutoff=10.0,
)
FAMILY = "gnn"
