"""Config dataclasses for every architecture family: the port's own copy
of ``repro/configs/base.py``, field for field, defaults included.

The configs are shapes only; no weights are loaded (both packages
initialise from a seed).  Every arch also defines ``reduced()``: a
same-family shrink for CPU tests (few layers, tiny tables and graphs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "MoEConfig", "MLAConfig", "LMConfig", "SchNetConfig",
    "DLRMConfig", "DCNConfig", "DINConfig", "SASRecConfig",
    "AnnConfig", "ShapeSpec",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (name + kind + dims)."""
    name: str
    kind: str            # train | prefill | decode | serve | retrieval | ...
    dims: dict

    def __getitem__(self, k):
        return self.dims[k]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert intermediate
    n_shared: int = 1
    n_experts_padded: int = 0       # 0 = no padding; launcher may pad for EP
    capacity_factor: float = 1.25
    routed_scaling: float = 2.5     # DeepSeek-V3 gate scale
    score_fn: str = "sigmoid"       # sigmoid (V3) | softmax (classic)

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn_kind: str = "gqa"          # gqa | mla
    qk_norm: bool = False
    mlp_kind: str = "swiglu"        # swiglu | gelu
    rope_theta: float = 1e6
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0         # leading dense layers in MoE models
    mla: Optional[MLAConfig] = None
    mtp: bool = False               # DeepSeek-V3 multi-token prediction
    tie_embeddings: bool = False
    param_dtype: str = "float32"    # giants use bfloat16 (DESIGN.md §4)
    # --- distribution knobs (overridden by the launcher per mesh) ---
    attn_shard: str = "heads"       # heads | seq (when n_heads % tp != 0)
    moe_groups: int = 1             # data-parallel dispatch groups
    attn_chunk: int = 0             # 0 = dense; else KV block size
    scan_layers: bool = True
    remat: bool = True
    residual_dtype: str = "float32"  # bfloat16 halves TP all-reduce bytes
    #                                  + scan-carry memory (§Perf lever)
    grad_accum: int = 1             # microbatches per step (activation
    #                                 memory / accum; giants use 4)

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.moe else 0

    def reduced(self) -> "LMConfig":
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=8, n_experts_padded=8, top_k=2, d_ff=64,
            )
        return dataclasses.replace(
            self, n_layers=2 if not self.moe else 3, d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16, d_ff=128, vocab=512, moe=moe, n_dense_layers=1
            if self.moe else 0,
            mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                          qk_nope_head_dim=16, qk_rope_head_dim=8,
                          v_head_dim=16) if self.mla else None,
            param_dtype="float32", moe_groups=1, attn_chunk=0,
        )


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat: int = 128               # input node-feature dim (shape-specific)
    n_out: int = 1                  # regression targets or classes
    message_dtype: str = "float32"  # bfloat16 halves the per-interaction
    #                                 node-aggregate all-reduce (§Perf)

    def reduced(self) -> "SchNetConfig":
        return dataclasses.replace(self, n_interactions=2, d_hidden=32,
                                   n_rbf=16)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    # MLPerf Criteo-Terabyte per-table row counts (26 tables)
    table_sizes: tuple = (
        39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
        2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
        25641295, 39664984, 585935, 12972, 108, 36,
    )
    interaction: str = "dot"

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    def reduced(self) -> "DLRMConfig":
        return dataclasses.replace(
            self, embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16, 1),
            table_sizes=tuple([100, 50, 200, 30]),
        )


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    table_sizes: tuple = (
        39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
        2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
        25641295, 39664984, 585935, 12972, 108, 36,
    )
    interaction: str = "cross"

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    def reduced(self) -> "DCNConfig":
        return dataclasses.replace(
            self, embed_dim=8, n_cross_layers=2, mlp=(32, 16),
            table_sizes=tuple([100, 50, 200, 30]),
        )


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_cates: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    interaction: str = "target-attn"

    def reduced(self) -> "DINConfig":
        return dataclasses.replace(self, n_items=1000, n_cates=50,
                                   embed_dim=8, seq_len=10)


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    interaction: str = "self-attn-seq"

    def reduced(self) -> "SASRecConfig":
        return dataclasses.replace(self, n_items=1000, embed_dim=16,
                                   seq_len=8)


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """The paper's own serving configs (radio/sift/deep)."""
    name: str
    n: int
    d: int
    n_clusters: int
    top: str = "pq"
    bottom: str = "brute"
    nprobe: int = 32

    def reduced(self) -> "AnnConfig":
        return dataclasses.replace(self, n=2000, n_clusters=32)
