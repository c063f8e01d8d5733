"""Architecture + shape registry: ``--arch <id> --shape <name>``; the
port's copy of ``repro/configs/registry.py``.

40 assigned cells = 10 archs x their family's 4 shapes.  ``long_500k`` is a
*listed skip* for the five full-attention LM archs (DESIGN.md §5).  The
paper's own ANN corpora are registered additionally under family "ann".
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ShapeSpec

_ARCH_MODULES = {
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2",
    "schnet": "repro_torch.configs.schnet",
    "din": "repro_torch.configs.din",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "sasrec": "repro_torch.configs.sasrec",
    "dcn-v2": "repro_torch.configs.dcn_v2",
}

_ANN_ARCHS = {"radio-station": "RADIO_STATION", "sift-1m": "SIFT_1M",
              "deep-10m": "DEEP_10M"}

ARCHS = tuple(_ARCH_MODULES) + tuple(_ANN_ARCHS)

SHAPES = {
    "lm": [
        ShapeSpec("train_4k", "train", dict(seq=4096, batch=256)),
        ShapeSpec("prefill_32k", "prefill", dict(seq=32768, batch=32)),
        ShapeSpec("decode_32k", "decode", dict(seq=32768, batch=128)),
        # needs sub-quadratic attention; all 5 LM archs are full softmax
        # attention -> listed skip (DESIGN.md §5)
        ShapeSpec("long_500k", "decode",
                  dict(seq=524288, batch=1, subquadratic_required=True)),
    ],
    "gnn": [
        ShapeSpec("full_graph_sm", "train",
                  dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
        ShapeSpec("minibatch_lg", "train",
                  dict(n_nodes=232965, n_edges=114615892,
                       batch_nodes=1024, fanout=(15, 10), d_feat=602)),
        ShapeSpec("ogb_products", "train",
                  dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
        ShapeSpec("molecule", "train",
                  dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
    ],
    "recsys": [
        ShapeSpec("train_batch", "train", dict(batch=65536)),
        ShapeSpec("serve_p99", "serve", dict(batch=512)),
        ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        ShapeSpec("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1_000_000)),
    ],
    "ann": [
        ShapeSpec("serve_edge", "serve", dict(batch=16, k=10)),
        ShapeSpec("serve_batch", "serve", dict(batch=1024, k=10)),
        ShapeSpec("serve_bulk", "serve", dict(batch=16384, k=10)),
    ],
}


def get_arch(arch_id: str):
    """Returns (config, family) for an arch id."""
    if arch_id in _ANN_ARCHS:
        mod = importlib.import_module("repro_torch.configs.ann_corpora")
        return getattr(mod, _ANN_ARCHS[arch_id]), "ann"
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}"
        )
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.CONFIG, mod.FAMILY


def get_shapes(family: str):
    return SHAPES[family]


def get_shape(family: str, name: str) -> ShapeSpec:
    for s in SHAPES[family]:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r} for family {family!r}")


def iter_cells(include_ann: bool = False):
    """Yield (arch_id, config, family, ShapeSpec) for every assigned cell."""
    for arch_id in _ARCH_MODULES:
        cfg, family = get_arch(arch_id)
        for shape in SHAPES[family]:
            yield arch_id, cfg, family, shape
    if include_ann:
        for arch_id in _ANN_ARCHS:
            cfg, family = get_arch(arch_id)
            for shape in SHAPES[family]:
                yield arch_id, cfg, family, shape
