"""Carry a built index and its sidecars across from the reference.

``index_from_arrays`` builds the port's :class:`TwoLevelIndex` from the
numpy arrays of an index built by the reference package, so both
packages search the *same* buckets, PQ codes, kd tree, LSH codes and
per-bucket trees; ``tree_from_arrays`` does the same for one
:class:`FlatTree` (a one-level index's tree); ``metadata_from_arrays``
and ``lexical_from_arrays`` for the metadata table and the postings
slabs; ``lm_params_from_arrays``, ``recsys_params_from_arrays`` and
``schnet_params_from_arrays`` for a model's parameter tree (one walker,
``_tree_from_arrays``, checks every leaf against the port's
``param_shapes``), and ``train_state_from_arrays`` for a train state
(parameters, optimizer state, error-feedback buffer).  They see numpy
arrays, scalars and a config dict only, never an object of the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LMConfig, SchNetConfig
from repro_torch.core.lexical import LexicalSlabs
from repro_torch.core.lsh import LSHIndex
from repro_torch.core.metadata import MetadataTable
from repro_torch.core.pq import ProductQuantizer
from repro_torch.core.tree import FlatTree
from repro_torch.core.two_level import (TwoLevelConfig, TwoLevelIndex,
                                        check_levels, check_sidecars,
                                        concat_forest, entity_buckets)
from repro_torch.device import resolve
from repro_torch.distributed.sharding import LOCAL_PLAN
from repro_torch.models import recsys, schnet, transformer
from repro_torch.train.compression import make_ef_transform
from repro_torch.train.loop import TrainState
from repro_torch.train.optim import state_specs

__all__ = ["index_from_arrays", "tree_from_arrays", "metadata_from_arrays",
           "lexical_from_arrays", "lm_params_from_arrays",
           "recsys_params_from_arrays", "schnet_params_from_arrays",
           "train_state_from_arrays"]

TREE_ARRAYS = ("proj", "dims", "tau", "children", "leaf_row",
               "leaf_entities", "depth", "entity_depth")


def metadata_from_arrays(columns: dict) -> MetadataTable:
    """``columns``: name -> (N,) integer array."""
    return MetadataTable({name: np.array(col, dtype=np.int32)
                          for name, col in columns.items()})


def lexical_from_arrays(arrays: dict, params: dict) -> LexicalSlabs:
    """``arrays``: ``terms`` (N, S), ``tf_sat`` (N, S), ``idf`` (V,);
    ``params``: the scalars ``k1``, ``b``, ``avg_len``."""
    return LexicalSlabs(
        terms=np.array(arrays["terms"], dtype=np.int32, order="C"),
        tf_sat=np.array(arrays["tf_sat"], dtype=np.float32, order="C"),
        idf=np.array(arrays["idf"], dtype=np.float32),
        k1=float(params["k1"]), b=float(params["b"]),
        avg_len=float(params["avg_len"]))


def tree_from_arrays(arrays: dict) -> FlatTree:
    """``arrays``: ``kind`` ("rp" or "kd") and the :class:`FlatTree`
    tables ``proj``, ``dims``, ``tau``, ``children``, ``leaf_row``,
    ``leaf_entities``, ``depth``, ``entity_depth``."""
    dtypes = {"proj": np.float32, "tau": np.float32}
    return FlatTree(kind=str(arrays["kind"]), **{
        name: np.array(arrays[name], dtype=dtypes.get(name, np.int32),
                       order="C")
        for name in TREE_ARRAYS})


def index_from_arrays(arrays: dict, config: dict, device=None, *,
                      metadata=None, lexical=None) -> TwoLevelIndex:
    """``arrays``: ``db`` (N, d), ``centroids`` (K, d), ``bucket_ids``
    (K, cap) -1 padded, ``bucket_counts`` (K,), and optionally ``alive``
    (N,), ``p`` (N,) and ``part_feats`` (N, pd); per level, as
    ``config["top"]`` / ``config["bottom"]`` need them: ``pq_codebooks``
    (M, 256, ds) and ``pq_codes`` (K, M); ``kd`` (a dict for
    :func:`tree_from_arrays`); ``lsh_proj`` (d, bits) and ``lsh_codes``
    (N, W); ``forest`` (a list of K such dicts, one per bucket, leaf ids
    global).  An index already mid-lifecycle also carries its mutation
    state: ``entity_bucket`` (N,), ``dirty`` (K,), ``base_trees`` (a list
    of K tree dicts, the reboost base) and the counters ``n_adds``,
    ``n_deletes``, ``mutation_version`` (the delta log starts afresh at
    that version, as after a ``pop_delta``).  ``config``: keyword
    arguments of :class:`TwoLevelConfig`.
    ``metadata`` / ``lexical``: the port's sidecars (see the two helpers
    above), one row per corpus row."""
    cfg = TwoLevelConfig(**config)
    check_levels(cfg)
    # the index owns writable copies of its tables
    db = np.array(arrays["db"], dtype=np.float32, order="C")
    bucket_ids = np.array(arrays["bucket_ids"], dtype=np.int32, order="C")
    n, k = db.shape[0], bucket_ids.shape[0]
    check_sidecars(n, metadata, lexical)
    alive = arrays.get("alive")
    p = arrays.get("p")
    part_feats = arrays.get("part_feats")
    eb = arrays.get("entity_bucket")
    dirty = arrays.get("dirty")
    idx = TwoLevelIndex(
        config=cfg, db=db,
        centroids=np.array(arrays["centroids"], dtype=np.float32, order="C"),
        bucket_ids=bucket_ids,
        bucket_counts=np.array(arrays["bucket_counts"], dtype=np.int32),
        alive=(np.ones(n, dtype=bool) if alive is None
               else np.array(alive, dtype=bool)),
        entity_bucket=(entity_buckets(bucket_ids, n) if eb is None
                       else np.array(eb, dtype=np.int32)),
        dirty=(np.zeros(k, dtype=bool) if dirty is None
               else np.array(dirty, dtype=bool)),
        p=None if p is None else np.array(p, dtype=np.float64),
        part_feats=(None if part_feats is None
                    else np.array(part_feats, dtype=np.float32, order="C")),
        n_adds=int(arrays.get("n_adds", 0)),
        n_deletes=int(arrays.get("n_deletes", 0)),
        mutation_version=int(arrays.get("mutation_version", 0)),
        device=resolve(device), metadata=metadata, lexical=lexical)
    if cfg.top == "pq":
        codebooks = np.array(arrays["pq_codebooks"], dtype=np.float32,
                             order="C")
        idx.top_pq = ProductQuantizer(
            codebooks=codebooks,
            codes=np.array(arrays["pq_codes"], dtype=np.uint8, order="C"),
            d=idx.centroids.shape[1])
    elif cfg.top == "kdtree":
        idx.top_kd = tree_from_arrays(arrays["kd"])
    if cfg.bottom == "lsh":
        proj = np.array(arrays["lsh_proj"], dtype=np.float32, order="C")
        idx.bottom_lsh = LSHIndex(
            proj=proj,
            codes=np.array(arrays["lsh_codes"], dtype=np.int32, order="C"),
            n_bits=proj.shape[1])
    elif cfg.bottom in ("tree", "qlbt"):
        idx.forest = concat_forest([tree_from_arrays(t)
                                    for t in arrays["forest"]])
        if arrays.get("base_trees") is not None:
            idx.base_trees = [tree_from_arrays(t)
                              for t in arrays["base_trees"]]
    return idx


def _leaf_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """One leaf on ``device`` in ``dtype``; a bf16 array (``ml_dtypes``'
    type, as JAX hands it over) is carried bit for bit."""
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def _tree_from_arrays(want: dict, tree: dict, dev) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) as
    the port's, walked against ``want`` (the port's ``param_shapes``):
    each leaf checked against its shape and cast to its dtype; a missing,
    extra or misshapen leaf raises ``ValueError``."""
    def walk(want, got, path: str):
        if isinstance(want, dict):
            have = sorted(got) if isinstance(got, dict) else type(got)
            if have != sorted(want):
                raise ValueError(f"{path or '/'}: keys {have} are not the "
                                 f"config's {sorted(want)}")
            return {k: walk(want[k], got[k], f"{path}/{k}") for k in want}
        a = np.asarray(got)
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {a.shape} is not the config's "
                             f"{tuple(want.shape)}")
        return _leaf_tensor(a, want.dtype, dev)

    return walk(want, tree, "")


def _placed(tree, specs, plan):
    """``tree``'s leaves placed over ``plan``'s mesh by ``specs`` (the
    same structure); ``tree`` itself with no plan or no mesh."""
    if plan is None or plan.mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: _placed(v, specs[k], plan) for k, v in tree.items()}
    return plan.place(tree, specs)


def lm_params_from_arrays(tree: dict, cfg, device=None, plan=None) -> dict:
    """The port's parameter tree from the reference's (nested dicts of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``).

    The layout mapping is the identity, leaf for leaf: the port keeps the
    reference's key paths and shapes (``embed`` (V, D), ``unembed``
    (D, V) unless tied, ``final_norm`` (D,); per stack ``dense_layers`` /
    ``moe_layers`` every leaf stacked ``(L, ...)``: ``ln1`` / ``ln2``
    (L, D); GQA ``w_q`` (L, D, H, dh), ``w_k`` / ``w_v`` (L, D, Hkv, dh),
    ``w_o`` (L, H, dh, D), ``q_norm`` / ``k_norm`` (L, dh); MLA ``w_dq``
    (L, D, q_lora), ``q_ln``, ``w_uq`` (L, q_lora, H, nope + rope),
    ``w_dkv`` (L, D, kv_lora), ``kv_ln``, ``w_kr`` (L, D, rope), ``w_uk`` /
    ``w_uv`` (L, kv_lora, H, nope / v), ``w_o`` (L, H, v, D); MLP
    ``w_gate`` / ``w_up`` (L, D, F), ``w_down`` (L, F, D); MoE ``router``
    (L, D, E) and ``router_bias`` (L, E) in fp32, experts ``w_gate`` /
    ``w_up`` (L, E_pad, D, F), ``w_down`` (L, E_pad, F, D), the shared
    expert ``sh_*``; ``mtp``: ``proj`` (2D, D), ``norm_h``, ``norm_e`` and
    one layer stacked ``(1, ...)``).  Each leaf is checked against
    ``transformer.param_shapes(cfg)`` and cast to its dtype; a missing,
    extra or misshapen leaf raises ``ValueError``.  Under ``plan``'s
    bound mesh each leaf is placed by ``transformer.param_specs(cfg,
    plan)`` (every rank passes the whole arrays)."""
    return _placed(_tree_from_arrays(transformer.param_shapes(cfg), tree,
                                     resolve(device)),
                   transformer.param_specs(cfg, plan or LOCAL_PLAN), plan)


def recsys_params_from_arrays(tree: dict, cfg, device=None,
                              plan=None) -> dict:
    """The port's DLRM / DCN-v2 / DIN / SASRec tree from the reference's
    (nested dicts of numpy arrays), the identity leaf for leaf: DLRM
    ``table`` (sum of rows, D), ``bot`` / ``top`` MLPs ``w{i}`` (in, out)
    and ``b{i}``; DCN-v2 ``table``, ``cross_w{i}`` / ``cross_b{i}`` and
    ``mlp``; DIN ``item_table``, ``cate_table``, ``att`` and ``mlp``;
    SASRec ``item_table`` (rows rounded up from n_items + 1), ``pos_table``,
    ``blocks`` (every leaf stacked ``(n_blocks, ...)``) and ``final_ln``.
    Checked against ``recsys.param_shapes(cfg)``; a missing, extra or
    misshapen leaf raises ``ValueError``.  Placed by ``param_specs``
    under ``plan``'s bound mesh."""
    return _placed(_tree_from_arrays(recsys.param_shapes(cfg), tree,
                                     resolve(device)),
                   recsys.param_specs(cfg, plan or LOCAL_PLAN), plan)


def schnet_params_from_arrays(tree: dict, cfg, device=None,
                              plan=None) -> dict:
    """The port's SchNet tree from the reference's, the identity leaf for
    leaf: ``embed_in`` (d_feat, h), ``inter`` (every leaf stacked
    ``(n_interactions, ...)``), ``head_w1`` / ``head_b1`` / ``head_w2``.
    Checked against ``schnet.param_shapes(cfg)``; a missing, extra or
    misshapen leaf raises ``ValueError``.  Placed by ``param_specs``
    under ``plan``'s bound mesh."""
    return _placed(_tree_from_arrays(schnet.param_shapes(cfg), tree,
                                     resolve(device)),
                   schnet.param_specs(cfg, plan or LOCAL_PLAN), plan)


def _model(cfg):
    if isinstance(cfg, LMConfig):
        return transformer
    if isinstance(cfg, SchNetConfig):
        return schnet
    return recsys


def _param_shapes(cfg):
    return _model(cfg).param_shapes(cfg)


def train_state_from_arrays(tree: dict, cfg, opt, device=None, plan=None):
    """The port's ``TrainState`` from the reference's, given as numpy
    arrays: ``tree`` holds ``step`` (an int32 scalar), ``params`` (the
    model's tree, as the ``*_params_from_arrays`` take it), ``opt_state``
    (``opt.init``'s structure: AdamW ``m`` / ``v``, SGD ``mu``, Adafactor
    ``stats`` with ``vr`` / ``vc`` or ``v`` a leaf) and optionally
    ``ef_buf`` (fp32, the parameters' shapes).  Every leaf is checked
    against the port's shapes (``param_shapes(cfg)`` and ``opt.init`` of
    them) and cast to their dtypes; a missing, extra or misshapen leaf
    raises ``ValueError``.  Under ``plan``'s bound mesh the state is placed
    as the reference's train cells shard it: the parameters by
    ``param_specs``, the optimizer state by ``optim.state_specs``, the
    step replicated (the error-feedback buffer like the parameters)."""
    dev = resolve(device)
    shapes = _param_shapes(cfg)
    opt_shapes = opt.init(shapes)
    ef = tree.get("ef_buf")
    if ef is not None:
        ef = _tree_from_arrays(make_ef_transform()[0](shapes), ef, dev)
    state = TrainState(
        step=torch.as_tensor(np.asarray(tree["step"], dtype=np.int32),
                             device=dev),
        params=_tree_from_arrays(shapes, tree["params"], dev),
        opt_state=_tree_from_arrays(opt_shapes, tree["opt_state"], dev),
        ef_buf=ef)
    if plan is None or plan.mesh is None:
        return state
    specs = _model(cfg).param_specs(cfg, plan)
    return TrainState(
        step=plan.place(state.step, ()),
        params=_placed(state.params, specs, plan),
        opt_state=_placed(state.opt_state,
                          state_specs(opt, specs, shapes), plan),
        ef_buf=None if ef is None else _placed(ef, specs, plan))
