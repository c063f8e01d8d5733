"""The language models' serving path on the CPU, held against the reference.

The port's configs, registry, token stream, parameter system, layers,
attention, MoE, embedding helpers and decoder-only transformer
(``repro_torch.{configs,data.lm,models}``) against the reference's on
the same numpy-seeded inputs, the reference's weights carried across with
``convert.lm_params_from_arrays``:

* configs, ``reduced()``, the registry's ``SHAPES`` and ``LMStream``
  batches equal the reference's exactly; so do ``_dispatch_indices``,
  ``moe_capacity``, ``_route``'s ids, every ``param_specs`` and every
  ``param_shapes`` (shape and dtype, full size, no allocation);
* layers, attention, MoE and embedding in fp32 to rtol / atol 1e-5
  (``TOL32``; GELU against ``jax.nn.gelu``'s tanh form);
* for each of the five LM archs at ``reduced()`` (MoE capacity factor 8,
  so no token drops, as the reference's own consistency test):
  ``loss_fn`` (with MTP for deepseek), ``prefill`` last logits and cache,
  one ``decode_step``'s logits and cache, at two policies:

  - fp32 (``set_precision(float32, float32)`` on both sides, and the
    residual stream in fp32 too, so that logic is held apart from
    rounding): rtol / atol 1e-4 (``TOL_FP32``), argmax equal on every row;
  - the default bf16 policy with the config as it is (bf16 residual for
    four archs): a relative L2 error of at most 2**-4 (``BF16_REL_L2``,
    about eight bf16 ulps on the whole tensor) and every element within
    ``TOL_BF16`` (rtol 2**-3, atol 2**-2: a single logit can move by
    more where bf16 rounding flips a near-tied expert), loss to rtol
    1e-2;

* the reference's own invariant on the port: ``decode_step`` after
  ``prefill(S)`` equals ``prefill(S + 1)``'s last logits (rtol / atol
  2e-3, as ``tests/test_models.py``);
* ``ShardPlan.constrain``, the cache's in-place slot write,
  ``lm_params_from_arrays`` and the parameter system's seeding.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.configs import base as pcb
from repro_torch.configs import registry as preg
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data.lm import LMStream
from repro_torch.distributed.sharding import LOCAL_PLAN, SINGLE_POD_PLAN
from repro_torch.models import attention as pattn
from repro_torch.models import base as pbase
from repro_torch.models import embedding as pemb
from repro_torch.models import layers as play
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as PT

LM_ARCHS = ["qwen3-0.6b", "qwen3-14b", "granite-34b", "deepseek-v3-671b",
            "kimi-k2-1t-a32b"]
TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL_FP32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=2 ** -3, atol=2 ** -2)
BF16_REL_L2 = 2 ** -4
CONSIST = dict(rtol=2e-3, atol=2e-3)
SEQ, BATCH, MAX_LEN = 8, 2, 12


def _np(x) -> np.ndarray:
    """A reference (jax) or port (torch) array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL32):
    a, b = _np(port), _np(ref)
    if tol is TOL_BF16:
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= BF16_REL_L2, f"relative L2 error {err}"
    np.testing.assert_allclose(a, b, **tol)


def _rng(seed):
    return np.random.default_rng(seed)


def _ref_weights(reference, rcfg, seed: int) -> dict:
    """A parameter tree in the reference's layout (its ``param_shapes``),
    numpy-seeded: weights ``normal / sqrt(fan_in)``, norm scales and the
    router bias ``1 + 0.1 normal`` / ``0.1 normal``; bf16 leaves as
    ``ml_dtypes`` arrays, as JAX hands them over.  Faster on the CPU than
    the reference's own ``init``, whose eager ops compile one by one."""
    jnp = pytest.importorskip("jax.numpy")
    rng = _rng(seed)

    def walk(tree):
        out = {}
        for k, sds in tree.items():
            if isinstance(sds, dict):
                out[k] = walk(sds)
                continue
            shape = tuple(sds.shape)
            a = rng.standard_normal(shape).astype(np.float32)
            if k == "router_bias":
                a = 0.1 * a
            elif k in VECTORS:
                a = 1.0 + 0.1 * a
            else:
                a = a / np.sqrt(shape[-2] if k != "w_o" else
                                shape[-3] * shape[-2])
            out[k] = np.asarray(a, dtype=jnp.dtype(sds.dtype))
        return out

    return walk(reference.transformer.param_shapes(
        rcfg, reference.sharding.ShardPlan()))


VECTORS = {"ln1", "ln2", "q_norm", "k_norm", "q_ln", "kv_ln", "final_norm",
           "norm_h", "norm_e"}


# ---------------------------------------------------------------------------
# configs, registry, token stream
# ---------------------------------------------------------------------------


ALL_ARCHS = ["qwen3-14b", "granite-34b", "qwen3-0.6b", "deepseek-v3-671b",
             "kimi-k2-1t-a32b", "schnet", "din", "dlrm-mlperf", "sasrec",
             "dcn-v2", "radio-station", "sift-1m", "deep-10m"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_config_and_reduced_equal_reference(reference, arch):
    rcfg, rfam = reference.registry.get_arch(arch)
    pcfg, pfam = preg.get_arch(arch)
    assert pfam == rfam
    assert type(pcfg).__name__ == type(rcfg).__name__
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(pcfg.reduced()) == \
        dataclasses.asdict(rcfg.reduced())
    for prop in ("n_moe_layers", "n_sparse"):
        if hasattr(rcfg, prop):
            assert getattr(pcfg, prop) == getattr(rcfg, prop)
    if getattr(rcfg, "moe", None) is not None:
        assert pcfg.moe.e_pad == rcfg.moe.e_pad


def test_registry_equals_reference(reference):
    reg = reference.registry
    assert preg.ARCHS == reg.ARCHS
    assert {f: [dataclasses.asdict(s) for s in v]
            for f, v in preg.SHAPES.items()} == \
        {f: [dataclasses.asdict(s) for s in v] for f, v in reg.SHAPES.items()}
    for inc in (False, True):
        mine = [(a, dataclasses.asdict(c), f, s.name)
                for a, c, f, s in preg.iter_cells(include_ann=inc)]
        theirs = [(a, dataclasses.asdict(c), f, s.name)
                  for a, c, f, s in reg.iter_cells(include_ann=inc)]
        assert mine == theirs
    s = preg.get_shape("lm", "prefill_32k")
    assert (s.kind, s["seq"], s["batch"]) == ("prefill", 32768, 32)
    assert [x.name for x in preg.get_shapes("ann")] == \
        [x.name for x in reg.get_shapes("ann")]
    with pytest.raises(KeyError):
        preg.get_arch("nope")
    with pytest.raises(KeyError):
        preg.get_shape("lm", "nope")
    # every config dataclass is the reference's, field for field
    for name in pcb.__all__:
        mine, theirs = getattr(pcb, name), getattr(reference.configs_base,
                                                   name)
        assert [(f.name, f.default) for f in dataclasses.fields(mine)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq=16, batch=2, seed=0),
    dict(vocab=151936, seq=64, batch=3, seed=7),
    dict(vocab=1000, seq=40, batch=1, seed=3, motif_len=4, n_motifs=16),
])
def test_lm_stream_bit_for_bit(reference, kw):
    mine, theirs = LMStream(**kw), reference.lm.LMStream(**kw)
    assert np.array_equal(mine.unigram, theirs.unigram)
    assert np.array_equal(mine.motifs, theirs.motifs)
    for step in (0, 1, 17):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope(reference):
    jnp = pytest.importorskip("jax.numpy")
    L = reference.layers
    rng = _rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    sc = rng.normal(size=(16,)).astype(np.float32)
    _close(play.rms_norm(_t(x), _t(sc)), L.rms_norm(jnp.asarray(x), sc))
    # bf16 in, bf16 out: the fp32 math, then one rounding
    got = play.rms_norm(_t(x).bfloat16(), _t(sc))
    ref = L.rms_norm(jnp.asarray(x, jnp.bfloat16), sc)
    assert got.dtype == torch.bfloat16
    _close(got, ref, dict(rtol=2 ** -7, atol=2 ** -7))
    for pos in (np.arange(5), np.array([[3], [9]])):
        pc, ps = play.rope_tables(_t(pos), 16, 1e4)
        rc, rs = L.rope_tables(jnp.asarray(pos), 16, 1e4)
        _close(pc, rc)
        _close(ps, rs)
        xin = x if pos.ndim == 1 else x[:, :1]
        _close(play.rope(_t(xin), pc, ps), L.rope(jnp.asarray(xin), rc, rs))


def test_mlps_softplus_and_xent(reference):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    L = reference.layers
    rng = _rng(1)
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    wg, wu = (rng.normal(size=(8, 12)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(12, 8)).astype(np.float32)
    _close(play.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           L.swiglu(x, wg, wu, wd))
    # jax.nn.gelu's default is the tanh form, not torch's erf
    _close(play.gelu_mlp(_t(x), _t(wu), _t(wd)), L.gelu_mlp(x, wu, wd))
    h = x @ wu
    _close(torch.nn.functional.gelu(_t(h), approximate="tanh"),
           jax.nn.gelu(h))
    assert not np.allclose(_np(torch.nn.functional.gelu(_t(h))),
                           _np(jax.nn.gelu(h)), rtol=1e-6, atol=1e-6)
    z = (rng.normal(size=(64,)) * 10).astype(np.float32)
    _close(play.shifted_softplus(_t(z)), L.shifted_softplus(z))
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for kw in (dict(), dict(z_loss=1e-4), dict(mask=mask),
               dict(z_loss=1e-3, mask=np.zeros_like(mask))):
        pl, pa = play.softmax_xent(
            _t(logits), _t(labels), z_loss=kw.get("z_loss", 0.0),
            mask=None if "mask" not in kw else _t(kw["mask"]))
        rl, ra = L.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                **kw)
        _close(pl, rl)
        _close(pa["accuracy"], ra["accuracy"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(seed, b, sq, sk, hq, hkv, dh, dv=None):
    rng = _rng(seed)
    q = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, dv or dh)).astype(np.float32)
    return q, k, v


# (hq, hkv, sq, sk, chunk, q_pos offset, kv_mask kind)
ATTN_CASES = [
    (4, 4, 6, 6, None, None, None),           # R = 1, dense
    (4, 2, 6, 6, None, None, None),           # R = 2
    (8, 1, 5, 5, None, None, None),           # R = 8 (MQA)
    (4, 2, 13, 13, 4, None, None),            # chunked, ragged last block
    (8, 1, 13, 13, 5, None, None),            # chunked MQA, ragged
    (4, 2, 3, 11, 4, 8, None),                # q_pos: the last 3 positions
    (4, 2, 3, 11, None, 8, None),
    (4, 2, 7, 7, None, None, "row0-empty"),   # a fully masked row, dense
    (4, 2, 7, 9, 4, None, "row0-empty"),      # ... chunked (pads count)
    (4, 4, 7, 9, 3, None, "ragged"),          # per-row valid lengths
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_attention_equals_reference(reference, case):
    jnp = pytest.importorskip("jax.numpy")
    hq, hkv, sq, sk, chunk, off, mk = case
    q, k, v = _qkv(hash(case) % 1000, 2, sq, sk, hq, hkv, 8, 6)
    kw = dict(chunk=chunk)
    if off is not None:
        kw["q_pos"] = np.arange(off, off + sq)
    if mk == "row0-empty":
        m = np.ones((2, sk), np.int32)
        m[0] = 0
        kw["kv_mask"] = m
    elif mk == "ragged":
        kw["kv_mask"] = (np.arange(sk)[None] < np.array([[4], [sk]])
                         ).astype(np.int32)
    rkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    pkw = {n: (_t(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    got = pattn.attention(_t(q), _t(k), _t(v), **pkw)
    ref = reference.attention.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **rkw)
    assert tuple(got.shape) == tuple(ref.shape)
    assert torch.isfinite(got).all()
    _close(got, ref)
    # the same with an explicit scale and no causal mask
    got = pattn.attention(_t(q), _t(k), _t(v), causal=False, scale=0.3,
                          **pkw)
    ref = reference.attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        scale=0.3, **rkw)
    _close(got, ref)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_decode_attention_equals_reference(reference, hq, hkv):
    jnp = pytest.importorskip("jax.numpy")
    q, k, v = _qkv(hq * 10 + hkv, 3, 1, 9, hq, hkv, 8)
    lengths = np.array([0, 4, 9], np.int32)       # 0: a fully masked row
    got = pattn.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    ref = reference.attention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    assert torch.isfinite(got).all()
    _close(got, ref)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_cfgs(reference, score_fn="sigmoid", groups=1, cf=1.25):
    r = reference.registry.get_arch("deepseek-v3-671b")[0].reduced()
    p = preg.get_arch("deepseek-v3-671b")[0].reduced()
    out = []
    for c in (p, r):
        out.append(dataclasses.replace(
            c, moe_groups=groups,
            moe=dataclasses.replace(c.moe, score_fn=score_fn,
                                    capacity_factor=cf)))
    return out


def test_moe_capacity_equals_reference(reference):
    for cf in (1.0, 1.25, 8.0):
        p, r = _moe_cfgs(reference, cf=cf)
        for t in (1, 2, 7, 16, 64, 100, 1024):
            assert pmoe.moe_capacity(p, t) == \
                reference.moe.moe_capacity(r, t)


@pytest.mark.parametrize("score_fn", ["sigmoid", "softmax"])
def test_route_equals_reference(reference, score_fn):
    jnp = pytest.importorskip("jax.numpy")
    p, r = _moe_cfgs(reference, score_fn=score_fn)
    rng = _rng(2)
    x = rng.normal(size=(64, p.d_model)).astype(np.float32)
    w = rng.normal(size=(p.d_model, p.moe.n_experts)).astype(np.float32)
    bias = (rng.normal(size=(p.moe.n_experts,)) * 0.1).astype(np.float32)
    pi, pg = pmoe._route(_t(x), _t(w), _t(bias), p.moe)
    ri, rg = reference.moe._route(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(bias), r.moe)
    assert pi.dtype == torch.int32
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    _close(pg, rg)
    # all scores tied: the lower experts win, as lax.top_k
    zx, zw, zb = (np.zeros_like(a) for a in (x[:3], w, bias))
    ti, _ = pmoe._route(_t(zx), _t(zw), _t(zb), p.moe)
    ri, _ = reference.moe._route(jnp.asarray(zx), jnp.asarray(zw),
                                 jnp.asarray(zb), r.moe)
    assert ti.tolist() == np.asarray(ri).tolist() == \
        [list(range(p.moe.top_k))] * 3


@pytest.mark.parametrize("t,k,e,cap", [(64, 2, 8, 24), (64, 2, 8, 8),
                                       (37, 3, 6, 8), (5, 2, 8, 8)])
def test_dispatch_indices_equal_reference_exactly(reference, t, k, e, cap):
    jnp = pytest.importorskip("jax.numpy")
    rng = _rng(t + k + e + cap)
    # skewed assignments so some experts overflow the capacity
    top_i = np.stack([rng.choice(e, k, replace=False,
                                 p=np.linspace(3, 1, e) / np.linspace(
                                     3, 1, e).sum()) for _ in range(t)]
                     ).astype(np.int32)
    pd, (pe, pr, po) = pmoe._dispatch_indices(_t(top_i), e, cap)
    rd, (re_, rr, ro) = reference.moe._dispatch_indices(jnp.asarray(top_i),
                                                        e, cap)
    for a, b in ((pd, rd), (pe, re_), (pr, rr), (po, ro)):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("groups,cf", [(1, 1.25), (2, 1.25), (1, 8.0),
                                       (2, 0.5)])
def test_moe_ffn_equals_reference(reference, groups, cf):
    jax = pytest.importorskip("jax")
    p, r = _moe_cfgs(reference, groups=groups, cf=cf)
    params = reference.models_base.build_params(
        lambda c, mk: reference.moe.moe_params(c, mk,
                                               reference.sharding.ShardPlan(),
                                               "m", 1),
        r, jax.random.PRNGKey(groups))
    layer = {k: np.asarray(v)[0] for k, v in params.items()}
    layer["router_bias"] = (_rng(5).normal(size=layer["router_bias"].shape)
                            * 0.05).astype(np.float32)
    x = _rng(4).normal(size=(2, 6, p.d_model)).astype(np.float32)
    got = pmoe.moe_ffn({k: _t(v) for k, v in layer.items()}, _t(x), p,
                       LOCAL_PLAN)
    ref = reference.moe.moe_ffn(layer, jax.numpy.asarray(x), r,
                                reference.sharding.ShardPlan())
    _close(got, ref)
    with pytest.raises(ValueError):
        pmoe.moe_ffn({k: _t(v) for k, v in layer.items()}, _t(x[:, :5]),
                     dataclasses.replace(p, moe_groups=4), LOCAL_PLAN)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_equals_reference(reference, mode):
    jnp = pytest.importorskip("jax.numpy")
    E = reference.embedding
    rng = _rng(6)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(-1, 20, (3, 5)).astype(np.int32)
    ids[1] = -1                                   # an empty bag
    w = rng.random((3, 5)).astype(np.float32)
    _close(pemb.take_embeddings(_t(table), _t(ids)),
           E.take_embeddings(jnp.asarray(table), jnp.asarray(ids)))
    for weights in (None, w):
        got = pemb.embedding_bag(_t(table), _t(ids), mode=mode,
                                 weights=None if weights is None
                                 else _t(weights))
        ref = E.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              mode=mode, weights=None if weights is None
                              else jnp.asarray(weights))
        _close(got, ref)
    off, n = pemb.concat_table_offsets((3, 5, 7))
    roff, rn = E.concat_table_offsets((3, 5, 7))
    assert np.array_equal(off, roff) and n == rn
    with pytest.raises(ValueError):
        pemb.embedding_bag(_t(table), _t(ids), mode="nope")


# ---------------------------------------------------------------------------
# parameters: specs, shapes, seeding, conversion
# ---------------------------------------------------------------------------


def _spec(entries) -> tuple:
    """A spec's entries as tuples of mesh axes (or None)."""
    return tuple(None if e is None else (tuple(e) if isinstance(e, tuple)
                                         else (e,)) for e in entries)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_and_shapes_equal_reference(reference, arch):
    jnp = pytest.importorskip("jax.numpy")
    T = reference.transformer
    rplan = reference.sharding.SINGLE_POD_PLAN
    rcfg = reference.registry.get_arch(arch)[0]
    pcfg = preg.get_arch(arch)[0]
    mine = _paths(PT.param_specs(pcfg, SINGLE_POD_PLAN))
    theirs = _paths(T.param_specs(rcfg, rplan))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert _spec(mine[k]) == _spec(theirs[k]), k
    mine = _paths(PT.param_shapes(pcfg))
    theirs = _paths(T.param_shapes(rcfg, reference.sharding.ShardPlan()))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].device.type == "meta"
        assert tuple(mine[k].shape) == tuple(theirs[k].shape), k
        assert str(mine[k].dtype).split(".")[-1] == \
            jnp.dtype(theirs[k].dtype).name, k
    n = pbase.count_params(PT.param_shapes(pcfg))
    assert n == sum(int(np.prod(v.shape)) for v in theirs.values())
    for batch, max_len in ((2, 16), (4, 32768)):
        mc = PT.cache_shapes(pcfg, batch, max_len)
        rc = T.cache_shapes(rcfg, batch, max_len)
        assert mc.keys() == rc.keys()
        for k in mc:
            assert tuple(mc[k].shape) == tuple(rc[k].shape)
    for k, v in PT.cache_specs(pcfg, SINGLE_POD_PLAN).items():
        assert _spec(v) == _spec(T.cache_specs(rcfg, rplan)[k])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_params_from_arrays(reference, arch):
    jax = pytest.importorskip("jax")
    T = reference.transformer
    rcfg = reference.registry.get_arch(arch)[0].reduced()
    pcfg = preg.get_arch(arch)[0].reduced()
    if arch == "deepseek-v3-671b":         # bf16 leaves carried bit for bit
        rcfg = dataclasses.replace(rcfg, param_dtype="bfloat16")
        pcfg = dataclasses.replace(pcfg, param_dtype="bfloat16")
    arrays = _ref_weights(reference, rcfg, 1)
    tree = lm_params_from_arrays(arrays, pcfg, device="cpu")
    want, got, src = (_paths(PT.param_shapes(pcfg)), _paths(tree),
                      _paths(arrays))
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        if got[k].dtype == torch.bfloat16:
            assert np.array_equal(got[k].view(torch.int16).numpy(),
                                  src[k].view(np.int16)), k
        else:
            assert np.array_equal(got[k].numpy(), src[k]), k
    assert pbase.tree_bytes(tree) == sum(a.nbytes for a in src.values())
    bad = dict(arrays, embed=arrays["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_arrays(bad, pcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_arrays(dict(arrays, extra=arrays["embed"]), pcfg,
                              device="cpu")


def test_build_params_seeding_and_inits():
    def fn(cfg, mk, extra=False):
        out = {"a": mk("a", (64, 32), None),
               "b": mk("b", (3, 5), None, init=("normal", 0.5)),
               "o": mk("o", (4,), None, init="ones"),
               "z": mk("z", (4,), None, init="zeros"),
               "c": mk("c", (2,), None, init=0.25),
               "h": mk("h", (8,), None, param_dtype=torch.bfloat16)}
        if extra:
            out["new"] = mk("new", (7,), None)
        return out

    p1 = pbase.build_params(fn, None, seed=3, device="cpu")
    p2 = pbase.build_params(lambda c, mk: fn(c, mk, extra=True), None,
                            seed=3, device="cpu")
    p3 = pbase.build_params(fn, None, seed=4, device="cpu")
    for k in p1:                  # adding a parameter reshuffles no other
        assert torch.equal(p1[k], p2[k])
    assert not torch.equal(p1["a"], p3["a"])
    assert torch.equal(p1["a"], pbase.build_params(fn, None, seed=3,
                                                   device="cpu")["a"])
    assert p1["h"].dtype == torch.bfloat16 and p1["a"].dtype == torch.float32
    assert abs(float(p1["a"].std()) - 64 ** -0.5) < 0.01   # fan_in 64 rows
    assert p1["o"].tolist() == [1.0] * 4 and p1["z"].tolist() == [0.0] * 4
    assert p1["c"].tolist() == [0.25, 0.25]
    assert pbase.count_params(p1) == 64 * 32 + 15 + 4 + 4 + 2 + 8
    cast = pbase.cast_tree({**p1, "i": torch.arange(3, dtype=torch.int32)},
                           torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for k, v in cast.items() if k != "i")
    assert cast["i"].dtype == torch.int32
    with pytest.raises(ValueError):
        pbase.build_params(lambda c, mk: mk("x", (2,), None, init="nope"),
                           None, device="cpu")
    specs = pbase.build_specs(fn, None)
    assert specs["a"] == ()
    shapes = pbase.build_shapes(fn, None)
    assert shapes["h"].dtype == torch.bfloat16 and \
        shapes["a"].device.type == "meta"


def test_init_needs_a_card_unless_asked_for_the_cpu():
    cfg = preg.get_arch("qwen3-0.6b")[0].reduced()
    p = PT.init(cfg, seed=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PT.init(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_params_from_arrays(pbase.tree_map(lambda t: t.numpy(), p),
                                  cfg)
    assert p["embed"].device.type == "cpu"
    assert pbase.count_params(p) == pbase.count_params(PT.param_shapes(cfg))


def test_constrain_is_identity_without_mesh_and_raises_with_one():
    """No mesh: the identity.  A bound mesh: a plain tensor raises
    ``TypeError`` (a DTensor is redistributed, as
    ``test_torch_sharded_models.py`` holds over four ranks)."""
    x = torch.ones(3, 4)
    assert LOCAL_PLAN.constrain(x, "dp", None) is x
    assert SINGLE_POD_PLAN.constrain(x, "dp", "tp") is x
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros((1, 1)))
    with pytest.raises(TypeError, match="plain"):
        SINGLE_POD_PLAN.with_mesh(mesh).constrain(x, "dp", "tp")


def test_write_slot_keeps_rows_past_the_cache():
    buf = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    ref = buf.clone()
    new = torch.full((2, 1, 3), -1.0)
    lengths = torch.tensor([1, 4], dtype=torch.int32)
    PT._write_slot(buf, PT._slots(lengths, 4), new)
    ref[0, 1] = -1.0                         # row 1 is full: unchanged
    assert torch.equal(buf, ref)


# ---------------------------------------------------------------------------
# the five LM archs at reduced(): loss, prefill, decode
# ---------------------------------------------------------------------------


def _arch_cfgs(reference, arch, policy):
    rcfg = reference.registry.get_arch(arch)[0].reduced()
    pcfg = preg.get_arch(arch)[0].reduced()
    kw = dict(remat=False)
    if policy == "fp32":
        kw["residual_dtype"] = "float32"
    rcfg, pcfg = (dataclasses.replace(c, **kw) for c in (rcfg, pcfg))
    if rcfg.moe is not None:
        rcfg, pcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=8.0))
            for c in (rcfg, pcfg))
    return rcfg, pcfg


_RUNS: dict = {}


def _run(reference, arch, policy):
    """Both packages' loss, prefill and one decode step on the reference's
    weights, once per (arch, policy)."""
    key = (arch, policy)
    if key in _RUNS:
        return _RUNS[key]
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    T = reference.transformer
    rcfg, pcfg = _arch_cfgs(reference, arch, policy)
    if policy == "fp32":
        T.set_precision(jnp.float32, jnp.float32)
        PT.set_precision(torch.float32, torch.float32)
    try:
        arrays = _ref_weights(reference, rcfg, 0)
        rp = jax.tree.map(jnp.asarray, arrays)
        pp = lm_params_from_arrays(arrays, pcfg, device="cpu")
        batch = LMStream(pcfg.vocab, 16, BATCH, seed=0).batch_at(0)
        toks = batch["tokens"]
        out = {"ref": {}, "port": {}}
        rl, raux = T.loss_fn(rp, batch, rcfg)
        pl, paux = PT.loss_fn(pp, batch, pcfg)
        out["ref"]["loss"], out["port"]["loss"] = (rl, raux), (pl, paux)
        rlog, rc = T.prefill(rp, toks[:, :SEQ], rcfg, max_len=MAX_LEN)
        plog, pc = PT.prefill(pp, toks[:, :SEQ], pcfg, max_len=MAX_LEN)
        out["ref"]["prefill"] = (rlog, {k: np.asarray(jnp.asarray(
            v, jnp.float32)) for k, v in rc.items()})
        out["port"]["prefill"] = (plog, {k: _np(v) for k, v in pc.items()})
        rd, rc2 = T.decode_step(rp, rc, toks[:, SEQ:SEQ + 1], rcfg)
        pd, pc2 = PT.decode_step(pp, pc, toks[:, SEQ:SEQ + 1], pcfg)
        out["ref"]["decode"], out["port"]["decode"] = (rd, rc2), (pd, pc2)
        if policy == "fp32":
            out["port"]["prefill_s1"] = PT.prefill(
                pp, toks[:, :SEQ + 1], pcfg, max_len=MAX_LEN)[0]
    finally:
        T.set_precision()
        PT.set_precision()
    _RUNS[key] = out
    return out


def _tol(policy):
    return TOL_FP32 if policy == "fp32" else TOL_BF16


POLICIES = ["fp32", "bf16"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_equals_reference(reference, arch, policy):
    out = _run(reference, arch, policy)
    (rl, raux), (pl, paux) = out["ref"]["loss"], out["port"]["loss"]
    tol = dict(rtol=1e-5, atol=1e-5) if policy == "fp32" else \
        dict(rtol=1e-2, atol=1e-2)
    assert set(paux) == set(raux)
    for k in raux:
        _close(paux[k], raux[k], tol)
    _close(pl, rl, tol)
    assert ("mtp_nll" in paux) == (arch == "deepseek-v3-671b")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_equals_reference(reference, arch, policy):
    out = _run(reference, arch, policy)
    (rlog, rc), (plog, pc) = out["ref"]["prefill"], out["port"]["prefill"]
    assert tuple(plog.shape) == (BATCH, preg.get_arch(arch)[0].reduced().vocab)
    _close(plog, rlog, _tol(policy))
    if policy == "fp32":
        assert np.array_equal(_np(plog).argmax(-1), _np(rlog).argmax(-1))
    assert pc.keys() == rc.keys()
    for k in rc:
        assert pc[k].shape == rc[k].shape, k
        _close(pc[k], rc[k], _tol(policy))
    assert (pc["lengths"] == SEQ).all()
    assert not pc[next(k for k in pc if k != "lengths")][:, :, SEQ:].any()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_step_equals_reference(reference, arch, policy):
    jnp = pytest.importorskip("jax.numpy")
    out = _run(reference, arch, policy)
    (rd, rc), (pd, pc) = out["ref"]["decode"], out["port"]["decode"]
    _close(pd, rd, _tol(policy))
    if policy == "fp32":
        assert np.array_equal(_np(pd).argmax(-1), _np(rd).argmax(-1))
    assert pc.keys() == rc.keys()
    assert pc["lengths"].dtype == torch.int32
    assert pc["lengths"].tolist() == np.asarray(rc["lengths"]).tolist() \
        == [SEQ + 1] * BATCH
    for k in rc:
        if k != "lengths":
            _close(pc[k], np.asarray(jnp.asarray(rc[k], jnp.float32)),
                   _tol(policy))
    if policy == "fp32":
        # the reference's own invariant, on the port
        _close(pd, out["port"]["prefill_s1"], CONSIST)
