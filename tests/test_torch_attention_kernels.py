"""The LM serving path's two attention kernels' designs on the CPU, held
against the reference.

``attention_chunked`` and ``attention_decode`` (``csrc/attention.cu``)
run only on the card.  Here three things the port computes are held
against the reference's ``attention`` (its ``lax.scan`` over KV blocks)
and ``decode_attention`` on the same numpy-seeded inputs:

* the split models (``ref.chunked_attention_split``,
  ``ref.decode_attention_split``), which compute in the kernels' own
  order: query tiles, skipped tiles, rounding points, the decode's
  split-and-combine;
* the plain versions (``ref.chunked_attention_ref``,
  ``ref.decode_attention_ref``), which the card's kernels are held to;
* the dispatch of ``models/attention.py`` on the CPU.

Tolerance, of each output row's max |o|: fp32 1e-5; bf16 2 bf16 ulps
(2**-7), both sides starting from the same bf16 inputs (the two sum in
other orders, so a rounding point may land a unit apart).  Every shape
of ``test_torch_lm_slice.ATTN_CASES`` runs through the reference's scan
(its chunk, else 4), with a few more: several query tiles whose causal
skips are real, inner tiles smaller than a block with whole tiles
masked, MLA's ``reduced()`` widths (dh 24 / dv 16).  The decode takes
lengths 0 (the uniform row), 1 and S over one split and over three.
The ``meta`` branches' FLOP counts equal the plain versions' on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_torch_reference import reference  # noqa: F401  (fixture)
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as pattn
from repro_torch.testing import ATTN_TOL, attn_row_err

# (hq, hkv, sq, sk, chunk, q_pos offset, kv_mask kind, dh, dv, tiles):
# test_torch_lm_slice.ATTN_CASES at dh 8 / dv 6 with the dense ones run
# through the scan at chunk 4; then several query tiles of the bf16
# kernel (causal tiles past a tile's last position skipped), inner tiles
# of 8 slots inside blocks of 32 with whole tiles masked, MLA reduced
CASES = [
    (4, 4, 6, 6, 4, None, None, 8, 6, None),
    (4, 2, 6, 6, 4, None, None, 8, 6, None),
    (8, 1, 5, 5, 4, None, None, 8, 6, None),
    (4, 2, 13, 13, 4, None, None, 8, 6, None),
    (8, 1, 13, 13, 5, None, None, 8, 6, None),
    (4, 2, 3, 11, 4, 8, None, 8, 6, None),
    (4, 2, 3, 11, 4, 8, None, 8, 6, (2, 2)),
    (4, 2, 7, 7, 4, None, "row0-empty", 8, 6, None),
    (4, 2, 7, 9, 4, None, "row0-empty", 8, 6, None),
    (4, 4, 7, 9, 3, None, "ragged", 8, 6, None),
    (4, 2, 160, 160, 32, None, None, 8, 6, None),
    (4, 2, 70, 90, 32, 20, "ragged", 8, 6, (16, 8)),
    (4, 2, 40, 40, 16, None, "row0-empty", 8, 6, (16, 8)),
    (4, 4, 20, 20, 8, None, None, 24, 16, None),
]
IMPLS = ("split", "plain", "dispatch")
DTYPES = ("float32", "bfloat16")


def _rows(case):
    hq, hkv, sq, sk, chunk, off, mk, dh, dv, tiles = case
    rng = np.random.default_rng([hq, hkv, sq, sk, chunk, dh, dv])
    q = rng.normal(size=(2, sq, hq, dh)).astype(np.float32)
    k = rng.normal(size=(2, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(2, sk, hkv, dv)).astype(np.float32)
    kw = {"chunk": chunk}
    if off is not None:
        kw["q_pos"] = np.arange(off, off + sq)
    if mk == "row0-empty":
        m = np.ones((2, sk), np.int32)
        m[0] = 0
        kw["kv_mask"] = m
    elif mk == "ragged":
        kw["kv_mask"] = (np.arange(sk)[None] < np.array([[4], [sk]])
                         ).astype(np.int32)
    return q, k, v, kw


def _bf16_exact(x: np.ndarray, dtype: str) -> np.ndarray:
    """``x`` rounded to ``dtype`` as fp32 numpy: the inputs both sides
    start from."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


# the reference's output of each (case, dtype, causal), shared by the
# three port implementations held against it
_REF_OUT: dict = {}


def _reference_out(ns, case, dtype, causal):
    key = (case, dtype, causal)
    if key not in _REF_OUT:
        jnp = pytest.importorskip("jax.numpy")
        q, k, v, kw = _rows(case)
        jdt = getattr(jnp, dtype)
        arr = [jnp.asarray(_bf16_exact(a, dtype)).astype(jdt)
               for a in (q, k, v)]
        rkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for n, a in kw.items()}
        o = ns.attention.attention(*arr, causal=causal,
                                   scale=None if causal else 0.3, **rkw)
        _REF_OUT[key] = torch.from_numpy(np.array(o.astype(jnp.float32)))
    return _REF_OUT[key]


def _port(case, dtype, causal, impl):
    q, k, v, kw = _rows(case)
    dt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(dt) for x in (q, k, v))
    pkw = {n: torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
           else a for n, a in kw.items()}
    scale = q.shape[-1] ** -0.5 if causal else 0.3
    if impl == "dispatch":
        return pattn.attention(qt, kt, vt, causal=causal,
                               scale=None if causal else 0.3, **pkw)
    if impl == "plain":
        return ref.chunked_attention_ref(qt, kt, vt, causal=causal,
                                         scale=scale, **pkw)
    return ref.chunked_attention_split(qt, kt, vt, causal=causal,
                                       scale=scale, tiles=case[-1], **pkw)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_chunked_equals_reference(reference, case, causal, dtype, impl):
    want = _reference_out(reference, case, dtype, causal)
    got = _port(case, dtype, causal, impl)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    assert torch.isfinite(got).all()
    err = attn_row_err(got, want)
    assert err["max_rel"] <= ATTN_TOL[got.dtype], err


# (hq, hkv, S, dh, dv, lengths): lengths 0 (every slot masked: the
# uniform row), 1 and S, over one split and over three (ragged ends)
DECODE_CASES = [
    (4, 4, 9, 8, 6, (0, 1, 9)),
    (4, 2, 9, 8, 6, (0, 4, 9)),
    (8, 1, 9, 8, 6, (1, 0, 9)),
    (4, 2, 1100, 8, 6, (0, 1, 1100)),
    (4, 2, 1100, 16, 16, (513, 1024, 1099)),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[str(c) for c in DECODE_CASES])
def test_decode_equals_reference(reference, case, dtype, impl):
    jnp = pytest.importorskip("jax.numpy")
    hq, hkv, s, dh, dv, lengths = case
    rng = np.random.default_rng([hq, hkv, s, dh, dv])
    q = _bf16_exact(rng.normal(size=(3, 1, hq, dh)).astype(np.float32),
                    dtype)
    k = _bf16_exact(rng.normal(size=(3, s, hkv, dh)).astype(np.float32),
                    dtype)
    v = _bf16_exact(rng.normal(size=(3, s, hkv, dv)).astype(np.float32),
                    dtype)
    ln = np.array(lengths, np.int32)
    jdt = getattr(jnp, dtype)
    want = reference.attention.decode_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), jnp.asarray(ln))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    dt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(dt) for x in (q, k, v))
    lt = torch.from_numpy(ln)
    if impl == "dispatch":
        got = pattn.decode_attention(qt, kt, vt, lt)
    elif impl == "plain":
        got = ref.decode_attention_ref(qt, kt, vt, lt, scale=dh ** -0.5)
    else:
        got = ref.decode_attention_split(qt, kt, vt, lt, scale=dh ** -0.5)
    assert got.dtype == dt and tuple(got.shape) == tuple(want.shape)
    assert torch.isfinite(got).all()
    err = attn_row_err(got, want)
    assert err["max_rel"] <= ATTN_TOL[dt], err


@pytest.mark.parametrize("tiles", [(64, 64), (32, 32), (16, 8), (4, 4)])
def test_split_model_tiles_agree(tiles):
    """The split model at any tiling agrees with the plain loop: skipping
    a masked tile adds exactly nothing (a kv_mask with whole dead tiles,
    a fully masked batch row, queries at a shard's offset)."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 50, 4, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 90, 2, 16, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 90, 2, 8, generator=g).to(torch.bfloat16)
    mask = torch.ones(2, 90, dtype=torch.int32)
    mask[0, 10:60] = 0
    mask[1] = 0
    kw = dict(causal=True, chunk=32, scale=0.25, q_pos=torch.arange(40, 90),
              kv_mask=mask)
    got = ref.chunked_attention_split(q, k, v, tiles=tiles, **kw)
    want = ref.chunked_attention_ref(q, k, v, **kw)
    err = attn_row_err(got, want)
    assert err["max_rel"] <= ATTN_TOL[torch.bfloat16], err


@pytest.mark.parametrize("split", [1, 3, 512])
def test_decode_split_model_splits_agree(split):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 1, 4, 16, generator=g)
    k = torch.randn(3, 40, 2, 16, generator=g)
    v = torch.randn(3, 40, 2, 8, generator=g)
    ln = torch.tensor([0, 7, 40])
    got = ref.decode_attention_split(q, k, v, ln, scale=0.25, split=split)
    want = ref.decode_attention_ref(q, k, v, ln, scale=0.25)
    assert attn_row_err(got, want)["max_rel"] <= ATTN_TOL[torch.float32]


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_flops_equal_the_plain_loop(dtype):
    """On ``meta`` the ops dispatch the plain versions' products, so the
    dry run's FLOP counter sees the same total: the chunked loop at four
    blocks (the last ragged), and the decode."""
    shapes = dict(q=(2, 15, 4, 8), k=(2, 15, 2, 8), v=(2, 15, 2, 6))
    cpu = {n: torch.zeros(s, dtype=dtype) for n, s in shapes.items()}
    meta = {n: torch.empty(s, dtype=dtype, device="meta")
            for n, s in shapes.items()}
    kw = dict(causal=True, chunk=4, scale=0.5)
    plain = _flops(lambda: ref.chunked_attention_ref(**cpu, **kw))
    on_meta = _flops(lambda: ops.chunked_attention_op(**meta, **kw))
    assert plain == on_meta > 0
    out = ops.chunked_attention_op(**meta, **kw)
    assert out.device.type == "meta" and out.dtype == dtype
    assert tuple(out.shape) == (2, 15, 4, 6)
    dshapes = dict(q=(2, 1, 4, 8), k_cache=(2, 21, 2, 8),
                   v_cache=(2, 21, 2, 6))
    cpu = {n: torch.zeros(s, dtype=dtype) for n, s in dshapes.items()}
    meta = {n: torch.empty(s, dtype=dtype, device="meta")
            for n, s in dshapes.items()}
    ln = torch.tensor([3, 21])
    plain = _flops(lambda: ref.decode_attention_ref(**cpu, lengths=ln,
                                                    scale=0.5))
    on_meta = _flops(lambda: ops.decode_attention_op(
        **meta, lengths=ln.to("meta"), scale=0.5))
    assert plain == on_meta > 0
    out = ops.decode_attention_op(**meta, lengths=ln.to("meta"), scale=0.5)
    assert tuple(out.shape) == (2, 1, 4, 6) and out.dtype == dtype


@pytest.mark.parametrize("wants_grad", [False, True])
def test_dispatch_by_autograd_only(monkeypatch, wants_grad):
    """The chunked path goes to the op when no gradient is wanted and to
    the plain checkpointed loop when one is, on every device; the dense
    path and the decode are untouched by it."""
    seen = []
    monkeypatch.setattr(pattn, "chunked_attention_op",
                        lambda *a, **k: seen.append("op") or
                        ref.chunked_attention_ref(*a, **k))
    monkeypatch.setattr(pattn, "chunked_attention_ref",
                        lambda *a, **k: seen.append("plain") or
                        ref.chunked_attention_ref(*a, **k))
    q, k, v = (torch.randn(1, 9, 2, 4, requires_grad=wants_grad)
               for _ in range(3))
    pattn.attention(q, k, v, chunk=4)
    pattn.attention(q, k, v, chunk=9)                       # dense
    with torch.no_grad():
        pattn.attention(q, k, v, chunk=4)
    assert seen == (["plain", "op"] if wants_grad else ["op", "op"])


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches a plain
    version through them (``ops`` picks by device)."""
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kattn.attention_chunked(q, q, q, causal=True, chunk=2, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kattn.attention_decode(q[:, :1], q, q, torch.ones(1), scale=1.0)
    with pytest.raises(TypeError):
        kattn.tiles_of(torch.float16)
    assert kattn.tiles_of(torch.bfloat16) == (64, 64)
