"""Wrappers of the CUDA kernels of the LM serving path's two attentions.

``attention_chunked`` runs the reference's chunked attention (the
``lax.scan`` over KV blocks of ``repro/models/attention.py``; no Pallas
kernel there) and ``attention_decode`` its one-token decode attention
over a KV cache, read in place; the kernels are ``csrc/attention.cu``,
whose header note gives the rounding points, the design and the bounds.
This module checks the operands, allocates the output and the decode's
scratch, launches on PyTorch's current stream and counts launches.  CUDA
tensors only; the plain versions are ``ref.chunked_attention_ref`` and
``ref.decode_attention_ref`` (``ref.chunked_attention_split`` and
``ref.decode_attention_split`` model the kernels' own order), and
``ops.chunked_attention_op`` / ``ops.decode_attention_op`` pick between
them by device.

K, V and the cache are read where they lie, by their strides (their last
dim must be contiguous); q, k and v are one type, bf16 or fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LaunchCounter

__all__ = ["attention_chunked", "attention_decode", "kernel_info",
           "tiles_of", "CHUNKED_LAUNCHES", "DECODE_LAUNCHES", "DECODE_SPLIT",
           "MAX_HEAD_DIM"]

CHUNKED_LAUNCHES = LaunchCounter("attention_chunked")
DECODE_LAUNCHES = LaunchCounter("attention_decode")

MAX_HEAD_DIM = 256          # dh and dv (csrc/attention.cu)
DECODE_SPLIT = 512          # cache slots a decode block
_TILES = {torch.bfloat16: (64, 64), torch.float32: (32, 32)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KINDS = ("chunked", "decode scores", "decode pv", "decode combine")

_fns: dict = {}


def tiles_of(dtype: torch.dtype) -> tuple:
    """(query rows a tile, KV slots an inner tile) of the chunked kernel
    for ``dtype``: the bf16 tensor-core kernel's or the fp32 one's."""
    if dtype not in _TILES:
        raise TypeError(f"attention kernels take bf16 or fp32, not {dtype}")
    return _TILES[dtype]


def _fn(name: str, argtypes, restype=ctypes.c_int):
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.library("attention"), name)
        f.argtypes, f.restype = argtypes, restype
        _fns[name] = f
    return f


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _fn("attention_error_string", [ctypes.c_int],
                  ctypes.c_char_p)(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_info(kind: str, dtype: torch.dtype, dh: int, dv: int,
                r: int = 1) -> dict:
    """The built kernel a launch would run, as it runs it: ``kind`` one of
    "chunked", "decode scores", "decode pv", "decode combine" (``r`` query
    heads a KV head).  Registers and spilled bytes a thread, resident
    blocks an SM, shared memory a block."""
    out = (ctypes.c_int * 4)()
    rc = _fn("attention_info", [ctypes.c_int] * 5 + [ctypes.c_void_p])(
        _KINDS.index(kind), _DTYPES[dtype], dh, dv, r, out)
    _check(rc, "attention_info")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], "shared_bytes": out[3]}


def _operand(t: torch.Tensor, name: str, dtype, dims: int = 4):
    if t.device.type != "cuda":
        raise ValueError(f"attention kernels take CUDA tensors: {name} is "
                         f"on {t.device}; the plain versions are in ref")
    if t.dtype != dtype:
        raise TypeError(f"attention: {name} is {t.dtype}, not {dtype}")
    if t.dim() != dims:
        raise ValueError(f"attention: {name} has shape {tuple(t.shape)}, "
                         f"not {dims} dims")
    return t if t.stride(-1) == 1 else t.contiguous()


def _vec(ts, widths) -> int:
    """16-byte loads: every width a multiple of 8 elements, every stride
    too, every pointer 16-byte aligned."""
    return int(all(w % 8 == 0 for w in widths)
               and all(t.data_ptr() % 16 == 0 and all(
                   s % 8 == 0 for s in t.stride()[:-1]) for t in ts))


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int, scale: float, q_pos=None,
                      kv_mask=None) -> torch.Tensor:
    """The chunked attention in one launch: q (B, Sq, Hq, dh), k (B, Sk,
    Hkv, dh), v (B, Sk, Hkv, dv), one type, bf16 or fp32; KV blocks of
    ``chunk`` slots with the reference's rounding points; ``q_pos`` (Sq,)
    the queries' positions (default 0..Sq-1), ``kv_mask`` (B, Sk) with 1
    = valid.  Returns (B, Sq, Hq, dv) in q's type.  Raises for a CPU
    tensor, a wrong type or shape, a head dim above ``MAX_HEAD_DIM``, or
    a failed launch."""
    dt = q.dtype
    if dt not in _DTYPES:
        raise TypeError(f"attention_chunked takes bf16 or fp32, not {dt}")
    q = _operand(q, "q", dt)
    k = _operand(k, "k", dt)
    v = _operand(v, "v", dt)
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, dh) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention_chunked: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"attention_chunked: {Hq} query heads over {Hkv} "
                         "KV heads")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"attention_chunked: dh {dh}, dv {dv} outside "
                         f"1..{MAX_HEAD_DIM}")
    if chunk < 1:
        raise ValueError(f"attention_chunked: chunk {chunk}")
    dev = q.device
    qp = None
    if q_pos is not None:
        if tuple(q_pos.shape) != (Sq,):
            raise ValueError(f"attention_chunked: q_pos has shape "
                             f"{tuple(q_pos.shape)}, not ({Sq},)")
        qp = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Sk):
            raise ValueError(f"attention_chunked: kv_mask has shape "
                             f"{tuple(kv_mask.shape)}, not ({B}, {Sk})")
        mask = (kv_mask.to(dev) > 0).to(torch.uint8).contiguous()
    o = torch.empty((B, Sq, Hq, dv), dtype=dt, device=dev)
    if B == 0 or Sq == 0:
        return o
    fn = _fn("attention_chunked_launch",
             [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if qp is None else qp.data_ptr(),
                None if mask is None else mask.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], B, Sq, Sk, Hkv, Hq // Hkv, dh, dv,
                int(chunk), int(bool(causal)), float(scale),
                _vec((q, k, v), (dh, dv)), _DTYPES[dt],
                torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, "attention_chunked launch")
    CHUNKED_LAUNCHES.inc()
    return o


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """One-token attention over a KV cache, read in place: q (B, 1, Hq,
    dh), k_cache (B, S, Hkv, dh), v_cache (B, S, Hkv, dv), one type, bf16
    or fp32; slot t of row b valid where t < ``lengths[b]`` (read on the
    device; a row of length 0 gets the uniform softmax over all S slots).
    Returns (B, 1, Hq, dv) in q's type.  Raises for a CPU tensor, a wrong
    type or shape, or a failed launch."""
    dt = q.dtype
    if dt not in _DTYPES:
        raise TypeError(f"attention_decode takes bf16 or fp32, not {dt}")
    q = _operand(q, "q", dt)
    k = _operand(k_cache, "k_cache", dt)
    v = _operand(v_cache, "v_cache", dt)
    B, S, Hkv, dh = k.shape
    Hq, dv = q.shape[2], v.shape[-1]
    if tuple(q.shape) != (B, 1, Hq, dh) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention_decode: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k.shape)}, v_cache {tuple(v.shape)} "
                         "disagree")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"attention_decode: {Hq} query heads over {Hkv} "
                         "KV heads")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"attention_decode: dh {dh}, dv {dv} outside "
                         f"1..{MAX_HEAD_DIM}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"attention_decode: lengths has shape "
                         f"{tuple(lengths.shape)}, not ({B},)")
    dev = q.device
    o = torch.empty((B, 1, Hq, dv), dtype=dt, device=dev)
    if B == 0 or S == 0:
        return o.zero_()
    R = Hq // Hkv
    ns = -(-S // DECODE_SPLIT)
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    sc = torch.empty((B * Hkv * R * S,), dtype=torch.float32, device=dev)
    stats = torch.empty((2, B * Hkv * R * ns), dtype=torch.float32,
                        device=dev)
    part = torch.empty((B * Hkv * R * ns * dv,), dtype=torch.float32,
                       device=dev)
    gl = 1 << max(0, (-(-dh // 8) - 1).bit_length())
    fn = _fn("attention_decode_launch",
             [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 10
             + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lens.data_ptr(), sc.data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), part.data_ptr(), q.stride(0),
                q.stride(2), *k.stride()[:3], *v.stride()[:3], o.stride(0),
                o.stride(2), B, S, Hkv, R, dh, dv, gl, float(scale),
                _vec((q, k, v), (dh, dv)), _DTYPES[dt],
                torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, "attention_decode launch")
    DECODE_LAUNCHES.inc()
    return o
