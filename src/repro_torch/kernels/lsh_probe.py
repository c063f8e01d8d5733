"""Wrapper of the CUDA kernel of the LSH bottom's probe scan.

Runs the reference's jitted ``lax.scan`` of
``repro/core/two_level.py::_probe_scan_lsh`` (no Pallas kernel there:
XLA's loop over the probe slots) as one launch: the query's sign bits
packed, every probed slot's Hamming distance and the stable counting sort
cut at the shortlist; the kernel is ``csrc/lsh_probe.cu``, whose header
note gives the order it keeps, the design and the bound.  This module
checks the operands, allocates the output, launches on PyTorch's current
stream and counts launches.  CUDA tensors only; the plain version is
``ref.lsh_probe_shortlist_ref`` and ``ops.lsh_probe_shortlist_op`` picks
between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LaunchCounter

__all__ = ["lsh_probe_shortlist", "stores_distances", "LAUNCHES", "MAX_W",
           "STORE_MAX"]

LAUNCHES = LaunchCounter("lsh_probe")

MAX_W = 8                  # words a code: 256 bits (csrc/lsh_probe.cu)
STORE_MAX = 96 * 1024      # bytes of distances a block keeps in shared memory

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("lsh_probe").lsh_probe_launch
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def stores_distances(p: int, cap: int, w: int) -> bool:
    """Whether the kernel keeps a query's slot distances in shared memory
    between its passes (a byte a slot, two at W = 8, up to ``STORE_MAX``
    bytes: DEEP-10M's P 64 x cap 763 fits), or recomputes them in its
    emit pass."""
    return p * cap * (2 if w == MAX_W else 1) <= STORE_MAX


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"lsh_probe takes CUDA tensors: {name} is on "
                         f"{t.device}; the plain version is "
                         "ref.lsh_probe_shortlist_ref")
    if t.dtype != dtype:
        raise TypeError(f"lsh_probe: {name} is {t.dtype}, not {dtype}")
    if t.dim() != 2:
        raise ValueError(f"lsh_probe: {name} has shape {tuple(t.shape)}, "
                         "not two dims")
    return t.contiguous()


def lsh_probe_shortlist(qproj: torch.Tensor, codes: torch.Tensor,
                        bucket_ids: torch.Tensor, probe: torch.Tensor,
                        shortlist: int) -> torch.Tensor:
    """The LSH bottom's probe scan in one launch.

    ``qproj`` (B, n_bits) fp32 is queries @ projections (the sign bits
    are ``qproj > 0``), ``codes`` (N, W) int32 the packed corpus codes with
    W = ceil(n_bits / 32) <= 8, ``bucket_ids`` (K, cap) int32 with -1
    pads, ``probe`` (B, P) int32 bucket ids.  Returns (B, shortlist) int32
    ids: the ``shortlist`` smallest slots under (distance, probe slot,
    column), -1 past the live slots; equal to the plain chain id for id.
    Raises for a CPU tensor, a wrong dtype or shape, W above ``MAX_W``, or
    a failed launch.
    """
    S = int(shortlist)
    if S < 0:
        raise ValueError(f"lsh_probe: shortlist {S} is negative")
    qp = _operand(qproj, torch.float32, "qproj")
    c = _operand(codes, torch.int32, "codes")
    bids = _operand(bucket_ids, torch.int32, "bucket_ids")
    pr = _operand(probe, torch.int32, "probe")
    B, n_bits = qp.shape
    N, W = c.shape
    K, cap = bids.shape
    P = pr.shape[1]
    if -(-n_bits // 32) != W:
        raise ValueError(f"lsh_probe: {n_bits} bits need "
                         f"{-(-n_bits // 32)} words a code, codes have {W}")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"lsh_probe: W={W} outside the kernel's range "
                         f"1..{MAX_W}")
    if pr.shape[0] != B:
        raise ValueError(f"lsh_probe: probe has {pr.shape[0]} rows for "
                         f"{B} queries")
    if min(N, K, cap, P) < 1 or P * cap >= 2**31:
        raise ValueError(f"lsh_probe: N={N}, K={K}, cap={cap}, P={P}: "
                         "each must be >= 1 and P cap below 2**31")
    dev = qp.device
    out = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(qp.data_ptr(), c.data_ptr(), bids.data_ptr(), pr.data_ptr(),
                out.data_ptr(), B, n_bits, N, K, cap, P, S,
                int(stores_distances(P, cap, W)),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lsh_probe launch failed: CUDA error {rc}")
    LAUNCHES.inc()
    return out
