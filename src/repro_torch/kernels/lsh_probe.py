"""Wrapper of the CUDA kernel of the LSH bottom's probe scan.

Runs the reference's jitted ``lax.scan`` of
``repro/core/two_level.py::_probe_scan_lsh`` (no Pallas kernel there:
XLA's loop over the probe slots) as one launch: the query's sign bits
packed, the live slots of its probed rows staged and walked, each one's
Hamming distance and the stable counting sort cut at the shortlist; the
kernel is ``csrc/lsh_probe.cu``, whose header note gives the order it
keeps, the design and the bound.  This module checks the operands,
allocates the output, launches on PyTorch's current stream and counts
launches.  CUDA tensors only; the plain version is
``ref.lsh_probe_shortlist_ref`` and ``ops.lsh_probe_shortlist_op`` picks
between them by device.

The kernel reads only the columns before each row's extent (``extents``,
(K,) int32: one past the row's last live column; the index passes its
``bucket_counts``, since every mutation keeps a row's live ids in front
of its -1 pads).  A table with a live id at or past its row's extent is
outside the contract.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LaunchCounter

__all__ = ["lsh_probe_shortlist", "stores_distances", "store_bytes",
           "path_of", "kernel_info", "LAUNCHES", "MAX_W",
           "STORE_MAX", "SLOT_STORE", "PSTAGE", "PATHS"]

LAUNCHES = LaunchCounter("lsh_probe")

MAX_W = 8                  # words a code: 256 bits (csrc/lsh_probe.cu)
PSTAGE = 1024              # probe rows a block stages at once
STORE_MAX = 96 * 1024      # bytes of distances a block may keep for P cap
SLOT_STORE = 24 * 1024     # bytes of distances kept above STORE_MAX
# how a query's emit pass reads its distances, by its slot count (path_of)
PATHS = ("distances stored", "recompute")

_fn = None
_info = None


def _launcher():
    global _fn
    if _fn is None:
        f = _build.library("lsh_probe").lsh_probe_launch
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _error_string(rc: int) -> str:
    f = _build.library("lsh_probe").lsh_probe_error_string
    f.argtypes, f.restype = [ctypes.c_int], ctypes.c_char_p
    return f(rc).decode()


def _dist_bytes(w: int) -> int:
    return 2 if w == MAX_W else 1


def stores_distances(p: int, cap: int, w: int) -> bool:
    """Whether a block's slot store holds the distances of any query at P
    probes of ``cap`` columns (a byte a slot, two at W = 8, up to
    ``STORE_MAX`` bytes: DEEP-10M's P 64 x cap 763 fits), so that no
    query recomputes them in its emit pass."""
    return p * cap * _dist_bytes(w) <= STORE_MAX


def store_bytes(p: int, cap: int, w: int) -> int:
    """The bytes of shared memory a block keeps its query's distances in:
    P cap of them where ``stores_distances`` (9,792 B at sift-1m's LSH
    bottom, eight blocks an SM), else ``SLOT_STORE``."""
    if stores_distances(p, cap, w):
        return p * cap * _dist_bytes(w)
    return SLOT_STORE


def path_of(n: int, store: int, w: int) -> str:
    """The emit path of a query with ``n`` slots (the sum of its probed
    rows' extents) in a ``store``-byte slot store (``PATHS``): its
    distances kept, or recomputed."""
    return PATHS[0] if n * _dist_bytes(w) <= store else PATHS[1]


def kernel_info(n_bits: int, p: int, cap: int) -> dict:
    """The built kernel for ``n_bits`` as a launch at P probes of ``cap``
    columns runs it: registers and spilled bytes a thread, resident blocks
    an SM, shared memory a block and the store's bytes."""
    global _info
    if _info is None:
        f = _build.library("lsh_probe").lsh_probe_info
        f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _info = f
    w = -(-n_bits // 32)
    store = store_bytes(p, cap, w)
    out = (ctypes.c_int * 4)()
    rc = _info(n_bits, p, store, out)
    if rc != 0:
        raise RuntimeError(f"lsh_probe_info failed: CUDA error {rc} "
                           f"({_error_string(rc)})")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], "shared_bytes": out[3],
            "store_bytes": store}


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str,
             dims: int = 2) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"lsh_probe takes CUDA tensors: {name} is on "
                         f"{t.device}; the plain version is "
                         "ref.lsh_probe_shortlist_ref")
    if t.dtype != dtype:
        raise TypeError(f"lsh_probe: {name} is {t.dtype}, not {dtype}")
    if t.dim() != dims:
        raise ValueError(f"lsh_probe: {name} has shape {tuple(t.shape)}, "
                         f"not {dims} dim(s)")
    return t.contiguous()


def lsh_probe_shortlist(qproj: torch.Tensor, codes: torch.Tensor,
                        bucket_ids: torch.Tensor, probe: torch.Tensor,
                        shortlist: int, *,
                        extents: torch.Tensor) -> torch.Tensor:
    """The LSH bottom's probe scan in one launch.

    ``qproj`` (B, n_bits) fp32 is queries @ projections (the sign bits
    are ``qproj > 0``), ``codes`` (N, W) int32 the packed corpus codes with
    W = ceil(n_bits / 32) <= 8, ``bucket_ids`` (K, cap) int32 with -1
    pads, ``extents`` (K,) int32 one past each row's last live column (the
    index's ``bucket_counts``; columns at or past it are never read),
    ``probe`` (B, P) int32 bucket ids.  Returns (B, shortlist) int32 ids:
    the ``shortlist`` smallest slots under (distance, probe slot, column),
    -1 past the live slots; equal to the plain chain id for id.  Raises
    for a CPU tensor, a wrong dtype or shape, W above ``MAX_W``, or a
    failed launch.
    """
    S = int(shortlist)
    if S < 0:
        raise ValueError(f"lsh_probe: shortlist {S} is negative")
    qp = _operand(qproj, torch.float32, "qproj")
    c = _operand(codes, torch.int32, "codes")
    bids = _operand(bucket_ids, torch.int32, "bucket_ids")
    pr = _operand(probe, torch.int32, "probe")
    ext = _operand(extents, torch.int32, "extents", dims=1)
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
    if ext.shape[0] != K:
        raise ValueError(f"lsh_probe: extents has {ext.shape[0]} entries "
                         f"for {K} bucket rows")
    if min(N, K, cap, P) < 1 or P * cap >= 2**31:
        raise ValueError(f"lsh_probe: N={N}, K={K}, cap={cap}, P={P}: "
                         "each must be >= 1 and P cap below 2**31")
    if W % 2 == 0 and c.data_ptr() % (16 if W % 4 == 0 else 8):
        c = c.clone()                     # the kernel's vector code loads
    dev = qp.device
    out = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        rc = fn(qp.data_ptr(), c.data_ptr(), bids.data_ptr(), ext.data_ptr(),
                pr.data_ptr(), out.data_ptr(), B, n_bits, N, K, cap, P, S,
                store_bytes(P, cap, W),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lsh_probe launch failed: CUDA error {rc} "
                           f"({_error_string(rc)})")
    LAUNCHES.inc()
    return out
