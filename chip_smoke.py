#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100, and check it.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over;
each prints its wall time as ``[phase] <name> <s> s``):

1. card    - name, count, versions, ``nvidia-smi`` name and power limit;
2. build   - build the five CUDA sources (seven kernels) from
             ``src/repro_torch/kernels/csrc`` in parallel and print the
             ``-Xptxas -v`` register/shared/spill lines;
3. edges   - each kernel against its plain version on the edge shapes that
             ``tests/test_kernels.py`` pins (for the option kernels, the
             index kernels and the probe chain, the tables in
             ``repro_torch.testing``, shared with the card tests), plus
             the hybrid alpha = 0 / 1 identities; every
             hybrid answer, here and later, is also held by its two
             halves (``testing.hybrid_by_parts``); the same tables at
             k = 33, 64, 65 and 100 and at k = N (the kernels' passes
             above their lists' length), ``l2_topk`` at d = 960 and
             ``l2_topk_int8`` at d = 640 and 1,000;
4. shapes  - each kernel against its plain version at the main path's
             shapes, on the backends' own operands, timed beside its bound,
             the plain version and a PyTorch yardstick (which the port
             never calls); ``candidate_topk`` as one probe step and as the
             whole served chain (B 64, nprobe 32, also held bit for bit
             against the rows read by id and 32 per-step launches);
5. serve   - sift-1m width: 1M x 128 corpus, 8,192 k-means buckets built on
             the card, IVF (nprobe 32, k 10) behind a ``ServingCell``
             answering 2,048 requests from 16 client threads, the exact
             brute backend for recall@10, the unfused IVF path for
             parity, and the chain against 32 per-step launches bit for
             bit on every served batch; launch counts are reset just
             before and read just after the served run;
6. options - the same corpus with a ``pct`` metadata column and BM25
             postings slabs of synthetic entity text: a brute cell (f32,
             2,048 requests over four option sets: semantic filtered at
             selectivity 0.05, lexical, lexical filtered at 0.5, hybrid
             alpha 0.5), a filtered IVF cell (1,024 requests at 0.05 and
             0.5) and an int8 brute cell (1,024 requests); counts reset
             just before and read just after the three cells; answers held
             against the filters, the unfused path and direct backend calls;
7. large k - every kernel with a list ceiling at k = 33, 64, 65, 100 at
             the main path's shapes on the backends' operands, against
             its plain version; its passes and time at k = 100 beside
             k = 10;
8. profile - ``torch.profiler`` over 8 batches of 64 per backend and mode
             (device time by kernel, busy share);
9. index   - the paper's index layer through ``build_index`` /
             ``auto_build_index`` and ``search``: DEEP-10M (10M x 96,
             32,768 buckets, PQ top, brute bottom; recall@10 against the
             exact top-10 of the ``l2_topk`` kernel at nprobe 8-64), the
             sift-1m corpus with a PQ top over brute, LSH and tree bottoms
             and the one-level ``lsh_search`` (96 bits, shortlists of 64 to
             1,024), and RADIO-STATION (10K x 256) where §5.3 picks QLBT
             with traffic and the balanced tree without; ``pq_adc_topk``
             and ``hamming_topk`` held against their plain versions and
             timed at those shapes (their yardsticks at k = 64 too; PQ at
             k = 100 in two passes), ``SearchIndex.search`` at k = 100 on
             the sift two-level index (recall@100), the
             DEEP brute bottom's probe chain (``candidate_topk``, rows by
             entity id) against its plain version and float64 and timed;
             counts reset just before and read just after each of the
             three runs;
10. forest serve - the sift tree-bottom index (8,192 buckets, leaf 8)
             through ``ServingCell.sharded(kind="auto")`` (the forest
             kind: nprobe 32, beam 8, k 10), 2,048 requests from 16
             clients, recall@10 against the exact top-10; counts reset just
             before and read just after; fused against unfused on every
             batch (near-ties recomputed in float64, repeats counted);
             filtered at 0.05 and 0.5; k = 50; a stage profile of one
             batch; ``candidate_topk``'s rows-by-id entry at the served
             shape (B 64, C 2,048, d 128) against its plain version, timed
             beside its bound, the library yardstick and the gathered tile;
11. lifecycle - a copy of that index (brute top): add 10,000 entities
             with metadata rows, delete 10,000, ``refresh_forest``,
             ``reboost`` (unbalance 0.23), ``rebalance``; after each,
             ``pop_delta`` and ``apply_updates(delta=...)`` on forest, IVF
             and brute backends, each held bit for bit (tables, answers)
             against a full re-place, the bucket-local steps required to
             ship a delta in place (same storage), no deleted id ever
             returned, every added vector its own rank 1;
12. sharded - the sharded search over a ``torch.distributed`` mesh at the
             same width: under a world-size-1 NCCL group the brute, IVF
             (nprobe 32) and forest backends built with a mesh, and one
             served batch through ``ServingCell.sharded(mesh=...)``,
             against the backends built without one, bit for bit (counts
             reset just before and read just after each meshed run); the
             all-gather timed by CUDA events; p50 of 1,024 requests
             through a cell with and without the mesh.  Then four ranks
             sharing the card under gloo (spawned; the parent builds the
             kernels and hands the ranks its index arrays through a file):
             brute, IVF and forest at 8 probes a shard on a ``(4,)`` mesh
             over ``("data",)``, and on the same mesh the options (brute
             filtered at 0.05, int8, lexical filtered at 0.5, hybrid, IVF
             filtered at 0.5), brute on a ``(2, 2)`` mesh with
             ``query_axes=("model",)`` at B = 37; every answer against the
             parent's single-process shard loop on the card bit for bit,
             each flat scan also against the one-shard backend; recall@10
             and each rank's launches (counts reset just before and read
             just after each case's run);
13. the ``kernels`` JSON line, the ``nvidia-smi`` line and the ``ok`` line.

The serve phase also runs the brute and IVF backends at k = 50 (above the
kernels' 32-pair lists) against their unfused plain paths.

Imports only ``torch``, numpy and ``repro_torch``.  Detailed results also
go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs.ann_corpora import (DEEP_10M,  # noqa: E402
                                             RADIO_STATION, SIFT_1M)
from repro_torch.core.brute import batched_l2sq, pairwise_l2sq  # noqa: E402
from repro_torch.core.index import (auto_build_index,  # noqa: E402
                                    build_index)
from repro_torch.core.likelihood import (beta_for_unbalance,  # noqa: E402
                                         sample_queries)
from repro_torch.core.lsh import (lsh_build, lsh_search,  # noqa: E402
                                  pack_bits)
from repro_torch.core.pq import adc_lut  # noqa: E402
from repro_torch.core.protocol import (IndexSpec,  # noqa: E402
                                       select_index_spec)
from repro_torch.core.tree import tree_search  # noqa: E402
from repro_torch.core.lexical import (build_lexical_slabs_flat,  # noqa: E402
                                      query_operands)
from repro_torch.core.metadata import FilterSpec, MetadataTable  # noqa: E402
from repro_torch.core.metrics import LatencyTimer, recall_at_k  # noqa: E402
from repro_torch.core.two_level import (TwoLevelConfig,  # noqa: E402
                                        build_forest, build_two_level)
from repro_torch.data.synthetic import make_corpus, make_queries  # noqa: E402
from repro_torch.distributed.backend import ShardedSearchBackend  # noqa: E402
from repro_torch.kernels import (_build, bm25, bucket_topk,  # noqa: E402
                                 hamming, l2_topk, ops, pq_adc, ref)
from repro_torch.kernels.common import (LAUNCH_COUNTERS,  # noqa: E402
                                        merge_topk, stable_topk)
from repro_torch.obs.trace import Tracer, set_tracer  # noqa: E402
from repro_torch.serve.cell import ServingCell  # noqa: E402
from repro_torch.testing import (CHAIN_EDGES, EDGE_ALPHAS,  # noqa: E402
                                 HAMMING_EDGES, OPTION_EDGES, PQ_EDGES,
                                 ROWS_EDGES, chain_edge_operands,
                                 chain_union_topk, hamming_edge_operands,
                                 hybrid_by_parts, option_edge_operands,
                                 pq_edge_operands, rows_edge_operands,
                                 rows_union_topk, shard_backends,
                                 shard_loop, step_chain)

# Published H100 SXM peaks (NVIDIA data sheet): HBM3, fp32 outside the
# tensor cores, and dense TF32 on them.  Every kernel computes in fp32 FMA;
# the fp32 L2 tile (l2_topk, hybrid_topk) also reports the bound of the
# tensor-core route it did not ship (3xTF32: three TF32 products a
# multiply-add), whose distances broke the options cells' parity floor.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
# Results a clock on each SM of compute capability 9.0 (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table): population
# count, and 32-bit integer add and bitwise operations.
POPC_PER_CLOCK_SM = 16
INT_PER_CLOCK_SM = 64
# Distances may differ by fp32 rounding, since the kernel and the plain
# version sum in another order: |d_kernel - d_plain| <= REL * (qn + xn).
REL = 1e-5
K = 10
BATCH = 64
N_REQUESTS = 2048
N_CLIENTS = 16
OUT_DIR = os.path.join(ROOT, "build")
# options phase: 2,048 brute requests over four option sets, 1,024 each
# through the filtered IVF and the int8 cells
N_IVF_OPTION_REQUESTS = 1024
N_INT8_REQUESTS = 1024
# synthetic entity text: a 50,000-term vocabulary with Zipf-like term
# frequencies (rank^-1.1), 6-12 tokens a document, 16 slab slots (the
# build_lexical_slabs default), 8 query term slots (query_operands')
VOCAB = 50_000
ZIPF_S = 1.1
DOC_TOKENS = (6, 12)
SLOTS = 16
Q_SLOTS = 8
ALPHA = 0.5
# the kernels the options phase's three cells run
OPTION_KERNELS = ("l2_topk", "l2_topk_int8", "bm25_topk", "hybrid_topk")
NARROW = FilterSpec.range("pct", 0, 4)       # selectivity 0.05
WIDE = FilterSpec.range("pct", 0, 49)        # selectivity 0.5
# index phase: query chunks of 1,024 (``TwoLevelIndex.search``'s default);
# fig2d_deep.py's nprobe sweep; Table 1's LSH bits (64 in a bucket, 96 flat)
# and shortlists; the paper's real-traffic unbalance (§4.2) and fig1's beam
# sweep and recall target
INDEX_QUERIES = 1024
DEEP_NPROBES = (8, 16, 32, 64)
SIFT_NPROBE = 32
BEAM = 8
BUCKET_LSH_BITS = 64
FLAT_LSH_BITS = 96
LSH_CANDIDATES = (64, 256, 1024)
RADIO_UNBALANCE = 0.23
RADIO_QUERIES = 2000
RADIO_BEAMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
RADIO_RECALL = 0.95
# k above the kernels' 32-pair lists (64 for PQ): served in passes
LARGE_KS = (33, 64, 65, 100)
K_LARGE = 100
K_BACKEND_LARGE = 50
# no-op kernels each profiler session launches first, to take the loss of a
# late session's first GPU records (profile_window)
LEAD_KERNELS = 2000

RESULTS: dict = {"kernels": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


class phase:
    """Prints ``[phase] <name> <wall s> s`` when the block ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        RESULTS.setdefault("phase_s", {})[self.name] = dt
        log(f"[phase] {self.name} {dt:.1f} s")


def reset_launches() -> None:
    for c in LAUNCH_COUNTERS.values():
        c.reset()


def read_launches() -> dict:
    return {name: c.count for name, c in LAUNCH_COUNTERS.items()}


# --------------------------------------------------------------- phase 1
def phase_card() -> dict:
    if not torch.cuda.is_available():
        raise CheckFailed("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[card] {card}")
    RESULTS["card"] = card
    return card


# --------------------------------------------------------------- phase 2
def _kernel_name(mangled: str) -> str:
    """``l2_tile_scan<Int8Rows, float4, bounded>`` or ``hamming_count<3>``
    from a mangled kernel name (``bounded``: the instantiation for a pass
    with a bound; 3: the words a code)."""
    last = re.search(r"Lb([01])EEEv", mangled)
    suffix = ", bounded" if last and last.group(1) == "1" else ""
    tile = re.search(r"l2_tile_scanINS_\d+(\w+?Rows)ELb(\d)ELb(\d)E", mangled)
    if tile:
        rows, vec, _ = tile.groups()
        return (f"l2_tile_scan<{rows}, {'float4' if vec == '1' else 'scalar'}"
                f"{suffix}>")
    name = re.search(r"(bm25_topk_partial|warp_merge_partials|"
                     r"candidate_scan|candidate_merge|pq_adc_scan|"
                     r"hamming_count|hamming_offsets|hamming_emit)", mangled)
    rows = re.search(r"(F32Rows|Int8Rows|HybridRows)", mangled)
    kt = re.search(r"Li(\d+)E", mangled)
    if name and name.group(1) == "candidate_scan":
        vec, ind = re.search(r"ILb(\d)ELb(\d)E", mangled).groups()
        return (f"candidate_scan<{'float4' if vec == '1' else 'scalar'}, "
                f"{'IndirectRows' if ind == '1' else 'direct rows'}{suffix}>")
    if name and name.group(1) == "candidate_merge":
        return f"candidate_merge{'<bounded>' if suffix else ''}"
    if name and name.group(1) == "hamming_offsets":
        return name.group(1)
    if not (name and kt):
        return mangled[-60:]
    return (f"{name.group(1)}<{rows.group(1) + ', ' if rows else ''}"
            f"{kt.group(1)}{suffix}>")


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    total = time.perf_counter() - t0
    for name, info in logs.items():
        log(f"[build] {name}: nvcc {info['seconds']:.1f} s")
        entry = ""
        for line in info["ptxas"]:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = _kernel_name(m.group(1))
            elif any(w in line for w in ("registers", "spill")):
                log(f"[build]   {entry}: {line.split(':', 1)[-1].strip()}")
    log(f"[build] total {total:.1f} s (parallel nvcc)")
    RESULTS["build_s"] = total


# ------------------------------------------------------------ comparisons
def compare(name: str, kd, ki, pd, pi, scale, vec_of=None, q=None) -> dict:
    """Kernel (kd, ki) against plain (pd, pi): the same sentinel slots;
    |kd - pd| <= REL * scale everywhere; ids equal except at near-ties
    (slots whose two distances agree within that tolerance).  With
    ``vec_of``, each kernel id's distance is also recomputed in float64
    and held to the same tolerance, so a wrong id cannot hide behind a
    right distance."""
    kd, ki, pd, pi = (t.detach().cpu().numpy() for t in (kd, ki, pd, pi))
    scale = np.asarray(scale, np.float64)
    require(kd.shape == pd.shape and ki.shape == pi.shape,
            f"{name}: shape {kd.shape} vs {pd.shape}")
    kinf, pinf = ~np.isfinite(kd), ~np.isfinite(pd)
    require(np.array_equal(kinf, pinf), f"{name}: sentinel slots differ")
    require((ki[kinf] == -1).all() and (pi[pinf] == -1).all(),
            f"{name}: an inf slot carries an id")
    fin = ~pinf
    tol = REL * scale
    err = np.abs(np.where(fin, kd, 0.0).astype(np.float64)
                 - np.where(fin, pd, 0.0))
    require((err <= tol).all(),
            f"{name}: distance error {err.max(initial=0.0)} above tolerance")
    diff = ki != pi
    near = diff & (err <= tol)
    require(not (diff & ~near).any(), f"{name}: ids differ off a near-tie")
    if vec_of is not None:
        qq = q.detach().cpu().numpy().astype(np.float64)
        for b, j in zip(*np.nonzero(fin)):
            v = vec_of(b, ki[b, j]).astype(np.float64)
            d64 = float(((qq[b] - v) ** 2).sum())
            require(abs(d64 - kd[b, j]) <= tol[b, j],
                    f"{name}: id {ki[b, j]} has distance {kd[b, j]}, "
                    f"float64 gives {d64}")
    rel = np.where(fin, err / np.maximum(scale, 1e-30), 0.0)
    out = {"ids_match": float((~diff).mean()) if diff.size else 1.0,
           "near_ties": int(near.sum()),
           "max_abs_err": float(err.max(initial=0.0)),
           "max_rel_err": float(rel.max(initial=0.0))}
    log(f"[{name}] {out}")
    return out


def _norms(t):
    return (t.double() * t.double()).sum(-1)


def check_l2(name, q, x, k, valid=None) -> dict:
    kd, ki = l2_topk.l2_topk(q, x, k, valid=valid)
    pd, pi = ref.l2_topk_ref(q, x, k, valid=valid)
    torch.cuda.synchronize()
    xn = _norms(x).cpu().numpy()
    qn = _norms(q).cpu().numpy()
    scale = qn[:, None] + xn[np.maximum(pi.cpu().numpy(), 0)]
    xh = x.cpu().numpy()
    return compare(name, kd, ki, pd, pi, scale,
                   vec_of=lambda b, i: xh[i], q=q)


def check_cand(name, q, vecs, ids, k, best_d=None, best_i=None,
               plain=None) -> dict:
    kd, ki = bucket_topk.candidate_topk(q, vecs, ids, k, best_d=best_d,
                                        best_i=best_i)
    if plain is None:
        pd, pi = ref.candidate_topk_ref(q, vecs, ids, k, best_d=best_d,
                                        best_i=best_i)
    else:
        pd, pi = plain
    torch.cuda.synchronize()
    qn = _norms(q).cpu().numpy()
    vmax = _norms(vecs).amax(dim=1).cpu().numpy()
    scale = (qn + vmax)[:, None] * np.ones((1, k))
    return compare(name, kd, ki, pd, pi, scale)


def require_bits(name, a, b) -> None:
    """Two (dists, ids) answers equal bit for bit."""
    torch.cuda.synchronize()
    require(torch.equal(a[1], b[1]), f"{name}: ids differ")
    require(torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)),
            f"{name}: distance bits differ")


def check_rows(name, q, rows, ids, k, plain=None) -> dict:
    """The tile read by row id against its plain version (or ``plain``),
    each returned pair's distance recomputed in float64 from ``rows``, and
    bit for bit against the tile entry on the gathered rows (the same
    arithmetic, the same segments)."""
    kd, ki = bucket_topk.candidate_rows_topk(q, rows, ids, k)
    live = torch.where((ids >= 0) & (ids < rows.shape[0]), ids, -1)
    require_bits(f"{name} (tile entry on the gathered rows)", (kd, ki),
                 bucket_topk.candidate_topk(
                     q, rows[live.clamp(min=0).long()].contiguous(), live, k))
    pd, pi = plain if plain is not None else ref.candidate_rows_topk_ref(
        q, rows, ids, k)
    torch.cuda.synchronize()
    scale = (_norms(q).cpu().numpy() + float(_norms(rows).max()))[:, None] \
        * np.ones((1, k))
    return compare(name, kd, ki, pd, pi, scale,
                   vec_of=lambda b, i: rows[int(i)].cpu().numpy(), q=q)


def check_chain(name, q, probe, bids, k, db, *, bvecs=None,
                plain=None) -> dict:
    """The probe chain entry against its plain version (or ``plain``),
    each returned pair's distance recomputed in float64 from ``db``.  With
    ``bvecs`` the chain reads rows by slot and is also held bit for bit
    against the rows read by id and against the chain of per-step
    launches."""
    src = {"db": db} if bvecs is None else {"bucket_vecs": bvecs}
    kd, ki = bucket_topk.bucket_probe_topk(q, probe, bids, k, **src)
    if bvecs is not None:
        require_bits(f"{name} (rows by id)", (kd, ki),
                     bucket_topk.bucket_probe_topk(q, probe, bids, k, db=db))
        require_bits(f"{name} (per-step chain)", (kd, ki),
                     step_chain(q, probe, bids, bvecs, k))
    pd, pi = plain if plain is not None else ref.bucket_probe_topk_ref(
        q, probe, bids, k, **src)
    torch.cuda.synchronize()
    xh = db.cpu().numpy()
    scale = (_norms(q).cpu().numpy() + float(_norms(db).max()))[:, None] \
        * np.ones((1, k))
    return compare(name, kd, ki, pd, pi, scale, vec_of=lambda b, i: xh[i],
                   q=q)


def _deq_rows(codes, scales):
    """``rows(ids)``: the dequantized rows ``scale * codes`` of any id
    array, in float64 on the host."""
    c = codes.cpu().numpy()
    sc = scales.cpu().numpy().astype(np.float64)
    return lambda ids: c[ids].astype(np.float64) * sc[ids][..., None]


def check_int8(name, q, codes, scales, k, valid=None) -> dict:
    """The int8 kernel against its plain version; each kernel id's
    distance is recomputed in float64 against its dequantized row."""
    kd, ki = l2_topk.l2_topk_int8(q, codes, scales, k, valid=valid)
    pd, pi = ref.l2_topk_int8_ref(q, codes, scales, k, valid=valid)
    torch.cuda.synchronize()
    rows = _deq_rows(codes, scales)
    qn = _norms(q).cpu().numpy()
    scale = qn[:, None] + (rows(np.maximum(pi.cpu().numpy(), 0)) ** 2).sum(-1)
    return compare(name, kd, ki, pd, pi, scale,
                   vec_of=lambda b, i: rows(i), q=q)


def _lex_scale(pd) -> np.ndarray:
    """BM25 distances are rounded sums of score terms: REL of |score|,
    with a floor of 1."""
    return np.maximum(np.abs(np.nan_to_num(pd.cpu().numpy(), posinf=0.0)),
                      1.0)


def check_bm25(name, qt, qw, terms, tf, k, valid=None,
               exact: bool = True) -> dict:
    """``exact``: slab rows hold distinct terms, so each hit sum has one
    non-zero term and the kernel's ids and distances equal the plain
    version's bit for bit (-0.0 included)."""
    kd, ki = bm25.bm25_topk(qt, qw, terms, tf, k, valid=valid)
    pd, pi = ref.bm25_topk_ref(qt, qw, terms, tf, k, valid=valid)
    torch.cuda.synchronize()
    out = compare(name, kd, ki, pd, pi, _lex_scale(pd))
    if exact:
        require(torch.equal(ki, pi) and torch.equal(
            kd.view(torch.int32), pd.view(torch.int32)),
            f"{name}: not bitwise equal to the plain version")
    return out


def require_by_parts(name, q, x, qt, qw, terms, tf, alpha, kd, ki) -> dict:
    """A hybrid answer equals ``a * d2 - (1 - a) * score`` bit for bit on
    every returned pair, with ``d2`` the fp32 L2 kernel's and ``score``
    the kernels' float32 BM25 order; ``d2`` within REL of float64 and the
    score within its rounding bound of float64."""
    parts = hybrid_by_parts(q, x, qt, qw, terms, tf, alpha, kd, ki)
    require(parts["mismatches"] == 0,
            f"{name}: {parts['mismatches']} of {parts['pairs']} distances "
            "are not alpha d2 - (1 - alpha) score")
    require(parts["l2_max_rel_err"] <= REL,
            f"{name}: an L2 half is off float64: {parts}")
    require(parts["lex_max_rel_err"] <= parts["lex_bound"],
            f"{name}: a BM25 half is off float64: {parts}")
    return parts


def check_hybrid(name, q, x, qt, qw, terms, tf, alpha: float, k,
                 valid=None) -> dict:
    a = torch.full((1, 1), alpha, dtype=torch.float32, device=q.device)
    kd, ki = bm25.hybrid_topk(q, x, qt, qw, terms, tf, a, k, valid=valid)
    pd, pi = ref.hybrid_topk_ref(q, x, qt, qw, terms, tf, a, k,
                                 valid=valid)
    torch.cuda.synchronize()
    xn = _norms(x).cpu().numpy()
    qn = _norms(q).cpu().numpy()
    scale = (alpha * (qn[:, None] + xn[np.maximum(pi.cpu().numpy(), 0)])
             + (1.0 - alpha) * _lex_scale(pd))
    out = compare(name, kd, ki, pd, pi, scale)
    # the tolerance above is loose enough at sift magnitudes to hide the
    # whole lexical half: hold each returned pair's two halves apart
    out["by_parts"] = require_by_parts(name, q, x, qt, qw, terms, tf,
                                       alpha, kd, ki)
    # the limits: alpha = 0 is the BM25 kernel's answer (by value: an
    # unmatched row is 0 * d2 - 0, +0.0 or -0.0), alpha = 1 the fp32 L2
    # kernel's (the same tile code), both on every slot
    if alpha in (0.0, 1.0):
        od, oi = (bm25.bm25_topk(qt, qw, terms, tf, k, valid=valid)
                  if alpha == 0.0 else l2_topk.l2_topk(q, x, k, valid=valid))
        torch.cuda.synchronize()
        require(torch.equal(ki, oi) and torch.equal(kd, od),
                f"{name}: the alpha = {alpha} identity does not hold")
    return out


def edges_options(dev) -> int:
    """int8, BM25 and hybrid on the shared edge shapes
    (``repro_torch.testing.OPTION_EDGES``, each with distinct and with
    repeated slab terms); returns near-ties."""
    near = 0
    for case in OPTION_EDGES:
        for repeat in (False, True):
            o = option_edge_operands(case, repeat)
            q, x, qt, qw, terms, tf, valid = (
                None if o[n] is None else torch.as_tensor(o[n], device=dev)
                for n in ("q", "x", "qt", "qw", "terms", "tf", "valid"))
            k, name = o["k"], case[0]
            tag = "repeated slab terms" if repeat else "distinct"
            if not repeat:     # int8 reads no slabs: once per shape
                codes, scales = (torch.as_tensor(a, device=dev)
                                 for a in ops.quantize_rows_int8(o["x"]))
                near += check_int8(f"edge int8 {name}", q, codes, scales, k,
                                   valid)["near_ties"]
            lex = (qt, qw, terms, tf)
            near += check_bm25(f"edge bm25 {name} {tag}", *lex, k, valid,
                               exact=not repeat)["near_ties"]
            for alpha in EDGE_ALPHAS:
                near += check_hybrid(f"edge hybrid {name} {tag} a={alpha}",
                                     q, x, *lex, alpha, k,
                                     valid)["near_ties"]
    return near


def edges_chain(dev) -> int:
    """The probe chain on the shared edge shapes
    (``repro_torch.testing.CHAIN_EDGES``): both row sources, the chain of
    per-step launches, and the plain version (for a repeated probe,
    ``chain_union_topk``: the plain loop keeps both copies); returns
    near-ties."""
    near = 0
    for case in CHAIN_EDGES:
        o = chain_edge_operands(case)
        q, db, bids, bvecs, probe = (torch.as_tensor(o[n], device=dev)
                                     for n in ("q", "db", "bucket_ids",
                                               "bucket_vecs", "probe"))
        k = o["k"]
        plain = (chain_union_topk(q, probe, bids, db, k)
                 if case[-1] == "repeat" else None)
        near += check_chain(f"edge chain {case[0]}", q, probe, bids, k, db,
                            bvecs=bvecs, plain=plain)["near_ties"]
    return near


def edges_rows(dev) -> int:
    """The tile read by row id on the shared edge shapes
    (``repro_torch.testing.ROWS_EDGES``) at their k and at k = 33, 64, 65
    and 100: the plain version, or for a list that repeats ids
    ``rows_union_topk`` (the plain gather keeps both copies); returns
    near-ties."""
    near = 0
    for case in ROWS_EDGES:
        o = rows_edge_operands(case)
        q, rows, ids = (torch.as_tensor(o[n], device=dev)
                        for n in ("q", "rows", "ids"))
        for k in (o["k"],) + LARGE_KS:
            plain = (rows_union_topk(q, rows, ids, k)
                     if case[-1] == "repeat" else None)
            near += check_rows(f"edge rows k={k} {case[0]}", q, rows, ids, k,
                               plain=plain)["near_ties"]
    return near


def check_bitwise(name, kd, ki, pd, pi) -> dict:
    """Kernel (kd, ki) equal to its plain version (pd, pi) bit for bit:
    the PQ kernel sums in the plain version's order, and Hamming distances
    are whole numbers, so ties included, ids and distances agree."""
    torch.cuda.synchronize()
    require(kd.shape == pd.shape and torch.equal(ki, pi),
            f"{name}: ids differ from the plain version")
    require(torch.equal(kd.view(torch.int32), pd.view(torch.int32)),
            f"{name}: distances differ from the plain version")
    fin = torch.isfinite(pd)
    err = float((kd[fin].double() - pd[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    out = {"ids_match": 1.0, "near_ties": 0, "max_abs_err": err,
           "max_rel_err": 0.0}
    log(f"[{name}] {out}")
    return out


def check_pq(name, lut, codes, k, valid=None) -> dict:
    kd, ki = pq_adc.pq_adc_topk(lut, codes, k, valid=valid)
    pd, pi = ref.pq_adc_topk_ref(lut, codes, k, valid=valid)
    return check_bitwise(name, kd, ki, pd, pi)


def check_hamming(name, qcodes, codes, k, valid=None) -> dict:
    kd, ki = hamming.hamming_topk(qcodes, codes, k, valid=valid)
    pd, pi = ref.hamming_topk_ref(qcodes, codes, k, valid=valid)
    return check_bitwise(name, kd, ki, pd, pi)


def edges_index(dev) -> None:
    """PQ-ADC and Hamming on the shared edge shapes
    (``repro_torch.testing.PQ_EDGES`` / ``HAMMING_EDGES``)."""
    def t(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    for case in PQ_EDGES:
        lut, codes, valid, k = pq_edge_operands(case)
        check_pq(f"edge pq_adc {case[0]}", t(lut), t(codes), k, t(valid))
    for case in HAMMING_EDGES:
        q, codes, valid, k = hamming_edge_operands(case)
        check_hamming(f"edge hamming {case[0]}", t(q), t(codes), k,
                      t(valid))


# --------------------------------------------------------------- phase 3
def phase_edges(dev) -> None:
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def case(b, n, d):
        return (t(rng.normal(size=(b, d)).astype(np.float32)),
                t(rng.normal(size=(n, d)).astype(np.float32)))

    near = 0
    q, x = case(1, 100, 8)
    near += check_l2("edge l2 B=1", q, x, 5)["near_ties"]
    q, x = case(4, 77, 8)
    near += check_l2("edge l2 N%tile!=0", q, x, 5)["near_ties"]
    q, x = case(3, 6, 8)
    near += check_l2("edge l2 k>N", q, x, 10)["near_ties"]
    q, x = case(4, 50, 8)
    near += check_l2("edge l2 all dead", q, x, 5,
                     valid=t(np.zeros(50, np.int32)))["near_ties"]
    q, x = case(6, 120, 8)
    near += check_l2("edge l2 partial valid", q, x, 7,
                     valid=t((rng.random(120) > .5).astype(np.int32))
                     )["near_ties"]
    base = rng.normal(size=(25, 8)).astype(np.float32)
    x = t(np.concatenate([base, base]))
    q = t(base[:5] + 0.01 * rng.normal(size=(5, 8)).astype(np.float32))
    near += check_l2("edge l2 duplicate rows", q, x, 9)["near_ties"]
    q, x = case(70, 5000, 128)
    near += check_l2("edge l2 two query tiles, splits", q, x, 32,
                     valid=t((rng.random(5000) > .3).astype(np.int32))
                     )["near_ties"]

    B, C, D, k = 5, 37, 8, 6
    q = t(rng.normal(size=(B, D)).astype(np.float32))
    vecs = t(rng.normal(size=(B, C, D)).astype(np.float32))
    ids_np = rng.integers(0, 500, size=(B, C)).astype(np.int32)
    ids_np[:, ::5] = -1
    ids = t(ids_np)
    near += check_cand("edge cand dead slots", q, vecs, ids, k)["near_ties"]
    near += check_cand("edge cand k>C", q, vecs[:, :20].contiguous(),
                       ids[:, :20].contiguous(), 24)["near_ties"]
    bd = t(np.sort(rng.random((B, k)).astype(np.float32) * .5, axis=1))
    bi = t(rng.integers(1000, 2000, size=(B, k)).astype(np.int32))
    vecs2 = t(rng.normal(size=(B, C, D)).astype(np.float32))
    ids2 = t(rng.integers(0, 500, size=(B, C)).astype(np.int32))
    near += check_cand("edge cand carried best", q, vecs2, ids2, k,
                       best_d=bd, best_i=bi)["near_ties"]
    near += check_cand("edge cand all dead", q, vecs,
                       torch.full((B, C), -1, dtype=torch.int32, device=dev),
                       4)["near_ties"]
    # a candidate duplicated with an identical distance is emitted once:
    # held against merge_topk, the plain statement of the kernel's rule
    vd = vecs2.clone()
    vd[:, 1::2] = vd[:, 0:-1:2]
    idd = torch.arange(C, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    idd[:, 1::2] = idd[:, 0:-1:2]
    sent = (torch.full((B, k), float("inf"), device=dev),
            torch.full((B, k), -1, dtype=torch.int32, device=dev))
    plain = merge_topk(*sent, batched_l2sq(vd, q), idd, k)
    plain = (plain[0], torch.where(torch.isinf(plain[0]), -1, plain[1]))
    near += check_cand("edge cand duplicate ids", q, vd, idd, k,
                       plain=plain)["near_ties"]
    near += edges_chain(dev)
    near += edges_rows(dev)
    near += edges_options(dev)
    edges_index(dev)
    # d = 960: the staged chunks carry any d (the old tile refused d > 512)
    q, x = case(9, 2000, 960)
    for k in (K, K_LARGE):
        near += check_l2(f"edge l2 d=960 k={k}", q, x, k,
                         valid=t((rng.random(2000) > .2).astype(np.int32))
                         )["near_ties"]
    # int8 rows past d = 512 (the first tile loop refused them), with dead
    # rows; d = 1,000 also takes the byte copies (d % 16 != 0)
    for d in (640, 1000):
        q = t(rng.normal(size=(9, d)).astype(np.float32))
        codes, scales = (t(a) for a in ops.quantize_rows_int8(
            rng.normal(size=(2000, d)).astype(np.float32)))
        for k in (K, K_LARGE):
            near += check_int8(f"edge int8 d={d} k={k}", q, codes, scales, k,
                               t((rng.random(2000) > .2).astype(np.int32))
                               )["near_ties"]
    near += edges_large_k(dev)
    log(f"[edges] all edge shapes agree; near-ties {near}")
    RESULTS["edge_near_ties"] = near


def edges_large_k(dev) -> int:
    """The edge tables above the kernels' lists: every option edge
    (distinct-term slabs: BM25 bit for bit), chain edge and PQ edge at
    k = 33, 64, 65 and 100, the candidate tile with a carried best of k
    pairs, and k = N on small edges; returns near-ties."""
    def t(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    near = 0
    for case in OPTION_EDGES:
        o = option_edge_operands(case, False)
        q, x, qt, qw, terms, tf, valid = (t(o[n]) for n in (
            "q", "x", "qt", "qw", "terms", "tf", "valid"))
        codes, scales = (t(a) for a in ops.quantize_rows_int8(o["x"]))
        ks = LARGE_KS + ((x.shape[0],) if case[0] == "N%tile!=0" else ())
        for k in ks:
            tag = f"large k={k} {case[0]}"
            near += check_l2(f"edge l2 {tag}", q, x, k, valid)["near_ties"]
            near += check_int8(f"edge int8 {tag}", q, codes, scales, k,
                               valid)["near_ties"]
            near += check_bm25(f"edge bm25 {tag}", qt, qw, terms, tf, k,
                               valid)["near_ties"]
            near += check_hybrid(f"edge hybrid {tag}", q, x, qt, qw, terms,
                                 tf, 0.5, k, valid)["near_ties"]
    for case in CHAIN_EDGES:
        o = chain_edge_operands(case)
        q, db, bids, bvecs, probe = (t(o[n]) for n in (
            "q", "db", "bucket_ids", "bucket_vecs", "probe"))
        for k in LARGE_KS:
            plain = (chain_union_topk(q, probe, bids, db, k)
                     if case[-1] == "repeat" else None)
            near += check_chain(f"edge chain large k={k} {case[0]}", q,
                                probe, bids, k, db, bvecs=bvecs,
                                plain=plain)["near_ties"]
    for case in PQ_EDGES:
        lut, codes, valid, _ = pq_edge_operands(case)
        ks = LARGE_KS + ((codes.shape[0],) if case[0] == "k>N" else ())
        for k in ks:
            check_pq(f"edge pq_adc large k={k} {case[0]}", t(lut), t(codes),
                     k, t(valid))
    rng = np.random.default_rng(7)
    B, C, D = 5, 37, 8
    q = t(rng.normal(size=(B, D)).astype(np.float32))
    vecs = t(rng.normal(size=(B, C, D)).astype(np.float32))
    ids = t(rng.integers(0, 500, size=(B, C)).astype(np.int32))
    for k in LARGE_KS:
        bd = t(np.sort(rng.random((B, k)).astype(np.float32) * 20, axis=1))
        bi = t(rng.integers(1000, 2000, size=(B, k)).astype(np.int32))
        near += check_cand(f"edge cand carried best large k={k}", q, vecs,
                           ids, k, best_d=bd, best_i=bi)["near_ties"]
    return near


# ----------------------------------------------------------------- timing
def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int) -> float:
    """Device time of ``fn`` per call: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's per-call overhead (checks,
    allocations, the launch itself) cannot leave the card idle between
    launches, as it does in a plain loop when a call costs the host more
    than the kernel costs the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sm_clocks_mhz() -> dict:
    """The SM clock ``nvidia-smi`` reads now and its maximum, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "--id=0"], capture_output=True,
        text=True, timeout=60, check=True).stdout.split(",")
    return {"now": float(out[0]), "max": float(out[1])}


def bound(nbytes: float, flops: float,
          tc_flops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of memory traffic and ``flops``
    fp32 operations outside the tensor cores plus ``tc_flops`` on them at
    the dense TF32 rate, and which of bytes and operations bounds it."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = flops / FP32_FLOPS_PER_S + tc_flops / TF32_FLOPS_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def counted(name: str, fn):
    """``fn()`` and the launches it made of kernel ``name`` (its passes)."""
    c = LAUNCH_COUNTERS[name]
    before = c.count
    out = fn()
    torch.cuda.synchronize()
    return out, c.count - before


# --------------------------------------------------------------- phase 4
def phase_shapes(dev, brute_be, ivf_be, queries) -> None:
    q = torch.as_tensor(queries[:BATCH], device=dev)
    B, D = q.shape

    # l2_topk at B=64 x N=1M x d=128 with the brute backend's operands
    x, valid = brute_be._args
    N = x.shape[0]
    res = check_l2("shape l2_topk B64 N1M", q, x, K, valid=valid)
    xn = (x * x).sum(-1)[None, :].contiguous()
    res["ms"] = time_ms(lambda: l2_topk.l2_topk(q, x, K, valid=valid), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.l2_topk_ref(q, x, K, valid=valid), 3, warmup=1)
    res["library_ms"] = time_ms(lambda: torch.topk(
        torch.addmm(xn, q, x.T, alpha=-2.0), K, largest=False), 20)
    res["library_call"] = "torch.topk(torch.addmm(xn, q, x.T)): two calls"
    live = int(valid.sum())
    # the products, norms and epilogue in fp32 FMA (the bound the kernel
    # is held to); beside it the bytes alone and the bound of the
    # tensor-core route (3xTF32: three TF32 products a multiply-add)
    products = 2.0 * B * live * D
    flops = 2.0 * N * D + 2.0 * B * D + 3.0 * B * live
    nbytes = 4.0 * (B * D + N * D + N) + 8.0 * B * K
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops + products)
    res["tc_bound_ms"] = bound(nbytes, flops, 3.0 * products)[0]
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["shape"] = [B, N, D, K]
    log(f"[shape l2_topk] ms {res['ms']:.4f} bound {res['bound_ms']:.4f} "
        f"({res['bound_by']}, fp32 FMA; bytes {res['bytes_ms']:.4f}; the "
        f"3xTF32 route's {res['tc_bound_ms']:.4f}: "
        f"{3.0 * products / 1e9:.1f} GFLOP at "
        f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s) plain {res['plain_ms']:.3f} "
        f"library {res['library_ms']:.4f}; near-ties {res['near_ties']}")
    RESULTS["kernels"]["l2_topk"] = res

    # candidate_topk at one IVF probe step (B=64 x cap x 128) with a
    # carried best from the steps before it, on the IVF backend's tables
    cents, bids, bvecs = ivf_be._args
    _, probe = stable_topk(pairwise_l2sq(q, cents), ivf_be.nprobe_local)
    step = probe.shape[1] // 2
    best_d = torch.full((B, K), float("inf"), device=dev)
    best_i = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    for j in range(step):
        best_d, best_i = ref.candidate_topk_ref(
            q, bvecs[probe[:, j]], bids[probe[:, j]], K,
            best_d=best_d, best_i=best_i)
    ids = bids[probe[:, step]].contiguous()
    vecs = bvecs[probe[:, step]].contiguous()
    C = ids.shape[1]
    res = check_cand("shape candidate_topk B64 C", q, vecs, ids, K,
                     best_d=best_d, best_i=best_i)
    # one launch costs the host more than the card, so a plain loop would
    # time the host: all three are timed as replays of a captured graph
    res["ms"] = time_graph_ms(lambda: bucket_topk.candidate_topk(
        q, vecs, ids, K, best_d=best_d, best_i=best_i), 200)
    res["plain_ms"] = time_graph_ms(lambda: ref.candidate_topk_ref(
        q, vecs, ids, K, best_d=best_d, best_i=best_i), 20)
    vnq = torch.where(ids >= 0, (vecs * vecs).sum(-1) + (q * q).sum(-1)[:, None],
                      float("inf"))[:, :, None].contiguous()
    res["library_ms"] = time_graph_ms(lambda: torch.topk(torch.cat(
        [best_d, torch.baddbmm(vnq, vecs, q[:, :, None], alpha=-2.0)[..., 0]],
        dim=1), K, largest=False), 200)
    res["library_call"] = ("torch.topk(torch.cat([best_d, torch.baddbmm(...)]))"
                           ": three calls, norms precomputed")
    live = int((ids >= 0).sum())
    flops = 4.0 * live * D + 2.0 * B * D + 3.0 * live
    nbytes = 4.0 * (live * D + B * C + B * D + 2 * B * K) + 8.0 * B * K
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res["shape"] = [B, C, D, K]
    log(f"[shape candidate_topk step] C={C} ms {res['ms']:.5f} bound "
        f"{res['bound_ms']:.5f} ({res['bound_by']}) plain "
        f"{res['plain_ms']:.4f} library {res['library_ms']:.5f}")
    step_res = res

    # the whole probe chain at the served shape (B 64, nprobe 32): one
    # scan and one merge, the rows read by slot from the IVF tables; held
    # against its plain version, the rows read by id (the brute backend's
    # copy of the corpus) and 32 per-step launches
    res = check_chain("shape chain B64 nprobe32", q, probe, bids, K, x,
                      bvecs=bvecs)
    res["ms"] = time_graph_ms(lambda: bucket_topk.bucket_probe_topk(
        q, probe, bids, K, bucket_vecs=bvecs), 100)
    res["plain_ms"] = time_graph_ms(lambda: ref.bucket_probe_topk_ref(
        q, probe, bids, K, bucket_vecs=bvecs), 3)
    yard = chain_yardstick(q, probe, bids, K, bvecs=bvecs)
    res["library_ms"] = time_graph_ms(yard, 20)
    res["library_call"] = CHAIN_YARDSTICK
    res.update(chain_bound(q, probe, bids, K))
    res["step"] = step_res
    log(f"[shape candidate_topk chain] B={B} nprobe={probe.shape[1]} "
        f"pairs {res['pairs']} ms {res['ms']:.5f} bound "
        f"{res['bound_ms']:.5f} ({res['bound_by']}) plain "
        f"{res['plain_ms']:.4f} library {res['library_ms']:.5f}")
    RESULTS["kernels"]["candidate_topk"] = res


CHAIN_YARDSTICK = ("gather + torch.baddbmm + torch.topk over each query's "
                   "(nprobe cap) slots, row norms precomputed")


def chain_yardstick(q, probe, bids, k, *, bvecs=None, db=None):
    """The PyTorch calls for the chain's function, which the port never
    makes: gather the (B, nprobe cap, d) rows, ``baddbmm`` against the
    queries onto the precomputed norms (+inf in dead slots), ``topk``."""
    B, D = q.shape
    qn = (q * q).sum(1)[:, None]
    p = probe.long()
    if bvecs is not None:
        vn = torch.where(bids >= 0, (bvecs * bvecs).sum(-1), float("inf"))

        def rows():
            return (bvecs[p].reshape(B, -1, D),
                    vn[p].reshape(B, -1))
    else:
        xn = (db * db).sum(1)

        def rows():
            cand = bids[p].reshape(B, -1)
            c = cand.clamp(min=0).long()
            return db[c], torch.where(cand >= 0, xn[c], float("inf"))

    def run():
        vecs, norms = rows()
        d = torch.baddbmm((norms + qn)[..., None], vecs, q[:, :, None],
                          alpha=-2.0)[..., 0]
        dd, sel = torch.topk(d, k, largest=False)
        return dd, bids[p].reshape(B, -1).gather(1, sel)
    return run


def chain_bound(q, probe, bids, k) -> dict:
    """The chain's bound from this run's operands: bytes are the distinct
    probed buckets' ids and live rows read once, the queries, the probe
    list and the output; operations 4 d + 3 a (query, live row) pair."""
    B, D = q.shape
    u = torch.unique(probe.long())
    live_u = int((bids[u] >= 0).sum())
    pairs = int((bids[probe.long()] >= 0).sum())
    nbytes = (4.0 * (live_u * D + u.numel() * bids.shape[1] + B * D
                     + probe.numel()) + 8.0 * B * k)
    flops = (4.0 * D + 3.0) * pairs + 2.0 * B * D
    b, by = bound(nbytes, flops)
    return {"bound_ms": b, "bound_by": by, "pairs": pairs,
            "distinct_buckets": int(u.numel()), "distinct_live_rows": live_u,
            "pair_bytes_ms": 4.0 * pairs * D / HBM_BYTES_PER_S * 1e3,
            "shape": [B, int(probe.shape[1]), int(bids.shape[1]), D, k]}


# --------------------------------------------------------------- phase 5
def serve(cell: ServingCell, queries: np.ndarray, options=None):
    """N_CLIENTS threads, each sending its share of ``queries`` one
    blocking request at a time; ``options(r)`` gives request ``r``'s
    keyword arguments of ``cell.search``.  Returns (ids, dists, latencies
    s, wall s)."""
    n = queries.shape[0]
    ids = np.full((n, K), -2, np.int32)
    dists = np.full((n, K), np.nan, np.float32)
    timers = [LatencyTimer() for _ in range(N_CLIENTS)]
    errors: list = []

    def client(rows, timer):
        try:
            for r in rows:
                kw = options(r) if options is not None else {}
                with timer:
                    d, i = cell.search(queries[r], timeout=120, **kw)
                ids[r], dists[r] = i, d
        except Exception as e:   # reported and failed below
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(range(c, n, N_CLIENTS), timers[c]))
               for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    require(not any(th.is_alive() for th in threads), "a client hung")
    if errors:
        raise errors[0]
    lat = np.concatenate([np.asarray(t.samples) for t in timers])
    require(lat.size == n, "a request went unanswered")
    return ids, dists, lat, wall


def batched(fn, queries: np.ndarray, call=None, qt=None, qw=None):
    """``fn`` over batches of BATCH queries, with the options ``call``; a
    lexical or hybrid call takes each batch's rows of ``qt`` / ``qw``."""
    def one(s):
        kw = dict(call or {})
        if kw.get("mode", "semantic") != "semantic":
            kw["q_terms"], kw["q_weights"] = qt[s:s + BATCH], qw[s:s + BATCH]
        return fn(queries[s:s + BATCH], **kw)

    outs = [one(s) for s in range(0, len(queries), BATCH)]
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]))


def entity_text(n: int, seed: int):
    """Synthetic entity text: ``n`` documents of 6-12 tokens drawn with
    repetition from a Zipf-like vocabulary.  Returns (tokens, offsets,
    term probabilities)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1, dtype=np.float64) ** ZIPF_S
    p /= p.sum()
    lens = rng.integers(DOC_TOKENS[0], DOC_TOKENS[1] + 1, size=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    tokens = rng.choice(VOCAB, size=int(offsets[-1]), p=p)
    return tokens, offsets, p


def phase_main(dev, card) -> dict:
    label = f"{card['name']}, {card['nvidia_smi']}"
    t0 = time.perf_counter()
    corpus = make_corpus("sift", seed=0)
    queries = make_queries(corpus, N_REQUESTS, seed=1)
    log(f"[data] corpus {corpus.shape} queries {queries.shape} "
        f"{time.perf_counter() - t0:.1f} s (host)")
    require(corpus.shape == (SIFT_1M.n, SIFT_1M.d), "corpus is not sift-1m")
    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    meta = MetadataTable({"pct": rng.permutation(SIFT_1M.n) % 100})
    tokens, offsets, p_term = entity_text(SIFT_1M.n, seed=3)
    slabs = build_lexical_slabs_flat(tokens, offsets, VOCAB, slots=SLOTS)
    log(f"[data] metadata + slabs {slabs.terms.shape} "
        f"{time.perf_counter() - t0:.1f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = build_two_level(corpus, TwoLevelConfig(
        n_clusters=SIFT_1M.n_clusters, top="brute", bottom="brute", seed=0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = idx.bucket_counts
    require(int(counts.sum()) == SIFT_1M.n, "build lost entities")
    cap = idx.bucket_ids.shape[1]
    log(f"[build index] {build_s:.1f} s on {label}: K={idx.k_clusters} "
        f"cap={cap} bucket sizes min/mean/max {counts.min()}/"
        f"{counts.mean():.1f}/{counts.max()}")

    # the served backends also carry the options phase's sidecars; an
    # unfiltered semantic call never reads them
    ivf = ShardedSearchBackend(idx, kind="ivf", k=K,
                               nprobe_local=SIFT_1M.nprobe, metadata=meta)
    brute = ShardedSearchBackend(corpus, kind="brute", k=K, metadata=meta,
                                 lexical=slabs)
    cell = ServingCell(ivf, max_batch=BATCH, max_wait_ms=2.0)
    # warm-up: first cuBLAS handles, allocator pools
    ivf(queries[:BATCH])
    brute(queries[:BATCH])
    torch.cuda.synchronize()

    phase_shapes(dev, brute, ivf, queries)

    # the served IVF path runs candidate_topk (its centroid probe is a
    # plain GEMM + sort); l2_topk's path is the options phase's brute cell
    reset_launches()
    ids, dists, lat, wall = serve(cell, queries)
    torch.cuda.synchronize()
    launches = read_launches()
    stats = cell.stats()
    cell.close()
    log(f"[serve] launches {launches}")
    require(launches["candidate_topk"] > 0,
            "a kernel of the main path was never launched")
    truth_d, truth = batched(brute, queries)
    require((ids >= 0).all() and np.isfinite(dists).all(),
            "served results hold sentinels or non-finite distances")
    # every served (id, distance) pair holds against a float64 recompute
    qn = (queries.astype(np.float64) ** 2).sum(1)
    xn = (corpus.astype(np.float64) ** 2).sum(1)
    d64 = ((queries[:, None, :].astype(np.float64)
            - corpus[ids].astype(np.float64)) ** 2).sum(-1)
    pair_err = np.abs(d64 - dists) / (qn[:, None] + xn[ids])
    log(f"[serve] served distances vs float64: max rel err "
        f"{pair_err.max():.3e}")
    require((pair_err <= REL).all(), "a served id carries a wrong distance")
    recall = recall_at_k(ids, truth)
    main = {
        "label": label, "build_s": build_s, "cap": int(cap),
        "bucket_max": int(counts.max()), "requests": int(len(queries)),
        "clients": N_CLIENTS, "recall_at_10": recall,
        "p50_ms": float(np.percentile(lat * 1e3, 50)),
        "p99_ms": float(np.percentile(lat * 1e3, 99)),
        "qps": len(queries) / wall, "wall_s": wall,
        "mean_batch": float(np.mean(stats.batch_sizes)),
        "stages": stats.stages, "launches": launches,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
    }
    log(f"[serve] {len(queries)} requests, {N_CLIENTS} clients on {label}: "
        f"recall@10 {recall:.4f} p50 {main['p50_ms']:.3f} ms p99 "
        f"{main['p99_ms']:.3f} ms QPS {main['qps']:.1f} mean batch "
        f"{main['mean_batch']:.1f}")
    log(f"[serve] stages {json.dumps(stats.stages)}")
    log(f"[serve] max_memory_allocated {main['max_memory_allocated_bytes']}")
    require(recall >= 0.5, f"recall@10 {recall} is implausibly low")

    # the unfused plain path on the same index, same batches
    fused = batched(ivf, queries)
    unfused = batched(ShardedSearchBackend(
        idx, kind="ivf", k=K, nprobe_local=SIFT_1M.nprobe, fused=False),
        queries)
    scale = qn[:, None] + xn[np.maximum(unfused[1], 0)]
    agree = float((fused[1] == unfused[1]).mean())
    err = np.abs(fused[0].astype(np.float64) - unfused[0])
    differ = fused[1] != unfused[1]
    off = differ & (err > REL * scale)
    gap = float(err[differ].max(initial=0.0))
    log(f"[parity] fused vs unfused IVF: ids agree on {agree:.6f} of slots, "
        f"{int(differ.sum())} differing slots (largest distance gap "
        f"{gap}), {int(off.sum())} off a near-tie")
    # sift-range rows have ||x||^2 ~ 2e6 against neighbour distances ~ 3e3,
    # so both expansions round d2 by about one unit and neighbours closer
    # than that swap: every differing slot must be a near-tie, and the
    # share of such slots is reported (the floor only catches breakage)
    require(not off.any(), "fused and unfused IVF differ off a near-tie")
    require(agree >= 0.99, "fused and unfused IVF differ on >1% of slots")
    served_agree = float((ids == fused[1]).mean())
    log(f"[parity] served (cell batches) vs direct fused batches: "
        f"{served_agree:.6f} of slots")
    require(served_agree >= 0.99, "cell answers differ from the backend's")
    # the chain against 32 per-step launches, bit for bit, on the served
    # batches (the same probe lists as the backend's local)
    cents, bids, bvecs = ivf._args
    for s0 in range(0, len(queries), BATCH):
        qb = torch.as_tensor(queries[s0:s0 + BATCH], device=dev)
        _, probe = stable_topk(pairwise_l2sq(qb, cents), SIFT_1M.nprobe)
        require_bits(f"served batch {s0 // BATCH} chain vs per-step",
                     bucket_topk.bucket_probe_topk(qb, probe, bids, K,
                                                   bucket_vecs=bvecs),
                     step_chain(qb, probe, bids, bvecs, K))
    log(f"[parity] chain vs {SIFT_1M.nprobe} per-step launches: bit for bit "
        f"on all {len(queries) // BATCH} served batches")
    main["unfused_recall_at_10"] = recall_at_k(unfused[1], truth)
    log(f"[parity] recall@10 served {recall:.4f}, unfused plain path "
        f"{main['unfused_recall_at_10']:.4f}")
    main["fused_unfused_agree"] = agree
    main["fused_unfused_max_gap"] = gap
    main["served_direct_agree"] = served_agree
    main["k50"] = backends_k50(idx, corpus, queries[:4 * BATCH], qn, xn)
    RESULTS["main"] = main
    RESULTS["kernels"]["candidate_topk"]["launches"] = launches[
        "candidate_topk"]
    return {"label": label, "corpus": corpus, "queries": queries,
            "truth": truth, "idx": idx, "ivf": ivf, "brute": brute,
            "meta": meta, "slabs": slabs, "tokens": tokens,
            "offsets": offsets, "p_term": p_term}


def backends_k50(idx, corpus, queries, qn, xn) -> dict:
    """The IVF and brute backends at k = 50 (above the kernels' 32-pair
    lists: two passes a call) on the card, each against its unfused plain
    path: ids equal except at near-ties, on at least 0.9 of slots (a
    breakage floor: ranks 11-50 of sift-magnitude neighbours hold many
    more pairs closer than d2's one-unit rounding than the top 10 do,
    fault 7: the IVF chain agreed on 0.972 of slots, every difference a
    near-tie); every returned pair's distance within REL of float64; the
    IVF answers' recall@50 against the brute's."""
    out = {}
    k = K_BACKEND_LARGE
    n = len(queries)
    for kind, target in (("ivf", idx), ("brute", corpus)):
        fused = ShardedSearchBackend(target, kind=kind, k=k,
                                     nprobe_local=SIFT_1M.nprobe)
        plain = ShardedSearchBackend(target, kind=kind, k=k,
                                     nprobe_local=SIFT_1M.nprobe, fused=False)
        a = batched(fused, queries)
        b = batched(plain, queries)
        require(a[1].shape == (n, k) and (a[1] >= 0).all(),
                f"{kind} at k={k}: wrong shape or sentinels")
        scale = qn[:n, None] + xn[np.maximum(b[1], 0)]
        out[kind] = near_tie_parity(f"{kind} k={k} vs unfused", a, b, scale,
                                    floor=0.9)
        d64 = ((queries[:, None, :].astype(np.float64)
                - corpus[a[1]].astype(np.float64)) ** 2).sum(-1)
        err = np.abs(d64 - a[0]) / (qn[:n, None] + xn[a[1]])
        require((err <= REL).all(), f"{kind} at k={k}: a wrong distance")
        out[kind]["max_rel_err_f64"] = float(err.max())
        out[kind]["ids"] = a[1]
    out["ivf_recall_at_50_vs_brute"] = recall_at_k(out["ivf"]["ids"],
                                                   out["brute"]["ids"])
    for kind in ("ivf", "brute"):
        del out[kind]["ids"]
    log(f"[serve] backends at k={k} on the card: {out}")
    require(out["ivf_recall_at_50_vs_brute"] >= 0.5,
            "IVF recall@50 is implausibly low")
    return out


# ------------------------------------------------------------ phase 4 (b)
def _csr_and_weights(terms, tf, qt, qw, scale: float = 1.0):
    """The yardstick's operands: an (N, V) CSR of ``tf_sat`` and the
    (V, B) query weight matrix ``scale * qw``, so that ``csr @ W`` is
    every (document, query) BM25 score."""
    live = terms >= 0
    crow = torch.zeros(terms.shape[0] + 1, dtype=torch.int64,
                       device=terms.device)
    crow[1:] = torch.cumsum(live.sum(1), 0)
    with warnings.catch_warnings():      # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(crow, terms[live].long(), tf[live],
                                      size=(terms.shape[0], VOCAB),
                                      check_invariants=False)
    w = torch.zeros((VOCAB, qt.shape[0]), device=terms.device)
    cols = torch.arange(qt.shape[0], device=terms.device)[:, None].expand(
        qt.shape)
    ok = qt >= 0
    w[qt[ok].long(), cols[ok]] = scale * qw[ok]
    return csr, w


def _matched_slots(terms, valid, qt) -> int:
    """The (query term slot, document slot) pairs whose terms match, over
    the live documents: the adds the BM25 hits need."""
    live_rows = (terms >= 0) & (valid != 0)[:, None]
    slot_df = torch.bincount(terms[live_rows].long(),
                             minlength=int(terms.max()) + 1)
    q_live = qt[(qt >= 0) & (qt < slot_df.numel())].long()
    return int(slot_df[q_live].sum())


def _eight_term_queries(ctx):
    """(qt, qw) of BATCH queries that fill all Q_SLOTS slots: 4 tokens of
    the query's exact nearest entity's document, then Zipf draws until
    Q_SLOTS distinct terms."""
    rng = np.random.default_rng(5)
    tokens, offsets = ctx["tokens"], ctx["offsets"]
    extra = rng.choice(VOCAB, size=(BATCH, 64), p=ctx["p_term"])
    q_docs = []
    for r, e in enumerate(ctx["truth"][:BATCH, 0]):
        doc = np.unique(tokens[offsets[e]:offsets[e + 1]])
        terms = list(rng.choice(doc, min(4, doc.size), replace=False))
        for t in extra[r]:
            if len(set(terms)) == Q_SLOTS:
                break
            terms.append(int(t))
        q_docs.append(terms)
    return query_operands(q_docs, ctx["slabs"], slots=Q_SLOTS)


def phase_option_shapes(dev, ctx, int8_be, qt_all, qw_all) -> None:
    """int8, BM25 and hybrid at B = 64, N = 1M on the backends' own
    operands: checked against the plain version, timed beside the bound,
    the plain version and a PyTorch yardstick."""
    brute, queries = ctx["brute"], ctx["queries"]
    q = torch.as_tensor(queries[:BATCH], device=dev)
    qt = torch.as_tensor(qt_all[:BATCH], device=dev)
    qw = torch.as_tensor(qw_all[:BATCH], device=dev)
    B, D = q.shape
    T = qt.shape[1]

    # l2_topk_int8 over the int8 backend's codes
    codes, scales, valid = int8_be._args
    N = codes.shape[0]
    res = check_int8("shape l2_topk_int8 B64 N1M", q, codes, scales, K,
                     valid)
    res["ms"] = time_ms(lambda: l2_topk.l2_topk_int8(
        q, codes, scales, K, valid=valid), 20)
    res["plain_ms"] = time_ms(lambda: ref.l2_topk_int8_ref(
        q, codes, scales, K, valid=valid), 3, warmup=1)
    deq = codes.float() * scales[:, None]
    xn = (deq * deq).sum(-1)[None, :].contiguous()
    res["library_ms"] = time_ms(lambda: torch.topk(
        torch.addmm(xn, q, deq.T, alpha=-2.0), K, largest=False), 20)
    res["library_call"] = ("torch.topk(torch.addmm(xn, q, deq.T)) over the "
                           "dequantized fp32 rows: two calls")
    del deq
    live = int((valid != 0).sum())
    flops = 2.0 * B * live * D + 2.0 * N * D + 2.0 * B * D + 5.0 * B * live
    nbytes = 1.0 * N * D + 4.0 * (N + N + B * D) + 8.0 * B * K
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res["shape"] = [B, N, D, K]
    res["placed_bytes"] = int(sum(t.numel() * t.element_size()
                                  for t in int8_be._args))
    RESULTS["kernels"]["l2_topk_int8"] = res
    log(f"[shape l2_topk_int8] ms {res['ms']:.4f} bound {res['bound_ms']:.4f}"
        f" ({res['bound_by']}) plain {res['plain_ms']:.3f} library "
        f"{res['library_ms']:.4f}")

    # bm25_topk over the brute backend's slabs
    terms, tf = brute._lex_args
    x, valid = brute._args
    N, S = terms.shape
    res = check_bm25("shape bm25_topk B64 N1M", qt, qw, terms, tf, K, valid)
    res["ms"] = time_ms(lambda: bm25.bm25_topk(qt, qw, terms, tf, K,
                                               valid=valid), 20)
    res["plain_ms"] = time_ms(lambda: ref.bm25_topk_ref(
        qt, qw, terms, tf, K, valid=valid), 3, warmup=1)
    csr, w = _csr_and_weights(terms, tf, qt, qw)
    res["library_ms"] = time_ms(lambda: torch.topk(
        torch.sparse.mm(csr, w).T, K), 20)
    res["library_call"] = ("torch.topk(torch.sparse.mm(csr, W).T): an (N, V)"
                           " CSR of tf_sat against the (V, B) query weights")
    # the work these inputs need: a multiply and an add a (live query term
    # slot, live document) pair, and an add a matched (query term slot,
    # document slot) pair; beside it, the count of lexical.cuh's T x S
    # compare loop (a compare-select and an add a query term slot and slab
    # slot), which this kernel no longer runs
    live_t = int((qt >= 0).sum())
    live_docs = int((valid != 0).sum())
    matched = _matched_slots(terms, valid, qt)
    lex_ops = 2.0 * live_docs * live_t + matched
    compare_ops = 2.0 * S * N * live_t
    nbytes = 8.0 * N * S + 4.0 * N + 8.0 * B * T + 8.0 * B * K
    res["bound_ms"], res["bound_by"] = bound(nbytes, lex_ops)
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["ops_ms"] = lex_ops / FP32_FLOPS_PER_S * 1e3
    res["compare_loop_ops_ms"] = compare_ops / FP32_FLOPS_PER_S * 1e3
    res["shape"] = [B, N, S, T, K]
    res["live_term_slots"] = live_t
    res["matched_slots"] = matched
    res["matched_slots_per_doc"] = matched / live_docs
    # queries of eight distinct terms, as many as the slots hold: a tile
    # of 64 then holds more distinct terms than the kernel's 256 hit rows,
    # and the kernel takes its queries in groups
    qt8, qw8 = _eight_term_queries(ctx)
    qt8, qw8 = torch.as_tensor(qt8, device=dev), torch.as_tensor(qw8,
                                                                 device=dev)
    r8 = check_bm25("shape bm25_topk B64 N1M T8", qt8, qw8, terms, tf, K,
                    valid)
    r8["ms"] = time_ms(lambda: bm25.bm25_topk(qt8, qw8, terms, tf, K,
                                              valid=valid), 20)
    r8["live_term_slots"] = int((qt8 >= 0).sum())
    r8["distinct_terms"] = int(torch.unique(qt8[qt8 >= 0]).numel())
    r8["matched_slots"] = _matched_slots(terms, valid, qt8)
    res["eight_terms"] = r8
    RESULTS["kernels"]["bm25_topk"] = res
    log(f"[shape bm25_topk] ms {res['ms']:.4f} bound {res['bound_ms']:.4f} "
        f"({res['bound_by']}; bytes {res['bytes_ms']:.4f}, operations "
        f"{res['ops_ms']:.4f}; the T x S loop's count "
        f"{res['compare_loop_ops_ms']:.4f}) plain {res['plain_ms']:.3f} "
        f"library {res['library_ms']:.4f}; matched (query slot, document "
        f"slot) pairs {matched} ({res['matched_slots_per_doc']:.2f} a "
        f"document)")
    log(f"[shape bm25_topk T8] ms {r8['ms']:.4f} with "
        f"{r8['live_term_slots']} live term slots ({r8['distinct_terms']} "
        f"distinct terms in the tile), matched pairs {r8['matched_slots']}; "
        f"max_abs_err {r8['max_abs_err']}")

    # hybrid_topk over the brute backend's rows and slabs
    a = torch.full((1, 1), ALPHA, dtype=torch.float32, device=dev)
    res = check_hybrid("shape hybrid_topk B64 N1M", q, x, qt, qw, terms, tf,
                       ALPHA, K, valid)
    res["ms"] = time_ms(lambda: bm25.hybrid_topk(
        q, x, qt, qw, terms, tf, a, K, valid=valid), 20)
    res["plain_ms"] = time_ms(lambda: ref.hybrid_topk_ref(
        q, x, qt, qw, terms, tf, a, K, valid=valid), 3, warmup=1)
    csr, w = _csr_and_weights(terms, tf, qt, qw, scale=-(1.0 - ALPHA))
    axn = (ALPHA * (x * x).sum(-1))[None, :].contiguous()
    res["library_ms"] = time_ms(lambda: torch.topk(torch.addmm(
        torch.sparse.mm(csr, w).T.add(axn), q, x.T, alpha=-2.0 * ALPHA), K,
        largest=False), 20)
    res["library_call"] = ("torch.topk(torch.addmm(torch.sparse.mm(csr, W).T"
                           " + a xn, q, x.T)): four calls")
    del csr, w, axn
    live = int((valid != 0).sum())
    products = 2.0 * B * live * D
    flops = (2.0 * N * D + 2.0 * B * D + 6.0 * B * live
             + lex_ops)                     # lex_ops: BM25's, above
    nbytes = (4.0 * N * D + 8.0 * N * S + 4.0 * N + 4.0 * B * D
              + 8.0 * B * T + 4.0 + 8.0 * B * K)
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops + products)
    res["tc_bound_ms"] = bound(nbytes, flops, 3.0 * products)[0]
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["shape"] = [B, N, D, S, T, K]
    RESULTS["kernels"]["hybrid_topk"] = res
    log(f"[shape hybrid_topk] ms {res['ms']:.4f} bound {res['bound_ms']:.4f}"
        f" ({res['bound_by']}, fp32 FMA; bytes {res['bytes_ms']:.4f}; the "
        f"3xTF32 route's {res['tc_bound_ms']:.4f}) plain "
        f"{res['plain_ms']:.3f} library {res['library_ms']:.4f}")


# --------------------------------------------------------------- phase 6
def _kw(o: dict, qt, qw, rows) -> dict:
    """A backend call's options for the requests ``rows``."""
    kw = {"filter_spec": o.get("filter"), "mode": o.get("mode", "semantic"),
          "alpha": o.get("alpha", 0.5)}
    if kw["mode"] != "semantic":
        kw["q_terms"], kw["q_weights"] = qt[rows], qw[rows]
    return kw


def direct(backend, queries, rows, o, qt, qw):
    """Direct backend calls for ``rows`` in batches of 64."""
    outs = [backend(queries[rows[s:s + BATCH]],
                    **_kw(o, qt, qw, rows[s:s + BATCH]))
            for s in range(0, len(rows), BATCH)]
    return (np.concatenate([x[0] for x in outs]),
            np.concatenate([x[1] for x in outs]))


def near_tie_parity(name, a, b, scale, floor: float = 0.99) -> dict:
    """Two answers (dists, ids) agree except at near-ties (slots whose
    distances agree within REL * scale), on at least ``floor`` of
    slots."""
    err = np.abs(np.where(np.isfinite(b[0]), a[0].astype(np.float64) - b[0],
                          0.0))
    differ = a[1] != b[1]
    off = differ & (err > REL * scale)
    agree = float((~differ).mean())
    require(np.array_equal(np.isinf(a[0]), np.isinf(b[0])),
            f"{name}: sentinel slots differ")
    require(not off.any(), f"{name}: ids differ off a near-tie")
    require(agree >= floor, f"{name}: ids agree on {agree} < {floor}")
    return {"agree": agree, "differing": int(differ.sum())}


def cell_stats(name, cell, lat, wall, n) -> dict:
    st = cell.stats()
    out = {"requests": n, "p50_ms": float(np.percentile(lat * 1e3, 50)),
           "p99_ms": float(np.percentile(lat * 1e3, 99)), "qps": n / wall,
           "wall_s": wall, "collected_batches": st.collected_batches,
           "dispatches": st.dispatches,
           "mean_batch": n / max(st.collected_batches, 1),
           "mean_dispatch": n / max(st.dispatches, 1),
           "dispatches_per_batch": st.dispatches / max(st.collected_batches,
                                                       1),
           "stages": st.stages}
    log(f"[options] {name}: {n} requests, {N_CLIENTS} clients: p50 "
        f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms QPS "
        f"{out['qps']:.1f}; mean batch {out['mean_batch']:.2f} requests, "
        f"{out['dispatches_per_batch']:.2f} dispatches per batch (mean "
        f"dispatch {out['mean_dispatch']:.2f})")
    return out


def require_admitted(name, ids, spec, meta) -> None:
    mask = spec.mask(meta, meta.n_rows)
    got = ids[ids >= 0]
    require(mask[got].all(), f"{name}: an id outside its filter came back")


def phase_options(dev, ctx) -> None:
    corpus, queries, truth = ctx["corpus"], ctx["queries"], ctx["truth"]
    brute, ivf, meta, slabs = (ctx[k] for k in ("brute", "ivf", "meta",
                                                "slabs"))
    label = ctx["label"]
    n = len(queries)
    # query text: 3 tokens of the query's exact nearest entity's document
    # plus 1 random token
    rng = np.random.default_rng(4)
    tokens, offsets = ctx["tokens"], ctx["offsets"]
    extra = rng.choice(VOCAB, size=n, p=ctx["p_term"])
    q_docs = [list(rng.choice(tokens[offsets[e]:offsets[e + 1]], 3,
                              replace=False)) + [int(extra[r])]
              for r, e in enumerate(truth[:, 0])]
    qt, qw = query_operands(q_docs, slabs, slots=Q_SLOTS)
    ctx["qt"], ctx["qw"] = qt, qw           # the sharded phase's too

    t0 = time.perf_counter()
    int8_be = ShardedSearchBackend(corpus, kind="brute", k=K,
                                   precision="int8")
    int8_be(queries[:BATCH])
    torch.cuda.synchronize()
    log(f"[options] int8 placement (quantize + place) "
        f"{time.perf_counter() - t0:.1f} s")
    with phase("shapes (int8, bm25, hybrid)"):
        phase_option_shapes(dev, ctx, int8_be, qt, qw)

    sets = [{"filter": NARROW}, {"mode": "lexical"},
            {"mode": "lexical", "filter": WIDE},
            {"mode": "hybrid", "alpha": ALPHA}]

    def brute_opts(r):
        o = dict(sets[r % len(sets)])
        if o.get("mode", "semantic") != "semantic":
            o["q_terms"], o["q_weights"] = qt[r], qw[r]
        return o

    n_ivf, n_i8 = N_IVF_OPTION_REQUESTS, N_INT8_REQUESTS
    ivf_filters = (NARROW, WIDE)
    cells = {"brute": ServingCell(brute, max_batch=BATCH, max_wait_ms=2.0),
             "ivf": ServingCell(ivf, max_batch=BATCH, max_wait_ms=2.0),
             "int8": ServingCell(int8_be, max_batch=BATCH, max_wait_ms=2.0)}
    # the main path of this phase: the three cells, counts reset just
    # before and read just after
    reset_launches()
    served = {
        "brute": serve(cells["brute"], queries, brute_opts),
        "ivf": serve(cells["ivf"], queries[:n_ivf],
                     lambda r: {"filter": ivf_filters[r % 2]}),
        "int8": serve(cells["int8"], queries[:n_i8]),
    }
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[options] launches {launches}")
    require(all(launches[name] > 0 for name in OPTION_KERNELS),
            "a kernel of the options path was never launched")
    out = {"label": label, "launches": launches}
    for name, cell in cells.items():
        ids, _, lat, wall = served[name]
        out[name] = cell_stats(name, cell, lat, wall, len(ids))
        cell.close()

    qn = (queries.astype(np.float64) ** 2).sum(1)
    xn = (corpus.astype(np.float64) ** 2).sum(1)
    unfused = ShardedSearchBackend(corpus, kind="brute", k=K, fused=False,
                                   metadata=meta, lexical=slabs)
    ids, dists = served["brute"][0], served["brute"][1]
    for j, o in enumerate(sets):
        rows = np.arange(j, n, len(sets))
        tag = (f"{o.get('mode', 'semantic')}"
               f"{' a=' + str(o['alpha']) if 'alpha' in o else ''}"
               f"{' ' + o['filter'].describe() if 'filter' in o else ''}")
        mine = (dists[rows], ids[rows])
        if "filter" in o:
            require_admitted(f"brute {tag}", mine[1], o["filter"], meta)
        fused = direct(brute, queries, rows, o, qt, qw)
        plain = direct(unfused, queries, rows, o, qt, qw)
        same_cell = float((mine[1] == fused[1]).mean())
        require(same_cell >= 0.99, f"brute {tag}: cell answers differ from "
                "direct backend calls")
        res = {"cell_direct_agree": same_cell}
        if o.get("mode") == "lexical":
            require(np.array_equal(mine[1], plain[1])
                    and np.array_equal(mine[0].view(np.int32),
                                       plain[0].view(np.int32)),
                    f"brute {tag}: lexical answers differ from the unfused "
                    "path (ids, or distance bits)")
            res["unfused_agree"] = 1.0
        else:
            a = o.get("alpha", 1.0) if o.get("mode") == "hybrid" else 1.0
            scale = (a * (qn[rows, None] + xn[np.maximum(plain[1], 0)])
                     + (1 - a) * np.maximum(np.abs(plain[0]), 1.0))
            par = near_tie_parity(f"brute {tag} vs unfused", mine, plain,
                                  scale)
            res["unfused_agree"] = par["agree"]
            res["unfused_differing"] = par["differing"]
        if o.get("mode") is None:
            # semantic filtered: every served pair against float64
            d64 = ((queries[rows][:, None, :].astype(np.float64)
                    - corpus[mine[1]].astype(np.float64)) ** 2).sum(-1)
            err = np.abs(d64 - mine[0]) / (qn[rows, None] + xn[mine[1]])
            require((err <= REL).all(), f"brute {tag}: a wrong distance")
            res["max_rel_err_f64"] = float(err.max())
        if o.get("mode") == "hybrid":
            # the near-tie tolerance above cannot see the lexical half at
            # sift magnitudes: every served pair, held by its two halves
            rt = torch.as_tensor(rows, device=dev)
            res["by_parts"] = require_by_parts(
                f"brute {tag}", torch.as_tensor(queries, device=dev)[rt],
                brute._args[0], torch.as_tensor(qt, device=dev)[rt],
                torch.as_tensor(qw, device=dev)[rt], *brute._lex_args,
                o["alpha"], torch.as_tensor(mine[0]),
                torch.as_tensor(mine[1]))
            res["not_in_semantic_top10"] = float(np.mean(
                [1 - np.intersect1d(a_, b_).size / K
                 for a_, b_ in zip(mine[1], truth[rows])]))
        log(f"[options] brute {tag}: {res}")
        out[f"brute {tag}"] = res

    ids, dists = served["ivf"][0], served["ivf"][1]
    for j, spec in enumerate(ivf_filters):
        rows = np.arange(j, n_ivf, 2)
        mine = (dists[rows], ids[rows])
        require_admitted(f"ivf {spec.describe()}", mine[1], spec, meta)
        o = {"filter": spec}
        fused = direct(ivf, queries, rows, o, qt, qw)
        exact = direct(brute, queries, rows, o, qt, qw)
        agree = float((mine[1] == fused[1]).mean())
        require(agree >= 0.99, "filtered IVF cell answers differ from "
                "direct backend calls")
        rec = recall_at_k(mine[1], exact[1])
        res = {"selectivity": float(spec.mask(meta, meta.n_rows).mean()),
               "recall_at_10_vs_filtered_exact": rec,
               "cell_direct_agree": agree}
        log(f"[options] ivf {spec.describe()}: {res}")
        out[f"ivf {spec.describe()}"] = res
        if spec is WIDE:
            # filter-blind probing sags at 0.05 (docs/filtering.md): the
            # floor only catches breakage, at 0.5
            require(rec >= 0.5, f"filtered IVF recall@10 {rec} at 0.5")

    ids, dists = served["int8"][0], served["int8"][1]
    rows = np.arange(n_i8)
    fused = direct(int8_be, queries, rows, {}, qt, qw)
    agree = float((ids == fused[1]).mean())
    require(agree >= 0.99, "int8 cell answers differ from direct calls")
    deq = _deq_rows(*int8_be._args[:2])(ids)
    d64 = ((queries[:n_i8, None, :].astype(np.float64) - deq) ** 2).sum(-1)
    err = np.abs(d64 - dists) / (qn[:n_i8, None] + (deq ** 2).sum(-1))
    require((err <= REL).all(), "int8: a served id carries a wrong distance")
    rec = recall_at_k(ids, truth[:n_i8])
    f32_bytes = int(sum(t.numel() * t.element_size() for t in brute._args))
    i8_bytes = int(sum(t.numel() * t.element_size() for t in int8_be._args))
    res = {"recall_at_10_vs_exact_f32": rec, "cell_direct_agree": agree,
           "max_rel_err_f64_dequantized": float(err.max()),
           "placed_bytes_f32": f32_bytes, "placed_bytes_int8": i8_bytes}
    log(f"[options] int8: {res}")
    require(rec >= 0.5, f"int8 recall@10 {rec} is implausibly low")
    out["int8 checks"] = res
    RESULTS["options"] = out
    for name in OPTION_KERNELS:
        RESULTS["kernels"][name]["launches"] = launches[name]
    ctx.update(int8=int8_be, qt=qt, qw=qw)


# ------------------------------------------------------------ phase 6 (b)
def phase_large_k(dev, ctx) -> None:
    """Every kernel with a list ceiling above it, at the main path's shapes
    on the backends' own operands (B 64 against the 1M-row corpus, its
    int8 codes and slabs; the served chain and one probe step with a
    carried best of k pairs on the IVF tables): k = 33, 64, 65 and 100
    against the plain version (``compare``, REL as everywhere; BM25 bit for
    bit), then the passes (counted launches of one call) and time at
    k = 100 beside k = 10.  PQ's are in the DEEP index phase."""
    brute, ivf, int8_be = ctx["brute"], ctx["ivf"], ctx["int8"]
    q = torch.as_tensor(ctx["queries"][:BATCH], device=dev)
    qt = torch.as_tensor(ctx["qt"][:BATCH], device=dev)
    qw = torch.as_tensor(ctx["qw"][:BATCH], device=dev)
    x, valid = brute._args
    terms, tf = brute._lex_args
    codes, scales, ivalid = int8_be._args
    a = torch.full((1, 1), ALPHA, dtype=torch.float32, device=dev)
    cents, bids, bvecs = ivf._args
    _, probe = stable_topk(pairwise_l2sq(q, cents), ivf.nprobe_local)
    half = probe.shape[1] // 2

    def step_operands(k):
        """The served chain's first half by the plain loop at width k (the
        carried best), and the next probe's tile."""
        bd = torch.full((BATCH, k), float("inf"), device=dev)
        bi = torch.full((BATCH, k), -1, dtype=torch.int32, device=dev)
        for j in range(half):
            bd, bi = ref.candidate_topk_ref(q, bvecs[probe[:, j]],
                                            bids[probe[:, j]], k,
                                            best_d=bd, best_i=bi)
        return (bvecs[probe[:, half]].contiguous(),
                bids[probe[:, half]].contiguous(), bd, bi)

    near = 0
    for k in LARGE_KS:
        near += check_l2(f"large k l2_topk k={k}", q, x, k, valid)[
            "near_ties"]
        near += check_int8(f"large k l2_topk_int8 k={k}", q, codes, scales, k,
                           ivalid)["near_ties"]
        near += check_bm25(f"large k bm25_topk k={k}", qt, qw, terms, tf, k,
                           valid)["near_ties"]
        near += check_hybrid(f"large k hybrid_topk k={k}", q, x, qt, qw,
                             terms, tf, ALPHA, k, valid)["near_ties"]
        vecs, ids, bd, bi = step_operands(k)
        near += check_cand(f"large k candidate_topk step k={k}", q, vecs, ids,
                           k, best_d=bd, best_i=bi)["near_ties"]
        near += check_chain(f"large k candidate_topk chain k={k}", q, probe,
                            bids, k, x, bvecs=bvecs)["near_ties"]
    vecs, ids, bd, bi = step_operands(K_LARGE)
    calls = {
        "l2_topk": lambda k: l2_topk.l2_topk(q, x, k, valid=valid),
        "l2_topk_int8": lambda k: l2_topk.l2_topk_int8(q, codes, scales, k,
                                                        valid=ivalid),
        "bm25_topk": lambda k: bm25.bm25_topk(qt, qw, terms, tf, k,
                                              valid=valid),
        "hybrid_topk": lambda k: bm25.hybrid_topk(q, x, qt, qw, terms, tf, a,
                                                  k, valid=valid),
    }
    out = {"near_ties": near}
    for name, fn in calls.items():
        _, passes = counted(name, lambda: fn(K_LARGE))
        r = {"passes": passes, "ms": time_ms(lambda: fn(K_LARGE), 10),
             "ms_k10": RESULTS["kernels"][name]["ms"]}
        RESULTS["kernels"][name]["k100"] = out[name] = r
        log(f"[large k] {name}: k={K_LARGE} {passes} passes {r['ms']:.4f} ms "
            f"(k={K}: {r['ms_k10']:.4f} ms)")
    # the chain and the step: graph replays, as at k = 10 (one call costs
    # the host more than the card)
    chain = lambda: bucket_topk.bucket_probe_topk(  # noqa: E731
        q, probe, bids, K_LARGE, bucket_vecs=bvecs)
    step = lambda: bucket_topk.candidate_topk(  # noqa: E731
        q, vecs, ids, K_LARGE, best_d=bd, best_i=bi)
    cand = RESULTS["kernels"]["candidate_topk"]
    for part, fn, k10 in (("chain", chain, cand["ms"]),
                          ("step", step, cand["step"]["ms"])):
        _, passes = counted("candidate_topk", fn)
        r = {"passes": passes, "ms": time_graph_ms(fn, 20), "ms_k10": k10}
        out[f"candidate_topk {part}"] = r
        log(f"[large k] candidate_topk {part}: k={K_LARGE} {passes} passes "
            f"{r['ms']:.5f} ms (k={K}: {k10:.5f} ms)")
    cand["k100"] = out["candidate_topk chain"]
    log(f"[large k] every kernel agrees with its plain version at k in "
        f"{LARGE_KS}; near-ties {near}")
    RESULTS["large_k"] = out


# --------------------------------------------------------------- phase 7
def phase_profiles(ctx) -> None:
    queries, qt, qw = ctx["queries"], ctx["qt"], ctx["qw"]

    def opts(o):
        return lambda s: _kw(o, qt, qw, np.arange(s, s + BATCH))

    for kind, backend, o in (
            ("ivf", ctx["ivf"], {}), ("brute", ctx["brute"], {}),
            ("lexical", ctx["brute"], {"mode": "lexical"}),
            ("hybrid", ctx["brute"], {"mode": "hybrid", "alpha": ALPHA}),
            ("int8", ctx["int8"], {})):
        RESULTS[f"profile_{kind}"] = phase_profile(
            kind, backend, queries, ctx["label"], opts(o))


def phase_profile(kind: str, backend, queries: np.ndarray, label: str,
                  opts) -> dict:
    """Where the device time of one backend goes: ``torch.profiler`` over
    8 batches of 64, kernels summed by name, and the device's busy share
    of the window's wall time."""
    backend(queries[:BATCH], **opts(0))
    torch.cuda.synchronize()

    def run():
        for s in range(0, 8 * BATCH, BATCH):
            backend(queries[s:s + BATCH], **opts(s))

    return profile_window(kind, label, run, 8, BATCH)


def profile_window(kind: str, label: str, run, batches: int,
                   batch: int) -> dict:
    """``torch.profiler`` over ``run()`` (``batches`` batches of ``batch``
    queries, already warm): kernels summed by name (``top``: the largest
    8; ``all``: every one), and the device's busy share of the window's
    wall time.

    Late in a long process a session loses its first GPU records (after
    the sift index phase's windows, up to hundreds of them: the DEEP window
    listed the probe chain and none of the PQ top level before it, though
    the trace held the runtime calls that launched them).  So a session
    first launches ``LEAD_KERNELS`` no-op kernels (``torch.cuda._sleep``),
    which take the loss and are left out of every figure
    (``lead_recorded`` says how many were kept).  A session that still
    recorded fewer kernels than its traced launches is taken again, at
    most four times; ``sessions`` and ``launched`` / ``recorded`` say how
    it went."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for sessions in range(1, 5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        gpu = [e for e in events if e.device_type == DeviceType.CUDA]
        kernels = [e for e in gpu if "spin_kernel" not in e.key]
        lead_recorded = sum(e.count for e in gpu if "spin_kernel" in e.key)
        launched = sum(e.count for e in events
                       if e.key.startswith(("cudaLaunchKernel",
                                            "cuLaunchKernel"))) - LEAD_KERNELS
        recorded = sum(e.count for e in kernels
                       if not e.key.startswith(("Memcpy", "Memset")))
        if recorded >= launched:
            break
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    ranked = [{"name": e.key[:90], "calls": e.count,
               "us_per_batch": e.self_device_time_total / batches}
              for e in kernels]
    out = {"batches": batches, "batch": batch,
           "wall_ms_per_batch": wall_us / 1e3 / batches,
           "device_busy_share": busy_us / wall_us,
           "sessions": sessions, "launched": launched,
           "recorded": recorded, "lead_recorded": lead_recorded,
           "top": ranked[:8], "all": ranked}
    log(f"[profile {kind}] on {label}: {out['wall_ms_per_batch']:.3f} ms "
        f"per batch of {batch}, device busy {out['device_busy_share']:.3f} "
        f"({recorded} kernels recorded of {launched} launches traced, "
        f"session {sessions}; {lead_recorded} of {LEAD_KERNELS} lead "
        f"kernels recorded)")
    for t in out["top"]:
        log(f"[profile {kind}]   {t['us_per_batch']:9.1f} us/batch "
            f"{t['calls']:6d} calls  {t['name']}")
    return out


# --------------------------------------------------------------- phase 8
def exact_top10(q_np: np.ndarray, x: torch.Tensor) -> np.ndarray:
    """Exact top-10 ids of every query by the ``l2_topk`` kernel, in
    batches of ``INDEX_QUERIES``."""
    dev = x.device
    out = []
    for s in range(0, len(q_np), INDEX_QUERIES):
        q = torch.as_tensor(q_np[s:s + INDEX_QUERIES], device=dev)
        out.append(l2_topk.l2_topk(q, x, K)[1].cpu().numpy())
    return np.concatenate(out)


def timed_search(search, queries: np.ndarray, **kw):
    """``search(queries, K, **kw)`` after a warm call on 32 queries: (ids,
    work, per-query host seconds, as fig2d_deep.py measures it)."""
    search(queries[:32], K, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = search(queries, K, **kw)
    per_q = (time.perf_counter() - t0) / len(queries)
    return out[1], (out[2] if len(out) > 2 else None), per_q


def build_spans(tracer: Tracer) -> dict:
    """Seconds of each ``build.*`` span the tracer holds."""
    return {e["name"]: e["dur"] / 1e6 for e in tracer.events()
            if e["name"].startswith("build.")}


def sign_flips(x: np.ndarray, proj: np.ndarray, bits_f32) -> int:
    """Sign bits of ``x @ proj`` that differ from a float64 recompute
    (a product within rounding of zero may land either side)."""
    want = (x.astype(np.float64) @ proj.astype(np.float64)) > 0
    return int((np.asarray(bits_f32, bool) != want).sum())


def phase_index_sift(dev, ctx) -> dict:
    """Table 1's two-level rows at sift-1m width: one k-means build with a
    PQ top, its brute bottom, and the LSH and tree bottoms over the same
    buckets; then the one-level ``lsh_search`` through ``hamming_topk``."""
    corpus, queries = ctx["corpus"], ctx["queries"][:INDEX_QUERIES]
    truth = ctx["truth"][:INDEX_QUERIES]
    out = {}
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        t0 = time.perf_counter()
        index = build_index(IndexSpec("two_level", TwoLevelConfig(
            n_clusters=SIFT_1M.n_clusters, top=SIFT_1M.top, bottom="brute",
            pq_m=8, lsh_bits=BUCKET_LSH_BITS, seed=0)), corpus)
        base = index.two_level
        torch.cuda.synchronize()
        build = {"pq top + brute": time.perf_counter() - t0,
                 "stages": build_spans(tracer)}
    finally:
        set_tracer(old)
    cfg = base.config
    t0 = time.perf_counter()
    lsh_idx = dataclasses.replace(
        base, config=dataclasses.replace(cfg, bottom="lsh"),
        bottom_lsh=lsh_build(corpus, n_bits=BUCKET_LSH_BITS, seed=cfg.seed))
    build["lsh bottom"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_cfg = dataclasses.replace(cfg, bottom="tree")
    tree_idx = dataclasses.replace(base, config=tree_cfg, forest=build_forest(
        corpus, base.bucket_ids, base.bucket_counts, tree_cfg, None))
    ctx["tree_idx"] = tree_idx
    build["tree bottom (one tree per bucket, host)"] = (time.perf_counter()
                                                        - t0)
    log(f"[index sift] build s {build}")
    out["build_s"] = build

    # the LSH bottom's query bits come from a product on the card
    qb = (torch.as_tensor(queries, device=dev)
          @ torch.as_tensor(lsh_idx.bottom_lsh.proj, device=dev) > 0)
    out["lsh64_query_bit_flips_vs_f64"] = sign_flips(
        queries, lsh_idx.bottom_lsh.proj, qb.cpu().numpy())

    reset_launches()
    rows = {}
    for name, idx in (("brute", base), ("lsh", lsh_idx), ("tree", tree_idx)):
        ids, work, per_q = timed_search(idx.search, queries,
                                        nprobe=SIFT_NPROBE, beam_width=BEAM)
        rows[name] = {"recall_at_10": recall_at_k(ids, truth),
                      "per_query_ms": per_q * 1e3,
                      "work_per_query": {k: v / len(queries)
                                         for k, v in work.items()}}
        log(f"[index sift] pq top + {name} bottom, nprobe {SIFT_NPROBE} "
            f"beam {BEAM}: {rows[name]}")
    torch.cuda.synchronize()
    out["two_level"] = rows
    out["two_level_launches"] = read_launches()
    ctx["index_tree_recall"] = rows["tree"]["recall_at_10"]
    for name, idx in (("brute", base), ("lsh", lsh_idx), ("tree", tree_idx)):
        RESULTS[f"profile_sift_pq_{name}"] = profile_window(
            f"sift pq top + {name} bottom", ctx["label"],
            lambda idx=idx: idx.search(queries, K, nprobe=SIFT_NPROBE,
                                       beam_width=BEAM), 1, len(queries))
    log(f"[index sift] launches {out['two_level_launches']}")
    require(out["two_level_launches"]["pq_adc_topk"] > 0,
            "the PQ top level never launched pq_adc_topk")
    out["k100"] = search_index_k100(index, corpus, queries, dev)
    for name, r in rows.items():
        require(r["recall_at_10"] >= 0.5,
                f"sift pq+{name} recall@10 {r['recall_at_10']} is "
                "implausibly low")

    t0 = time.perf_counter()
    flat = lsh_build(corpus, n_bits=FLAT_LSH_BITS, seed=0)
    out["flat_lsh_build_s"] = time.perf_counter() - t0
    qbits = (queries @ flat.proj) > 0
    out["lsh96_query_bit_flips_vs_f64"] = sign_flips(queries, flat.proj,
                                                     qbits)
    out["lsh96_corpus_bits"] = int(corpus.shape[0] * FLAT_LSH_BITS)
    xt = torch.as_tensor(corpus, device=dev)
    reset_launches()
    lsh_rows = {}
    for nc in LSH_CANDIDATES:
        ids, _, per_q = timed_search(
            lambda q, k, n_candidates: lsh_search(
                flat, xt, q, k, n_candidates=n_candidates), queries,
            n_candidates=nc)
        lsh_rows[nc] = {"recall_at_10": recall_at_k(ids, truth),
                        "per_query_ms": per_q * 1e3}
        log(f"[index sift] one-level lsh_search {FLAT_LSH_BITS} bits, "
            f"n_candidates {nc}: {lsh_rows[nc]}")
    torch.cuda.synchronize()
    out["lsh_search"] = lsh_rows
    out["lsh_launches"] = read_launches()
    RESULTS["profile_sift_lsh_search"] = profile_window(
        f"sift lsh_search n_candidates {LSH_CANDIDATES[-1]}", ctx["label"],
        lambda: lsh_search(flat, xt, queries, K,
                           n_candidates=LSH_CANDIDATES[-1]), 1, len(queries))
    log(f"[index sift] launches {out['lsh_launches']}")
    require(out["lsh_launches"]["hamming_topk"] > 0,
            "lsh_search never launched hamming_topk")
    log(f"[index sift] query sign-bit flips vs float64: 64-bit bucket "
        f"codes {out['lsh64_query_bit_flips_vs_f64']}, 96-bit flat "
        f"{out['lsh96_query_bit_flips_vs_f64']}")

    # hamming_topk at the one-level scan's shapes (B = 1,024, N = 1M,
    # W = 3, k = 1,024), on lsh_search's own operands
    qc = torch.as_tensor(pack_bits(qbits.astype(np.uint8)), device=dev)
    codes = torch.as_tensor(flat.codes, device=dev)
    kk = LSH_CANDIDATES[-1]
    res = check_hamming("shape hamming_topk B1024 N1M W3 k1024", qc, codes,
                        kk)
    res["ms"] = time_ms(lambda: hamming.hamming_topk(qc, codes, kk), 10)
    res["ms_k64"] = time_ms(lambda: hamming.hamming_topk(
        qc, codes, LSH_CANDIDATES[0]), 10)
    res["plain_ms"] = time_ms(lambda: ref.hamming_topk_ref(qc, codes, kk), 2,
                              warmup=1)
    pm = (2.0 * qbits - 1.0).astype(np.float32)          # (B, bits) +-1
    cbits = ((corpus @ flat.proj) > 0)
    cm = torch.as_tensor((2.0 * cbits - 1.0).astype(np.float32), device=dev)
    pmt = torch.as_tensor(pm, device=dev)
    half = torch.full((1, 1), FLAT_LSH_BITS / 2.0, device=dev)
    res["library_ms"] = time_ms(lambda: torch.topk(torch.addmm(
        half, pmt, cm.T, alpha=-0.5), kk, largest=False), 10)
    res["library_ms_k64"] = time_ms(lambda: torch.topk(torch.addmm(
        half, pmt, cm.T, alpha=-0.5), LSH_CANDIDATES[0], largest=False), 10)
    res["library_call"] = ("torch.topk(torch.addmm(n_bits / 2, s_q, s_x.T, "
                           "alpha=-1/2)) over +-1 bit expansions: two calls")
    del cm
    B, W = qc.shape
    N = codes.shape[0]
    nbytes = 4.0 * (N * W + B * W) + 8.0 * B * kk
    # the operations at their own rates (the CUDA C++ Programming Guide's
    # arithmetic-instruction throughput table, compute capability 9.0, a
    # clock an SM): population count 16, 32-bit XOR and add 64.  The
    # kernel's carry-save adder takes two popcounts for three words.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res["sm_clock_mhz"] = sm_clocks_mhz()
    per_s = sms * res["sm_clock_mhz"]["max"] * 1e6
    res["popc"] = float(B) * N * (2 * (W // 3) + W % 3)
    res["popc_ms"] = res["popc"] / (POPC_PER_CLOCK_SM * per_s) * 1e3
    res["int_ms"] = 2.0 * B * N * W / (INT_PER_CLOCK_SM * per_s) * 1e3
    res["popc_each_word_ms"] = (float(B) * N * W
                                / (POPC_PER_CLOCK_SM * per_s) * 1e3)
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["bound_ms"] = max(res["bytes_ms"], res["popc_ms"], res["int_ms"])
    res["bound_by"] = ("bytes" if res["bound_ms"] == res["bytes_ms"]
                       else "operations")
    # the figure held until this bound counted popcounts at their rate:
    # 3 B N W operations at the fp32 rate
    res["fp32_rate_bound_ms"] = 3.0 * B * N * W / FP32_FLOPS_PER_S * 1e3
    res["shape"] = [B, N, W, kk]
    RESULTS["kernels"]["hamming_topk"] = res
    log(f"[shape hamming_topk] ms {res['ms']:.4f} (k=64: "
        f"{res['ms_k64']:.4f}) bound {res['bound_ms']:.4f} "
        f"({res['bound_by']}: {res['popc']:.4g} popcounts at "
        f"{POPC_PER_CLOCK_SM} a clock an SM, {res['sm_clock_mhz']['max']} "
        f"MHz; XOR and add {res['int_ms']:.4f}; bytes "
        f"{res['bytes_ms']:.4f}; a popcount a word "
        f"{res['popc_each_word_ms']:.4f}; the old fp32-rate figure "
        f"{res['fp32_rate_bound_ms']:.4f}) plain {res['plain_ms']:.3f} "
        f"library {res['library_ms']:.4f} (k=64: "
        f"{res['library_ms_k64']:.4f})")
    del xt
    return out


def search_index_k100(index, corpus, queries, dev) -> dict:
    """``SearchIndex.search`` at k = 100 on the sift two-level index (PQ top,
    brute bottom, nprobe 32), on the card: the PQ top level at k = nprobe,
    the probe chain in four passes; recall@100 against the exact top-100
    of the ``l2_topk`` kernel (four passes a batch), whose first batch is
    held against its plain version."""
    x = torch.as_tensor(corpus, device=dev)
    q0 = torch.as_tensor(queries[:BATCH], device=dev)
    check_l2("index sift exact top-100", q0, x, K_LARGE)
    exact = []
    for s0 in range(0, len(queries), INDEX_QUERIES):
        qb = torch.as_tensor(queries[s0:s0 + INDEX_QUERIES], device=dev)
        exact.append(l2_topk.l2_topk(qb, x, K_LARGE)[1].cpu().numpy())
    exact = np.concatenate(exact)
    del x
    reset_launches()
    t0 = time.perf_counter()
    d, ids, _ = index.search(queries, K_LARGE, nprobe=SIFT_NPROBE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    require(ids.shape == (len(queries), K_LARGE) and (ids >= 0).all()
            and np.isfinite(d).all(), "search at k=100: sentinels or shape")
    require(all((np.diff(r) >= 0).all() for r in d),
            "search at k=100: distances out of order")
    out = {"recall_at_100": recall_at_k(ids, exact),
           "per_query_ms": wall / len(queries) * 1e3,
           "launches": launches}
    log(f"[index sift] SearchIndex.search k={K_LARGE} nprobe {SIFT_NPROBE}: "
        f"recall@100 {out['recall_at_100']:.4f} against the exact top-100, "
        f"{out['per_query_ms']:.5f} ms a query (cold call), launches "
        f"{launches}")
    require(launches["candidate_topk"] > 0 and launches["pq_adc_topk"] > 0,
            "search at k=100 ran no kernel")
    require(out["recall_at_100"] >= 0.5, "recall@100 is implausibly low")
    return out


def phase_index_deep(dev, label: str) -> dict:
    """Fig. 2(d) at the paper's 10M claim: DEEP-10M through ``build_index``
    with the DEEP_10M settings, nprobe 8-64, and ``pq_adc_topk`` at the
    top level's shapes."""
    out = {}
    t0 = time.perf_counter()
    deep = make_corpus("deep", seed=0)
    queries = make_queries(deep, INDEX_QUERIES, seed=1)
    out["corpus_s_host"] = time.perf_counter() - t0
    require(deep.shape == (DEEP_10M.n, DEEP_10M.d), "corpus is not deep-10m")
    log(f"[index deep] corpus {deep.shape} {out['corpus_s_host']:.1f} s "
        "(host)")
    chosen = select_index_spec(deep.shape[0], embedding_dim=deep.shape[1])
    out["protocol_choice"] = {"kind": chosen.kind, "reason": chosen.reason,
                              "config": chosen.two_level and
                              dataclasses.asdict(chosen.two_level)}
    log(f"[index deep] the 5.3 protocol would choose "
        f"{out['protocol_choice']}; built "
        f"with DEEP_10M: n_clusters {DEEP_10M.n_clusters} top "
        f"{DEEP_10M.top} bottom {DEEP_10M.bottom}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x = torch.as_tensor(deep, device=dev)
    truth = exact_top10(queries, x)
    torch.cuda.synchronize()
    out["exact_truth_s"] = time.perf_counter() - t0
    del x
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        t0 = time.perf_counter()
        index = build_index(IndexSpec("two_level", TwoLevelConfig(
            n_clusters=DEEP_10M.n_clusters, top=DEEP_10M.top,
            bottom=DEEP_10M.bottom, pq_m=8, seed=0)), deep)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        out["build_stages_s"] = build_spans(tracer)
    finally:
        set_tracer(old)
    idx = index.two_level
    counts = idx.bucket_counts
    require(int(counts.sum()) == DEEP_10M.n, "build lost entities")
    out["cap"] = int(idx.bucket_ids.shape[1])
    out["footprint_bytes"] = int(index.footprint_bytes())
    log(f"[index deep] build {out['build_s']:.1f} s, stages "
        f"{out['build_stages_s']}; cap {out['cap']}, bucket sizes "
        f"min/mean/max {counts.min()}/{counts.mean():.1f}/{counts.max()}; "
        f"footprint {out['footprint_bytes']} bytes")

    reset_launches()
    rows = {}
    for nprobe in DEEP_NPROBES:
        ids, work, per_q = timed_search(index.search, queries,
                                        nprobe=nprobe)
        rows[nprobe] = {"recall_at_10": recall_at_k(ids, truth),
                        "per_query_ms": per_q * 1e3,
                        "work_per_query": {k: v / len(queries)
                                           for k, v in work.items()}}
        log(f"[index deep] nprobe {nprobe}: {rows[nprobe]}")
    torch.cuda.synchronize()
    out["search"] = rows
    out["launches"] = read_launches()
    out["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    prof = profile_window("deep nprobe 32", label,
                          lambda: index.search(queries, K, nprobe=32),
                          1, len(queries))
    RESULTS["profile_deep_nprobe32"] = prof
    pq_rows = [t for t in prof["all"] if "pq_adc" in t["name"]]
    log("[index deep] profile: PQ top level "
        + (", ".join(f"{t['name'][:60]} {t['us_per_batch']:.1f} us"
                     for t in pq_rows) or "NOT in the window")
        + f"; {len(prof['all'])} kernels in the window")
    log(f"[index deep] launches {out['launches']}; max_memory_allocated "
        f"{out['max_memory_allocated_bytes']}")
    require(out["launches"]["pq_adc_topk"] > 0,
            "the DEEP PQ top level never launched pq_adc_topk")
    require(out["launches"]["candidate_topk"] > 0,
            "the DEEP brute bottom never launched candidate_topk")
    require(rows[32]["recall_at_10"] >= 0.5,
            f"deep recall@10 {rows[32]['recall_at_10']} at nprobe 32 is "
            "implausibly low")

    # the probe chain at the brute bottom's shape (B = 1,024, nprobe 32,
    # rows read by entity id) on the index's own tables: against its plain
    # version and float64, timed beside its bound, the plain version and
    # the gather + baddbmm + topk yardstick (a 9.6 GB gather)
    t = idx._tables(dev)
    q = torch.as_tensor(queries, device=dev)
    bids, db = t["bucket_ids"], t["db"]
    # the plain chain on the same probes: the kernel moves no recall
    for nprobe in DEEP_NPROBES:
        probe, _ = idx._top_probe(t, q, nprobe)
        plain_ids = ref.bucket_probe_topk_ref(q, probe, bids, K, db=db)[1]
        rows[nprobe]["recall_at_10_plain_chain"] = recall_at_k(
            plain_ids.cpu().numpy(), truth)
    log("[index deep] recall@10 kernel / plain chain: " + ", ".join(
        f"nprobe {n} {r['recall_at_10']:.5f} / "
        f"{r['recall_at_10_plain_chain']:.5f}" for n, r in rows.items()))
    probe, _ = idx._top_probe(t, q, DEEP_10M.nprobe)
    res = check_chain("deep chain B1024 nprobe32", q, probe, bids, K, db)
    res["ms"] = time_ms(lambda: bucket_topk.bucket_probe_topk(
        q, probe, bids, K, db=db), 20)
    res["plain_ms"] = time_ms(lambda: ref.bucket_probe_topk_ref(
        q, probe, bids, K, db=db), 3, warmup=1)
    res["library_ms"] = time_ms(chain_yardstick(q, probe, bids, K, db=db), 3,
                                warmup=1)
    res["library_call"] = CHAIN_YARDSTICK
    res.update(chain_bound(q, probe, bids, K))
    RESULTS["kernels"]["candidate_topk"]["deep"] = res
    log(f"[shape candidate_topk deep] pairs {res['pairs']} ms "
        f"{res['ms']:.4f} bound {res['bound_ms']:.4f} ({res['bound_by']}; "
        f"pair by pair {res['pair_bytes_ms']:.4f}) plain "
        f"{res['plain_ms']:.3f} library {res['library_ms']:.4f}")
    del q

    # pq_adc_topk at the top level's shapes (B = 1,024, N = 32,768, M = 8,
    # k = nprobe) on the index's own codebooks and codes; the probed
    # buckets of every nprobe against the plain version on the card
    q = torch.as_tensor(queries, device=dev)
    lut = adc_lut(q, torch.as_tensor(idx.top_pq.codebooks, device=dev))
    codes = torch.as_tensor(idx.top_pq.codes, device=dev)
    for nprobe in DEEP_NPROBES:
        check_pq(f"deep probe pq_adc_topk nprobe {nprobe}", lut, codes,
                 nprobe)
    kk = DEEP_10M.nprobe
    res = check_pq("shape pq_adc_topk B1024 N32768 M8 k32", lut, codes, kk)
    res["ms"] = time_ms(lambda: pq_adc.pq_adc_topk(lut, codes, kk), 20)
    res["ms_k64"] = time_ms(lambda: pq_adc.pq_adc_topk(lut, codes, 64), 20)
    res["plain_ms"] = time_ms(lambda: ref.pq_adc_topk_ref(lut, codes, kk), 5,
                              warmup=1)
    B, M, _ = lut.shape
    N = codes.shape[0]
    cidx = codes.long().T[None].expand(B, M, N)
    res["library_ms"] = time_ms(lambda: torch.topk(
        torch.gather(lut, 2, cidx).sum(1), kk, largest=False), 20)
    res["library_ms_k64"] = time_ms(lambda: torch.topk(
        torch.gather(lut, 2, cidx).sum(1), 64, largest=False), 20)
    res["library_call"] = ("torch.topk(torch.gather(lut, 2, codes).sum(1)):"
                           " three calls")
    # above the 64-pair lists: passes of 64, bit for bit the plain version
    for k in (65, K_LARGE):
        check_pq(f"shape pq_adc_topk B1024 N32768 M8 k{k}", lut, codes, k)
    _, passes = counted("pq_adc_topk",
                        lambda: pq_adc.pq_adc_topk(lut, codes, K_LARGE))
    res["k100"] = {"passes": passes, "ms": time_ms(
        lambda: pq_adc.pq_adc_topk(lut, codes, K_LARGE), 20)}
    log(f"[large k] pq_adc_topk: k={K_LARGE} {passes} passes "
        f"{res['k100']['ms']:.4f} ms (k={kk}: {res['ms']:.4f} ms)")
    nbytes = 4.0 * B * M * 256 + 1.0 * N * M + 8.0 * B * kk
    res["bound_ms"], res["bound_by"] = bound(nbytes, 1.0 * B * N * M)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res["splits"] = pq_adc.splits_for(B, N, sms)
    # beside the bound: each of the B N M adds reads its LUT entry from
    # shared memory, at most 32 a clock on each SM (no bank conflicts)
    res["sm_clock_mhz"] = sm_clocks_mhz()
    res["lookups"] = float(B) * N * M
    res["lookup_ms"] = res["lookups"] / (
        32.0 * sms * res["sm_clock_mhz"]["max"] * 1e6) * 1e3
    res["shape"] = [B, N, M, kk]
    RESULTS["kernels"]["pq_adc_topk"] = res
    log(f"[shape pq_adc_topk] ms {res['ms']:.4f} (k=64: "
        f"{res['ms_k64']:.4f}; {res['splits']} split(s)) "
        f"bound {res['bound_ms']:.5f} "
        f"({res['bound_by']}; shared-memory lookups {res['lookup_ms']:.5f} "
        f"at {res['sm_clock_mhz']['max']} MHz, clock after the runs "
        f"{res['sm_clock_mhz']['now']} MHz) plain {res['plain_ms']:.3f} "
        f"library {res['library_ms']:.4f} (k=64: "
        f"{res['library_ms_k64']:.4f})")
    return out


def radio_work(tree, db, q, gt, dev) -> dict:
    """fig1_qlbt.py's measure: the narrowest beam whose recall@10 of the
    true entity reaches ``RADIO_RECALL``, with the mean and P90 of the
    work (internal-node dot products + leaf candidates) per query."""
    arrays = tree.device_arrays(dev)
    for w in RADIO_BEAMS:
        res = tree_search(arrays, db, q, kind=tree.kind, beam_width=w, k=K,
                          max_steps=tree.max_depth + 4)
        r = recall_at_k(res.ids.cpu().numpy(), gt)
        if r >= RADIO_RECALL:
            work = (res.internal_visits + res.candidates).cpu().numpy()
            return {"beam": w, "recall_at_10": r,
                    "mean_work": float(work.mean()),
                    "p90_work": float(np.percentile(work, 90))}
    raise CheckFailed(f"no beam up to {RADIO_BEAMS[-1]} reached recall@10 "
                      f"{RADIO_RECALL}")


def phase_index_radio(dev) -> dict:
    """Fig. 1 / §5.3 at the radio-station size: ``auto_build_index`` picks
    QLBT when the traffic ``p`` is known and the balanced tree when not;
    QLBT's expected depth under ``p`` and its work at recall 0.95."""
    db = make_corpus("radio_station", seed=0)
    require(db.shape == (RADIO_STATION.n, RADIO_STATION.d),
            "corpus is not radio-station")
    _, u, p = beta_for_unbalance(RADIO_UNBALANCE, db.shape[0])
    q_np, gt = sample_queries(np.random.default_rng(0), db, p, RADIO_QUERIES)
    out = {"unbalance": u}
    idxs = {}
    for name, traffic in (("qlbt", p), ("tree", None)):
        t0 = time.perf_counter()
        idxs[name] = auto_build_index(db, p=traffic)
        out[f"{name}_build_s"] = time.perf_counter() - t0
        require(idxs[name].spec.kind == name,
                f"§5.3 chose {idxs[name].spec.kind}, not {name}")
    xt = torch.as_tensor(db, device=dev)
    qt = torch.as_tensor(q_np, device=dev)
    exact = exact_top10(q_np, xt)
    reset_launches()
    for name, idx in idxs.items():
        r = radio_work(idx.tree, xt, qt, gt, dev)
        r["expected_depth"] = idx.tree.expected_depth(p)
        ids, work, per_q = timed_search(idx.search, q_np,
                                        beam_width=r["beam"])
        r["recall_at_10_vs_exact_top10"] = recall_at_k(ids, exact)
        r["per_query_ms"] = per_q * 1e3
        # split margins near zero may round to the other side on the card:
        # the same descent on the CPU, query by query
        res = tree_search(idx.tree.device_arrays(dev), xt, qt,
                          kind=idx.tree.kind, beam_width=r["beam"], k=K,
                          max_steps=idx.tree.max_depth + 4)
        cpu = tree_search(idx.tree.device_arrays("cpu"), xt.cpu(), qt.cpu(),
                          kind=idx.tree.kind, beam_width=r["beam"], k=K,
                          max_steps=idx.tree.max_depth + 4)
        r["queries_off_cpu_descent"] = int((
            (res.internal_visits.cpu() != cpu.internal_visits)
            | (res.ids.cpu() != cpu.ids).any(dim=1)).sum())
        out[name] = r
        log(f"[index radio] {name}: {r}")
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    out["mean_work_gain"] = 1 - out["qlbt"]["mean_work"] / out["tree"][
        "mean_work"]
    out["p90_work_gain"] = 1 - out["qlbt"]["p90_work"] / out["tree"][
        "p90_work"]
    log(f"[index radio] U {u:.3f}: E[depth] qlbt "
        f"{out['qlbt']['expected_depth']:.3f} vs tree "
        f"{out['tree']['expected_depth']:.3f}; work gain mean "
        f"{out['mean_work_gain']:.3f} p90 {out['p90_work_gain']:.3f}")
    require(out["qlbt"]["expected_depth"] < out["tree"]["expected_depth"],
            "QLBT is not shallower than the balanced tree under p")
    return out


def phase_index(dev, ctx) -> None:
    out = {"label": ctx["label"]}
    with phase("index sift-1m"):
        out["sift"] = phase_index_sift(dev, ctx)
    with phase("index deep-10m"):
        out["deep"] = phase_index_deep(dev, ctx["label"])
    with phase("index radio-station"):
        out["radio"] = phase_index_radio(dev)
    RESULTS["index"] = out
    RESULTS["kernels"]["pq_adc_topk"]["launches"] = (
        out["sift"]["two_level_launches"]["pq_adc_topk"]
        + out["deep"]["launches"]["pq_adc_topk"])
    RESULTS["kernels"]["hamming_topk"]["launches"] = out["sift"][
        "lsh_launches"]["hamming_topk"]
    RESULTS["kernels"]["candidate_topk"]["deep_launches"] = out["deep"][
        "launches"]["candidate_topk"]


# ------------------------------------------------------------ phase 10
FOREST_HEADROOM = 1.25     # bucket, node and leaf room for the adds
LIFE_ADDS = 10_000         # 1 % of sift-1m: 100 near each of 100 buckets
LIFE_HOT = 100
LIFE_DELETES = 10_000      # the members of whole cold buckets
LIFE_CHUNK = 1024          # queries a call in the lifecycle's checks
STAGE_KERNELS = (("descent gathers", r"index|gather|Gather|take"),
                 ("node products", r"gemm|gemv|Gemm|xmma|cutlass|bmm|dot"),
                 ("beam sorts", r"[sS]ort|radix|Radix|topk"))


def forest_parity(name, a, b, queries, db, floor: float = 0.99) -> dict:
    """Fused (a) against unfused (b) forest answers: the same sentinel
    slots, and ids equal except at near-ties (fault 7), each differing
    slot's two entities recomputed in float64 and within REL * (qn + xn)
    of each other; the unfused answer's repeated ids are counted (fault 5:
    the fused rerank emits a pair once)."""
    require(np.array_equal(np.isinf(a[0]), np.isinf(b[0])),
            f"{name}: sentinel slots differ")
    differ = a[1] != b[1]
    rows, cols = np.nonzero(differ)
    gaps = []
    for r, c in zip(rows, cols):
        ia, ib = int(a[1][r, c]), int(b[1][r, c])
        q64 = queries[r].astype(np.float64)
        xa, xb = db[ia].astype(np.float64), db[ib].astype(np.float64)
        gap = abs(((q64 - xa) ** 2).sum() - ((q64 - xb) ** 2).sum())
        gaps.append(gap / ((q64 ** 2).sum() + max((xa ** 2).sum(),
                                                  (xb ** 2).sum())))
    worst = float(max(gaps, default=0.0))
    repeats = int(sum((row >= 0).sum() - len(set(row[row >= 0].tolist()))
                      for row in b[1]))
    agree = float((~differ).mean())
    out = {"agree": agree, "differing": int(differ.sum()),
           "worst_f64_gap_rel": worst, "unfused_repeated_ids": repeats}
    log(f"[parity] {name}: {out}")
    require(worst <= REL, f"{name}: ids differ off a near-tie")
    require(agree >= floor, f"{name}: ids agree on {agree} < {floor}")
    return out


def forest_local_stages(be, q):
    """The forest local of ``be`` on its own placed tables, stage by stage
    (the local's own calls in its order), each stage under a
    ``record_function`` range.  Returns (dists, ids, candidate slot ids,
    the (Kloc cap, d) rows they index)."""
    from torch.profiler import record_function

    (cents, valid, roots, bids, bvecs, proj, dims, tau, children, leaf_row,
     leaf_ents) = (t[0] for t in be._args)
    arrays = dict(proj=proj, dims=dims, tau=tau, children=children,
                  leaf_row=leaf_row, leaf_entities=leaf_ents)
    B, d = q.shape
    sh = be._shapes
    with record_function("forest: centroid scan"):
        d2c = torch.where(valid[None, :], pairwise_l2sq(q, cents),
                          float("inf"))
    with record_function("forest: probe sort"):
        _, probe = stable_topk(d2c, min(be.nprobe_local, cents.shape[0]))
    with record_function("forest: descent"):
        res = tree_search(arrays, bvecs.reshape(-1, d),
                          torch.repeat_interleave(q, probe.shape[1], dim=0),
                          kind="rp", beam_width=be.beam_width,
                          k=be.beam_width * sh.leaf_sz,
                          max_steps=sh.max_depth + 4, rerank=False,
                          roots=roots[probe].reshape(-1))
        flat = bids.reshape(-1)
        cand = res.ids.reshape(B, -1)
        cand = torch.where(
            (cand >= 0) & (flat[cand.clamp(min=0).long()] >= 0), cand, -1)
    rows = bvecs.reshape(-1, d)
    with record_function("forest: rerank"):
        ld, slot = bucket_topk.candidate_rows_topk(q, rows, cand, be.k)
        li = torch.where((slot >= 0) & ~torch.isinf(ld),
                         flat[slot.clamp(min=0).long()], -1)
    return ld, li, cand, rows


def forest_stage_profile(be, q, label: str) -> dict:
    """Device time of one batch by stage of the forest local (the
    ``record_function`` ranges' kernels), the descent's kernels split into
    gathers, node products, beam sorts and the rest by kernel name; beside
    it each stage's time by CUDA events, the stages run one at a time."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forest_local_stages(be, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        forest_local_stages(be, q)
        torch.cuda.synchronize()

    def kernels_of(e):
        out = [(k.name, k.duration) for k in e.kernels]
        for ch in e.cpu_children:
            out += kernels_of(ch)
        return out

    stages, descent = {}, {name: 0.0 for name, _ in STAGE_KERNELS}
    descent["descent other"] = 0.0
    for e in prof.events():
        # the host-side range (the device timeline repeats each range as a
        # user annotation with no kernels of its own)
        if (not e.name.startswith("forest: ")
                or e.device_type != DeviceType.CPU):
            continue
        ks = kernels_of(e)
        stage = e.name[len("forest: "):]
        stages[stage] = stages.get(stage, 0.0) + sum(dur for _, dur in ks)
        if e.name == "forest: descent":
            for kname, dur in ks:
                for cat, pat in STAGE_KERNELS:
                    if re.search(pat, kname):
                        descent[cat] += dur
                        break
                else:
                    descent["descent other"] += dur
    # CUDA events around each stage, one at a time
    events = {}
    (cents, valid, *_rest) = (t[0] for t in be._args)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for name, fn in (
            ("centroid scan", lambda: pairwise_l2sq(q, cents)),
            ("whole local", lambda: forest_local_stages(be, q))):
        fn()
        torch.cuda.synchronize()
        marks[0].record()
        fn()
        marks[1].record()
        marks[1].synchronize()
        events[name] = marks[0].elapsed_time(marks[1]) * 1e3
    out = {"stage_us": stages, "descent_us": descent,
           "events_us": events,
           "measured": bool(sum(stages.values()) > 0)}
    log(f"[profile forest stages] on {label}: one batch of {q.shape[0]}: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in stages.items())
        + "; descent: " + ", ".join(f"{k} {v:.1f} us"
                                    for k, v in descent.items())
        + f"; CUDA events: {events}")
    if not out["measured"]:
        log("[profile forest stages] the ranges recorded no device time: "
            "not measured")
    return out


def shape_rows(dev, be, queries) -> dict:
    """``candidate_topk``'s rows-by-id entry at the served forest's shape
    (B 64, C = nprobe 32 x beam 8 x leaf 8 = 2,048 slot ids a query, d
    128) on the forest backend's own rows and candidates: against its
    plain version at k 10 and 33 / 64 / 100, timed (CUDA graph replays)
    beside its bound, the plain version, the library yardstick (gather,
    ``torch.baddbmm``, ``torch.topk``) and the tile entry on the gathered
    rows with the gather timed on its own."""
    q = torch.as_tensor(queries[:BATCH], device=dev)
    ld, li, cand, rows = forest_local_stages(be, q)
    want = be(queries[:BATCH])
    torch.cuda.synchronize()
    require(np.array_equal(li.cpu().numpy(), want[1])
            and np.array_equal(ld.cpu().numpy().view(np.int32),
                               want[0].view(np.int32)),
            "the forest local run stage by stage differs from the backend")
    B, C = cand.shape
    D = rows.shape[1]
    res = check_rows(f"shape candidate_topk rows-by-id B{B} C{C}", q, rows,
                     cand, K)
    near = 0
    for k in LARGE_KS:
        near += check_rows(f"shape rows-by-id k={k}", q, rows, cand,
                           k)["near_ties"]
    res["large_k_near_ties"] = near
    res["ms"] = time_graph_ms(
        lambda: bucket_topk.candidate_rows_topk(q, rows, cand, K), 100)
    res["plain_ms"] = time_graph_ms(
        lambda: ref.candidate_rows_topk_ref(q, rows, cand, K), 3)
    live = cand.clamp(min=0).long()
    tile = rows[live].contiguous()
    res["gather_ms"] = time_graph_ms(lambda: rows[live], 20)
    res["tile_entry_ms"] = time_graph_ms(
        lambda: bucket_topk.candidate_topk(q, tile, cand, K), 100)
    vn = torch.where(cand >= 0, (rows * rows).sum(1)[live], float("inf"))
    qn = (q * q).sum(1)[:, None]

    def library():
        d = torch.baddbmm((vn + qn)[..., None], rows[live], q[:, :, None],
                          alpha=-2.0)[..., 0]
        return torch.topk(d, K, largest=False)

    res["library_ms"] = time_graph_ms(library, 20)
    res["library_call"] = ("rows[ids] gather + torch.baddbmm + torch.topk, "
                           "row norms precomputed: three calls")
    (kd, _), passes = counted("candidate_topk", lambda: (
        bucket_topk.candidate_rows_topk(q, rows, cand, K_LARGE)))
    res["k100"] = {"ms": time_graph_ms(lambda: bucket_topk.candidate_rows_topk(
        q, rows, cand, K_LARGE), 20), "passes": passes}
    pairs = int((cand >= 0).sum())
    distinct = int(torch.unique(cand[cand >= 0]).numel())
    nbytes = 4.0 * (distinct * D + B * C + B * D) + 8.0 * B * K
    flops = (4.0 * D + 3.0) * pairs + 2.0 * B * D
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res.update(pairs=pairs, distinct_rows=distinct,
               pair_bytes_ms=4.0 * pairs * D / HBM_BYTES_PER_S * 1e3,
               gather_bytes=4 * B * C * D, shape=[B, C, D, K])
    log(f"[shape candidate_topk rows-by-id] B={B} C={C} d={D} pairs {pairs} "
        f"(distinct rows {distinct}) ms {res['ms']:.5f} bound "
        f"{res['bound_ms']:.5f} ({res['bound_by']}; pair by pair "
        f"{res['pair_bytes_ms']:.5f}) plain {res['plain_ms']:.4f} library "
        f"{res['library_ms']:.5f}; the gathered tile: gather "
        f"{res['gather_ms']:.5f} ({res['gather_bytes'] / 2**20:.0f} MiB) + "
        f"tile entry {res['tile_entry_ms']:.5f}; k=100 "
        f"{res['k100']['passes']} passes {res['k100']['ms']:.5f}")
    return res


def phase_forest_serve(dev, ctx) -> dict:
    """The served forest kind at sift-1m width: the index phase's tree
    bottom (8,192 buckets, leaf 8) through ``ServingCell.sharded(kind=
    "auto")`` (nprobe 32, beam 8, k 10) answering 2,048 requests from 16
    clients; recall@10 against the exact top-10; launches reset just
    before and read just after; fused against unfused on every batch;
    filtered at selectivity 0.05 and 0.5; k = 50; a stage profile; the
    rows-by-id shape."""
    tree_idx = ctx["tree_idx"]
    corpus, queries, truth, label = (ctx[k] for k in (
        "corpus", "queries", "truth", "label"))
    tree_idx.metadata = ctx["meta"]
    t0 = time.perf_counter()
    cell = ServingCell.sharded(
        tree_idx, kind="auto", k=K, nprobe_local=SIFT_NPROBE,
        beam_width=BEAM, headroom=FOREST_HEADROOM, delta_updates=True,
        max_batch=BATCH, max_wait_ms=2.0)
    be = cell.search_fn
    torch.cuda.synchronize()
    out = {"place_s": time.perf_counter() - t0,
           "shapes": dataclasses.asdict(be._shapes),
           "full_bytes": be._full_bytes}
    require(be.kind == "forest", f"auto picked {be.kind}, not forest")
    log(f"[forest] placed in {out['place_s']:.1f} s: slab shapes "
        f"{out['shapes']}, {out['full_bytes']} bytes")
    be(queries[:BATCH])
    torch.cuda.synchronize()
    reset_launches()
    ids, dists, lat, wall = serve(cell, queries)
    torch.cuda.synchronize()
    launches = read_launches()
    stats = cell.stats()
    cell.close()
    log(f"[forest] launches {launches}")
    require(launches["candidate_topk"] > 0,
            "the forest path never launched candidate_topk")
    require(all(v == 0 for n, v in launches.items() if n != "candidate_topk"),
            "the forest path launched another kernel")
    require((ids >= 0).all() and np.isfinite(dists).all(),
            "served forest results hold sentinels or non-finite distances")
    qn = (queries.astype(np.float64) ** 2).sum(1)
    xn = (corpus.astype(np.float64) ** 2).sum(1)
    d64 = ((queries[:, None, :].astype(np.float64)
            - corpus[ids].astype(np.float64)) ** 2).sum(-1)
    pair_err = np.abs(d64 - dists) / (qn[:, None] + xn[ids])
    require((pair_err <= REL).all(), "a served forest id carries a wrong "
            "distance")
    recall = recall_at_k(ids, truth)
    out.update({
        "requests": int(len(queries)), "clients": N_CLIENTS,
        "recall_at_10": recall,
        "index_path_tree_recall_at_10": ctx["index_tree_recall"],
        "p50_ms": float(np.percentile(lat * 1e3, 50)),
        "p99_ms": float(np.percentile(lat * 1e3, 99)),
        "qps": len(queries) / wall, "wall_s": wall,
        "dispatches": stats.dispatches,
        "launches": launches,
        "launches_per_batch": launches["candidate_topk"]
        / max(stats.dispatches, 1),
        "mean_batch": len(queries) / max(stats.dispatches, 1),
        "max_rel_err_f64": float(pair_err.max()), "stages": stats.stages})
    log(f"[forest] {len(queries)} requests, {N_CLIENTS} clients on {label}: "
        f"recall@10 {recall:.4f} (index path, tree bottom, PQ top: "
        f"{ctx['index_tree_recall']:.4f}) p50 {out['p50_ms']:.3f} ms p99 "
        f"{out['p99_ms']:.3f} ms QPS {out['qps']:.1f}; "
        f"{out['launches_per_batch']:.2f} candidate_topk launches a batch "
        f"of {out['mean_batch']:.1f}")
    log(f"[forest] stages {json.dumps(stats.stages)}")
    require(recall >= ctx["index_tree_recall"] - 0.05,
            "served forest recall@10 is far below the index path's")

    fused = batched(be, queries)
    served_agree = float((ids == fused[1]).mean())
    require(served_agree >= 0.99, "forest cell answers differ from the "
            "backend's")
    unfused_be = ShardedSearchBackend(
        tree_idx, k=K, nprobe_local=SIFT_NPROBE, beam_width=BEAM,
        headroom=FOREST_HEADROOM, fused=False)
    out["parity"] = forest_parity("forest fused vs unfused, every batch",
                                  fused, batched(unfused_be, queries),
                                  queries, corpus)
    del unfused_be
    out["served_direct_agree"] = served_agree

    out["filtered"] = {}
    rows = queries[:N_IVF_OPTION_REQUESTS]
    for sel, spec in (("0.05", NARROW), ("0.5", WIDE)):
        got = batched(lambda qb, s=spec: be(qb, filter_spec=s), rows)
        exact = batched(lambda qb, s=spec: ctx["brute"](qb, filter_spec=s),
                        rows)
        require_admitted(f"forest filtered {sel}", got[1], spec, ctx["meta"])
        out["filtered"][sel] = {
            "recall_at_10_vs_filtered_exact": recall_at_k(got[1], exact[1]),
            "sentinel_share": float((got[1] < 0).mean())}
    log(f"[forest] filtered: {out['filtered']}")

    k = K_BACKEND_LARGE
    q50 = queries[:4 * BATCH]
    f50 = ShardedSearchBackend(tree_idx, k=k, nprobe_local=SIFT_NPROBE,
                               beam_width=BEAM)
    p50 = ShardedSearchBackend(tree_idx, k=k, nprobe_local=SIFT_NPROBE,
                               beam_width=BEAM, fused=False)
    a, b = batched(f50, q50), batched(p50, q50)
    del f50, p50
    k50 = forest_parity(f"forest k={k} vs unfused", a, b, q50, corpus,
                        floor=0.9)
    brute50 = ShardedSearchBackend(corpus, kind="brute", k=k)
    k50["forest_recall_at_50_vs_brute"] = recall_at_k(
        a[1], batched(brute50, q50)[1])
    del brute50
    RESULTS["main"]["k50"]["forest"] = k50
    log(f"[serve] backends at k={k} on the card, forest: {k50}")

    RESULTS["profile_forest"] = profile_window(
        "forest", label, lambda: be(queries[:BATCH]), 1, BATCH)
    out["stage_profile"] = forest_stage_profile(
        be, torch.as_tensor(queries[:BATCH], device=dev), label)
    res = shape_rows(dev, be, queries)
    res["launches"] = launches["candidate_topk"]
    RESULTS["kernels"]["candidate_topk"]["rows"] = res
    RESULTS["forest"] = out
    del be, cell
    return out


def life_copy(idx, metadata):
    """A copy of ``idx`` whose mutations reach no other index: every table
    the lifecycle changes in place is copied, and the top level is brute
    (the served forest never reads the top; ``rebalance`` then retrains
    nothing)."""
    f = idx.forest
    trees = [dataclasses.replace(t, leaf_entities=t.leaf_entities.copy())
             for t in f.trees]
    return dataclasses.replace(
        idx, config=dataclasses.replace(idx.config, top="brute"),
        top_pq=None, top_kd=None, centroids=idx.centroids.copy(),
        bucket_ids=idx.bucket_ids.copy(),
        bucket_counts=idx.bucket_counts.copy(), alive=idx.alive.copy(),
        entity_bucket=idx.entity_bucket.copy(), dirty=idx.dirty.copy(),
        forest=dataclasses.replace(f, arrays=dict(f.arrays), trees=trees),
        metadata=metadata, lexical=None, base_trees=None, delta_log=None)


def in_chunks(fn, x: np.ndarray) -> np.ndarray:
    """``fn`` over ``x`` in calls of ``LIFE_CHUNK`` queries: the ids."""
    return np.concatenate([fn(x[s:s + LIFE_CHUNK])[1]
                           for s in range(0, len(x), LIFE_CHUNK)])


def phase_lifecycle(dev, ctx) -> dict:
    """The index lifecycle at sift-1m width on the tree-bottom index (a
    copy, brute top): add 10,000 entities with metadata rows (100 near
    each of 100 buckets), delete 10,000 (whole cold buckets),
    ``refresh_forest``, ``reboost`` with the radio phase's skewed
    likelihood, ``rebalance``; after each, ``pop_delta`` and
    ``apply_updates(delta=...)`` on live forest, IVF and brute backends
    (the brute kind gets the flat part of the manifest), each held bit for
    bit, tables and answers, against a control backend of its kind
    re-placed in full from the same index."""
    corpus, label = ctx["corpus"], ctx["label"]
    queries = ctx["queries"][:INDEX_QUERIES]
    meta = MetadataTable({"pct": ctx["meta"].column("pct").copy()})
    life = life_copy(ctx["tree_idx"], meta)
    rng = np.random.default_rng(5)

    def make(kind):
        if kind == "brute":
            return ShardedSearchBackend(life.db, kind="brute", k=K,
                                        headroom=FOREST_HEADROOM)
        return ShardedSearchBackend(life, kind=kind, k=K,
                                    nprobe_local=SIFT_NPROBE,
                                    beam_width=BEAM,
                                    headroom=FOREST_HEADROOM)

    t0 = time.perf_counter()
    kinds = ("forest", "ivf", "brute")
    live = {kind: make(kind) for kind in kinds}
    control = {kind: make(kind) for kind in kinds}
    torch.cuda.synchronize()
    out = {"place_s": time.perf_counter() - t0, "steps": {}}
    counts = life.bucket_counts
    # hot buckets at most the median size: 100 more entities still fit
    # the pad width, and the rebuilt trees stay within the node slabs
    hot = rng.choice(np.flatnonzero((counts > 0)
                                    & (counts <= np.median(counts))),
                     LIFE_HOT, replace=False)
    per = LIFE_ADDS // LIFE_HOT
    spread = np.stack([corpus[life.bucket_ids[b][:counts[b]]].std(0)
                       for b in hot])
    new = (np.repeat(life.centroids[hot], per, axis=0)
           + 0.3 * np.repeat(spread, per, axis=0)
           * rng.normal(size=(LIFE_ADDS, corpus.shape[1]))).astype(
               np.float32)
    hot_set = set(hot.tolist())
    cold = [b for b in rng.permutation(life.k_clusters)
            if b not in hot_set and counts[b] > 0]
    gone, total = [], 0
    for b in cold:
        if total >= LIFE_DELETES:
            break
        members = life.bucket_ids[b][:counts[b]].astype(np.int64)
        gone.append(members[:LIFE_DELETES - total])
        total += gone[-1].size
    gone = np.concatenate(gone)
    _, unbalance, p_skew = beta_for_unbalance(RADIO_UNBALANCE,
                                              corpus.shape[0] + LIFE_ADDS)
    added = np.zeros(0, np.int64)
    deleted = np.zeros(0, np.int64)
    steps = (
        ("add", lambda: life.add_entities(
            new, metadata={"pct": rng.integers(0, 100, LIFE_ADDS)})),
        ("delete", lambda: life.delete_entities(gone)),
        ("refresh_forest", life.refresh_forest),
        ("reboost", lambda: life.reboost(p_skew)),
        ("rebalance", life.rebalance))
    for name, op in steps:
        t0 = time.perf_counter()
        ret = op()
        mut_s = time.perf_counter() - t0
        if name == "add":
            added = np.asarray(ret, np.int64)
        elif name == "delete":
            deleted = gone
        man = life.pop_delta()
        flat = dataclasses.replace(man, dirty_buckets=man.dirty_buckets[:0])
        step = {"mutation_s": mut_s, "manifest": man.describe(),
                "max_depth": life.forest.max_depth}
        if isinstance(ret, dict):
            step["stats"] = ret
        for kind in kinds:
            target = life.db if kind == "brute" else life
            ptrs = [t.data_ptr() for t in live[kind]._args]
            t0 = time.perf_counter()
            try:
                st = live[kind].apply_updates(
                    target, delta=flat if kind == "brute" else man)
            except ValueError as e:
                # the contract of an outgrown reservation: rebuild
                require("outgrew" in str(e) and name == "reboost",
                        f"{kind} apply after {name}: {e}")
                log(f"[lifecycle] {name}: {kind}: {e}; rebuilding its "
                    "backends, as the contract says")
                live[kind], control[kind] = make(kind), make(kind)
                st = {"mode": "rebuilt", "bytes": live[kind]._full_bytes,
                      "full_bytes": live[kind]._full_bytes,
                      "reason": "outgrew"}
            torch.cuda.synchronize()
            st = dict(st, apply_s=time.perf_counter() - t0)
            control[kind].apply_updates(
                target, alive=life.alive if kind == "brute" else None)
            if st["mode"] == "delta":
                require([t.data_ptr() for t in live[kind]._args] == ptrs,
                        f"{kind} delta after {name} moved a placed tensor")
            require(all(torch.equal(a, b) for a, b in zip(
                live[kind]._args, control[kind]._args)),
                f"{kind} after {name}: the placed tables differ from a full "
                "re-place's")
            a, c = batched(live[kind], queries), batched(control[kind],
                                                         queries)
            require(np.array_equal(a[1], c[1]) and np.array_equal(
                a[0].view(np.int32), c[0].view(np.int32)),
                f"{kind} after {name}: answers differ from a full "
                "re-place's")
            if deleted.size:
                got = in_chunks(live[kind], life.db[deleted])
                require(not np.isin(got, deleted).any(),
                        f"{kind} after {name}: a deleted id came back")
            if added.size:
                got = in_chunks(live[kind], new)[:, 0]
                st["added_found_at_rank_1"] = float((got == added).mean())
                require((got == added).all(),
                        f"{kind} after {name}: an added vector did not find "
                        "itself at rank 1")
            step[kind] = st
            log(f"[lifecycle] {name} ({mut_s:.2f} s on the host; "
                f"{man.describe()}): {kind} mode {st['mode']} bytes "
                f"{st['bytes']} full_bytes {st['full_bytes']} reason "
                f"{st['reason']} apply {st['apply_s']:.2f} s")
        out["steps"][name] = step
        if name in ("add", "delete", "refresh_forest"):
            for kind in ("forest", "ivf"):
                require(step[kind]["mode"] == "delta",
                        f"{kind} after {name} did not take the delta path")
        if name in ("add", "delete"):
            require(step["brute"]["mode"] == "delta",
                    f"brute after {name} did not take the delta path")
    require(life.metadata.n_rows == life.n, "metadata rows lag the db")
    out["unbalance"] = unbalance
    out["counters"] = {kind: {"delta_applies": live[kind].n_delta_applies,
                              "full_applies": live[kind].n_full_applies,
                              "republished_bytes":
                                  live[kind].republished_bytes,
                              "republish_full_bytes":
                                  live[kind].republish_full_bytes}
                       for kind in kinds}
    log(f"[lifecycle] counters {out['counters']}")
    RESULTS["lifecycle"] = out
    return out


# ------------------------------------------------------------- the line
SOURCES = {
    "l2_topk": ("src/repro_torch/kernels/csrc/l2_topk.cu",
                "src/repro/kernels/l2_topk.py:109"),
    "candidate_topk": ("src/repro_torch/kernels/csrc/candidate_topk.cu",
                       "src/repro/kernels/bucket_topk.py:69"),
    "l2_topk_int8": ("src/repro_torch/kernels/csrc/l2_topk.cu",
                     "src/repro/kernels/l2_topk.py:161"),
    "bm25_topk": ("src/repro_torch/kernels/csrc/bm25_topk.cu",
                  "src/repro/kernels/bm25.py:111"),
    "hybrid_topk": ("src/repro_torch/kernels/csrc/l2_topk.cu",
                    "src/repro/kernels/bm25.py:160"),
    "pq_adc_topk": ("src/repro_torch/kernels/csrc/pq_adc_topk.cu",
                    "src/repro/kernels/pq_adc.py:73"),
    "hamming_topk": ("src/repro_torch/kernels/csrc/hamming_topk.cu",
                     "src/repro/kernels/hamming.py:48"),
}


# -------------------------------------------------------------- phase 12
SHARD_WORLD = 4          # ranks sharing the one card under gloo
SHARD_NPROBE = 8         # probes a shard over four: 32 in all
SHARD_QUERIES = 256      # queries each check runs, in batches of 64
SHARD_ODD_B = 37         # a batch the (2, 2) mesh's query axis pads
SHARD_SERVE = 1024       # requests through each cell for the p50s
SHARD_LIMIT_S = 480      # the four ranks, joined together
GATHER_ITERS = 200
# the kernel each sharded kind's local launches
KIND_KERNEL = {"brute": "l2_topk", "ivf": "candidate_topk",
               "forest": "candidate_topk"}


def mesh_kinds(ctx, nprobe: int):
    """(name, target, backend kwargs) of the sharded phase's kinds: the
    sift corpus (brute), the serve phase's IVF index and the index
    phase's tree-bottom index (forest)."""
    return (("brute", ctx["corpus"], dict(kind="brute")),
            ("ivf", ctx["idx"], dict(kind="ivf", nprobe_local=nprobe)),
            ("forest", ctx["tree_idx"], dict(kind="forest",
                                             nprobe_local=nprobe,
                                             beam_width=BEAM)))


def mesh_options(ctx):
    """(name, target, backend kwargs, call kwargs, kernel) of the option
    cases the four ranks run besides the kinds: filters (the mask's
    slice), int8, lexical and hybrid (the flat locals' row offsets)."""
    meta = dict(metadata=ctx["meta"])
    lex = dict(kind="brute", lexical=ctx["slabs"], **meta)
    return (("brute_narrow", ctx["corpus"], dict(kind="brute", **meta),
             {"filter_spec": NARROW}, "l2_topk"),
            ("int8", ctx["corpus"], dict(kind="brute", precision="int8"),
             {}, "l2_topk_int8"),
            ("lexical_wide", ctx["corpus"], lex,
             {"mode": "lexical", "filter_spec": WIDE}, "bm25_topk"),
            ("hybrid", ctx["corpus"], lex, {"mode": "hybrid",
                                            "alpha": ALPHA}, "hybrid_topk"),
            ("ivf_wide", ctx["idx"], dict(kind="ivf",
                                          nprobe_local=SHARD_NPROBE, **meta),
             {"filter_spec": WIDE}, "candidate_topk"))


def same_bits(name: str, a, b) -> None:
    """Two numpy (dists, ids) answers equal bit for bit."""
    require(a[1].shape == b[1].shape and np.array_equal(a[1], b[1]),
            f"{name}: ids differ")
    require(np.array_equal(a[0].view(np.int32), b[0].view(np.int32)),
            f"{name}: distance bits differ")


def sharded_world1(dev, ctx, label: str) -> dict:
    """A world-size-1 NCCL group: each kind with and without the mesh bit
    for bit, the all-gather's time, one served batch through a meshed
    cell, and the p50 of a cell with and without the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import MeshCollective, _all_gather

    out = {"launches": {}}
    q = ctx["queries"][:SHARD_QUERIES]
    tmp = tempfile.mkdtemp(prefix="nccl1-", dir=OUT_DIR)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        for name, target, kw in mesh_kinds(ctx, SIFT_NPROBE):
            meshed = ShardedSearchBackend(target, k=K, mesh=mesh,
                                          axes=("data",), **kw)
            plain = ShardedSearchBackend(target, k=K, **kw)
            meshed(q[:BATCH])                   # warm-up, not counted
            torch.cuda.synchronize()
            reset_launches()
            a = batched(meshed, q)
            torch.cuda.synchronize()
            out["launches"][name] = {n: v for n, v in read_launches().items()
                                     if v}
            require(out["launches"][name].get(KIND_KERNEL[name], 0) > 0,
                    f"the world-1 {name} path never launched "
                    f"{KIND_KERNEL[name]}")
            b = batched(plain, q)
            same_bits(f"world-1 NCCL {name} against no mesh", a, b)
            out[f"{name}_recall_at_10"] = recall_at_k(
                b[1], ctx["truth"][:SHARD_QUERIES])
            del meshed, plain
        coll = MeshCollective(mesh, ("data",))
        ld = torch.rand(BATCH, K, device=dev)
        li = torch.randint(0, SIFT_1M.n, (BATCH, K), dtype=torch.int32,
                           device=dev)
        gd, gi = coll.gather_corpus(ld, li)
        require_bits("the world-1 gather", (gd[0], gi[0]), (ld, li))
        packed = torch.cat([ld.view(torch.int32), li], dim=1)
        buf = torch.empty_like(packed)
        group = mesh.get_group("data")
        out["all_gather_ms"] = time_ms(
            lambda: _all_gather(buf, packed, group), GATHER_ITERS)
        out["gather_corpus_ms"] = time_ms(
            lambda: coll.gather_corpus(ld, li), GATHER_ITERS)
        log(f"[sharded] world-1 NCCL on {label}: brute, IVF (nprobe 32) "
            f"and forest (nprobe 32, beam 8) with a mesh equal the backends "
            f"without one bit for bit on {SHARD_QUERIES} queries; "
            f"all-gather of ({BATCH}, 2 x {K}) int32 "
            f"{out['all_gather_ms']:.4f} ms, with packing "
            f"{out['gather_corpus_ms']:.4f} ms (CUDA events, "
            f"{GATHER_ITERS} calls); launches {out['launches']}")

        ivf_kw = dict(kind="ivf", k=K, nprobe_local=SIFT_1M.nprobe,
                      max_batch=BATCH)
        cell = ServingCell.sharded(ctx["idx"], mesh=mesh, axes=("data",),
                                   max_wait_ms=1000.0, **ivf_kw)
        futs = [cell.submit(r) for r in q[:BATCH]]
        got = [f.get(timeout=120) for f in futs]
        batches = cell.stats().dispatches
        cell.close()
        require(batches == 1, f"the served batch was split in {batches}")
        want = ctx["ivf"](q[:BATCH])
        same_bits("one served batch through a meshed cell",
                  (np.stack([g[0] for g in got]),
                   np.stack([g[1] for g in got])), want)
        reqs = ctx["queries"][:SHARD_SERVE]
        for tag, m in (("mesh", mesh), ("no_mesh", None)):
            cell = ServingCell.sharded(ctx["idx"], mesh=m, axes=("data",),
                                       max_wait_ms=2.0, **ivf_kw)
            cell.search_fn(q[:BATCH])
            torch.cuda.synchronize()
            ids, _, lat, wall = serve(cell, reqs)
            cell.close()
            out[tag] = {"p50_ms": float(np.percentile(lat * 1e3, 50)),
                        "p99_ms": float(np.percentile(lat * 1e3, 99)),
                        "qps": len(reqs) / wall,
                        "recall_at_10": recall_at_k(
                            ids, ctx["truth"][:SHARD_SERVE])}
        log(f"[sharded] IVF cell, {SHARD_SERVE} requests, {N_CLIENTS} "
            f"clients on {label}: with the world-1 mesh p50 "
            f"{out['mesh']['p50_ms']:.3f} ms p99 {out['mesh']['p99_ms']:.3f}"
            f" ms QPS {out['mesh']['qps']:.1f}; without p50 "
            f"{out['no_mesh']['p50_ms']:.3f} ms p99 "
            f"{out['no_mesh']['p99_ms']:.3f} ms QPS "
            f"{out['no_mesh']['qps']:.1f}; one served batch bit for bit")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def handoff(idx):
    """``idx`` as the ranks need it: no placed tables, no top level or
    sidecars (the served locals read neither)."""
    return dataclasses.replace(idx, top_pq=None, top_kd=None,
                               bottom_lsh=None, base_trees=None,
                               delta_log=None, metadata=None, lexical=None)


def sharded_rank(rank: int, world: int, workdir: str) -> None:
    """One of the ranks sharing the card under gloo (spawned by
    ``sharded_four_ranks``): each kind and option case on the (4,) mesh,
    brute on the (2, 2) mesh with a query axis; answers, launches and
    walls pickled."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        mesh22 = init_device_mesh("cuda", (2, 2),
                                  mesh_dim_names=("data", "model"))
        out = {"launches": {}, "place_s": {}, "wall_s": {}}
        ctx = {"corpus": inp["corpus"], "idx": inp["idx"],
               "tree_idx": inp["tree"], "meta": inp["meta"],
               "slabs": inp["slabs"]}
        cases = [(name, target, kw, {}) for name, target, kw
                 in mesh_kinds(ctx, SHARD_NPROBE)]
        cases += [case[:4] for case in mesh_options(ctx)]
        for name, target, kw, call in cases:
            t0 = time.perf_counter()
            be = ShardedSearchBackend(target, k=K, mesh=mesh,
                                      axes=("data",), **kw)
            torch.cuda.synchronize()
            out["place_s"][name] = time.perf_counter() - t0
            batched(be, inp["q"][:BATCH], call, inp["qt"], inp["qw"])
            torch.cuda.synchronize()            # the warm-up, not counted
            reset_launches()
            t0 = time.perf_counter()
            out[name] = batched(be, inp["q"], call, inp["qt"], inp["qw"])
            torch.cuda.synchronize()
            out["wall_s"][name] = time.perf_counter() - t0
            out["launches"][name] = read_launches()
            del be
            torch.cuda.empty_cache()
        be = ShardedSearchBackend(inp["corpus"], kind="brute", k=K,
                                  mesh=mesh22, axes=("data",),
                                  query_axes=("model",))
        out["brute_b37"] = be(inp["q"][:SHARD_ODD_B])
        out["slot_b37"] = be.slot
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def sharded_four_ranks(dev, ctx, label: str, one_shard: dict) -> dict:
    """Four ranks on the one card under gloo against the parent's shard
    loop, bit for bit; brute also against the one-shard backend."""
    import torch.multiprocessing as mp

    q = ctx["queries"][:SHARD_QUERIES]
    qt, qw = ctx["qt"][:SHARD_QUERIES], ctx["qw"][:SHARD_QUERIES]
    truth = ctx["truth"][:SHARD_QUERIES]
    workdir = tempfile.mkdtemp(prefix="gloo4-", dir=OUT_DIR)
    out = {}
    try:
        t0 = time.perf_counter()
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump({"corpus": ctx["corpus"], "idx": handoff(ctx["idx"]),
                         "tree": handoff(ctx["tree_idx"]), "q": q,
                         "meta": ctx["meta"], "slabs": ctx["slabs"],
                         "qt": qt, "qw": qw}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        out["handoff_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=sharded_rank,
                               args=(r, SHARD_WORLD, workdir))
                 for r in range(SHARD_WORLD)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + SHARD_LIMIT_S
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        require(not hung, f"ranks {hung} outlived {SHARD_LIMIT_S} s")
        codes = [p.exitcode for p in procs]
        require(all(c == 0 for c in codes), f"a rank failed: exit codes "
                f"{codes}")
        out["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_WORLD):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    t0 = time.perf_counter()
    for name, target, kw in mesh_kinds(ctx, SHARD_NPROBE):
        bes = shard_backends(target, SHARD_WORLD, k=K, **kw)
        loop = batched(lambda qb: shard_loop(bes, qb), q)
        del bes
        for r, got in enumerate(ranks):
            same_bits(f"gloo rank {r} {name} against the shard loop",
                      got[name], loop)
        out[name] = {"recall_at_10": recall_at_k(loop[1], truth),
                     "launches": [rk["launches"][name] for rk in ranks],
                     "place_s": [rk["place_s"][name] for rk in ranks],
                     "wall_s": [rk["wall_s"][name] for rk in ranks]}
    same_bits("four-rank brute against the one-shard backend",
              ranks[0]["brute"], batched(ctx["brute"], q))
    # the option cases: the shard loop, and for a flat scan the one-shard
    # backend (no split changes a row's score)
    one_int8 = ShardedSearchBackend(ctx["corpus"], kind="brute", k=K,
                                    precision="int8")
    for name, target, kw, call, kernel in mesh_options(ctx):
        bes = shard_backends(target, SHARD_WORLD, k=K, **kw)
        loop = batched(lambda qb, **c: shard_loop(bes, qb, **c), q, call,
                       qt, qw)
        del bes
        for r, got in enumerate(ranks):
            same_bits(f"gloo rank {r} {name} against the shard loop",
                      got[name], loop)
        if "filter_spec" in call:
            require_admitted(f"four-rank {name}", loop[1],
                             call["filter_spec"], ctx["meta"])
        if target is ctx["corpus"]:
            one = one_int8 if name == "int8" else ctx["brute"]
            same_bits(f"four-rank {name} against the one-shard backend",
                      loop, batched(one, q, call, qt, qw))
        out[name] = {"launches": [rk["launches"][name] for rk in ranks],
                     "place_s": [rk["place_s"][name] for rk in ranks],
                     "wall_s": [rk["wall_s"][name] for rk in ranks]}
        require(all(lc[kernel] > 0 for lc in out[name]["launches"]),
                f"a {name} rank never launched {kernel}")
    del one_int8
    loop = shard_loop(shard_backends(ctx["corpus"], 2, k=K, kind="brute"),
                      q[:SHARD_ODD_B], n_q=2)
    for r, got in enumerate(ranks):
        same_bits(f"gloo rank {r} brute on the (2, 2) mesh, B = "
                  f"{SHARD_ODD_B}", got["brute_b37"], loop)
    same_bits(f"(2, 2) brute, B = {SHARD_ODD_B}, against one shard",
              loop, ctx["brute"](q[:SHARD_ODD_B]))
    out["loop_s"] = time.perf_counter() - t0
    for name, kernel in KIND_KERNEL.items():
        require(all(lc[kernel] > 0 for lc in out[name]["launches"]),
                f"a {name} rank never launched {kernel}")
    log(f"[sharded] four gloo ranks on one card ({label}): every answer "
        f"equals the shard loop bit for bit on {SHARD_QUERIES} queries "
        f"(brute also the one-shard backend; the (2, 2) mesh with a query "
        f"axis at B = {SHARD_ODD_B} too); recall@10 IVF "
        f"{out['ivf']['recall_at_10']:.4f} (8 probes a shard, 32 in all; "
        f"one shard at nprobe 32: {one_shard['ivf_recall_at_10']:.4f} here,"
        f" {RESULTS['main']['recall_at_10']:.4f} on {N_REQUESTS}), forest "
        f"{out['forest']['recall_at_10']:.4f} (one shard: "
        f"{one_shard['forest_recall_at_10']:.4f} here, "
        f"{RESULTS['forest']['recall_at_10']:.4f} on {N_REQUESTS}); the "
        f"options {[c[0] for c in mesh_options(ctx)]} equal the shard loop "
        f"bit for bit on every rank, the flat ones the one-shard backend "
        f"too")
    for name in [c[0] for c in mesh_kinds(ctx, SHARD_NPROBE)
                 + mesh_options(ctx)]:
        log(f"[sharded] {name} ranks: launches "
            f"{[{n: v for n, v in lc.items() if v} for lc in out[name]['launches']]}"
            f"; walls {[round(w, 3) for w in out[name]['wall_s']]} s for "
            f"{SHARD_QUERIES // BATCH} batches; placed in "
            f"{[round(w, 1) for w in out[name]['place_s']]} s")
    log(f"[sharded] hand-off {out['handoff_s']:.1f} s, ranks "
        f"{out['ranks_s']:.1f} s, shard loops {out['loop_s']:.1f} s")
    return out


def phase_sharded(dev, ctx) -> dict:
    label = ctx["label"]
    out = {"world1_nccl": sharded_world1(dev, ctx, label)}
    out["gloo4"] = sharded_four_ranks(dev, ctx, label, out["world1_nccl"])
    RESULTS["sharded"] = out
    return out


def kernel_line() -> dict:
    """Each kernel at its main path's shape (``candidate_topk``: the served
    chain, with its one-step, DEEP-10M and served forest rows-by-id
    numbers beside it)."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        r = RESULTS["kernels"][name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": r["launches"],
               "max_abs_err": r["max_abs_err"],
               "max_rel_err": r["max_rel_err"],
               "ids_match": r["ids_match"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "library_ms_k64" in r:
            row.update(ms_k64=r["ms_k64"], library_ms_k64=r["library_ms_k64"])
        for extra in ("lookup_ms", "bytes_ms", "compare_loop_ops_ms",
                      "matched_slots", "tc_bound_ms", "popc_ms", "int_ms",
                      "popc_each_word_ms", "fp32_rate_bound_ms"):
            if extra in r:
                row[extra] = r[extra]
        if "eight_terms" in r:
            row["ms_t8"] = r["eight_terms"]["ms"]
        if "k100" in r:
            row.update(ms_k100=r["k100"]["ms"],
                       passes_k100=r["k100"]["passes"])
        for part in ("step", "deep", "rows"):
            if part in r:
                row[part] = {key: r[part][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")}
        if "deep" in r:
            row["deep"]["launches"] = r["deep_launches"]
        if "rows" in r:
            row["rows"].update(
                launches=r["rows"]["launches"],
                gather_ms=r["rows"]["gather_ms"],
                tile_entry_ms=r["rows"]["tile_entry_ms"],
                ms_k100=r["rows"]["k100"]["ms"])
        out.append(row)
    return {"kernels": out}


def main() -> int:
    with phase("card"):
        card = phase_card()
    dev = torch.device("cuda", 0)
    with phase("build"):
        phase_build()
    with phase("edges"):
        phase_edges(dev)
    with phase("serve"):
        ctx = phase_main(dev, card)
    with phase("options"):
        phase_options(dev, ctx)
    with phase("large k"):
        phase_large_k(dev, ctx)
    with phase("profile"):
        phase_profiles(ctx)
    phase_index(dev, ctx)
    with phase("forest serve"):
        phase_forest_serve(dev, ctx)
    with phase("lifecycle"):
        phase_lifecycle(dev, ctx)
    with phase("sharded"):
        phase_sharded(dev, ctx)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    print(json.dumps(kernel_line()))
    print(card["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
