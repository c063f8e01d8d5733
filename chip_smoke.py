#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100, and check it.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over;
each prints its wall time as ``[phase] <name> <s> s``):

1. card    - name, count, versions, ``nvidia-smi`` name and power limit;
2. build   - build the six CUDA sources (eight kernels) from
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
             ``l2_topk_int8`` at d = 640 and 1,000; the tree descent on
             ``testing.DESCENT_EDGES`` (its five results equal the plain
             loop's);
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
             three runs; the sift forest under a kd top (``top="kdtree"``
             over the 8,192 centroids, nprobe 32 and 64: kd beams 64 and
             128) and the descent kernel at the kd top's shapes and at the
             radio QLBT's beams 1-32, each against the plain card loop
             and the CPU loop (rows off the CPU's descent counted, the
             kernel's at most the plain card path's plus a slack), timed
             beside its bound;
10. forest serve - the sift tree-bottom index (8,192 buckets, leaf 8)
             through ``ServingCell.sharded(kind="auto")`` (the forest
             kind: nprobe 32, beam 8, k 10), 2,048 requests from 16
             clients, recall@10 against the exact top-10; counts reset just
             before and read just after; fused against unfused on every
             batch (near-ties recomputed in float64, repeats counted);
             filtered at 0.05 and 0.5; k = 50; a stage profile of one
             batch (its launches by stage); ``candidate_topk``'s rows-by-id
             entry at the served shape (B 64, C 2,048, d 128) against its
             plain version, timed beside its bound, the library yardstick
             and the gathered tile; the descent of every served batch
             (2,048 rows of nprobe 32 x beam 8) by the kernel and by the
             plain card loop, each against the CPU loop, both reranked:
             answers equal on every query whose descent rows agree;
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
             just after each case's run); an IVF cell over the ``(4,)``
             mesh takes the lifecycle's add and delete through
             ``ServingCell.apply_updates`` on the root (every rank's
             tables and the answers against the parent's shard loop
             after the same manifest, bit for bit; the bytes each rank
             received beside its share), and a root sits idle past its
             group's timeout, then answers a call with every rank;
13. fleet   - four cells sharing the card (``build_fleet``, each its own
             IVF placement of the serve phase's index, nprobe 32, k 10),
             a TinyLFU cache each, one estimator with its sketch on the
             card, 16 clients sending Zipf traffic over 2,048 queries:
             steady windows of 2,048 requests (one cell; the fleet on its
             own streams, on the default stream and on its own streams
             again), a hedge window (one cell delayed),
             a failure window (one cell raising: no request lost, only
             its keys remapped), a maintenance window (the head rotates,
             a copy of the index takes the lifecycle's add and delete,
             ``MaintenanceScheduler`` leads one rolling fan-out under
             load; every live cell then equals a fresh backend bit for
             bit), the down cell's revive, every answer held bit for bit
             against its backend's direct call on the same batch, the
             sketch on the card against the CPU's, and the launcher
             ``python -m repro_torch.launch.serve`` in a process of its
             own (its first-calls line, ``compile_signatures`` and
             ``first_call_ms``, beside its P90); launch counts reset just
             before and read just after each window;
14. analysis - the static gate of ``repro_torch.analysis`` over
             ``src/repro_torch`` (0 findings), the recompile gate over the
             seven registered entry points on the card (0 findings; each
             step's wall ms and compiled variants; launch counts reset
             just before and read just after: the six on-path kernels
             > 0), one seeded plan whose second step brings a new batch
             shape (exactly one ``recompile``), ``profile_entry_points``,
             ``roofline_report`` of the serve phase's brute and IVF
             backends at B = 64 (a measured share above 1.05 of the
             H100's 3.35 TB/s fails), the serve phase's first calls
             beside its steady p50, each library's ``kernel_build_ms``
             from the build phase, and ``repro_torch.obs.smoke`` on the
             card;
15. cells and dry run - the cells no earlier phase ran over a mesh,
             before the serve phase's index is freed: under a world-size-1
             NCCL group on a ``(1, 1)`` mesh the sift-1m ANN cell
             (``serve_batch``: B 1,024, k 10, nprobe 32; the serve phase's
             1M x 128 corpus and 8,192 buckets packed into the cell's
             (8,192, 312) layout, rows over the cap counted) bit for bit
             against the same cell with no mesh, its ids against the
             unfused plain loop (near-ties recomputed in float64), its
             recall@10 against the exact top-10 and its time by CUDA
             events (counts reset just before and read just after its
             first call: ``candidate_topk`` > 0); DIN's and SASRec's
             ``retrieval_cand`` cells (1M candidates, full width) against
             the unsharded ``retrieval_logits``; then four gloo ranks
             sharing the card on a ``(2, 2)`` mesh (spawned): the ANN cell
             (2,048 buckets and 8 probes a rank) and the two retrieval
             cells bit for bit against the four shards run on one card
             and merged; meanwhile ``launch/dryrun.py``'s ``run_cell`` in a
             subprocess on this machine's torch (the fake process group):
             qwen3-0.6b ``train_4k`` and sift-1m ``serve_batch`` at
             ``(16, 16)`` ``ok``, and the world-1 ANN and DIN cells, whose
             dry-run ``peak_bytes`` must lie within 0.5-2x of the card's
             ``max_memory_allocated`` above the same step's arguments;
16. lm      - the language models' serving path (plain torch; the
             reference's LM path reaches no Pallas kernel): qwen3-0.6b at
             full width and depth, card against CPU at the fp32 policy on
             the same weights (prefill and decode logits and cache,
             ``loss_fn``; decode after prefill(S) against prefill(S + 1));
             then served at bf16 (the registry's ``prefill_32k`` with the
             batch cut to 2: 2 x 32,736 prompt tokens, 32 greedy decode
             steps to a 32,768 context), timed, profiled and its memory
             read; deepseek-v3-671b and kimi-k2 at ``reduced()`` (MoE and
             MLA, MTP) card against CPU; deepseek-v3-671b at full width
             with its depth cut to 1 dense + 1 MoE layer, bf16 prefill of
             2 x 512 and 8 decode steps;
17. models  - the recsys and GNN models' serving path (plain torch, as the
             reference's plain jnp): DLRM, DCN-v2, DIN and SASRec at full
             width card against CPU in fp32 (DLRM and DCN-v2 with each
             table capped at 65,536 rows): ``serve_logits`` on 512 rows,
             ``loss_fn``, ``retrieval_logits`` over 4,096 candidates; SchNet
             at full width on ``full_graph_sm`` and ``molecule``, fp32 and
             bf16 messages; the four archs served at the registry's
             ``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` (1M
             candidates; DLRM in bf16, its 187.8M-row table kept whole),
             profiles of DLRM ``serve_p99`` and DIN ``retrieval_cand``;
             SASRec's 1M items MIPS-augmented to d 51 through
             ``build_two_level`` (brute top and bottom, 1,024 buckets;
             nprobe 16-1,024, exact at full probing; launch counts reset
             just before and read just after: ``candidate_topk`` > 0);
             SchNet at ``full_graph_sm``, ``minibatch_lg`` (the 114.6M-edge
             graph and the (15, 10) sampler) and ``molecule`` with bf16
             messages; ``radius_graph`` over 16,384 points, two-level on the
             card against brute;
18. train   - training (plain torch, as the reference's training path;
             no kernel on it): qwen3-0.6b at full width and depth bound
             as the reference's ``train_4k`` cell (remat, KV blocks of
             1,024, AdamW warmup_cosine(3e-4, 2000, 100000), fp32 params,
             bf16 compute) at seq 4,096 with the batch cut from 256 to 8
             (4 microbatches of 2 through ``accum``): 1 warm-up and 3
             timed steps (ms, tokens/s, peak memory, each step's loss and
             grad_norm), one microbatch's step profiled; its fp32 gradient
             and one AdamW step card against CPU on the ``lm`` phase's
             inputs; a restart on the card (depth cut to 2, seq 512: 4
             steps, a checkpoint at 2, restored and replayed) bit for bit;
             the CTR sparse step (``make_ctr_sparse_train_step``) at
             ``train_batch`` (65,536 rows) for DCN-v2 (fp32, whole) and
             DLRM (its 48 GB table in bf16), with one fp32 step card
             against CPU on tables capped at 65,536 rows, each side held
             against the step in float64; SchNet (``molecule``,
             ``full_graph_sm``, bf16 messages), DIN and SASRec
             (``train_batch``) through ``make_train_step``;
19. sharded models - the models over a ``torch.distributed`` mesh through
             the port's copy of the reference's cells
             (``repro_torch.launch.cells``; plain torch, no kernel on
             it): under a world-size-1 NCCL group on a ``(1, 1)`` mesh,
             qwen3-0.6b at full width and depth through
             ``_lm_decode_cell`` (prefill 2 x 4,096, 8 decode steps; bit
             for bit against the same steps with no mesh) and one step of
             ``_lm_train_cell`` at the ``train_4k`` binding (one
             microbatch of 2 x 4,096, fp32 policy; within 1e-4 of each
             leaf's max of the no-mesh step), deepseek-v3-671b at full
             width cut to 1 dense + 1 MoE layer (decode cell 2 x 512 and
             8 steps, one Adafactor step at 1 x 512, its peak memory);
             then four gloo ranks sharing the card on a ``(2, 2)`` mesh
             (spawned; the parent computes the one-card steps first and
             hands them over on the host): qwen3-0.6b at full width
             with its depth cut to 8 layers, deepseek-v3 at ``reduced()``
             and granite-34b at
             full width with its depth cut to 2 layers (its 48 query heads
             over tp, its one KV head whole on each rank; the attention
             projections at their true fan-in, ROADMAP fault 27) through
             the prefill cell (2 x 512), 4 decode steps and a train step
             (4 x 512) at the fp32 policy, every rank's logits, loss,
             grad_norm, updated parameters and moments (its own shards)
             within 1e-4 of each leaf's max of the one-card step (the
             parameters within 1e-6); DCN-v2 at full width with its whole
             12.0 GB fp32 table (columns over tp, drawn one rank at a
             time) and DLRM with its full-width MLPs (tables capped at
             65,536 rows), each through ``serve_p99`` and one sparse
             ``train_batch`` step: logits, dense leaves and moments, the
             AdaGrad sums, the table's touched rows and its float64
             column sums within 1e-4 of the one-card step's; each
             check's error, the ranks' wall time and rank 0's collective
             bytes by kind printed before the checks run;
20. the ``kernels`` JSON line, the ``nvidia-smi`` line and the ``ok`` line.

The serve phase also runs the brute and IVF backends at k = 50 (above the
kernels' 32-pair lists) against their unfused plain paths.

Imports only ``torch``, numpy and ``repro_torch``.  Detailed results also
go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
from functools import partial
import hashlib
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
from repro_torch.configs.registry import get_arch, get_shape  # noqa: E402
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
from repro_torch.core.graph_build import radius_graph  # noqa: E402
from repro_torch.core.tree import build_kd_tree, tree_search  # noqa: E402
from repro_torch.core.lexical import (build_lexical_slabs_flat,  # noqa: E402
                                      query_operands)
from repro_torch.core.metadata import FilterSpec, MetadataTable  # noqa: E402
from repro_torch.core.metrics import LatencyTimer, recall_at_k  # noqa: E402
from repro_torch.core.two_level import (TwoLevelConfig,  # noqa: E402
                                        build_forest, build_two_level)
from repro_torch.data.graph import (NeighborSampler,  # noqa: E402
                                    make_graph, molecule_batch, pad_edges)
from repro_torch.data.lm import LMStream  # noqa: E402
from repro_torch.data.recsys import (batch_for,  # noqa: E402
                                     retrieval_batch, serve_batch)
from repro_torch.data.synthetic import make_corpus, make_queries  # noqa: E402
from repro_torch.device import require_fp32_matmul  # noqa: E402
from repro_torch.distributed.backend import ShardedSearchBackend  # noqa: E402
from repro_torch.kernels import (_build, bm25, bucket_topk,  # noqa: E402
                                 hamming, l2_topk, ops, pq_adc, ref,
                                 tree_descent)
from repro_torch.kernels.common import (LAUNCH_COUNTERS,  # noqa: E402
                                        merge_topk, stable_topk)
from repro_torch.analysis import run_static_analysis  # noqa: E402
from repro_torch.analysis.recompile import (Plan,  # noqa: E402
                                            run_entry_point,
                                            run_recompile_gate)
from repro_torch.analysis.registry import ENTRY_POINTS  # noqa: E402
from repro_torch.models import recsys, schnet, transformer  # noqa: E402
from repro_torch.models.base import (cast_tree, count_params,  # noqa: E402
                                     tree_bytes, tree_map)
from repro_torch.obs import smoke as obs_smoke  # noqa: E402
from repro_torch.obs.profile import (PROFILE,  # noqa: E402
                                     install_compile_hooks,
                                     profile_entry_points)
from repro_torch.obs.trace import Tracer, set_tracer  # noqa: E402
from repro_torch.serve.cell import ServingCell  # noqa: E402
from repro_torch.distributed.sharding import LOCAL_PLAN  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import (init_state,  # noqa: E402
                                    make_train_step, train, value_and_grad)
from repro_torch.train.sparse_embed import \
    make_ctr_sparse_train_step  # noqa: E402
from repro_torch.train.tree import leaves as tree_leaves_sorted  # noqa: E402
from repro_torch.testing import (CHAIN_EDGES, DESCENT_EDGES,  # noqa: E402
                                 EDGE_ALPHAS, HAMMING_EDGES, OPTION_EDGES,
                                 PQ_EDGES, ROWS_EDGES,
                                 attention_at_true_fan_in,
                                 chain_edge_operands, descent_edge_operands,
                                 chain_union_topk, hamming_edge_operands,
                                 hybrid_by_parts, message_dtypes,
                                 mips_parity, option_edge_operands,
                                 pq_edge_operands, rows_edge_operands,
                                 rows_union_topk, sasrec_mips_truth,
                                 shard_backends, shard_loop, step_chain)

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
KD_NPROBES = (32, 64)         # the kd top's beams max(2 nprobe, 8): 64, 128
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
    if "tree_descent" in mangled:
        return "tree_descent"
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
    edges_descent(dev)
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
    first_calls = first_call_snapshot(ivf)
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
    main["first_calls"] = first_calls
    RESULTS["main"] = main
    RESULTS["kernels"]["candidate_topk"]["launches"] = launches[
        "candidate_topk"]
    return {"label": label, "corpus": corpus, "queries": queries,
            "truth": truth, "idx": idx, "ivf": ivf, "brute": brute,
            "meta": meta, "slabs": slabs, "tokens": tokens,
            "offsets": offsets, "p_term": p_term}


def first_call_snapshot(backend) -> dict:
    """A backend's first calls (one a dispatch signature) beside its
    kernel time over every call so far."""
    m = backend.metrics
    first, kern = m.get("first_call_ms"), m.get("kernel_ms")
    return {"compile_signatures": m.counter("compile_signatures").value,
            "first_call_ms_n": first.count, "first_call_ms_sum": first.sum,
            "first_call_ms_mean": first.mean(),
            "kernel_ms_p50": kern.quantile(0.5), "dispatches": kern.count}


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
    require(out["two_level_launches"]["tree_descent"] > 0,
            "the forest bottom never launched tree_descent")
    out["kd_top"] = index_sift_kd(dev, ctx, tree_idx, queries, truth)
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


def index_sift_kd(dev, ctx, tree_idx, queries, truth) -> dict:
    """The two-level kd top (``top="kdtree"``: a kd-tree of leaf 4 over the
    8,192 centroids, as ``build_two_level`` builds it) over the tree
    bottom's forest, at nprobe 32 and 64 (kd beams 64 and 128): recall@10
    and launches (reset just before, read just after: ``tree_descent``
    for the kd top and the forest bottom); then the descent kernel at the
    kd top's shapes (1,024 queries, d 128) against its plain version and
    the CPU loop, timed beside its bound."""
    t0 = time.perf_counter()
    kd_idx = dataclasses.replace(
        tree_idx, config=dataclasses.replace(tree_idx.config, top="kdtree"),
        top_pq=None, top_kd=build_kd_tree(tree_idx.centroids, leaf_size=4))
    out = {"kd_build_s": time.perf_counter() - t0,
           "kd_nodes": kd_idx.top_kd.n_nodes,
           "kd_max_depth": kd_idx.top_kd.max_depth}
    reset_launches()
    for nprobe in KD_NPROBES:
        ids, work, per_q = timed_search(kd_idx.search, queries,
                                        nprobe=nprobe, beam_width=BEAM)
        out[nprobe] = {"recall_at_10": recall_at_k(ids, truth),
                       "per_query_ms": per_q * 1e3,
                       "work_per_query": {k: v / len(queries)
                                          for k, v in work.items()}}
        log(f"[index sift] kd top + tree bottom, nprobe {nprobe} (kd beam "
            f"{max(2 * nprobe, 8)}) beam {BEAM}: {out[nprobe]}")
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    log(f"[index sift] kd top launches {out['launches']}")
    require(out["launches"]["tree_descent"] > 0,
            "the kd top and forest bottom never launched tree_descent")
    arrays = kd_idx.top_kd.device_arrays(dev)
    q = torch.as_tensor(queries, device=dev)
    out["shapes"] = {}
    for nprobe in KD_NPROBES:
        kw = {"kind": "kd", "beam_width": max(2 * nprobe, 8),
              "max_steps": kd_idx.top_kd.max_depth + 4}
        res = shape_descent(f"kd top W{kw['beam_width']}", arrays, q, kw)
        res.pop("_results")
        out["shapes"][kw["beam_width"]] = res
        RESULTS["kernels"].setdefault("tree_descent", {})[
            f"kd{kw['beam_width']}"] = res
    del kd_idx
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
    log(f"[index radio] launches {out['launches']}")
    require(out["launches"]["tree_descent"] > 0,
            "SearchIndex's tree search never launched tree_descent")
    t = idxs["qlbt"].tree
    arrays, cpu_arrays = t.device_arrays(dev), t.device_arrays("cpu")
    out["descent"] = {}
    for w in RADIO_BEAMS:
        kw = {"kind": t.kind, "beam_width": w, "max_steps": t.max_depth + 4}
        if w == out["qlbt"]["beam"]:
            res = shape_descent(f"radio qlbt W{w}", arrays, qt, kw,
                                cpu_arrays=cpu_arrays)
            RESULTS["kernels"].setdefault("tree_descent", {})["radio"] = res
        else:
            res = descent_parity(f"radio qlbt descent W{w}", arrays, qt, kw,
                                 cpu_arrays=cpu_arrays)
        res.pop("_results")
        out["descent"][w] = res
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
# the descent's kernels by name: the hand-written descent first (its name
# holds none of the other patterns)
# the hand-written kernels by the stage that launches them: their launches
# (through ctypes, inside no aten op) are not attached to the ranges
HAND_STAGES = (("descent", r"tree_descent"),
               ("rerank", r"candidate_scan|candidate_merge"))
STAGE_KERNELS = (("descent kernel", r"tree_descent"),
                 ("descent gathers", r"index|gather|Gather|take"),
                 ("node products", r"gemm|gemv|Gemm|xmma|cutlass|bmm|dot"),
                 ("beam sorts", r"[sS]ort|radix|Radix|topk"))


# The descent kernel against the plain batch loop on the card, each against
# the plain loop on the CPU: split margins within rounding of zero may fall
# to the other side in any of the three sums (ROADMAP fault 11), so the
# kernel may leave the CPU's descent on no more rows than the plain card
# path does, plus this slack (rows, and a share of the rows).
DESCENT_SLACK = (4, 0.005)
DESCENT_NAMES = ("nodes", "steps", "internal_visits", "candidates",
                 "n_candidates")


def _descent_rows_off(a, b) -> torch.Tensor:
    """Rows whose leaf candidates, steps or internal visits differ."""
    return ((a[3] != b[3]).any(dim=1) | (a[1] != b[1]) | (a[2] != b[2]))


def descent_parity(name, arrays, q, kw, roots=None, cpu_arrays=None) -> dict:
    """The kernel and the plain loop on the card on the same operands, each
    held against the plain loop on the CPU: the rows each leaves the CPU's
    descent on (``_descent_rows_off``), the kernel's at most the plain
    card path's plus ``DESCENT_SLACK``; beside it the rows where kernel and
    plain card path differ, the largest |internal_visits| gap between them
    and that gap over the plain's visits."""
    kern = tree_descent.tree_descent(arrays, q, roots=roots, **kw)
    plain = ref.tree_descent_ref(arrays, q, roots=roots, **kw)
    cpu_arrays = cpu_arrays or {n: v.cpu() for n, v in arrays.items()}
    cpu = ref.tree_descent_ref(cpu_arrays, q.cpu(),
                               roots=None if roots is None else roots.cpu(),
                               **kw)
    kern_h = [t.cpu() for t in kern]
    plain_h = [t.cpu() for t in plain]
    for t, n in zip(kern_h, DESCENT_NAMES):
        require(t.dtype == torch.int32, f"{name}: kernel {n} is {t.dtype}")
    R = q.shape[0]
    k_off = int(_descent_rows_off(kern_h, cpu).sum())
    p_off = int(_descent_rows_off(plain_h, cpu).sum())
    differ = _descent_rows_off(kern_h, plain_h)
    gap = (kern_h[2] - plain_h[2]).abs()
    out = {"descent_rows": R, "beam": kw["beam_width"], "kind": kw["kind"],
           "max_steps": kw["max_steps"],
           "kernel_rows_off_cpu": k_off, "plain_rows_off_cpu": p_off,
           "kernel_vs_plain_rows": int(differ.sum()),
           "rows_match": float(1.0 - differ.float().mean()) if R else 1.0,
           "max_abs_err": float(gap.max()) if R else 0.0,
           "max_rel_err": float((gap / plain_h[2].clamp(min=1)).max())
           if R else 0.0,
           "steps_max": int(kern_h[1].max()) if R else 0,
           "internal_visits": int(kern_h[2].sum()),
           "candidates": int(kern_h[4].sum())}
    slack = DESCENT_SLACK[0] + DESCENT_SLACK[1] * R
    log(f"[{name}] {out}")
    require(k_off <= p_off + slack,
            f"{name}: the kernel leaves the CPU descent on {k_off} rows, the "
            f"plain card path on {p_off} (slack {slack:.1f})")
    out["_results"] = kern
    return out


def descent_bound(res: dict, arrays, q, kw, roots=None) -> dict:
    """The descent's least time at 3.35 TB/s and 67 TFLOP/s, each input
    read once: the proj row, tau and children of every distinct internal
    node the run visits (the internal live nodes of the beams after 0, 1,
    ... steps: the kernel run with ``max_steps`` cut there), each row's
    query and start node, the leaf-table rows of the final beams, the node
    ids those rows are found by, and the five outputs written once; 2 d
    FLOP a visit.  Beside it the figure that reads a node's row at every
    visit (``visit_bound_ms``: repeats in cache not subtracted)."""
    R, d = q.shape
    W = kw["beam_width"]
    leaf = arrays["leaf_entities"].shape[1]
    row_bytes = 4.0 * (3 + (1 if kw["kind"] == "kd" else d))
    children = arrays["children"]
    seen = []
    for s in range(min(res["steps_max"], kw["max_steps"])):
        nodes = tree_descent.tree_descent(
            arrays, q, roots=roots, **dict(kw, max_steps=s))[0]
        live = nodes[nodes >= 0].long()
        seen.append(live[children[live, 0] >= 0])
    distinct = int(torch.unique(torch.cat(seen)).numel()) if seen else 0
    final = res["_results"][0]
    leaf_rows = arrays["leaf_row"][final[final >= 0].long()]
    distinct_leaves = int(torch.unique(leaf_rows[leaf_rows >= 0]).numel())
    fixed = (4.0 * R * (d + 1) + 4.0 * R * W
             + 4.0 * distinct_leaves * leaf + 4.0 * R * (W + 3 + W * leaf))
    flops = 2.0 * (1 if kw["kind"] == "kd" else d) * res["internal_visits"]
    ms, by = bound(row_bytes * distinct + fixed, flops)
    visit_ms, _ = bound(row_bytes * res["internal_visits"] + fixed, flops)
    return {"bound_ms": ms, "bound_by": by,
            "bound_bytes": row_bytes * distinct + fixed,
            "bound_flops": flops, "distinct_internal_nodes": distinct,
            "distinct_leaf_rows": distinct_leaves,
            "visit_bound_ms": visit_ms}


def shape_descent(name, arrays, q, kw, roots=None, cpu_arrays=None) -> dict:
    """``descent_parity`` at a main path's shape, then the kernel's time
    (CUDA graph replays: one call costs the host more than the card),
    the plain card loop's time (CUDA events: its exit test reads the card
    each step) and the bound.  No PyTorch call computes the descent, so
    there is no library time."""
    res = descent_parity(name, arrays, q, kw, roots, cpu_arrays)
    res["ms"] = time_graph_ms(lambda: tree_descent.tree_descent(
        arrays, q, roots=roots, **kw), 20)
    res["plain_ms"] = time_ms(lambda: ref.tree_descent_ref(
        arrays, q, roots=roots, **kw), 3, warmup=1)
    res["library_ms"] = None
    res.update(descent_bound(res, arrays, q, kw, roots))
    log(f"[shape tree_descent {name}] R={q.shape[0]} d={q.shape[1]} "
        f"W={kw['beam_width']} ms {res['ms']:.5f} bound "
        f"{res['bound_ms']:.5f} ({res['bound_by']}; "
        f"{res['distinct_internal_nodes']} distinct internal nodes of "
        f"{res['internal_visits']} internal visits; a row read at every "
        f"visit {res['visit_bound_ms']:.5f}) plain "
        f"{res['plain_ms']:.4f} library none")
    return res


def edges_descent(dev) -> None:
    """Every ``DESCENT_EDGES`` case: the kernel's five results equal the
    plain loop's on the card (continuous normal data: no split margin
    within rounding of zero), one launch a call."""
    for case in DESCENT_EDGES:
        o = descent_edge_operands(case)
        arrays = o["tree"].device_arrays(dev)
        q = torch.as_tensor(o["q"], device=dev)
        roots = (None if o["roots"] is None
                 else torch.as_tensor(o["roots"], device=dev))
        got, n = counted("tree_descent", lambda: tree_descent.tree_descent(
            arrays, q, roots=roots, **o["kw"]))
        want = ref.tree_descent_ref(arrays, q, roots=roots, **o["kw"])
        require(n == 1, f"edge descent {case[0]}: {n} launches")
        for a, b, name in zip(got, want, DESCENT_NAMES):
            require(a.dtype == torch.int32 and torch.equal(a, b),
                    f"edge descent {case[0]}: {name} differs from the "
                    "plain version")
    log(f"[edges] tree_descent: {len(DESCENT_EDGES)} edges equal the plain "
        "version (nodes, steps, internal visits, candidates)")


def forest_descent_inputs(be, q):
    """The forest local's descent operands for the batch ``q`` on ``be``'s
    placed tables: (arrays, the (B nprobe, d) query rows, their start
    nodes, the keywords)."""
    (cents, valid, roots, _bids, bvecs, proj, dims, tau, children, leaf_row,
     leaf_ents) = (t[0] for t in be._args)
    arrays = dict(proj=proj, dims=dims, tau=tau, children=children,
                  leaf_row=leaf_row, leaf_entities=leaf_ents)
    d2c = torch.where(valid[None, :], pairwise_l2sq(q, cents), float("inf"))
    _, probe = stable_topk(d2c, min(be.nprobe_local, cents.shape[0]))
    kw = {"kind": "rp", "beam_width": be.beam_width,
          "max_steps": be._shapes.max_depth + 4}
    return (arrays, torch.repeat_interleave(q, probe.shape[1], dim=0),
            roots[probe].reshape(-1), kw)


def forest_descent(dev, be, queries, truth) -> dict:
    """The served forest's descent over every batch of ``queries``: the
    kernel and the plain loop on the card against the CPU loop
    (``descent_parity``); each batch's answers through the fused rerank
    from the kernel's candidates and from the plain card loop's, equal on
    every query but those whose descent rows differ; recall@10 of both;
    the first batch timed (``shape_descent``)."""
    flat = be._args[3][0].reshape(-1)
    rows = be._args[4][0].reshape(-1, queries.shape[1])
    cpu_arrays = None
    totals = {"descent_rows": 0, "kernel_rows_off_cpu": 0,
              "plain_rows_off_cpu": 0,
              "kernel_vs_plain_rows": 0, "queries_differ": 0,
              "answers_differ_elsewhere": 0, "max_abs_err": 0.0,
              "max_rel_err": 0.0}
    ids_k, ids_p = [], []
    first = None
    for s in range(0, len(queries), BATCH):
        q = torch.as_tensor(queries[s:s + BATCH], device=dev)
        arrays, qq, rr, kw = forest_descent_inputs(be, q)
        if cpu_arrays is None:
            cpu_arrays = {n: v.cpu() for n, v in arrays.items()}
        if first is None:
            first = shape_descent(
                f"forest B{q.shape[0]} nprobe {qq.shape[0] // q.shape[0]}",
                arrays, qq, kw, rr, cpu_arrays)
            res = first
        else:
            res = descent_parity(f"forest descent batch {s // BATCH}",
                                 arrays, qq, kw, rr, cpu_arrays)
        kern = res.pop("_results")
        plain = ref.tree_descent_ref(arrays, qq, roots=rr, **kw)
        answers = []
        for cand in (kern[3], plain[3]):
            c = cand.reshape(q.shape[0], -1)
            c = torch.where((c >= 0) & (flat[c.clamp(min=0).long()] >= 0),
                            c, -1)
            ld, slot = bucket_topk.candidate_rows_topk(q, rows, c, K)
            answers.append(torch.where(
                (slot >= 0) & ~torch.isinf(ld),
                flat[slot.clamp(min=0).long()], -1).cpu().numpy())
        qdiff = _descent_rows_off([t.cpu() for t in kern],
                                  [t.cpu() for t in plain]).reshape(
            q.shape[0], -1).any(dim=1).numpy()
        elsewhere = (answers[0] != answers[1]).any(axis=1) & ~qdiff
        for key in ("descent_rows", "kernel_rows_off_cpu",
                    "plain_rows_off_cpu", "kernel_vs_plain_rows"):
            totals[key] += res[key]
        totals["queries_differ"] += int(qdiff.sum())
        totals["answers_differ_elsewhere"] += int(elsewhere.sum())
        for key in ("max_abs_err", "max_rel_err"):
            totals[key] = max(totals[key], res[key])
        ids_k.append(answers[0])
        ids_p.append(answers[1])
    ids_k, ids_p = np.concatenate(ids_k), np.concatenate(ids_p)
    totals["recall_at_10_kernel"] = recall_at_k(ids_k, truth)
    totals["recall_at_10_plain_descent"] = recall_at_k(ids_p, truth)
    log(f"[forest descent] {len(queries)} queries: {totals}")
    require(totals["answers_differ_elsewhere"] == 0,
            "forest answers from the kernel's descent differ from the plain "
            "card descent's on a query whose descent rows agree")
    first.update({k: v for k, v in totals.items()
                  if k not in ("max_abs_err", "max_rel_err")})
    first["max_abs_err"] = totals["max_abs_err"]
    first["max_rel_err"] = totals["max_rel_err"]
    first["ids_match"] = 1.0 - totals["kernel_vs_plain_rows"] / max(
        totals["descent_rows"], 1)
    return first


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
    ``record_function`` ranges' kernels) and its launches, the descent's
    kernels split into the descent kernel, gathers, node products, beam
    sorts and the rest by kernel name; beside it each stage's time by CUDA
    events, the stages run one at a time."""
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
    stage_n, descent_n = {}, {name: 0 for name in descent}
    attached: dict = {}
    for e in prof.events():
        # the host-side range (the device timeline repeats each range as a
        # user annotation with no kernels of its own)
        if (not e.name.startswith("forest: ")
                or e.device_type != DeviceType.CPU):
            continue
        ks = kernels_of(e)
        stage = e.name[len("forest: "):]
        stages[stage] = stages.get(stage, 0.0) + sum(dur for _, dur in ks)
        stage_n[stage] = stage_n.get(stage, 0) + len(ks)
        for kname, dur in ks:
            n, us = attached.get(kname, (0, 0.0))
            attached[kname] = (n + 1, us + dur)
        if e.name == "forest: descent":
            for kname, dur in ks:
                for cat, pat in STAGE_KERNELS:
                    if re.search(pat, kname):
                        break
                else:
                    cat = "descent other"
                descent[cat] += dur
                descent_n[cat] += 1
    # the hand-written kernels the ranges did not hold, by name
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for stage, pat in HAND_STAGES:
            if not re.search(pat, e.key):
                continue
            n, us = attached.get(e.key, (0, 0.0))
            if e.count > n:
                extra = e.self_device_time_total - us
                stages[stage] = stages.get(stage, 0.0) + extra
                stage_n[stage] = stage_n.get(stage, 0) + e.count - n
                if stage == "descent":
                    descent["descent kernel"] += extra
                    descent_n["descent kernel"] += e.count - n
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
           "stage_launches": stage_n, "descent_launches": descent_n,
           "launches_per_batch": sum(stage_n.values()),
           "events_us": events,
           "measured": bool(sum(stages.values()) > 0)}
    log(f"[profile forest stages] on {label}: one batch of {q.shape[0]}: "
        + ", ".join(f"{k} {v:.1f} us ({stage_n[k]} launches)"
                    for k, v in stages.items())
        + "; descent: " + ", ".join(f"{k} {v:.1f} us ({descent_n[k]})"
                                    for k, v in descent.items())
        + f"; {out['launches_per_batch']} launches a batch in the ranges"
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
    require(launches["tree_descent"] > 0,
            "the forest path never launched tree_descent")
    require(launches["tree_descent"] == launches["candidate_topk"],
            "the forest local made other than one descent a rerank")
    require(all(v == 0 for n, v in launches.items()
                if n not in ("candidate_topk", "tree_descent")),
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
        "descent_launches_per_batch": launches["tree_descent"]
        / max(stats.dispatches, 1),
        "mean_batch": len(queries) / max(stats.dispatches, 1),
        "max_rel_err_f64": float(pair_err.max()), "stages": stats.stages})
    log(f"[forest] {len(queries)} requests, {N_CLIENTS} clients on {label}: "
        f"recall@10 {recall:.4f} (index path, tree bottom, PQ top: "
        f"{ctx['index_tree_recall']:.4f}) p50 {out['p50_ms']:.3f} ms p99 "
        f"{out['p99_ms']:.3f} ms QPS {out['qps']:.1f}; "
        f"{out['launches_per_batch']:.2f} candidate_topk and "
        f"{out['descent_launches_per_batch']:.2f} tree_descent launches a "
        f"batch of {out['mean_batch']:.1f}")
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
    desc = forest_descent(dev, be, queries, truth)
    desc["launches"] = launches["tree_descent"]
    desc["launches_per_batch"] = out["descent_launches_per_batch"]
    out["descent"] = {k: v for k, v in desc.items()}
    RESULTS["kernels"].setdefault("tree_descent", {}).update(desc)
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


def life_inputs(corpus, index, rng):
    """The lifecycle's mutations of ``index``: LIFE_ADDS vectors, 100 near
    each of LIFE_HOT buckets, and LIFE_DELETES ids, the members of whole
    cold buckets.  Returns (new vectors, ids to delete)."""
    counts = index.bucket_counts
    # hot buckets at most the median size: 100 more entities still fit
    # the pad width, and the rebuilt trees stay within the node slabs
    hot = rng.choice(np.flatnonzero((counts > 0)
                                    & (counts <= np.median(counts))),
                     LIFE_HOT, replace=False)
    per = LIFE_ADDS // LIFE_HOT
    spread = np.stack([corpus[index.bucket_ids[b][:counts[b]]].std(0)
                       for b in hot])
    new = (np.repeat(index.centroids[hot], per, axis=0)
           + 0.3 * np.repeat(spread, per, axis=0)
           * rng.normal(size=(LIFE_ADDS, corpus.shape[1]))).astype(
               np.float32)
    hot_set = set(hot.tolist())
    cold = [b for b in rng.permutation(index.k_clusters)
            if b not in hot_set and counts[b] > 0]
    gone, total = [], 0
    for b in cold:
        if total >= LIFE_DELETES:
            break
        members = index.bucket_ids[b][:counts[b]].astype(np.int64)
        gone.append(members[:LIFE_DELETES - total])
        total += gone[-1].size
    return new, np.concatenate(gone)


def ivf_copy(idx):
    """A copy of the served IVF index whose mutations reach no other
    index (the tables the lifecycle changes in place are copied; no top
    level or sidecars, which the IVF backend never reads)."""
    def cp(a):
        return None if a is None else a.copy()

    return dataclasses.replace(
        idx, config=dataclasses.replace(idx.config, top="brute"),
        top_pq=None, top_kd=None, bottom_lsh=None, base_trees=None,
        centroids=idx.centroids.copy(), bucket_ids=idx.bucket_ids.copy(),
        bucket_counts=idx.bucket_counts.copy(), alive=cp(idx.alive),
        entity_bucket=cp(idx.entity_bucket), dirty=cp(idx.dirty),
        delta_log=None, metadata=None, lexical=None)


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
    new, gone = life_inputs(corpus, life, rng)
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
    # no Pallas kernel: the reference's compiled lax.while_loop descent
    "tree_descent": ("src/repro_torch/kernels/csrc/tree_descent.cu",
                     "src/repro/core/tree.py:1002"),
}


# -------------------------------------------------------------- phase 12
SHARD_WORLD = 4          # ranks sharing the one card under gloo
SHARD_NPROBE = 8         # probes a shard over four: 32 in all
SHARD_QUERIES = 256      # queries each check runs, in batches of 64
SHARD_ODD_B = 37         # a batch the (2, 2) mesh's query axis pads
SHARD_SERVE = 1024       # requests through each cell for the p50s
SHARD_LIMIT_S = 480      # the four ranks, joined together
SHARD_BEAT_TIMEOUT_S = 10   # the heartbeat group's collective timeout
SHARD_IDLE_S = 12           # the root's idle pause, past that timeout
UPDATE_STEPS = ("add", "delete")
GATHER_ITERS = 200
# the kernel each sharded kind's local launches
KIND_KERNEL = {"brute": "l2_topk", "ivf": "candidate_topk",
               "forest": "candidate_topk"}
# and the forest local's descent
KIND_DESCENT = ("forest",)


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
            require(name not in KIND_DESCENT
                    or out["launches"][name].get("tree_descent", 0) > 0,
                    f"the world-1 {name} path never launched tree_descent")
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
        del be
        out["cell_updates"] = rank_cell_updates(inp, mesh, rank)
    finally:
        dist.destroy_process_group()
    out["heartbeat"] = rank_heartbeat(inp, rank, world, workdir)
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def table_digest(tables) -> list:
    """A digest of each placed table's bytes (to hold tables across
    processes bit for bit)."""
    return [hashlib.blake2b(t.contiguous().cpu().numpy().tobytes(),
                            digest_size=16).hexdigest() for t in tables]


def rank_cell_updates(inp, mesh, rank: int) -> dict:
    """An IVF cell over the (4,) mesh whose root takes the lifecycle's add
    and delete through ``ServingCell.apply_updates``: the root's stats,
    answers, table digests and the bytes it sent each rank after each
    step; each follower's table digests and the bytes it received."""
    idx = inp["idx"]
    be = ShardedSearchBackend(idx, kind="ivf", k=K, mesh=mesh,
                              axes=("data",), nprobe_local=SHARD_NPROBE,
                              headroom=FOREST_HEADROOM)
    if rank != 0:
        digests = []
        be.follow(on_update=lambda b: digests.append(table_digest(b._args)))
        return {"digests": digests, "updates": be.updates}
    cell = ServingCell(be.lead(), max_batch=BATCH)
    out = {}
    try:
        for step in UPDATE_STEPS:
            t0 = time.perf_counter()
            if step == "add":
                idx.add_entities(inp["new"])
            else:
                idx.delete_entities(inp["gone"])
            t1 = time.perf_counter()
            st = cell.apply_updates(idx)
            t2 = time.perf_counter()
            out[step] = {"stats": st, "mutation_s": t1 - t0,
                         "apply_s": t2 - t1, "fanout": be.last_fanout,
                         "digests": table_digest(be._args),
                         "answers": batched(be, inp["q"])}
    finally:
        cell.close()
    return out


def rank_heartbeat(inp, rank: int, world: int, workdir: str) -> dict:
    """A group with a SHARD_BEAT_TIMEOUT_S timeout: a brute cell over the
    (4,) mesh whose root sits idle SHARD_IDLE_S, then answers a call that
    every rank joins."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store_beat"),
                                     world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_BEAT_TIMEOUT_S))
    try:
        # the mesh over this very group: its timeout is the followers'
        mesh = DeviceMesh.from_group(dist.group.WORLD, "cuda",
                                     mesh_dim_names=("data",))
        be = ShardedSearchBackend(inp["corpus"], kind="brute", k=K,
                                  mesh=mesh, axes=("data",))
        if rank != 0:
            return {"served": be.follow(), "beats": be.beats}
        cell = ServingCell(be.lead(), max_batch=BATCH)
        try:
            time.sleep(SHARD_IDLE_S)
            got = cell.search(inp["q"][0], timeout=60)
        finally:
            cell.close()                # joins the heartbeat thread
        return {"after_idle": got, "beats": be.beats, "beat_s": be._beat_s}
    finally:
        dist.destroy_process_group()


def check_cell_updates(ctx, ranks, q, label: str) -> dict:
    """The parent's shard loop through the same add and delete as the
    ranks' cell: each rank's tables (digests) and the root's answers and
    stats after each step equal it bit for bit; each follower received
    exactly its own part of the delta."""
    from repro_torch.distributed.backend import _nbytes

    x = ivf_copy(ctx["idx"])
    bes = shard_backends(x, SHARD_WORLD, k=K, kind="ivf",
                         nprobe_local=SHARD_NPROBE, headroom=FOREST_HEADROOM)
    lead = ranks[0]["cell_updates"]
    out = {}
    for j, step in enumerate(UPDATE_STEPS):
        if step == "add":
            x.add_entities(ctx["life_new"])
        else:
            x.delete_entities(ctx["life_gone"])
        man = x.pop_delta()
        pay, reason = bes[0]._delta_payload(x, None, man)
        require(reason is None, f"the {step} manifest has no delta payload")
        parts = [_nbytes(bes[0]._cut(pay, lin)) for lin in range(SHARD_WORLD)]
        stats = [be.apply_updates(x, delta=man) for be in bes]
        loop = batched(lambda qb: shard_loop(bes, qb), q)
        got = lead[step]
        require(got["stats"] == stats[0] and got["stats"]["mode"] == "delta",
                f"the cell's {step} stats {got['stats']} are not the shard "
                f"loop's {stats[0]}")
        same_bits(f"the cell's answers after {step} against the shard loop",
                  got["answers"], loop)
        want = [table_digest(be._args) for be in bes]
        mine = [got["digests"]] + [r["cell_updates"]["digests"][j]
                                   for r in ranks[1:]]
        require(mine == want, f"a rank's tables after {step} differ from "
                "its shard's in the loop")
        sent = got["fanout"]["bytes_to_rank"]
        took = [r["cell_updates"]["updates"][j] for r in ranks[1:]]
        require([t["part_bytes"] for t in took] == [sent[r] for r in range(
            1, SHARD_WORLD)] == parts[1:],
            f"a follower's part of the {step} is not its share")
        out[step] = {"stats": got["stats"], "mutation_s": got["mutation_s"],
                     "apply_s": got["apply_s"], "part_bytes": parts,
                     "header_bytes": [t["header_bytes"] for t in took]}
        log(f"[sharded] cell update {step} on the (4,) mesh ({label}): "
            f"mode {got['stats']['mode']} bytes {got['stats']['bytes']} of "
            f"full {got['stats']['full_bytes']}; bytes each rank received "
            f"(its rows, buckets or slabs of the delta) {parts[1:]} (the "
            f"root's own part {parts[0]}; sum {sum(parts)} of the manifest's "
            f"{got['stats']['bytes']}), header (index mirrors) "
            f"{out[step]['header_bytes']}; apply {got['apply_s']:.3f} s; every "
            "rank's tables and the answers equal the shard loop bit for bit")
    del bes
    torch.cuda.empty_cache()
    return out


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
                         "qt": qt, "qw": qw, "new": ctx["life_new"],
                         "gone": ctx["life_gone"]}, f,
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
    out["cell_updates"] = check_cell_updates(ctx, ranks, q, label)
    beat = ranks[0]["heartbeat"]
    same_bits(f"a call after the root sat idle {SHARD_IDLE_S} s (group "
              f"timeout {SHARD_BEAT_TIMEOUT_S} s)", tuple(
                  a[None] for a in beat["after_idle"]), ctx["brute"](q[:1]))
    require(all(r["heartbeat"]["served"] == 1 for r in ranks[1:]),
            "a follower did not answer the call after the idle pause")
    require(beat["beat_s"] == 0.25 * SHARD_BEAT_TIMEOUT_S,
            f"the root beats every {beat['beat_s']} s idle, not a quarter "
            f"of the group's {SHARD_BEAT_TIMEOUT_S} s timeout")
    require(all(r["heartbeat"]["beats"] == beat["beats"] > 0
                for r in ranks[1:]),
            f"the followers missed heartbeats: root sent {beat['beats']}, "
            f"followers took {[r['heartbeat']['beats'] for r in ranks[1:]]}")
    out["heartbeat"] = {"beats": beat["beats"], "beat_s": beat["beat_s"],
                        "idle_s": SHARD_IDLE_S,
                        "timeout_s": SHARD_BEAT_TIMEOUT_S}
    log(f"[sharded] heartbeat: the root sat idle {SHARD_IDLE_S} s under a "
        f"{SHARD_BEAT_TIMEOUT_S} s group timeout, sent {beat['beats']} "
        f"heartbeats (every {beat['beat_s']:.1f} s idle), then a call every "
        "rank answered, bit for bit the one-shard backend's")
    for name, kernel in KIND_KERNEL.items():
        require(all(lc[kernel] > 0 for lc in out[name]["launches"]),
                f"a {name} rank never launched {kernel}")
    for name in KIND_DESCENT:
        require(all(lc["tree_descent"] > 0 for lc in out[name]["launches"]),
                f"a {name} rank never launched tree_descent")
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
    # the lifecycle's mutations of the served IVF index: the ranks' cell
    # updates here and the fleet's maintenance window take them
    ctx["life_new"], ctx["life_gone"] = life_inputs(
        ctx["corpus"], ctx["idx"], np.random.default_rng(6))
    out = {"world1_nccl": sharded_world1(dev, ctx, label)}
    out["gloo4"] = sharded_four_ranks(dev, ctx, label, out["world1_nccl"])
    RESULTS["sharded"] = out
    return out


# -------------------------------------------------------------- phase 13
FLEET_CELLS = 4
FLEET_POOL = 2048           # distinct queries; Zipf-drawn traffic over them
FLEET_ZIPF = 1.1
# each steady window's requests (cut from 4,096 to keep the smoke within
# its time; the A B A stream windows and every answer check stay)
FLEET_REQUESTS = 2048
FLEET_ROTATED = 16384       # the maintenance window's rotated traffic
FLEET_CACHE = 1024
FLEET_SKETCH_WIDTH = 4096
FLEET_HALFLIFE = 4096
FLEET_DELAY_S = 0.05        # the hedge window's injected straggler
FLEET_HEDGE_MS = 10.0
FLEET_HEDGE_REQUESTS = 1024
FLEET_FAIL_REQUESTS = 2048
FLEET_FAIL_AFTER = 256      # answered requests before a cell starts failing
FLEET_REMAP_QUERIES = 512
FLEET_CHECK_QUERIES = 256
FLEET_MAINT_AFTER = 1024    # requests after the fan-out that end the window
FLEET_CHECK_EVERY = 256     # rotated requests between two drift checks
LAUNCHER_TIMEOUT_S = 300


class Recorder:
    """A cell's backend that keeps every batch it answered (queries and
    answer) and delegates the rest; ``delay_s`` and ``fail`` inject a
    straggler and a failure (fault injection in this script only)."""

    def __init__(self, backend):
        self.backend = backend
        self.metrics = backend.metrics
        self.calls: list = []
        self.delay_s = 0.0
        self.fail = threading.Event()
        self._lock = threading.Lock()

    def __call__(self, qs, **kw):
        if self.fail.is_set():
            raise RuntimeError("injected cell failure")
        if self.delay_s:
            time.sleep(self.delay_s)
        out = self.backend(qs, **kw)
        with self._lock:
            self.calls.append((np.array(qs), out))
        return out

    def apply_updates(self, *args, **kw):
        return self.backend.apply_updates(*args, **kw)


def fleet_traffic(router, pool, order, during=None, stop=None) -> dict:
    """N_CLIENTS threads, each sending its share of ``pool[order]`` one
    blocking routed request at a time; ``during(done)`` runs in this thread
    meanwhile (``done[0]``: requests answered); a set ``stop`` ends the
    clients early.  Every request is accounted for: answered, or an error
    (a lost request)."""
    n = len(order)
    ids = np.full((n, K), -2, np.int32)
    dists = np.full((n, K), np.nan, np.float32)
    lat = np.full(n, np.nan)
    errors: list = []
    done = [0]
    lock = threading.Lock()

    def client(rows):
        for r in rows:
            if stop is not None and stop.is_set():
                return
            t0 = time.perf_counter()
            try:
                d, i = router.search(pool[order[r]], timeout=120)
            except Exception as e:  # a lost request: reported and failed
                errors.append((int(r), repr(e)))
                continue
            lat[r] = time.perf_counter() - t0
            ids[r], dists[r] = i, d
            with lock:
                done[0] += 1

    threads = [threading.Thread(target=client,
                                args=(range(c, n, N_CLIENTS),))
               for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    extra = during(done) if during is not None else None
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    require(not any(th.is_alive() for th in threads), "a fleet client hung")
    sent = ~np.isnan(lat)
    return {"ids": ids, "dists": dists, "lat": lat, "wall": wall,
            "errors": errors, "answered": sent, "extra": extra,
            "p50_ms": float(np.percentile(lat[sent] * 1e3, 50)),
            "p99_ms": float(np.percentile(lat[sent] * 1e3, 99)),
            "qps": float(sent.sum() / wall)}


def check_served(name, recorders, pool, order, res, since) -> int:
    """Every answer (cache hits included) is a row of a batch its cell's
    backend answered, bit for bit; every batch answered since ``since``
    equals a direct call of that backend on the same batch, bit for bit.
    Returns the batches replayed."""
    seen: dict = {}
    replayed = 0
    for rec, s0 in zip(recorders, since):
        for j, (qs, (d, i)) in enumerate(rec.calls):
            if j >= s0:
                same_bits(f"{name}: a served batch against a direct call",
                          (d, i), rec.backend(qs))
                replayed += 1
            for row in range(len(d)):
                seen.setdefault(qs[row].tobytes(), set()).add(
                    (d[row].tobytes(), i[row].tobytes()))
    ok = res["answered"]
    for r in np.flatnonzero(ok):
        key = pool[order[r]].tobytes()
        require((res["dists"][r].tobytes(), res["ids"][r].tobytes())
                in seen.get(key, ()),
                f"{name}: request {r}'s answer is no backend's answer")
    return replayed


def cell_counts(router) -> dict:
    """Per cell: requests its worker served and its cache hits, so far."""
    return {c.name: (c.stats().n,
                     c.cache.hits if c.cache is not None else 0)
            for c in router.cells}


def window_report(name, router, res, before, truth_rows, label) -> dict:
    after = cell_counts(router)
    per_cell = {c: (after[c][0] - before[c][0]) + (after[c][1] - before[c][1])
                for c in after}
    hits = sum(after[c][1] - before[c][1] for c in after)
    ok = res["answered"]
    out = {"p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "qps": res["qps"], "wall_s": res["wall"],
           "requests": int(ok.sum()), "lost": len(res["errors"]),
           "cache_hit_rate": hits / max(int(ok.sum()), 1),
           "requests_per_cell": per_cell}
    if truth_rows is not None:
        out["recall_at_10"] = recall_at_k(res["ids"][ok], truth_rows[ok])
    log(f"[fleet] {name} on {label}: {out['requests']} requests, "
        f"{N_CLIENTS} clients, p50 {out['p50_ms']:.3f} ms p99 "
        f"{out['p99_ms']:.3f} ms QPS {out['qps']:.1f}, cache hit rate "
        f"{out['cache_hit_rate']:.4f}, requests per cell {per_cell}"
        + (f", recall@10 {out['recall_at_10']:.4f}"
           if "recall_at_10" in out else "")
        + f", lost {out['lost']}")
    return out


def phase_fleet(dev, ctx) -> dict:
    """The fleet tier and the adaptive loop at sift-1m width: four cells
    sharing the card, each its own IVF placement (nprobe 32, k 10), a
    TinyLFU cache each, one estimator (sketch on the card) and a
    MaintenanceScheduler leading the fleet."""
    from repro_torch.adaptive import (CountMinSketch,
                                      FrequencyAdmissionCache,
                                      MaintenanceScheduler,
                                      OnlineLikelihoodEstimator)
    from repro_torch.serve.fleet import CellRouter, build_fleet

    label, idx = ctx["label"], ctx["idx"]
    out: dict = {}
    rng = np.random.default_rng(7)
    pool = make_queries(ctx["corpus"], FLEET_POOL, seed=7)
    zipf = 1.0 / np.arange(1, FLEET_POOL + 1) ** FLEET_ZIPF
    zipf /= zipf.sum()
    order = rng.choice(FLEET_POOL, FLEET_REQUESTS, p=zipf)
    truth = batched(ctx["brute"], pool)[1]

    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated(dev)
    est = OnlineLikelihoodEstimator(SIFT_1M.n, width=FLEET_SKETCH_WIDTH,
                                    halflife=FLEET_HALFLIFE)
    router = build_fleet(
        [dev] * FLEET_CELLS, idx, kind="ivf", k=K,
        cache_capacity=FLEET_CACHE, estimator=est,
        backend_kw=dict(nprobe_local=SIFT_1M.nprobe,
                        headroom=FOREST_HEADROOM),
        cell_kw=dict(max_batch=BATCH, max_wait_ms=2.0))
    torch.cuda.synchronize()
    recs = []
    for c in router.cells:
        c.search_fn = Recorder(c.search_fn)
        recs.append(c.search_fn)
    out["build_s"] = time.perf_counter() - t0
    out["placed_bytes"] = int(torch.cuda.memory_allocated(dev) - mem0)
    log(f"[fleet] {FLEET_CELLS} cells on one card ({label}): each its own IVF "
        f"placement of {SIFT_1M.n} x {SIFT_1M.d} ({idx.k_clusters} buckets, "
        f"nprobe {SIFT_1M.nprobe}, headroom {FOREST_HEADROOM}), "
        f"{out['placed_bytes']} bytes in all, built in {out['build_s']:.1f} s")
    try:
        for rec in recs:                      # warm-up, not recorded
            rec.backend(pool[:BATCH])
        torch.cuda.synchronize()

        # -- steady: one cell (its own cache and estimator, as a fleet
        #    cell has), then the fleet on own / default streams
        one = CellRouter([ServingCell(
            recs[0].backend, name="one", max_batch=BATCH, max_wait_ms=2.0,
            cache=FrequencyAdmissionCache(FLEET_CACHE),
            estimator=OnlineLikelihoodEstimator(
                SIFT_1M.n, width=FLEET_SKETCH_WIDTH,
                halflife=FLEET_HALFLIFE))])
        before = cell_counts(one)
        res = fleet_traffic(one, pool, order)
        require(not res["errors"], f"one cell lost requests {res['errors'][:3]}")
        out["one_cell"] = window_report("one cell", one, res, before,
                                        truth[order], label)
        one.cells[0].close()
        windows = []
        own = [r.backend._stream for r in recs]
        for w, streams in enumerate(("own", "default", "own")):
            # each backend's own stream, or the card's default stream (the
            # backend's synchronise then waits for every cell's kernels)
            for c, s_own in zip(router.cells, own):
                c.cache.invalidate_all()
                c.search_fn.backend._stream = (None if streams == "default"
                                               else s_own)
            since = [len(r.calls) for r in recs]
            before = cell_counts(router)
            rc0 = router.stats()
            reset_launches()
            res = fleet_traffic(router, pool, order)
            torch.cuda.synchronize()
            launches = read_launches()
            require(not res["errors"], f"the fleet lost requests "
                    f"{res['errors'][:3]}")
            rep = window_report(f"steady {w} ({streams} streams)", router,
                                res, before, truth[order], label)
            rep["launches"] = {n: v for n, v in launches.items() if v}
            require(launches["candidate_topk"] > 0,
                    "the fleet's path never launched bucket_probe_topk")
            rep["replayed"] = check_served(f"steady {w}", recs, pool, order,
                                           res, since)
            rep["route"] = router.stats().stages.get("route")
            rep["shed"] = router.shed - rc0.shed
            windows.append((streams, rep))
            log(f"[fleet] steady {w}: launches {rep['launches']}; every "
                f"answer, hits included, is its cell backend's answer bit for "
                f"bit ({rep['replayed']} served batches replayed directly)")
            if w == 0:
                steady_res = res
        out["steady"] = windows
        steady = windows[0][1]
        log(f"[fleet] recall@10 {steady['recall_at_10']:.4f} (one cell on the "
            f"same traffic {out['one_cell']['recall_at_10']:.4f}; the serve "
            f"phase's cell {RESULTS['main']['recall_at_10']:.4f})")

        # -- hedge: cell0 straggles FLEET_DELAY_S a batch
        for c in router.cells:
            c.cache.invalidate_all()
        recs[0].delay_s = FLEET_DELAY_S
        router.hedge_ms = FLEET_HEDGE_MS
        h0 = router.hedge_cell
        since = [len(r.calls) for r in recs]
        hedge_order = order[:FLEET_HEDGE_REQUESTS]
        before = cell_counts(router)
        reset_launches()
        res = fleet_traffic(router, pool, hedge_order)
        out["hedge_launches"] = read_launches()["candidate_topk"]
        recs[0].delay_s = 0.0
        router.hedge_ms = None
        require(not res["errors"], f"the hedge window lost requests "
                f"{res['errors'][:3]}")
        out["hedge"] = window_report("hedge window", router, res, before,
                                     truth[hedge_order], label)
        out["hedge"]["hedge_cell"] = router.hedge_cell - h0
        require(out["hedge"]["hedge_cell"] > 0, "no request was hedged")
        check_served("hedge", recs, pool, hedge_order, res, since)
        same = float((res["ids"] == steady_res["ids"][:FLEET_HEDGE_REQUESTS])
                     .all(1).mean())
        out["hedge"]["same_as_steady"] = same
        log(f"[fleet] hedge: cell0 delayed {FLEET_DELAY_S * 1e3:.0f} ms a "
            f"batch, hedge_ms {FLEET_HEDGE_MS}: hedge_cell "
            f"{out['hedge']['hedge_cell']}; every answer a backend's bit for "
            f"bit; {same:.4f} of answers equal the steady window's")

        # -- fail: cell3 starts raising mid-window
        remap = pool[:FLEET_REMAP_QUERIES]
        pref0 = [router.preferred_cell(x).name for x in remap]
        r0 = router.rerouted
        since = [len(r.calls) for r in recs]
        fail_order = order[:FLEET_FAIL_REQUESTS]

        def fail_mid(done):
            while done[0] < FLEET_FAIL_AFTER:
                time.sleep(0.001)
            recs[3].fail.set()

        before = cell_counts(router)
        res = fleet_traffic(router, pool, fail_order, during=fail_mid)
        require(not res["errors"], f"a cell failure lost requests "
                f"{res['errors'][:3]}")
        require(res["answered"].all(), "a request went unanswered")
        out["fail"] = window_report("fail window", router, res, before,
                                    truth[fail_order], label)
        out["fail"]["rerouted"] = router.rerouted - r0
        require(out["fail"]["rerouted"] > 0, "no request was rerouted")
        require(set(router.down_cells()) == {"cell3"},
                f"down cells {router.down_cells()}")
        check_served("fail", recs, pool, fail_order, res, since)
        pref1 = [router.preferred_cell(x).name for x in remap]
        moved = [(a, b) for a, b in zip(pref0, pref1) if a != b]
        require(all(a == "cell3" for a, _ in moved)
                and all(b != "cell3" for b in pref1),
                "a live cell's key moved when cell3 went down")
        out["fail"]["remapped"] = len(moved)
        out["fail"]["cell3_keys"] = pref0.count("cell3")
        log(f"[fleet] fail: cell3 raised after {FLEET_FAIL_AFTER} answers: "
            f"0 lost of {len(fail_order)}, rerouted {out['fail']['rerouted']}; "
            f"of {FLEET_REMAP_QUERIES} queries {len(moved)} remapped, all "
            f"cell3's ({out['fail']['cell3_keys']})")

        # -- maintenance: the head rotates, the index takes the lifecycle's
        #    add and delete, the leader fans one manifest out while the
        #    clients keep going
        life = ivf_copy(idx)
        t0 = time.perf_counter()
        added = np.asarray(life.add_entities(ctx["life_new"]), np.int64)
        life.delete_entities(ctx["life_gone"])
        out["mutation_s"] = time.perf_counter() - t0
        est.set_reference(est.current_raw())
        rot = rng.permutation(FLEET_POOL)
        rot_order = rot[rng.choice(FLEET_POOL, FLEET_ROTATED, p=zipf)]
        sched = MaintenanceScheduler(est, life, engine=router, interval_s=None)
        live = [c for c in router.cells if c.name != "cell3"]
        gens = {c.name: c.cache.generation for c in router.cells}
        stop = threading.Event()

        def lead(done):
            ev, checks, t_fan = None, 0, None
            mark = 0
            while ev is None and done[0] < len(rot_order) - FLEET_CHECK_EVERY:
                if done[0] >= mark + FLEET_CHECK_EVERY:
                    mark = done[0]
                    checks += 1
                    t1 = time.perf_counter()
                    ev = sched.check_now()
                    t_fan = time.perf_counter() - t1
                else:
                    time.sleep(0.002)
            at = done[0]
            while done[0] < at + FLEET_MAINT_AFTER and not stop.is_set():
                time.sleep(0.002)
            stop.set()
            return {"event": ev, "checks": checks, "maintenance_s": t_fan,
                    "answered_at_trigger": mark, "answered_after": at}

        rc0 = router.rerouted
        before = cell_counts(router)
        res = fleet_traffic(router, pool, rot_order, during=lead, stop=stop)
        info = res["extra"]
        ev = info["event"]
        require(ev is not None, "the leader never triggered")
        require(sched.n_reboosts == 1, "the leader triggered more than once")
        require(not res["errors"], f"the maintenance window lost requests "
                f"{res['errors'][:3]}")
        maint = window_report("maintenance window", router, res, before,
                              None, label)
        rep = ev["republish"]
        modes = {name: st["mode"] for name, st in rep["cells"].items()}
        require(modes == {"cell0": "delta", "cell1": "delta",
                          "cell2": "delta", "cell3": "skipped"},
                f"the fan-out's modes {modes}: {rep['cells']}; rebalance "
                f"{ev['rebalance']}")
        maint.update(
            drift=ev["drift"], checks=info["checks"],
            maintenance_s=info["maintenance_s"], modes=modes,
            bytes=rep["bytes"], full_bytes=rep["full_bytes"],
            reboost=ev["reboost"], rebalance=ev["rebalance"],
            p99_over_steady=maint["p99_ms"] / steady["p99_ms"],
            rerouted=router.rerouted - rc0)
        out["maintenance"] = maint
        log(f"[fleet] maintenance: drift tv {ev['drift']['tv']:.4f} after "
            f"{info['answered_at_trigger']} rotated requests ({info['checks']} "
            f"checks); reboost {ev['reboost']}, rebalance {ev['rebalance']}; "
            f"one pop_delta, rolling fan-out {modes}, bytes {rep['bytes']} of "
            f"full {rep['full_bytes']}, {info['maintenance_s']:.2f} s while "
            f"the clients kept going; window p99 {maint['p99_ms']:.3f} ms, "
            f"{maint['p99_over_steady']:.3f}x the steady window's "
            f"{steady['p99_ms']:.3f} ms (the reference's fig8 bar: 2x; "
            "reported only)")
        qc = ctx["queries"][:FLEET_CHECK_QUERIES]
        fresh = ShardedSearchBackend(life, kind="ivf", k=K,
                                     nprobe_local=SIFT_1M.nprobe,
                                     headroom=FOREST_HEADROOM)
        want = batched(fresh, qc)
        gone = ctx["life_gone"]
        for c in live:
            same_bits(f"{c.name} after the fan-out against a fresh backend",
                      batched(c.search_fn.backend, qc), want)
            require(not np.isin(in_chunks(c.search_fn.backend,
                                          life.db[gone]), gone).any(),
                    f"{c.name} returned a deleted id")
            require(c.cache.generation == gens[c.name] + 1,
                    f"{c.name}'s cache was not invalidated once")
        got = in_chunks(fresh, life.db[added])[:, 0]
        out["maintenance"]["added_found_at_rank_1"] = float(
            (got == added).mean())
        log(f"[fleet] after the fan-out: every live cell equals a fresh "
            f"backend on the mutated index bit for bit on "
            f"{FLEET_CHECK_QUERIES} queries, no deleted id of {gone.size} "
            f"returned, every live cache's generation +1")

        # -- revive: cell3 is repaired and replays what it missed
        recs[3].fail.clear()
        st = router.revive("cell3")
        require(st is not None and st["mode"] == "delta",
                f"cell3's replay {st}")
        require(router.stats().resyncs == 1, "resyncs != 1")
        same_bits("cell3 after revive against a fresh backend",
                  batched(recs[3].backend, qc), want)
        require(router.cells[3].cache.generation == gens["cell3"] + 1,
                "cell3's cache was not invalidated at its replay")
        require("cell3" not in router.down_cells(), "cell3 is still down")
        out["revive"] = st
        log(f"[fleet] revive: cell3 replayed the merged manifest ({st}), "
            f"equals a fresh backend bit for bit; resyncs 1")
        del fresh

        # -- the sketch on the card against the same sketch on the CPU
        ids_seen = steady_res["ids"][:, 0]
        t0 = time.perf_counter()
        drift = est.drift()
        out["drift_query_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for j in range(200):                 # what a cache hit adds
            est.observe(ids_seen[j:j + 1])
        torch.cuda.synchronize()
        out["observe_one_ms"] = (time.perf_counter() - t0) * 1e3 / 200
        sk = {}
        for weighted in (False, True):
            card, cpu = (CountMinSketch(width=FLEET_SKETCH_WIDTH, depth=4,
                                        topk=64, halflife=FLEET_HALFLIFE,
                                        seed=0, device=d)
                         for d in (dev, "cpu"))
            wrng = np.random.default_rng(9)
            for lo in range(0, ids_seen.size, ids_seen.size // 20):
                b = ids_seen[lo:lo + ids_seen.size // 20]
                w = (wrng.random(b.size).astype(np.float32) * 3
                     if weighted else None)
                card.update(b, w)
                cpu.update(b, w)
            cols = np.arange(0, SIFT_1M.n, 7)
            sk["weighted" if weighted else "unit"] = {
                "columns": bool(np.array_equal(card.columns(cols),
                                               cpu.columns(cols))),
                "table": bool(np.array_equal(
                    card.table.cpu().numpy().view(np.int32),
                    cpu.table.numpy().view(np.int32))),
                "heavy_hitters": all(np.array_equal(a, b) for a, b in zip(
                    card.heavy_hitters(), cpu.heavy_hitters()))}
        require(all(all(v.values()) for v in sk.values()),
                f"the card sketch differs from the CPU sketch: {sk}")
        out["sketch"] = sk
        log(f"[fleet] sketch on the card against the CPU over 20 batches of "
            f"served top-1 ids: {sk}; the estimator's drift over all "
            f"{est.n} ids {out['drift_query_ms']:.2f} ms (tv "
            f"{drift['tv']:.4f}); one observed id (a cache hit's) "
            f"{out['observe_one_ms']:.4f} ms on the host clock")
        st = router.stats()
        out["stats"] = {k_: getattr(st, k_) for k_ in (
            "n", "p50_ms", "p99_ms", "hedges", "cache_hits", "cache_misses",
            "drift", "republished_bytes", "delta_fraction", "cancelled",
            "shed", "rerouted", "hedge_cell", "resyncs")}
        log(f"[fleet] router stats {out['stats']}")
    finally:
        router.close()

    # -- the launcher, on the card, in a process of its own
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "sift-1m", "--n-requests", "256"], capture_output=True, text=True,
        timeout=LAUNCHER_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    require(r.returncode == 0, f"the launcher failed: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    require(any(x.startswith("paper bars:") for x in lines),
            "the launcher printed no paper bar line")
    require(any(x.startswith("first calls: compile_signatures")
                for x in lines), "the launcher printed no first-calls line")
    out["launcher"] = {"s": time.perf_counter() - t0, "lines": lines}
    for x in lines:
        log(f"[fleet] launcher: {x}")
    RESULTS["fleet"] = out
    return out


# ------------------------------------------------------------ phase 14
# the six kernels the registered entry points reach (the forest entry
# point's descent among them; PQ-ADC and Hamming serve the index layer,
# which no entry point drives)
GATE_KERNELS = ("l2_topk", "candidate_topk", "l2_topk_int8", "bm25_topk",
                "hybrid_topk", "tree_descent")
ANALYSIS_LIMIT_S = 60.0      # this phase's share of the command's time


def gate_steps(tracer: Tracer) -> dict:
    """Entry point -> [(step, wall ms)] from the gate's spans, and the
    compiled variants each entry point ended with."""
    steps: dict = {}
    for e in tracer.events("gate.step"):
        a = e["args"]
        steps.setdefault(a["entry"], []).append(
            (a["step"], round(e["dur"] / 1e3, 3)))
    variants = {e["args"]["entry"]: e["args"].get("variants")
                for e in tracer.events("gate.entry-point")}
    return {"steps": steps, "variants": variants}


def phase_analysis(ctx) -> dict:
    t_phase = time.perf_counter()
    out: dict = {}
    # 1. the static gate over the port's sources
    t0 = time.perf_counter()
    active, suppressed = run_static_analysis(
        [os.path.join(ROOT, "src", "repro_torch")])
    for f in active:
        log(f"[analysis] {f.format()}")
    require(active == [], f"the static gate found {len(active)} finding(s)")
    out["static"] = {"findings": 0, "suppressed": len(suppressed),
                     "s": time.perf_counter() - t0}
    log(f"[analysis] static gate over src/repro_torch: 0 findings, "
        f"{len(suppressed)} suppressed, {out['static']['s']:.2f} s")

    # 2. the recompile gate on the card: the main path of this phase
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        reset_launches()
        t0 = time.perf_counter()
        found = run_recompile_gate()
        torch.cuda.synchronize()
        gate_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        set_tracer(old)
    for f in found:
        log(f"[analysis] {f.format()}")
    require(found == [], f"the recompile gate found {len(found)} finding(s) "
            "on the card")
    spans = gate_steps(tracer)
    require(sorted(spans["steps"]) == sorted(ENTRY_POINTS),
            "the gate did not run every registered entry point")
    for name in sorted(spans["steps"]):
        log(f"[analysis] gate {name}: steps {spans['steps'][name]} "
            f"(label, wall ms); jit_cache_size {spans['variants'][name]}")
    log(f"[analysis] gate on the card: 0 findings over "
        f"{len(ENTRY_POINTS)} entry points in {gate_s:.2f} s; "
        f"gate_step_ms p50 "
        f"{PROFILE.get('gate_step_ms').quantile(0.5):.3f}")
    log(f"[analysis] launches {launches}")
    for name in GATE_KERNELS:
        require(launches[name] > 0,
                f"the gate's entry points never launched {name}")
    out["gate"] = {"s": gate_s, "findings": 0, "launches": launches,
                   **spans}

    # 3. a seeded plan: a new batch shape after the warm-up is exactly one
    # recompile on the card
    rng = np.random.default_rng(11)
    seed_be = ShardedSearchBackend(
        rng.normal(size=(4096, 32)).astype(np.float32), kind="brute", k=K)

    def seeded():
        q = rng.normal(size=(9, 32)).astype(np.float32)
        return Plan(steps=[("warmup-b8", lambda: seed_be(q[:8])),
                           ("new-batch-shape-b9", lambda: seed_be(q))],
                    cache_size=seed_be.jit_cache_size)

    seeded_found = run_entry_point("seeded-new-batch-shape", seeded)
    log(f"[analysis] seeded plan: {[f.format() for f in seeded_found]}")
    require([f.rule for f in seeded_found] == ["recompile"],
            "the seeded new batch shape is not exactly one recompile")
    out["seeded"] = [f.message for f in seeded_found]

    # 4. the per-entry-point replay
    t0 = time.perf_counter()
    prof = profile_entry_points()
    out["profile"] = {"s": time.perf_counter() - t0, "entries": prof}
    for name, r in sorted(prof.items()):
        require("error" not in r, f"profile of {name} failed: {r}")
        log(f"[analysis] profile {name}: "
            f"{[(st['label'], st['wall_ms']) for st in r['steps']]} "
            f"compiles {r['compiles']} wall {r['wall_ms']:.1f} ms")

    # 5. the roofline of the serve phase's backends after their traffic
    out["roofline"] = {}
    for kind in ("brute", "ivf"):
        rep = ctx[kind].roofline_report(b=BATCH,
                                        peak_bw=HBM_BYTES_PER_S)
        out["roofline"][kind] = rep
        log(f"[analysis] roofline {kind} B={BATCH}: analytic_frac "
            f"{rep['analytic_frac']:.6f} achieved_gbps "
            f"{rep['achieved_gbps']:.2f} measured_frac "
            f"{rep['measured_frac']:.6f} (useful bytes "
            f"{rep['useful_bytes']:.0f}, kernel_ms p50 "
            f"{rep['measured_kernel_ms_p50']:.4f} over "
            f"{ctx[kind].metrics.get('kernel_ms').count} dispatches, bound "
            f"{rep['bound_ms']:.4f} ms by {rep['bound_by']}; "
            f"{ctx['label']})")
        require(0 < rep["measured_frac"] <= 1.05,
                f"{kind}: measured_frac {rep['measured_frac']} is not a "
                "possible reading")

    # 6. the serve phase's first calls beside its steady p50
    fc = RESULTS["main"]["first_calls"]
    log(f"[analysis] serve first calls: compile_signatures "
        f"{fc['compile_signatures']} first_call_ms n {fc['first_call_ms_n']}"
        f" sum {fc['first_call_ms_sum']:.3f} mean "
        f"{fc['first_call_ms_mean']:.3f}; steady kernel_ms p50 "
        f"{fc['kernel_ms_p50']:.4f} over {fc['dispatches']} dispatches; "
        f"request p50 {RESULTS['main']['p50_ms']:.3f} ms")

    # 7. each library's build in the build phase
    builds = {}
    for name in _build.SOURCES:
        h = PROFILE.get(f"kernel_build_ms.{name}")
        require(h is not None and h.count >= 1,
                f"PROFILE holds no kernel_build_ms for {name}")
        builds[name] = h.sum
    out["kernel_build_ms"] = builds
    log(f"[analysis] PROFILE kernel_build_ms by library (build phase): "
        f"{ {n: round(v, 1) for n, v in builds.items()} }; "
        f"kernel_builds {PROFILE.counter('kernel_builds').value}")

    # 8. the observability smoke on the card
    t0 = time.perf_counter()
    require(obs_smoke.main(["--out", os.path.join(OUT_DIR,
                                                  "obs_trace.json")]) == 0,
            "the observability smoke failed")
    out["obs_smoke_s"] = time.perf_counter() - t0
    out["s"] = time.perf_counter() - t_phase
    log(f"[analysis] phase {out['s']:.1f} s (budget {ANALYSIS_LIMIT_S:.0f} s;"
        f" obs smoke {out['obs_smoke_s']:.1f} s)")
    RESULTS["analysis"] = out
    return out


# ------------------------------------------------------------ phase 15
# The language models' serving path (plain torch; no kernel of its own).
# Tolerances, stated before the run: card against CPU at the fp32 policy
# (no TF32) on the same weights; decode after prefill(S) against
# prefill(S + 1), the reference's own invariant (tests/test_models.py).
LM_PARITY_TOL = dict(rtol=1e-4, atol=1e-4)
LM_CONSIST_TOL = dict(rtol=2e-3, atol=2e-3)
LM_BATCH = 2
LM_PARITY_SEQ = 16
# registry shape prefill_32k with its batch cut from 32 to 2 (memory: the
# bf16 cache alone is 7.5 GB at batch 2, 120 GB at 32); the prompt leaves
# room for LM_DECODE_STEPS greedy steps, so decode ends at decode_32k's
# context
LM_SERVE_SHAPE = "prefill_32k"
LM_DECODE_STEPS = 32
LM_WARM_SEQ = 2048
LM_PROFILE_SEQ = 8192
# deepseek-v3-671b at full width, depth cut to 1 dense + 1 MoE layer
LM_DEEP_DEPTH = dict(n_layers=2, n_dense_layers=1)
LM_DEEP_SEQ = 512
LM_DEEP_STEPS = 8


def _lm_close(name: str, a, b, tol: dict, argmax: bool = False) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    ok = bool(torch.allclose(a, b, **tol))
    require(ok, f"[lm] {name}: max abs err {err} beyond {tol}")
    if argmax:
        require(torch.equal(a.argmax(-1), b.argmax(-1)),
                f"[lm] {name}: argmax differs")
    return err


def _lm_parity(name, cfg, params) -> dict:
    """``cfg`` at the fp32 policy on the card and on the CPU (the same
    weights, copied): prefill logits and cache, one decode step's logits
    and cache, ``loss_fn`` (MTP included where the config has it), and
    decode after prefill(S) against prefill(S + 1) on the card."""
    cpu = tree_map(lambda t: t.cpu(), params)
    batch = LMStream(cfg.vocab, LM_PARITY_SEQ + 1, LM_BATCH,
                     seed=0).batch_at(0)
    toks = batch["tokens"]
    prompt, nxt = toks[:, :LM_PARITY_SEQ], toks[:, LM_PARITY_SEQ:]
    max_len = LM_PARITY_SEQ + 8
    out, errs = {}, {}
    for side, p in (("card", params), ("cpu", cpu)):
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(p, prompt, cfg,
                                            max_len=max_len)
        pre = {k: v.cpu().clone() for k, v in cache.items()}
        dlog, cache = transformer.decode_step(p, cache, nxt, cfg)
        loss = transformer.loss_fn(
            p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cfg)[0]
        out[side] = (logits.cpu(), pre, dlog.cpu(),
                     {k: v.cpu() for k, v in cache.items()}, loss.cpu())
        errs[f"{side}_s"] = time.perf_counter() - t0
    (lc, pc, dc, cc, sc), (lp, pp, dp, cp, sp) = out["card"], out["cpu"]
    errs["prefill_logits"] = _lm_close(f"{name} prefill", lc, lp,
                                       LM_PARITY_TOL, argmax=True)
    errs["decode_logits"] = _lm_close(f"{name} decode", dc, dp,
                                      LM_PARITY_TOL, argmax=True)
    for k in cc:
        errs[f"prefill_{k}"] = _lm_close(f"{name} prefill cache {k}",
                                         pc[k], pp[k], LM_PARITY_TOL)
        errs[f"decode_{k}"] = _lm_close(f"{name} decode cache {k}",
                                        cc[k], cp[k], LM_PARITY_TOL)
    errs["loss"] = _lm_close(f"{name} loss", sc, sp, LM_PARITY_TOL)
    whole, _ = transformer.prefill(params, toks, cfg, max_len=max_len)
    errs["decode_vs_prefill_s1"] = _lm_close(
        f"{name} decode after prefill(S) vs prefill(S+1)", dc, whole,
        LM_CONSIST_TOL)
    require(cc["lengths"].tolist() == [LM_PARITY_SEQ + 1] * LM_BATCH,
            f"[lm] {name}: lengths {cc['lengths'].tolist()}")
    return errs


def _greedy(params, cfg, logits, cache, steps: int):
    """``steps`` greedy decode steps; per-step CUDA-event ms, the tokens
    and whether every logit stayed finite."""
    ms, toks, finite = [], [], torch.isfinite(logits).all()
    for _ in range(steps):
        tok = logits.argmax(-1)[:, None]
        toks.append(tok)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = transformer.decode_step(params, cache, tok, cfg)
        b.record()
        finite = finite & torch.isfinite(logits).all()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return logits, cache, ms, torch.cat(toks, 1), bool(finite)


def phase_lm(dev, card) -> dict:
    """qwen3-0.6b (full width and depth) card against CPU at the fp32
    policy, then served at bf16 over a 32,736-token prompt with 32 greedy
    decode steps; deepseek-v3-671b and kimi-k2 at ``reduced()`` (MoE and
    MLA) card against CPU; deepseek-v3-671b at full width with its depth
    cut, bf16."""
    smi = card["nvidia_smi"]
    out = {"card": smi}
    require_fp32_matmul()

    # 1. qwen3-0.6b at full width and depth, fp32 policy, card vs CPU
    cfg = get_arch("qwen3-0.6b")[0]
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.d_head, cfg.d_ff, cfg.vocab, cfg.qk_norm,
             cfg.tie_embeddings) == (28, 1024, 16, 8, 128, 3072, 151936,
                                     True, True), "qwen3-0.6b config")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device=dev)
    init_s = time.perf_counter() - t0
    transformer.set_precision(torch.float32, torch.float32)
    try:
        errs = _lm_parity("qwen3-0.6b", cfg, params)
    finally:
        transformer.set_precision()
    out["qwen_parity"] = errs
    log(f"[lm] qwen3-0.6b full width, fp32 policy, card vs CPU "
        f"(B {LM_BATCH} x {LM_PARITY_SEQ} from LMStream, same weights): "
        f"max abs err prefill logits {errs['prefill_logits']:.3e}, decode "
        f"{errs['decode_logits']:.3e}, cache k/v {errs['decode_k']:.3e} / "
        f"{errs['decode_v']:.3e}, loss {errs['loss']:.3e} (tol "
        f"{LM_PARITY_TOL}); argmax equal; decode after prefill(S) vs "
        f"prefill(S+1) {errs['decode_vs_prefill_s1']:.3e} (tol "
        f"{LM_CONSIST_TOL}); {count_params(params)} params, init "
        f"{init_s:.2f} s; {smi}")

    # 2. qwen3-0.6b served at bf16: prefill_32k's prompt, 32 decode steps
    shape = get_shape("lm", LM_SERVE_SHAPE)
    max_len = shape["seq"]
    s = max_len - LM_DECODE_STEPS
    # the reference's serving binding (launch/cells.py, lm_config_for_mesh
    # and _lm_decode_cell): bf16 weights, KV blocks of min(1024, seq / 4)
    scfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                               attn_chunk=min(1024, max_len // 4),
                               remat=False)
    sparams = cast_tree(params, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    prompt = torch.as_tensor(LMStream(cfg.vocab, s, LM_BATCH,
                                      seed=1).batch_at(0)["tokens"],
                             device=dev)
    t0 = time.perf_counter()
    transformer.prefill(sparams, prompt[:, :LM_WARM_SEQ], scfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sparams, prompt, scfg,
                                        max_len=max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(logits).all()), "[lm] prefill logits")
    logits, cache, ms, gen, finite = _greedy(sparams, scfg, logits, cache,
                                             LM_DECODE_STEPS)
    require(finite, "[lm] qwen3-0.6b decode logits are not finite")
    require(cache["lengths"].tolist() == [max_len] * LM_BATCH,
            f"[lm] lengths {cache['lengths'].tolist()} != {max_len}")
    require(bool(((gen >= 0) & (gen < cfg.vocab)).all()),
            "[lm] generated tokens out of the vocabulary")
    # where a step's time goes: two decode steps at the full context (the
    # last two slots written again), and a prefill of 2 x 8,192 (8 KV
    # blocks of the 32 above)
    last = logits

    def two_steps():
        c = {**cache, "lengths": torch.full_like(cache["lengths"],
                                                 max_len - 2)}
        lg = last
        for _ in range(2):
            lg, c = transformer.decode_step(sparams, c,
                                            lg.argmax(-1)[:, None], scfg)

    prof_decode = profile_window("lm decode", f"qwen3-0.6b bf16 at "
                                 f"{max_len}", two_steps, 2, LM_BATCH)
    prof_prefill = profile_window(
        "lm prefill", f"qwen3-0.6b bf16 {LM_BATCH} x {LM_PROFILE_SEQ}",
        lambda: transformer.prefill(sparams, prompt[:, :LM_PROFILE_SEQ],
                                    scfg), 1, LM_BATCH)
    p_bytes = tree_bytes(sparams)
    c_bytes = tree_bytes(cache)
    ms_sorted = sorted(ms)
    serve = {"batch": LM_BATCH, "prompt": s, "max_len": max_len,
             "attn_chunk": scfg.attn_chunk, "warm_prefill_s": warm_s,
             "prefill_s": prefill_s,
             "prefill_tokens_per_s": LM_BATCH * s / prefill_s,
             "decode_ms": ms, "decode_ms_mean": sum(ms) / len(ms),
             "decode_ms_p50": ms_sorted[len(ms) // 2],
             "decode_tokens_per_s": LM_BATCH * 1000.0 * len(ms) / sum(ms),
             "prefill_peak_bytes": prefill_peak,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "param_bytes": p_bytes, "cache_bytes": c_bytes,
             "decode_bytes_bound_ms": (p_bytes + c_bytes)
             / HBM_BYTES_PER_S * 1e3,
             "profile_decode": prof_decode, "profile_prefill": prof_prefill}
    out["qwen_serve"] = serve
    log(f"[lm] qwen3-0.6b bf16 serve ({LM_SERVE_SHAPE}, batch cut 32 -> "
        f"{LM_BATCH}): prefill {LM_BATCH} x {s} tokens in {prefill_s:.3f} s"
        f" ({serve['prefill_tokens_per_s']:.0f} tokens/s; warm-up "
        f"{LM_BATCH} x {LM_WARM_SEQ} {warm_s:.2f} s), attn_chunk "
        f"{scfg.attn_chunk}; {LM_DECODE_STEPS} greedy decode steps to "
        f"{max_len}: mean {serve['decode_ms_mean']:.3f} ms, p50 "
        f"{serve['decode_ms_p50']:.3f} ms a step (CUDA events; "
        f"{serve['decode_tokens_per_s']:.1f} tokens/s; bytes bound "
        f"{serve['decode_bytes_bound_ms']:.3f} ms: params + cache read "
        f"once at 3.35 TB/s); params {p_bytes} B, cache {c_bytes} B, "
        f"max_memory_allocated {serve['peak_bytes']} B (prefill "
        f"{prefill_peak} B); {smi}")
    del sparams, cache, logits, prompt
    torch.cuda.empty_cache()

    # 3. MoE + MLA at reduced(), fp32 policy, card vs CPU
    out["reduced"] = {}
    transformer.set_precision(torch.float32, torch.float32)
    try:
        for arch in ("deepseek-v3-671b", "kimi-k2-1t-a32b"):
            rc = get_arch(arch)[0].reduced()
            rc = dataclasses.replace(
                rc, residual_dtype="float32", remat=False,
                moe=dataclasses.replace(rc.moe, capacity_factor=8.0))
            rp = transformer.init(rc, seed=0, device=dev)
            errs = _lm_parity(arch, rc, rp)
            out["reduced"][arch] = errs
            log(f"[lm] {arch} reduced (MoE {rc.moe.n_experts}e top-"
                f"{rc.moe.top_k}, MLA, capacity factor 8, fp32 policy, "
                f"fp32 residual; MTP {rc.mtp}): card vs CPU max abs err "
                f"prefill {errs['prefill_logits']:.3e}, decode "
                f"{errs['decode_logits']:.3e}, cache ckv "
                f"{errs['decode_ckv']:.3e}, loss {errs['loss']:.3e}; "
                f"decode vs prefill(S+1) "
                f"{errs['decode_vs_prefill_s1']:.3e}")
    finally:
        transformer.set_precision()

    # 4. deepseek-v3-671b at full width, depth cut, bf16
    dcfg = dataclasses.replace(get_arch("deepseek-v3-671b")[0],
                               **LM_DEEP_DEPTH, remat=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dparams = transformer.init(dcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    dinit_s = time.perf_counter() - t0
    toks = torch.as_tensor(LMStream(dcfg.vocab, LM_DEEP_SEQ, LM_BATCH,
                                    seed=2).batch_at(0)["tokens"],
                           device=dev)
    dmax = LM_DEEP_SEQ + LM_DEEP_STEPS
    transformer.prefill(dparams, toks[:, :64], dcfg)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(dparams, toks, dcfg,
                                        max_len=dmax)
    torch.cuda.synchronize()
    dprefill_s = time.perf_counter() - t0
    require(bool(torch.isfinite(logits).all()), "[lm] deepseek prefill")
    m = dcfg.mla
    want = {"ckv": (2, LM_BATCH, dmax, m.kv_lora_rank),
            "krope": (2, LM_BATCH, dmax, m.qk_rope_head_dim),
            "lengths": (LM_BATCH,)}
    got = {k: tuple(v.shape) for k, v in cache.items()}
    require(got == want, f"[lm] deepseek cache shapes {got} != {want}")
    logits, cache, dms, _, finite = _greedy(dparams, dcfg, logits, cache,
                                            LM_DEEP_STEPS)
    require(finite, "[lm] deepseek decode logits are not finite")
    require(cache["lengths"].tolist() == [dmax] * LM_BATCH, "[lm] lengths")
    deep = {"params": count_params(dparams),
            "param_bytes": tree_bytes(dparams), "init_s": dinit_s,
            "prefill_s": dprefill_s,
            "prefill_tokens_per_s": LM_BATCH * LM_DEEP_SEQ / dprefill_s,
            "decode_ms": dms, "decode_ms_mean": sum(dms) / len(dms),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    out["deepseek_cut"] = deep
    log(f"[lm] deepseek-v3-671b full width, depth cut to "
        f"{dcfg.n_dense_layers} dense + {dcfg.n_moe_layers} MoE layer "
        f"({dcfg.moe.n_experts} experts top-{dcfg.moe.top_k}, MLA latent "
        f"{m.kv_lora_rank}) + MTP, bf16: {deep['params']} params "
        f"({deep['param_bytes']} B, init {dinit_s:.2f} s); prefill "
        f"{LM_BATCH} x {LM_DEEP_SEQ} in {dprefill_s:.3f} s "
        f"({deep['prefill_tokens_per_s']:.0f} tokens/s); "
        f"{LM_DEEP_STEPS} decode steps mean {deep['decode_ms_mean']:.3f} "
        f"ms; max_memory_allocated {deep['peak_bytes']} B; {smi}")
    del dparams, cache, logits
    torch.cuda.empty_cache()
    RESULTS["lm"] = out
    return out


# ------------------------------------------------------------ phase 16
# The recsys and GNN models' serving path (plain torch, as the reference's
# plain jnp; the SASRec retrieval through the two-level index runs the
# probe chain's kernel, candidate_topk).  Tolerances, stated before the
# run: card against CPU in fp32 on the same weights (no TF32) to rtol /
# atol 1e-4, top ids equal except at near-ties (their two candidates
# rescored in float64 on the CPU within that tolerance); SchNet's bf16
# messages (the card's index_add_ atomics accumulate in bf16) to a
# relative L2 error of 2**-4 on the node states, the loss to rtol 1e-2.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_BF16_REL_L2 = 2 ** -4
MODEL_BF16_LOSS_TOL = dict(rtol=1e-2, atol=1e-2)
RECSYS_ARCHS = ("dlrm-mlperf", "dcn-v2", "din", "sasrec")
# DLRM's fp32 table (187,767,399 x 128) is 96.1 GB: the fp32 parity runs
# with each table's rows capped (widths unchanged); DCN-v2 too, so both
# CPU copies stay small.  Serving keeps every row: DLRM in bf16 (48.07 GB),
# the other three in fp32.
PARITY_TABLE_ROWS = 65_536
PARITY_ROWS = 512
PARITY_CANDIDATES = 4096
RETRIEVAL_K = 100
SERVE_DTYPES = {"dlrm-mlperf": torch.bfloat16}
SERVE_P99_CALLS = 100
SERVE_P99_BATCHES = 16          # distinct request batches, cycled
SERVE_BULK_CALLS = 3
RETRIEVAL_CALLS = 3
PROFILE_BATCHES = 8
# retrieval through the paper's index (examples/retrieval_recsys.py at
# full width): 64 users, 1,024 buckets, brute top and bottom
INDEX_USERS = 64
INDEX_CLUSTERS = 1024
INDEX_NPROBES = (16, 64, 256, 1024)
INDEX_FLOOR = 0.99
# SchNet at the gnn shapes, bf16 messages as _gnn_cell binds them
GNN_ITERS = 5
GNN_SEEDS = 1024
# radius_graph on the card: 16,384 points at the density of the reference
# test's (500 points, normal x 3, cutoff 1.5)
RADIUS_POINTS = 16_384
RADIUS_CUTOFF = 1.5
RADIUS_RECALL = 0.95


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _model_close(name: str, a, b, tol: dict = MODEL_TOL) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    require(bool(torch.allclose(a, b, **tol)),
            f"[models] {name}: max abs err {err} beyond {tol}")
    return err


def _rel_l2(name: str, a, b, bound: float) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = float((a - b).norm() / b.norm().clamp(min=1e-30))
    require(err <= bound, f"[models] {name}: relative L2 error {err} > "
            f"{bound}")
    return err


def _retrieval_parity(name, cfg, rb, card, cpu, cpu_params) -> dict:
    """Card (scores, ids) against CPU: scores to ``MODEL_TOL``; a slot whose
    ids differ is a near-tie when its two candidates' float64 scores (the
    CPU tree in float64) lie within the same tolerance."""
    (cs, ci), (ps, pi) = ((s.cpu(), i.cpu()) for s, i in (card, cpu))
    err = _model_close(f"{name} retrieval scores", cs, ps)
    diff = (ci != pi).nonzero().flatten().tolist()
    if diff:
        p64 = cast_tree(cpu_params, torch.float64)
        for j in diff:
            ids = np.array([int(ci[j]), int(pi[j])], np.int32)
            b2 = dict(rb, candidates=ids)
            if "cand_cates" in rb:
                b2["cand_cates"] = (ids % cfg.n_cates).astype(np.int32)
            s64, i64 = recsys.retrieval_logits(p64, b2, cfg, k=2)
            gap = float((s64[0] - s64[1]).abs())
            require(gap <= MODEL_TOL["atol"] + MODEL_TOL["rtol"]
                    * float(s64.abs().max()),
                    f"[models] {name}: ids {ids.tolist()} differ at slot "
                    f"{j}, float64 score gap {gap}")
    return {"max_abs_err": err, "near_ties": len(diff)}


def recsys_parity(dev, arch: str) -> dict:
    """``arch`` at full width in fp32 (DLRM / DCN-v2 tables capped at
    ``PARITY_TABLE_ROWS`` rows each), card against CPU on the same
    weights: ``serve_logits`` on ``PARITY_ROWS`` rows, ``loss_fn`` and
    ``retrieval_logits`` over ``PARITY_CANDIDATES`` candidates."""
    cfg = get_arch(arch)[0]
    if hasattr(cfg, "table_sizes"):
        cfg = dataclasses.replace(cfg, table_sizes=tuple(
            min(s, PARITY_TABLE_ROWS) for s in cfg.table_sizes))
    params = recsys.init(cfg, seed=0, device=dev)
    cpu = tree_map(lambda t: t.cpu(), params)
    batch = batch_for(cfg, PARITY_ROWS, 0)
    serve = serve_batch(cfg, batch)
    rb = retrieval_batch(cfg, batch, PARITY_CANDIDATES)
    out = {}
    for side, p in (("card", params), ("cpu", cpu)):
        loss, aux = recsys.loss_fn(p, batch, cfg)
        out[side] = (recsys.serve_logits(p, serve, cfg), loss, aux,
                     recsys.retrieval_logits(p, rb, cfg, k=RETRIEVAL_K))
    (sc, lc, ac, rc), (sp, lp, ap, rp) = out["card"], out["cpu"]
    require(tuple(sc.shape) == (PARITY_ROWS,) and bool(
        torch.isfinite(sc).all()), f"[models] {arch} serve logits")
    errs = {"serve": _model_close(f"{arch} serve", sc, sp),
            "loss": _model_close(f"{arch} loss", lc, lp)}
    for k in ap:
        errs[f"aux_{k}"] = _model_close(f"{arch} aux {k}", ac[k], ap[k])
    errs["retrieval"] = _retrieval_parity(arch, cfg, rb, rc, rp, cpu)
    errs["params"] = count_params(params)
    del params, cpu
    torch.cuda.empty_cache()
    return errs


def _events_ms(fn, calls: int, warmup: int = 1) -> list:
    """CUDA-event ms of each of ``calls`` calls of ``fn(i)``."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    ms = []
    for i in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return ms


def _pct(ms: list, q: float) -> float:
    s = sorted(ms)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def recsys_serve(dev, arch: str, smi: str, keep: bool = False) -> dict:
    """``arch`` at full width served at the registry's three shapes:
    ``serve_p99`` (p50 / p99 over ``SERVE_P99_CALLS`` calls),
    ``serve_bulk`` (rows/s) and ``retrieval_cand`` (ms a call over 1M
    candidates, k 100); parameter bytes and ``max_memory_allocated``.
    DLRM serves in bf16 (its fp32 table does not fit), the others in fp32.
    Returns the results (and the parameters when ``keep``)."""
    cfg = get_arch(arch)[0]
    dtype = SERVE_DTYPES.get(arch, torch.float32)
    p99 = get_shape("recsys", "serve_p99")["batch"]
    bulk = get_shape("recsys", "serve_bulk")["batch"]
    n_cand = get_shape("recsys", "retrieval_cand")["n_candidates"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = recsys.init(cfg, seed=0, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_bytes = tree_bytes(params)
    small = [serve_batch(cfg, batch_for(cfg, p99, s))
             for s in range(SERVE_P99_BATCHES)]
    ms_p99 = _events_ms(lambda i: recsys.serve_logits(
        params, small[i % len(small)], cfg), SERVE_P99_CALLS)
    t0 = time.perf_counter()
    batch = batch_for(cfg, bulk, 1)
    big, rb = serve_batch(cfg, batch), retrieval_batch(cfg, batch, n_cand)
    data_s = time.perf_counter() - t0
    logits = recsys.serve_logits(params, big, cfg)
    require(tuple(logits.shape) == (bulk,) and bool(
        torch.isfinite(logits).all()), f"[models] {arch} bulk logits")
    ms_bulk = _events_ms(lambda i: recsys.serve_logits(params, big, cfg),
                         SERVE_BULK_CALLS)
    top, ids = recsys.retrieval_logits(params, rb, cfg, k=RETRIEVAL_K)
    require(bool(torch.isfinite(top).all()) and bool((top[:-1] >= top[1:])
                                                     .all()),
            f"[models] {arch} retrieval scores not finite and descending")
    require(len(set(ids.tolist())) == RETRIEVAL_K and int(ids.min()) >= 0
            and int(ids.max()) < n_cand, f"[models] {arch} retrieval ids")
    ms_ret = _events_ms(lambda i: recsys.retrieval_logits(
        params, rb, cfg, k=RETRIEVAL_K), RETRIEVAL_CALLS)
    out = {"dtype": str(dtype).split(".")[-1], "params": count_params(params),
           "param_bytes": p_bytes, "init_s": init_s,
           "serve_p99": {"batch": p99, "calls": len(ms_p99),
                         "p50_ms": _pct(ms_p99, 0.5),
                         "p99_ms": _pct(ms_p99, 0.99),
                         "mean_ms": sum(ms_p99) / len(ms_p99)},
           "serve_bulk": {"batch": bulk, "ms": ms_bulk,
                          "rows_per_s": bulk * 1e3 / (sum(ms_bulk)
                                                      / len(ms_bulk)),
                          "host_batch_s": data_s},
           "retrieval_cand": {"candidates": n_cand, "k": RETRIEVAL_K,
                              "ms": ms_ret,
                              "ms_mean": sum(ms_ret) / len(ms_ret)},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if arch == "dlrm-mlperf":
        out["profile_serve_p99"] = profile_window(
            "models dlrm serve_p99", f"dlrm-mlperf bf16 B {p99}",
            lambda: [recsys.serve_logits(params, small[i], cfg)
                     for i in range(PROFILE_BATCHES)], PROFILE_BATCHES, p99)
    if arch == "din":
        out["profile_retrieval_cand"] = profile_window(
            "models din retrieval_cand", f"din fp32 1 x {n_cand}",
            lambda: recsys.retrieval_logits(params, rb, cfg,
                                            k=RETRIEVAL_K), 1, 1)
    for key in ("profile_serve_p99", "profile_retrieval_cand"):
        if key in out:
            pr = out[key]
            pr["launches_per_call"] = pr["launched"] / pr["batches"]
            log(f"[models] {arch} {key[8:]}: device busy "
                f"{pr['device_busy_share']:.3f}, "
                f"{pr['launches_per_call']:.1f} launches a call")
    s, b, r = out["serve_p99"], out["serve_bulk"], out["retrieval_cand"]
    log(f"[models] {arch} {out['dtype']} full width: serve_p99 B {p99} p50 "
        f"{s['p50_ms']:.3f} ms p99 {s['p99_ms']:.3f} ms ({len(ms_p99)} "
        f"calls, CUDA events); serve_bulk B {bulk} "
        f"{b['rows_per_s']:.0f} rows/s ({min(ms_bulk):.1f}-"
        f"{max(ms_bulk):.1f} ms a call); retrieval_cand 1 x {n_cand} k "
        f"{RETRIEVAL_K} {r['ms_mean']:.2f} ms a call; {out['params']} "
        f"params {p_bytes} B (init {init_s:.2f} s); max_memory_allocated "
        f"{out['peak_bytes']} B; {smi}")
    if keep:
        return out, params
    del params, small, big, batch
    torch.cuda.empty_cache()
    return out, None


def sasrec_index(dev, params, smi: str) -> dict:
    """SASRec at full size through the paper's index: ``INDEX_USERS``
    users' vectors, the exact ``retrieval_logits`` top-10 over all items as
    the truth, the items MIPS-augmented (d 51) into ``build_two_level``
    (brute top and bottom), searched at ``INDEX_NPROBES`` and at full
    probing.  Launch counts are reset just before the searches and read
    just after: ``candidate_topk`` > 0.  After that window each search's
    own answer (the probe chain's kernel) is held against the plain chain
    on the same probe lists (``compare``, each id's distance recomputed in
    float64), and the full-probing answer must equal the exact top-10
    (``testing.mips_parity``)."""
    cfg = get_arch("sasrec")[0]
    seq = batch_for(cfg, INDEX_USERS, 7)["seq"]
    t0 = time.perf_counter()
    users, exact, items = sasrec_mips_truth(params, seq, cfg, K)
    exact_s = time.perf_counter() - t0
    aug_items, aug_users, m2 = recsys.mips_augment(items, users)
    require(aug_items.shape == (cfg.n_items, cfg.embed_dim + 1),
            f"[models] augmented items {aug_items.shape}")
    icfg = TwoLevelConfig(n_clusters=INDEX_CLUSTERS, top="brute",
                          bottom="brute", kmeans_iters=8,
                          kmeans_minibatch=50_000)
    t0 = time.perf_counter()
    index = build_two_level(aug_items, icfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = {"users": INDEX_USERS, "d": int(aug_items.shape[1]),
           "clusters": INDEX_CLUSTERS,
           "cap": int(index.bucket_ids.shape[1]), "build_s": build_s,
           "exact_s": exact_s, "nprobe": {}}
    runs = {}
    reset_launches()
    for nprobe in sorted(set(INDEX_NPROBES) | {INDEX_CLUSTERS}):
        index.search(aug_users[:8], K, nprobe=nprobe)        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, ann, work = index.search(aug_users, K, nprobe=nprobe)
        runs[nprobe] = (dist, ann, work, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = read_launches()
    out["launches"] = launches
    require(launches["candidate_topk"] > 0,
            f"[models] the index search launched no candidate_topk: "
            f"{launches}")
    RESULTS["kernels"]["candidate_topk"]["models_launches"] = \
        launches["candidate_topk"]
    t = index._tables(dev)
    q = torch.as_tensor(aug_users, device=dev)
    xh = aug_items
    scale = (_norms(q).cpu().numpy() + float(_norms(t["db"]).max()))[
        :, None] * np.ones((1, K))
    for nprobe, (dist, ann, work, ms) in runs.items():
        probe, _ = index._top_probe(t, q, nprobe)
        t0 = time.perf_counter()
        pd, pi = ref.bucket_probe_topk_ref(q, probe, t["bucket_ids"], K,
                                           db=t["db"])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        chain = compare(f"models sasrec chain nprobe {nprobe}",
                        torch.from_numpy(dist), torch.from_numpy(ann), pd,
                        pi, scale, vec_of=lambda b, i: xh[i], q=q)
        row = {"recall_at_10": recall_at_k(ann, exact), "ms": ms,
               "plain_ms": plain_ms,
               "candidates_per_query": work["candidates"] / INDEX_USERS,
               "chain_vs_plain": chain}
        out["nprobe"][nprobe] = row
        log(f"[models] sasrec index nprobe {nprobe}: recall@10 "
            f"{row['recall_at_10']:.4f}, {ms:.2f} ms a batch of "
            f"{INDEX_USERS} (host clock; the plain chain {plain_ms:.2f} "
            f"ms), {row['candidates_per_query']:.0f} candidates a query; "
            f"chain vs plain max abs err {chain['max_abs_err']:.3e}, ids "
            f"match {chain['ids_match']:.4f}")
    par = mips_parity(runs[INDEX_CLUSTERS][1], exact, users, items, m2)
    out["full_probe"] = par
    require(par["match"] >= INDEX_FLOOR and par["bad"] == 0
            and par["repeats"] == 0,
            f"[models] full probing is not the exact MIPS top-10: {par}")
    log(f"[models] sasrec index: {cfg.n_items} items at d {out['d']} "
        f"(MIPS-augmented),"
        f" {INDEX_CLUSTERS} buckets of cap {out['cap']}, build "
        f"{build_s:.2f} s; exact top-10 of {INDEX_USERS} users by "
        f"retrieval_logits {exact_s:.2f} s; full probing vs exact: {par}; "
        f"launches {launches}; {smi}")
    return out


def _gnn_batch_full_graph(shape, seed: int = 0) -> tuple:
    """The ``full_graph_sm`` shape: ``make_graph`` at its node count and
    width (it gives more edges than asked: every node keeps one), a
    seeded choice of the shape's edge count, padded to the cell's."""
    d = shape.dims
    t0 = time.perf_counter()
    g = make_graph(d["n_nodes"], d["n_edges"], d["d_feat"], seed=seed)
    snd, rcv = g.edge_list()
    keep = np.sort(np.random.default_rng(seed).choice(
        snd.size, size=min(d["n_edges"], snd.size), replace=False))
    batch = pad_edges({"feats": g.feats, "pos": g.pos,
                       "senders": snd[keep], "receivers": rcv[keep],
                       "labels": g.labels}, d["n_nodes"],
                      _pad_to(d["n_edges"], 256))
    return batch, {"graph_edges": g.n_edges, "kept": int(keep.size),
                   "host_s": time.perf_counter() - t0}


def _gnn_batch_minibatch(shape, seed: int = 0) -> tuple:
    """``minibatch_lg``: the whole graph (232,965 nodes, 114,615,892
    edges, d 602), ``NeighborSampler`` fanout (15, 10) over 1,024 seeds,
    padded to the cell's 169,984 nodes and 168,960 edges; returns the
    padded batch, the host times and the unpadded sample."""
    d = shape.dims
    t0 = time.perf_counter()
    g = make_graph(d["n_nodes"], d["n_edges"], d["d_feat"], seed=seed)
    graph_s = time.perf_counter() - t0
    bn = d["batch_nodes"]
    f1, f2 = d["fanout"]
    seeds = np.random.default_rng(seed).choice(g.n_nodes, size=bn,
                                               replace=False)
    t0 = time.perf_counter()
    sub = NeighborSampler(g, d["fanout"], seed=seed).sample(seeds)
    batch = pad_edges(sub, _pad_to(bn * (1 + f1) + bn * f1 * f2, 256),
                      _pad_to(bn * f1 + bn * f1 * f2, 256))
    info = {"graph_edges": g.n_edges, "graph_s": graph_s,
            "sample_s": time.perf_counter() - t0,
            "sampled_nodes": int(sub["feats"].shape[0]),
            "sampled_edges": int(sub["senders"].size)}
    del g
    keys = ("feats", "pos", "senders", "receivers", "labels")
    return ({k: batch[k] for k in keys + ("node_mask",)}, info,
            {k: sub[k] for k in keys})


def _gnn_cfg(shape, message_dtype: str):
    """``_gnn_cell``'s binding: the shape's width, 16 classes (1 energy
    output for a batch of molecules), the message dtype."""
    return dataclasses.replace(
        get_arch("schnet")[0], d_feat=shape.dims["d_feat"],
        n_out=16 if "batch" not in shape.dims else 1,
        message_dtype=message_dtype)


def _molecule(shape, step: int = 0) -> dict:
    d = shape.dims
    return molecule_batch(d["batch"], d["n_nodes"], d["n_edges"],
                          d["d_feat"], step=step)


def schnet_parity(dev) -> dict:
    """SchNet at full width on ``full_graph_sm`` and ``molecule``, card
    against CPU on the same weights, fp32 and bf16 messages: ``forward``
    and ``loss_fn``.  The bf16 bound holds rounding noise and cannot tell
    the dtype (card fp32 messages against CPU bf16 ones, read beside it,
    land as close), so each interaction's message sum on the card must be
    taken in the message dtype (``testing.message_dtypes``)."""
    out = {}
    for name in ("full_graph_sm", "molecule"):
        shape = get_shape("gnn", name)
        batch = (_gnn_batch_full_graph(shape)[0] if name == "full_graph_sm"
                 else _molecule(shape))
        states = {}
        for mdt in ("float32", "bfloat16"):
            cfg = _gnn_cfg(shape, mdt)
            params = schnet.init(cfg, seed=0, device=dev)
            cpu = tree_map(lambda t: t.cpu(), params)
            with message_dtypes() as sums:
                hc = schnet.forward(params, batch, cfg)
            hp = schnet.forward(cpu, batch, cfg)
            lc = schnet.loss_fn(params, batch, cfg)[0]
            lp = schnet.loss_fn(cpu, batch, cfg)[0]
            tag = f"schnet {name} {mdt}"
            require(hc.dtype == torch.float32 and bool(
                torch.isfinite(hc).all()), f"[models] {tag}")
            want = [getattr(torch, mdt)] * cfg.n_interactions
            require(sums == want, f"[models] {tag}: message sums taken in "
                    f"{sums}, not {want}")
            states[mdt] = (hc, hp)
            if mdt == "float32":
                errs = {"h": _model_close(f"{tag} forward", hc, hp),
                        "loss": _model_close(f"{tag} loss", lc, lp)}
            else:
                errs = {"h_rel_l2": _rel_l2(f"{tag} forward", hc, hp,
                                            MODEL_BF16_REL_L2),
                        "loss": _model_close(f"{tag} loss", lc, lp,
                                             MODEL_BF16_LOSS_TOL)}
                # the reading beside it: card fp32 messages against the
                # CPU's bf16 ones
                fc, bp = states["float32"][0].cpu(), hp.cpu()
                errs["h_rel_l2_fp32_vs_bf16"] = float(
                    (fc - bp).norm() / bp.norm())
            errs["loss_value"] = float(lp)
            errs["loss_rel"] = float((lc.cpu() - lp).abs() / lp.abs())
            out[f"{name}_{mdt}"] = errs
        del states
    return out


def schnet_shapes(dev, smi: str) -> dict:
    """SchNet at the gnn shapes with bf16 messages: ``forward`` and
    ``loss_fn`` ms (CUDA events) and ``max_memory_allocated`` on
    ``full_graph_sm``, ``minibatch_lg`` and ``molecule``."""
    out = {}
    for name in ("full_graph_sm", "minibatch_lg", "molecule"):
        shape = get_shape("gnn", name)
        raw = None
        if name == "full_graph_sm":
            batch, info = _gnn_batch_full_graph(shape)
        elif name == "minibatch_lg":
            batch, info, raw = _gnn_batch_minibatch(shape)
        else:
            t0 = time.perf_counter()
            batch = _molecule(shape)
            info = {"host_s": time.perf_counter() - t0}
        cfg = _gnn_cfg(shape, "bfloat16")
        params = schnet.init(cfg, seed=0, device=dev)
        # the batch on the card once, as a training step's input would be
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd = _events_ms(lambda i: schnet.forward(params, tb, cfg),
                         GNN_ITERS)
        loss_ms = _events_ms(lambda i: schnet.loss_fn(params, tb, cfg),
                             GNN_ITERS)
        loss, aux = schnet.loss_fn(params, tb, cfg)
        require(bool(torch.isfinite(loss)), f"[models] schnet {name} loss")
        row = {"nodes": int(batch["feats"].shape[0]),
               "edges": int(batch["senders"].shape[0]),
               "d_feat": cfg.d_feat, "n_out": cfg.n_out,
               "forward_ms": sum(fwd) / len(fwd),
               "loss_ms": sum(loss_ms) / len(loss_ms),
               "loss": float(loss),
               "peak_bytes": torch.cuda.max_memory_allocated(), **info}
        if raw is not None:
            # every pad edge adds its zero message into node 0: the
            # unpadded sample's forward reads the work without that
            # contention
            tr = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
            unp = _events_ms(lambda i: schnet.forward(params, tr, cfg),
                             GNN_ITERS)
            row["forward_unpadded_ms"] = sum(unp) / len(unp)
            log(f"[models] schnet {name} bf16 messages, the sample "
                f"unpadded ({row['sampled_nodes']} nodes, "
                f"{row['sampled_edges']} edges): forward "
                f"{row['forward_unpadded_ms']:.3f} ms (CUDA events, mean of "
                f"{GNN_ITERS}); {smi}")
            del tr
        out[name] = row
        log(f"[models] schnet {name} bf16 messages: {row['nodes']} nodes, "
            f"{row['edges']} edges (padded), d_feat {cfg.d_feat}: forward "
            f"{row['forward_ms']:.3f} ms, forward + loss_fn "
            f"{row['loss_ms']:.3f} ms (CUDA events, mean of {GNN_ITERS}); "
            f"max_memory_allocated {row['peak_bytes']} B; host "
            f"{ {k: v for k, v in info.items()} }; {smi}")
        del params, tb, batch
        torch.cuda.empty_cache()
    return out


def radius_on_card(dev, smi: str) -> dict:
    """``radius_graph`` over ``RADIUS_POINTS`` points: ``method="auto"``
    (two-level above 4,096 points: k-means and the bucket probe on the
    card) against ``method="brute"`` (host numpy) on the same points; edge
    recall at least the reference test's 0.95."""
    scale = 3.0 * (RADIUS_POINTS / 500) ** (1 / 3)
    pos = (np.random.default_rng(9).normal(size=(RADIUS_POINTS, 3))
           * scale).astype(np.float32)
    t0 = time.perf_counter()
    s2, d2 = radius_graph(pos, RADIUS_CUTOFF, method="auto", device=dev)
    auto_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, d1 = radius_graph(pos, RADIUS_CUTOFF, method="brute")
    brute_s = time.perf_counter() - t0
    e1 = set(zip(s1.tolist(), d1.tolist()))
    e2 = set(zip(s2.tolist(), d2.tolist()))
    recall = len(e2 & e1) / max(len(e1), 1)
    out = {"points": RADIUS_POINTS, "cutoff": RADIUS_CUTOFF,
           "brute_edges": len(e1), "auto_edges": len(e2),
           "false_edges": len(e2 - e1), "recall": recall,
           "auto_s": auto_s, "brute_s": brute_s}
    require(recall >= RADIUS_RECALL and not out["false_edges"],
            f"[models] radius_graph two-level vs brute: {out}")
    log(f"[models] radius_graph {RADIUS_POINTS} points (normal x "
        f"{scale:.2f}, cutoff {RADIUS_CUTOFF}): auto (two-level, "
        f"{max(8, RADIUS_POINTS // 128)} buckets, nprobe 8, on the card) "
        f"{auto_s:.2f} s, {len(e2)} edges; brute (host numpy) "
        f"{brute_s:.2f} s, {len(e1)} edges; edge recall {recall:.4f} "
        f"(bar {RADIUS_RECALL}); {smi}")
    return out


def phase_models(dev, card) -> dict:
    """The recsys and GNN models at full width: card-against-CPU parity,
    the four recsys archs at the registry's serving shapes (profiles of
    DLRM ``serve_p99`` and DIN ``retrieval_cand``), SASRec's candidates
    through the two-level index, SchNet at the gnn shapes, and
    ``radius_graph`` on the card."""
    smi = card["nvidia_smi"]
    require_fp32_matmul()
    out = {"card": smi, "parity": {}}
    for arch in RECSYS_ARCHS:
        errs = recsys_parity(dev, arch)
        out["parity"][arch] = errs
        log(f"[models] {arch} full width fp32"
            f"{' (tables capped at %d rows)' % PARITY_TABLE_ROWS if arch in ('dlrm-mlperf', 'dcn-v2') else ''}"
            f", card vs CPU: max abs err serve {errs['serve']:.3e} "
            f"({PARITY_ROWS} rows), loss {errs['loss']:.3e}, retrieval "
            f"{PARITY_CANDIDATES} candidates k {RETRIEVAL_K} "
            f"{errs['retrieval']} (tol {MODEL_TOL}); {errs['params']} "
            f"params")
    out["parity"]["schnet"] = schnet_parity(dev)
    log(f"[models] schnet full width (3 interactions, d_hidden 64, 300 "
        f"RBFs) card vs CPU: {out['parity']['schnet']} (fp32 tol "
        f"{MODEL_TOL}; bf16 relative L2 <= {MODEL_BF16_REL_L2}, loss "
        f"{MODEL_BF16_LOSS_TOL})")
    out["serve"] = {}
    sparams = None
    for arch in RECSYS_ARCHS:
        res, kept = recsys_serve(dev, arch, smi, keep=arch == "sasrec")
        out["serve"][arch] = res
        sparams = kept if kept is not None else sparams
    out["index"] = sasrec_index(dev, sparams, smi)
    del sparams
    torch.cuda.empty_cache()
    out["gnn"] = schnet_shapes(dev, smi)
    out["radius"] = radius_on_card(dev, smi)
    RESULTS["models"] = out
    return out


# ------------------------------------------------------------ phase 17
# Training (plain torch, as the reference's training path: its
# jax.value_and_grad runs over loss_fns that reach no Pallas kernel).
# Tolerances, stated before the run: card against CPU at the fp32 policy
# (no TF32) on the same weights, every gradient leaf, and after one AdamW
# step every param, m and v, to rtol 1e-4 and an atol of 1e-4 of the
# leaf's max abs; the CTR sparse step (fp32), each leaf against the step in
# float64, the card's error within twice the CPU's fp32 error plus rtol /
# atol 1e-5 of the leaf's max (DLRM's fp32 gradient at init is itself off
# by up to 3.4e-3 of a leaf's max: its deep ReLU MLPs cancel); the
# restart bit for bit.
TRAIN_TOL = dict(rtol=1e-4, atol_of_max=1e-4)
SPARSE_TOL = dict(rtol=1e-5, atol_of_max=1e-5)
# the registry's train_4k (seq 4,096, batch 256) with the batch cut to 8,
# four microbatches of 2 through accum (the run's time limit forces it)
TRAIN_LM_SHAPE = "train_4k"
TRAIN_MICRO = 2
TRAIN_ACCUM = 4
# one warm-up and three timed steps (cut from 2 + 4 to keep the smoke
# within its time)
TRAIN_WARM = 1
TRAIN_STEPS = 3
# the restart: qwen3-0.6b at full width, depth cut to 2, seq 512, KV
# blocks of 128 (four: the chunked backward runs)
RESTART_DEPTH = 2
RESTART_SEQ = 512
RESTART_CHUNK = 128
RESTART_STEPS = 4
RESTART_AT = 2
# the CTR sparse step at the registry's train_batch; its card-vs-CPU
# check on tables capped at PARITY_TABLE_ROWS rows (widths kept) and
# SPARSE_PARITY_ROWS rows of batch
SPARSE_STEPS = 3
SPARSE_PARITY_ROWS = 4096
TRAIN_DTYPES = {"dlrm-mlperf": torch.bfloat16}    # the table's
DENSE_STEPS = 3
TRAIN_LIMIT_S = 200.0           # this phase's share of the command's time


def _leaf_err(name, a_tree, b_tree, rtol, atol_of_max) -> float:
    """Every leaf of ``a_tree`` (card) against ``b_tree`` (CPU): the worst
    |a - b| over the leaf's max abs; fails beyond the tolerance."""
    b = dict(ckpt.leaf_paths(b_tree))
    worst = 0.0
    for path, x in ckpt.leaf_paths(a_tree):
        x = x.detach().float().cpu()
        y = b[path].detach().float().cpu()
        m = float(y.abs().max()) if y.numel() else 0.0
        err = float((x - y).abs().max()) if y.numel() else 0.0
        ok = bool(torch.allclose(x, y, rtol=rtol, atol=atol_of_max * m))
        require(ok, f"[train] {name} {path}: max abs err {err} beyond "
                f"rtol {rtol} + {atol_of_max} x max {m}")
        worst = max(worst, err / max(m, 1e-30))
    return worst


def _lm_train_cfg(cfg, seq: int):
    """``lm_config_for_mesh`` for a train shape on one card
    (``launch/cells.py``): KV blocks of min(1024, seq / 4) from seq 4,096,
    the residual sequence-sharded (a no-op without a mesh), remat on."""
    return dataclasses.replace(
        cfg, moe_groups=1, attn_chunk=min(1024, seq // 4) if seq >= 4096
        else 0, attn_shard="seq", scan_layers=True, remat=True)


def _lm_optimizer(cfg):
    """``_lm_optimizer``: AdamW for fp32 params, Adafactor for bf16."""
    if cfg.param_dtype == "bfloat16":
        return optim.adafactor(optim.warmup_cosine(1e-4, 2000, 100_000))
    return optim.adamw(optim.warmup_cosine(3e-4, 2000, 100_000))


def _step_ms(step, state, batch_at, n: int, start: int = 0):
    """``n`` steps from ``state``: each one's wall ms (ending in a
    synchronise), its aux as floats, and the state after them."""
    ms, auxs = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, batch_at(start + i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        auxs.append({k: float(v) for k, v in aux.items()})
    return ms, auxs, state


def train_qwen(dev, smi: str) -> dict:
    """qwen3-0.6b at full width and depth, bound as the reference's
    ``train_4k`` cell, seq 4,096, batch 8 as 4 microbatches of 2."""
    shape = get_shape("lm", TRAIN_LM_SHAPE)
    seq = shape["seq"]
    cfg = _lm_train_cfg(get_arch("qwen3-0.6b")[0], seq)
    require((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.attn_chunk,
             cfg.remat, cfg.param_dtype) == (28, 1024, 151936, 1024, True,
                                             "float32"), "train config")
    batch = TRAIN_MICRO * TRAIN_ACCUM
    stream = LMStream(cfg.vocab, seq, batch, seed=0)

    def batch_at(i):
        b = stream.batch_at(i)
        return {k: torch.as_tensor(v.reshape(TRAIN_ACCUM, TRAIN_MICRO, seq),
                                   device=dev) for k, v in b.items()}

    torch.cuda.reset_peak_memory_stats()
    params = transformer.init(cfg, seed=0, device=dev)
    opt = _lm_optimizer(cfg)
    step = make_train_step(lambda p, b: transformer.loss_fn(p, b, cfg), opt,
                           accum=TRAIN_ACCUM)
    state = init_state(params, opt)
    del params
    warm_ms, warm_aux, state = _step_ms(step, state, batch_at, TRAIN_WARM)
    torch.cuda.reset_peak_memory_stats()
    ms, auxs, state = _step_ms(step, state, batch_at, TRAIN_STEPS,
                               start=TRAIN_WARM)
    peak = torch.cuda.max_memory_allocated()
    for a in warm_aux + auxs:
        require(all(np.isfinite(a[k]) for k in ("loss", "grad_norm")),
                f"[train] qwen3-0.6b loss / grad_norm not finite: {a}")
    require(int(state.step) == TRAIN_WARM + TRAIN_STEPS, "[train] step")
    tokens = batch * seq
    mean = sum(ms) / len(ms)
    # where a step's time goes: one step of one microbatch (the four of a
    # step run the same kernels; a window of all four traces 88K launches
    # and takes a minute to read back)
    one = make_train_step(lambda p, b: transformer.loss_fn(p, b, cfg), opt)
    nxt = {k: v[0] for k, v in batch_at(TRAIN_WARM + TRAIN_STEPS).items()}
    one(state, nxt)
    prof = profile_window(
        "train qwen3 step", f"qwen3-0.6b, one microbatch {TRAIN_MICRO} x "
        f"{seq}, remat, KV blocks {cfg.attn_chunk}",
        lambda: one(state, nxt), 1, TRAIN_MICRO * seq)
    out = {"seq": seq, "batch": batch, "micro": TRAIN_MICRO,
           "accum": TRAIN_ACCUM, "attn_chunk": cfg.attn_chunk,
           "params": count_params(state.params),
           "warm_ms": warm_ms, "step_ms": ms, "step_ms_mean": mean,
           "tokens_per_s": tokens / (mean / 1e3),
           "loss": [a["loss"] for a in warm_aux + auxs],
           "grad_norm": [a["grad_norm"] for a in warm_aux + auxs],
           "peak_bytes": peak, "state_bytes": tree_bytes(state.params)
           + tree_bytes(state.opt_state), "profile": prof, "card": smi}
    log(f"[train] qwen3-0.6b full width and depth ({out['params']} params, "
        f"fp32 params, bf16 compute, AdamW warmup_cosine(3e-4, 2000, "
        f"100000)), {TRAIN_LM_SHAPE} with the batch cut 256 -> {batch} "
        f"({TRAIN_ACCUM} microbatches of {TRAIN_MICRO} through accum), seq "
        f"{seq}, remat, KV blocks {cfg.attn_chunk}: {TRAIN_STEPS} steps "
        f"after {TRAIN_WARM} warm-up: mean {mean:.1f} ms a step "
        f"(each {[round(x, 1) for x in ms]}; warm-up "
        f"{[round(x, 1) for x in warm_ms]}), {out['tokens_per_s']:.0f} "
        f"tokens/s; loss {[round(x, 4) for x in out['loss']]}, grad_norm "
        f"{[round(x, 4) for x in out['grad_norm']]}; max_memory_allocated "
        f"{peak} B (params + AdamW state {out['state_bytes']} B); {smi}")
    del state, step, one, nxt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_qwen_parity(dev) -> dict:
    """qwen3-0.6b (full width, depth and vocabulary) at the fp32 policy on
    the ``lm`` phase's parity inputs (B 2 x 16 tokens): ``loss_fn``'s
    gradient card against CPU, then the train step's rest on each side's
    gradient, ``clip_by_norm`` and one AdamW update (constant lr 3e-4, so
    the step moves the params; the cell's warm-up gives 0 at step 0)."""
    cfg = get_arch("qwen3-0.6b")[0]
    toks = LMStream(cfg.vocab, LM_PARITY_SEQ + 1, LM_BATCH,
                    seed=0).batch_at(0)["tokens"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = transformer.init(cfg, seed=0, device=dev)
    cpu = tree_map(lambda t: t.to("cpu", copy=True), params)
    opt = optim.adamw(optim.constant_lr(3e-4))
    out = {}
    transformer.set_precision(torch.float32, torch.float32)
    try:
        (lc, _), gc_ = value_and_grad(
            lambda p, b: transformer.loss_fn(p, b, cfg), params, batch)
        t0 = time.perf_counter()
        (lp, _), gp = value_and_grad(
            lambda p, b: transformer.loss_fn(p, b, cfg), cpu, batch)
        out["cpu_grad_s"] = time.perf_counter() - t0
        out["loss"] = _lm_close("train qwen3-0.6b loss", lc, lp,
                                LM_PARITY_TOL)
        out["grad"] = _leaf_err("qwen3-0.6b gradient", gc_, gp, **TRAIN_TOL)
    finally:
        transformer.set_precision()
    # the rest of the train step on those gradients: clip, then AdamW
    stepped = {}
    for side, p, g in (("card", params, gc_), ("cpu", cpu, gp)):
        t0 = time.perf_counter()
        g, norm = optim.clip_by_norm(g, 1.0)
        state = init_state(p, opt)
        stepped[side] = (opt.update(g, state.opt_state, p, state.step),
                         norm)
        out[f"{side}_update_s"] = time.perf_counter() - t0
    del gc_, gp
    ((pc, sc), nc), ((pp, sp), np_) = stepped["card"], stepped["cpu"]
    out["grad_norm"] = _lm_close("train qwen3-0.6b grad_norm", nc, np_,
                                 LM_PARITY_TOL)
    out["params"] = _leaf_err("qwen3-0.6b AdamW step params", pc, pp,
                              **TRAIN_TOL)
    out["opt_state"] = _leaf_err("qwen3-0.6b AdamW step m / v", sc, sp,
                                 **TRAIN_TOL)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves_sorted(pp), tree_leaves_sorted(cpu)))
    require(moved > 0, "[train] the AdamW step moved no param")
    out["moved"] = moved
    del params, cpu, stepped, pc, sc, pp, sp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_restart(dev) -> dict:
    """qwen3-0.6b at full width, depth cut to 2, seq 512 (KV blocks of
    128), the cell's binding otherwise: 4 steps with a checkpoint at 2,
    then step 2 restored and replayed; every param and the optimizer
    state equal the uninterrupted run's bit for bit."""
    cfg = dataclasses.replace(_lm_train_cfg(get_arch("qwen3-0.6b")[0],
                                            RESTART_SEQ),
                              n_layers=RESTART_DEPTH,
                              attn_chunk=RESTART_CHUNK)
    stream = LMStream(cfg.vocab, RESTART_SEQ, LM_BATCH, seed=3)
    opt = _lm_optimizer(cfg)
    step = make_train_step(lambda p, b: transformer.loss_fn(p, b, cfg), opt)

    def fresh():
        return init_state(transformer.init(cfg, seed=0, device=dev), opt)

    d = os.path.join(OUT_DIR, "train_restart")
    shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        full = train(fresh(), step, stream.batch_at, RESTART_STEPS,
                     ckpt_dir=d, ckpt_every=RESTART_AT, ckpt_async=False)
        full_s = time.perf_counter() - t0
        require(ckpt.latest_step(d) == RESTART_STEPS, "[train] ckpt")
        t0 = time.perf_counter()
        resumed = ckpt.restore(d, RESTART_AT, fresh())
        again = train(resumed, step, stream.batch_at, RESTART_STEPS)
        again_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    diff = [n for (n, a), (_, b) in zip(
        ckpt.leaf_paths(full.state), ckpt.leaf_paths(again.state))
        if not torch.equal(a, b)]
    require(not diff, f"[train] restart on the card differs in {diff}")
    out = {"leaves": len(ckpt.leaf_paths(full.state)),
           "params": count_params(full.state.params), "full_s": full_s,
           "restored_s": again_s,
           "losses": [h["loss"] for h in full.history]}
    del full, again, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ctr_cfg(arch: str, rows=None):
    cfg = get_arch(arch)[0]
    if rows is not None:
        cfg = dataclasses.replace(cfg, table_sizes=tuple(
            min(s, rows) for s in cfg.table_sizes))
    return cfg


def _recsys_opt():
    """``_recsys_train_cell``'s optimizer (the dense params of the sparse
    step; the whole tree for DIN and SASRec)."""
    return optim.adamw(optim.warmup_cosine(1e-3, 1000, 100_000))


def _truth_err(name, card, cpu, truth) -> dict:
    """Each leaf's worst error against the float64 ``truth``, card and
    CPU, over the leaf's max abs; the card's may be at most twice the
    CPU's plus ``SPARSE_TOL`` (the fp32 card as accurate as the fp32
    CPU)."""
    want = dict(ckpt.leaf_paths(truth))
    mine = dict(ckpt.leaf_paths(cpu))
    worst = {"card": 0.0, "cpu": 0.0, "card_vs_cpu": 0.0}
    for path, x in ckpt.leaf_paths(card):
        t = want[path].detach().double().cpu()
        m = float(t.abs().max()) if t.numel() else 0.0
        if not m:
            continue
        x = x.detach().double().cpu()
        y = mine[path].detach().double()
        ec = float((x - t).abs().max())
        ep = float((y - t).abs().max())
        worst["card_vs_cpu"] = max(worst["card_vs_cpu"],
                                   float((x - y).abs().max()) / m)
        bound = 2 * ep + SPARSE_TOL["rtol"] * float(t.abs().max()) \
            + SPARSE_TOL["atol_of_max"] * m
        require(ec <= bound, f"[train] {name} {path}: card err {ec} against "
                f"float64 beyond 2 x the CPU's {ep} + {SPARSE_TOL}")
        worst["card"] = max(worst["card"], ec / m)
        worst["cpu"] = max(worst["cpu"], ep / m)
    return worst


def sparse_parity(dev, arch: str) -> dict:
    """One fp32 sparse step card against CPU, each table capped at
    ``PARITY_TABLE_ROWS`` rows (widths kept), ``SPARSE_PARITY_ROWS`` rows
    of batch: table, AdaGrad accumulator, dense params and AdamW state,
    each held against the same step in float64 on the CPU.  DLRM's fp32
    gradient at its init is itself off by up to 3.4e-3 of a leaf's max
    (the deep ReLU MLPs cancel; DCN-v2's 1.8e-7), so the card is held to
    the CPU's own fp32 error, not to a fixed bound."""
    cfg = _ctr_cfg(arch, PARITY_TABLE_ROWS)
    init, step = make_ctr_sparse_train_step(cfg, LOCAL_PLAN, _recsys_opt())
    params = recsys.init(cfg, seed=0, device=dev)
    cpu = init(tree_map(lambda t: t.to("cpu", copy=True), params))
    truth = init(tree_map(lambda t: t.to("cpu", torch.float64), params))
    card = init(params)
    batch = batch_for(cfg, SPARSE_PARITY_ROWS, 0)
    card, ac = step(card, batch)
    cpu, ap = step(cpu, batch)
    truth, _ = step(truth, batch)
    out = {"params": _truth_err(f"{arch} sparse step", card.params,
                                cpu.params, truth.params),
           "opt_state": _truth_err(f"{arch} sparse step state",
                                   card.opt_state, cpu.opt_state,
                                   truth.opt_state),
           "loss": _model_close(f"{arch} sparse loss", ac["loss"],
                                ap["loss"]),
           "touched_rows": int((cpu.opt_state["embed_acc"] > 0).sum())}
    del params, cpu, card, truth
    torch.cuda.empty_cache()
    return out


def sparse_train(dev, arch: str, smi: str) -> dict:
    """``arch``'s sparse step at the registry's ``train_batch`` on the
    whole table (DLRM's in bf16, its dense params in fp32): ms a step,
    rows/s and ``max_memory_allocated``."""
    cfg = _ctr_cfg(arch)
    rows = get_shape("recsys", "train_batch")["batch"]
    tdt = TRAIN_DTYPES.get(arch, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = recsys.init(cfg, seed=0, dtype=tdt, device=dev)
    params = {k: (v if k == "table" else cast_tree(v, torch.float32))
              for k, v in params.items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init, step = make_ctr_sparse_train_step(cfg, LOCAL_PLAN, _recsys_opt())
    state = init(params)
    del params
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                batch_for(cfg, rows, i).items()}
               for i in range(SPARSE_STEPS + 1)]
    ms, auxs, state = _step_ms(step, state, batches.__getitem__,
                               SPARSE_STEPS + 1)
    for a in auxs:
        require(all(np.isfinite(v) for v in a.values()),
                f"[train] {arch} sparse aux {a}")
    touched = int((state.opt_state["embed_acc"] > 0).sum())
    steady = ms[1:]
    out = {"rows": rows, "table_rows": int(state.params["table"].shape[0]),
           "table_dtype": str(tdt).replace("torch.", ""),
           "table_bytes": tree_bytes(state.params["table"]),
           "init_s": init_s, "first_ms": ms[0], "step_ms": steady,
           "step_ms_mean": sum(steady) / len(steady),
           "rows_per_s": rows / (sum(steady) / len(steady) / 1e3),
           "touched_rows": touched, "loss": [a["loss"] for a in auxs],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"[train] {arch} sparse step (row-wise AdaGrad on the table, AdamW "
        f"on the dense params) at train_batch {rows} rows: table "
        f"{out['table_rows']} x {state.params['table'].shape[1]} "
        f"{out['table_dtype']} ({out['table_bytes']} B, init {init_s:.1f} "
        f"s); {SPARSE_STEPS} steps after the first ({ms[0]:.1f} ms): mean "
        f"{out['step_ms_mean']:.2f} ms ({[round(x, 2) for x in steady]}), "
        f"{out['rows_per_s']:.0f} rows/s; {touched} rows touched; "
        f"loss {[round(x, 4) for x in out['loss']]}; max_memory_allocated "
        f"{out['peak_bytes']} B; {smi}")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dense_train(dev, name: str, params, loss_fn, opt, batch, smi: str,
                what: str) -> dict:
    """``make_train_step`` on one batch held on the card: the first step,
    then ``DENSE_STEPS`` timed ones."""
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(loss_fn, opt)
    state = init_state(params, opt)
    ms, auxs, state = _step_ms(step, state, lambda i: batch,
                               DENSE_STEPS + 1)
    for a in auxs:
        require(all(np.isfinite(v) for v in a.values()),
                f"[train] {name} aux {a}")
    steady = ms[1:]
    out = {"first_ms": ms[0], "step_ms": steady,
           "step_ms_mean": sum(steady) / len(steady),
           "loss": [a["loss"] for a in auxs],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"[train] {name} ({what}): {DENSE_STEPS} steps after the first "
        f"({ms[0]:.1f} ms): mean {out['step_ms_mean']:.2f} ms "
        f"({[round(x, 2) for x in steady]}); loss "
        f"{[round(x, 4) for x in out['loss']]}; max_memory_allocated "
        f"{out['peak_bytes']} B; {smi}")
    del state
    torch.cuda.empty_cache()
    return out


def phase_train(dev, card) -> dict:
    """Training on the card: qwen3-0.6b at full width and depth
    (``train_4k``, batch cut to 8 by accumulation; profiled), its fp32
    gradient and one AdamW step card against CPU, a restart bit for bit,
    the CTR sparse step at ``train_batch`` (DCN-v2 fp32, DLRM's 48 GB bf16
    table) with a capped fp32 check against the CPU, and SchNet, DIN and
    SASRec steps."""
    smi = card["nvidia_smi"]
    t_phase = time.perf_counter()
    require_fp32_matmul()
    out = {"card": smi, "part_s": {}}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        out["part_s"][name] = time.perf_counter() - t0
        return res

    out["qwen"] = part("qwen", train_qwen, dev, smi)
    out["qwen_parity"] = part("qwen_parity", train_qwen_parity, dev)
    p = out["qwen_parity"]
    log(f"[train] qwen3-0.6b full width fp32 policy, B {LM_BATCH} x "
        f"{LM_PARITY_SEQ} (the lm phase's inputs), card vs CPU: loss max "
        f"abs err {p['loss']:.3e}; gradient worst leaf err / leaf max "
        f"{p['grad']:.3e}; one AdamW step (constant lr 3e-4): params "
        f"{p['params']:.3e}, m / v {p['opt_state']:.3e}, grad_norm "
        f"{p['grad_norm']:.3e} (tol rtol {TRAIN_TOL['rtol']} + "
        f"{TRAIN_TOL['atol_of_max']} x leaf max); params moved up to "
        f"{p['moved']:.3e}; CPU gradient {p['cpu_grad_s']:.1f} s, CPU update "
        f"{p['cpu_update_s']:.1f} s")
    out["restart"] = part("restart", train_restart, dev)
    r = out["restart"]
    log(f"[train] restart on the card: qwen3-0.6b full width, depth "
        f"{RESTART_DEPTH}, seq {RESTART_SEQ}, KV blocks {RESTART_CHUNK}, "
        f"remat, bf16 compute: {RESTART_STEPS} steps with a checkpoint at "
        f"{RESTART_AT} ({r['full_s']:.1f} s), restored and replayed "
        f"({r['restored_s']:.1f} s): all {r['leaves']} leaves (params, "
        f"AdamW m / v, step) bit for bit; losses "
        f"{[round(x, 4) for x in r['losses']]}")
    out["sparse_parity"] = {a: part(f"sparse_parity {a}", sparse_parity,
                                    dev, a)
                            for a in ("dlrm-mlperf", "dcn-v2")}
    log(f"[train] sparse step fp32 card vs CPU (tables capped at "
        f"{PARITY_TABLE_ROWS} rows, {SPARSE_PARITY_ROWS} rows of batch), "
        f"each against the step in float64 (worst err / leaf max; the "
        f"card within 2 x the CPU's error + rtol {SPARSE_TOL['rtol']} + "
        f"{SPARSE_TOL['atol_of_max']} x leaf max): {out['sparse_parity']}")
    out["sparse"] = {a: part(f"sparse {a}", sparse_train, dev, a, smi)
                     for a in ("dcn-v2", "dlrm-mlperf")}
    out["dense"] = {}
    for name in ("molecule", "full_graph_sm"):
        shape = get_shape("gnn", name)
        batch = (_molecule(shape) if name == "molecule"
                 else _gnn_batch_full_graph(shape)[0])
        cfg = _gnn_cfg(shape, "bfloat16")
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        out["dense"][f"schnet {name}"] = part(
            f"schnet {name}", dense_train, dev, f"schnet {name}",
            schnet.init(cfg, seed=0, device=dev),
            lambda p, b, c=cfg: schnet.loss_fn(p, b, c),
            optim.adamw(optim.warmup_cosine(1e-3, 100, 10_000)), tb, smi,
            f"{int(batch['feats'].shape[0])} nodes, "
            f"{int(batch['senders'].shape[0])} edges padded, bf16 messages, "
            f"AdamW warmup_cosine(1e-3, 100, 10000)")
    rows = get_shape("recsys", "train_batch")["batch"]
    for arch in ("din", "sasrec"):
        cfg = get_arch(arch)[0]
        tb = {k: torch.as_tensor(v, device=dev)
              for k, v in batch_for(cfg, rows, 0).items()}
        out["dense"][arch] = part(
            arch, dense_train, dev, arch,
            recsys.init(cfg, seed=0, device=dev),
            lambda p, b, c=cfg: recsys.loss_fn(p, b, c), _recsys_opt(), tb,
            smi, f"train_batch {rows} rows, fp32, AdamW on every leaf "
            f"(tables included) warmup_cosine(1e-3, 1000, 100000)")
        del tb
    out["s"] = time.perf_counter() - t_phase
    log(f"[train] phase {out['s']:.1f} s (budget {TRAIN_LIMIT_S:.0f} s); "
        f"by part: { {k: round(v, 1) for k, v in out['part_s'].items()} }")
    RESULTS["train"] = out
    return out


# ------------------------------------------------------------ phase 18
# Models sharded over a mesh (plain torch; no kernel lies on this path):
# the port's copy of the reference's cells (launch/cells.py) over a
# DeviceMesh.  Stated before the run: on a world-1 NCCL (1, 1) mesh every
# placement is over size-1 axes, so qwen3-0.6b's decode cell and train_4k
# cell must equal the same step with no mesh (max abs err printed, bit
# for bit expected); deepseek-v3-671b at full width (1 dense + 1 MoE
# layer) serves and takes one Adafactor step, its peak memory logged.
# Four gloo ranks sharing the card on a (2, 2) mesh must give, on every
# rank, the one-card step's logits, loss, grad_norm and updated
# parameters within 1e-4 of each leaf's max (ROADMAP fault 21: the
# optimizer starts from trained-looking moments, so an update is a smooth
# function of the gradient).
SM_SERVE_SEQ = 4096             # world-1 qwen3: prefill 2 x 4,096
SM_DECODE_STEPS = 8
SM_BATCH = 2
SM_TRAIN_SEQ = 4096             # the train_4k binding, one microbatch of 2
SM_DEEP_SEQ = 512               # deepseek: prefill 2 x 512, 8 steps
SM_DEEP_TRAIN = (1, 512)        # one Adafactor step at 1 x 512 (cut ladder)
SM_DEEP_CUTS = (512, 256, 128)  # tokens tried in order when memory runs out
SM_GLOO_SEQ = 512               # four ranks: prefill 2 x 512, 4 steps
SM_GLOO_DECODE_STEPS = 4
SM_GLOO_TRAIN_BATCH = 4         # one train step of 4 x 512
SM_DEEP_REDUCED = dict(prefill=(4, 16), train=(8, 16))   # (batch, seq)
SM_GRANITE_LAYERS = 2           # granite-34b at full width, depth cut 88 -> 2
# qwen3-0.6b on the four ranks at full width, depth cut 28 -> 8 to keep the
# smoke within its time (every layer is the same code; the world-1 mesh and
# the one-card phases keep the full depth)
SM_QWEN_LAYERS = 8
# the CTR cases on the four ranks: (arch, each table's rows capped at, or
# None for the whole table); DCN-v2's 12.0 GB fp32 table lies with its
# columns over tp, DLRM's capped as the train phase caps it
SM_CTR = {"dcn": ("dcn-v2", None), "dlrm": ("dlrm-mlperf", 65_536)}
SM_TOL = 1e-4                   # of each leaf's max
# the four ranks' updated params, of each leaf's max: one AdamW update
# from step 1000 moves a weight leaf by about 1.25e-4 of its max, so 1e-4
# would pass a wrong or skipped update; sound runs read <= 5.9e-8
SM_PARAM_TOL = 1e-6
SM_START_STEP = 1000            # warmup_cosine's lr is 0 at step 0
SM_LIMIT_S = 420.0              # the four ranks, joined together
SM_WORLD = 4


def _sm_plan(mesh):
    from repro_torch.distributed.sharding import SINGLE_POD_PLAN

    return SINGLE_POD_PLAN.with_mesh(mesh)


def _sm_local(tree):
    """A world-1 DTensor tree's local tensors (the whole values, shared
    storage): the same weights with no mesh."""
    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local")
                    else t, tree)


def _sm_rewrap(tree, plan, specs):
    """A world-1 DTensor tree re-wrapped with other specs' placements
    (the same local storage: on size-1 axes every placement holds the
    whole value)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _sm_rewrap(v, plan, specs[k]) for k, v in tree.items()}
    return DTensor.from_local(tree.to_local(), plan.mesh,
                              plan.spec_placements(specs), run_check=False)


def _sm_moments(params, seed: int):
    """AdamW moments away from zero, drawn on the parameters' device with
    a seeded generator (the same values in every process), placed as the
    parameters are."""
    from repro_torch.distributed.sharding import place_on

    gen = torch.Generator(device=tree_leaves_sorted(params)[0].device)
    gen.manual_seed(seed)

    def one(p, kind):
        full = torch.empty(p.shape, dtype=torch.float32,
                           device=p.device if not hasattr(p, "to_local")
                           else p.to_local().device)
        if kind == "m":
            full.normal_(generator=gen).mul_(1e-3)
        else:
            full.uniform_(generator=gen).add_(1.0).mul_(1e-4)
        if hasattr(p, "device_mesh"):
            return place_on(full, p.device_mesh, p.placements)
        return full

    return {"m": tree_map(lambda p: one(p, "m"), params),
            "v": tree_map(lambda p: one(p, "v"), params)}


def _sm_leaf_errs(got, want) -> dict:
    """Per leaf of two trees (``got`` DTensors or tensors; ``want`` whole
    tensors, any device): the max abs err of this rank's shard against
    the same slice of ``want``, over the whole leaf's max.  Over every
    rank that is the whole leaf's error, and no leaf travels between
    ranks to find it."""
    from repro_torch.distributed.sharding import local, local_offset

    out = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in sorted(b):
                walk(a[k], b[k], f"{path}/{k}")
            return
        x = local(a).float()
        at = tuple(slice(o, o + n) for o, n in zip(local_offset(a),
                                                    x.shape))
        y = b[at].to(x.device).float()
        scale = max(float(b.abs().max()), 1e-6)
        out[path] = float((x - y).abs().max()) / scale if x.numel() else 0.0
    walk(got, want, "")
    return out


def sm_world1(dev, smi: str) -> dict:
    """The cells over a world-1 NCCL (1, 1) mesh on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.launch import cells

    require(dev.type == "cuda", f"[sharded models] world-1 NCCL mesh "
            f"needs the card, got {dev}")
    out = {}
    workdir = tempfile.mkdtemp(prefix="world1-", dir=OUT_DIR)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        plan = _sm_plan(mesh)
        qcfg = get_arch("qwen3-0.6b")[0]
        # 1. the decode cell: a prefill of 2 x 4,096, then 8 steps
        total = SM_SERVE_SEQ + SM_DECODE_STEPS
        dcell = cells.build_cell(qcfg, "lm", plan, ShapeSpec(
            "decode_4k", "decode", dict(seq=total, batch=SM_BATCH)))
        toks = torch.as_tensor(LMStream(qcfg.vocab, total, SM_BATCH,
                                        seed=2).batch_at(0)["tokens"],
                               device=dev)
        sharding.REDISTRIBUTES.clear()
        torch.cuda.reset_peak_memory_stats()
        p = transformer.init(dcell.cfg, seed=0, plan=dcell.plan, device=dev)
        tk = dcell.plan.distribute(toks[:, :SM_SERVE_SEQ], "dp", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = transformer.prefill(p, tk, dcell.cfg, dcell.plan,
                                        max_len=total)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        mesh_logits, step_ms = [sharding.whole(lg)], []
        for i in range(SM_DECODE_STEPS):
            t1 = dcell.plan.distribute(
                toks[:, SM_SERVE_SEQ + i:SM_SERVE_SEQ + i + 1], "dp", None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = dcell.step_fn(p, cache, t1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            mesh_logits.append(sharding.whole(lg))
        moves = dict(sharding.REDISTRIBUTES)
        peak = torch.cuda.max_memory_allocated()
        del cache
        lp = _sm_local(p)
        lg, cache = transformer.prefill(lp, toks[:, :SM_SERVE_SEQ],
                                        dcell.cfg, LOCAL_PLAN, max_len=total)
        plain_logits = [lg]
        for i in range(SM_DECODE_STEPS):
            lg, cache = transformer.decode_step(
                lp, cache, toks[:, SM_SERVE_SEQ + i:SM_SERVE_SEQ + i + 1],
                dcell.cfg, LOCAL_PLAN)
            plain_logits.append(lg)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(mesh_logits, plain_logits)]
        bits = all(torch.equal(a, b) for a, b in zip(mesh_logits,
                                                     plain_logits))
        require(all(bool(torch.isfinite(a).all()) for a in mesh_logits),
                "[sharded models] world-1 qwen3 decode logits not finite")
        out["qwen_decode"] = {"prefill_s": prefill_s, "step_ms": step_ms,
                              "max_abs_err": errs, "bit_for_bit": bits,
                              "peak_bytes": peak, "moves": moves}
        log(f"[sharded models] world-1 NCCL (1, 1) mesh, qwen3-0.6b full "
            f"width and depth through _lm_decode_cell (bf16 weights, no "
            f"FSDP): prefill {SM_BATCH} x {SM_SERVE_SEQ} in {prefill_s:.3f} "
            f"s, {SM_DECODE_STEPS} decode steps mean "
            f"{sum(step_ms) / len(step_ms):.2f} ms; against the same steps "
            f"with no mesh: max abs err {max(errs):.3e} (bit for bit "
            f"{bits}); peak {peak} B; moves {moves}; {smi}")
        del p, lp, cache, lg, mesh_logits, plain_logits
        gc.collect()
        torch.cuda.empty_cache()
        out["collectives"] = _sm_world1_collectives(dev, mesh)
        out["qwen_train"] = _sm_world1_train(dev, plan, qcfg, smi)
        out["deepseek"] = _sm_world1_deepseek(dev, plan, smi)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def _sm_world1_collectives(dev, mesh) -> dict:
    """The exchange and the reduce-scatter that ``sharding.move`` issues
    (``_swap`` of an ``_exchange_plan``, ``_reduce_scatter``), called once
    each over the world-1 NCCL mesh's group: over one rank each returns
    its input (a move over size-1 dims issues neither)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding

    x = torch.randn((6, 5, 3), generator=torch.Generator().manual_seed(3))
    x = x.to(dev)
    group = mesh.get_group(0)
    for c in (sharding.COLLECTIVE_BYTES, sharding.COLLECTIVE_COUNTS):
        c.clear()
    plan = sharding._exchange_plan(mesh, tuple(x.shape),
                                   [Shard(0), Replicate()],
                                   [Shard(1), Replicate()], (0,), group)
    swapped = sharding._swap(x, plan, group)
    reduced = sharding._reduce_scatter(x, 1, mesh, (0,), dist.ReduceOp.SUM,
                                       group)
    torch.cuda.synchronize()
    out = {"backend": dist.get_backend(group),
           "exchange_equal": bool(torch.equal(swapped, x)),
           "reduce_scatter_equal": bool(torch.equal(reduced, x)),
           "counts": dict(sharding.COLLECTIVE_COUNTS)}
    log(f"[sharded models] world-1 {out['backend']} mesh: one all-to-all "
        f"(all_to_all_single with split sizes) and one reduce-scatter "
        f"(reduce_scatter_tensor) through the moves' own code return their "
        f"input: {out['exchange_equal']} / {out['reduce_scatter_equal']}; "
        f"counts {out['counts']}")
    require(out["exchange_equal"] and out["reduce_scatter_equal"]
            and out["counts"] == {"all_to_all": 1, "reduce_scatter": 1},
            f"[sharded models] world-1 collectives: {out}")
    return out


def _sm_world1_train(dev, plan, qcfg, smi: str) -> dict:
    """One step of the train_4k cell (one microbatch of 2 x 4,096) over
    the world-1 mesh against the same cell's step with no mesh, at the
    fp32 policy: the forward is the same code on the same tensors, but
    autograd adds a tensor's gradient contributions in another order
    where a use goes through a shard's view (the residual feeds RMSNorm's
    two products directly on one card, through the region's view under
    a mesh), so the gradients agree to fp32 rounding; at bf16 compute that
    rounding flips bf16 ulps of the cotangents."""
    transformer.set_precision(torch.float32, torch.float32)
    try:
        return _sm_world1_train_fp32(
            dev, plan, dataclasses.replace(qcfg, residual_dtype="float32"),
            smi)
    finally:
        transformer.set_precision()


def _sm_world1_train_fp32(dev, plan, qcfg, smi: str) -> dict:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import SINGLE_POD_PLAN
    from repro_torch.launch import cells
    from repro_torch.train.loop import TrainState

    shape = ShapeSpec("train_4k", "train", dict(seq=SM_TRAIN_SEQ,
                                                batch=SM_BATCH))
    cell = cells.build_cell(qcfg, "lm", plan, shape)
    one = cells.build_cell(qcfg, "lm", SINGLE_POD_PLAN, shape)
    require(dataclasses.asdict(cell.cfg) == dataclasses.asdict(one.cfg),
            "[sharded models] the cells bind one config")
    opt = _lm_optimizer(cell.cfg)
    b = LMStream(qcfg.vocab, SM_TRAIN_SEQ, SM_BATCH, seed=0).batch_at(0)
    # no mesh first: its new state stays for the comparison
    p1 = transformer.init(one.cfg, seed=0, device=dev)
    s1 = TrainState(step=torch.tensor(SM_START_STEP, dtype=torch.int32,
                                      device=dev), params=p1,
                    opt_state=_sm_moments(p1, 5), ef_buf=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1, a1 = one.step_fn(s1, {k: torch.as_tensor(v, device=dev)
                              for k, v in b.items()})
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    sharding.REDISTRIBUTES.clear()
    torch.cuda.reset_peak_memory_stats()
    p2 = transformer.init(cell.cfg, seed=0, plan=cell.plan, device=dev)
    s2 = TrainState(step=cell.plan.place(torch.tensor(
        SM_START_STEP, dtype=torch.int32, device=dev), ()), params=p2,
        opt_state=_sm_moments(p2, 5), ef_buf=None)
    bd = cell.place((None, b), dev)[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2, a2 = cell.step_fn(s2, bd)
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    moves = dict(sharding.REDISTRIBUTES)
    aux_err = {k: float((a2[k].float() - a1[k].float()).abs().max())
               for k in a1}
    perr = _sm_leaf_errs(s2.params, s1.params)
    oerr = _sm_leaf_errs(s2.opt_state, s1.opt_state)
    bits = all(v == 0.0 for v in list(perr.values()) + list(oerr.values())
               + list(aux_err.values()))
    require(all(np.isfinite(float(a2[k])) for k in a2),
            "[sharded models] world-1 qwen3 train aux not finite")
    require(max(perr.values()) <= SM_TOL and max(oerr.values()) <= SM_TOL,
            f"[sharded models] world-1 qwen3 train step against no mesh: "
            f"params {max(perr.values()):.3e}, m / v "
            f"{max(oerr.values()):.3e} of the leaf max (tol {SM_TOL})")
    out = {"plain_ms": plain_ms, "mesh_ms": mesh_ms, "aux_err": aux_err,
           "params_err": max(perr.values()), "opt_err": max(oerr.values()),
           "bit_for_bit": bits, "peak_bytes": peak, "moves": moves,
           "loss": float(a2["loss"]), "grad_norm": float(a2["grad_norm"])}
    log(f"[sharded models] world-1 qwen3-0.6b _lm_train_cell (train_4k "
        f"binding: remat, KV blocks {cell.cfg.attn_chunk}, seq-sharded "
        f"residual; one microbatch {SM_BATCH} x {SM_TRAIN_SEQ}, fp32 "
        f"policy, AdamW from step {SM_START_STEP}): {mesh_ms:.1f} ms (no mesh {plain_ms:.1f} "
        f"ms); loss {out['loss']:.4f}, grad_norm {out['grad_norm']:.4f}; "
        f"against no mesh: aux max abs err {max(aux_err.values()):.3e}, "
        f"params {out['params_err']:.3e}, m / v {out['opt_err']:.3e} of "
        f"the leaf max (bit for bit {bits}); peak {peak} B; moves {moves}; "
        f"{smi}")
    del s1, s2, p1, p2, bd
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sm_world1_deepseek(dev, plan, smi: str) -> dict:
    """deepseek-v3-671b at full width, depth cut to 1 dense + 1 MoE layer:
    the decode cell (prefill 2 x 512, 8 steps), then one train-cell step
    under its Adafactor over the same bf16 weights."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.launch import cells
    from repro_torch.train.loop import TrainState

    cfg = dataclasses.replace(get_arch("deepseek-v3-671b")[0],
                              **LM_DEEP_DEPTH)
    total = SM_DEEP_SEQ + SM_DECODE_STEPS
    dcell = cells.build_cell(cfg, "lm", plan, ShapeSpec(
        "decode_512", "decode", dict(seq=total, batch=SM_BATCH)))
    toks = torch.as_tensor(LMStream(cfg.vocab, total, SM_BATCH,
                                    seed=2).batch_at(0)["tokens"],
                           device=dev)
    sharding.REDISTRIBUTES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = transformer.init(dcell.cfg, seed=0, plan=dcell.plan, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(p)
    lg, cache = transformer.prefill(
        p, dcell.plan.distribute(toks[:, :SM_DEEP_SEQ], "dp", None),
        dcell.cfg, dcell.plan, max_len=total)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = transformer.prefill(
        p, dcell.plan.distribute(toks[:, :SM_DEEP_SEQ], "dp", None),
        dcell.cfg, dcell.plan, max_len=total)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(sharding.whole(lg)).all())
    step_ms = []
    for i in range(SM_DECODE_STEPS):
        t1 = dcell.plan.distribute(
            toks[:, SM_DEEP_SEQ + i:SM_DEEP_SEQ + i + 1], "dp", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = dcell.step_fn(p, cache, t1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(torch.isfinite(sharding.whole(lg)).all())
    require(finite, "[sharded models] deepseek decode logits not finite")
    serve_peak = torch.cuda.max_memory_allocated()
    serve_moves = dict(sharding.REDISTRIBUTES)
    del cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    # one train step: accumulation off (one microbatch), the same weights
    # re-wrapped with the train cell's (FSDP) placements
    out = {"params": n_params, "init_s": init_s, "prefill_s": prefill_s,
           "decode_ms": step_ms, "serve_peak_bytes": serve_peak,
           "serve_moves": serve_moves}
    for tokens in SM_DEEP_CUTS:
        try:
            out["train"] = _sm_deep_step(dev, plan, cfg, p, tokens)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[sharded models] deepseek train step at 1 x {tokens} "
                f"ran out of memory ({str(e)[:120]}); cutting the tokens")
            gc.collect()
            torch.cuda.empty_cache()
    require("train" in out, "[sharded models] deepseek train step did not "
            f"fit at any of {SM_DEEP_CUTS} tokens")
    t = out["train"]
    log(f"[sharded models] world-1 deepseek-v3-671b full width, depth cut "
        f"to {cfg.n_dense_layers} dense + {cfg.n_moe_layers} MoE layer + "
        f"MTP ({n_params} params, bf16, init {init_s:.1f} s): decode cell "
        f"prefill {SM_BATCH} x {SM_DEEP_SEQ} in {prefill_s:.3f} s, "
        f"{SM_DECODE_STEPS} steps mean {sum(step_ms) / len(step_ms):.2f} ms, "
        f"peak {serve_peak} B; _lm_train_cell one step at 1 x "
        f"{t['tokens']} (accumulation off; Adafactor over the bf16 "
        f"weights, leaf by leaf in place, expert leaves in chunks): "
        f"{t['ms']:.1f} ms, loss {t['loss']:.4f}, grad_norm "
        f"{t['grad_norm']:.4f}, params moved {t['moved']:.3e}, peak "
        f"{t['peak_bytes']} B; {smi}")
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sm_deep_step(dev, plan, cfg, p, tokens: int) -> dict:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.launch import cells
    from repro_torch.train.loop import TrainState

    tcell = cells.build_cell(dataclasses.replace(cfg, grad_accum=1), "lm",
                             plan, ShapeSpec("train_512", "train", dict(
                                 seq=tokens, batch=SM_DEEP_TRAIN[0])))
    specs = transformer.param_specs(tcell.cfg, tcell.plan)
    params = _sm_rewrap(p, tcell.plan, specs)
    opt = _lm_optimizer(tcell.cfg)
    require(opt.name == "adafactor", "[sharded models] deepseek optimizer")
    probe = {k: v.to_local()[0, :4].clone() for k, v in
             params["moe_layers"].items() if k == "w_gate"}
    state = TrainState(step=tcell.plan.place(torch.tensor(
        SM_START_STEP, dtype=torch.int32, device=dev), ()), params=params,
        opt_state=opt.init(params), ef_buf=None)
    b = LMStream(cfg.vocab, tokens, SM_DEEP_TRAIN[0], seed=0).batch_at(0)
    bd = tcell.place((None, b), dev)[1]
    sharding.REDISTRIBUTES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux = tcell.step_fn(state, bd)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    moved = float((state.params["moe_layers"]["w_gate"].to_local()[0, :4]
                   .float() - probe["w_gate"].float()).abs().max())
    require(all(np.isfinite(float(aux[k])) for k in aux),
            "[sharded models] deepseek train aux not finite")
    require(moved > 0, "[sharded models] the deepseek step moved nothing")
    return {"tokens": tokens, "ms": ms, "loss": float(aux["loss"]),
            "grad_norm": float(aux["grad_norm"]), "moved": moved,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "moves": dict(sharding.REDISTRIBUTES)}


def _sm_cases(plan, qcfg, dcfg, gcfg):
    """The four-rank LM cases' cells under ``plan`` (a (2, 2) mesh, or its
    shape alone for the one-card reference): qwen3-0.6b at full width
    with ``SM_QWEN_LAYERS`` layers, deepseek-v3-671b at ``reduced()``,
    granite-34b at full
    width with ``SM_GRANITE_LAYERS`` layers (one KV head: its 48 query
    heads split over tp, K and V whole on each rank)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import cells

    out = {}
    gloo = ((SM_BATCH, SM_GLOO_SEQ), (SM_GLOO_TRAIN_BATCH, SM_GLOO_SEQ))
    for name, cfg, pre, train in (
            ("qwen", qcfg) + gloo,
            ("deepseek", dcfg, SM_DEEP_REDUCED["prefill"],
             SM_DEEP_REDUCED["train"]),
            ("granite", gcfg) + gloo):
        total = pre[1] + SM_GLOO_DECODE_STEPS
        out[name] = {
            "prefill": cells.build_cell(cfg, "lm", plan, ShapeSpec(
                "prefill", "prefill", dict(seq=pre[1], batch=pre[0]))),
            "decode": cells.build_cell(cfg, "lm", plan, ShapeSpec(
                "decode", "decode", dict(seq=total, batch=pre[0]))),
            "train": cells.build_cell(cfg, "lm", plan, ShapeSpec(
                "train", "train", dict(seq=train[1], batch=train[0]))),
            "pre": pre, "total": total}
    return out


def _sm_cfgs():
    qcfg = dataclasses.replace(get_arch("qwen3-0.6b")[0],
                               n_layers=SM_QWEN_LAYERS,
                               residual_dtype="float32")
    d = get_arch("deepseek-v3-671b")[0].reduced()
    dcfg = dataclasses.replace(d, residual_dtype="float32", moe=dataclasses
                               .replace(d.moe, capacity_factor=8.0))
    gcfg = dataclasses.replace(get_arch("granite-34b")[0],
                               n_layers=SM_GRANITE_LAYERS,
                               residual_dtype="float32")
    return qcfg, dcfg, gcfg


def _sm_ctr_cases(plan) -> dict:
    """The CTR cases' serve and train cells under ``plan`` (their widths
    in full, the registry's ``serve_p99`` and ``train_batch``)."""
    from repro_torch.launch import cells

    return {name: {kind: cells.build_cell(
        _ctr_cfg(arch, rows), "recsys", plan, get_shape("recsys", shape))
        for kind, shape in (("serve", "serve_p99"),
                            ("train", "train_batch"))}
        for name, (arch, rows) in SM_CTR.items()}


def _sm_ctr_run(cs: dict, dev, one_card: bool, turn=None) -> dict:
    """Each CTR case's serve cell and one sparse train step (AdamW from
    trained-looking moments at ``SM_START_STEP``, the AdaGrad sums
    positive), fp32: the logits, the step's aux and dense leaves (and
    their moments), the table's rows the batch touched with the float64
    sums of every column and of its squares (a sparse step changes no
    other row), and the AdaGrad sums.  ``turn(fn)`` runs ``fn`` on one
    rank at a time (each rank draws the whole table before it keeps its
    columns)."""
    from repro_torch.distributed.sharding import (local, local_offset,
                                                  place_on, whole)
    from repro_torch.train.loop import TrainState

    out = {}
    for name, c in cs.items():
        sc, tc = c["serve"], c["train"]
        cfg, plan = sc.cfg, LOCAL_PLAN if one_card else sc.plan
        res = {"ms": {}}
        params = (turn or (lambda f: f()))(
            lambda: recsys.init(cfg, seed=0, plan=plan, device=dev))
        sb = serve_batch(cfg, batch_for(cfg, sc.args[1]["dense"].shape[0],
                                        0))
        sb = {k: torch.as_tensor(v, device=dev) for k, v in sb.items()} \
            if one_card else sc.place((None, sb), dev)[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = recsys.serve_logits(params, sb, cfg, plan) if one_card \
            else sc.step_fn(params, sb)
        torch.cuda.synchronize()
        res["ms"]["serve"] = (time.perf_counter() - t0) * 1e3
        res["logits"] = [whole(lg).detach().float().cpu()]
        rest = {k: v for k, v in params.items() if k != "table"}
        rows = params["table"].shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        acc = torch.empty(rows, device=dev).uniform_(generator=gen)
        acc = acc.add_(1.0).mul_(1e-4)
        if not one_card:
            acc = place_on(acc, plan.mesh, plan.spec_placements(
                tc.in_specs[0].opt_state["embed_acc"]))
        step0 = torch.tensor(SM_START_STEP, dtype=torch.int32, device=dev)
        state = TrainState(
            step=step0 if one_card else plan.place(step0, ()),
            params=params, ef_buf=None,
            opt_state={"dense": _sm_moments(rest, 5), "embed_acc": acc})
        tb = batch_for(cfg, tc.args[1]["dense"].shape[0], 1)
        ids = np.unique(tb["sparse"])
        tb = {k: torch.as_tensor(v, device=dev) for k, v in tb.items()} \
            if one_card else tc.place((None, tb), dev)[1]
        step = make_ctr_sparse_train_step(cfg, LOCAL_PLAN,
                                          _recsys_opt())[1] \
            if one_card else tc.step_fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, tb)
        torch.cuda.synchronize()
        res["ms"]["train"] = (time.perf_counter() - t0) * 1e3
        res["aux"] = {k: float(v) for k, v in aux.items()}
        table = state.params["table"]
        t = local(table)
        c0, nc = local_offset(table)[1], t.shape[1]
        at = torch.as_tensor(ids, device=t.device)
        res["table"] = {"touched": t[at].float(), "cols": (c0, nc),
                        **_col_sums(t)}
        res["params"] = {k: v for k, v in state.params.items()
                         if k != "table"}
        res["opt_state"] = state.opt_state
        out[name] = res
        del params, state, table, t
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _col_sums(t, block: int = 1 << 22) -> dict:
    """Float64 sums of every column of ``t`` and of its squares, a block
    of rows at a time (a 6 GB shard never copied whole in float64)."""
    sums = torch.zeros(t.shape[1], dtype=torch.float64, device=t.device)
    squares = torch.zeros_like(sums)
    for i in range(0, t.shape[0], block):
        b = t[i:i + block].double()
        sums += b.sum(0)
        squares += (b * b).sum(0)
    return {"sums": sums, "squares": squares}


def _to_host(x):
    """Every tensor of a result tree detached onto the host."""
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _sm_ctr_errs(got: dict, want: dict) -> dict:
    """A CTR case's errors, each over the leaf's max of the one-card
    step: logits, this rank's shard of each dense leaf and moment and of
    the AdaGrad sums, its columns of the touched rows, and the float64
    column sums (and sums of squares) over the sums' max."""
    c0, nc = got["table"]["cols"]
    tw = want["table"]

    def rel(a, b):
        return float((a.cpu().double() - b.double()).abs().max()) / max(
            float(b.abs().max()), 1e-6)

    return {"logits": max(rel(a, b) for a, b in zip(got["logits"],
                                                     want["logits"])),
            "params": max(_sm_leaf_errs(got["params"],
                                        want["params"]).values()),
            "opt_state": max(_sm_leaf_errs(got["opt_state"],
                                           want["opt_state"]).values()),
            "touched_rows": rel(got["table"]["touched"],
                                tw["touched"][:, c0:c0 + nc]),
            "column_sums": max(rel(got["table"][k], tw[k][c0:c0 + nc])
                               for k in ("sums", "squares")),
            "aux": max(abs(got["aux"][k] - want["aux"][k]) / max(
                abs(want["aux"][k]), 1e-6) for k in want["aux"])}


def _sm_init(name: str, cfg, plan, dev):
    """``transformer.init`` of a case's cell; granite-34b's attention at
    its true fan-in (``testing.attention_at_true_fan_in``: at ``init``'s
    scale its first attention is a hard max, and the one-card step alone
    moves by more than 1e-4 of the logits' max under another fp32
    summation order, ROADMAP fault 27)."""
    p = transformer.init(cfg, seed=0, plan=plan, device=dev)
    return attention_at_true_fan_in(p, cfg) if name == "granite" else p


def _sm_run(cs: dict, dev, one_card: bool) -> dict:
    """Each case's prefill cell, decode steps and train step at the fp32
    policy: the values (gathered whole) and times."""
    from repro_torch.distributed import sharding
    from repro_torch.train.loop import TrainState

    out = {}
    for name, c in cs.items():
        res = {"ms": {}}
        pc, dc, tc = c["prefill"], c["decode"], c["train"]
        plan = LOCAL_PLAN if one_card else pc.plan
        b, s = c["pre"]
        toks = torch.as_tensor(LMStream(pc.cfg.vocab, c["total"], b,
                                        seed=2).batch_at(0)["tokens"],
                               device=dev)
        p = _sm_init(name, pc.cfg, plan, dev)
        tk = toks[:, :s] if one_card else plan.distribute(toks[:, :s], "dp",
                                                          None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = transformer.prefill(p, tk, pc.cfg, plan,
                                        max_len=c["total"])
        torch.cuda.synchronize()
        res["ms"]["prefill"] = (time.perf_counter() - t0) * 1e3
        logits = [sharding.whole(lg).float()]
        del p
        dplan = LOCAL_PLAN if one_card else dc.plan
        dp = _sm_init(name, dc.cfg, dplan, dev)
        res["ms"]["decode"] = []
        for i in range(SM_GLOO_DECODE_STEPS):
            t1 = toks[:, s + i:s + i + 1]
            if not one_card:
                t1 = dplan.distribute(t1, "dp", None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = transformer.decode_step(dp, cache, t1, dc.cfg, dplan)
            torch.cuda.synchronize()
            res["ms"]["decode"].append((time.perf_counter() - t0) * 1e3)
            logits.append(sharding.whole(lg).float())
        res["logits"] = logits
        del dp, cache
        tplan = LOCAL_PLAN if one_card else tc.plan
        params = _sm_init(name, tc.cfg, tplan, dev)
        step0 = torch.tensor(SM_START_STEP, dtype=torch.int32, device=dev)
        state = TrainState(step=step0 if one_card else tplan.place(step0, ()),
                           params=params, opt_state=_sm_moments(params, 5),
                           ef_buf=None)
        shp = tuple(tc.args[1]["tokens"].shape)
        n_rows = int(np.prod(shp[:-1]))
        tb = LMStream(tc.cfg.vocab, shp[-1], n_rows, seed=0).batch_at(0)
        tb = {k: v.reshape(shp) for k, v in tb.items()}
        tb = {k: torch.as_tensor(v, device=dev) for k, v in tb.items()} \
            if one_card else tc.place((None, tb), dev)[1]
        step = tc.step_fn
        if one_card:
            step = make_train_step(
                partial(transformer.loss_fn, cfg=tc.cfg, plan=LOCAL_PLAN),
                _lm_optimizer(tc.cfg), accum=shp[0] if len(shp) == 3
                else 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, tb)
        torch.cuda.synchronize()
        res["ms"]["train"] = (time.perf_counter() - t0) * 1e3
        res["aux"] = {k: float(v) for k, v in aux.items()}
        res["params"] = state.params
        res["opt_state"] = state.opt_state
        out[name] = res
    return out


def sm_gloo_rank(rank: int, world: int, workdir: str, device: str) -> None:
    """One of the four ranks sharing the card (``device``, the parent's)
    under gloo on a (2, 2) mesh: every case through the port's cells, each
    value gathered whole on this rank and held against the one-card
    reference."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.testing import MOVE_MESHES, run_move_cases

    dev = torch.device(device)
    require(dev.type == "cuda", f"[sharded models] gloo rank {rank} needs "
            f"the card, got {dev}")
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    t_all = time.perf_counter()
    transformer.set_precision(torch.float32, torch.float32)

    def turn(fn):
        """``fn()`` on one rank at a time, the others waiting."""
        got = None
        for r in range(world):
            if r == rank:
                got = fn()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        return got

    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cuda")
        # the moves' cases on card tensors, against the whole value cut
        t0 = time.perf_counter()
        moves = run_move_cases(
            {k: make_test_mesh(shape, axes, device_type="cuda")
             for k, (shape, axes) in MOVE_MESHES.items()}, dev)
        move_cases = {
            c["name"]: {"bit_for_bit": c["placements_ok"] and torch.equal(
                c["out"], c["oracle"]) and ("grad" not in c or (
                    c["grad_placements_ok"]
                    and torch.equal(c["grad"], c["grad_oracle"]))),
                "bytes_ok": c["bytes"] == c["expected_bytes"],
                "bytes": c["bytes"], "routes": c["routes"]}
            for c in moves}
        move_s = time.perf_counter() - t0
        qcfg, dcfg, gcfg = _sm_cfgs()
        cs = _sm_cases(_sm_plan(mesh), qcfg, dcfg, gcfg)
        ctr = _sm_ctr_cases(_sm_plan(mesh))
        ref = torch.load(os.path.join(workdir, "one_card.pt"),
                         map_location="cpu", mmap=True)
        for counter in (sharding.REDISTRIBUTES, sharding.COLLECTIVE_BYTES,
                        sharding.COLLECTIVE_COUNTS, sharding.MOVE_ROUTES):
            counter.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = _sm_run(cs, dev, one_card=False)
        t1 = time.perf_counter()
        ctr_got = _sm_ctr_run(ctr, dev, one_card=False, turn=turn)
        part_s = {"lm": t1 - t0, "ctr": time.perf_counter() - t1}
        part_s["move cases"] = move_s
        out = {"rank": rank, "moves": dict(sharding.REDISTRIBUTES),
               "part_s": part_s, "move_cases": move_cases,
               "routes": dict(sharding.MOVE_ROUTES),
               "bytes": dict(sharding.COLLECTIVE_BYTES),
               "peak_bytes": torch.cuda.max_memory_allocated(), "cases": {},
               "ctr": {name: {"errs": _sm_ctr_errs(r, ref["ctr"][name]),
                              "ms": r["ms"]}
                       for name, r in ctr_got.items()}}
        for name, r in got.items():
            want = ref[name]
            logits = [float((a.cpu() - b).abs().max()) / max(
                float(b.abs().max()), 1e-6)
                for a, b in zip(r["logits"], want["logits"])]
            argmax = [bool(torch.equal(a.cpu().argmax(-1), b.argmax(-1)))
                      for a, b in zip(r["logits"], want["logits"])]
            perr = _sm_leaf_errs(r["params"], want["params"])
            oerr = _sm_leaf_errs(r["opt_state"], want["opt_state"])
            worst = max(perr, key=perr.get)
            worst_o = max(oerr, key=oerr.get)
            out["cases"][name] = {
                "logits_err": logits, "argmax_equal": argmax,
                "aux_err": {k: abs(r["aux"][k] - want["aux"][k]) / max(
                    abs(want["aux"][k]), 1e-6) for k in want["aux"]},
                "worst_leaf": worst, "worst_err": perr[worst],
                "worst_state": worst_o, "worst_state_err": oerr[worst_o],
                "ms": r["ms"]}
        out["wall_s"] = time.perf_counter() - t_all
    finally:
        transformer.set_precision()
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def sm_gloo4(dev, smi: str) -> dict:
    """The one-card reference on the card, then four gloo ranks sharing
    it (spawned), each held against it."""
    import torch.multiprocessing as mp
    from types import SimpleNamespace

    qcfg, dcfg, gcfg = _sm_cfgs()
    shape_only = SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros((2, 2)))
    cs = _sm_cases(_sm_plan(shape_only), qcfg, dcfg, gcfg)
    ctr = _sm_ctr_cases(_sm_plan(shape_only))
    workdir = tempfile.mkdtemp(prefix="gloo4-models-", dir=OUT_DIR)
    out = {}
    try:
        transformer.set_precision(torch.float32, torch.float32)
        try:
            t0 = time.perf_counter()
            ref = _to_host({k: {f: v[f] for f in ("logits", "aux", "params",
                                                  "opt_state", "ms")}
                            for k, v in _sm_run(cs, dev,
                                                one_card=True).items()})
            gc.collect()
            torch.cuda.empty_cache()
            ref["ctr"] = _to_host(_sm_ctr_run(ctr, dev, one_card=True))
            out["one_card_s"] = time.perf_counter() - t0
        finally:
            transformer.set_precision()
        out["one_card_ms"] = {k: v["ms"] for k, v in ref.items()
                              if k != "ctr"}
        out["one_card_ms"]["ctr"] = {k: v["ms"]
                                     for k, v in ref["ctr"].items()}
        t0 = time.perf_counter()
        torch.save(ref, os.path.join(workdir, "one_card.pt"))
        out["save_s"] = time.perf_counter() - t0
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=sm_gloo_rank,
                               args=(r, SM_WORLD, workdir, str(dev)))
                 for r in range(SM_WORLD)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + SM_LIMIT_S
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        require(not hung, f"[sharded models] ranks {hung} outlived "
                f"{SM_LIMIT_S} s")
        codes = [p.exitcode for p in procs]
        require(all(c == 0 for c in codes), f"[sharded models] a rank "
                f"failed: exit codes {codes}")
        out["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(SM_WORLD):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["ranks"] = ranks
    scope = {"qwen": f"full width, depth cut to {SM_QWEN_LAYERS} layers",
             "deepseek": "reduced()",
             "granite": f"full width, depth cut to {SM_GRANITE_LAYERS} "
                        f"layers"}
    for name in ranks[0]["cases"]:
        cs_ = [r["cases"][name] for r in ranks]
        worst = max(cs_, key=lambda c: c["worst_err"])
        ms = ranks[0]["cases"][name]["ms"]
        log(f"[sharded models] four gloo ranks on one card, (2, 2) mesh, "
            f"{name} ({scope[name]}"
            f", fp32 policy): every rank's params within {SM_PARAM_TOL} and "
            f"m / v within {SM_TOL} of each leaf's max of the one-card "
            f"step: worst leaf {worst['worst_leaf']} "
            f"{worst['worst_err']:.3e}, worst m / v "
            f"{max(c['worst_state_err'] for c in cs_):.3e}, logits "
            f"{max(max(c['logits_err']) for c in cs_):.3e} (argmax equal "
            f"{all(all(c['argmax_equal']) for c in cs_)}), loss / "
            f"grad_norm rel err {max(max(c['aux_err'].values()) for c in cs_):.3e}; "
            f"rank 0: prefill {ms['prefill']:.1f} ms, decode "
            f"{[round(x, 1) for x in ms['decode']]} ms, train "
            f"{ms['train']:.1f} ms (one card "
            f"{out['one_card_ms'][name]['train']:.1f} ms)")
    for name, (arch, rows) in SM_CTR.items():
        errs = {k: max(r["ctr"][name]["errs"][k] for r in ranks)
                for k in ranks[0]["ctr"][name]["errs"]}
        ms = ranks[0]["ctr"][name]["ms"]
        table = "the whole table" if rows is None else \
            f"tables capped at {rows} rows"
        log(f"[sharded models] four gloo ranks on one card, (2, 2) mesh, "
            f"{arch} (full width, {table}, fp32; serve_p99 and one sparse "
            f"train_batch step): worst rank's error of each leaf's max of "
            f"the one-card step "
            f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol "
            f"{SM_TOL}); rank 0: serve {ms['serve']:.1f} ms, train "
            f"{ms['train']:.1f} ms (one card "
            f"{out['one_card_ms']['ctr'][name]['train']:.1f} ms)")
    log(f"[sharded models] four gloo ranks: rank 0's collective bytes by "
        f"kind {ranks[0]['bytes']}; each mesh dim's move by kind and the "
        f"collectives it took {ranks[0]['routes']}")
    mc = {name: all(r["move_cases"][name]["bit_for_bit"]
                    and r["move_cases"][name]["bytes_ok"] for r in ranks)
          for name in ranks[0]["move_cases"]}
    log(f"[sharded models] four gloo ranks, the moves' {len(mc)} cases on "
        f"card tensors ((2, 2) and (1, 2, 2) meshes; all-to-all and "
        f"reduce-scatter staged through host memory under gloo) bit for "
        f"bit against the whole value cut, with the reference's "
        f"collectives and bytes: {sum(mc.values())} of {len(mc)} "
        f"({ {k: v for k, v in mc.items() if not v} or 'all'}); rank 0 "
        f"{ranks[0]['part_s']['move cases']:.1f} s")
    require(all(mc.values()), f"[sharded models] move cases failed on the "
            f"card: {[k for k, v in mc.items() if not v]}")
    for r in ranks:
        bad = {k: v for k, v in r["routes"].items()
               if k.split("->")[0] in ("all_to_all", "none",
                                       "reduce_scatter")
               and "all_gather" in k.split("->")[1]}
        require(not bad, f"[sharded models] gloo rank {r['rank']}: a "
                f"Shard -> Shard or Partial -> Shard dim all-gathered: "
                f"{bad}")
    log(f"[sharded models] four gloo ranks: wall {out['ranks_s']:.1f} s "
        f"(one-card reference {out['one_card_s']:.1f} s, saved in "
        f"{out['save_s']:.1f} s); per rank wall "
        f"{[round(r['wall_s'], 1) for r in ranks]} s (rank 0 by part "
        f"{ {k: round(v, 1) for k, v in ranks[0]['part_s'].items()} }), "
        f"max_memory_allocated "
        f"{[r['peak_bytes'] for r in ranks]} B; rank 0 moves by kind "
        f"{ranks[0]['moves']}; {smi}")
    for r in ranks:
        for name, c in r["cases"].items():
            require(c["worst_err"] <= SM_PARAM_TOL
                    and c["worst_state_err"] <= SM_TOL
                    and max(c["logits_err"]) <= SM_TOL
                    and max(c["aux_err"].values()) <= SM_TOL,
                    f"[sharded models] gloo rank {r['rank']} {name}: worst "
                    f"leaf {c['worst_leaf']} {c['worst_err']:.3e} (tol "
                    f"{SM_PARAM_TOL}), worst m / v {c['worst_state']} "
                    f"{c['worst_state_err']:.3e}, logits "
                    f"{max(c['logits_err']):.3e}, aux {c['aux_err']} (tol "
                    f"{SM_TOL} of each leaf's max)")
        for name, c in r["ctr"].items():
            require(max(c["errs"].values()) <= SM_TOL,
                    f"[sharded models] gloo rank {r['rank']} {name}: "
                    f"{c['errs']} (tol {SM_TOL} of each leaf's max)")
    return out


def phase_sharded_models(dev, card) -> dict:
    """Models sharded over a mesh: the world-1 NCCL mesh (qwen3-0.6b's
    decode and train_4k cells against no mesh; deepseek-v3-671b at full
    width serving and taking an Adafactor step), then four gloo ranks
    sharing the card on a (2, 2) mesh against the one-card steps."""
    smi = card["nvidia_smi"]
    t0 = time.perf_counter()
    out = {"card": smi, "part_s": {}}
    t = time.perf_counter()
    out["world1"] = sm_world1(dev, smi)
    out["part_s"]["world1"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["gloo4"] = sm_gloo4(dev, smi)
    out["part_s"]["gloo4"] = time.perf_counter() - t
    out["s"] = time.perf_counter() - t0
    log(f"[sharded models] phase {out['s']:.1f} s; by part "
        f"{ {k: round(v, 1) for k, v in out['part_s'].items()} }")
    RESULTS["sharded_models"] = out
    return out


# ------------------------------------------------------ cells and dry run
CELLS_B = 1024              # the ANN cell's batch: the registry's serve_batch
K_ANN = 10                  # and its k
CELLS_ARCHS = ("din", "sasrec")          # the retrieval cells at 1M candidates
CELLS_WORLD = 4             # gloo ranks sharing the card on a (2, 2) mesh
CELLS_LIMIT_S = 240         # the four ranks, joined together
CELLS_ITERS = 20            # CUDA-event calls timing the world-1 cells
CELLS_DRYRUN_LIMIT_S = 300  # the dry run's subprocess
PEAK_RATIO = (0.5, 2.0)     # dry-run peak_bytes over the card's, allowed
CELLS_DRYRUN = (("qwen3-0.6b", "train_4k", None),
                ("sift-1m", "serve_batch", None),
                ("sift-1m", "serve_batch", (1, 1)),
                ("din", "retrieval_cand", (1, 1)))
_CELLS_DRYRUN = r"""
import json, sys, torch
from repro_torch.launch.dryrun import run_cell
out = {"torch": torch.__version__, "cells": []}
for arch, shape, mesh in json.loads(sys.argv[1]):
    rec = run_cell(arch, shape, mesh_shape=mesh, verbose=False)
    a = rec.get("analysis", {})
    out["cells"].append({
        "arch": arch, "shape": shape, "mesh": rec["mesh"],
        "status": rec["status"], "error": rec.get("error"),
        "memory": rec.get("memory"), "times": rec.get("times"),
        "matmul_flops": a.get("matmul_flops"),
        "collective_bytes": a.get("collective_bytes")})
print(json.dumps(out))
"""


def _cells_pack(ctx, dev, K: int, cap: int):
    """The serve phase's index packed into the ANN cell's (K, cap) layout
    on the card: (centroids, bucket ids, bucket vectors), and how many
    rows lay past ``cap`` (dropped)."""
    idx = ctx["idx"]
    bids = np.full((K, cap), -1, np.int32)
    have = np.asarray(idx.bucket_ids, np.int32)[:, :cap]
    bids[:have.shape[0], :have.shape[1]] = have
    over = int(np.maximum(np.asarray(idx.bucket_counts) - cap, 0).sum())
    cents = np.zeros((K, SIFT_1M.d), np.float32)
    cents[:SIFT_1M.n_clusters] = np.asarray(idx.centroids, np.float32)
    b = torch.as_tensor(bids, device=dev)
    db = torch.as_tensor(ctx["corpus"], device=dev)
    vecs = db[torch.clamp(b, min=0).long()]
    vecs.masked_fill_((b < 0)[..., None], 0.0)
    del db
    return (torch.as_tensor(cents, device=dev), b, vecs), over


def _cells_merged(tabs, q, n: int):
    """The ANN cell over ``n`` shards computed in one process on the card:
    each shard's local on its rows of the tables, merged."""
    from repro_torch.distributed.sharding import (_merge_gathered,
                                                  make_sharded_ivf_fn)

    K = tabs[1].shape[0]
    kl = K // n
    local = make_sharded_ivf_fn(K_ANN, max(1, SIFT_1M.nprobe // n), kl,
                                SIFT_1M.n_clusters)
    parts = [local(*(t[s * kl:(s + 1) * kl] for t in tabs), q, lin=s)
             for s in range(n)]
    return _merge_gathered(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1] for p in parts]), K_ANN)


def _cells_retrieval_merged(params, rb, cfg, n: int):
    """``retrieval_logits`` over ``n`` candidate shards in one process:
    each shard scored on its own (what a rank does), the scores joined
    and the top k taken, as the sharded step does."""
    cand = rb["candidates"]
    per = len(cand) // n
    scores = []
    for s in range(n):
        part = {k: (v[s * per:(s + 1) * per]
                    if k in ("candidates", "cand_cates") else v)
                for k, v in rb.items()}
        scores.append(recsys._retrieval_scores(params, part, cfg,
                                               LOCAL_PLAN)[0])
    neg, ids = stable_topk(-torch.cat(scores).float()[None], RETRIEVAL_K)
    c = torch.as_tensor(cand, dtype=torch.int32, device=neg.device)
    return -neg[0], c[ids[0]]


def _near_ties(name, q, corpus, a, b) -> dict:
    """Two (B, k) id answers: every slot where they differ holds two ids
    whose float64 distances to the query lie within ``REL`` of
    ``|q|^2 + |x|^2`` (ROADMAP fault 7)."""
    q64 = q.astype(np.float64)
    differ = np.argwhere(a != b)
    for r, c in differ:
        d = [float(((q64[r] - corpus[j].astype(np.float64)) ** 2).sum())
             for j in (a[r, c], b[r, c])]
        scale = float((q64[r] ** 2).sum() + max(
            (corpus[j].astype(np.float64) ** 2).sum()
            for j in (a[r, c], b[r, c])))
        require(abs(d[0] - d[1]) <= REL * scale,
                f"[cells] {name}: ids {a[r, c]} / {b[r, c]} differ off a "
                f"near-tie at ({r}, {c})")
    return {"agree": float((a == b).mean()), "near_ties": len(differ)}


def cells_world1(dev, ctx, smi: str) -> dict:
    """The ANN cell (sift-1m serve_batch) and the DIN and SASRec retrieval
    cells over a world-1 NCCL (1, 1) mesh: against the same cells with no
    mesh, the ANN cell against its unfused plain loop too; times and the
    steps' peak memory."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import make_sharded_ivf_fn
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_plan

    out = {}
    workdir = tempfile.mkdtemp(prefix="cells-world1-", dir=OUT_DIR)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
        rank=0, world_size=1)
    try:
        plan = make_plan(init_device_mesh("cuda", (1, 1),
                                          mesh_dim_names=("data", "model")))
        shape = get_shape("ann", "serve_batch")
        require(shape["batch"] == CELLS_B and shape["k"] == K_ANN,
                "[cells] serve_batch is not B 1024, k 10")
        cell = cells.build_cell(SIFT_1M, "ann", plan, shape)
        one = cells.build_cell(SIFT_1M, "ann", LOCAL_PLAN, shape)
        K, cap = cell.args[1].shape
        tabs, over = _cells_pack(ctx, dev, K, cap)
        qn = ctx["queries"][:CELLS_B]
        q = torch.as_tensor(qn, device=dev)
        args = cell.place(tabs + (q,), dev)
        reset_launches()
        d, i = cell.step_fn(*args)
        torch.cuda.synchronize()
        launches = read_launches()
        require(launches["candidate_topk"] > 0,
                "[cells] the ANN cell launched no candidate_topk")
        require_bits("[cells] world-1 ANN cell vs no mesh", (d, i),
                     one.step_fn(*tabs, q))
        ud, ui = make_sharded_ivf_fn(K_ANN, SIFT_1M.nprobe, K,
                                     SIFT_1M.n_clusters, fused=False)(
            *tabs, q, lin=0)
        ids = i.cpu().numpy()
        ties = _near_ties("world-1 ANN cell vs unfused", qn, ctx["corpus"],
                          ids, ui.cpu().numpy())
        recall = recall_at_k(ids, ctx["truth"][:CELLS_B])
        ms = time_ms(lambda: cell.step_fn(*args), CELLS_ITERS)
        ms_one = time_ms(lambda: one.step_fn(*tabs, q), CELLS_ITERS)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cell.step_fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        out["ann"] = {"K": int(K), "cap": int(cap), "rows_over_cap": over,
                      "launches": launches, "unfused": ties,
                      "recall_at_10": recall, "ms": ms, "ms_no_mesh": ms_one,
                      "step_peak_bytes": peak, "bit_for_bit": True}
        log(f"[cells] world-1 NCCL (1, 1) mesh, sift-1m ANN cell "
            f"(serve_batch: B {CELLS_B}, k {K_ANN}, {K} buckets x cap "
            f"{cap}, nprobe_local {SIFT_1M.nprobe}): {over} rows over cap "
            f"dropped of {SIFT_1M.n}; bit for bit against the same cell "
            f"with no mesh; ids against the unfused plain loop agree on "
            f"{ties['agree']:.6f} of slots ({ties['near_ties']} near-ties, "
            f"float64); recall@10 {recall:.4f} against the exact top-10; "
            f"{ms:.3f} ms a call by CUDA events (no mesh {ms_one:.3f} ms); "
            f"step peak {peak} B above its arguments; launches {launches}; "
            f"{smi}")
        RESULTS["kernels"]["candidate_topk"]["cells_launches"] = launches[
            "candidate_topk"]
        out["tables"] = tabs
        for arch in CELLS_ARCHS:
            cfg = get_arch(arch)[0]
            params = recsys.init(cfg, seed=0, device=dev)
            n_cand = get_shape("recsys", "retrieval_cand")["n_candidates"]
            rb = retrieval_batch(cfg, batch_for(cfg, 1, 0), n_cand)
            rcell = cells.build_cell(cfg, "recsys", plan,
                                     get_shape("recsys", "retrieval_cand"))
            placed = rcell.place((params, rb), dev)
            s, c = rcell.step_fn(*placed)
            ps, pc = recsys.retrieval_logits(params, rb, cfg, LOCAL_PLAN,
                                             k=RETRIEVAL_K)
            torch.cuda.synchronize()
            require(torch.equal(c, pc), f"[cells] world-1 {arch} retrieval "
                    "ids differ from the unsharded step")
            err = float((s - ps).abs().max())
            bound = 1e-5 * max(float(ps.abs().max()), 1.0)
            require(err <= bound, f"[cells] world-1 {arch} retrieval "
                    f"scores off by {err} (bound {bound})")
            ms = time_ms(lambda: rcell.step_fn(*placed), 3, warmup=1)
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rcell.step_fn(*placed)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            bits = bool(torch.equal(s.view(torch.int32),
                                    ps.view(torch.int32)))
            out[arch] = {"max_abs_err": err, "bit_for_bit": bits, "ms": ms,
                         "step_peak_bytes": peak}
            log(f"[cells] world-1 {arch} retrieval_cand (1 x {n_cand} "
                f"candidates at full width, k {RETRIEVAL_K}): ids equal to "
                f"the unsharded retrieval_logits, scores max abs err "
                f"{err:.3e} (bit for bit {bits}); {ms:.1f} ms a call; step "
                f"peak {peak} B above its arguments")
            del params, placed, s, ps
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def _cells_padded(params, shapes):
    """``params`` with every leaf zero-padded to the (2, 2) cell's shape
    (SASRec's item table rounds its rows up to a multiple of tp; the rows
    past the items are never read)."""
    if isinstance(params, dict):
        return {k: _cells_padded(v, shapes[k]) for k, v in params.items()}
    pad = tuple(shapes.shape)
    if tuple(params.shape) == pad:
        return params
    out = params.new_zeros(pad)
    out[tuple(slice(0, n) for n in params.shape)] = params
    return out


def cells_rank(rank: int, world: int, workdir: str, device: str) -> None:
    """One of the four ranks sharing the card under gloo on a (2, 2) mesh:
    the ANN cell and the DIN and SASRec retrieval cells through the
    port's cells, each answer written for the parent."""
    import torch.distributed as dist

    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_plan, make_test_mesh

    dev = torch.device(device)
    require(dev.type == "cuda", f"[cells] gloo rank {rank} needs the card")
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    t_all = time.perf_counter()
    try:
        plan = make_plan(make_test_mesh((2, 2), ("data", "model"),
                                        device_type="cuda"))
        cell = cells.build_cell(SIFT_1M, "ann", plan,
                                get_shape("ann", "serve_batch"))
        host = {k: np.load(os.path.join(workdir, f"{k}.npy"), mmap_mode="r")
                for k in ("corpus", "cents", "bids", "q")}
        b = torch.as_tensor(np.array(host["bids"]), device=dev)
        db = torch.as_tensor(np.array(host["corpus"]), device=dev)
        vecs = db[torch.clamp(b, min=0).long()]
        vecs.masked_fill_((b < 0)[..., None], 0.0)
        del db
        args = cell.place((np.array(host["cents"]), b, vecs,
                           np.array(host["q"])), dev)
        del b, vecs
        torch.cuda.empty_cache()
        reset_launches()
        d, i = cell.step_fn(*args)
        torch.cuda.synchronize()
        out = {"rank": rank, "launches": read_launches(),
               "ann": (d.cpu().numpy(), i.cpu().numpy()),
               "ann_ms": time_ms(lambda: cell.step_fn(*args), 5, warmup=1)}
        del args
        for arch in CELLS_ARCHS:
            cfg = get_arch(arch)[0]
            saved = torch.load(os.path.join(workdir, f"{arch}.pt"),
                               map_location="cpu")
            rcell = cells.build_cell(cfg, "recsys", plan,
                                     get_shape("recsys", "retrieval_cand"))
            placed = rcell.place((saved["params"], saved["batch"]), dev)
            s, c = rcell.step_fn(*placed)
            torch.cuda.synchronize()
            out[arch] = (s.cpu().numpy(), c.cpu().numpy())
            del placed, saved
        out["wall_s"] = time.perf_counter() - t_all
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def cells_gloo4(dev, ctx, tabs, smi: str) -> dict:
    """The one-process merges on the card, then four gloo ranks sharing it
    (spawned), each held against them bit for bit."""
    import torch.multiprocessing as mp
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import SINGLE_POD_PLAN

    workdir = tempfile.mkdtemp(prefix="cells-gloo4-", dir=OUT_DIR)
    shape_plan = SINGLE_POD_PLAN.with_mesh(SimpleNamespace(
        mesh_dim_names=("data", "model"), mesh=torch.zeros((2, 2))))
    out = {}
    try:
        q = torch.as_tensor(ctx["queries"][:CELLS_B], device=dev)
        want = {"ann": tuple(t.cpu().numpy() for t in _cells_merged(
            tabs, q, CELLS_WORLD))}
        for name, a in (("corpus", ctx["corpus"]),
                        ("cents", tabs[0].cpu().numpy()),
                        ("bids", tabs[1].cpu().numpy()),
                        ("q", ctx["queries"][:CELLS_B])):
            np.save(os.path.join(workdir, f"{name}.npy"), a)
        n_cand = get_shape("recsys", "retrieval_cand")["n_candidates"]
        for arch in CELLS_ARCHS:
            cfg = get_arch(arch)[0]
            params = _cells_padded(recsys.init(cfg, seed=0, device=dev),
                                   recsys.param_shapes(cfg, shape_plan))
            rb = retrieval_batch(cfg, batch_for(cfg, 1, 0), n_cand)
            want[arch] = tuple(t.cpu().numpy() for t in
                               _cells_retrieval_merged(params, rb, cfg,
                                                       CELLS_WORLD))
            torch.save({"params": tree_map(lambda t: t.cpu(), params),
                        "batch": {k: torch.as_tensor(v)
                                  for k, v in rb.items()}},
                       os.path.join(workdir, f"{arch}.pt"))
            del params
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=cells_rank,
                               args=(r, CELLS_WORLD, workdir, str(dev)))
                 for r in range(CELLS_WORLD)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + CELLS_LIMIT_S
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        require(not hung, f"[cells] ranks {hung} outlived {CELLS_LIMIT_S} s")
        codes = [p.exitcode for p in procs]
        require(all(c == 0 for c in codes),
                f"[cells] a rank failed: exit codes {codes}")
        out["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(CELLS_WORLD):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for r in ranks:
        require(r["launches"]["candidate_topk"] > 0,
                f"[cells] gloo rank {r['rank']} launched no candidate_topk")
        for name in ("ann",) + CELLS_ARCHS:
            for got, exp in zip(r[name], want[name]):
                require(got.dtype == exp.dtype and np.array_equal(
                    got.view(np.uint8), exp.view(np.uint8)),
                    f"[cells] gloo rank {r['rank']} {name} differs from the "
                    "one-process merge")
    recall = recall_at_k(ranks[0]["ann"][1], ctx["truth"][:CELLS_B])
    n_cand = get_shape("recsys", "retrieval_cand")["n_candidates"]
    out.update(recall_at_10=recall,
               ann_ms=[r["ann_ms"] for r in ranks],
               wall_s=[r["wall_s"] for r in ranks],
               peak_bytes=[r["peak_bytes"] for r in ranks],
               launches=[r["launches"] for r in ranks])
    log(f"[cells] four gloo ranks on one card, (2, 2) mesh: the sift-1m ANN "
        f"cell ({SIFT_1M.n_clusters // CELLS_WORLD} buckets a rank, "
        f"nprobe_local {SIFT_1M.nprobe // CELLS_WORLD}, B {CELLS_B}) and "
        f"DIN and SASRec retrieval_cand ({n_cand} candidates, "
        f"{n_cand // CELLS_WORLD} a rank) "
        f"bit for bit against the four shards run on one card and merged "
        f"(_merge_gathered / the joined scores' top {RETRIEVAL_K}), on "
        f"every rank; ANN recall@10 {recall:.4f}; rank ANN ms "
        f"{[round(x, 2) for x in out['ann_ms']]}; launches "
        f"{out['launches']}; wall {out['ranks_s']:.1f} s; {smi}")
    return out


def phase_cells(dev, ctx, card) -> dict:
    """The cells never run over a mesh before (the ANN cell, the DIN and
    SASRec retrieval cells), on a world-1 NCCL mesh and on four gloo
    ranks sharing the card, and the dry run of ``launch/dryrun.py`` in a
    subprocess on this machine's torch, its peaks held against the
    card's."""
    smi = card["nvidia_smi"]
    t0 = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-c", _CELLS_DRYRUN, json.dumps(CELLS_DRYRUN)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    try:
        world1 = cells_world1(dev, ctx, smi)
        tabs = world1.pop("tables")
        gloo = cells_gloo4(dev, ctx, tabs, smi)
        del tabs
        gc.collect()
        torch.cuda.empty_cache()
        out_s, err_s = dry.communicate(timeout=max(
            1.0, CELLS_DRYRUN_LIMIT_S - (time.perf_counter() - t0)))
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    require(dry.returncode == 0, f"[cells] the dry run failed: "
            f"{err_s[-3000:]}")
    res = json.loads(out_s.strip().splitlines()[-1])
    for c in res["cells"]:
        require(c["status"] == "ok", f"[cells] dry run {c['arch']} "
                f"{c['shape']} {c['mesh']}: {c['status']} {c['error']}")
        log(f"[cells] dry run (meta counts, torch {res['torch']} on this "
            f"machine's CPU) {c['arch']} {c['shape']} {c['mesh']}: ok; "
            f"argument_bytes {c['memory']['argument_bytes']} peak_bytes "
            f"{c['memory']['peak_bytes']}, matmul_flops "
            f"{c['matmul_flops']:.4e}, collective bytes "
            f"{c['collective_bytes']['total']}; step {c['times']['step_s']} s")
    ratios = {}
    for c in res["cells"]:
        if c["mesh"] != "1x1":
            continue
        name = "ann" if c["arch"] == "sift-1m" else c["arch"]
        card_peak = world1[name]["step_peak_bytes"]
        ratios[name] = c["memory"]["peak_bytes"] / max(card_peak, 1)
        log(f"[cells] memory, world-1 {c['arch']} {c['shape']}: dry-run "
            f"peak_bytes {c['memory']['peak_bytes']} against the card's "
            f"max_memory_allocated above the step's arguments {card_peak} "
            f"B: ratio {ratios[name]:.3f}")
        require(PEAK_RATIO[0] <= ratios[name] <= PEAK_RATIO[1],
                f"[cells] {name}: dry-run peak over the card's "
                f"{ratios[name]:.3f} outside {PEAK_RATIO}")
    out = {"world1": world1, "gloo4": gloo, "dry_run": res,
           "peak_ratio": ratios, "s": time.perf_counter() - t0}
    log(f"[cells] phase {out['s']:.1f} s; {smi}")
    RESULTS["cells"] = out
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
                      "popc_each_word_ms", "fp32_rate_bound_ms",
                      "models_launches", "cells_launches"):
            if extra in r:
                row[extra] = r[extra]
        if "eight_terms" in r:
            row["ms_t8"] = r["eight_terms"]["ms"]
        if "k100" in r:
            row.update(ms_k100=r["k100"]["ms"],
                       passes_k100=r["k100"]["passes"])
        for part in ("step", "deep", "rows", "kd64", "kd128", "radio"):
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
    install_compile_hooks()
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
    with phase("fleet"):
        phase_fleet(dev, ctx)
    with phase("analysis"):
        phase_analysis(ctx)
    with phase("cells and dry run"):
        phase_cells(dev, ctx, card)
    ctx.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] before the phase: memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    with phase("lm"):
        phase_lm(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[models] before the phase: memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    with phase("models"):
        phase_models(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] before the phase: memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    with phase("train"):
        phase_train(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sharded models] before the phase: memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    with phase("sharded models"):
        phase_sharded_models(dev, card)
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
