"""The dry run (``launch/dryrun.py``) and the step accounting
(``launch/step_analysis.py``) on the CPU.

1. the ``meta`` branch of every kernel op: the shapes and dtypes of the
   CPU outputs at several ``k`` (past the candidate count too), and the
   plain version's dot products seen by a FLOP counter;
2. ``analyze_step`` on small hand-built steps, mirroring
   ``tests/test_hlo_analysis.py``: matmul FLOPs (a loop counted as it
   runs), views and allocations skipped in the byte proxy, peak liveness
   freeing a buffer after its last use (a long sort's workspace held
   while it runs); in a subprocess on a fake
   ``(2, 2)`` process group, the moves' bytes by kind (an all-reduce
   doubled, a ``Shard -> Shard`` move counting its gather under
   ``all-to-all`` beside a true all-to-all's bytes) and DTensor's own
   all-reduce;
3. each of ``tests/test_dryrun_lowering.py::CASES`` (11 cells at the
   production meshes, 256 and 512 ranks), each in its own subprocess with
   a time limit, all started together: ``ok``, and rank 0's argument
   bytes equal to the reference's to the byte (the sum over its
   ``in_shardings`` of ``shard_shape(arg.shape)`` x itemsize, built on
   512 fake XLA devices without lowering);
4. beside each case, printed, the reference's compiled program at the
   production mesh (FLOPs, collective bytes, temp bytes), and bounded:
   the cells whose work the port splits over tp as the reference does
   (qwen3-0.6b ``train_4k``: the query heads with K and V whole and the
   vocabulary-parallel loss, at most 1.15x the reference's matmul FLOPs
   and a peak of 4.0e10 bytes; qwen3-14b ``prefill_32k``: the queries
   over their sequence shard, 1.10x; DLRM ``train_batch`` and DCN-v2
   ``serve_p99``: the tables and large MLP layers at their placements,
   1.10x, DCN-v2's all-gather at most 1.2e8 bytes, DLRM's collective
   bytes at most the reference's with its tuple-typed collectives
   counted), each of these at least the reference's count less the work
   its compiled program repeats on every rank of a model row, and every
   other case within 2 % of its ratio in PERF.md §6;
5. at ``(2, 2)`` on ``reduced()`` configs, the port's ``matmul_flops``
   against the reference's ``analyze_hlo(compiled.as_text())`` on 4 fake
   XLA devices: the forward cells within 2 %, DLRM's train cell at most
   1.05x; the other train cells' ratios printed (ROADMAP fault 24:
   torch's checkpoint recomputes a whole layer).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_dryrun_lowering import CASES
from test_torch_reference import REPO

from repro_torch.kernels import ops
from repro_torch.launch.step_analysis import analyze_step

CASE_LIMIT_S = 600
REF_LIMIT_S = 600
FORWARD_TOL = 0.02


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.path.join(REPO, "tests")]))


# ------------------------------------------------------ the meta branch


def _op_inputs(n: int, b: int = 3, d: int = 8):
    """Every op's positional inputs and keywords on the CPU."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a)                         # noqa: E731
    q = t(rng.standard_normal((b, d)).astype(np.float32))
    x = t(rng.standard_normal((n, d)).astype(np.float32))
    codes, scales = ops.quantize_rows_int8(x.numpy())
    vecs = t(rng.standard_normal((b, n, d)).astype(np.float32))
    ids = t(rng.integers(-1, 50, (b, n)).astype(np.int32))
    K, cap = 4, 5
    bids = t(np.arange(K * cap, dtype=np.int32).reshape(K, cap))
    bvecs = t(rng.standard_normal((K, cap, d)).astype(np.float32))
    probe = t(rng.integers(0, K, (b, 2)).astype(np.int32))
    qt = t(rng.integers(0, 6, (b, 2)).astype(np.int32))
    qw = t(rng.random((b, 2)).astype(np.float32))
    terms = t(rng.integers(-1, 6, (n, 3)).astype(np.int32))
    tf = t(rng.random((n, 3)).astype(np.float32))
    lut = t(rng.random((b, 2, 256)).astype(np.float32))
    pq = t(rng.integers(0, 256, (n, 2)).astype(np.uint8))
    hq = t(rng.integers(0, 2**31, (b, 2)).astype(np.int32))
    hc = t(rng.integers(0, 2**31, (n, 2)).astype(np.int32))
    alpha = torch.full((1, 1), 0.5)
    return {
        "l2_topk_op": ((q, x), {}),
        "l2_topk_int8_op": ((q, t(codes), t(scales)), {}),
        "candidate_topk_op": ((q, vecs, ids), {}),
        "candidate_rows_topk_op": ((q, x, ids), {}),
        "bucket_probe_topk_op": ((q, probe, bids), {"bucket_vecs": bvecs}),
        "bm25_topk_op": ((qt, qw, terms, tf), {}),
        "hybrid_topk_op": ((q, x, qt, qw, terms, tf, alpha), {}),
        "pq_adc_topk_op": ((lut, pq), {}),
        "hamming_topk_op": ((hq, hc), {}),
    }


def _to_meta(v):
    return v.to("meta") if isinstance(v, torch.Tensor) else v


OPS = sorted(_op_inputs(7))


@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("name", OPS)
def test_meta_branch_is_the_result_contract(name, k):
    """On ``meta`` every op returns the CPU result's shapes and dtypes
    (``k`` past the 7 candidates padded back, as the kernels pad it),
    with no storage and no kernel or plain version run."""
    args, kw = _op_inputs(7)[name]
    fn = getattr(ops, name)
    cpu = fn(*args, k, **kw)
    meta = fn(*map(_to_meta, args), k,
              **{a: _to_meta(v) for a, v in kw.items()})
    for c, m in zip(cpu, meta):
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(c.shape), c.dtype)
        assert tuple(m.shape) == (3, k)


@pytest.mark.parametrize("name", OPS)
def test_meta_branch_counts_the_plain_versions_products(name):
    """A FLOP counter sees on ``meta`` the matmul FLOPs the plain version
    spends on the CPU: the candidates' dot products (none for the BM25,
    PQ and Hamming scans)."""
    args, kw = _op_inputs(7)[name]
    fn = getattr(ops, name)
    counts = []
    for conv in (lambda v: v, _to_meta):
        with FlopCounterMode(display=False) as fc:
            fn(*map(conv, args), 4, **{a: conv(v) for a, v in kw.items()})
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1]
    assert (counts[0] > 0) == (name not in ("bm25_topk_op", "pq_adc_topk_op",
                                            "hamming_topk_op"))


def test_meta_branch_leaves_other_devices_to_the_kernel_or_raises():
    q = torch.zeros((2, 4))
    assert ops._shape_only(q, 3) is None
    with pytest.raises(ValueError, match="no kernel path"):
        ops._on_card(torch.device("xpu"))


# ------------------------------------------------ analyze_step, by hand


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_matmul_flops_count_every_iteration():
    """A loop of 12 products counts 12 times (the reference weights its
    while body by the trip count; here the loop simply runs)."""
    def step(lhs, rhs):
        out = None
        for _ in range(12):
            out = lhs @ rhs
        return out

    a = analyze_step(step, (_meta(8, 64), _meta(64, 32)))["analysis"]
    assert a["matmul_flops"] == 2.0 * 8 * 32 * 64 * 12
    assert a["matmul_flops_by_op"] == {"aten.mm": 2 * 8 * 32 * 64 * 12}


def test_bmm_and_addmm_counted():
    def step(x, y, b):
        return torch.bmm(x, y), torch.addmm(b, x[0], y[0])

    a = analyze_step(step, (_meta(3, 4, 8), _meta(3, 8, 5),
                            _meta(4, 5)))["analysis"]
    assert a["matmul_flops"] == 2.0 * 3 * 4 * 5 * 8 + 2.0 * 4 * 5 * 8


def test_mem_proxy_skips_views_and_allocations():
    """Only the copy streams: 2 x 1,024 bytes read and written; the
    views, the transpose and the empty allocation add nothing."""
    def step(x):
        v = x.view(16, 16).t()[2:]
        torch.empty(1000, device=x.device)
        return x.clone(), v

    a = analyze_step(step, (_meta(256),))["analysis"]
    assert a["mem_bytes_proxy"] == 2.0 * 1024


def test_peak_liveness_frees_after_last_use():
    """Two 4 MiB buffers overlap at most (a + b), never three; the
    arguments are not counted."""
    def step(p):
        a = p.clone()
        b = a + a
        del a
        c = b * b
        del b
        return c.clone()

    a = analyze_step(step, (_meta(1048576),))["analysis"]
    pk = a["peak_liveness"]
    assert pk["peak_bytes"] == 2 * 4 * 1048576
    assert {n for n, _, _ in pk["top_buffers"]} == {"aten.clone", "aten.add"}
    assert {tuple(s) for _, _, s in pk["top_buffers"]} == {(1048576,)}


def test_peak_liveness_agrees_with_memtracker():
    """torch's own ``MemTracker`` over the same step on ``meta`` finds the
    same peak of the storages the step makes."""
    from torch.distributed._tools.mem_tracker import MemTracker

    def step(p):
        a = p.clone()
        b = a + a
        c = b @ a.T
        del a
        return c.sum() + b.sum()

    x = _meta(512, 256)
    mine = analyze_step(step, (x,))["analysis"]["peak_liveness"]
    mt = MemTracker()
    with mt:
        step(x)
    assert mine["peak_bytes"] == mt.get_tracker_snapshot("peak")[
        torch.device("meta")]["Total"]


def test_peak_liveness_in_place_ops_make_nothing():
    def step(x):
        y = x.clone()
        y.add_(1.0).mul_(2.0)
        return y

    a = analyze_step(step, (_meta(1024),))["analysis"]
    assert a["peak_liveness"]["peak_bytes"] == 4096
    assert a["mem_bytes_proxy"] == 3 * 2.0 * 4096


def test_a_long_sort_holds_the_cards_workspace():
    """A sort along more than ``SMALL_SORT`` columns also holds its
    values' bytes and twice its indices' while it runs (the card's
    segmented radix sort); a short one sorts in place."""
    from repro_torch.launch.step_analysis import SMALL_SORT

    def step(x):
        return torch.sort(x + 0.0, dim=1, stable=True)

    for cols, workspace in ((SMALL_SORT + 4, True), (SMALL_SORT, False)):
        n = 4 * cols
        pk = analyze_step(step, (_meta(4, cols),))["analysis"][
            "peak_liveness"]
        # x + 0.0, the values, the int64 indices (and the workspace)
        assert pk["peak_bytes"] == 4 * n + 4 * n + 8 * n + (
            4 * n + 16 * n if workspace else 0)


_COLLECTIVES = """
import json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.distributed import sharding
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.step_analysis import analyze_step

out = {}
with fake_world(4):
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    x = torch.empty((8, 16), device="meta")          # 512 bytes whole
    part = DTensor.from_local(x, mesh, [Partial(), Partial()],
                              run_check=False)
    sh = DTensor.from_local(torch.empty((4, 16), device="meta"), mesh,
                            [Shard(0), Replicate()], run_check=False)
    odd = DTensor.from_local(torch.empty((1, 3), device="meta"), mesh,
                             [Replicate(), Shard(0)], run_check=False,
                             shape=(1, 3), stride=(3, 1))
    steps = {
        "all_reduce": lambda t: sharding.move(t, [Replicate(), Replicate()]),
        "all_gather": lambda t: sharding.move(t, [Replicate(), Replicate()]),
        "all_to_all": lambda t: sharding.move(t, [Shard(1), Replicate()]),
        "dtensor": lambda t: t.redistribute(mesh, [Replicate(),
                                                    Replicate()]),
        "uneven": lambda t: sharding.move(t, [Replicate(), Replicate()]),
    }
    args = {"all_reduce": part, "all_gather": sh, "all_to_all": sh,
            "dtensor": part, "uneven": odd}
    for name, fn in steps.items():
        r = analyze_step(fn, (args[name],))
        a = r["analysis"]
        out[name] = {"bytes": a["collective_bytes"],
                     "counts": a["collective_counts"],
                     "exchange": a["all_to_all_exchange_bytes"],
                     "moves": a["moves"],
                     "local": list(r["out"].to_local().shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                       capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_all_reduce_is_doubled(collectives):
    """A partial sum over both mesh dims reduced to replicated: two
    all-reduces of the (8, 16) float32 value, each counted twice its
    512 result bytes."""
    c = collectives["all_reduce"]
    assert c["bytes"]["all-reduce"] == 2 * 2 * 512
    assert c["counts"]["all-reduce"] == 2
    assert c["bytes"]["total"] == 2 * 2 * 512
    assert c["moves"] == {"all_reduce": 2}


def test_all_gather_counts_its_result(collectives):
    """Rows over ``data`` gathered: the (8, 16) result, 512 bytes."""
    c = collectives["all_gather"]
    assert c["bytes"]["all-gather"] == 512
    assert c["counts"]["all-gather"] == 1
    assert c["local"] == [8, 16]


def test_shard_to_shard_counts_its_gather_as_all_to_all(collectives):
    """Rows over ``data`` to columns over ``data``: the port gathers the
    whole (8, 16) and cuts it (ROADMAP fault 22), 512 bytes under
    ``all-to-all``, where a true all-to-all's result is the 256-byte
    local shard."""
    c = collectives["all_to_all"]
    assert c["bytes"]["all-to-all"] == 512
    assert c["exchange"] == 256
    assert c["local"] == [8, 8]
    assert c["moves"] == {"all_to_all": 1}


def test_dtensors_own_all_reduce_is_seen(collectives):
    c = collectives["dtensor"]
    assert c["bytes"]["all-reduce"] == 2 * 2 * 512
    assert c["counts"]["all-reduce"] == 2


def test_uneven_shard_gathers_padded_and_trims(collectives):
    """One row over a mesh dim of two: each rank sends a chunk of one row
    (the empty one padded), the gathered two rows trimmed to the one."""
    c = collectives["uneven"]
    assert c["local"] == [1, 3]
    assert c["bytes"]["all-gather"] == 2 * 3 * 4


# ------------------------------------------- the cells, port and reference


_REF = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import warnings; warnings.filterwarnings("ignore")
import importlib
import numpy as np
import jax
from test_torch_reference import reference_modules
from test_dryrun_lowering import CASES


def tuple_collective_bytes(hlo, txt, trips):
    # the collectives with a tuple-typed result (XLA's combiners merge
    # several into one), which analyze_hlo reads as 0 bytes: weighted and
    # the all-reduce doubled as it weighs the others
    comps, entry = hlo._split_computations(txt)
    n = 0.0
    for cname, w in {entry: 1.0, **trips}.items():
        for s in comps[cname]:
            mi = hlo._INSTR_RE.match(s)
            if not mi or not mi.group(2).startswith("("):
                continue
            head, _, rest = mi.group(2).partition(") ")
            op = rest.split("(", 1)[0].strip()
            base = op.replace("-start", "")
            if base in hlo._COLLECTIVES and not op.endswith("-done"):
                n += (2.0 if base == "all-reduce" else 1.0) * w * sum(
                    hlo._shape_elems(g.group(2)) * hlo._DTYPE_BYTES[g.group(1)]
                    for g in hlo._SHAPE_RE.finditer(head))
    return n


out = {}
with reference_modules() as ref:
    mesh_mod = importlib.import_module("repro.launch.mesh")
    hlo = importlib.import_module("repro.launch.hlo_analysis")
    auto = jax.sharding.AxisType.Auto
    m4 = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
    is_sh = lambda x: isinstance(x, jax.sharding.NamedSharding)
    for arch, shape, m in CASES:
        cfg, fam = ref.registry.get_arch(arch)
        sh = ref.registry.get_shape(fam, shape)
        mesh = mesh_mod.make_production_mesh(multi_pod=(m == "multi"))
        cell = ref.cells.build_cell(cfg, fam, mesh_mod.make_plan(mesh), sh)
        args = jax.tree.leaves(cell.args)
        shs = jax.tree.leaves(cell.in_shardings, is_leaf=is_sh)
        assert len(args) == len(shs)
        nb = sum(int(np.prod(s.shard_shape(a.shape)))
                 * np.dtype(a.dtype).itemsize for a, s in zip(args, shs))
        with mesh:
            comp = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings,
                           donate_argnums=cell.donate).lower(
                *cell.args).compile()
        prod = hlo.analyze_hlo(comp.as_text())
        tup = tuple_collective_bytes(hlo, comp.as_text(),
                                     prod["while_trip_multipliers"])
        c4 = ref.cells.build_cell(cfg.reduced(), fam,
                                  mesh_mod.make_plan(m4), sh)
        with m4:
            txt = jax.jit(c4.step_fn, in_shardings=c4.in_shardings,
                          out_shardings=c4.out_shardings,
                          donate_argnums=c4.donate).lower(
                *c4.args).compile().as_text()
        out["|".join((arch, shape, m))] = {
            "argument_bytes": nb,
            "matmul_flops": prod["matmul_flops"],
            "collective_bytes": prod["collective_bytes"]["total"],
            "tuple_collective_bytes": tup,
            "temp_bytes": int(comp.memory_analysis().temp_size_in_bytes),
            "matmul_flops_22": hlo.analyze_hlo(txt)["matmul_flops"]}
print(json.dumps(out))
"""

_CELL = """
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import run_cell
rec = run_cell(sys.argv[1], sys.argv[2], sys.argv[3] == "multi",
               verbose=False)
a = rec.get("analysis", {})
print(json.dumps({"status": rec["status"], "error": rec.get("error"),
                  "traceback": rec.get("traceback"),
                  "memory": rec.get("memory"),
                  "matmul_flops": a.get("matmul_flops"),
                  "collective_bytes": a.get("collective_bytes", {}).get(
                      "total"),
                  "all_gather_bytes": a.get("collective_bytes", {}).get(
                      "all-gather")}))
"""

_CELLS_22 = """
import json, torch
torch.set_num_threads(1)
from test_dryrun_lowering import CASES
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import run_cell

out = {}
for arch, shape, m in CASES:
    rec = run_cell(arch, shape, mesh_shape=(2, 2),
                   cfg=get_arch(arch)[0].reduced(), verbose=False)
    out["|".join((arch, shape, m))] = {
        "status": rec["status"], "error": rec.get("error"),
        "matmul_flops_22": rec.get("analysis", {}).get("matmul_flops")}
print(json.dumps(out))
"""


def _key(case) -> str:
    return "|".join(case)


@pytest.fixture(scope="module")
def cells():
    """The reference's subprocess, one port subprocess a case at the
    production mesh and one for the (2, 2) runs, all started together;
    ``{"ref": {...}, "port": {case: record}, "port22": {...}}``."""
    def start(code, *argv):
        return subprocess.Popen([sys.executable, "-c", code, *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=_env(), cwd=REPO)

    ref = start(_REF)
    port22 = start(_CELLS_22)
    procs = {_key(c): start(_CELL, *c) for c in CASES}

    def last_json(p, limit):
        try:
            out, err = p.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            return {"status": "error", "error": f"timed out after {limit} s"}
        if p.returncode != 0:
            return {"status": "error", "error": err[-3000:]}
        return json.loads(out.strip().splitlines()[-1])

    try:
        port = {k: last_json(p, CASE_LIMIT_S) for k, p in procs.items()}
        res = {"ref": last_json(ref, REF_LIMIT_S),
               "port22": last_json(port22, CASE_LIMIT_S), "port": port}
    finally:
        for p in [ref, port22, *procs.values()]:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert "status" not in res["ref"], res["ref"].get("error")
    assert "status" not in res["port22"], res["port22"].get("error")
    return res


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_cell_dry_runs_ok_at_the_production_mesh(cells, case):
    rec = cells["port"][_key(case)]
    assert rec["status"] == "ok", rec.get("error") or rec.get("traceback")
    m = rec["memory"]
    assert m["per_device_total"] == m["argument_bytes"] + m["peak_bytes"]
    assert m["peak_bytes"] > 0 and m["output_bytes"] > 0


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_argument_bytes_equal_the_reference(cells, case):
    rec = cells["port"][_key(case)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_bytes"] == \
        cells["ref"][_key(case)]["argument_bytes"]


# at the production mesh, rank 0 against the reference's compiled
# program: the matmul FLOPs ratio's floor and ceiling and, where set, the
# port's peak, all-gather bytes and collective bytes against the
# reference's.  The cells whose work the port splits over tp as the
# reference does carry their own ceilings and floors.  A floor is the
# reference's count less the work its compiled program repeats on every
# rank of a model row (``tools/dryrun_vs_reference.py``, PERF.md §6),
# less 1 %: qwen3-0.6b 0.840 (it projects K for all eight KV heads where
# a rank's query head reads one), qwen3-14b 0.895 (it projects one of K
# and V over the whole gathered sequence), DLRM 0.712 (the top MLP's
# first layer and the bottom MLP's last input gradient whole on every
# rank).  Every other case keeps within 2 % of its ratio in PERF.md §6,
# either way (kimi-k2's 1.266: its experts' all-to-all, ROADMAP fault
# 22; DIN's 1.003).  DLRM's collective bytes may not pass the
# reference's with its tuple-typed collectives counted (its table's
# update all-reduced over dp).
def _near(r):
    return dict(flops=r * 1.02, flops_min=r * 0.98)


PRODUCTION_BOUNDS = {
    "qwen3-0.6b|train_4k|single": dict(flops=1.15, flops_min=0.840 * 0.99,
                                       peak=4.0e10),
    "qwen3-14b|prefill_32k|single": dict(flops=1.10, flops_min=0.895 * 0.99),
    "dlrm-mlperf|train_batch|single": dict(flops=1.10, flops_min=0.712 * 0.99,
                                           collectives=1.0),
    "dcn-v2|serve_p99|multi": dict(flops=1.10, flops_min=0.98,
                                   all_gather=1.2e8),
    "deepseek-v3-671b|decode_32k|single": _near(1.000),
    "kimi-k2-1t-a32b|train_4k|multi": _near(1.266),
    "schnet|ogb_products|multi": _near(1.000),
    "schnet|minibatch_lg|single": _near(1.000),
    "din|retrieval_cand|multi": _near(1.003),
    "sasrec|serve_bulk|single": _near(1.000),
    "sift-1m|serve_batch|single": _near(1.000),
}


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_production_counts_beside_the_reference(cells, case):
    """Rank 0's matmul FLOPs, collective bytes and peak beside the
    reference's compiled program at the production mesh (its
    ``analyze_hlo``, the bytes of its tuple-typed collectives, which
    ``analyze_hlo`` counts as 0, and ``memory_analysis()``'s temp bytes),
    printed (PERF.md §6 reads these lines) and held to
    ``PRODUCTION_BOUNDS``."""
    mine, theirs = cells["port"][_key(case)], cells["ref"][_key(case)]
    assert mine["status"] == "ok", mine.get("error")
    assert theirs["matmul_flops"] > 0
    ratio = mine["matmul_flops"] / theirs["matmul_flops"]
    ref_coll = theirs["collective_bytes"] + theirs["tuple_collective_bytes"]
    print(f"{_key(case)} production: matmul_flops port "
          f"{mine['matmul_flops']:.4e} reference {theirs['matmul_flops']:.4e}"
          f" (x{ratio:.3f}); "
          f"collective bytes port {mine['collective_bytes']} reference "
          f"{int(theirs['collective_bytes'])} (with its tuple-typed "
          f"collectives {int(ref_coll)}); all-gather port "
          f"{mine['all_gather_bytes']}; peak port "
          f"{mine['memory']['peak_bytes']} reference temp "
          f"{theirs['temp_bytes']}")
    bound = PRODUCTION_BOUNDS[_key(case)]
    assert bound["flops_min"] <= ratio <= bound["flops"], (ratio, bound)
    assert mine["memory"]["peak_bytes"] <= bound.get("peak", float("inf"))
    assert mine["all_gather_bytes"] <= bound.get("all_gather", float("inf"))
    assert mine["collective_bytes"] <= bound.get("collectives",
                                                 float("inf")) * ref_coll


FORWARD = [c for c in CASES
           if c[1] in ("prefill_32k", "decode_32k", "serve_bulk",
                       "serve_p99", "retrieval_cand", "serve_batch")]
TRAIN = [c for c in CASES if c not in FORWARD]


@pytest.mark.parametrize("case", FORWARD, ids=_key)
def test_forward_flops_match_the_reference_at_2x2(cells, case):
    mine = cells["port22"][_key(case)]
    assert mine["status"] == "ok", mine["error"]
    theirs = cells["ref"][_key(case)]["matmul_flops_22"]
    ratio = mine["matmul_flops_22"] / theirs
    print(f"{_key(case)} (2, 2) matmul_flops port / reference {ratio:.4f}")
    assert abs(ratio - 1.0) <= FORWARD_TOL


# the train cells at (2, 2) whose ratio is bounded: DLRM's step splits
# its table's columns, its interaction and the MLP layers over tp as the
# reference does
TRAIN_BOUNDS = {"dlrm-mlperf|train_batch|single": 1.05}


@pytest.mark.parametrize("case", TRAIN, ids=_key)
def test_train_flops_ratio_at_2x2(cells, case):
    """Printed, and bounded where ``TRAIN_BOUNDS`` says: the LM train
    cells' excess is torch's checkpoint recomputing a whole layer where
    XLA's remat drops what the backward never reads (ROADMAP fault 24);
    PERF.md §6 reads each ratio."""
    mine = cells["port22"][_key(case)]
    assert mine["status"] == "ok", mine["error"]
    theirs = cells["ref"][_key(case)]["matmul_flops_22"]
    ratio = mine["matmul_flops_22"] / theirs
    print(f"{_key(case)} (2, 2) matmul_flops port / reference {ratio:.4f}")
    assert 0 < ratio <= TRAIN_BOUNDS.get(_key(case), float("inf"))


def test_cli_writes_records_and_serves_the_cache(tmp_path):
    """``--arch/--shape/--mesh/--out``: the record written, exit 0, a
    second run served from the cache."""
    out = tmp_path / "dry.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "sift-1m", "--shape", "serve_batch", "--mesh", "single",
           "--out", str(out)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text())["sift-1m|serve_batch|single"]
    assert rec["status"] == "ok" and rec["mesh"] == "single_pod_16x16"
    assert "nprobe_local=1" in rec["note"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0
    assert "[cached] sift-1m|serve_batch|single" in r.stdout


def test_long_context_is_a_listed_skip():
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("qwen3-0.6b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
