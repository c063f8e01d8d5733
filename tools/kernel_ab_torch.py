"""The tree descent, the sketch update, the rows-by-id top-k and the LSH
probe scan kernels against a baseline's sources, timed in turns on one
card.

    python tools/kernel_ab_torch.py --baseline DIR [--out FILE]
                                    [--lsh-ablation] [--lsh-spans]

``DIR`` holds any of ``tree_descent.cu``, ``count_min.cu``,
``candidate_topk.cu`` and ``lsh_probe.cu`` (an earlier commit's
``src/repro_torch/kernels/csrc/``, e.g. by ``git show``); the shapes of
each kernel it holds are timed.  The first two must have the current
launchers' signatures: the wrappers (``tree_descent.tree_descent``,
``count_min.count_min_update``) call one build or the other, so each call
does the same host work.  ``candidate_topk.cu``'s rows entry is the
first design's (a scan and a merge launch handing over per-block
partial lists, allocated a pass as its wrapper did:
``rows_first_design``); the current one is
``bucket_topk.candidate_rows_topk``.  ``lsh_probe.cu`` is the first
design's (every slot of P cap read, no extents: ``lsh_first_design``);
the current one is ``lsh_probe.lsh_probe_shortlist``.  All are built with the port's nvcc
flags (headers from the current ``csrc/`` where ``DIR`` has none).
Each shape is timed by CUDA graph replay (the smoke's ``time_graph_ms``)
in the order baseline, current, current, baseline, and the two builds'
outputs must be equal.  Shapes, made from seed 0
(synthetic, near the smoke's main paths):

* ``descent forest``: 2,048 rows (64 queries x 32 probes), W 8, d 128,
  each row from an internal node six levels above the leaves of an rp
  tree over 131,072 points with leaves of 8 (a bucket's tree);
* ``descent kd W64`` / ``W128``: 1,024 rows over a kd tree of 8,192
  centroids, d 128, leaves of 4 (the two-level index's kd top);
* ``descent qlbt W4``: 2,000 rows, d 256, a QLBT over 10,000 points under
  a skewed likelihood (the radio-station corpus);
* ``count_min m1`` / ``m64``: width 4,096, depth 4, topk 64 after 200
  served batches;
* ``rows forest`` / ``rows index`` (k 10, and k 100 in 4 passes): a
  (1,048,576, 128) table in 8,192 buckets of 16 leaves of 8 rows; each
  query reads 8 distinct leaves of each of 32 distinct buckets (C
  2,048): 64 queries over 450 buckets with 38 % of slots dead (the served
  forest's batch: about 82,000 live pairs over 35,000 distinct rows, as
  the smoke's forest shape reads), 1,024 queries over all with 5 % dead;
* ``lsh sift``: 1,024 queries, 32 probes of 8,192 bucket rows of 306
  columns, each row's live ids in front (a count uniform in 38..244,
  about 46 % of the slots, as the sift index's probed rows), 1,000,000
  random 64-bit codes, shortlist 128; ``lsh W8``: the same at 256 bits;
  ``lsh recompute``: 128 probes of 2,048 rows of 800 columns at 64 bits
  (the first design's and this one's recompute path).

``--lsh-ablation`` builds the current ``lsh_probe.cu`` with one part
taken out or done another way at a time (``LSH_ABLATIONS``: the
histogram by ``__match_any_sync``, no histogram, no code loads, random
ids for the id loads, no read of the winners' ids, no emit pass, the
prologue alone) and times each beside
the shipped source on ``lsh sift`` and ``lsh W8``: a part's cost is the
kernel's time less its variant's.  ``--lsh-spans`` builds it with a
stamp at each phase boundary of every block (``LSH_SPANS``) and reports
the cycles each phase takes a block and the spread of the blocks' start
and end times.

Prints one JSON line with the card's name and power limit (and writes it
to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.adaptive import CountMinSketch  # noqa: E402
from repro_torch.core.tree import (build_kd_tree, build_qlbt,  # noqa: E402
                                   build_rp_tree)
from repro_torch.kernels import (_build, bucket_topk,  # noqa: E402
                                 count_min, lsh_probe, tree_descent)
from repro_torch.kernels.common import (KMAX, list_len,  # noqa: E402
                                        topk_passes)
from repro_torch.kernels.l2_topk import ptr  # noqa: E402

GRAPH_ITERS = 20


def build(src: Path, names, out_dir: Path) -> dict:
    """``src``'s ``<name>.cu`` files built in parallel, loaded."""
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
         str(out_dir / f"{n}.so"), str(src / f"{n}.cu")],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {src / n}.cu:\n{log}")
    return {n: ctypes.CDLL(str(out_dir / f"{n}.so")) for n in names}


def graph_ms(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / GRAPH_ITERS


def node_depths(children: np.ndarray) -> np.ndarray:
    depth = np.full(children.shape[0], -1, np.int64)
    depth[0], level, frontier = 0, 0, np.array([0])
    while frontier.size:
        kids = children[frontier].reshape(-1)
        kids = kids[kids >= 0]
        level += 1
        depth[kids] = level
        frontier = kids
    return depth


def descent_shapes(dev, rng) -> dict:
    out = {}
    db = rng.normal(size=(131072, 128)).astype(np.float32)
    t = build_rp_tree(db, leaf_size=8, n_candidates=4, seed=1)
    depth = node_depths(t.children)
    internal = np.flatnonzero((t.children[:, 0] >= 0)
                              & (depth == t.max_depth - 6))
    roots = rng.choice(internal, 2048).astype(np.int32)
    q = db[rng.integers(0, db.shape[0], 2048)] + 0.1 * rng.normal(
        size=(2048, 128))
    out["descent forest"] = (t, q, roots, 8)
    cents = rng.normal(size=(8192, 128)).astype(np.float32)
    kd = build_kd_tree(cents, leaf_size=4)
    qk = cents[rng.integers(0, 8192, 1024)] + 0.1 * rng.normal(
        size=(1024, 128))
    out["descent kd W64"] = (kd, qk, None, 64)
    out["descent kd W128"] = (kd, qk, None, 128)
    radio = rng.normal(size=(10000, 256)).astype(np.float32)
    ql = build_qlbt(radio, rng.beta(0.3, 8.0, size=10000), leaf_size=8,
                    n_candidates=4, seed=1)
    qr = radio[rng.integers(0, 10000, 2000)] + 0.1 * rng.normal(
        size=(2000, 256))
    out["descent qlbt W4"] = (ql, qr, None, 4)
    return {k: (t.device_arrays(dev), torch.as_tensor(
        q, dtype=torch.float32, device=dev),
        None if r is None else torch.as_tensor(r, device=dev),
        {"kind": t.kind, "beam_width": w, "max_steps": t.max_depth + 4})
        for k, (t, q, r, w) in out.items()}


def rows_shapes(dev, rng) -> dict:
    """(queries, rows, ids) of the rows entry at the forest's and the
    index path's shapes (the module docstring)."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((8192 * 128, 128), generator=g, device=dev)

    def cands(b, pool, dead):
        probes = np.stack([rng.choice(pool, 32, replace=False)
                           for _ in range(b)])
        leaves = np.argsort(rng.random((b, 32, 16)), axis=2)[:, :, :8]
        ids = (probes[:, :, None, None] * 128 + leaves[..., None] * 8
               + np.arange(8)).reshape(b, -1).astype(np.int32)
        ids[rng.random(ids.shape) < dead] = -1
        q = rows[torch.as_tensor(ids[:, 0].clip(0), device=dev).long()]
        return (q + 0.1 * torch.randn(q.shape, generator=g, device=dev),
                rows, torch.as_tensor(ids, device=dev))

    return {"rows forest": cands(64, rng.choice(8192, 450, replace=False),
                                 0.38),
            "rows index": cands(1024, np.arange(8192), 0.05)}


def rows_first_design(fn, q, rows, ids, k):
    """The first design's rows entry through its launcher ``fn``: segments by
    ``splits_for``, a (B, splits, kt) partial a pass, passes above KMAX."""
    B, C = ids.shape
    dev = q.device
    splits = bucket_topk.splits_for(
        B, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    per = -(-C // splits)

    def run(kr, after_d, after_i):
        kt = list_len(kr)
        part_d = torch.empty((B, splits, kt), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, splits, kt), dtype=torch.int32, device=dev)
        out_d = torch.empty((B, kr), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, kr), dtype=torch.int32, device=dev)
        rc = fn(q.data_ptr(), rows.data_ptr(), rows.shape[0], ids.data_ptr(),
                ptr(after_d), ptr(after_i), part_d.data_ptr(),
                part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B, C,
                q.shape[1], kr, kt, splits, per,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"baseline rows launch failed: {rc}")
        return out_d, out_i

    return topk_passes(run, B, k, KMAX, dev)


def lsh_shapes(dev, rng) -> dict:
    """(qproj, codes, bucket_ids, extents, probe, S) of the LSH probe
    scan's shapes (the module docstring)."""

    def shape(n_bits, k, cap, p, lo, hi, b=1024, n=1_000_000, s=128):
        w = -(-n_bits // 32)
        fill = rng.integers(lo, hi + 1, k)
        bids = np.where(np.arange(cap)[None, :] < fill[:, None],
                        rng.integers(0, n, (k, cap)), -1).astype(np.int32)
        q = torch.as_tensor(rng.normal(size=(b, 16)), dtype=torch.float32,
                            device=dev)
        proj = torch.as_tensor(rng.normal(size=(16, n_bits)),
                               dtype=torch.float32, device=dev)
        return (q @ proj, torch.as_tensor(
            rng.integers(-2**31, 2**31, (n, w)).astype(np.int32), device=dev),
            torch.as_tensor(bids, device=dev),
            torch.as_tensor(fill.astype(np.int32), device=dev),
            torch.as_tensor(rng.integers(0, k, (b, p)).astype(np.int32),
                            device=dev), s)

    return {"lsh sift": shape(64, 8192, 306, 32, 38, 244),
            "lsh W8": shape(256, 8192, 306, 32, 38, 244),
            "lsh recompute": shape(64, 2048, 800, 128, 0, 800)}


def lsh_first_design(fn, qproj, codes, bids, probe, S):
    """The first design's launch: every slot of P cap, its distances kept
    where P cap of them fit 96 KB (``lsh_probe.stores_distances``)."""
    B, n_bits = qproj.shape
    K, cap = bids.shape
    P, W = probe.shape[1], codes.shape[1]
    out = torch.empty((B, S), dtype=torch.int32, device=qproj.device)
    rc = fn(qproj.data_ptr(), codes.data_ptr(), bids.data_ptr(),
            probe.data_ptr(), out.data_ptr(), B, n_bits, codes.shape[0], K,
            cap, P, S, int(lsh_probe.stores_distances(P, cap, W)),
            torch.cuda.current_stream(qproj.device).cuda_stream)
    if rc:
        raise RuntimeError(f"baseline lsh_probe launch failed: {rc}")
    return (out,)


def lsh_current(qproj, codes, bids, ext, probe, S):
    return (lsh_probe.lsh_probe_shortlist(qproj, codes, bids, probe, S,
                                          extents=ext),)


def lsh_launch(fn, qproj, codes, bids, ext, probe, S):
    """The current launcher ``fn`` (a variant's build), as the wrapper
    calls it."""
    B, n_bits = qproj.shape
    K, cap = bids.shape
    P, W = probe.shape[1], codes.shape[1]
    out = torch.empty((B, S), dtype=torch.int32, device=qproj.device)
    rc = fn(qproj.data_ptr(), codes.data_ptr(), bids.data_ptr(),
            ext.data_ptr(), probe.data_ptr(), out.data_ptr(), B, n_bits,
            codes.shape[0], K, cap, P, S, lsh_probe.store_bytes(P, cap, W),
            torch.cuda.current_stream(qproj.device).cuda_stream)
    if rc:
        raise RuntimeError(f"lsh_probe variant launch failed: {rc}")
    return (out,)


# the current lsh_probe.cu with one part taken out or done another way:
# (label, [(source text, replacement), ...]); answers differ by
# construction but for "hist by match_any", whose counts are equal
LSH_ABLATIONS = (
    ("hist by match_any", [(
        """      if (d != DEAD) atomicAdd(&h[d], 1);""",
        """      const unsigned mk = __ballot_sync(full, d != DEAD);
      if (d != DEAD) {
        const unsigned peers = __match_any_sync(mk, d);
        if (lane == __ffs(peers) - 1) h[d] += __popc(peers);
      }
      __syncwarp();""")]),
    ("no count histogram", [(
        """      if (d != DEAD) atomicAdd(&h[d], 1);""",
        """      if (d == -7) atomicAdd(&h[0], 1);""")]),
    ("no code loads", [(
        """  load_code<W>(a.codes + (size_t)min(id, a.N - 1) * W, x);""",
        """  for (int w = 0; w < W; ++w) x[w] = (uint32_t)id * (w + 1);""")]),
    ("no id loads (random ids)", [(
        """    id = __ldg(a.bucket_ids + (size_t)rows.bkt[j] * a.cap + (s - rows.rstart[j]));""",
        """    id = (int)(((unsigned)(s + 7919 * blockIdx.x + rows.bkt[j]) * 2654435761u) % (unsigned)a.N);""")]),
    ("no winners' id reads", [(
        """    const int wins = min(live, a.S);""",
        """    const int wins = 0;""")]),
    ("no emit", [("""  // 3. emit:""", """  if (a.S > 0) return;
  // 3. emit:""")]),
    ("prologue only", [("""  // 1. count
""", """  if (a.S > 0) return;
  // 1. count
""")]),
)


# phase stamps for ``--lsh-spans``: (source text, text put before it,
# phase that ends there); each stamp follows a block barrier, so it marks
# the block's slowest warp
LSH_STAMP = """__syncthreads();
  if (threadIdx.x == 0) {{
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    g_lsh_stamps[(size_t)blockIdx.x * 12 + 2 * {k}] = clock64();
    g_lsh_stamps[(size_t)blockIdx.x * 12 + 2 * {k} + 1] = g;
  }}
"""
LSH_SPANS = (
    ("  const bool chunked = a.P > a.ps;\n", "start"),
    ("  const int n = chunked ? total : rows.rstart[a.ps];\n", "prologue"),
    ("  // 2. offsets\n", "count"),
    ("  // 3. emit:", "offsets"),
    ("    // 4. the winners' ids", "emit"),
    ("    if (chunked) {\n      __syncthreads();\n      for (int p = tid; p < wins;",
     "ids"),
)


def lsh_spans(dev, shapes: dict, out_dir: Path) -> dict:
    """The shipped source with a stamp (``clock64`` and the global timer)
    at each phase boundary of every block (``LSH_SPANS``), run once on
    each shape: per phase the mean and the largest cycles a block spent,
    and the spread of the blocks' start and end times (ns from the
    launch's first start), with the stamped kernel's own time."""
    src = (_build.CSRC / "lsh_probe.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    text = src.replace("namespace {\n", "__device__ unsigned long long* "
                       "g_lsh_stamps;\nnamespace {\n", 1)
    for k, (marker, _) in enumerate(LSH_SPANS):
        if marker not in text:
            return {"skipped": f"marker {marker!r} no longer matches"}
        text = text.replace(marker, LSH_STAMP.format(k=k) + marker, 1)
    text += ("\nextern \"C\" int lsh_probe_set_stamps(void* p) {\n"
             "  return (int)cudaMemcpyToSymbol(g_lsh_stamps, &p, "
             "sizeof(p));\n}\n")
    (out_dir / "lsh_spans.cu").write_text(text)
    lib = build(out_dir, ["lsh_spans"], out_dir)["lsh_spans"]
    fn = lib.lsh_probe_launch
    fn.argtypes, fn.restype = lsh_probe._launcher().argtypes, ctypes.c_int
    lib.lsh_probe_set_stamps.argtypes = [ctypes.c_void_p]
    res = {}
    for key, (qproj, codes, bids, ext, probe, S) in shapes.items():
        B = qproj.shape[0]
        stamps = torch.zeros((B, 6, 2), dtype=torch.int64, device=dev)
        rc = lib.lsh_probe_set_stamps(stamps.data_ptr())
        want = lsh_probe.lsh_probe_shortlist(qproj, codes, bids, probe, S,
                                             extents=ext)
        got = lsh_launch(fn, qproj, codes, bids, ext, probe, S)[0]
        torch.cuda.synchronize()
        st = stamps.cpu().numpy().astype(np.float64)
        cyc, ns = np.diff(st[:, :, 0], axis=1), st[:, :, 1]
        ns = ns - ns[:, 0].min()
        phases = [name for _, name in LSH_SPANS[1:]]
        res[key] = {
            "rc": rc, "equal": torch.equal(got, want),
            "us": graph_ms(partial(lsh_launch, fn, qproj, codes, bids, ext,
                                   probe, S)),
            "cycles_mean": dict(zip(phases, cyc.mean(0).round(1).tolist())),
            "cycles_max": dict(zip(phases, cyc.max(0).tolist())),
            "start_ns": np.percentile(ns[:, 0], [0, 50, 90, 100]).tolist(),
            "end_ns": np.percentile(ns[:, -1], [0, 50, 90, 100]).tolist(),
            "block_ns_mean": float((ns[:, -1] - ns[:, 0]).mean())}
    return res


def lsh_ablation(dev, shapes: dict, out_dir: Path) -> dict:
    """Each ``LSH_ABLATIONS`` variant of the current source built and timed
    beside the unchanged source on ``shapes``, two rounds (forward,
    backward) by graph replay."""
    src = (_build.CSRC / "lsh_probe.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    variants, res = {"as shipped": src}, {}
    for label, edits in LSH_ABLATIONS:
        text = src
        for old, new in edits:
            if old not in text:
                res[label] = {"skipped": "edit no longer matches"}
                break
            text = text.replace(old, new)
        else:
            variants[label] = text
    names = {label: f"lsh_abl_{n}" for n, label in enumerate(variants)}
    for label, text in variants.items():
        (out_dir / f"{names[label]}.cu").write_text(text)
    libs = build(out_dir, list(names.values()), out_dir)
    for key, (qproj, codes, bids, ext, probe, S) in shapes.items():
        want = lsh_probe.lsh_probe_shortlist(qproj, codes, bids, probe, S,
                                             extents=ext)
        fns = {}
        for label, name in names.items():
            fn = libs[name].lsh_probe_launch
            fn.argtypes, fn.restype = lsh_probe._launcher().argtypes, \
                ctypes.c_int
            fns[label] = fn
        row = {label: {"us": [], "equal": torch.equal(lsh_launch(
            fn, qproj, codes, bids, ext, probe, S)[0], want)}
            for label, fn in fns.items()}
        for order in (list(fns), list(fns)[::-1]):
            for label in order:
                row[label]["us"].append(graph_ms(partial(
                    lsh_launch, fns[label], qproj, codes, bids, ext, probe,
                    S)))
        res[key] = row
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--out", default=None)
    ap.add_argument("--lsh-ablation", action="store_true")
    ap.add_argument("--lsh-spans", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out_dir = REPO / "build" / "kernel_ab" / args.baseline.name
    out_dir.mkdir(parents=True, exist_ok=True)
    mods = {n: m for n, m in (("tree_descent", tree_descent),
                              ("count_min", count_min),
                              ("candidate_topk", bucket_topk),
                              ("lsh_probe", lsh_probe))
            if (args.baseline / f"{n}.cu").exists()}
    libs = build(args.baseline, list(mods), out_dir)
    builds = {}
    for name, mod in mods.items():
        if name in ("candidate_topk", "lsh_probe"):
            continue
        mod._launcher()                   # the current build, loaded
        cur = mod._fn
        base = getattr(libs[name], cur.__name__)
        base.argtypes, base.restype = cur.argtypes, cur.restype
        builds[name] = (mod, {"baseline": base, "current": cur})

    def turns(name, call) -> dict:
        mod, fns = builds[name]

        def swapped(which):
            mod._fn = fns[which]
            return call()

        out = paired({w: partial(swapped, w) for w in fns})
        mod._fn = fns["current"]
        return out

    def paired(calls) -> dict:
        times = {"baseline": [], "current": []}
        res = {}
        for which in ("baseline", "current", "current", "baseline"):
            times[which].append(graph_ms(calls[which]))
            res[which] = [t.clone() for t in calls[which]()]
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(res["baseline"], res["current"]))
        return {"baseline_us": times["baseline"],
                "current_us": times["current"], "equal": same}

    rng = np.random.default_rng(0)
    result = {"card": smi}
    if "lsh_probe" in libs or args.lsh_ablation or args.lsh_spans:
        shapes = lsh_shapes(dev, rng)
        if args.lsh_spans:
            result["lsh spans"] = lsh_spans(
                dev, {k: shapes[k] for k in ("lsh sift", "lsh W8")},
                out_dir / "spans")
        if args.lsh_ablation:
            result["lsh ablation"] = lsh_ablation(
                dev, {k: shapes[k] for k in ("lsh sift", "lsh W8")},
                out_dir / "ablation")
        for key, (qproj, codes, bids, ext, probe, S) in (
                shapes.items() if "lsh_probe" in libs else ()):
            base = libs["lsh_probe"].lsh_probe_launch
            base.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            base.restype = ctypes.c_int
            result[key] = paired({
                "baseline": partial(lsh_first_design, base, qproj, codes,
                                    bids, probe, S),
                "current": partial(lsh_current, qproj, codes, bids, ext,
                                   probe, S)})
            P, cap = probe.shape[1], bids.shape[1]
            n = ext[probe.long()].sum(1).cpu().numpy()
            store = lsh_probe.store_bytes(P, cap, codes.shape[1])
            paths = [lsh_probe.path_of(int(x), store, codes.shape[1])
                     for x in n]
            result[key].update(
                live_slots_a_query=float(n.mean()),
                paths={p: paths.count(p) for p in lsh_probe.PATHS},
                kernel=lsh_probe.kernel_info(qproj.shape[1], P, cap))
        del shapes
    if "candidate_topk" in libs:
        base = libs["candidate_topk"].candidate_rows_topk_launch
        base.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
        base.restype = ctypes.c_int
        for key, (q, rows, ids) in rows_shapes(dev, rng).items():
            for k in (10, 100):
                result[f"{key} k{k}"] = paired({
                    "baseline": partial(rows_first_design, base, q, rows,
                                        ids, k),
                    "current": partial(bucket_topk.candidate_rows_topk, q,
                                       rows, ids, k)})
            result[f"{key} k10"]["distinct_rows"] = int(
                torch.unique(ids[ids >= 0]).numel())
        del rows
    for key, (arrays, q, roots, kw) in (descent_shapes(dev, rng).items()
                                        if "tree_descent" in mods else ()):
        result[key] = turns("tree_descent", lambda: tree_descent.tree_descent(
            arrays, q, roots=roots, **kw))
        result[key]["rows"], result[key]["W"] = q.shape[0], kw["beam_width"]
    if "count_min" not in mods:
        return finish(result, args.out)
    sk = CountMinSketch(width=4096, depth=4, topk=64, halflife=4096.0,
                        device=dev)
    ids = rng.zipf(1.1, 200 * 64) % 100000
    for lo in range(0, ids.size, 64):
        sk.update(ids[lo:lo + 64])
    with sk._on_stream():
        table, hh = sk.snapshot(), sk._hh_ids
    torch.cuda.current_stream().wait_stream(sk._stream)
    for m in (1, 64):
        st = sk.prepare(ids[:m])
        decay = float(np.float32(st.decay))
        result[f"count_min m{m}"] = turns(
            "count_min", lambda: count_min.count_min_update(
                table, sk._a, sk._b, hh, st.ids, st.weights, decay))
    return finish(result, args.out)


def finish(result: dict, out) -> int:
    """Print (and write to ``out``) the result line; 0 if every pair of
    outputs was equal."""
    line = json.dumps(result)
    print(line)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    def equal(v):
        return v["equal"] if "equal" in v else all(
            x["equal"] for x in v.values())

    return 0 if all(k in ("lsh ablation", "lsh spans") or equal(v)
                    for k, v in result.items() if k != "card") else 1


if __name__ == "__main__":
    sys.exit(main())
