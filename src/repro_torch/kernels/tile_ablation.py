"""Where the time of the fp32 / hybrid tile and the BM25 scan goes, on one
card: each variant is the kernel source with one part taken out, built by
``nvcc`` beside the kernel and timed on the same operands.

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_ablation \
        [--out build/ablation] [--baseline DIR]

``--baseline DIR`` also builds ``DIR/l2_topk.cu`` and ``DIR/bm25_topk.cu``
of a checkout before the large-k passes (their launchers take no bound
operands; the int8 loop's selector count sizes the fp32 partials), times
them in the same rounds, and holds this checkout's answers to theirs bit
for bit (fp32, hybrid, BM25 at k = 10): the kernels' redesign keeps every
distance.

Run from the root of a checkout on a machine with a card and the CUDA
toolkit; nothing runs at import (the CPU tests import every module).  The variants' answers are wrong by construction; only their
times mean something: the time a part costs is the kernel's time less the
time of the variant without it.  Operands: B = 64 queries against N = 1M
rows of d = 128 (SIFT-like integer rows, queries perturbed), about 2 %
dead, k = 10; slabs of 10 Zipf-drawn terms a row (of 16 slots), queries of
4 real term slots (of 8).  Each variant is timed twice, the second round in
the reverse order, with CUDA events over 20 launches after 3 warm-ups.  A
variant whose edit no longer matches the source is reported and skipped.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

# (file, old, new) edits; each variant takes one part out
SELECT = ("l2_topk.cu", "        if (mine == 0) continue;",
          "        if (mine != 12345u) continue;")
SHARED = ("l2_topk.cu",
          "      if (lane < QPT) thr = fminf(thr, order_float(g_key));", "")
FLAGS_ALL = ("l2_topk.cu", "if (__ballot_sync(0xffffffffu, dist <= bound))",
             "if (__ballot_sync(0xffffffffu, dist <= CUDART_INF_F))")
LOADS = ("l2_topk.cu",
         "    if (step + STAGES - 1 < steps)\n      load_step",
         "    if (step + STAGES - 1 < 0)\n      load_step")
# three of every four FMAs of the products taken out
PRODUCTS = ("l2_topk.cu",
            "          acc[i][j] = fmaf(qv.y, xv[j].y, acc[i][j]);\n"
            "          acc[i][j] = fmaf(qv.z, xv[j].z, acc[i][j]);\n"
            "          acc[i][j] = fmaf(qv.w, xv[j].w, acc[i][j]);", "")
LEXICAL = ("l2_topk.cu", "        for (int g0 = 0; g0 < BQ; g0 += dc.G) {",
           "        for (int g0 = 0; g0 < 0; g0 += dc.G) {")
# the first pass's lists with the bound's test compiled in (its bound the
# constant none): what a run-time bound would cost
TESTED_BOUND = [("l2_topk.cu", "rt::WarpTopK<1, false, BOUNDED> top;",
                 "rt::WarpTopK<1, false, true> top;"),
                ("bm25_topk.cu", "rt::WarpTopK<1, false, BOUNDED> top[QW];",
                 "rt::WarpTopK<1, false, true> top[QW];")]

# a deeper ring (still two fp32 blocks an SM)
DEEPER = ("l2_topk.cu",
          "constexpr int STAGES = 3;              // ring of staged chunks",
          "constexpr int STAGES = 4;")

VARIANTS = {
    "kernel": [],
    "no selection": [SELECT],
    "every live run offered": [FLAGS_ALL],
    "no bound shared across splits": [SHARED],
    "no loads": [LOADS],
    "a quarter of the products": [PRODUCTS],
    "no lexical half": [LEXICAL],
    "bound tested in a first pass": TESTED_BOUND,
    "four stages": [DEEPER],
}


def build(out: Path, baseline) -> dict:
    """Each variant's csrc copy with its edits (and the baseline's csrc),
    l2_topk.cu and bm25_topk.cu built by parallel nvcc; returns {variant:
    dir} for those that built."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs, dirs = [], {}
    todo = dict(VARIANTS)
    if baseline is not None:
        todo["baseline"] = []
    for name, edits in todo.items():
        d = out / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC if name != "baseline" else baseline, d)
        ok = True
        for fname, old, new in edits:
            src = (d / fname).read_text()
            if old not in src:
                print(f"[ablation] {name}: edit no longer matches {fname}")
                ok = False
                break
            (d / fname).write_text(src.replace(old, new))
        if not ok:
            continue
        dirs[name] = d
        for lib in ("l2_topk", "bm25_topk"):
            procs.append((name, lib, subprocess.Popen(
                [nvcc, *FLAGS, "-o", str(d / f"{lib}.so"),
                 str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            print(f"[ablation] {name}: {lib} did not build\n{log[-2000:]}")
            dirs.pop(name, None)
    return dirs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "ablation"))
    ap.add_argument("--baseline", default=None,
                    help="csrc directory of a checkout before the passes")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    import numpy as np
    import torch

    from repro_torch.kernels import l2_topk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dirs = build(out, None if args.baseline is None else Path(args.baseline))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, b, d, k = 1_000_000, 64, 128, 10
    x = torch.as_tensor(np.round(rng.random((n, d)) * 255).astype(np.float32),
                        device=dev)
    q = torch.as_tensor((np.round(rng.random((b, d)) * 255)
                         + rng.normal(size=(b, d))).astype(np.float32),
                        device=dev)
    valid = torch.as_tensor((rng.random(n) > 0.02).astype(np.int32),
                            device=dev)
    p = 1.0 / np.arange(1, 50_001) ** 1.1
    p /= p.sum()
    terms = rng.choice(50_000, size=(n, 16), p=p).astype(np.int32)
    terms[:, 10:] = -1
    terms = torch.as_tensor(terms, device=dev)
    tf = torch.as_tensor(rng.random((n, 16)).astype(np.float32), device=dev)
    qt = torch.as_tensor(rng.choice(50_000, size=(b, 8), p=p).astype(np.int32),
                         device=dev)
    qt[:, 4:] = -1
    qw = torch.as_tensor(rng.random((b, 8)).astype(np.float32), device=dev)
    alpha = torch.full((1, 1), 0.5, device=dev)
    out_d, out_i, part_d, part_i, kt, splits, rows = l2_topk.scan_outputs(
        b, n, k, 1, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    outs = (part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr())
    bound = l2_topk.shared_bound(b, dev)     # refilled for every launch

    def launchers(dd: Path, name: str):
        lib = ctypes.CDLL(str(dd / "l2_topk.so"))
        bm = ctypes.CDLL(str(dd / "bm25_topk.so"))
        if name == "baseline":   # no bound operands; SEL lists a split
            sel = lib.l2_topk_selectors()
            pd = torch.empty((b, splits * sel, kt), device=dev)
            pi = torch.empty((b, splits * sel, kt), dtype=torch.int32,
                             device=dev)
            old = (pd.data_ptr(), pi.data_ptr(), out_d.data_ptr(),
                   out_i.data_ptr())
            lib.l2_topk_launch.argtypes = [P] * 7 + [I] * 7 + [P]
            lib.hybrid_topk_launch.argtypes = [P] * 12 + [I] * 9 + [P]
            bm.bm25_topk_launch.argtypes = [P] * 9 + [I] * 8 + [P]
            return {
                "l2_topk": lambda: lib.l2_topk_launch(
                    q.data_ptr(), x.data_ptr(), valid.data_ptr(), *old, b, n,
                    d, k, kt, splits, rows, stream),
                "hybrid_topk": lambda: lib.hybrid_topk_launch(
                    q.data_ptr(), x.data_ptr(), qt.data_ptr(), qw.data_ptr(),
                    terms.data_ptr(), tf.data_ptr(), alpha.data_ptr(),
                    valid.data_ptr(), *old, b, n, d, 8, 16, k, kt, splits,
                    rows, stream),
                "bm25_topk": lambda: bm.bm25_topk_launch(
                    qt.data_ptr(), qw.data_ptr(), terms.data_ptr(),
                    tf.data_ptr(), valid.data_ptr(), *old, b, n, 8, 16, k,
                    kt, splits, rows, stream)}
        lib.l2_topk_launch.argtypes = [P] * 10 + [I] * 7 + [P]
        lib.hybrid_topk_launch.argtypes = [P] * 15 + [I] * 9 + [P]
        bm.bm25_topk_launch.argtypes = [P] * 11 + [I] * 8 + [P]
        def fresh(launch):
            """The launch after refilling the splits' shared bound with
            +inf, as the wrappers do for every pass."""
            def run():
                bound.fill_(0x7F800000)
                return launch()
            return run

        return {
            "l2_topk": fresh(lambda: lib.l2_topk_launch(
                q.data_ptr(), x.data_ptr(), valid.data_ptr(), None, None,
                bound.data_ptr(), *outs, b, n, d, k, kt, splits, rows,
                stream)),
            "hybrid_topk": fresh(lambda: lib.hybrid_topk_launch(
                q.data_ptr(), x.data_ptr(), qt.data_ptr(), qw.data_ptr(),
                terms.data_ptr(), tf.data_ptr(), alpha.data_ptr(),
                valid.data_ptr(), None, None, bound.data_ptr(), *outs, b, n,
                d, 8, 16, k, kt, splits, rows, stream)),
            "bm25_topk": lambda: bm.bm25_topk_launch(
                qt.data_ptr(), qw.data_ptr(), terms.data_ptr(), tf.data_ptr(),
                valid.data_ptr(), None, None, *outs, b, n, 8, 16, k, kt,
                splits, rows, stream)}

    def time_ms(fn) -> float:
        for _ in range(3):
            assert fn() == 0
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / 20

    runs = {name: launchers(dd, name) for name, dd in dirs.items()}
    print("[ablation] " + os.popen("nvidia-smi --query-gpu=name,power.limit "
                                   "--format=csv,noheader").read().strip())
    if "baseline" in runs:
        for kern in ("l2_topk", "hybrid_topk", "bm25_topk"):
            got = []
            for name in ("kernel", "baseline"):
                assert runs[name][kern]() == 0
                torch.cuda.synchronize()
                got.append((out_d.clone(), out_i.clone()))
            same = (torch.equal(got[0][1], got[1][1]) and torch.equal(
                got[0][0].view(torch.int32), got[1][0].view(torch.int32)))
            print(f"[ablation] {kern}: this checkout's answer equals the "
                  f"baseline's bit for bit: {same}")
    for rnd, order in enumerate((list(runs), list(runs)[::-1])):
        for name in order:
            times = {kern: time_ms(fn) for kern, fn in runs[name].items()}
            print(f"[ablation] round {rnd} {name}: " + ", ".join(
                f"{kern} {ms:.4f} ms" for kern, ms in times.items()),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
