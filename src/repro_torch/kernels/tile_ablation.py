"""Where the time of the tile (fp32, hybrid and int8 rows), the BM25 scan
and the Hamming select goes, on one card: each variant is the kernel
source with one part taken out (or done another way), built by ``nvcc``
beside the kernel and timed on the same operands.

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_ablation \
        [--out build/ablation] [--baseline DIR]

``--baseline DIR`` also builds ``DIR/l2_topk.cu``, ``DIR/bm25_topk.cu``
and ``DIR/hamming_topk.cu`` of a checkout whose int8 scan is the first
tile loop (its launcher takes no shared-bound scratch, and
``l2_topk_int8_selectors()`` partial lists a split) and whose Hamming
scan takes one query a block row (warps of 128 rows and more, about four
blocks an SM), times them in the same rounds, and holds this checkout's
answers to theirs bit for bit (fp32, hybrid, BM25 and int8 at k = 10,
Hamming at k = 1,024): the kernels' redesign keeps every distance.

Run from the root of a checkout on a machine with a card and the CUDA
toolkit; nothing runs at import (the CPU tests import every module).  The variants' answers are wrong by construction; only their
times mean something: the time a part costs is the kernel's time less the
time of the variant without it.  Operands: B = 64 queries against N = 1M
rows of d = 128 (SIFT-like integer rows, queries perturbed), about 2 %
dead, k = 10; slabs of 10 Zipf-drawn terms a row (of 16 slots), queries of
4 real term slots (of 8); the int8 rows are those rows quantized
(``ops.quantize_rows_int8``); the Hamming codes are the rows' 96 sign
bits under ``lsh_build``'s kind of projection, against 1,024 perturbed
rows, k = 1,024 (the one-level LSH scan's shape).  Each variant is timed twice, the second round in
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
         "    if (step + RING - 1 < steps)\n      load_step",
         "    if (step + RING - 1 < 0)\n      load_step")
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
# int8 rows: no chunk widened to fp32 (the products read stale chunks)
NO_WIDEN = [("l2_topk.cu", "    if (steps > 0) widen<BN>(stages, wide, tid);",
             ""),
            ("l2_topk.cu", "    if constexpr (S::kInt8)\n      if (step + 1 < steps)",
             "    if constexpr (false)\n      if (step + 1 < steps)")]
# int8 rows widened in registers where the products read them: a char4 of
# the staged codes a row and 4 dims, each code by a byte permute into the
# low byte of 2^23 and one exact fadd (no I2F), in place of the widened
# fp32 chunk
IN_REGISTERS = NO_WIDEN + [(
    "l2_topk.cu",
    "      for (int j = 0; j < RPT; ++j)\n"
    "        xv[j] = *reinterpret_cast<const float4*>(xs + (lane + 32 * j) * LDK + kq);",
    "      for (int j = 0; j < RPT; ++j) {\n"
    "        if constexpr (S::kInt8) {\n"
    "          const unsigned u = *reinterpret_cast<const unsigned*>(\n"
    "              stage + (lane + 32 * j) * BK + kq) ^ 0x80808080u;\n"
    "          const float m = 8388736.f;   // 2^23 + 128\n"
    "          xv[j] = make_float4(\n"
    "              __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - m,\n"
    "              __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - m,\n"
    "              __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - m,\n"
    "              __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - m);\n"
    "        } else {\n"
    "          xv[j] = *reinterpret_cast<const float4*>(xs + (lane + 32 * j) * LDK + kq);\n"
    "        }\n"
    "      }")]

# the Hamming select: a popcount for each word (no carry-save adder), and
# the emit's bound left at the threshold bin once that bin is full
HAM_EACH_WORD = ("hamming_topk.cu", "  for (; w + 3 <= W; w += 3) {",
                 "  for (; w + 3 <= 0; w += 3) {")
HAM_NO_DROP = [
    ("hamming_topk.cu",
     "#pragma unroll\n  for (int j = 0; j < QW; ++j)\n"
     "    if (bound[j] >= 0 && next[(warp + WARPS * j) * M::BINS + bound[j]]"
     " >= a.k) --bound[j];", ""),
    ("hamming_topk.cu",
     "        if (nx[bound[j]] >= a.k) --bound[j];   // the threshold bin is"
     " full", "")]

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
    "int8: no widening": NO_WIDEN,
    "int8: widened in registers": IN_REGISTERS,
    "hamming: a popcount a word": [HAM_EACH_WORD],
    "hamming: bound kept at the threshold bin": HAM_NO_DROP,
}
LIBS = ("l2_topk", "bm25_topk", "hamming_topk")


def build(out: Path, baseline) -> dict:
    """Each variant's csrc copy with its edits (and the baseline's csrc),
    its ``LIBS`` built by parallel nvcc; returns {variant: dir} for those
    that built."""
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
        for lib in LIBS:
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

    from repro_torch.core.lsh import pack_bits
    from repro_torch.kernels import hamming, l2_topk, ops

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dirs = build(out, None if args.baseline is None else Path(args.baseline))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, b, d, k = 1_000_000, 64, 128, 10
    x_np = np.round(rng.random((n, d)) * 255).astype(np.float32)
    codes, scales = (torch.as_tensor(a, device=dev)
                     for a in ops.quantize_rows_int8(x_np))
    x = torch.as_tensor(x_np, device=dev)
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
    hb, hk, hw = 1024, 1024, 3
    proj = rng.normal(size=(d, 32 * hw)).astype(np.float32)
    proj /= np.linalg.norm(proj, axis=0, keepdims=True)
    hq_np = x_np[:hb] + rng.normal(size=(hb, d)).astype(np.float32)
    hcodes, hq = (torch.as_tensor(pack_bits((a @ proj > 0).astype(np.uint8)),
                                  device=dev) for a in (x_np, hq_np))
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    _, h_splits, h_rows = hamming.plan(hb, n, sm)
    h_hist = torch.empty((hb, h_splits, 32 * hw + 1), dtype=torch.int32,
                         device=dev)
    h_thr = torch.empty((hb,), dtype=torch.int32, device=dev)
    h_d = torch.empty((hb, hk), device=dev)
    h_i = torch.empty((hb, hk), dtype=torch.int32, device=dev)
    # the baseline's Hamming grid: warps of whole 32-row runs, at least 128
    # rows each, about four blocks an SM over the queries
    o_blocks = max(1, min(-(-n // (8 * 128)), (4 * sm) // hb))
    o_rows = -(-(-(-n // (o_blocks * 8))) // 32) * 32
    o_hist = torch.empty((hb, o_blocks * 8, 32 * hw + 1), dtype=torch.int32,
                         device=dev)
    out_d, out_i, part_d, part_i, kt, splits, rows = l2_topk.scan_outputs(
        b, n, k, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    outs = (part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr())
    bound = l2_topk.shared_bound(b, dev)     # refilled for every launch

    def launchers(dd: Path, name: str):
        lib = ctypes.CDLL(str(dd / "l2_topk.so"))
        bm = ctypes.CDLL(str(dd / "bm25_topk.so"))
        ham = ctypes.CDLL(str(dd / "hamming_topk.so")).hamming_topk_launch
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

        if name == "baseline":   # the first tile loop: SEL lists a split
            sel = lib.l2_topk_int8_selectors()
            pd = torch.empty((b, splits * sel, kt), device=dev)
            pi = torch.empty((b, splits * sel, kt), dtype=torch.int32,
                             device=dev)
            lib.l2_topk_int8_launch.argtypes = [P] * 10 + [I] * 7 + [P]
            int8 = lambda: lib.l2_topk_int8_launch(  # noqa: E731
                q.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                valid.data_ptr(), None, None, pd.data_ptr(), pi.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), b, n, d, k, kt, splits,
                rows, stream)
            ham.argtypes = [P] * 6 + [I] * 6 + [P]
            hamm = lambda: ham(  # noqa: E731
                hq.data_ptr(), hcodes.data_ptr(), None, o_hist.data_ptr(),
                h_d.data_ptr(), h_i.data_ptr(), hb, n, hw, hk, o_blocks,
                o_rows, stream)
        else:
            lib.l2_topk_int8_launch.argtypes = [P] * 11 + [I] * 7 + [P]
            int8 = fresh(lambda: lib.l2_topk_int8_launch(
                q.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                valid.data_ptr(), None, None, bound.data_ptr(), *outs, b, n,
                d, k, kt, splits, rows, stream))
            ham.argtypes = [P] * 7 + [I] * 6 + [P]
            hamm = lambda: ham(  # noqa: E731
                hq.data_ptr(), hcodes.data_ptr(), None, h_hist.data_ptr(),
                h_thr.data_ptr(), h_d.data_ptr(), h_i.data_ptr(), hb, n, hw,
                hk, h_splits, h_rows, stream)
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
                splits, rows, stream),
            "l2_topk_int8": int8,
            "hamming_topk": hamm}

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
        for kern in ("l2_topk", "hybrid_topk", "bm25_topk", "l2_topk_int8",
                     "hamming_topk"):
            od, oi = (h_d, h_i) if kern == "hamming_topk" else (out_d, out_i)
            got = []
            for name in ("kernel", "baseline"):
                assert runs[name][kern]() == 0
                torch.cuda.synchronize()
                got.append((od.clone(), oi.clone()))
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
