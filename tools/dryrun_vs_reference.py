"""One cell's dry run beside the reference's compiled program, by matmul
and by collective, on the CPU.

The port's side: ``repro_torch.launch.dryrun.run_cell`` as rank 0 of a
fake process group on ``meta`` tensors, each matmul (``mm``, ``bmm``,
``addmm``, ``baddbmm``) logged by its local operand shapes, and each
collective of ``sharding``'s moves by kind and result shape.  The
reference's side: the JAX package's cell compiled at the production mesh
on 512 fake XLA devices (loaded as the tests load it,
``tests/test_torch_reference.reference_modules``, in a subprocess), each
``dot`` of its HLO with the trip count of its enclosing loops, as
``repro.launch.hlo_analysis.analyze_hlo`` weighs it, and each collective
with its result bytes, tuple-typed results included (``analyze_hlo``
reads a collective's bytes from its result type and counts a tuple, the
form XLA's combiners give merged collectives, as 0 bytes).

    PYTHONPATH=src python tools/dryrun_vs_reference.py \\
        --arch dlrm-mlperf --shape train_batch --mesh single [--top 30]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = r"""
import os, sys, json, importlib
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import warnings; warnings.filterwarnings("ignore")
import jax
from test_torch_reference import reference_modules

arch, shape, m = sys.argv[1:4]
with reference_modules() as ref:
    mesh_mod = importlib.import_module("repro.launch.mesh")
    hlo = importlib.import_module("repro.launch.hlo_analysis")
    cfg, fam = ref.registry.get_arch(arch)
    mesh = mesh_mod.make_production_mesh(multi_pod=(m == "multi"))
    cell = ref.cells.build_cell(cfg, fam, mesh_mod.make_plan(mesh),
                                ref.registry.get_shape(fam, shape))
    with mesh:
        txt = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                      out_shardings=cell.out_shardings,
                      donate_argnums=cell.donate).lower(
            *cell.args).compile().as_text()
    a = hlo.analyze_hlo(txt)
    comps, entry = hlo._split_computations(txt)
    mult = {entry: 1.0, **a["while_trip_multipliers"]}
    dots, colls = [], []
    for cname, w in mult.items():
        sym = {}
        for s in comps[cname]:
            mi = hlo._INSTR_RE.match(s)
            if mi:
                sym[mi.group(1)] = mi.group(2)
        for rhs in sym.values():
            if rhs.startswith("("):
                head, _, rest = rhs.partition(") ")
                head += ")"
            else:
                head, _, rest = rhs.partition("(")
                toks = head.split()
                head, rest = " ".join(toks[:-1]), toks[-1] + "(" + rest
            op = rest.split("(", 1)[0].strip()
            base = op.replace("-start", "")
            nbytes = sum(hlo._shape_elems(g.group(2))
                         * hlo._DTYPE_BYTES[g.group(1)]
                         for g in hlo._SHAPE_RE.finditer(head))
            if base in hlo._COLLECTIVES and not op.endswith("-done"):
                f = 2.0 if base == "all-reduce" else 1.0
                colls.append([base, head.strip(), f * nbytes * w, w,
                              rhs.startswith("(")])
            dm = hlo._DOT_RE.search(rhs)
            if op == "dot" and dm:
                out = sum(hlo._shape_elems(g.group(2))
                          for g in hlo._SHAPE_RE.finditer(head))
                lhs = sym.get(dm.group(1), "").split("(", 1)[0]
                cd = hlo._LHS_CDIMS_RE.search(rhs)
                lm = hlo._SHAPE_RE.search(lhs)
                k = 1
                if cd and lm:
                    ld = [int(d) for d in lm.group(2).split(",") if d]
                    for ci in cd.group(1).split(","):
                        if ci and int(ci) < len(ld):
                            k *= ld[int(ci)]
                dots.append([2.0 * out * k * w, w, head.strip(),
                             lhs.strip(), k])
    print(json.dumps({"matmul_flops": a["matmul_flops"],
                      "collective_bytes": a["collective_bytes"],
                      "dots": dots, "collectives": colls}))
"""


def _port(arch: str, shape: str, multi: bool):
    """Rank 0's record, its matmuls by (op, local shapes) and its
    collectives by (kind, result shape)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import run_cell

    torch.set_num_threads(1)
    mms, colls = collections.Counter(), collections.Counter()

    class Matmuls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._opname in ("mm", "bmm", "addmm", "baddbmm"):
                ts = [a for a in args if isinstance(a, torch.Tensor)]
                a, b = ts[-2:]
                flops = 2 * a.numel() * b.shape[-1]
                mms[(func._opname, tuple(a.shape), tuple(b.shape))] += flops
            return func(*args, **(kwargs or {}))

    sent = sharding._sent

    def logged(kind, t, factor=1):
        colls[(kind, tuple(t.shape))] += factor * t.numel() \
            * t.element_size()
        return sent(kind, t, factor)

    sharding._sent = logged
    try:
        with Matmuls():
            rec = run_cell(arch, shape, multi, verbose=False)
    finally:
        sharding._sent = sent
    return rec, mms, colls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _REF, args.arch,
                             args.shape, args.mesh], stdout=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    rec, mms, colls = _port(args.arch, args.shape, args.mesh == "multi")
    out, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"the reference's compile failed ({proc.returncode})")
    ref = json.loads(out.strip().splitlines()[-1])
    a = rec["analysis"]
    print(f"{args.arch} {args.shape} {args.mesh}: matmul FLOPs port "
          f"{a['matmul_flops']:.4e}, reference {ref['matmul_flops']:.4e} "
          f"(x{a['matmul_flops'] / ref['matmul_flops']:.4f})")
    print(f"\nport matmuls, largest first (op, local shapes: FLOPs):")
    for key, f in mms.most_common(args.top):
        print(f"  {f:.3e}  {key[0]} {key[1]} x {key[2]}")
    print(f"\nreference dots, largest first (FLOPs, loop weight, result, "
          f"lhs, contraction):")
    for f, w, head, lhs, k in sorted(ref["dots"], reverse=True)[:args.top]:
        print(f"  {f:.3e}  w={w:g} {head} <- {lhs} k={k}")
    print(f"\nport collective bytes {a['collective_bytes']}")
    for (kind, shape), n in colls.most_common(args.top):
        print(f"  {n:.3e}  {kind} {shape}")
    tup = sum(c[2] for c in ref["collectives"] if c[4])
    print(f"\nreference collective bytes (analyze_hlo) "
          f"{ref['collective_bytes']}; tuple-typed results, which it "
          f"counts as 0: {tup:.4e}")
    for kind, head, n, w, is_tuple in sorted(
            ref["collectives"], key=lambda c: -c[2])[:args.top]:
        print(f"  {n:.3e}  {kind} w={w:g} {head[:120]}"
              f"{' (tuple)' if is_tuple else ''}")


if __name__ == "__main__":
    main()
