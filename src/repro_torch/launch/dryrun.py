"""Dry run of every (arch x shape x mesh) cell: the port's counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder XLA
devices and reads per-device memory, cost and collective bytes off the
compiled program.  The port has no compiler to ask, so it builds each
cell with ``launch.cells.build_cell`` on ``make_production_mesh`` as rank
0 of a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once), places the cell's ``meta`` arguments by its specs (no
storage, nothing computed) and runs its step once through
``step_analysis.analyze_step``.  Every number is a meta count of what
rank 0 does, not a time.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --include-ann
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Each record keeps the reference's keys where they have a meaning:
``status`` (``ok``; ``skipped`` for ``long_500k``, as the reference
lists it; ``error`` with its message), ``memory`` (``argument_bytes`` and
``output_bytes``: rank 0's shards of the placed arguments and of the
step's result; ``peak_bytes``: the most storage the step held at once
beyond its arguments; ``per_device_total``: arguments plus that peak),
``analysis`` (``analyze_step``'s), ``times`` (build, placement and step
seconds on this host) and ``note``.  Results go to
``build/dryrun_torch.json`` in the checkout (keyed ``arch|shape|mesh``;
``--force`` recomputes a cached cell).  The exit code is 1 if any record
is an error, as the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs.registry import get_arch, get_shape, iter_cells
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import (make_plan, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.step_analysis import analyze_step, local_bytes

__all__ = ["run_cell", "main", "fake_world", "RESULTS"]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch.json")

_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a fake process group of ``n`` ranks, for the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "run it in a process that has none")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return make_test_mesh(tuple(mesh_shape), _AXES[len(mesh_shape)],
                          device_type="cpu")


def _mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "x".join(str(n) for n in mesh_shape)
    return "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             mesh_shape=None, cfg=None, verbose: bool = True) -> dict:
    """One cell's record.  ``mesh_shape`` (2 or 3 dims, the reference's
    axis names) replaces the production mesh; ``cfg`` replaces the arch's
    config (a ``reduced()`` one)."""
    arch_cfg, family = get_arch(arch_id)
    cfg = arch_cfg if cfg is None else cfg
    shape = get_shape(family, shape_name)
    name = _mesh_name(multi_pod, mesh_shape)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": name,
           "family": family, "status": "ok"}
    if shape.dims.get("subquadratic_required") and family == "lm":
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k needs sub-quadratic attention; arch is "
                         "full softmax attention (DESIGN.md §5)")
        return rec
    n = (math.prod(mesh_shape) if mesh_shape is not None
         else 512 if multi_pod else 256)
    try:
        with fake_world(n):
            t0 = time.perf_counter()
            cell = build_cell(cfg, family, make_plan(_mesh(multi_pod,
                                                           mesh_shape)),
                              shape)
            t1 = time.perf_counter()
            args = cell.place(cell.args, "meta")
            t2 = time.perf_counter()
            res = analyze_step(cell.step_fn, args)
            t3 = time.perf_counter()
            arg_b, out_b = local_bytes(args), local_bytes(res["out"])
        a = res["analysis"]
        peak = a["peak_liveness"]["peak_bytes"]
        rec["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b,
                         "peak_bytes": peak,
                         "per_device_total": arg_b + peak}
        rec["analysis"] = a
        rec["times"] = {"build_s": round(t1 - t0, 3),
                        "place_s": round(t2 - t1, 3),
                        "step_s": round(t3 - t2, 3)}
        if cell.note:
            rec["note"] = cell.note
        if verbose:
            print(f"[ok] {arch_id} x {shape_name} x {name}: "
                  f"{rec['memory']['per_device_total'] / 2**30:.2f} GiB/dev "
                  f"(meta), {a['matmul_flops']:.3e} mmflops/dev, coll "
                  f"{a['collective_bytes']['total'] / 2**20:.1f} MiB/dev "
                  f"(step {t3 - t2:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 -- record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[ERR] {arch_id} x {shape_name} x {name}: "
                  f"{rec['error']}", flush=True)
    return rec


def load_results(path: str = RESULTS) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(results: dict, path: str = RESULTS) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-ann", action="store_true",
                    help="also run the paper's own ANN corpora cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = load_results(args.out)
    if args.all:
        cells = [(arch_id, shape.name, mp) for arch_id, _, _, shape in
                 iter_cells(include_ann=args.include_ann) for mp in meshes]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    for arch_id, shape_name, mp in cells:
        k = f"{arch_id}|{shape_name}|{'multi' if mp else 'single'}"
        if not args.force and results.get(k, {}).get("status") in (
                "ok", "skipped"):
            print(f"[cached] {k}", flush=True)
            continue
        results[k] = run_cell(arch_id, shape_name, mp)
        save_results(results, args.out)

    n_ok = sum(r["status"] == "ok" for r in results.values())
    n_skip = sum(r["status"] == "skipped" for r in results.values())
    n_err = sum(r["status"] == "error" for r in results.values())
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (listed), "
          f"{n_err} errors", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
