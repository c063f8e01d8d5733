"""One-time costs, entry-point replay and the analytic cost model: the
port of ``repro/obs/profile.py``.

Three layers, cheapest first:

1. **Dispatch signatures** (always on) -- ``ShardedSearchBackend`` keeps
   the signature (mode, padded operand shape, dtype) of every batch it
   dispatches; the *first* call of each is the one that paid the
   one-time costs (allocator pools, cuBLAS handles, a kernel library's
   load), so its time and signature are recorded (``compile_signatures``
   counter, ``first_call_ms`` histogram, a ``compile-signature`` instant
   in the trace).  A healthy cell stops adding signatures after its
   power-of-two warm-up: the invariant the recompile gate of
   ``repro_torch.analysis`` enforces.

2. **Kernel-library hooks** (:func:`install_compile_hooks`) -- the port
   traces nothing, so the reference's JAX compile events have no
   counterpart; its one-time compile cost is ``nvcc`` building a kernel
   library (``kernels/_build.py``).  The hook mirrors every library
   built or loaded into :data:`PROFILE` (``kernel_builds`` counter,
   ``kernel_build_ms`` histogram, and ``kernel_build_ms.<library>`` for
   each library) and the current tracer (a ``kernel-build`` instant
   carrying the library's name).  It is installed once a process and
   reads the current tracer at event time.

3. **Entry-point accounting** (:func:`profile_entry_points`) -- replays
   the entry points registered in ``repro_torch.analysis.registry`` (the
   list the recompile gate checks), timing every step and attributing
   compiled-variant growth to the step that caused it.

The analytic side (:func:`backend_cost`) prices one dispatch in bytes and
FLOPs with the reference's traffic model, so
``ShardedSearchBackend.roofline_report`` puts a *measured* bandwidth
beside the *analytic* useful-byte fraction.  Its device figures are the
H100's below (NVIDIA's data sheet, SXM part, at a 700 W power limit).
"""
from __future__ import annotations

import time
from typing import Iterable, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

__all__ = [
    "H100_FP32_FLOPS_PER_S",
    "H100_HBM_BYTES_PER_S",
    "H100_NAME",
    "PROFILE",
    "backend_cost",
    "install_compile_hooks",
    "profile_entry_points",
]

# the card the port runs on, as torch.cuda.get_device_name names it, with
# its published HBM3 rate and fp32 rate outside the tensor cores
H100_NAME = "NVIDIA H100 80GB HBM3"
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12

# process-wide profiling registry: one-time costs land here whichever
# component paid them (there is one build directory and one card)
PROFILE = MetricsRegistry()

_HOOKS_INSTALLED = False


def install_compile_hooks(metrics: Optional[MetricsRegistry] = None) -> bool:
    """Mirror every kernel library that ``kernels/_build.py`` builds or
    loads from now on into ``metrics`` (default :data:`PROFILE`) and the
    current default tracer.  Idempotent: one listener a process, routed
    through module state, as the reference's JAX listener is.  Returns
    True once the listener is installed."""
    global _HOOKS_INSTALLED
    if _HOOKS_INSTALLED:
        return True
    from repro_torch.kernels import _build

    reg = metrics or PROFILE

    def _on_load(name: str, ms: float, built: bool) -> None:
        reg.counter("kernel_builds").inc()
        for metric in ("kernel_build_ms", f"kernel_build_ms.{name}"):
            reg.histogram(metric, lo=1e-2, hi=1e7).observe(ms)
        get_tracer().instant("kernel-build", library=name,
                             ms=round(ms, 3), built=built)

    _build.add_listener(_on_load)
    _HOOKS_INSTALLED = True
    return True


def backend_cost(kind: str, *, fused: bool, precision: str,
                 n_rows: int, d: int, b: int, k: int,
                 n_probe_rows: int = 0, n_centroids: int = 0) -> dict:
    """Analytic bytes/FLOPs for ONE dispatch of a sharded search, a copy
    of the reference's model: the scan is bandwidth-bound, so variants
    differ almost purely in bytes moved -- ``useful_bytes`` is the corpus
    traffic a perfect kernel must move, ``bytes_moved`` adds the
    materialized ``(B, N)`` distance matrix (write + read-back) that only
    the *unfused* brute path pays.

    ``n_rows`` is total corpus rows placed; for ``ivf``/``forest`` the
    probed subset (``n_probe_rows``) plus the centroid scan
    (``n_centroids``) is what moves per query batch -- an estimate (probe
    sets overlap across a batch), flagged as such in the report.
    """
    if kind == "brute":
        scanned = n_rows
        db_bytes = (n_rows * d * 1.0 + n_rows * 4.0
                    if precision == "int8" else n_rows * d * 4.0)
    else:
        scanned = n_probe_rows
        db_bytes = (n_centroids + n_probe_rows) * d * 4.0
    out_bytes = b * k * 8.0
    moved = db_bytes + out_bytes
    if kind == "brute" and not fused:
        moved += 2.0 * b * scanned * 4.0     # (B, N) write + read-back
    flops = 2.0 * b * (n_centroids + scanned) * d
    return {
        "kind": kind, "fused": bool(fused), "precision": precision,
        "useful_bytes": db_bytes, "bytes_moved": moved,
        "flops": flops,
        "analytic_frac": db_bytes / moved if moved else 0.0,
        "estimate": kind != "brute",
    }


def profile_entry_points(names: Optional[Iterable[str]] = None, *,
                         metrics: Optional[MetricsRegistry] = None,
                         device=None) -> dict:
    """Replay registered entry points, accounting per step.

    For each entry point in ``repro_torch.analysis.registry`` (or the
    ``names`` subset): build its Plan on ``device`` (default the card),
    run the steps in order, and record per step the wall time and the
    compiled-variant growth its mutations caused.  Returns ``{name:
    {"steps": [...], "compiles": int, "wall_ms": float}}`` and mirrors
    the numbers into ``metrics`` (default :data:`PROFILE`) and spans into
    the tracer.
    """
    from repro_torch.analysis.registry import ENTRY_POINTS

    install_compile_hooks(metrics)
    reg = metrics or PROFILE
    tracer = get_tracer()
    chosen = sorted(ENTRY_POINTS) if names is None else list(names)
    report: dict = {}
    for name in chosen:
        make_plan = ENTRY_POINTS[name]
        steps_out: list = []
        t_entry = time.perf_counter()
        with tracer.span("profile.entry-point", entry=name):
            try:
                plan = make_plan(device=device)
            except Exception as e:
                report[name] = {"error": repr(e), "steps": [],
                                "compiles": 0, "wall_ms": 0.0}
                continue
            prev = None
            compiles = 0
            for label, thunk in plan.steps:
                t0 = time.perf_counter()
                with tracer.span("profile.step", entry=name, step=label):
                    thunk()
                wall_ms = (time.perf_counter() - t0) * 1e3
                size = plan.cache_size()
                grew = (0 if size < 0 or prev is None
                        else max(size - prev, 0))
                prev = size if size >= 0 else prev
                compiles += grew
                steps_out.append({"label": label,
                                  "wall_ms": round(wall_ms, 3),
                                  "cache_size": size,
                                  "new_compiles": grew})
                reg.histogram(f"entry.{name}.step_ms",
                              lo=1e-3, hi=1e7).observe(wall_ms)
        wall_ms = (time.perf_counter() - t_entry) * 1e3
        reg.counter(f"entry.{name}.compiles").inc(compiles)
        report[name] = {"steps": steps_out, "compiles": compiles,
                        "wall_ms": round(wall_ms, 3)}
    return report
