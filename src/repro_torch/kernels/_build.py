"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` (all started
together) into a shared library with a plain C interface, under
``build/repro_torch/`` at the root of the checkout (``.gitignore`` lists
``build/``).  A library's file name carries a hash of its source, the
shared header and the flags, so an unchanged kernel is built once per
checkout and a changed one is never loaded stale.

Nothing here runs at import: the CPU tests import every module, and this
machine has no ``nvcc``.  A missing compiler or a failed build raises.

A listener added with :func:`add_listener` hears of every library as it
is loaded: ``listener(name, ms, built)``, ``ms`` the ``nvcc`` wall time
(0 for a library an earlier process built), ``built`` whether this call
compiled it.  ``repro_torch.obs.profile.install_compile_hooks`` mirrors
these one-time costs into the profiling registry.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "add_listener", "build_all", "library", "loaded"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("l2_topk", "candidate_topk", "bm25_topk", "pq_adc_topk",
           "hamming_topk", "tree_descent", "count_min", "lsh_probe",
           "attention")
HEADERS = ("topk_common.cuh", "lexical.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_logs: dict = {}
_listeners: list = []


def add_listener(fn) -> None:
    """Call ``fn(name, ms, built)`` for every library loaded from now on
    (once per process: adding the same listener again does nothing)."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)


def loaded() -> int:
    """How many kernel libraries this process has loaded."""
    return len(_libs)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Build (or reuse) every library; returns ``{name: {"seconds",
    "ptxas"}}``, ``ptxas`` being the ``-Xptxas -v`` report lines (empty
    when the library was already built)."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        for name in todo:
            out = _target(name)
            if out.exists():
                _logs[name] = {"seconds": 0.0, "ptxas": []}
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), time.perf_counter(), tmp, out)
        failed = []
        for name, (proc, t0, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
            _logs[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": [ln.strip() for ln in log.splitlines()
                                     if "ptxas" in ln or "spill" in ln]}
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
            for fn in _listeners:
                fn(name, _logs[name]["seconds"] * 1e3, name in procs)
        return {n: dict(_logs[n]) for n in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib
