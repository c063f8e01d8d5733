"""Atomic, async checkpoints of a tree of tensors -- the port of
``repro/train/checkpoint.py``, in the reference's on-disk layout::

    <dir>/step_<N>/
        manifest.json   # leaf names, shapes, dtypes, crc32s, step, meta
        <leaf>.npy      # one file a leaf
        COMMITTED       # written last; restores ignore uncommitted dirs

A leaf's name is its path, the keys joined by ``__``, as
``jax.tree_util.tree_flatten_with_path`` names it: a dict's keys, a list's
or tuple's indices, and an object with ``tree_flatten`` (the train state)
its children's indices; ``None`` holds no leaf.  So a ``TrainState``
gives ``0`` (the step), ``1__<param path>``, ``2__<optimizer state
path>`` and ``3__...`` only with an error-feedback buffer, and a
checkpoint written by either package restores into the other.  bf16
leaves are stored as the reference stores them: two raw bytes an element
(numpy's ``V2``) under the manifest dtype ``bfloat16``.

Writes go to ``step_<N>.tmp`` and rename atomically after the manifest's
fsync -- a crash mid-save never corrupts the latest checkpoint; the
oldest committed steps past ``keep_last`` are removed.  ``save_async``
copies every leaf to host memory before it returns (a real copy, also of
a CPU tensor, since a train step may update its tensors in place), then
writes on a worker thread.  ``restore`` checks each file's CRC and puts
each leaf on its template leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending",
           "leaf_paths"]

_pending: list[threading.Thread] = []


def _children(tree):
    """(keys, children) of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return list(range(len(tree))), list(tree)
    if hasattr(tree, "tree_flatten"):
        children, _ = tree.tree_flatten()
        return list(range(len(children))), list(children)
    return None


def leaf_paths(tree, prefix: str = "") -> list:
    """``(name, leaf)`` for every leaf of ``tree``, in flattening order."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    return [pair for k, c in zip(*node)
            for pair in leaf_paths(c, f"{prefix}__{k}" if prefix
                                   else str(k))]


def _rebuild(tree, fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``fn(name, leaf)``."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(prefix, tree)
    keys, kids = node
    new = [_rebuild(c, fn, f"{prefix}__{k}" if prefix else str(k))
           for k, c in zip(keys, kids)]
    if isinstance(tree, dict):
        return dict(zip(keys, new))
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    _, aux = tree.tree_flatten()
    return type(tree).tree_unflatten(aux, new)


def _to_host(leaf) -> tuple:
    """(a numpy copy of ``leaf``, its manifest dtype); bf16 as raw ``V2``
    elements under ``bfloat16``."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _snapshot(tree) -> list:
    return [(name, *_to_host(leaf)) for name, leaf in leaf_paths(tree)]


def save(dirpath: str, step: int, tree, meta: Optional[dict] = None,
         keep_last: int = 3):
    """Synchronous atomic checkpoint of a tree."""
    _write(dirpath, step, _snapshot(tree), meta or {}, keep_last)


def save_async(dirpath: str, step: int, tree, meta: Optional[dict] = None,
               keep_last: int = 3):
    """Copy to host now, write on a background thread."""
    host = _snapshot(tree)
    t = threading.Thread(target=_write,
                         args=(dirpath, step, host, meta or {}, keep_last),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    for t in list(_pending):
        t.join()
        _pending.remove(t)


def _write(dirpath, step, host: list, meta, keep_last):
    final = os.path.join(dirpath, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta, "leaves": {}}
    for name, arr, dtype in host:
        fp = os.path.join(tmp, name + ".npy")
        np.save(fp, arr)
        with open(fp, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": dtype, "crc": crc,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(dirpath, keep_last)


def _committed_steps(dirpath: str) -> list:
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(dirpath)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(dirpath, d, "COMMITTED")))


def _gc(dirpath, keep_last):
    for s in _committed_steps(dirpath)[:-keep_last]:
        shutil.rmtree(os.path.join(dirpath, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(dirpath: str) -> Optional[int]:
    if not os.path.isdir(dirpath):
        return None
    steps = _committed_steps(dirpath)
    return steps[-1] if steps else None


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")          # 0-d stays 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def restore(dirpath: str, step: int, template, verify: bool = True) -> Any:
    """Load a checkpoint into ``template``'s structure, each leaf in the
    file's dtype on its template leaf's device."""
    d = os.path.join(dirpath, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for name, info in manifest["leaves"].items():
        fp = os.path.join(d, name + ".npy")
        if verify:
            with open(fp, "rb") as f:
                if zlib.crc32(f.read()) != info["crc"]:
                    raise IOError(f"checkpoint leaf {name} failed CRC")
        leaves[name] = (np.load(fp), info["dtype"])

    def load(name, leaf):
        arr, dtype = leaves[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs template "
                f"{tuple(leaf.shape)}")
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return _from_host(arr, dtype, dev)

    return _rebuild(template, load)
