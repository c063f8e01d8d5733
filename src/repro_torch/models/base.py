"""Functional parameter system: the port of ``repro/models/base.py``.

A model describes its parameters once, through a ``mk`` callback::

    def params(cfg, mk):
        return {"w": mk("w", (d, f), plan.p("fsdp", "tp"), init="fanin")}

and three interpreters consume the description:

  * ``build_params(fn, cfg, seed, device=...)`` -> nested dict of tensors
  * ``build_specs(fn, cfg)``  -> the same structure of ``ShardPlan.p``
                                 tuples (one mesh-axis tuple or None a dim)
  * ``build_shapes(fn, cfg)`` -> the same structure of ``meta`` tensors
                                 (shape and dtype, no storage)

Each parameter draws from its own ``torch.Generator`` seeded from
``(seed, md5(name))``, as the reference folds the name's hash into its
root key, so adding a parameter never reshuffles the others.  The values
are not the reference's (another generator); tests carry the reference's
weights across instead (``repro_torch.convert.lm_params_from_arrays``).
"""
from __future__ import annotations

import hashlib
from typing import Callable

import torch

from repro_torch.device import resolve

__all__ = ["build_params", "build_specs", "build_shapes", "count_params",
           "cast_tree", "tree_bytes", "tree_leaves", "tree_map"]

# normal draws are made this many elements at a time (fp32), so a large
# bf16 weight never needs a whole fp32 copy of itself
_DRAW_CHUNK = 1 << 26


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _name_seed(seed: int, name: str) -> int:
    """The generator seed of one parameter: the root seed and the first
    four bytes of the name's md5 (little endian), as ``_name_fold``,
    mixed by splitmix64 (the CPU generator keeps only the seed's low 32
    bits, so every bit of both must reach them)."""
    h = int.from_bytes(hashlib.md5(name.encode()).digest()[:4], "little")
    m = (1 << 64) - 1
    z = (((int(seed) << 32) | h) + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _normal(shape, std: float, dtype, device, gen) -> torch.Tensor:
    """``normal(shape) * std`` drawn in fp32, then cast to ``dtype``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _DRAW_CHUNK):
        n = min(_DRAW_CHUNK, flat.numel() - s)
        part = torch.randn(n, generator=gen, device=device,
                           dtype=torch.float32)
        flat[s:s + n].copy_(part.mul_(std))
    return out


def _init_array(seed: int, name: str, shape, init, dtype, device):
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if isinstance(init, (int, float)):
        return torch.full(shape, float(init), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_name_seed(seed, name))
    if init == "fanin":  # variance scaling, fan_in
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return _normal(shape, (1.0 / max(1, fan_in)) ** 0.5, dtype, device,
                       gen)
    if isinstance(init, tuple) and init[0] == "normal":
        return _normal(shape, float(init[1]), dtype, device, gen)
    raise ValueError(f"unknown init {init!r}")


def build_params(fn: Callable, cfg, seed: int = 0, dtype=torch.float32,
                 device=None):
    """The description's tensors, initialised on ``device`` (``None``:
    the card)."""
    dev = resolve(device)

    def mk(name, shape, spec, init="fanin", param_dtype=None):
        del spec
        return _init_array(seed, name, tuple(shape), init,
                           param_dtype or dtype, dev)

    with torch.no_grad():
        return fn(cfg, mk)


def build_specs(fn: Callable, cfg):
    def mk(name, shape, spec, init="fanin", param_dtype=None):
        del name, shape, init, param_dtype
        return spec if spec is not None else ()

    return fn(cfg, mk)


def build_shapes(fn: Callable, cfg, dtype=torch.float32):
    """``meta`` tensors: each parameter's shape and dtype, no storage."""
    def mk(name, shape, spec, init="fanin", param_dtype=None):
        del name, spec, init
        return torch.empty(tuple(shape), dtype=param_dtype or dtype,
                           device="meta")

    return fn(cfg, mk)


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def cast_tree(tree, dtype):
    """Every floating leaf cast to ``dtype`` (a no-op where it already is);
    integer leaves unchanged."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
