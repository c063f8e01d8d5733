"""Optimizers: SGD-M, AdamW, Adafactor -- the port of
``repro/train/optim.py``.

Functional, as the reference: ``opt.init(params) -> state``;
``opt.update(grads, state, params, step) -> (new_params, new_state)``,
new tensors for every leaf, computed under ``torch.no_grad()``.  ``step``
is the train state's int32 step (a tensor on the parameters' device, or
an int); the schedules and the bias corrections read it as an fp32
tensor, as the reference does (``b1 ** t`` is an fp32 power, not a
Python float).  ``state_specs`` mirrors a parameter spec tree (the
``ShardPlan.p`` tuples of ``param_specs``) onto the optimizer state, so
the state shards exactly like its parameter.

The leaf rules are the reference's, on the reference's leaf shapes
(stacked layer params, so a stacked norm ``(L, d)`` is 2-D): AdamW decays
every leaf with ``ndim >= 2``; Adafactor factors its second moment over
the last two dims when both are at least ``min_dim_factored``.  Products
of the fp32 learning rate with a bf16 update run in fp32 (``jnp``'s
promotion of a non-weak fp32 scalar), then cast to the parameter's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.train.tree import leaves, map_trees, pick

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "state_specs",
           "warmup_cosine", "constant_lr", "global_norm", "clip_by_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable           # (grads, state, params, step) -> (p', s')
    state_spec_fn: Callable    # (param_spec, shape) -> state spec tree


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1):
    def lr(step):
        step = _step_f32(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_lr(v: float):
    return lambda step: torch.full((), v, dtype=torch.float32,
                                   device=_step_f32(step).device)


def _scaled(lr, u):
    """``lr * u`` in the promoted dtype (fp32 for a bf16 ``u``)."""
    return lr * u.to(torch.promote_types(lr.dtype, u.dtype))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves
    added in sorted key order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return map_trees(lambda x: x * scale.to(x.dtype), tree), n


def _axpy(a: float, m, g):
    """``a * m + g`` as ``jnp`` computes it: the Python scalar is weakly
    typed and takes ``m``'s dtype (bf16 0.9 for a bf16 ``m``, where torch
    would multiply by the fp32 0.9), each op rounds to its result dtype."""
    return m * torch.full((), a, dtype=m.dtype, device=m.device) + g


def sgd(lr_fn, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": map_trees(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        mu = map_trees(lambda m, g: _axpy(momentum, m, g), state["mu"],
                       grads)
        if nesterov:
            upd = map_trees(lambda m, g: _axpy(momentum, m, g), mu, grads)
        else:
            upd = mu
        new_p = map_trees(lambda p, u: p - _scaled(lr, u).to(p.dtype),
                          params, upd)
        return new_p, {"mu": mu}

    return Optimizer("sgd", init, update,
                     lambda spec, shape: {"mu": spec})


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
        return {"m": map_trees(z, params), "v": map_trees(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _step_f32(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and p.dim() >= 2:    # no decay on norms/biases
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), m, v

        out = map_trees(upd, params, grads, state["m"], state["v"])
        return pick(out, 0), {"m": pick(out, 1), "v": pick(out, 2)}

    return Optimizer("adamw", init, update,
                     lambda spec, shape: {"m": spec, "v": spec})


def adafactor(lr_fn, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              min_dim_factored: int = 128) -> Optimizer:
    """Factored second-moment Adafactor (Shazeer & Stern), momentum-free."""

    def factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_factored \
            and shape[-2] >= min_dim_factored

    def init(params):
        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"stats": map_trees(st, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _step_f32(step) + 1.0
        beta = 1.0 - t ** (-decay)

        def upd(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / (torch.sqrt(v) + eps)
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), ns

        # walked along the params' structure: each param's stats dict whole
        out = map_trees(upd, params, grads, state["stats"])
        return pick(out, 0), {"stats": pick(out, 1)}

    def spec_fn(spec, shape):
        if factored(tuple(shape)):
            parts = list(spec) if spec is not None else [None] * len(shape)
            while len(parts) < len(shape):
                parts.append(None)
            return {"vr": tuple(parts[:-1]),
                    "vc": tuple(parts[:-2] + parts[-1:])}
        return {"v": spec}

    return Optimizer("adafactor", init, update, spec_fn)


def state_specs(opt: Optimizer, param_specs, param_shapes):
    """Spec tree matching ``opt.init(params)``'s structure.
    ``param_shapes``: tensors (``meta`` ones do) of each leaf's shape."""
    def part(key=None):
        def one(spec, shp):
            out = opt.state_spec_fn(spec, tuple(shp.shape))
            return out if key is None else out[key]
        return map_trees(one, param_specs, param_shapes)

    if opt.name == "adamw":
        return {"m": part("m"), "v": part("v")}
    if opt.name == "sgd":
        return {"mu": part("mu")}
    if opt.name == "adafactor":
        return {"stats": part()}
    raise ValueError(opt.name)
