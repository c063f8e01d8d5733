"""Optimizers: SGD-M, AdamW, Adafactor -- the port of
``repro/train/optim.py``.

Each optimizer has one rule, ``opt.leaf(p, g, s, step)``, that updates a
parameter leaf and its state leaves in place (the reference's train step
is jitted with its state donated, so it too overwrites the state).
``apply_in_place`` runs it leaf by leaf over a tree, dropping each
gradient as it is applied; ``opt.update(grads, state, params, step) ->
(new_params, new_state)`` is the reference's functional form, the same
rule on copies, the inputs kept.  ``opt.init(params) -> state``.  ``step``
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import move, place_on
from repro_torch.train.tree import leaves, map_trees

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "state_specs",
           "warmup_cosine", "constant_lr", "global_norm", "clip_by_norm",
           "apply_in_place"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    # (p, g, s, step) -> None: one parameter leaf and its state (``s``:
    # the state's top-level name -> that leaf's part) updated in place on
    # their local shards
    leaf: Callable
    state_spec_fn: Callable    # (param_spec, shape) -> state spec tree

    def update(self, grads, state, params, step):
        """``(new_params, new_state)``: ``leaf`` on copies of ``params``
        and ``state`` (the inputs kept, as the reference's update)."""
        new_p, new_s = map_trees(_copy, params), map_trees(_copy, state)
        apply_in_place(self, map_trees(lambda g: g, grads), new_s, new_p,
                       step)
        return new_p, new_s


def _like(x, loc):
    """``loc`` as a leaf placed as ``x`` (``loc`` itself for a plain
    ``x``)."""
    if not isinstance(x, DTensor):
        return loc
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _copy(x):
    """A copy of a leaf (a DTensor's local shard copied, re-wrapped)."""
    return _like(x, _local(x).clone())


def _zeros(p, drop=None) -> torch.Tensor:
    """fp32 zeros of ``p``'s shape without dim ``drop`` (a factored
    statistic); for a DTensor ``p`` placed as ``p`` is, the dropped dim's
    shards replicated (the reference's ``state_specs``)."""
    shape = tuple(p.shape)
    if drop is not None:
        drop %= len(shape)
        shape = shape[:drop] + shape[drop + 1:]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    pl = []
    for q in p.placements:
        if isinstance(q, Shard) and drop is not None and q.dim >= drop:
            q = Replicate() if q.dim == drop else Shard(q.dim - 1)
        pl.append(q)
    return place_on(torch.zeros(shape, dtype=torch.float32,
                                device=p.to_local().device),
                    p.device_mesh, pl)


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


# a leaf above this many elements is reduced and updated in chunks of
# its local shard (fp32 temporaries of a whole 3.8e9-element expert leaf
# would not fit beside the bf16 parameters and gradients on one card)
BIG_LEAF = 1 << 28
_CHUNK = 1 << 26


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _split(x, first: int = 0) -> bool:
    """Whether a DTensor leaf is cut over more than one rank (along a dim
    from ``first`` on)."""
    return isinstance(x, DTensor) and any(
        isinstance(q, Shard) and n > 1 and q.dim >= first
        for q, n in zip(x.placements, x.device_mesh.mesh.shape))


def _gathered(x, first: int):
    """A DTensor leaf with its dims from ``first`` on whole on every
    rank (a new tensor)."""
    return move(x, [Replicate() if isinstance(q, Shard) and q.dim >= first
                    else q for q in x.placements])


def _mesh_total(local_sum, like):
    """A per-rank sum over ``like``'s local shard as the sum over the
    whole leaf, the same plain tensor on every rank (an all-reduce over
    the mesh dims that shard it)."""
    if not _split(like):
        return local_sum
    pl = [Partial() if isinstance(q, Shard) else Replicate()
          for q in like.placements]
    total = DTensor.from_local(local_sum, like.device_mesh, pl,
                               run_check=False)
    return move(total, [Replicate()] * len(pl)).to_local()


def _sq_sum(x):
    """fp32 sum of squares of one leaf, over its local shard and summed
    over the mesh; a shard above ``BIG_LEAF`` elements is summed chunk by
    chunk (the same sum to rounding)."""
    loc = _local(x)
    if loc.numel() <= BIG_LEAF:
        return _mesh_total(torch.sum(torch.square(loc.float())), x)
    flat = loc.reshape(-1)
    tot = sum(torch.sum(torch.square(flat[i:i + _CHUNK].float()))
              for i in range(0, flat.numel(), _CHUNK))
    return _mesh_total(tot, x)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves
    added in sorted key order (DTensor leaves over the whole mesh; the
    norm a plain tensor, the same on every rank)."""
    return torch.sqrt(sum(_sq_sum(x) for x in leaves(tree)))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_norm(tree, max_norm: float):
    """``tree`` scaled to ``max_norm`` at most, and its global norm."""
    n = global_norm(tree)
    scale = _clip_scale(n, max_norm)
    return map_trees(lambda x: x * scale.to(x.dtype), tree), n


def _axpy(a: float, m, g):
    """``a * m + g`` as ``jnp`` computes it: the Python scalar is weakly
    typed and takes ``m``'s dtype (bf16 0.9 for a bf16 ``m``, where torch
    would multiply by the fp32 0.9), each op rounds to its result dtype."""
    return m * torch.full((), a, dtype=m.dtype, device=m.device) + g


def sgd(lr_fn, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": map_trees(lambda p: torch.zeros_like(p) if not
                                isinstance(p, DTensor) else
                                _zeros(p).to(p.dtype), params)}

    @torch.no_grad()
    def leaf(p, g, s, step):
        lr = lr_fn(_local(step))
        pl, gl, mu = _local(p), _local(g), _local(s["mu"])
        mu.copy_(_axpy(momentum, mu, gl))
        u = _axpy(momentum, mu, gl) if nesterov else mu
        pl.copy_(pl - _scaled(lr, u).to(pl.dtype))

    return Optimizer("sgd", init, leaf,
                     lambda spec, shape: {"mu": spec})


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return {"m": map_trees(_zeros, params),
                "v": map_trees(_zeros, params)}

    @torch.no_grad()
    def leaf(p, g, s, step):
        step = _local(step)
        lr = lr_fn(step)
        t = _step_f32(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        pl, gf = _local(p), _local(g).float()
        m, v = _local(s["m"]), _local(s["v"])
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay and p.dim() >= 2:    # no decay on norms/biases
            u = u + weight_decay * pl.float()
        pl.copy_((pl.float() - lr * u).to(pl.dtype))

    return Optimizer("adamw", init, leaf,
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
            if factored(p.shape):
                return {"vr": _zeros(p, -1), "vc": _zeros(p, -2)}
            return {"v": _zeros(p)}
        return {"stats": map_trees(st, params)}

    def rule(p, g, s, step):
        """The update of one leaf in place, on its local shard, whose
        factored dims each rank holds whole; the update's RMS is summed
        over the mesh.  A leaf above ``BIG_LEAF`` elements runs in blocks
        of about ``_CHUNK`` elements (whole experts of a stacked expert
        leaf, else runs of rows, the column statistic then summed over the
        blocks): one pass updates the statistics, one sums the RMS, one
        applies it, so no fp32 temporary of the whole leaf is ever held.
        A smaller leaf is one block."""
        fac = factored(p.shape)
        step = _local(step)
        lr = lr_fn(step)
        t = _step_f32(step) + 1.0
        beta = 1.0 - t ** (-decay)
        pl, gl = _local(p), _local(g)
        big = pl.numel() > BIG_LEAF
        whole = not _split(p) and not big
        if fac:
            rows, cols = pl.shape[-2], pl.shape[-1]
            p3, g3 = pl.view(-1, rows, cols), gl.view(-1, rows, cols)
            vr3 = _local(s["vr"]).view(-1, rows)
            vc3 = _local(s["vc"]).view(-1, cols)
            n_all = p3.shape[0]
            per_n = max(1, _CHUNK // (rows * cols)) if big else n_all
            per_r = rows if not big or rows * cols <= _CHUNK else \
                max(1, _CHUNK // cols)
        else:
            p3, g3 = pl.view(1, 1, -1), gl.view(1, 1, -1)
            v3 = _local(s["v"]).view(1, 1, -1)
            n_all, rows, cols = 1, 1, p3.shape[-1]
            per_n, per_r = 1, 1
        step_c = _CHUNK if big and not fac else cols
        blocks = [(slice(n, n + per_n), slice(r, r + per_r),
                   slice(c, c + step_c))
                  for n in range(0, n_all, per_n)
                  for r in range(0, rows, per_r)
                  for c in range(0, cols, step_c)]
        col_sum = None
        if fac and per_r < rows:
            col_sum = torch.zeros(vc3.shape, dtype=torch.float32,
                                  device=vc3.device)
        for bn, br, bc in blocks:
            g2 = torch.square(g3[bn, br, bc].float()).add_(eps)
            if not fac:
                v3[bn, br, bc] = beta * v3[bn, br, bc] + (1 - beta) * g2
            else:
                vr3[bn, br] = beta * vr3[bn, br] + (1 - beta) * g2.mean(
                    dim=-1)
                if col_sum is None:
                    vc3[bn] = beta * vc3[bn] + (1 - beta) * g2.mean(dim=-2)
                else:
                    col_sum[bn] += g2.sum(dim=-2)
            del g2
        if col_sum is not None:
            vc3.copy_(beta * vc3 + (1 - beta) * (col_sum / rows))
        if fac:
            r_mean = torch.clamp(vr3.mean(dim=-1, keepdim=True), min=eps)

        def u_of(bn, br, bc):
            gc = g3[bn, br, bc].float()
            if not fac:
                return gc / (torch.sqrt(v3[bn, br, bc]) + eps)
            r = vr3[bn, br] / r_mean[bn]
            return gc / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc3[bn])[..., None, :] + eps)

        sq = []
        for b in blocks:
            u = u_of(*b)
            sq.append(torch.mean(u * u) if whole else torch.sum(u * u))
            del u
        if whole:
            rms = torch.sqrt(sq[0])
        else:
            rms = torch.sqrt(_mesh_total(sum(sq), p) / p.numel())
        div = torch.clamp(rms / clip_threshold, min=1.0)
        for b in blocks:
            u = u_of(*b) / div
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * p3[b].float()
            p3[b] = (p3[b].float() - lr * u).to(p3.dtype)

    @torch.no_grad()
    def leaf(p, g, s, step):
        st = s["stats"]
        nd = p.dim()
        if not (factored(p.shape) and _split(p, first=nd - 2)):
            rule(p, g, st, step)
            return
        # the factored statistics reduce over the last two dims: those
        # dims of the leaf, its gradient and its statistics are gathered,
        # updated, and each rank keeps its shards again
        pw, gw = _gathered(p, nd - 2), _gathered(g, nd - 2)
        sw = {k: _gathered(v, nd - 2) for k, v in st.items()}
        rule(pw, gw, sw, step)
        _local(p).copy_(_local(move(pw, p.placements)))
        for k, v in st.items():
            _local(v).copy_(_local(move(sw[k], v.placements)))

    def spec_fn(spec, shape):
        if factored(tuple(shape)):
            parts = list(spec) if spec is not None else [None] * len(shape)
            while len(parts) < len(shape):
                parts.append(None)
            return {"vr": tuple(parts[:-1]),
                    "vc": tuple(parts[:-2] + parts[-1:])}
        return {"v": spec}

    return Optimizer("adafactor", init, leaf, spec_fn)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, prefix=()) -> list:
    """Key paths to ``tree``'s leaves, in sorted key order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                         prefix + (k,))]
    return [prefix]


def apply_in_place(opt: Optimizer, grads, state, params, step,
                   max_norm=None):
    """``opt.leaf`` leaf by leaf, each parameter and its state written in
    place and each gradient dropped from ``grads`` once applied, so the
    peak holds one leaf's temporaries beside the parameters and the rest
    of the gradients.  DTensor leaves update on their local shards (the
    gradient and the state lie as the parameter does).  ``max_norm``:
    the gradients are first clipped to that global norm (``clip_by_norm``'s
    scale, each gradient scaled as it is taken), and the norm is
    returned."""
    norm = None
    if max_norm is not None:
        norm = global_norm(grads)
        scale = _clip_scale(norm, max_norm)
    for path in _paths(params):
        parent = _at(grads, path[:-1])
        g = parent[path[-1]]
        parent[path[-1]] = None
        if max_norm is not None:
            g = _like(g, _local(g) * scale.to(g.dtype))
        opt.leaf(_at(params, path), g,
                 {k: _at(v, path) for k, v in state.items()}, step)
        del g
    return norm


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
