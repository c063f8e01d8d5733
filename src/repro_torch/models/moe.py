"""Mixture-of-Experts FFN (DeepSeek-V3 / Kimi-K2 style): the port of
``repro/models/moe.py``.

Router: sigmoid scores + an aux-loss-free selection bias (the bias enters
the top-k selection only, not the gate value); the selected gates
renormalised and scaled by ``routed_scaling``; one always-on shared
expert.

Dispatch is GShard-style and capacity-based, built with the sort trick:
per dispatch group, token->expert assignments are sorted by expert id
(stable), ranks within each expert come from a ``searchsorted`` prefix,
and assignments at rank >= capacity drop.  The reference drops them with
``.at[].set(mode="drop")``; here the table has one spare column that
takes every dropped assignment and is cut off, so no index is out of
range and nothing waits on the host.  The combine is a scatter-add over
duplicate targets (``index_add_``), whose float sum order differs from
XLA's.  Top-k ties break toward the lower expert id, as ``lax.top_k``
(``kernels.common.stable_topk``).  Experts whose id >= n_experts are
mesh padding (Kimi: 384 -> 512) and receive no tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis.annotations import hot_path
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.distributed.sharding import ShardPlan, local_region
from repro_torch.kernels.common import stable_topk
from repro_torch.models.layers import swiglu

__all__ = ["moe_params", "moe_capacity", "moe_ffn"]


def moe_params(cfg: LMConfig, mk, plan: ShardPlan, prefix: str, stack: int):
    """Parameter description for ``stack`` stacked MoE layers."""
    m: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.e_pad
    fs = m.n_shared * m.d_ff
    L = (stack,)

    def pp(*dims):                       # leading layer dim unsharded
        return plan.p(None, *dims)

    return {
        "router": mk(f"{prefix}/router", L + (d, m.n_experts),
                     pp(None, None), init=("normal", 0.02),
                     param_dtype=torch.float32),
        "router_bias": mk(f"{prefix}/router_bias", L + (m.n_experts,),
                          pp(None), init="zeros",
                          param_dtype=torch.float32),
        "w_gate": mk(f"{prefix}/w_gate", L + (e, d, f),
                     pp("ep", None, None)),
        "w_up": mk(f"{prefix}/w_up", L + (e, d, f),
                   pp("ep", None, None)),
        "w_down": mk(f"{prefix}/w_down", L + (e, f, d),
                     pp("ep", None, None)),
        "sh_gate": mk(f"{prefix}/sh_gate", L + (d, fs),
                      pp("fsdp", "tp")),
        "sh_up": mk(f"{prefix}/sh_up", L + (d, fs), pp("fsdp", "tp")),
        "sh_down": mk(f"{prefix}/sh_down", L + (fs, d), pp("tp", "fsdp")),
    }


def moe_capacity(cfg: LMConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(tokens_per_group * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _route(x, router_w, router_bias, moe_cfg: MoEConfig):
    """(T, D) -> (top-k ids int32 (T, K), gates fp32 (T, K))."""
    logits = x.float() @ router_w.float()
    if moe_cfg.score_fn == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    sel_scores = scores + router_bias[None, :]     # bias: selection only
    _, top_i = stable_topk(-sel_scores, moe_cfg.top_k)
    top_s = torch.gather(scores, 1, top_i)
    gates = top_s / torch.clamp(top_s.sum(dim=-1, keepdim=True), min=1e-9)
    gates = gates * moe_cfg.routed_scaling
    return top_i.to(torch.int32), gates


def _dispatch_indices(top_i, e_pad: int, capacity: int):
    """Sort-based (E, C) token-slot table + per-assignment placement.

    Returns (dispatch (E, C) int32 token ids, T = the dummy row, and
    (sorted_e, ranks, order) for the gate scatter: the sorted expert of
    each assignment, its rank within the expert, and the permutation).
    """
    t, k = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(-1)                              # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(t * k, dtype=torch.int32, device=dev) - \
        first.to(torch.int32)
    tok = (order // k).to(torch.int32)
    dispatch = torch.full((e_pad, capacity + 1), t, dtype=torch.int32,
                          device=dev)
    dispatch[sorted_e.long(), _slot(ranks, capacity)] = tok
    return dispatch[:, :capacity], (sorted_e.to(torch.int32), ranks,
                                    order.to(torch.int32))


def _slot(ranks, capacity: int):
    """Each assignment's column: its rank, or the spare column
    ``capacity`` where the reference's ``mode="drop"`` drops it."""
    return torch.clamp(ranks.long(), max=capacity)


def _dispatch(xt, router_w, router_bias, moe_cfg: MoEConfig, cap: int):
    """Route every group of ``xt`` (G, T, D): the expert tiles (G, E, C,
    D), their gates (G, E, C) fp32 and the token-slot table (G, E, C)."""
    g, t, d = xt.shape
    dev = xt.device
    xs, gs, ds = [], [], []
    for x_g in xt:
        top_i, gates = _route(x_g, router_w, router_bias, moe_cfg)
        dispatch, (sorted_e, ranks, order) = _dispatch_indices(
            top_i, moe_cfg.e_pad, cap)
        x_pad = torch.cat([x_g, torch.zeros((1, d), dtype=x_g.dtype,
                                            device=dev)], dim=0)
        gate_flat = gates.reshape(-1)[order.long()]
        g_e = torch.zeros((moe_cfg.e_pad, cap + 1), dtype=torch.float32,
                          device=dev)
        g_e[sorted_e.long(), _slot(ranks, cap)] = gate_flat
        xs.append(x_pad[dispatch.long()])                   # (E, C, D)
        gs.append(g_e[:, :cap])
        ds.append(dispatch)
    return torch.stack(xs), torch.stack(gs), torch.stack(ds)


def _combine(y_e, g_e, dispatch, t: int):
    """The gated expert outputs (G, E, C, D) scattered back to each
    group's ``t`` tokens (G, t, D); slot-table entries equal to ``t`` (the
    dummy row) land in a spare row that is cut off."""
    d = y_e.shape[-1]
    ys = []
    for y_g, g_g, d_g in zip(y_e, g_e, dispatch):
        w = (y_g * g_g[..., None].to(y_g.dtype)).reshape(-1, d)
        out = torch.zeros((t + 1, d), dtype=y_g.dtype, device=y_g.device)
        out.index_add_(0, d_g.reshape(-1).long(), w)
        ys.append(out[:t])
    return torch.stack(ys)


@hot_path
def moe_ffn(p: dict, x, cfg: LMConfig, plan: ShardPlan, *, cast=None,
            out_dtype=None):
    """x: (B, S, D) -> (B, S, D).  p: one layer's slice of
    ``moe_params``, its weights cast to ``cast`` (default: ``x``'s
    dtype) where they are used; the output in ``out_dtype`` (default:
    ``x``'s).

    Each stretch between two of the reference's constraints is a
    ``sharding.local_region`` (with no mesh bound, the plain call).  Under
    a bound mesh ``x`` is a DTensor over the batch's shards and ``p``
    holds the DTensor parameters.  The dispatch groups lie over ``dp``
    where ``dp`` divides both the batch and the groups (a rank's batch
    rows are then its groups' tokens; else every rank routes every group)
    and each rank routes and combines its own groups.  The constraint pair
    ("dp", "tp") -> ("pp", "ep") is the expert all-to-all, the experts run
    where their weights lie, and the mirror pair brings the outputs
    back."""
    m = cfg.moe
    b, s, d = x.shape
    g = max(1, cfg.moe_groups)
    t_all = b * s
    if t_all % g:
        raise ValueError(f"{t_all} tokens do not split into {g} groups")
    tg = t_all // g
    cap = moe_capacity(cfg, tg)
    mesh = plan.mesh
    dp_n = plan.axis_size("dp")
    even = b % dp_n == 0 and g % dp_n == 0
    gp = plan.layout(*(("dp",) if even else (None,)), None, None)
    rep = plan.layout(None, None)
    cdt = cast or x.dtype
    odt = out_dtype or x.dtype

    def c(w):
        return w.to(cdt) if w.dtype.is_floating_point else w

    def route(x_, router_w, router_bias):
        return _dispatch(x_.reshape(-1, tg, d), c(router_w),
                         c(router_bias), m, cap)

    x_e, g_e, dispatch = local_region(
        mesh, route, [(x, gp), (p["router"], rep),
                      (p["router_bias"], plan.layout(None))],
        [gp, gp, gp])
    x_e = plan.constrain(x_e, "dp", "tp", None, None)
    x_e = plan.constrain(x_e, "pp", "ep", None, None)
    e_pl = plan.layout("ep", None, None)
    y_e = local_region(
        mesh, lambda xe, a, u, w: _experts(xe, c(a), c(u), c(w)),
        [(x_e, plan.layout("pp", "ep", None, None)), (p["w_gate"], e_pl),
         (p["w_up"], e_pl), (p["w_down"], e_pl)],
        plan.layout("pp", "ep", None, None))
    y_e = plan.constrain(y_e, "pp", "ep", None, None)
    y_e = plan.constrain(y_e, "dp", "tp", None, None)
    y = local_region(
        mesh, lambda ye, ge, dg: _combine(ye, ge, dg, tg).reshape(-1, s, d),
        [(y_e, gp), (g_e, gp), (dispatch, gp)], gp)
    # the always-on shared expert: its hidden units over tp
    bp = plan.layout("dp", None, None)
    sh = local_region(
        mesh, lambda x_, a, u, w: swiglu(x_, c(a), c(u), c(w)),
        [(x, bp), (p["sh_gate"], plan.layout(None, "tp")),
         (p["sh_up"], plan.layout(None, "tp")),
         (p["sh_down"], plan.layout("tp", None))], plan.partial(bp, "tp"))
    return local_region(mesh, lambda a, b_: (a + b_).to(odt),
                        [(y, bp), (sh, bp)], bp)


def _experts(x_e, w_gate, w_up, w_down):
    h = F.silu(torch.einsum("gecd,edf->gecf", x_e, w_gate))
    h = h * torch.einsum("gecd,edf->gecf", x_e, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)
