"""SchNet: continuous-filter convolution GNN  [arXiv:1706.08566] — the
port of ``repro/models/schnet.py``, in plain PyTorch.

Message passing IS ``segment_sum`` over the edge list (taxonomy §GNN):
   m_e = (h[sender] W1) * filter(RBF(d_e));   h' += W2 ssp(segsum_e->recv m)

``jax.ops.segment_sum`` becomes ``index_add_`` into zeros of one row a
node (``_segment_sum``).  On the card its atomics add in no fixed order,
so the card agrees with the CPU to rounding only; at bf16 messages the
atomics accumulate in bf16.  Padded edges (``-1``) are masked to zero
before they reach node 0, as in the reference.  Two heads: per-node logits
(citation-graph shapes) and pooled per-graph energy (molecule shape).  The
neighbor list for molecule inputs comes from
``core.graph_build.radius_graph`` — the paper's two-level machinery
(DESIGN.md §5).

Dtypes follow ``jnp``'s promotion: at ``message_dtype="bfloat16"`` the
node state starts in bf16, and the first interaction's residual add
(``h + upd + b2``, ``b2`` fp32) returns it to fp32, as in the reference.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.analysis.annotations import hot_path
from repro_torch.configs.base import SchNetConfig
from repro_torch.distributed.sharding import LOCAL_PLAN, ShardPlan
from repro_torch.models import base
from repro_torch.models.attention import _ein
from repro_torch.models.layers import shifted_softplus

__all__ = ["init", "param_specs", "param_shapes", "forward", "node_logits",
           "graph_energy", "loss_fn"]


def _param_fn(cfg: SchNetConfig, mk, plan: ShardPlan):
    h, r = cfg.d_hidden, cfg.n_rbf
    L = (cfg.n_interactions,)
    pp = lambda *d: plan.p(*d)   # noqa: E731  tiny params: replicated
    sp = lambda *d: plan.p(None, *d)   # noqa: E731
    return {
        "embed_in": mk("embed_in", (cfg.d_feat, h), pp(None, None)),
        "inter": {
            "w1": mk("inter/w1", L + (h, h), sp(None, None)),
            "f_w1": mk("inter/f_w1", L + (r, h), sp(None, None)),
            "f_b1": mk("inter/f_b1", L + (h,), sp(None), init="zeros"),
            "f_w2": mk("inter/f_w2", L + (h, h), sp(None, None)),
            "f_b2": mk("inter/f_b2", L + (h,), sp(None), init="zeros"),
            "w2": mk("inter/w2", L + (h, h), sp(None, None)),
            "b2": mk("inter/b2", L + (h,), sp(None), init="zeros"),
        },
        "head_w1": mk("head_w1", (h, h // 2), pp(None, None)),
        "head_b1": mk("head_b1", (h // 2,), pp(None), init="zeros"),
        "head_w2": mk("head_w2", (h // 2, cfg.n_out), pp(None, None)),
    }


def init(cfg: SchNetConfig, seed: int = 0, plan: ShardPlan = LOCAL_PLAN,
         device=None):
    """The parameter tree, initialised from ``seed`` on ``device``
    (``None``: the card)."""
    return base.build_params(partial(_param_fn, plan=plan), cfg, seed,
                             device=device)


def param_specs(cfg: SchNetConfig, plan: ShardPlan):
    return base.build_specs(partial(_param_fn, plan=plan), cfg)


def param_shapes(cfg: SchNetConfig, plan: ShardPlan = LOCAL_PLAN):
    """``meta`` tensors of every parameter's shape and dtype."""
    return base.build_shapes(partial(_param_fn, plan=plan), cfg)


def _segment_sum(x, seg, n: int):
    """``jax.ops.segment_sum(x, seg, num_segments=n)``: rows of ``x``
    summed into ``n`` rows by ``seg`` (every id in ``[0, n)``)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def _rbf(dist, cfg: SchNetConfig):
    """Gaussian radial basis on [0, cutoff], gamma from center spacing."""
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf,
                             dtype=torch.float32, device=dist.device)
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


@hot_path
def forward(params, batch: dict, cfg: SchNetConfig,
            plan: ShardPlan = LOCAL_PLAN):
    """batch: {feats (N,F), pos (N,3), senders (E,), receivers (E,),
    [graph_ids (N,) + n_graphs]} -> per-node hidden (N, h).

    senders/receivers use -1 for padded edges (masked out of the message
    sum).
    """
    dev = params["embed_in"].device
    feats = torch.as_tensor(batch["feats"], dtype=torch.float32, device=dev)
    pos = torch.as_tensor(batch["pos"], dtype=torch.float32, device=dev)
    snd = torch.as_tensor(batch["senders"], dtype=torch.int64, device=dev)
    rcv = torch.as_tensor(batch["receivers"], dtype=torch.int64,
                          device=dev)
    n = feats.shape[0]
    h = _ein("nf,fh->nh", feats, params["embed_in"])
    if cfg.message_dtype == "bfloat16":
        # node state in bf16 too: the *gradient* all-reduces (cotangent of
        # the replicated node state w.r.t. sharded edges) follow h's dtype
        h = h.to(torch.bfloat16)

    edge_valid = (snd >= 0) & (rcv >= 0)
    s_safe = torch.clamp(snd, min=0)
    r_safe = torch.clamp(rcv, min=0)
    dvec = pos[s_safe] - pos[r_safe]
    dist = torch.sqrt(torch.clamp((dvec * dvec).sum(-1), min=1e-12))
    rbf = _rbf(dist, cfg)                                   # (E, R)
    # smooth cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                 + 1.0)
    rbf = plan.constrain(rbf * env[:, None], ("dp", "tp"), None)

    mdt = torch.bfloat16 if cfg.message_dtype == "bfloat16" \
        else torch.float32

    def interaction(h, ip):
        hw = _ein("nh,hg->ng", h, ip["w1"])
        w = shifted_softplus(_ein("er,rh->eh", rbf, ip["f_w1"]) + ip["f_b1"])
        w = shifted_softplus(_ein("eh,hg->eg", w, ip["f_w2"])
                             + ip["f_b2"])                  # (E, h)
        # messages AND everything until the residual add stay in
        # message_dtype (the reference's cross-shard aggregate carries
        # bf16); padded edges are zeroed before they reach node 0
        m = hw[s_safe].to(mdt) * w.to(mdt)
        m = torch.where(edge_valid[:, None], m,
                        torch.zeros((), dtype=mdt, device=m.device))
        agg = _segment_sum(m, r_safe, n)
        upd = _ein("nh,hg->ng", shifted_softplus(agg), ip["w2"].to(mdt))
        return h + upd.to(h.dtype) + ip["b2"]

    for i in range(cfg.n_interactions):
        h = interaction(h, {k: v[i] for k, v in params["inter"].items()})
    return h


def node_logits(params, h):
    z = shifted_softplus(_ein("nh,hg->ng", h, params["head_w1"])
                         + params["head_b1"])
    return _ein("nh,hg->ng", z, params["head_w2"])


def graph_energy(params, h, graph_ids, n_graphs: int):
    z = node_logits(params, h)[:, 0]                        # atomwise energy
    gid = torch.as_tensor(graph_ids, dtype=torch.int64, device=z.device)
    return _segment_sum(z, torch.clamp(gid, min=0), n_graphs)


@hot_path
def loss_fn(params, batch: dict, cfg: SchNetConfig,
            plan: ShardPlan = LOCAL_PLAN):
    """Node-classification CE when batch has 'labels'; energy MSE when it
    has 'energy' (+ graph_ids/n_graphs)."""
    dev = params["embed_in"].device
    h = forward(params, batch, cfg, plan)
    if "labels" in batch:
        logits = node_logits(params, h)
        lf = logits.float()
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64,
                                 device=dev)
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, 1, labels[:, None])[:, 0]
        mask = batch.get("node_mask")
        mask = torch.ones_like(ll) if mask is None else \
            torch.as_tensor(mask, dtype=torch.float32, device=dev)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = ((lse - ll) * mask).sum() / denom
        acc = ((torch.argmax(lf, -1) == labels) * mask).sum() / denom
        return loss, {"loss": loss, "accuracy": acc}
    energy = torch.as_tensor(batch["energy"], dtype=torch.float32,
                             device=dev)
    n_graphs = energy.shape[0]                 # static via shape
    e = graph_energy(params, h, batch["graph_ids"], n_graphs)
    loss = torch.mean((e - energy) ** 2)
    return loss, {"loss": loss}
