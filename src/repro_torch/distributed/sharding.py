"""Sharded search: the role plans, device arrays, the per-shard brute
(fp32 / int8), lexical, hybrid, IVF and forest locals, the forest's shard
layouts and delta slicers, the collective over a mesh, and the merge of
per-shard results.

Port of ``repro/distributed/sharding.py``.  The reference is one
controller over a mesh: each chip runs a local over its shard inside
``shard_map`` and an ``all_gather`` brings every shard's top-k together
for ``_merge_gathered``.  The port is SPMD, one process a card: a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
the reference's axis names (``"data"``, ``"model"``, ``"pod"``), each
rank places one shard, and :class:`MeshCollective` all-gathers the
shards' ``(B, k)`` results over the corpus axes, in the order of the
shard's flat index ``lin`` (row-major over ``axes`` as given, what JAX's
``axis_index`` over a tuple computes).  With ``query_axes`` each rank
scans its block of the padded batch and the merged blocks are gathered
over the query axes, so every rank returns the whole batch.  Without a
mesh there is one shard and no collective.

The locals are pure functions of the shard's tables, its ``lin`` and the
queries, and return the shard's ``(B, k)`` top-k with global ids (brute
kinds: ``li + lin * shard_rows``; IVF and forest: the bucket tables
already hold global ids).  Bucket tables are padded to ``ceil(K / S) * S``
buckets and the IVF local masks the pad centroids by global bucket index.

The forest (tree/QLBT bottom) is sliced per shard into fixed shapes
(``ForestShardShapes``): *packed* (buckets back to back) or *slab* (every
bucket at a fixed node and leaf window, so one rebuilt bucket is a
fixed-shape payload, ``slice_forest_delta``, scattered in place).  The
slicers are numpy copies of the reference's.

``fused=True`` routes the per-shard scan through ``kernels.ops`` (the
CUDA kernels on the card, their plain versions on the CPU);
``fused=False`` runs the reference's unfused ops.  On the CPU both give
the same ids, since the plain versions are built from the same ops.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import Counter
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.analysis.annotations import hot_path
from repro_torch.core.brute import batched_l2sq, pairwise_l2sq
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.common import INF, pad_sentinel, stable_topk
from repro_torch.kernels.ref import bm25_dists_ref

__all__ = ["ShardPlan", "SINGLE_POD_PLAN", "MULTI_POD_PLAN", "LOCAL_PLAN",
           "REDISTRIBUTES", "COLLECTIVE_BYTES", "COLLECTIVE_COUNTS",
           "MOVE_ROUTES", "exchange_groups", "move", "local_region",
           "place_on", "zeros_on", "whole", "local", "local_offset",
           "layer_of",
           "ShardSlot", "MeshCollective",
           "sharded_brute_search", "sharded_ivf_search",
           "sharded_forest_search",
           "make_sharded_brute_fn", "make_sharded_ivf_fn",
           "make_sharded_lexical_fn", "make_sharded_hybrid_fn",
           "make_sharded_forest_fn", "shard_forest", "forest_shard_shapes",
           "ForestShardShapes", "slice_forest_delta", "slice_ivf_delta"]


# ---------------------------------------------------------------------------
# Role plans
# ---------------------------------------------------------------------------


def _mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``mesh`` rank tensor)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Roles -- ``dp`` (batch), ``fsdp`` (parameter gather), ``tp``
    (tensor), ``ep`` (expert), ``pp`` (the pod remainder of ``dp``) --
    bound to mesh axes.  ``p`` returns each dimension's axis tuple (the
    content of the reference's ``PartitionSpec``); with no mesh bound
    every axis counts 1.  ``placements`` turns those tuples into DTensor
    placements over the bound ``DeviceMesh``; ``distribute`` places a
    tensor every rank holds whole, and ``constrain`` redistributes a
    DTensor (the reference's ``with_sharding_constraint``).  With no mesh
    bound ``constrain`` is the identity, and the model runs on plain
    tensors on one card."""
    dp: tuple = ()
    fsdp: tuple = ()
    tp: tuple = ()
    ep: tuple = ()
    pp: tuple = ()
    mesh: Any = None

    def resolve(self, sym) -> Optional[tuple]:
        """role | tuple of roles | None -> tuple of mesh axes | None."""
        if sym is None:
            return None
        if isinstance(sym, tuple):
            axes: list = []
            for s in sym:
                r = self.resolve(s)
                if r:
                    axes.extend(r)
            return tuple(dict.fromkeys(axes)) or None
        return tuple(getattr(self, sym)) or None

    def p(self, *dims) -> tuple:
        return tuple(self.resolve(d) for d in dims)

    def placements(self, *dims) -> tuple:
        """The DTensor placements of ``p(*dims)`` over the bound mesh: one
        a mesh dimension, ``Shard(d)`` where that mesh axis is in dim
        ``d``'s tuple, else ``Replicate()``.  A dim over several axes
        (``ep`` = ("data", "model")) gets a ``Shard`` on each, which
        DTensor splits with the first mesh dimension outermost: the
        reference's ``P(("data", "model"))`` when the tuple lists its axes
        in mesh order, as every role of the three plans does.  A tuple
        against mesh order has no plain-``Shard`` layout and raises."""
        return self.spec_placements(self.p(*dims))

    def layout(self, *dims):
        """``placements(*dims)`` under a bound mesh, ``None`` with none:
        what ``local_region`` and ``move`` take (no mesh, no move)."""
        return None if self.mesh is None else self.placements(*dims)

    def spec_placements(self, spec) -> tuple:
        """``placements`` of an already resolved spec (``p``'s tuples, as
        ``param_specs`` holds them)."""
        if self.mesh is None:
            raise ValueError("placements need a bound mesh (with_mesh)")
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, axes in enumerate(spec):
            if not axes:
                continue
            at = [names.index(a) for a in axes]
            if at != sorted(at):
                raise ValueError(
                    f"dim {d} lists mesh axes {axes} against the mesh's "
                    f"order {names}: no plain Shard layout equals it")
            for i in at:
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {names[i]!r} shards two "
                                     f"dims of {spec}")
                out[i] = Shard(d)
        return tuple(out)

    def constrain(self, x, *dims):
        """``x`` itself when no mesh is bound, as the reference's
        ``with_sharding_constraint`` is then skipped.  Under a bound mesh
        ``x`` must be a DTensor and comes back redistributed to
        ``placements(*dims)``; a plain tensor raises ``TypeError`` (taking
        it as replicated would hide a value that never reached the
        mesh)."""
        if self.mesh is None:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(
                f"ShardPlan.constrain{self.p(*dims)} under a bound mesh got "
                f"a plain {type(x).__name__}: place it first "
                "(ShardPlan.distribute, or a DTensor parameter)")
        return move(x, self.placements(*dims))

    def distribute(self, x, *dims):
        """``x`` (the whole value, the same on every rank) placed over the
        bound mesh as ``placements(*dims)``: each rank keeps its own shard,
        copied out of ``x``, with no communication.  No mesh: ``x``."""
        if self.mesh is None or isinstance(x, DTensor):
            return self.constrain(x, *dims)
        return self.place(x, self.p(*dims))

    def zeros(self, shape, dtype, device, *dims):
        """Zeros of ``shape`` placed as ``distribute`` would place them,
        each rank allocating only its own shard (``zeros_on``).  No mesh:
        the plain zeros."""
        if self.mesh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return zeros_on(shape, self.mesh, self.placements(*dims),
                        dtype=dtype, device=device)

    def place(self, x, spec):
        """``distribute`` by a resolved spec (a parameter's)."""
        if self.mesh is None:
            return x
        return place_on(torch.as_tensor(x), self.mesh,
                        self.spec_placements(spec))

    def axis_size(self, role: str) -> int:
        if self.mesh is None:
            return 1
        return _axes_size(self.mesh, getattr(self, role))

    def size_of(self, sym) -> int:
        """Device count along a role or a tuple of roles."""
        if sym is None:
            return 1
        if isinstance(sym, tuple):
            return math.prod(self.size_of(s) for s in sym)
        return self.axis_size(sym)

    def div_p(self, shape, *dims) -> tuple:
        """``p`` with every role whose device count does not divide its
        dimension dropped (that dimension stays replicated)."""
        return self.p(*[d if d and size % max(self.size_of(d), 1) == 0
                        else None for size, d in zip(shape, dims)])

    def chunk(self, n: int, role: str) -> tuple:
        """``(start, length)`` of this rank's chunk of a dim of ``n``
        placed over ``role``, as DTensor chunks it (ceil-sized, the last
        shorter); with no mesh bound, ``(0, n)``."""
        if self.mesh is None:
            return 0, n
        shape, off = compute_local_shape_and_global_offset(
            (n,), self.mesh, self.placements(role))
        return int(off[0]), int(shape[0])

    def partial(self, pl, role: str, op: str = "sum"):
        """Placements ``pl`` with a partial value (``op``: "sum", "max"
        or "min") on the mesh dims of ``role``: a region's output that
        each rank holds a part of.  ``None`` (no mesh) stays ``None``."""
        if pl is None:
            return None
        axes = self.resolve(role) or ()
        names = tuple(self.mesh.mesh_dim_names)
        return tuple(Partial(op) if names[m] in axes else q
                     for m, q in enumerate(pl))

    def sharded_dims(self, x, role: str) -> set:
        """The dims of ``x`` that lie over ``role``'s mesh axes (none for
        a plain tensor)."""
        if not isinstance(x, DTensor):
            return set()
        names, axes = x.device_mesh.mesh_dim_names, self.resolve(role) or ()
        return {q.dim for m, q in enumerate(x.placements)
                if isinstance(q, Shard) and names[m] in axes}

    def with_mesh(self, mesh) -> "ShardPlan":
        return dataclasses.replace(self, mesh=mesh)


LOCAL_PLAN = ShardPlan()

SINGLE_POD_PLAN = ShardPlan(
    dp=("data",), fsdp=("data",), tp=("model",), ep=("data", "model"))

# experts stay inside a pod; pods meet only in the data-parallel reduction
MULTI_POD_PLAN = ShardPlan(
    dp=("pod", "data"), fsdp=("pod", "data"), tp=("model",),
    ep=("data", "model"), pp=("pod",))


# ---------------------------------------------------------------------------
# Placements and moves of a model over a mesh
# ---------------------------------------------------------------------------


# a partial value's reduction: ``Partial()`` sums, ``Partial("max")`` /
# ``Partial("min")`` take the extreme (the vocabulary-parallel loss)
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _move(x, want):
    """``x.redistribute(want)`` by the collectives the reference's
    lowering issues, each a process group's own (DTensor's functional
    collectives are not used).  The partial mesh dims are reduced first:
    those that ``want`` cuts along one tensor dim ``d`` by one
    reduce-scatter over their ranks, then the rest by an all-reduce each
    (a partial dim whose ``d`` a later mesh dim cuts already is
    all-reduced and cut after, which no plan's move asks).  Then the mesh
    dims that change, with every later one cutting a tensor dim that one
    of them gives up or takes (it is re-nested), are split in three:

    * the exchange set, every ``Shard -> Shard`` or re-nested dim and
      every dim sharing a tensor dim with one of them: one all-to-all over
      the ranks of those mesh dims (``_exchange``);
    * the other ``Shard -> Replicate`` dims: all-gathered, last first;
    * the other ``Replicate -> Shard`` dims: cut, first first.

    Shards are DTensor's chunks (ceil-sized, the last shorter, trailing
    ones empty), the counterpart of the reference's padded layout."""
    want = tuple(want)
    have = tuple(x.placements)
    if have == want:
        return x
    mesh = x.device_mesh
    n = len(have)
    if all(mesh.size(m) == 1 for m in range(n) if have[m] != want[m]):
        # every changing mesh dim holds one rank: the local tensor already
        # is the value in either layout (no copy, the same strides)
        return DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                                  shape=x.shape, stride=x.stride())
    for m in range(n):
        if have[m] != want[m] and isinstance(want[m], Partial):
            raise ValueError(f"no move makes a partial sum: {want}")
    shape = tuple(x.shape)
    loc = x.to_local()
    cur = list(have)
    route = {}                     # mesh dim -> the collectives it took
    part = [m for m in range(n)
            if isinstance(cur[m], Partial) and cur[m] != want[m]]
    for d in sorted({want[m].dim for m in part
                     if isinstance(want[m], Shard)}):
        # the partial mesh dims that cut tensor dim d, in one group,
        # where no other later mesh dim cuts d already
        cut = [m for m in part if want[m] == Shard(d)]
        if any(isinstance(cur[j], Shard) and cur[j].dim == d
               for j in range(cut[0] + 1, n)):
            continue
        ops = {cur[m].reduce_op for m in cut}
        if len(ops) > 1:
            continue
        big = tuple(m for m in cut if mesh.size(m) > 1)
        if big:
            loc = _reduce_scatter(loc, d, mesh, big,
                                  _REDUCE_OPS[ops.pop()],
                                  _dims_group(mesh, big))
        for m in cut:
            cur[m] = want[m]
            route[m] = "reduce_scatter"
    for m in reversed(part):
        if isinstance(cur[m], Partial):
            loc = loc.contiguous().clone()
            dist.all_reduce(loc, op=_REDUCE_OPS[cur[m].reduce_op],
                            group=mesh.get_group(m))
            _sent("all_reduce", loc, 2)
            cur[m] = Replicate()
            route[m] = "all_reduce"
    changed = _renested(cur, want)
    swap = {m for m in changed
            if isinstance(cur[m], Shard) and isinstance(want[m], Shard)}
    while True:           # every changing dim that shares a tensor dim
        dims = {q.dim for m in swap for q in (cur[m], want[m])
                if isinstance(q, Shard)}
        more = {m for m in changed - swap
                if {q.dim for q in (cur[m], want[m])
                    if isinstance(q, Shard)} & dims}
        if not more:
            break
        swap |= more
    for m in sorted(changed - swap, reverse=True):
        if isinstance(cur[m], Shard):
            loc = _gather(loc, shape, mesh, cur, m)
            cur[m] = Replicate()
            route[m] = "all_gather"
    if swap:
        mid = [want[m] if m in swap else q for m, q in enumerate(cur)]
        loc = _exchange(loc, shape, mesh, cur, mid, swap)
        cur = mid
        for m in swap:
            route[m] = "+".join(filter(None, (route.get(m), "all_to_all")))
    for m in sorted(changed - swap):
        if isinstance(want[m], Shard):
            d = want[m].dim
            c = -(-loc.shape[d] // mesh.size(m))
            start = min(mesh.get_local_rank(m) * c, loc.shape[d])
            loc = loc.narrow(d, start, min(c, loc.shape[d] - start))
            cur[m] = want[m]
            route[m] = "+".join(filter(None, (route.get(m), "slice")))
    for m, how in route.items():
        MOVE_ROUTES[f"{_move_kind(have[m], want[m])}->{how}"] += 1
    return DTensor.from_local(loc.contiguous(), mesh, want,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _renested(cur, want) -> set:
    """The mesh dims that change from ``cur`` to ``want``, and every later
    one cutting a tensor dim that a changing one gives up or takes: it
    sits inside that one and is cut again."""
    n = len(cur)
    out = {m for m in range(n) if cur[m] != want[m]}
    for m in range(n):               # a later dim joins after the earlier
        if m not in out:
            continue
        dims = {q.dim for q in (cur[m], want[m]) if isinstance(q, Shard)}
        out |= {j for j in range(m + 1, n)
                if isinstance(cur[j], Shard) and cur[j].dim in dims}
    return out


def _box(shape, sizes, coord, placements):
    """(offsets, lengths) of the block that the rank at mesh coordinate
    ``coord`` holds of a value of ``shape`` placed as ``placements`` over
    a mesh of ``sizes``: DTensor's chunks, first mesh dim outermost."""
    off, ext = [0] * len(shape), list(shape)
    for m, q in enumerate(placements):
        if isinstance(q, Shard):
            d = q.dim
            c = -(-ext[d] // sizes[m])
            start = min(coord[m] * c, ext[d])
            off[d] += start
            ext[d] = min(c, ext[d] - start)
    return off, ext


def _coords(mesh) -> dict:
    """``{global rank: its mesh coordinate}``, kept on the mesh."""
    got = mesh.__dict__.get("_rank_coords")
    if got is None:
        flat = mesh.mesh
        got = {int(flat[c]): c for c in np.ndindex(*flat.shape)}
        mesh.__dict__["_rank_coords"] = got
    return got


def _members(mesh, group) -> list:
    """The mesh coordinates of ``group``'s members in group rank order
    (the order in which a collective lays out their blocks)."""
    at = _coords(mesh)
    return [at[r] for r in dist.get_process_group_ranks(group)]


def exchange_groups(mesh) -> dict:
    """One process group over every set of two or more of ``mesh``'s dims
    (those of more than one rank): the ranks that share their coordinates
    on the other dims.  A move's all-to-all or reduce-scatter over several
    mesh dims runs in one of them (``_dims_group``).  Making a group is
    collective over the whole world, so this runs on every rank, in the
    same order, where the mesh is made (``launch.mesh`` does), and never
    inside a move; a second call returns the groups already made.
    ``{dims: this rank's group}``."""
    got = mesh.__dict__.get("_exchange_groups")
    if got is not None:
        return got
    ranks = mesh.mesh
    big = [m for m in range(ranks.dim()) if ranks.shape[m] > 1]
    me = dist.get_rank()
    out = {}
    for r in range(2, len(big) + 1):
        for dims in itertools.combinations(big, r):
            rest = [m for m in range(ranks.dim()) if m not in dims]
            rows = ranks.permute(rest + list(dims)).reshape(
                -1, math.prod(ranks.shape[m] for m in dims))
            for row in rows.tolist():
                group = dist.new_group(row)
                if me in row:
                    out[dims] = group
    mesh.__dict__["_exchange_groups"] = out
    return out


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through host
    memory: gloo runs an all-to-all and a reduce-scatter on CPU tensors
    only, NCCL on card tensors, and the fake group of the dry run on
    any."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _on_host(collective, out, inp, *args, **kw):
    """``collective(out, inp, ...)`` run on pinned host copies of a card
    tensor's input and output, the result copied back into ``out``."""
    h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    h_in.copy_(inp, non_blocking=True)
    h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    torch.cuda.current_stream(inp.device).synchronize()
    collective(h_out, h_in, *args, **kw)
    out.copy_(h_out, non_blocking=True)


def _reduce_scatter(loc, d: int, mesh, dims, op, group):
    """A partial value over the mesh dims ``dims`` reduced and cut along
    tensor dim ``d`` as DTensor nests the chunks of ``Shard(d)`` on those
    dims (the first outermost): one reduce-scatter over ``group``, each
    member's chunk padded to the largest and trimmed after."""
    part = loc.movedim(d, 0)
    full = part.shape[0]
    members = _members(mesh, group)
    spans = []
    for q in members:
        off, ln = 0, full
        for m in dims:
            c = -(-ln // mesh.size(m))
            start = min(q[m] * c, ln)
            off, ln = off + start, min(c, ln - start)
        spans.append((off, ln))
    c = max(ln for _, ln in spans)
    if spans == [(min(i * c, full), max(0, min(c, full - i * c)))
                 for i in range(len(spans))]:
        # the chunks lie in group order, one after another
        if full < len(spans) * c:
            part = torch.cat([part, part.new_zeros(
                (len(spans) * c - full,) + part.shape[1:])])
    else:
        part = torch.cat([torch.cat([part.narrow(0, off, ln), part.new_zeros(
            (c - ln,) + part.shape[1:])]) for off, ln in spans])
    part = part.contiguous()
    out = part.new_empty((c,) + part.shape[1:])
    if _staged(group, part):
        _on_host(dist.reduce_scatter_tensor, out, part, op=op, group=group)
    else:
        dist.reduce_scatter_tensor(out, part, op=op, group=group)
    _sent("reduce_scatter", out)
    mine = spans[members.index(tuple(mesh.get_coordinate()))][1]
    return out[:mine].movedim(0, d)


def _dims_group(mesh, dims):
    """The process group over mesh dims ``dims``: one dim's own, or the
    one ``exchange_groups`` made for several."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    group = mesh.__dict__.get("_exchange_groups", {}).get(tuple(dims))
    if group is None:
        raise RuntimeError(
            f"no process group over mesh dims {tuple(dims)}: call "
            "sharding.exchange_groups(mesh) on every rank where the mesh "
            "is made (launch.mesh does)")
    return group


def _gather(loc, shape, mesh, cur, m: int):
    """Shard mesh dim ``m`` of ``cur`` gathered: one all-gather, uneven
    chunks travelling padded to the chunk size and trimmed after."""
    d = cur[m].dim
    k = mesh.size(m)
    full = _box(shape, mesh.mesh.shape, mesh.get_coordinate(),
                cur[:m] + [Replicate()] + cur[m + 1:])[1][d]
    part = loc.movedim(d, 0)
    c = -(-full // k)
    if part.shape[0] < c:
        part = torch.cat([part, part.new_zeros(
            (c - part.shape[0],) + part.shape[1:])])
    part = part.contiguous()
    out = part.new_empty((k * c,) + part.shape[1:])
    dist.all_gather_into_tensor(out, part, group=mesh.get_group(m))
    _sent("all_gather", out)
    return out[:full].movedim(0, d)


def _exchange_plan(mesh, shape, cur, mid, dims, group):
    """What ``_exchange`` sends to and receives from each member of
    ``group``, in group rank order: ``(send, recv, out_shape)``, each of
    ``send`` / ``recv`` a list of (slices into the local block, box
    shape).  A member's box is the intersection of what the sender holds
    under ``cur`` with what the receiver wants under ``mid``.  Where
    ``cur`` replicates a dim of ``dims``, only the holder at the
    receiver's own coordinate there sends.  Kept on the mesh."""
    plans = mesh.__dict__.setdefault("_exchange_plans", {})
    key = (shape, tuple(cur), tuple(mid), dims)
    if key in plans:
        return plans[key]
    sizes = tuple(mesh.mesh.shape)
    me = tuple(mesh.get_coordinate())
    rep = [m for m in dims if not isinstance(cur[m], Shard)]
    have_o, have_n = _box(shape, sizes, me, cur)
    want_o, want_n = _box(shape, sizes, me, mid)

    def cut(o1, n1, o2, n2, rel):
        lo = [max(a, b) for a, b in zip(o1, o2)]
        hi = [min(a + x, b + y) for a, x, b, y in zip(o1, n1, o2, n2)]
        ext = [max(0, h - lo_) for lo_, h in zip(lo, hi)]
        return (tuple(slice(a - r, a - r + e) for a, r, e in
                      zip(lo, rel, ext)), tuple(ext))

    send, recv = [], []
    for peer in _members(mesh, group):
        if all(peer[m] == me[m] for m in rep):
            send.append(cut(have_o, have_n, *_box(shape, sizes, peer, mid),
                            have_o))
            recv.append(cut(*_box(shape, sizes, peer, cur), want_o, want_n,
                            want_o))
        else:
            empty = (tuple(slice(0, 0) for _ in shape), (0,) * len(shape))
            send.append(empty)
            recv.append(empty)
    plans[key] = (send, recv, tuple(want_n))
    return plans[key]


def _exchange(loc, shape, mesh, cur, mid, swap):
    """``cur`` -> ``mid`` over the mesh dims ``swap``: one all-to-all
    over the group of those dims that hold more than one rank (``_swap``
    of ``_exchange_plan``'s boxes)."""
    dims = tuple(sorted(m for m in swap if mesh.size(m) > 1))
    if not dims:
        return loc
    group = _dims_group(mesh, dims)
    return _swap(loc, _exchange_plan(mesh, shape, cur, mid, dims, group),
                 group)


def _swap(loc, plan, group):
    """One ``all_to_all_single`` with split sizes over ``group``: each
    member gets the box of ``loc`` that ``plan`` names for it, and the
    boxes received are assembled into the new local block."""
    send, recv, out_shape = plan
    ins = [math.prod(b) for _, b in send]
    outs = [math.prod(b) for _, b in recv]
    # the boxes travel as their bytes, so every dtype goes as it is
    size = loc.element_size()
    flat = torch.cat([loc[sl].reshape(-1) for (sl, _), n in zip(send, ins)
                      if n] or [loc.new_empty(0)])
    raw = flat.view(torch.uint8)
    got = raw.new_empty(sum(outs) * size)
    outs_b, ins_b = [n * size for n in outs], [n * size for n in ins]
    if _staged(group, raw):
        _on_host(dist.all_to_all_single, got, raw, outs_b, ins_b,
                 group=group)
    else:
        dist.all_to_all_single(got, raw, outs_b, ins_b, group=group)
    got = got.view(loc.dtype)
    out = loc.new_empty(out_shape)
    for (sl, b), at, n in zip(recv, itertools.accumulate([0] + outs), outs):
        if n:
            out[sl] = got.narrow(0, at, n).view(b)
    _sent("all_to_all", out)
    return out


class _Move(torch.autograd.Function):
    """``_move`` with its backward through ``_move`` too: the gradient
    goes back to the input's placements (a partial sum's gradient is
    replicated: a reduce-scatter's backward is an all-gather, an
    exchange's the reverse exchange), never through DTensor's own
    backward collectives."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.src = tuple(Replicate() if isinstance(q, Partial) else q
                        for q in x.placements)
        return _move(x.detach(), want)

    @staticmethod
    def backward(ctx, g):
        return _move(g, ctx.src), None


class _Wrap(torch.autograd.Function):
    """``DTensor.from_local`` of a local tensor whose gradient comes back
    to the wrap's placements (a partial sum's gradient replicated) through
    ``_move``, as ``_Move``'s does, and not through DTensor's own
    backward, which reshards with torch's ``redistribute_local_tensor``."""

    @staticmethod
    def forward(ctx, loc, mesh, placements):
        ctx.set_materialize_grads(False)
        ctx.src = tuple(Replicate() if isinstance(q, Partial) else q
                        for q in placements)
        return DTensor.from_local(loc, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        return _move(g, ctx.src).to_local(), None, None


def _wrap(loc, mesh, placements):
    """``loc`` as this rank's shard of a DTensor with ``placements``, its
    gradient moved by ``_move`` (``_Wrap``)."""
    return _Wrap.apply(loc, mesh, tuple(placements))


def move(x, want):
    """A DTensor to the placements ``want`` (differentiable), counted in
    ``REDISTRIBUTES``; ``want`` ``None`` (``ShardPlan.layout`` with no
    mesh bound): ``x`` as it is."""
    if want is None:
        return x
    _count_redistribute(x.placements, want)
    if tuple(x.placements) == tuple(want):
        return x
    return _Move.apply(x, tuple(want))


def local_region(mesh, fn, ins, outs):
    """``fn`` on each rank's shards: every ``(value, placements)`` of
    ``ins`` moved to its placements and handed to ``fn`` as the local
    tensor (``placements`` ``None``: a plain value, passed as is); each
    of ``fn``'s outputs wrapped with its placements from ``outs`` (one
    placement tuple, or a list of them), its gradient moved back by
    ``_move`` (``_wrap``).  A mesh dim over which any input
    is sharded is one the work is split over: an input replicated there
    gets its gradient as a partial sum, so every output must be sharded
    or a partial sum on such a dim.  Shards are even (the callers pad to
    divisibility, as the reference does).  With no mesh (``mesh``
    ``None``) ``fn`` runs on the values as they are, so the one-card and
    the sharded model are one code path.  The port's counterpart of
    ``local_map``, which it does not use: its gradients and its input
    moves go through DTensor's own collectives."""
    if mesh is None:
        return fn(*(x for x, _ in ins))
    active = {m for _, pl in ins if pl is not None
              for m, q in enumerate(pl) if isinstance(q, Shard)}
    loc = []
    for x, pl in ins:
        if pl is None:
            loc.append(x)
            continue
        gpl = tuple(Partial() if isinstance(q, Replicate) and m in active
                    else q for m, q in enumerate(pl))
        loc.append(move(x, pl).to_local(grad_placements=gpl))
    out = fn(*loc)
    if isinstance(outs, list):
        return tuple(_wrap(o, mesh, pl) for o, pl in zip(out, outs))
    return _wrap(out, mesh, outs)


def place_on(x, mesh, placements):
    """``x`` (the whole value, the same on every rank) as a DTensor on
    ``mesh``: each rank keeps its own shard, copied out of ``x`` (no
    communication, and no view keeping the whole value alive)."""
    pl = tuple(placements)
    dt = distribute_tensor(x, mesh, pl, src_data_rank=None)
    loc = dt.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        dt = DTensor.from_local(loc.clone(), mesh, pl, run_check=False,
                                shape=x.shape, stride=x.stride())
    return dt


def zeros_on(shape, mesh, placements, *, dtype, device):
    """Zeros of the whole ``shape`` as a DTensor on ``mesh``: each rank
    allocates only its own shard, as the reference's zeros under a
    sharding never stand whole on one device (``place_on`` of whole zeros
    holds them whole, and cuts them, on every rank)."""
    pl = tuple(placements)
    shape = torch.Size(shape)
    loc_shape, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    loc = torch.zeros(loc_shape, dtype=dtype, device=device)
    return DTensor.from_local(loc, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def layer_of(w, i: int):
    """Layer ``i`` of a stacked parameter (a DTensor's leading layer dim
    never sharded): a view of the local shard, re-wrapped by ``_wrap``,
    so the gradient flows back into the stack through ``_move``; a plain
    tensor's ``w[i]``."""
    if not isinstance(w, DTensor):
        return w[i]
    pl = tuple(Shard(q.dim - 1) if isinstance(q, Shard) else q
               for q in w.placements)
    return _wrap(w.to_local()[i], w.device_mesh, pl)


def local(x):
    """A DTensor's local shard; any other value as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def local_offset(x) -> tuple:
    """Where ``x``'s local shard starts in the whole value, per dim (all 0
    for a plain tensor)."""
    if not isinstance(x, DTensor):
        return (0,) * x.dim()
    return tuple(compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1])


def whole(x):
    """A DTensor's whole value on every rank (a plain tensor; gathered
    as ``move`` gathers); any other value as it is."""
    if not isinstance(x, DTensor):
        return x
    return move(x, [Replicate()] * x.device_mesh.ndim).to_local()


# what ``move`` (and so ``constrain``) asked of the mesh, by the kind of
# each mesh dimension's move (``all_gather`` Shard -> Replicate,
# ``all_to_all`` Shard(a) -> Shard(b), ``all_reduce`` / ``reduce_scatter``
# from Partial, ``slice`` Replicate -> Shard, no communication); a move
# already met counts ``none``.  Read and reset by whoever drives a
# sharded step.
REDISTRIBUTES: Counter = Counter()

# the bytes a rank receives from each collective the port issues (``move``
# and ``MeshCollective``), and how many it issues, by the collective's
# kind, at the reference's rule (``hlo_analysis.analyze_hlo``: the
# result's bytes, an all-reduce doubled): an all-gather its gathered
# block, an all-reduce twice its value, a reduce-scatter its own chunk,
# an all-to-all the local block it assembles (what its own block keeps
# included, as the reference's all-to-all result holds it).  Read and
# reset with ``REDISTRIBUTES``.
COLLECTIVE_BYTES: Counter = Counter()
COLLECTIVE_COUNTS: Counter = Counter()

# how each mesh dim of a move went, ``"<its kind>-><the collectives it
# took>"``: ``all_to_all->all_to_all`` (a Shard -> Shard dim exchanged),
# ``none->all_to_all`` (a re-nested dim exchanged with it),
# ``reduce_scatter->reduce_scatter``, ``all_gather->all_gather``,
# ``all_reduce->all_reduce``, ``slice->slice``; a dim over one rank, which
# moves nothing, is not counted.  Read and reset with ``REDISTRIBUTES``.
MOVE_ROUTES: Counter = Counter()


def _move_kind(a, b) -> str:
    """The kind of one mesh dim's move from placement ``a`` to ``b``."""
    if a == b:
        return "none"
    if isinstance(a, Partial):
        return "all_reduce" if isinstance(b, Replicate) else "reduce_scatter"
    if isinstance(b, Replicate):
        return "all_gather"
    if isinstance(a, Replicate):
        return "slice"
    return "all_to_all"


def _count_redistribute(have, want) -> None:
    kinds = [k for k in map(_move_kind, have, want) if k != "none"]
    for k in kinds or ["none"]:
        REDISTRIBUTES[k] += 1


def _sent(kind: str, t: torch.Tensor, factor: int = 1) -> None:
    """Count one collective of ``kind`` whose result is ``t``."""
    COLLECTIVE_BYTES[kind] += factor * t.numel() * t.element_size()
    COLLECTIVE_COUNTS[kind] += 1


# ---------------------------------------------------------------------------
# Axes, query padding and the collective
# ---------------------------------------------------------------------------


def _axes_size(mesh, axes) -> int:
    shape = _mesh_shape(mesh)
    return math.prod(int(shape[a]) for a in axes)


def _q_spec(query_axes) -> tuple:
    """The queries' per-dimension axes: batch over ``query_axes``."""
    return (tuple(query_axes), None) if query_axes else (None, None)


def _check_disjoint(axes, query_axes):
    """Corpus and query axes must not overlap: the merge gathers over the
    corpus axes, and a shared axis would merge results that belong to
    different queries."""
    overlap = set(axes) & set(query_axes)
    if overlap:
        raise ValueError(
            f"query_axes {tuple(query_axes)} overlap corpus axes "
            f"{tuple(axes)} on {sorted(overlap)}; pass disjoint axes, e.g. "
            "axes=('data',), query_axes=('model',)")


def _query_grid(mesh, query_axes) -> int:
    return _axes_size(mesh, query_axes) if mesh is not None and query_axes \
        else 1


def _grid_pad(a: np.ndarray, n_q: int, fill=0) -> np.ndarray:
    """``a``'s rows padded with ``fill`` to a multiple of ``n_q``."""
    B = a.shape[0]
    Bp = -(-B // n_q) * n_q
    if Bp == B:
        return a
    return np.pad(a, ((0, Bp - B),) + ((0, 0),) * (a.ndim - 1),
                  constant_values=fill)


def _pad_batch(queries, n_q: int) -> np.ndarray:
    """Float32 queries zero-padded to a multiple of ``n_q`` rows."""
    return _grid_pad(np.asarray(queries, np.float32), n_q)


def _pad_terms(q_terms, q_weights, n_q: int):
    """The lexical operands padded like ``_pad_batch``: pad rows get term
    -1 (matches no slab slot) and weight 0, so they score nothing."""
    return (_grid_pad(np.asarray(q_terms, np.int32), n_q, fill=-1),
            _grid_pad(np.asarray(q_weights, np.float32), n_q))


def _pad_queries(mesh, queries, query_axes):
    """Zero-pad the batch to a multiple of the query axes' size: (padded
    float32 queries, B)."""
    return _pad_batch(queries, _query_grid(mesh, query_axes)), len(queries)


def _pad_term_queries(mesh, q_terms, q_weights, query_axes):
    """``_pad_terms`` to the query axes' size: (terms, weights, B)."""
    return (*_pad_terms(q_terms, q_weights, _query_grid(mesh, query_axes)),
            len(q_terms))


@dataclasses.dataclass(frozen=True)
class ShardSlot:
    """Where one process sits: corpus shard ``lin`` of ``n_dev`` and query
    block ``qlin`` of ``n_q``."""
    n_dev: int = 1
    lin: int = 0
    n_q: int = 1
    qlin: int = 0


def _row_major(coord: dict, shape: dict, axes) -> int:
    lin = 0
    for a in axes:
        lin = lin * int(shape[a]) + int(coord[a])
    return lin


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = every member's ``inp`` concatenated on dim 0, in group
    rank order.  ``all_gather_into_tensor`` is the one call form that
    gloo and NCCL, CPU and CUDA tensors, and torch 2.11 and 2.13 all take
    (2.13 deprecates it for ``all_gather_single``, which 2.11 lacks)."""
    dist.all_gather_into_tensor(out, inp, group=group)
    _sent("all_gather", out)


class MeshCollective:
    """The collectives of one rank of a ``DeviceMesh`` over ``axes``
    (corpus) and ``query_axes`` (batch).

    Only the mesh's own per-dimension groups are used, so nothing here
    creates a process group.  A gather over several axes is one gather a
    axis, innermost first: the result is row-major over the axes in the
    order given, whatever the mesh's order.  A group's members are
    reordered by their coordinate where the group's rank order differs.
    The mesh broadcast runs from the root (every coordinate 0) along one
    dimension after another."""

    def __init__(self, mesh, axes=("data", "model"), query_axes=()):
        axes, query_axes = tuple(axes), tuple(query_axes)
        _check_disjoint(axes, query_axes)
        self.mesh = mesh
        self.axes = axes
        self.names = tuple(mesh.mesh_dim_names)
        shape = _mesh_shape(mesh)
        for a in axes + query_axes:
            if a not in shape:
                raise KeyError(f"axis {a!r} is not a dimension of the mesh "
                               f"{self.names}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.coord = tuple(int(c) for c in coord)
        c = dict(zip(self.names, self.coord))
        self.slot = ShardSlot(
            n_dev=_axes_size(mesh, axes), lin=_row_major(c, shape, axes),
            n_q=_axes_size(mesh, query_axes) if query_axes else 1,
            qlin=_row_major(c, shape, query_axes))
        self.root = not any(self.coord)
        self.size = int(mesh.mesh.numel())
        self._corpus = [self._axis(a) for a in reversed(axes)]
        self._query = [self._axis(a) for a in reversed(query_axes)]

    def _axis(self, name: str):
        """(group, size, order) of this rank's group along ``name``:
        ``order`` puts the gathered blocks in coordinate order, or None."""
        dim = self.names.index(name)
        group = self.mesh.get_group(name)
        ranks = dist.get_process_group_ranks(group)
        flat = self.mesh.mesh
        coords = [int((flat == r).nonzero()[0][dim]) for r in ranks]
        order = None
        if coords != list(range(len(ranks))):
            order = torch.as_tensor(np.argsort(coords))
        return group, len(ranks), order

    @staticmethod
    def _gather(x: torch.Tensor, chain) -> torch.Tensor:
        out = x[None]
        for group, n, order in chain:
            buf = out.new_empty((n * out.shape[0],) + out.shape[1:])
            _all_gather(buf, out.contiguous(), group)
            buf = buf.view((n,) + tuple(out.shape))
            if order is not None:
                buf = buf[order.to(buf.device)]
            out = buf.reshape((n * out.shape[0],) + tuple(out.shape[1:]))
        return out

    def _gather_pairs(self, d, i, chain):
        """Distances and ids in one gather: the float32 distances travel
        as their int32 bit patterns, so the bytes arrive unchanged."""
        k = d.shape[1]
        packed = torch.cat([d.contiguous().view(torch.int32),
                            i.to(torch.int32)], dim=1)
        g = self._gather(packed, chain)
        return g[..., :k].view(torch.float32), g[..., k:]

    def gather_corpus(self, ld, li):
        """(B, k) per shard -> (S, B, k) in ``lin`` order."""
        return self._gather_pairs(ld, li, self._corpus)

    def gather_queries(self, d, i):
        """Merged (b, k) per query block -> (n_q * b, k) in block order."""
        gd, gi = self._gather_pairs(d, i, self._query)
        return gd.reshape(-1, d.shape[1]), gi.reshape(-1, d.shape[1])

    def _broadcast_steps(self):
        """(group, source global rank) of each step of the root's
        broadcast this rank takes part in."""
        for dim, name in enumerate(self.names):
            if any(self.coord[dim + 1:]):
                continue
            src = self.coord[:dim] + (0,) + self.coord[dim + 1:]
            yield self.mesh.get_group(name), int(self.mesh.mesh[src])

    def broadcast_object(self, obj):
        """The root's ``obj`` on every rank of the mesh."""
        box = [obj]
        for group, src in self._broadcast_steps():
            dist.broadcast_object_list(box, src=src, group=group)
        return box[0]

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The root's tensor into ``t`` (same shape and dtype) everywhere."""
        for group, src in self._broadcast_steps():
            dist.broadcast(t, src=src, group=group)
        return t

    @property
    def root_rank(self) -> int:
        """Global rank of the mesh's root (every coordinate 0)."""
        return int(self.mesh.mesh.reshape(-1)[0])

    def followers(self) -> "list[tuple[int, int]]":
        """(global rank, corpus shard ``lin``) of every rank of the mesh
        but the root, in the mesh's row-major order."""
        shape = _mesh_shape(self.mesh)
        flat = self.mesh.mesh
        out = []
        for coord in np.ndindex(*flat.shape):
            if not any(coord):
                continue
            c = dict(zip(self.names, coord))
            out.append((int(flat[coord]), _row_major(c, shape, self.axes)))
        return out

    def total(self, value: int, device) -> int:
        """Sum of every rank's ``value`` over the whole mesh (one
        all-reduce a dimension)."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=device)
        for name in self.names:
            dist.all_reduce(t, group=self.mesh.get_group(name))
        return int(t.item())

    def timeout_s(self, device) -> Optional[float]:
        """The shortest collective timeout among the mesh's groups (what
        bounds a follower's wait for the root's next call), or None where
        this torch does not expose it."""
        out = []
        for name in self.names:
            group = self.mesh.get_group(name)
            for dev in (torch.device(device), torch.device("cpu")):
                try:
                    out.append(group._get_backend(
                        dev).options._timeout.total_seconds())
                    break
                except (AttributeError, RuntimeError):
                    continue
        return min(out) if out else None


@hot_path
def search_blocks(call, operands, B: int, k: int, slot: ShardSlot,
                  coll: Optional[MeshCollective] = None):
    """One sharded search on this rank: take query block ``slot.qlin`` of
    ``operands`` (per-query tensors padded to the query grid), run
    ``call`` (the shard's local: (B, k) top-k, global ids), merge over
    the corpus shards and gather the blocks.  Returns the merged (B, k),
    the same on every rank.  Without ``coll`` the local is the only
    shard."""
    bq = operands[0].shape[0] // slot.n_q
    block = tuple(o[slot.qlin * bq:(slot.qlin + 1) * bq] for o in operands)
    ld, li = call(*block)
    if coll is None:
        d, i = _merge_gathered(ld[None], li[None], k)
    else:
        d, i = _merge_gathered(*coll.gather_corpus(ld, li), k)
        if slot.n_q > 1:
            d, i = coll.gather_queries(d, i)
    return d[:B], i[:B]


# ---------------------------------------------------------------------------
# Device arrays: each rank places shard ``lin`` of ``n_dev``
# ---------------------------------------------------------------------------


def _row_valid(n: int, rows: int, alive=None) -> np.ndarray:
    """Liveness of a shard grid of ``rows`` over ``n`` real rows: pads are
    dead, and so are tombstoned rows (``alive`` False)."""
    if rows < n:
        raise ValueError(
            f"corpus has {n} rows but the shard grid holds only {rows}; "
            "rebuild the backend (or raise headroom)")
    valid = np.arange(rows) < n
    if alive is not None:
        valid[:n] &= np.asarray(alive, bool)
    return valid.astype(np.int32)


def _shard_rows(a: np.ndarray, lin: int, rows: int, fill=0) -> np.ndarray:
    """Rows ``[lin * rows, (lin + 1) * rows)`` of ``a``, padded with
    ``fill`` past its end."""
    part = a[lin * rows:(lin + 1) * rows]
    if part.shape[0] == rows:
        return part
    pad = ((0, rows - part.shape[0]),) + ((0, 0),) * (a.ndim - 1)
    return np.pad(part, pad, constant_values=fill)


def _brute_device_arrays(db, device, rows=None, alive=None, lin=0, n_dev=1):
    """Zero-pad db rows to the shard grid (``rows`` a shard) and place
    shard ``lin``.  Pads (and tombstoned rows, via ``alive``) are masked
    by an explicit int32 per-row ``valid`` operand, never by inf-valued
    vectors (whose distances would evaluate to ``inf - inf = NaN``).
    Returns (the shard's padded db, its valid, the whole grid's valid on
    the host)."""
    db = np.asarray(db, np.float32)
    n = db.shape[0]
    rows = -(-n // n_dev) if rows is None else rows
    valid = _row_valid(n, rows * n_dev, alive)
    return (torch.as_tensor(_shard_rows(db, lin, rows), device=device),
            torch.as_tensor(_shard_rows(valid, lin, rows), device=device),
            valid)


def _brute_int8_device_arrays(db, device, rows=None, alive=None, lin=0,
                              n_dev=1):
    """int8 counterpart of ``_brute_device_arrays``: per-row symmetric
    quantization (``kernels.ops.quantize_rows_int8``, row by row, so the
    shard quantizes alone), pad rows zero codes with scale 1.0 (they
    dequantize to exact zero), masked by ``valid`` like every other dead
    row.  Returns (codes, scales, valid, the grid's valid on the host)."""
    db = np.asarray(db, np.float32)
    n = db.shape[0]
    rows = -(-n // n_dev) if rows is None else rows
    valid = _row_valid(n, rows * n_dev, alive)
    codes, scales = kernel_ops.quantize_rows_int8(db[lin * rows:
                                                     (lin + 1) * rows])
    pad = rows - codes.shape[0]
    codes = np.pad(codes, ((0, pad), (0, 0)))
    scales = np.pad(scales, (0, pad), constant_values=1.0)
    return (torch.as_tensor(codes, device=device),
            torch.as_tensor(scales, device=device),
            torch.as_tensor(_shard_rows(valid, lin, rows), device=device),
            valid)


def _lexical_device_arrays(terms, tf_sat, device, rows=None, lin=0,
                           n_dev=1):
    """Postings-slab counterpart of ``_brute_device_arrays``: term rows
    padded with -1 (no aliasing of term id 0), tf rows with zeros; pads
    and tombstones are masked by the brute scan's ``valid``.  Returns the
    shard's (terms, tf_sat)."""
    t = np.asarray(terms, np.int32)
    f = np.asarray(tf_sat, np.float32)
    rows = -(-t.shape[0] // n_dev) if rows is None else rows
    _row_valid(t.shape[0], rows * n_dev)
    return (torch.as_tensor(_shard_rows(t, lin, rows, fill=-1),
                            device=device),
            torch.as_tensor(_shard_rows(f, lin, rows), device=device))


def _ivf_host_bids(index, cap: int, n_dev: int) -> np.ndarray:
    """Every shard's bucket ids, the tables padded to ``ceil(K / S) * S``
    buckets of width ``cap`` (-1 in the pads)."""
    K, cap_now = index.bucket_ids.shape
    if cap < cap_now:
        raise ValueError(
            f"bucket cap grew to {cap_now} > reserved {cap}; rebuild the "
            "backend (or raise headroom)")
    Kp = -(-K // n_dev) * n_dev
    bids = np.full((Kp, cap), -1, np.int32)
    bids[:K, :cap_now] = np.asarray(index.bucket_ids, np.int32)
    return bids


def _ivf_device_arrays(index, device, cap=None, lin=0, n_dev=1):
    """Place shard ``lin`` of a built TwoLevelIndex's centroid and bucket
    tables, padded to ``ceil(K / S) * S`` buckets of width ``cap`` (update
    headroom): zero vectors and -1 ids in the pads, masked by id (and pad
    centroids by global bucket index, in the local).  Returns (centroids,
    bucket ids, bucket vectors (Kloc, cap, d), every shard's bucket ids on
    the host).  The bucket vectors are gathered once here, so a probe
    step reads its tile without touching the corpus."""
    cap = index.bucket_ids.shape[1] if cap is None else cap
    host = _ivf_host_bids(index, cap, n_dev)
    kloc = host.shape[0] // n_dev
    cents = _shard_rows(np.asarray(index.centroids, np.float32), lin, kloc)
    cents = torch.as_tensor(cents, device=device)
    bids = torch.as_tensor(host[lin * kloc:(lin + 1) * kloc], device=device)
    db = torch.as_tensor(np.asarray(index.db, np.float32), device=device)
    bvecs = db[torch.clamp(bids, min=0).long()]
    bvecs.masked_fill_((bids < 0)[..., None], 0.0)
    return cents, bids, bvecs, host


def _merge_gathered(gd: torch.Tensor, gi: torch.Tensor, k: int):
    """(S, B, k) per-shard results -> merged (B, k)."""
    s, b, kk = gd.shape
    cat_d = gd.permute(1, 0, 2).reshape(b, s * kk)
    cat_i = gi.permute(1, 0, 2).reshape(b, s * kk)
    d, sel = stable_topk(cat_d, k)
    ids = torch.gather(cat_i, 1, sel)
    return d, torch.where(torch.isinf(d), -1, ids)


def _finish_local(ld, li, k: int, lin: int, shard_rows: int):
    """A row-sharded local's (B, k_loc) top-k -> (B, k) with global ids:
    the shard's row offset added, the -1 sentinel kept, inf / -1 past
    k_loc."""
    li = li.to(torch.int32)
    if lin:
        li = torch.where(li >= 0, li + lin * shard_rows, -1).to(torch.int32)
    k_loc = ld.shape[1]
    if k_loc < k:
        b = ld.shape[0]
        ld = torch.cat([ld, ld.new_full((b, k - k_loc), INF)], dim=1)
        li = torch.cat([li, li.new_full((b, k - k_loc), -1)], dim=1)
    return ld, li


def _masked_topk(dist, valid_shard, k_loc: int):
    """The unfused locals' selection: dead rows to +inf, stable top-k."""
    return stable_topk(torch.where(valid_shard[None, :] != 0, dist, INF),
                       k_loc)


def make_sharded_brute_fn(k: int, shard_rows: int, *, fused: bool = True,
                          precision: str = "f32"):
    """Exact search over a row-sharded corpus: ``fn(db, valid, q, lin=0)``,
    or with ``precision="int8"`` (fused only) ``fn(codes, scales, valid,
    q, lin=0)`` over per-row-scaled int8 codes; the shard's (B, k) top-k
    with global row ids.

    Pad and tombstoned rows are masked by the ``valid`` operand, which is
    data, so a mutated corpus can be re-placed into the same shapes.
    """
    if precision not in ("f32", "int8"):
        raise ValueError(f"precision must be 'f32' or 'int8', "
                         f"got {precision!r}")
    if precision == "int8" and not fused:
        raise ValueError("precision='int8' is a fused-kernel feature; "
                         "pass fused=True")
    k_loc = min(k, shard_rows)   # a shard may hold fewer rows than k

    @hot_path
    def local(db_shard, valid_shard, q, lin: int = 0):
        if fused:
            ld, li = kernel_ops.l2_topk_op(q, db_shard, k_loc,
                                           valid=valid_shard)
        else:
            ld, li = _masked_topk(pairwise_l2sq(q, db_shard), valid_shard,
                                  k_loc)
        return _finish_local(ld, li, k, lin, shard_rows)

    @hot_path
    def local_int8(codes_shard, scales_shard, valid_shard, q, lin: int = 0):
        ld, li = kernel_ops.l2_topk_int8_op(q, codes_shard, scales_shard,
                                            k_loc, valid=valid_shard)
        return _finish_local(ld, li, k, lin, shard_rows)

    return local_int8 if precision == "int8" else local


def make_sharded_lexical_fn(k: int, shard_rows: int, *, fused: bool = True):
    """BM25 scan over row-sharded postings slabs -- the brute layout with
    term/tf slabs in place of vectors: ``fn(terms, tf_sat, valid,
    q_terms, q_weights, lin=0)``.  Filters and tombstones compose through
    ``valid`` as in the brute scan."""
    k_loc = min(k, shard_rows)

    @hot_path
    def local(terms_shard, tf_shard, valid_shard, qt, qw, lin: int = 0):
        if fused:
            ld, li = kernel_ops.bm25_topk_op(qt, qw, terms_shard, tf_shard,
                                             k_loc, valid=valid_shard)
        else:
            ld, li = _masked_topk(
                bm25_dists_ref(qt, qw, terms_shard, tf_shard), valid_shard,
                k_loc)
        return _finish_local(ld, li, k, lin, shard_rows)

    return local


def make_sharded_hybrid_fn(k: int, shard_rows: int, *, fused: bool = True):
    """Semantic L2 and BM25 fused per shard as ``alpha * l2sq - (1 -
    alpha) * bm25``: ``fn(db, terms, tf_sat, valid, q, q_terms, q_weights,
    alpha, lin=0)``, ``alpha`` a (1, 1) float32 tensor on the device."""
    k_loc = min(k, shard_rows)

    @hot_path
    def local(db_shard, terms_shard, tf_shard, valid_shard, q, qt, qw,
              alpha, lin: int = 0):
        if fused:
            ld, li = kernel_ops.hybrid_topk_op(
                q, db_shard, qt, qw, terms_shard, tf_shard, alpha, k_loc,
                valid=valid_shard)
        else:
            d2 = pairwise_l2sq(q, db_shard)
            score = -bm25_dists_ref(qt, qw, terms_shard, tf_shard)
            a = alpha.reshape(1, 1)
            ld, li = _masked_topk(a * d2 - (1.0 - a) * score, valid_shard,
                                  k_loc)
        return _finish_local(ld, li, k, lin, shard_rows)

    return local


def make_sharded_ivf_fn(k: int, nprobe_local: int, buckets_per_shard: int,
                        n_buckets: int, *, fused: bool = True):
    """Two-level, brute bottom, over a bucket-sharded index:
    ``fn(cents, bucket_ids, bucket_vecs, q, lin=0)``.

    The shard (1) scores its ``buckets_per_shard`` centroids, the pads
    past the ``n_buckets`` real ones (global bucket index) at +inf, (2)
    probes its ``nprobe_local`` best buckets, and (3) returns its top-k
    (the bucket tables hold global ids).  Fused, step (2) is one
    ``bucket_probe_topk_op`` call (on the card one scan and one merge
    launch, the bucket rows read inside the kernel); unfused, it is the
    reference's step-by-step loop with a carried running best.
    """
    nprobe_local = min(nprobe_local, buckets_per_shard)

    @hot_path
    def local(cents, bucket_ids, bucket_vecs, q, lin: int = 0):
        d2c = pairwise_l2sq(q, cents)                      # (B, Kloc)
        if (lin + 1) * buckets_per_shard > n_buckets:      # pad centroids
            gbucket = lin * buckets_per_shard + torch.arange(
                buckets_per_shard, dtype=torch.int64, device=q.device)
            d2c = torch.where(gbucket[None, :] < n_buckets, d2c, INF)
        _, probe = stable_topk(d2c, nprobe_local)          # (B, np)
        if fused:
            return kernel_ops.bucket_probe_topk_op(
                q, probe, bucket_ids, k, bucket_vecs=bucket_vecs)
        B = q.shape[0]
        best_d = q.new_full((B, k), INF)
        best_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
        for j in range(nprobe_local):
            bsel = probe[:, j]                             # (B,)
            ids = bucket_ids[bsel]                         # (B, cap)
            vecs = bucket_vecs[bsel]                       # (B, cap, d)
            d2 = torch.where(ids >= 0, batched_l2sq(vecs, q), INF)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            best_d, sel = stable_topk(cat_d, k)
            best_i = torch.gather(cat_i, 1, sel)
        return best_d, best_i

    return local


# ---------------------------------------------------------------------------
# Tree/QLBT forest bottom level
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ForestShardShapes:
    """Fixed per-shard array shapes for a sliced forest.

    Recorded at backend construction (optionally with headroom) and
    re-applied by :meth:`ShardedSearchBackend.apply_updates`: a mutated
    index re-slices into the *same* shapes, so its tables are rewritten in
    the tensors already placed.

    Two layouts share this record:

    * **packed** (``node_slab == 0``): each shard's buckets are packed
      back-to-back, minimal padding — the host entry points' layout.
    * **slab** (``node_slab > 0``): every bucket owns a fixed
      ``node_slab``-row node window and ``leaf_slab``-row leaf window at
      ``slot * slab``, so one bucket's rebuilt tree overwrites only its
      own slabs.  This is what makes *delta shipping* possible — a dirty
      bucket is a fixed-shape payload scattered in place on device — at
      the cost of padding every bucket to the largest tree
      (``nodes == kloc * node_slab``).
    """
    n_dev: int
    kloc: int       # buckets per shard
    cap: int        # bucket pad width
    nodes: int      # node-table rows per shard (excluding the dead node)
    leaves: int     # leaf-table rows per shard
    leaf_sz: int    # leaf width (entities per leaf row)
    max_depth: int  # bound on descent steps
    node_slab: int = 0   # slab layout: node rows reserved per bucket
    leaf_slab: int = 0   # slab layout: leaf rows reserved per bucket


def _forest_slices(index, n_dev: int):
    """Per-shard (b0, b1, N0, N1, L0, L1) bucket/node/leaf windows."""
    f = index.forest
    if f is None:
        raise ValueError("index has no forest (bottom must be tree/qlbt)")
    K = index.bucket_ids.shape[0]
    Kloc = -(-K // n_dev)
    leaf_row = np.asarray(f.arrays["leaf_row"])
    roots = np.asarray(f.roots, dtype=np.int64)
    n_nodes = leaf_row.shape[0]
    bounds = np.concatenate([roots, [n_nodes]])
    slices = []
    for s in range(n_dev):
        b0 = min(s * Kloc, K)
        b1 = min(b0 + Kloc, K)
        N0 = int(bounds[b0]) if b0 < K else n_nodes
        N1 = int(bounds[b1]) if b0 < K else n_nodes
        lr = leaf_row[N0:N1]
        rows = lr[lr >= 0]
        L0 = int(rows.min()) if rows.size else 0
        L1 = int(rows.max()) + 1 if rows.size else 0
        if rows.size not in (0, L1 - L0):
            raise ValueError(
                f"shard {s}: leaf rows not contiguous ({rows.size} rows in "
                f"window [{L0}, {L1})); build_forest concatenation order "
                "changed?")
        slices.append((b0, b1, N0, N1, L0, L1))
    return slices, Kloc


def _bucket_windows(index):
    """Per-bucket (N0, N1, L0, L1) node/leaf windows in the concatenated
    forest (bucket ``b`` owns nodes ``[roots[b], roots[b+1])`` and the
    contiguous leaf rows its own tree contributed)."""
    f = index.forest
    if f is None:
        raise ValueError("index has no forest (bottom must be tree/qlbt)")
    K = index.bucket_ids.shape[0]
    leaf_row = np.asarray(f.arrays["leaf_row"])
    roots = np.asarray(f.roots, dtype=np.int64)
    bounds = np.concatenate([roots, [leaf_row.shape[0]]])
    windows = []
    for b in range(K):
        N0, N1 = int(bounds[b]), int(bounds[b + 1])
        lr = leaf_row[N0:N1]
        rows = lr[lr >= 0]
        L0 = int(rows.min()) if rows.size else 0
        L1 = int(rows.max()) + 1 if rows.size else 0
        if rows.size not in (0, L1 - L0):
            raise ValueError(
                f"bucket {b}: leaf rows not contiguous; "
                "build_forest concatenation order changed?")
        windows.append((N0, N1, L0, L1))
    return windows


def forest_shard_shapes(index, n_dev: int, headroom: float = 1.0,
                        layout: str = "packed") -> ForestShardShapes:
    """Measure the natural per-shard shapes; ``headroom`` > 1 reserves
    room for post-mutation growth (bigger buckets after adds, deeper or
    wider trees after dirty-bucket rebuilds).

    ``layout="slab"`` reserves a fixed node/leaf slab *per bucket*
    (``headroom`` scales the slab against the current largest bucket
    tree) — the delta-shipping layout; see :class:`ForestShardShapes`.
    """
    f = index.forest
    cap = index.bucket_ids.shape[1]
    leaf_sz = np.asarray(f.arrays["leaf_entities"]).shape[1] if f else 0
    grow = lambda x: int(np.ceil(x * headroom))
    extra_depth = 8 if headroom > 1.0 else 0
    if layout == "slab":
        windows = _bucket_windows(index)
        K = index.bucket_ids.shape[0]
        Kloc = -(-K // n_dev)
        node_slab = grow(max(max((N1 - N0 for N0, N1, _, _ in windows),
                                 default=0), 1))
        leaf_slab = grow(max(max((L1 - L0 for *_, L0, L1 in windows),
                                 default=0), 1))
        return ForestShardShapes(
            n_dev=n_dev, kloc=Kloc, cap=grow(cap),
            nodes=Kloc * node_slab, leaves=Kloc * leaf_slab,
            leaf_sz=leaf_sz, max_depth=f.max_depth + extra_depth,
            node_slab=node_slab, leaf_slab=leaf_slab,
        )
    if layout != "packed":
        raise ValueError(f"layout must be 'packed' or 'slab', got {layout!r}")
    slices, Kloc = _forest_slices(index, n_dev)
    maxN = max(max((N1 - N0 for _, _, N0, N1, _, _ in slices), default=0), 1)
    maxL = max(max((L1 - L0 for *_, L0, L1 in slices), default=0), 1)
    return ForestShardShapes(
        n_dev=n_dev, kloc=Kloc, cap=grow(cap), nodes=grow(maxN),
        leaves=grow(maxL), leaf_sz=leaf_sz,
        max_depth=f.max_depth + extra_depth,
    )


def shard_forest(index, n_dev: int, *,
                 shapes: Optional[ForestShardShapes] = None,
                 only: Optional[int] = None) -> dict:
    """Slice a built forest index into ``n_dev`` equal-shape shards.

    The two-level build concatenates per-bucket trees into one node table
    (``two_level.build_forest``); bucket ``b`` owns node range
    ``[roots[b], roots[b+1])`` and a contiguous run of leaf-table rows.
    Each shard takes a contiguous block of buckets, re-bases node/leaf
    offsets, and remaps leaf entity ids from *global* entity ids to local
    *bucket-slot* ids (``bucket_row * cap + col``) so the rerank gathers
    from the shard's own ``(Kloc, cap, d)`` vector tile — corpus memory
    stays sharded.  One extra dead node per shard backs padded bucket
    roots.  Returns host (numpy) arrays stacked on a leading shard dim.

    ``shapes`` pads every shard to the given fixed sizes (raising if the
    forest outgrew them) so re-slicing a *mutated* index produces arrays
    of identical shape (the in-place update path).  Deleted entities are
    naturally dropped: they are absent from ``bucket_ids``, so their leaf
    slots remap to -1.

    A ``shapes`` with ``node_slab > 0`` switches to the *slab* layout
    (every bucket at a fixed per-slot window — the delta-shipping
    layout); the two layouts produce identical search results, they only
    differ in padding placement.

    ``only`` slices shard ``only`` alone (leading dimension 1), the same
    arrays as ``[only:only + 1]`` of the whole slicing: what one rank
    places.
    """
    if shapes is not None and shapes.node_slab > 0:
        return _shard_forest_slab(index, shapes, only)
    slices, Kloc = _forest_slices(index, n_dev)
    f = index.forest
    K, cap_now = index.bucket_ids.shape
    arrays = {name: np.asarray(v) for name, v in f.arrays.items()}
    roots = np.asarray(f.roots, dtype=np.int64)
    d = index.db.shape[1]
    leaf_sz_now = arrays["leaf_entities"].shape[1]
    maxN = max(max((N1 - N0 for _, _, N0, N1, _, _ in slices), default=0), 1)
    maxL = max(max((L1 - L0 for *_, L0, L1 in slices), default=0), 1)

    if shapes is None:
        shapes = ForestShardShapes(
            n_dev=n_dev, kloc=Kloc, cap=cap_now, nodes=maxN, leaves=maxL,
            leaf_sz=leaf_sz_now, max_depth=f.max_depth)
    else:
        over = []
        if shapes.n_dev != n_dev:
            over.append(f"n_dev {n_dev} != {shapes.n_dev}")
        if Kloc > shapes.kloc:
            over.append(f"kloc {Kloc} > {shapes.kloc}")
        if cap_now > shapes.cap:
            over.append(f"cap {cap_now} > {shapes.cap}")
        if maxN > shapes.nodes:
            over.append(f"nodes {maxN} > {shapes.nodes}")
        if maxL > shapes.leaves:
            over.append(f"leaves {maxL} > {shapes.leaves}")
        if leaf_sz_now > shapes.leaf_sz:
            over.append(f"leaf_sz {leaf_sz_now} > {shapes.leaf_sz}")
        if f.max_depth > shapes.max_depth:
            over.append(f"max_depth {f.max_depth} > {shapes.max_depth}")
        if over:
            raise ValueError(
                "forest outgrew the reserved shard shapes ("
                + ", ".join(over)
                + "); rebuild the backend (or raise headroom)")
    Kloc, cap, leaf_sz = shapes.kloc, shapes.cap, shapes.leaf_sz
    out = _forest_tables(n_dev if only is None else 1, shapes, d,
                         arrays["dims"].dtype)
    for s_in, (b0, b1, N0, N1, L0, L1) in enumerate(slices):
        if only is not None and s_in != only:
            continue
        s = s_in if only is None else 0
        nb, nn, nl = b1 - b0, N1 - N0, L1 - L0
        if nb == 0:
            continue
        ch = arrays["children"][N0:N1].copy()
        ch[ch >= 0] -= N0
        lr = arrays["leaf_row"][N0:N1].copy()
        lr[lr >= 0] -= L0
        out["proj"][s, :nn] = arrays["proj"][N0:N1]
        out["dims"][s, :nn] = arrays["dims"][N0:N1]
        out["tau"][s, :nn] = arrays["tau"][N0:N1]
        out["children"][s, :nn] = ch
        out["leaf_row"][s, :nn] = lr
        out["roots"][s, :nb] = (roots[b0:b1] - N0).astype(np.int32)
        out["valid"][s, :nb] = True
        out["cents"][s, :nb] = index.centroids[b0:b1]
        bl = index.bucket_ids[b0:b1]
        out["bucket_ids"][s, :nb, :cap_now] = bl
        bv = index.db[np.maximum(bl, 0)]
        out["bvecs"][s, :nb, :cap_now] = np.where((bl >= 0)[..., None], bv,
                                                  0.0)
        # global entity id -> local bucket-slot id for this shard's leaves
        # (deleted entities are absent from bucket_ids -> slot -1)
        slot_of = np.full(index.db.shape[0], -1, np.int64)
        rr, cc = np.nonzero(bl >= 0)
        slot_of[bl[rr, cc]] = rr * cap + cc
        le = arrays["leaf_entities"][L0:L1]
        le = np.pad(le, ((0, 0), (0, leaf_sz - le.shape[1])),
                    constant_values=-1).copy()
        m = le >= 0
        le[m] = slot_of[le[m]]
        out["leaf_entities"][s, :nl] = le
    out["max_depth"] = shapes.max_depth
    return out


def _slab_slot_of(index, Kloc: int, cap: int) -> np.ndarray:
    """Global entity id -> slab bucket-slot id (``(b % Kloc) * cap + col``)
    for every placed entity; -1 for deleted/absent.  One vectorized pass,
    shared by the full slab slicer and the delta slicer."""
    rr, cc = np.nonzero(index.bucket_ids >= 0)
    keep = cc < cap          # per-bucket overflow is diagnosed later
    rr, cc = rr[keep], cc[keep]
    slot_of = np.full(index.db.shape[0], -1, np.int64)
    slot_of[index.bucket_ids[rr, cc]] = (rr % Kloc) * cap + cc
    return slot_of


def _bucket_slab_payload(index, shapes: ForestShardShapes, b: int, j: int,
                         arrays: dict, roots: np.ndarray,
                         windows, slot_of: np.ndarray) -> dict:
    """One bucket's fixed-shape slab: every per-bucket array padded to the
    reserved slab sizes, node/leaf offsets rebased to slot ``j``'s
    windows, leaf entity ids remapped to the shard's bucket-slot ids
    (via the precomputed ``slot_of``).  Raises when the bucket outgrew a
    reservation (the same loud contract as the packed slicer)."""
    N0, N1, L0, L1 = windows[b]
    nb, nl = N1 - N0, L1 - L0
    cap, node_slab, leaf_slab = shapes.cap, shapes.node_slab, shapes.leaf_slab
    d = index.db.shape[1]
    over = []
    if nb > node_slab:
        over.append(f"nodes {nb} > slab {node_slab}")
    if nl > leaf_slab:
        over.append(f"leaves {nl} > slab {leaf_slab}")
    bl_full = index.bucket_ids[b]
    count = int((bl_full >= 0).sum())
    if count > cap:
        over.append(f"bucket count {count} > cap {cap}")
    le_w = arrays["leaf_entities"].shape[1]
    if le_w > shapes.leaf_sz:
        over.append(f"leaf_sz {le_w} > {shapes.leaf_sz}")
    if over:
        raise ValueError(
            f"bucket {b} outgrew the reserved slab shapes ("
            + ", ".join(over) + "); rebuild the backend (or raise headroom)")

    proj = np.zeros((node_slab, d), np.float32)
    dims = np.zeros((node_slab,), arrays["dims"].dtype)
    tau = np.zeros((node_slab,), np.float32)
    children = np.full((node_slab, 2), -1, np.int32)
    leaf_row = np.full((node_slab,), -1, np.int32)
    leaf_ents = np.full((leaf_slab, shapes.leaf_sz), -1, np.int32)
    proj[:nb] = arrays["proj"][N0:N1]
    dims[:nb] = arrays["dims"][N0:N1]
    tau[:nb] = arrays["tau"][N0:N1]
    ch = arrays["children"][N0:N1].astype(np.int32, copy=True)
    ch[ch >= 0] += j * node_slab - N0
    children[:nb] = ch
    lr = arrays["leaf_row"][N0:N1].astype(np.int32, copy=True)
    lr[lr >= 0] += j * leaf_slab - L0
    leaf_row[:nb] = lr

    # global entity id -> this shard's bucket-slot id (deleted entities
    # are absent from bucket_ids -> slot -1 via the shared slot_of map)
    bids = np.full((cap,), -1, np.int32)
    w = min(cap, bl_full.shape[0])
    bids[:w] = bl_full[:w]
    le = arrays["leaf_entities"][L0:L1]
    le = np.pad(le, ((0, 0), (0, shapes.leaf_sz - le.shape[1])),
                constant_values=-1).astype(np.int32, copy=True)
    m = le >= 0
    le[m] = slot_of[le[m]]
    leaf_ents[:nl] = le

    bv = index.db[np.maximum(bids, 0)].astype(np.float32)
    bv = np.where((bids >= 0)[:, None], bv, 0.0)
    return {
        "proj": proj, "dims": dims, "tau": tau, "children": children,
        "leaf_row": leaf_row, "leaf_entities": leaf_ents,
        "roots": np.int32(j * node_slab + int(roots[b] - N0)),
        "valid": True,
        "cents": index.centroids[b].astype(np.float32),
        "bucket_ids": bids, "bvecs": bv,
    }


def _forest_tables(n_out: int, shapes: ForestShardShapes, d: int,
                   dims_dtype) -> dict:
    """Empty stacked shard tables: pads, -1 links, roots at each shard's
    dead node (row ``nodes``)."""
    padN, padL, Kloc, cap = (shapes.nodes, shapes.leaves, shapes.kloc,
                             shapes.cap)
    return {
        "proj": np.zeros((n_out, padN + 1, d), np.float32),
        "dims": np.zeros((n_out, padN + 1), dims_dtype),
        "tau": np.zeros((n_out, padN + 1), np.float32),
        "children": np.full((n_out, padN + 1, 2), -1, np.int32),
        "leaf_row": np.full((n_out, padN + 1), -1, np.int32),
        "leaf_entities": np.full((n_out, padL, shapes.leaf_sz), -1,
                                 np.int32),
        "roots": np.full((n_out, Kloc), padN, np.int32),
        "valid": np.zeros((n_out, Kloc), bool),
        "cents": np.zeros((n_out, Kloc, d), np.float32),
        "bucket_ids": np.full((n_out, Kloc, cap), -1, np.int32),
        "bvecs": np.zeros((n_out, Kloc, cap, d), np.float32),
    }


def _shard_forest_slab(index, shapes: ForestShardShapes,
                       only: Optional[int] = None) -> dict:
    """Slab-layout slicer: same output contract as the packed
    ``shard_forest`` (stacked host arrays + ``max_depth``), but bucket
    ``b`` always lands at slot ``b % kloc`` of shard ``b // kloc`` with
    fixed node/leaf windows — so a mutated bucket later re-ships as a
    standalone slab (:func:`slice_forest_delta`).  ``only``: that shard
    alone."""
    f = index.forest
    K = index.bucket_ids.shape[0]
    n_dev, Kloc = shapes.n_dev, shapes.kloc
    if -(-K // n_dev) > Kloc:
        raise ValueError(
            f"forest outgrew the reserved shard shapes (kloc "
            f"{-(-K // n_dev)} > {Kloc}); rebuild the backend")
    if f.max_depth > shapes.max_depth:
        raise ValueError(
            f"forest outgrew the reserved shard shapes (max_depth "
            f"{f.max_depth} > {shapes.max_depth}); rebuild the backend "
            "(or raise headroom)")
    arrays = {name: np.asarray(v) for name, v in f.arrays.items()}
    roots = np.asarray(f.roots, dtype=np.int64)
    windows = _bucket_windows(index)
    d = index.db.shape[1]
    cap = shapes.cap
    out = _forest_tables(n_dev if only is None else 1, shapes, d,
                         arrays["dims"].dtype)
    ns, ls = shapes.node_slab, shapes.leaf_slab
    slot_of = _slab_slot_of(index, Kloc, cap)
    first = 0 if only is None else only * Kloc
    last = K if only is None else min((only + 1) * Kloc, K)
    for b in range(first, last):
        s, j = b // Kloc - first // Kloc, b % Kloc
        p = _bucket_slab_payload(index, shapes, b, j, arrays, roots,
                                 windows, slot_of)
        out["proj"][s, j * ns:(j + 1) * ns] = p["proj"]
        out["dims"][s, j * ns:(j + 1) * ns] = p["dims"]
        out["tau"][s, j * ns:(j + 1) * ns] = p["tau"]
        out["children"][s, j * ns:(j + 1) * ns] = p["children"]
        out["leaf_row"][s, j * ns:(j + 1) * ns] = p["leaf_row"]
        out["leaf_entities"][s, j * ls:(j + 1) * ls] = p["leaf_entities"]
        out["roots"][s, j] = p["roots"]
        out["valid"][s, j] = True
        out["cents"][s, j] = p["cents"]
        out["bucket_ids"][s, j] = p["bucket_ids"]
        out["bvecs"][s, j] = p["bvecs"]
    out["max_depth"] = shapes.max_depth
    return out


def slice_forest_delta(index, shapes: ForestShardShapes,
                       dirty_buckets) -> dict:
    """Slice only the dirty buckets into stacked fixed-shape slab
    payloads (slab layout required: ``shapes.node_slab > 0``).

    Returns host arrays keyed like the device tables plus ``shard`` /
    ``slot`` index vectors: the operand set of the backend's in-place
    scatter.  Payload bytes are what a delta republish actually
    ships; compare against the full re-place bytes for the fallback
    decision.
    """
    if shapes.node_slab <= 0:
        raise ValueError("delta slicing requires the slab layout "
                         "(forest_shard_shapes(..., layout='slab'))")
    K = index.bucket_ids.shape[0]
    dirty = np.unique(np.asarray(dirty_buckets, dtype=np.int64))
    if dirty.size and (dirty.min() < 0 or dirty.max() >= K):
        raise ValueError(f"dirty bucket id out of range [0, {K})")
    f = index.forest
    if f.max_depth > shapes.max_depth:
        raise ValueError(
            f"forest outgrew the reserved shard shapes (max_depth "
            f"{f.max_depth} > {shapes.max_depth}); rebuild the backend "
            "(or raise headroom)")
    arrays = {name: np.asarray(v) for name, v in f.arrays.items()}
    roots = np.asarray(f.roots, dtype=np.int64)
    windows = _bucket_windows(index)
    Kloc = shapes.kloc
    slot_of = _slab_slot_of(index, Kloc, shapes.cap)
    rows = [_bucket_slab_payload(index, shapes, int(b), int(b % Kloc),
                                 arrays, roots, windows, slot_of)
            for b in dirty]
    out = {"shard": (dirty // Kloc).astype(np.int32),
           "slot": (dirty % Kloc).astype(np.int32)}
    for name in ("proj", "dims", "tau", "children", "leaf_row",
                 "leaf_entities", "roots", "valid", "cents",
                 "bucket_ids", "bvecs"):
        out[name] = np.stack([p[name] for p in rows]) if rows else \
            np.zeros((0,), np.int32)
    return out


def slice_ivf_delta(index, cap: int, dirty_buckets) -> dict:
    """Dirty-bucket rows of the IVF device tables (centroid, padded slot
    row, gathered bucket-vector tile), ready to scatter at ``rows``."""
    K, cap_now = index.bucket_ids.shape
    if cap < cap_now:
        raise ValueError(
            f"bucket cap grew to {cap_now} > reserved {cap}; rebuild the "
            f"backend (or raise headroom)")
    dirty = np.unique(np.asarray(dirty_buckets, dtype=np.int64))
    if dirty.size and (dirty.min() < 0 or dirty.max() >= K):
        raise ValueError(f"dirty bucket id out of range [0, {K})")
    bids = np.full((dirty.size, cap), -1, np.int32)
    bids[:, :cap_now] = index.bucket_ids[dirty]
    bvecs = index.db[np.maximum(bids, 0)].astype(np.float32)
    bvecs = np.where((bids >= 0)[..., None], bvecs, 0.0)
    return {
        "rows": dirty.astype(np.int32),
        "cents": index.centroids[dirty].astype(np.float32),
        "bucket_ids": bids,
        "bvecs": bvecs,
    }


def make_sharded_forest_fn(k: int, nprobe_local: int, beam_width: int,
                           leaf_size: int, max_depth: int, *,
                           fused: bool = True):
    """Two-level, tree/QLBT bottom, over a bucket-sharded forest:
    ``fn(cents, valid, roots, bucket_ids, bvecs, proj, dims, tau, children,
    leaf_row, leaf_entities, q, lin=0)``, each table with its leading
    shard dim (length 1: the rank's shard); the shard's (B, k) top-k with
    global ids (its ``bucket_ids`` map slot ids to them).

    The shard scores its centroids, descends its forest for the
    ``nprobe_local`` best buckets (one batched beam search over the
    shard's node table), reranks the leaf candidates (bucket-slot ids)
    against the shard's ``(Kloc cap, d)`` vector table and contributes its
    top-k to the merge.  Fused, the rerank is one ``candidate_rows_topk_op``
    call (on the card the ``candidate_topk`` kernel reading the rows by
    slot id); unfused, the reference's gather, distances and top-k.
    """
    from repro_torch.core.tree import tree_search

    @hot_path
    def local(cents, valid, roots, bids, bvecs, proj, dims, tau, children,
              leaf_row, leaf_ents, q, lin: int = 0):
        cents, valid, roots = cents[0], valid[0], roots[0]
        bids, bvecs = bids[0], bvecs[0]
        arrays = dict(proj=proj[0], dims=dims[0], tau=tau[0],
                      children=children[0], leaf_row=leaf_row[0],
                      leaf_entities=leaf_ents[0])
        B, dd = q.shape
        np_eff = min(nprobe_local, cents.shape[0])
        d2c = torch.where(valid[None, :], pairwise_l2sq(q, cents), INF)
        _, probe = stable_topk(d2c, np_eff)                # (B, np)
        rr = roots[probe].reshape(-1)
        qq = torch.repeat_interleave(q, np_eff, dim=0)      # (B*np, d)
        vecs_flat = bvecs.reshape(-1, dd)                   # (Kloc*cap, d)
        res = tree_search(arrays, vecs_flat, qq, kind="rp",
                          beam_width=beam_width, k=beam_width * leaf_size,
                          max_steps=max_depth + 4, rerank=False, roots=rr)
        cand = res.ids.reshape(B, -1)                       # local slot ids
        # bucket-slot liveness: a slot whose bucket entry is -1 holds no
        # servable entity (pads, compacted deletes, filtered-out rows)
        flat_bids = bids.reshape(-1)
        cand = torch.where(
            (cand >= 0) & (flat_bids[torch.clamp(cand, min=0).long()] >= 0),
            cand, -1)
        if fused:
            ld, slot = kernel_ops.candidate_rows_topk_op(q, vecs_flat, cand,
                                                         k)
            gids = flat_bids[torch.clamp(slot, min=0).long()]
            li = torch.where((slot >= 0) & ~torch.isinf(ld), gids, -1)
        else:
            vecs = vecs_flat[torch.clamp(cand, min=0).long()]
            d2 = torch.where(cand >= 0, batched_l2sq(vecs, q), INF)
            k_eff = min(k, cand.shape[1])
            ld, sel = stable_topk(d2, k_eff)
            slot = torch.gather(cand, 1, sel)
            gids = flat_bids[torch.clamp(slot, min=0).long()]
            li = torch.where((slot >= 0) & ~torch.isinf(ld), gids, -1)
            ld, li = pad_sentinel(ld, li, k, k_eff)
        return ld, li.to(torch.int32)

    return local


def _forest_device_arrays(index, device, shapes=None, lin=0, n_dev=1):
    """Slice shard ``lin`` of ``n_dev`` of ``index``'s forest and place it
    on ``device`` (its leading dimension kept, length 1).  Returns
    ({name: tensor}, {name: the shard's host array} with ``max_depth``)."""
    sh = shard_forest(index, n_dev, shapes=shapes, only=lin)
    return ({name: torch.as_tensor(v, device=device)
             for name, v in sh.items() if name != "max_depth"}, sh)


# ---------------------------------------------------------------------------
# Host entries: collective calls, every rank gets the numpy (B, k)
# ---------------------------------------------------------------------------


def _mesh_slot(mesh, axes, query_axes):
    """(collective, slot) of this rank, or (None, one shard) without a
    mesh."""
    if mesh is None:
        _check_disjoint(axes, query_axes)
        return None, ShardSlot()
    coll = MeshCollective(mesh, axes, query_axes)
    return coll, coll.slot


def _host_result(d, i):
    return d.cpu().numpy(), i.cpu().numpy()


def sharded_brute_search(mesh, db, queries, k=10, axes=("data", "model"),
                         query_axes=(), fused=True, precision="f32",
                         device=None):
    """Exact search with the rows of ``db`` sharded over ``axes`` (one
    shard a rank) and the batch over ``query_axes``, a disjoint axis set.
    A collective call: every rank of ``mesh`` calls it with the same
    arguments and gets the numpy (B, k).  ``mesh=None`` is one shard."""
    from repro_torch.device import resolve

    dev = resolve(device, mesh)
    coll, slot = _mesh_slot(mesh, axes, query_axes)
    db = np.asarray(db, np.float32)
    rows = -(-db.shape[0] // slot.n_dev)
    place = (_brute_int8_device_arrays if precision == "int8"
             else _brute_device_arrays)
    tables = place(db, dev, rows=rows, lin=slot.lin, n_dev=slot.n_dev)[:-1]
    fn = make_sharded_brute_fn(k, rows, fused=fused, precision=precision)
    q, B = _pad_queries(mesh, queries, query_axes)
    return _host_result(*search_blocks(
        lambda qb: fn(*tables, qb, lin=slot.lin),
        (torch.as_tensor(q, device=dev),), B, k, slot, coll))


def sharded_ivf_search(mesh, index, queries, k=10, nprobe_local=2,
                       axes=("data", "model"), query_axes=(), fused=True,
                       device=None):
    """A built TwoLevelIndex (brute bottom) with its buckets sharded over
    ``axes``: each shard probes its ``nprobe_local`` best buckets.  The
    bucket tables hold global entity ids, so the merged ids compare with
    the one-card index.  A collective call, as ``sharded_brute_search``."""
    from repro_torch.device import resolve

    dev = resolve(device, mesh)
    coll, slot = _mesh_slot(mesh, axes, query_axes)
    K = index.bucket_ids.shape[0]
    tables = _ivf_device_arrays(index, dev, lin=slot.lin,
                                n_dev=slot.n_dev)[:3]
    fn = make_sharded_ivf_fn(k, nprobe_local, tables[0].shape[0], K,
                             fused=fused)
    q, B = _pad_queries(mesh, queries, query_axes)
    return _host_result(*search_blocks(
        lambda qb: fn(*tables, qb, lin=slot.lin),
        (torch.as_tensor(q, device=dev),), B, k, slot, coll))


def sharded_forest_search(mesh, index, queries, k=10, nprobe_local=2,
                          beam_width=8, axes=("data", "model"),
                          query_axes=(), fused=True, device=None):
    """A built TwoLevelIndex with a tree / QLBT bottom, its forest sliced
    over ``axes`` (the packed layout): each shard descends its own slice
    before the merge.  A collective call, as ``sharded_brute_search``."""
    from repro_torch.device import resolve

    dev = resolve(device, mesh)
    coll, slot = _mesh_slot(mesh, axes, query_axes)
    placed, host = _forest_device_arrays(index, dev, lin=slot.lin,
                                         n_dev=slot.n_dev)
    fn = make_sharded_forest_fn(k, nprobe_local, beam_width,
                                index.config.tree_leaf, host["max_depth"],
                                fused=fused)
    tables = tuple(placed[name] for name in (
        "cents", "valid", "roots", "bucket_ids", "bvecs", "proj", "dims",
        "tau", "children", "leaf_row", "leaf_entities"))
    q, B = _pad_queries(mesh, queries, query_axes)
    return _host_result(*search_blocks(
        lambda qb: fn(*tables, qb, lin=slot.lin),
        (torch.as_tensor(q, device=dev),), B, k, slot, coll))
