"""Registered entry points for the recompile-stability gate: the port of
``repro/analysis/registry.py``, with the reference's seven names, step
labels, corpora and seeds.

Each entry point builds the real serving object on one shard, on
``device`` (default the card; the CPU tests pass ``"cpu"``), and returns
a :class:`repro_torch.analysis.recompile.Plan` whose steps walk the
index through its online lifecycle -- mutations, delta applies, reboosts
-- while the backend's compiled variants (``jit_cache_size``,
``delta_cache_size``) are watched.  The invariant under test is the
stack's core claim: **the dispatch signatures and placed shapes set at
warm-up survive every mutation**.

Registering a new entry point:

    from repro_torch.analysis.recompile import Plan
    from repro_torch.analysis.registry import register_entry_point

    @register_entry_point("my-kernel")
    def _my_kernel(device=None):
        thing = build_it(device)
        steps = [("warmup", lambda: thing(x)),
                 ("mutate", lambda: mutate_and_call(thing))]
        return Plan(steps=steps, cache_size=thing.jit_cache_size)

Plan factories import the backends lazily so the static passes never pay for
torch.  Corpora are small (the gate checks *signatures*, not quality)
and every shape-feeding size is kept inside the backend's headroom
reservation -- an outgrown reservation is a loud error, not a silent new
variant, and has its own test coverage.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.analysis.recompile import Plan

__all__ = ["ENTRY_POINTS", "register_entry_point"]

ENTRY_POINTS: Dict[str, Callable[..., Plan]] = {}

_N, _D, _K = 96, 8, 4


def register_entry_point(name: str):
    """Register a Plan factory under ``name`` (last registration wins,
    so tests can shadow real entry points with seeded ones)."""

    def deco(make_plan: Callable[..., Plan]):
        ENTRY_POINTS[name] = make_plan
        return make_plan

    return deco


def _corpus(rng, n):
    import numpy as np

    c = rng.normal(size=(8, _D)) * 4
    return (c[rng.integers(0, 8, n)]
            + rng.normal(size=(n, _D))).astype(np.float32)


def _index(rng, bottom: str, device):
    import numpy as np

    from repro_torch.core.two_level import TwoLevelConfig, build_two_level

    db = _corpus(rng, _N)
    cfg = TwoLevelConfig(
        n_clusters=_K, top="brute", bottom=bottom, kmeans_iters=2,
        kmeans_minibatch=None, bucket_cap=64, tree_leaf=4,
        lsh_bits=16, pq_m=4)
    p = (rng.dirichlet(np.full(_N, 0.5)).astype(np.float64)
         if bottom == "qlbt" else None)
    return db, build_two_level(db, cfg, p=p, device=device)


def _localized_mutation(rng, idx):
    """Delete a few rows of the fullest bucket, add mass near another
    centroid -- the canonical dirty-handful-of-buckets maintenance pass."""
    import numpy as np

    b = int(np.argmax(idx.bucket_counts))
    dele = np.asarray(idx.bucket_ids[b][:3]).copy()
    idx.delete_entities(dele)
    new = (np.asarray(idx.centroids[1])[None, :]
           + 0.1 * rng.normal(size=(3, _D))).astype(np.float32)
    idx.add_entities(new)


@register_entry_point("sharded-brute-search")
def _sharded_brute_search(device=None) -> Plan:
    import numpy as np

    from repro_torch.distributed.backend import ShardedSearchBackend

    rng = np.random.default_rng(0)
    db = _corpus(rng, _N)
    be = ShardedSearchBackend(db, kind="brute", k=5, headroom=2.0,
                              device=device)
    q = _corpus(rng, 4)
    grown = np.concatenate([db, _corpus(rng, 16)])
    alive = np.ones(grown.shape[0], bool)
    alive[:5] = False

    def grow():
        be.apply_updates(grown)
        be(q)

    def tombstone():
        be.apply_updates(grown, alive=alive)
        be(q)

    return Plan(
        steps=[("warmup-search", lambda: be(q)),
               ("full-republish-grown-corpus", grow),
               ("full-republish-tombstones", tombstone)],
        cache_size=be.jit_cache_size)


@register_entry_point("brute-delta-scatter")
def _brute_delta_scatter(device=None) -> Plan:
    import numpy as np

    from repro_torch.core.delta import DeltaLog
    from repro_torch.distributed.backend import ShardedSearchBackend

    rng = np.random.default_rng(1)
    db = _corpus(rng, 64)
    be = ShardedSearchBackend(db, kind="brute", k=5, headroom=2.0,
                              device=device)
    log = DeltaLog(base_version=0, base_n=64)
    state = {"db": db, "version": 0}

    def apply_delta(n_append, n_tomb):
        def step():
            cur = state["db"]
            if n_append:
                state["db"] = np.concatenate(
                    [cur, _corpus(rng, n_append)])
            if n_tomb:
                log.mark_tombstones(
                    rng.choice(cur.shape[0], n_tomb, replace=False))
            state["version"] += 1
            man = log.pop(state["version"], state["db"].shape[0])
            st = be.apply_updates(state["db"], delta=man)
            assert st["mode"] == "delta", st

        return step

    # two warm-up shape buckets -- append windows (rows pad to 4) and
    # tombstone-only windows (rows pad to 1) -- then re-drive both:
    # same pow2 buckets, so the scatter must not mint a new shape
    return Plan(
        steps=[("warmup-append-3-tombstone-2", apply_delta(3, 2)),
               ("warmup-tombstone-only-2", apply_delta(0, 2)),
               ("delta-append-4-tombstone-2", apply_delta(4, 2)),
               ("delta-tombstone-only-2", apply_delta(0, 2))],
        cache_size=be.delta_cache_size,
        warmup_steps=2)


@register_entry_point("sharded-ivf-search")
def _sharded_ivf_search(device=None) -> Plan:
    import numpy as np

    from repro_torch.distributed.backend import ShardedSearchBackend

    rng = np.random.default_rng(2)
    _, idx = _index(rng, "brute", device)  # bucketed flat bottom -> IVF
    be = ShardedSearchBackend(idx, k=5, nprobe_local=_K, headroom=2.0,
                              device=device)
    q = _corpus(rng, 4)

    def mutate_and_apply():
        _localized_mutation(rng, idx)
        be.apply_updates(idx, delta=idx.pop_delta())
        be(q)

    return Plan(
        steps=[("warmup-search", lambda: be(q)),
               ("delta-republish-1", mutate_and_apply),
               ("delta-republish-2", mutate_and_apply)],
        cache_size=be.jit_cache_size)


@register_entry_point("sharded-forest-search")
def _sharded_forest_search(device=None) -> Plan:
    import numpy as np

    from repro_torch.distributed.backend import ShardedSearchBackend

    rng = np.random.default_rng(3)
    _, idx = _index(rng, "qlbt", device)   # per-bucket trees -> forest
    be = ShardedSearchBackend(idx, k=5, nprobe_local=_K, beam_width=8,
                              headroom=1.5, device=device)
    q = _corpus(rng, 4)

    def mutate_and_apply():
        _localized_mutation(rng, idx)
        be.apply_updates(idx, delta=idx.pop_delta())
        be(q)

    def reboost_and_apply():
        n_now = int(idx.db.shape[0])
        idx.reboost(rng.dirichlet(np.full(n_now, 0.5)))
        be.apply_updates(idx, delta=idx.pop_delta())
        be(q)

    return Plan(
        steps=[("warmup-search", lambda: be(q)),
               ("delta-republish", mutate_and_apply),
               ("reboost-republish", reboost_and_apply)],
        cache_size=be.jit_cache_size)


@register_entry_point("fused-sharded-search")
def _fused_sharded_search(device=None) -> Plan:
    """``fused=True`` routes the per-shard scan+top-k through the kernel
    dispatch (``repro_torch.kernels.ops``) and ``precision="int8"``
    additionally swaps the placed corpus for per-row-scaled codes.  Both
    must survive delta windows (scatters into the quantized corpus
    included) without a single new variant."""
    import numpy as np

    from repro_torch.core.delta import DeltaLog
    from repro_torch.distributed.backend import ShardedSearchBackend

    rng = np.random.default_rng(5)
    db = _corpus(rng, 64)
    be8 = ShardedSearchBackend(db, kind="brute", k=5, headroom=2.0,
                               fused=True, precision="int8", device=device)
    _, idx = _index(rng, "brute", device)  # bucketed flat bottom -> IVF
    bei = ShardedSearchBackend(idx, k=5, nprobe_local=_K, headroom=2.0,
                               fused=True, device=device)
    q = _corpus(rng, 4)
    log = DeltaLog(base_version=0, base_n=64)
    state = {"db": db, "version": 0}

    def int8_delta(n_append, n_tomb):
        def step():
            cur = state["db"]
            if n_append:
                state["db"] = np.concatenate([cur, _corpus(rng, n_append)])
            if n_tomb:
                log.mark_tombstones(
                    rng.choice(cur.shape[0], n_tomb, replace=False))
            state["version"] += 1
            man = log.pop(state["version"], state["db"].shape[0])
            st = be8.apply_updates(state["db"], delta=man)
            assert st["mode"] == "delta", st
            be8(q)

        return step

    def ivf_mutate():
        _localized_mutation(rng, idx)
        bei.apply_updates(idx, delta=idx.pop_delta())
        bei(q)

    def cache_size():
        sizes = [be8.jit_cache_size(), bei.jit_cache_size()]
        return -1 if any(s < 0 for s in sizes) else sum(sizes)

    return Plan(
        steps=[("warmup-fused-searches", lambda: (be8(q), bei(q))),
               ("warmup-int8-delta-append-3-tombstone-2", int8_delta(3, 2)),
               ("int8-delta-append-4-tombstone-2", int8_delta(4, 2)),
               ("fused-ivf-delta-republish-1", ivf_mutate),
               ("fused-ivf-delta-republish-2", ivf_mutate)],
        cache_size=cache_size,
        warmup_steps=2)


@register_entry_point("filtered-sharded-search")
def _filtered_sharded_search(device=None) -> Plan:
    """Filter + mode surface: predicates compile to mask *operands*
    (brute valid-AND, ivf/forest bucket-slot -1s) and hybrid alpha is a
    (1, 1) operand, so sweeping filters, modes, and alphas across delta
    windows must not mint one new variant beyond the three per-mode
    signatures of the warm-up."""
    import numpy as np

    from repro_torch.core.lexical import build_lexical_slabs, query_operands
    from repro_torch.core.metadata import FilterSpec, MetadataTable
    from repro_torch.distributed.backend import ShardedSearchBackend

    rng = np.random.default_rng(6)
    db = _corpus(rng, 64)
    meta = MetadataTable(
        {"cat": rng.integers(0, 4, 64).astype(np.int32)})
    docs = [list(rng.integers(0, 32, 5)) for _ in range(64)]
    slabs = build_lexical_slabs(docs, 32)
    beb = ShardedSearchBackend(db, kind="brute", k=5, headroom=2.0,
                               metadata=meta, lexical=slabs, device=device)
    _, idx = _index(rng, "brute", device)  # bucketed flat bottom -> IVF
    imeta = MetadataTable(
        {"cat": rng.integers(0, 4, _N).astype(np.int32)})
    bei = ShardedSearchBackend(idx, k=5, nprobe_local=_K, headroom=2.0,
                               metadata=imeta, device=device)
    q = _corpus(rng, 4)
    qt, qw = query_operands([docs[0], docs[1], docs[2], docs[3]], slabs)
    state = {"db": db, "round": 0}

    def sweep():
        # fresh predicates every round: each compiles to a new mask
        # operand and must hit the same executables
        r = state["round"]
        state["round"] += 1
        specs = (FilterSpec.eq("cat", r % 4),
                 FilterSpec.range("cat", 0, 1 + r % 3),
                 FilterSpec.isin("cat", (r % 4, (r + 1) % 4)))
        for fs in specs:
            beb(q, filter_spec=fs)
            bei(q, filter_spec=fs)
        beb(q, mode="lexical", q_terms=qt, q_weights=qw,
            filter_spec=specs[0])
        for alpha in (0.1 + 0.2 * r, 0.9):
            beb(q, mode="hybrid", alpha=alpha, q_terms=qt, q_weights=qw,
                filter_spec=specs[1])

    def mutate_and_sweep():
        # grow the brute corpus (+slabs +metadata) through a delta
        # window, then sweep filters over the post-delta state
        from repro_torch.core.delta import DeltaManifest

        cur = state["db"]
        n0, n1 = cur.shape[0], cur.shape[0] + 4
        state["db"] = np.concatenate([cur, _corpus(rng, 4)])
        slabs.append_docs([list(rng.integers(0, 32, 5))
                           for _ in range(4)])
        meta.append_rows(
            {"cat": rng.integers(0, 4, 4).astype(np.int32)}, 4)
        man = DeltaManifest(
            base_version=0, version=1, base_n=n0, n=n1,
            dirty_buckets=np.zeros(0, np.int64),
            tombstones=np.asarray([1, 3], np.int64),
            lsh_rows_appended=0, full=False)
        beb.apply_updates(state["db"], delta=man)
        _localized_mutation(rng, idx)
        imeta.append_rows(
            {"cat": rng.integers(0, 4, 3).astype(np.int32)}, 3)
        bei.apply_updates(idx, delta=idx.pop_delta())
        sweep()

    def cache_size():
        sizes = [beb.jit_cache_size(), bei.jit_cache_size()]
        return -1 if any(s < 0 for s in sizes) else sum(sizes)

    return Plan(
        steps=[("warmup-filter-mode-sweep", sweep),
               ("filter-sweep-new-predicates", sweep),
               ("delta-republish-filter-sweep", mutate_and_sweep)],
        cache_size=cache_size)


@register_entry_point("fleet-router-search")
def _fleet_router_search(device=None) -> Plan:
    import numpy as np

    from repro_torch.serve.fleet import build_fleet

    rng = np.random.default_rng(4)
    _, idx = _index(rng, "brute", device)  # bucketed flat bottom -> IVF
    # two cells sharing the gate's one device: each owns a private
    # ShardedSearchBackend with its own placement and variants -- the
    # invariant is that ROUTED traffic plus a leader fan-out keeps every
    # cell's variants fixed, same as the single-backend entries
    router = build_fleet(
        [device] * 2, idx, k=5,
        backend_kw={"nprobe_local": _K, "headroom": 2.0},
        cell_kw={"max_wait_ms": 1.0})
    qs = _corpus(rng, 8)

    def warmup():
        # the router batches blocking callers one at a time, so the
        # served shape is the 1-query pow2 bucket; warm it on EVERY
        # cell directly -- rendezvous routing alone might leave a cell
        # cold and turn its first spill/hedge into a false recompile
        for cell in router.cells:
            cell.search_fn(qs[:1])
        for q in qs[:4]:
            router.search(q)

    def mutate_and_fanout():
        _localized_mutation(rng, idx)
        # leader contract: ONE pop, the same manifest to every cell
        router.apply_updates(idx)
        for q in qs[:4]:
            router.search(q)

    def cache_size():
        sizes = [c.search_fn.jit_cache_size() for c in router.cells]
        return -1 if any(s < 0 for s in sizes) else sum(sizes)

    return Plan(
        steps=[("warmup-routed-search", warmup),
               ("fleet-delta-fanout-1", mutate_and_fanout),
               ("fleet-delta-fanout-2", mutate_and_fanout)],
        cache_size=cache_size)
