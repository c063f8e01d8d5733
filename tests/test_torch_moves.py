"""``sharding.move`` by the reference's collectives, on the CPU.

1. one spawn of 4 gloo ranks (a ``FileStore`` under pytest's temporary
   directory, every group with a 60 s timeout, every rank joined within
   ``RANK_LIMIT_S``) on a ``(2, 2)`` mesh and on a ``(1, 2, 2)`` mesh
   whose pod dim holds one rank, both made by ``launch.mesh``.  Each case
   of ``testing.MOVE_CASES`` is one move: ``Shard -> Shard`` over one
   mesh dim, the MoE's re-nesting ``(Shard(0), Shard(1)) -> (Shard(1),
   Shard(1))`` and its multi-pod forms, uneven and empty chunks, partial
   sums and maxima cut.  Every rank's block must equal
   ``testing.cut_as_dtensor`` of the whole value bit for bit (the whole
   value gathered and cut, what the moves gave before they issued an
   all-to-all or a reduce-scatter; integer-valued fp32, so any sum order
   is exact), and the move must issue the reference's collective: one
   all-to-all of the local block it assembles, or one reduce-scatter of
   its chunk, counted in ``COLLECTIVE_BYTES`` / ``COLLECTIVE_COUNTS``, and
   no all-gather.  Some cases run their backward too: the gradient goes
   back by the reverse exchange, or, from a partial sum, by an
   all-gather.
2. the same moves as rank 0 of ``launch.dryrun.fake_world(4)`` on
   ``meta`` tensors through ``step_analysis.analyze_step``: the process
   group ops it sees (``c10d.alltoall_base_``,
   ``c10d._reduce_scatter_base_``, never ``c10d._allgather_base_``) and
   the bytes that gloo's rank 0 counted.

The ranks and the fake world run in subprocesses; a rank that fails or
outlives its limit fails the tests that read it.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from test_torch_reference import REPO

from repro_torch.testing import MOVE_CASES

WORLD = 4
RANK_LIMIT_S = 240            # every rank of the spawn, joined together
FAKE_LIMIT_S = 240

# the process-group op each kind of collective reaches
_OPS = {"all_to_all": "c10d.alltoall_base_",
        "reduce_scatter": "c10d._reduce_scatter_base_",
        "all_reduce": "c10d.allreduce_"}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.path.join(REPO, "tests")]))


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank: the meshes, every move case, the exchange groups, the
    boxes against DTensor's own arithmetic, and a two-dim exchange on a
    mesh made without its groups."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.testing import (MOVE_MESHES, placements_of,
                                     run_move_cases)

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        meshes = {k: make_test_mesh(shape, axes, device_type="cpu")
                  for k, (shape, axes) in MOVE_MESHES.items()}
        out = {"cases": run_move_cases(meshes, "cpu"),
               "groups": {k: sorted(m.__dict__["_exchange_groups"])
                          for k, m in meshes.items()}}
        boxes = []
        for _, mesh_name, shape, have, want, _, _ in MOVE_CASES:
            mesh = meshes[mesh_name]
            for spec in (have, want):
                pl = placements_of(spec)
                n, o = compute_local_shape_and_global_offset(shape, mesh, pl)
                mine = sharding._box(shape, tuple(mesh.mesh.shape),
                                     tuple(mesh.get_coordinate()), pl)
                # an empty block's offset is DTensor's convention alone
                same = list(mine[1]) == list(n) and (
                    0 in n or list(mine[0]) == list(o))
                boxes.append(same or (spec, mine, (o, n)))
        out["boxes"] = boxes
        bare = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.zeros(2, 2), bare,
                               placements_of("S0,S1"), run_check=False,
                               shape=(4, 4), stride=(4, 1))
        try:
            sharding.move(x, placements_of("S1,S1"))
            out["bare"] = None
        except RuntimeError as e:
            out["bare"] = str(e)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 gloo ranks once; their pickled results by rank."""
    workdir = str(tmp_path_factory.mktemp("moves"))
    code = textwrap.dedent(f"""
        import sys
        from test_torch_moves import _rank_main
        _rank_main(int(sys.argv[1]), {WORLD}, {workdir!r})
    """)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=_env(), cwd=REPO)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=RANK_LIMIT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()

    def tail(r):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            return f.read()[-3000:]

    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} exit {procs[r].returncode}:\n"
                              + tail(r) for r in bad)
    out = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


NAMES = [c[0] for c in MOVE_CASES]
KINDS = {c[0]: c[5] for c in MOVE_CASES}
BACKWARD = [c[0] for c in MOVE_CASES if c[6]]


def _case(ranks, name):
    return [next(c for c in r["cases"] if c["name"] == name) for r in ranks]


@pytest.mark.parametrize("name", NAMES)
def test_move_equals_gather_and_cut(ranks, name):
    """Every rank's block bit for bit the whole value cut, with
    ``want``'s placements."""
    for r, c in enumerate(_case(ranks, name)):
        assert c["placements_ok"], r
        assert c["out"].shape == c["oracle"].shape, (r, c["out"].shape)
        assert torch.equal(c["out"], c["oracle"]), r


@pytest.mark.parametrize("name", NAMES)
def test_move_issues_the_references_collective(ranks, name):
    """One collective of each kind the reference's lowering issues, at
    its rule: an all-to-all's local block, a reduce-scatter's chunk
    (padded to the ceil size), an all-reduce twice its value; no
    all-gather."""
    for r, c in enumerate(_case(ranks, name)):
        assert c["bytes"] == c["expected_bytes"], (r, c["bytes"])
        assert c["counts"] == {k: 1 for k in KINDS[name]}, (r, c["counts"])
        # every Shard -> Shard, re-nested or Partial -> Shard dim took the
        # collective of its kind, none an all-gather
        for route in c["routes"]:
            kind, how = route.split("->")
            assert "all_gather" not in how, (r, c["routes"])
            if kind in ("all_to_all", "none"):
                assert how == "all_to_all", (r, c["routes"])
            if kind == "reduce_scatter":
                assert how == "reduce_scatter", (r, c["routes"])


@pytest.mark.parametrize("name", BACKWARD)
def test_move_backward(ranks, name):
    """The gradient of ``sum(move(x) * g)`` is ``g`` at ``x``'s
    placements (a partial sum's gradient replicated), bit for bit, moved
    back by the reverse exchange or, from a partial sum, by one
    all-gather of the block."""
    back = "all_gather" if "reduce_scatter" in KINDS[name] else "all_to_all"
    for r, c in enumerate(_case(ranks, name)):
        assert c["grad_placements_ok"], r
        assert torch.equal(c["grad"], c["grad_oracle"]), r
        assert c["grad_counts"] == {back: 1}, (r, c["grad_counts"])
        assert c["grad_bytes"] == {back: c["grad"].numel() * 4}, r


def test_exchange_groups_made_with_the_mesh(ranks):
    """``launch.mesh`` makes one group over every set of two or more of a
    mesh's dims that hold more than one rank; ``move``'s boxes are
    DTensor's own shards (an empty one's offset aside); a two-dim
    exchange on a mesh made without its groups raises, naming
    ``exchange_groups``, on every rank."""
    for r in ranks:
        assert r["groups"] == {"2x2": [(0, 1)], "1x2x2": [(1, 2)]}
        assert all(b is True for b in r["boxes"]), \
            [b for b in r["boxes"] if b is not True]
        assert r["bare"] and "exchange_groups" in r["bare"]


_FAKE = """
import json, torch
from torch.distributed.tensor import DTensor
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.distributed import sharding
from repro_torch.testing import (MOVE_CASES, MOVE_MESHES, cut_as_dtensor,
                                 placements_of)

out = {}
with fake_world(4):
    meshes = {k: make_test_mesh(s, a, device_type="cpu")
              for k, (s, a) in MOVE_MESHES.items()}
    for name, mesh_name, shape, have, want, _, _ in MOVE_CASES:
        mesh = meshes[mesh_name]
        pl = placements_of(have)
        loc = cut_as_dtensor(torch.empty(shape, device="meta"),
                             tuple(mesh.mesh.shape),
                             tuple(mesh.get_coordinate()), pl)
        x = DTensor.from_local(loc, mesh, pl, run_check=False,
                               shape=torch.Size(shape),
                               stride=torch.empty(shape).stride())
        a = analyze_step(lambda t: sharding.move(t, placements_of(want)),
                         (x,))["analysis"]
        out[name] = {"ops": a["collective_ops"],
                     "bytes": a["collective_bytes"],
                     "counts": a["collective_counts"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake():
    r = subprocess.run([sys.executable, "-c", _FAKE], capture_output=True,
                       text=True, timeout=FAKE_LIMIT_S, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_dry_run_sees_the_collectives(fake, ranks, name):
    """Rank 0 of a fake world on ``meta`` tensors issues the same ops
    (no all-gather) and counts the bytes gloo's rank 0 counted."""
    rec = fake[name]
    assert rec["ops"] == {_OPS[k]: 1 for k in KINDS[name]}, rec["ops"]
    assert "c10d._allgather_base_" not in rec["ops"]
    want = {k.replace("_", "-"): n
            for k, n in _case(ranks, name)[0]["bytes"].items()}
    assert {k: n for k, n in rec["bytes"].items()
            if n and k != "total"} == want
