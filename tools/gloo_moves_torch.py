"""Time ``sharding.move``'s collectives against the moves they replaced,
on four gloo ranks sharing one device.

The four ranks of the smoke's ``sharded models`` phase share the card
under gloo, which runs an all-to-all and a reduce-scatter on host
tensors only: ``sharding`` stages a card tensor's through pinned host
memory.  This times, on a ``(2, 2)`` mesh at qwen3-0.6b's widths, each
move by its own route and by the one it replaced, in turns:

* ``reduce-scatter``: ``(Shard(0), Partial()) -> (Shard(0), Shard(1))``
  of a (4, 4096, 1024) fp32 residual (32 MiB a rank), against one gloo
  all-reduce of the card tensor and a cut;
* ``all-to-all``: the MoE's ``(Shard(0), Shard(1)) -> (Shard(1),
  Shard(1))`` of a (4, 64, 512, 1024) fp32 expert block (32 MiB a
  rank), against two all-gathers and a cut.

It prints rank 0's host-clock mean over ``--reps`` rounds of each route
(a round runs them in turns, A B B A) after one call of each, which
also holds the two results equal; every call ends in a synchronise and
a barrier.

    python tools/gloo_moves_torch.py --device cuda     # on the card
    python tools/gloo_moves_torch.py --device cpu      # a rehearsal
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

WORLD = 4


def _old_reduce_scatter(x, want):
    """The replaced route: one all-reduce of the partial value, then a
    cut."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    loc = x.to_local().contiguous().clone()
    dist.all_reduce(loc, group=mesh.get_group(1))
    c = -(-loc.shape[1] // mesh.size(1))
    loc = loc.narrow(1, mesh.get_local_rank(1) * c, c).contiguous()
    return DTensor.from_local(loc, mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def _old_exchange(x, want):
    """The replaced route: both mesh dims gathered (the last first), then
    cut as ``want`` nests them."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    loc = x.to_local()
    for m, d in ((1, 1), (0, 0)):
        part = loc.movedim(d, 0).contiguous()
        out = part.new_empty((mesh.size(m) * part.shape[0],)
                             + part.shape[1:])
        dist.all_gather_into_tensor(out, part, group=mesh.get_group(m))
        loc = out.movedim(0, d)
    c = loc.shape[1] // (mesh.size(0) * mesh.size(1))
    at = mesh.get_local_rank(0) * mesh.size(1) + mesh.get_local_rank(1)
    loc = loc.narrow(1, at * c, c).contiguous()
    return DTensor.from_local(loc, mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def _rank(rank: int, workdir: str, device: str, reps: int) -> None:
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_test_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type=dev.type)
        g = torch.Generator().manual_seed(rank)
        part = DTensor.from_local(
            torch.randn((2, 4096, 1024), generator=g).to(dev), mesh,
            (Shard(0), Partial()), run_check=False, shape=(4, 4096, 1024),
            stride=(4096 * 1024, 1024, 1))
        block = DTensor.from_local(
            torch.randn((2, 32, 512, 1024), generator=g).to(dev), mesh,
            (Shard(0), Shard(1)), run_check=False,
            shape=(4, 64, 512, 1024), stride=(64 * 512 * 1024, 512 * 1024,
                                               1024, 1))
        cases = {
            "reduce-scatter": (part, (Shard(0), Shard(1)),
                               _old_reduce_scatter),
            "all-to-all": (block, (Shard(1), Shard(1)), _old_exchange)}
        out = {"device": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu"}
        for name, (x, want, old) in cases.items():
            routes = {"move": lambda: sharding.move(x, want),
                      "replaced route": lambda: old(x, want)}
            same = torch.equal(routes["move"]().to_local(),
                               routes["replaced route"]().to_local())
            ms = {k: [] for k in routes}
            for _ in range(reps):
                for k in (list(routes) + list(routes)[::-1]):
                    dist.barrier()
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    routes[k]()
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    dist.barrier()
                    ms[k].append((time.perf_counter() - t0) * 1e3)
            out[name] = {"equal": same, **{k: sum(v) / len(v)
                                           for k, v in ms.items()}}
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    import torch.multiprocessing as mp

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="gloo-moves-",
                               dir=os.path.join(REPO, "build"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, workdir, args.device,
                                             args.reps))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    shutil.rmtree(workdir, ignore_errors=True)
    return 0 if codes == [0] * WORLD else 1


if __name__ == "__main__":
    raise SystemExit(main())
