"""Meshes over a ``torch.distributed`` world.

Port of ``repro/launch/mesh.py``.  JAX holds every device in one
controller; here each rank is one process a card, so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks, with the
reference's axis names.  Start the process group first (``torchrun`` /
``python -m torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; or ``init_process_group`` with a store).  Building a mesh
creates its process groups, which is collective over the whole world:
every rank calls these functions with the same arguments, in the same
order, also for meshes it is not part of.  Besides one group a mesh dim,
each mesh gets one group over every set of two or more of its dims
(``sharding.exchange_groups``), in which a move's all-to-all spans
several mesh dims.  Importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import (MULTI_POD_PLAN,
                                              SINGLE_POD_PLAN, ShardPlan,
                                              exchange_groups)

__all__ = ["make_production_mesh", "make_plan", "make_test_mesh",
           "make_cell_meshes"]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(ranks, shape, axes, device_type) -> DeviceMesh:
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = DeviceMesh(device_type,
                      torch.as_tensor(list(ranks)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
    exchange_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type=None) -> DeviceMesh:
    """16x16 one pod (256 ranks) or 2x16x16 two pods (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(
            f"need {n} devices, found {_world()} — launch {n} ranks "
            "(python -m torch.distributed.run --nproc-per-node ...) "
            "before building the production mesh")
    return _mesh(range(n), shape, axes, device_type)


def make_plan(mesh) -> ShardPlan:
    """Bind the role plan matching a mesh's axis names."""
    if "pod" in mesh.mesh_dim_names:
        return MULTI_POD_PLAN.with_mesh(mesh)
    return SINGLE_POD_PLAN.with_mesh(mesh)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device_type=None) -> DeviceMesh:
    """A small mesh over the first ``prod(shape)`` ranks of the world."""
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"world has {_world()}")
    return _mesh(range(n), shape, axes, device_type)


def make_cell_meshes(n_cells: int, *, shape=None, axes=None, ranks=None,
                     share_devices: bool = False,
                     device_type=None) -> list:
    """Partition the rank pool into ``n_cells`` sub-meshes.

    Cells are carved as consecutive rank blocks (cell i gets ranks
    ``[i * per_cell, (i + 1) * per_cell)`` of ``ranks``, default the
    world).  ``shape`` / ``axes`` describe one cell's mesh (default: all
    of its ranks on a flat ``("data",)`` axis).  ``share_devices=True``
    lets cells reuse blocks round-robin when the pool is smaller than the
    fleet: the meshes are still distinct process groups (for tests and
    one-host runs; production fleets keep the default).  A rank repeated
    inside one mesh is refused.  Collective over the world, as every mesh.
    """
    if n_cells <= 0:
        raise ValueError("n_cells must be positive")
    pool = list(range(_world())) if ranks is None else list(ranks)
    if shape is None:
        per_cell = len(pool) // n_cells
        if share_devices:
            per_cell = max(per_cell, 1)
        elif per_cell == 0:
            raise RuntimeError(
                f"{n_cells} disjoint cells need at least {n_cells} "
                f"ranks, found {len(pool)} — pass share_devices=True for "
                "logically separate meshes over a shared pool")
        shape = (per_cell,)
    n_per = math.prod(shape)
    if axes is None:
        axes = (("data", "model")[:len(shape)] if len(shape) <= 2
                else ("pod", "data", "model")[:len(shape)])
    need = n_cells * n_per
    if len(pool) < need and not share_devices:
        raise RuntimeError(
            f"{n_cells} disjoint cells of shape {tuple(shape)} need "
            f"{need} ranks, found {len(pool)} — pass share_devices=True "
            "for logically separate meshes over a shared pool")
    if n_per > len(pool):
        raise ValueError(
            f"a cell of shape {tuple(shape)} needs {n_per} distinct ranks, "
            f"the pool has {len(pool)}: a rank may not repeat inside one "
            "mesh")
    meshes = []
    for i in range(n_cells):
        if len(pool) < need:
            block = [pool[(i * n_per + j) % len(pool)] for j in range(n_per)]
        else:
            block = pool[i * n_per:(i + 1) * n_per]
        meshes.append(_mesh(block, shape, axes, device_type))
    return meshes
