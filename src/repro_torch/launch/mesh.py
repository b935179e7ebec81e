"""Production meshes, as `torch.distributed.device_mesh.DeviceMesh`es.

The port of `repro.launch.mesh`.  A production cluster is 256 cards
as (data=16, model=16); the multi-pod mesh stacks two such pods on a
leading pure-DP axis (pod=2, data=16, model=16), and GEE runs
edge-parallel over a flat (edges=256 | 512) mesh.

Where the process group's world is smaller than the mesh (the dry run,
in one process), the mesh is built over a `fake` process group of the
mesh's size: this process is rank 0 of it, its collectives return at
once and move nothing, and its tensors are the caller's (fake tensors
under `FakeTensorMode` in the dry run): it never touches a card.  A
fake group already in place is replaced by one of the needed size; a
real group of another size raises.  Building a mesh starts no group at
import time.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _is_fake() -> bool:
    return dist.is_initialized() and "fake" in str(dist.get_backend())


def fake_world(size: int) -> None:
    """Make the default process group a `fake` one of `size` ranks, this
    process rank 0 (a fake group of another size is replaced)."""
    if dist.is_initialized():
        if _is_fake() and dist.get_world_size() == size:
            return
        if not _is_fake():
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks is initialized; a {size}-rank mesh needs that many "
                "ranks or no group (then it is built over a fake one)")
        dist.destroy_process_group()
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _mesh(shape, names) -> DeviceMesh:
    need = math.prod(shape)
    if not (dist.is_initialized() and dist.get_world_size() == need
            and not _is_fake()):
        fake_world(need)
        kind = "cpu"
    else:
        kind = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(kind, torch.arange(need).view(*shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         shape=None) -> DeviceMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with multi_pod;
    `shape` another (data, model) or (pod, data, model) size."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if len(shape) == 3 else \
        ("data", "model")
    return _mesh(tuple(shape), names)


def make_gee_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """GEE runs edge-parallel over every card: flat 1-D mesh."""
    return _mesh((512 if multi_pod else 256,), ("edges",))


def make_host_mesh() -> DeviceMesh:
    """A 1-D ("data",) mesh over the ranks that exist: the initialized
    group's world, or a one-rank gloo group started here."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    kind = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(kind, list(range(dist.get_world_size())),
                      mesh_dim_names=("data",))
