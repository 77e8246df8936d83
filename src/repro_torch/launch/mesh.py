"""Mesh builders over the torch.distributed world.

Counterpart of ``repro/launch/mesh.py``. Each builder returns a
`torch.distributed.device_mesh.DeviceMesh` with named axes
("data", "model") (or ("pod", "data", "model") for the multi-pod
production mesh) over the first ranks of the world, one rank per device.
Functions, not module-level meshes, so importing this module touches no
device and no process group.

With no process group initialised, a builder opens a world of one in this
process over an in-memory `HashStore` (NCCL for "cuda", gloo for "cpu"):
no network and no launcher are needed for a 1x1 mesh. A larger mesh needs
the world started by its launcher, one process per rank
(`torch.distributed.init_process_group` with the rank, the world size and
a store or a localhost address).

`fake_world(n)` opens a world of n ranks in this process over torch's
fake process group: this process is rank 0, every collective returns at
once without moving data, and steps traced on meta tensors see the mesh
the production world would have (``launch.dryrun``, 256 or 512 ranks). It
cannot share a process with a real world.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def ensure_world(device_type: str = "cuda") -> None:
    """Initialise a world of one in this process when no process group
    exists: NCCL bound to the current card for "cuda", gloo for "cpu",
    over an in-process HashStore."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass device_type='cpu' "
                               "for a gloo mesh on the CPU")
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    elif device_type == "cpu":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")


def fake_world(n: int) -> None:
    """A world of `n` ranks over torch's fake process group, this process
    rank 0 (the one place that reaches torch's internal `FakeStore`). A
    fake world of at least `n` ranks that is already open is kept."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= n:
            return
        raise RuntimeError("a fake world cannot share a process with another world "
                           f"(this one has {dist.get_world_size()} ranks over "
                           f"{dist.get_backend()})")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    ensure_world(device_type)
    need = math.prod(shape)
    have = dist.get_world_size()
    if have < need:
        raise RuntimeError(f"need {need} ranks for mesh {tuple(shape)}, have {have}: start "
                           f"one process per rank (torch.distributed, world size {need})")
    ranks = torch.arange(need, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh: (data=16, model=16), or (pod=2, data=16,
    model=16) across pods. Raises when the world has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A (data, model) mesh over the first data * model ranks."""
    return _mesh((data, model), ("data", "model"), device_type)


def make_host_mesh(*, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over ALL ranks of the world: data = world /
    model. The topology builder of the sharded federation engine: a world
    of one gives the 1x1 mesh (every flat spec degrades to replication and
    the engine's collectives run on groups of one); `model` must divide
    the world size."""
    ensure_world(device_type)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return make_debug_mesh(n // model, model, device_type=device_type)
