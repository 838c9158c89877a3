"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module touches
no process group. ``make_host_mesh`` lays the ranks of the initialised
``torch.distributed`` process group out as a ("data", "model")
``DeviceMesh``, the counterpart of the JAX ``Mesh`` over local devices:
one process a rank, each rank one position of the mesh. Several ranks may
share one card (gloo); NCCL wants a card a rank.

``make_production_mesh`` is the pods' layout the reference's dry-run
lowers its cells on: (16, 16) ("data", "model"), 256 cards, and with
``multi_pod`` (2, 16, 16) ("pod", "data", "model"), 512. Without a process
group it is a ``MeshLayout``, axis names and sizes only: the rules of
``distributed/sharding.py`` read nothing else, and ``launch/dryrun.py``
counts a rank's program on it. A process group of that size gets the
``DeviceMesh`` of the same layout.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

DIST_TIMEOUT_S = 60   # default: a collective that waits longer fails,
#                       not hangs
RANK0_ALONE_S = 86400  # the others' wait for rank 0's work alone: its
#                        length grows with the run's settings


class MeshLayout(NamedTuple):
    """A mesh's axis names and their sizes, with no process group."""
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False):
    """The pods' layout (16 x 16 cards a pod, a "pod" axis in front of
    two) as a ``DeviceMesh`` over the initialised process group, which
    must hold exactly its cards; without a process group, the
    ``MeshLayout`` itself (module docstring)."""
    layout = (MeshLayout(("pod", "data", "model"), (2, 16, 16)) if multi_pod
              else MeshLayout(("data", "model"), (16, 16)))
    if not dist.is_initialized():
        return layout
    n = dist.get_world_size()
    if n != layout.size:
        raise ValueError(f"the production mesh {layout.shape} needs "
                         f"{layout.size} ranks, the process group has {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, layout.shape,
                            mesh_dim_names=layout.axis_names)


def make_host_mesh(model: int = 1):
    """Every rank of the process group as a (data = world // model, model)
    ``DeviceMesh`` with ``mesh_dim_names=("data", "model")``: of device
    type "cuda" under NCCL, "cpu" otherwise (gloo moves CPU and CUDA
    tensors alike)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    assert n % model == 0, f"world size {n} is not a multiple of {model}"
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_rank_device(backend: str, device: str) -> torch.device:
    """This rank's device under ``torch.distributed.run`` (``LOCAL_RANK``
    in the environment): ``cuda:{LOCAL_RANK % device_count}`` for CUDA,
    the CPU otherwise. NCCL with more local ranks than cards raises (it
    refuses two ranks on one card); gloo may share one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > cards:
        raise ValueError(
            f"--dist-backend nccl with {local_world} ranks on {cards} "
            f"card(s): NCCL refuses two ranks on one card; use "
            f"--dist-backend gloo, or at most {cards} ranks")
    return torch.device("cuda", local % cards)


def init_ranks(backend: str, device: str, *,
               init_method: str | None = None,
               timeout_s: float = DIST_TIMEOUT_S) -> torch.device:
    """Join this process's rank of a ``torch.distributed.run`` launch
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the environment) to the
    ``backend`` process group (``init_method`` default ``env://``; a
    ``file://`` store needs no port; collectives time out after
    ``timeout_s``) -> this rank's device, made current. NCCL on the
    CPU, or with more ranks than cards, raises."""
    dev = mesh_rank_device(backend, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@contextlib.contextmanager
def rank0_alone(mesh, timeout_s: float = RANK0_ALONE_S):
    """Wrap work that rank 0 does alone and the others wait for (the
    collection and the AIP fit, of unbounded length): the others wait at
    the block's end on a gloo group of their own (under either backend)
    for at most ``timeout_s``, not in a collective bound by the process
    group's shorter timeout. Made on entry by every rank; ``mesh`` None:
    nothing to wait for. An error inside the block skips the barrier:
    the process exits and its peers' barrier fails."""
    if mesh is None:
        yield
        return
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout_s))
    yield
    dist.barrier(group=group)
    dist.destroy_process_group(group)
