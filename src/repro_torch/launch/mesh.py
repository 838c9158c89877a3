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
RENDEZVOUS_S = 600     # the ranks' wait for each other at start-up


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


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """Every rank of the process group as a (data = world // model, model)
    ``DeviceMesh`` with ``mesh_dim_names=("data", "model")``: of
    ``device_type``, by default "cuda" under NCCL and "cpu" otherwise
    (gloo moves CPU and CUDA tensors alike). A ``DTensor`` lives on its
    mesh's device type: DTensors on the card over gloo take "cuda" (and
    ``gloo_on_card``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    assert n % model == 0, f"world size {n} is not a multiple of {model}"
    device_type = device_type or (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
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
    CPU, or with more ranks than cards, raises.

    The ranks first meet in the store, for up to ``RENDEZVOUS_S`` (at
    least ``timeout_s``): processes that start seconds apart (a loaded
    host importing torch) then connect the group together, so the
    group's own waits, which ``timeout_s`` bounds, are not spent on a
    late start."""
    dev = mesh_rank_device(backend, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    meet = datetime.timedelta(seconds=max(RENDEZVOUS_S, timeout_s))
    store, _, _ = next(dist.rendezvous(init_method or "env://", rank,
                                       world, timeout=meet))
    store.set_timeout(meet)
    arrived = dist.PrefixStore("repro_torch/arrived", store)
    arrived.set(str(rank), "1")
    arrived.wait([str(r) for r in range(world)])
    dist.init_process_group(
        backend, store=dist.PrefixStore("default_pg", store), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
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


_REDUCE_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN",
               "product": "PRODUCT"}


def gloo_on_card(force: bool = False) -> None:
    """Route the functional collectives that ``DTensor`` (and the port's
    own sharded code) issues on CUDA tensors over gloo groups through
    the synchronous c10d collectives of the same names. Ranks that share
    one card must use gloo (NCCL refuses two ranks on one card), and in
    torch 2.11 the functional all-gather of a CUDA tensor on a gloo group
    (``_c10d_functional.all_gather_into_tensor``, as DTensor's redistribute
    calls it) segfaults at its wait, while ``dist.all_gather_into_tensor``
    of the same tensor works; so do the c10d reduce-scatter, all-reduce,
    all-gather and all-to-all of CUDA tensors, which this uses, one for
    one: DTensor's ``Shard(a)`` -> ``Shard(b)`` is an all-to-all here
    too (``dist.all_to_all_single``, after a gather of one integer a
    rank: the blocks' sizes), not the all-gather and chunk that torch's
    own CPU route makes of it, and so is the functional
    ``all_to_all_single`` (the microbatch split's,
    ``launch/steps.py::_route_rows``). Applies to the
    process, once; other tensors and groups take the functional
    collectives as before (``force``: every tensor on a gloo group, which
    the CPU tests use to run this route)."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor.placement_types as placement_types
    from torch.distributed import distributed_c10d as c10d
    from torch.distributed.device_mesh import DeviceMesh
    if getattr(funcol, "_repro_torch_gloo_on_card", False):
        return

    def group_of(group):
        if isinstance(group, tuple) and len(group) == 2 \
                and isinstance(group[0], DeviceMesh):
            return group[0].get_group(group[1])
        if isinstance(group, str):
            return c10d._resolve_process_group(group)
        if isinstance(group, dist.ProcessGroup):
            return group
        if isinstance(group, DeviceMesh) and group.ndim == 1:
            return group.get_group()
        return None

    def raw_group(t, group):
        """The gloo group to run ``t``'s collective on, or None."""
        pg = group_of(group)
        if pg is None or not (force or t.is_cuda):
            return None
        return pg if dist.get_backend(pg) == "gloo" else None

    def op_of(name):
        return getattr(dist.ReduceOp, _REDUCE_OPS[name.lower()])

    def gather(self, gather_dim, group, pg):
        n = pg.size()
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        if gather_dim != 0:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out

    def wrap_gather(orig):
        def all_gather(self, gather_dim, group, tag=""):
            pg = raw_group(self, group)
            if pg is None:
                return orig(self, gather_dim, group, tag)
            return gather(self, gather_dim, group, pg)
        return all_gather

    def wrap_scatter(orig):
        def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
            pg = raw_group(self, group)
            if pg is None:
                return orig(self, reduceOp, scatter_dim, group, tag)
            n = pg.size()
            x = self
            if scatter_dim != 0:
                x = torch.cat(torch.chunk(x, n, dim=scatter_dim), dim=0)
            x = x.contiguous()
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, op=op_of(reduceOp), group=pg)
            return out / n if reduceOp.lower() == "avg" else out
        return reduce_scatter

    def wrap_reduce(orig):
        def all_reduce(self, reduceOp, group, tag=""):
            pg = raw_group(self, group)
            if pg is None:
                return orig(self, reduceOp, group, tag)
            out = self.contiguous().clone()
            dist.all_reduce(out, op=op_of(reduceOp), group=pg)
            return out / pg.size() if reduceOp.lower() == "avg" else out
        return all_reduce

    def alltoall(x, gather_dim, shard_dim, pg):
        """``Shard(gather_dim)`` -> ``Shard(shard_dim)`` as one
        all-to-all: chunk j of ``x`` along ``shard_dim`` (DTensor's
        ``torch.chunk`` split) goes to rank j, and the chunks received
        are laid along ``gather_dim`` in rank order. The ranks' blocks
        along ``gather_dim`` may differ (an uneven split): their sizes
        come first, in a gather of one integer a rank."""
        n, me = pg.size(), pg.rank()
        parts = list(torch.chunk(x, n, dim=shard_dim))
        parts += [x.narrow(shard_dim, 0, 0)] * (n - len(parts))
        every = torch.empty(n, dtype=torch.int64)
        dist.all_gather_into_tensor(
            every, torch.tensor([x.shape[gather_dim]]), group=pg)
        shape = list(x.shape)
        shape[shard_dim] = parts[me].shape[shard_dim]
        recv = [shape[:gather_dim] + [g] + shape[gather_dim + 1:]
                for g in every.tolist()]
        counts = [math.prod(s) for s in recv]
        out = x.new_empty(sum(counts))
        dist.all_to_all_single(
            out, torch.cat([p.reshape(-1) for p in parts]),
            output_split_sizes=counts,
            input_split_sizes=[p.numel() for p in parts], group=pg)
        return torch.cat([b.view(s) for b, s in
                          zip(torch.split(out, counts), recv)],
                         dim=gather_dim)

    def wrap_alltoall(orig):
        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            pg = raw_group(input, (mesh, mesh_dim))
            if pg is None:
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            return alltoall(input, gather_dim, shard_dim, pg)
        return shard_dim_alltoall

    def wrap_alltoall_single(orig):
        def all_to_all_single(self, output_split_sizes, input_split_sizes,
                              group, tag=""):
            pg = raw_group(self, group)
            if pg is None:
                return orig(self, output_split_sizes, input_split_sizes,
                            group, tag)
            x = self.contiguous()
            out = x.new_empty((sum(output_split_sizes),) + tuple(x.shape[1:]))
            dist.all_to_all_single(out, x,
                                   output_split_sizes=output_split_sizes,
                                   input_split_sizes=input_split_sizes,
                                   group=pg)
            return out
        return all_to_all_single

    for name, wrap in (("all_to_all_single", wrap_alltoall_single),
                       ("all_gather_tensor", wrap_gather),
                       ("all_gather_single", wrap_gather),
                       ("reduce_scatter_tensor", wrap_scatter),
                       ("reduce_scatter_single", wrap_scatter),
                       ("all_reduce", wrap_reduce)):
        if hasattr(funcol, name):
            setattr(funcol, name, wrap(getattr(funcol, name)))
    if hasattr(placement_types, "shard_dim_alltoall"):
        placement_types.shard_dim_alltoall = wrap_alltoall(
            placement_types.shard_dim_alltoall)
    funcol._repro_torch_gloo_on_card = True
