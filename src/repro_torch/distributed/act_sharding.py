"""Activation sharding constraints (counterpart of
``repro/distributed/act_sharding.py``).

Model code calls ``constrain(x, "dp", None, None)`` at block boundaries;
the launcher installs the mesh with ``use_mesh`` before it runs a step. A
no-op when no mesh is installed: every one-card caller.

Roles: "dp" -> the batch axes ("pod", "data"), plus "model" under the
``fsdp_only`` profile; "tp" -> "model" (nothing under ``fsdp_only``);
"fsdp" -> "data". A dim that does not divide its axis stays
unconstrained. The reference's ``with_sharding_constraint`` becomes:

- on a ``DTensor``: ``redistribute`` to the spec's placements
  (``sharding.to_placements``), the collective DTensor picks for the
  move; its backward puts the gradient on the same placements;
- on a plain tensor under a mesh: a check, the rule must leave every
  dim whole (a plain tensor is replicated: one the rule would shard is
  an activation the sharded program lost track of), and it is returned.

``constrain_spec`` is the spec the rule gives a global shape, the
reference's ``PartitionSpec`` as a tuple (``sharding.py``'s form).

``gather_weights`` is the FSDP all-gather the reference leaves to GSPMD:
a layer's weights are gathered on every axis but the tensor-parallel
one ("model" under the "tp" profile; every axis under ``fsdp_only``)
before the layer uses them, so each product is a batch-sharded
activation times a "model"-sharded weight (DTensor's own choice for a
product of two sharded operands may shard the tokens instead, which a
later reshape cannot follow); the gradient goes back to the parameter's
own placements (a reduce-scatter).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_MESH = None
_PROFILE: str = "tp"


def set_mesh(mesh, profile: str = "tp") -> None:
    global _MESH, _PROFILE
    _MESH = mesh
    _PROFILE = profile


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh, profile: str = "tp"):
    prev, prev_p = _MESH, _PROFILE
    set_mesh(mesh, profile)
    try:
        yield
    finally:
        set_mesh(prev, prev_p)


def _role_axes(role: Optional[str]) -> Tuple[str, ...]:
    from repro_torch.distributed.sharding import _view
    names = _view(_MESH).axis_names
    if role == "dp":
        want = (("pod", "data", "model") if _PROFILE == "fsdp_only"
                else ("pod", "data"))
        return tuple(a for a in want if a in names)
    if role == "tp":
        if _PROFILE == "fsdp_only":   # the model axis serves as DP/FSDP
            return ()
        return ("model",) if "model" in names else ()
    if role == "fsdp":
        return ("data",) if "data" in names else ()
    return ()


def constrain_spec(shape, *roles) -> tuple:
    """The spec the rule gives a global ``shape`` under the installed
    mesh, one entry per dim (trailing ``None``s kept, as ``P(*spec)``)."""
    from repro_torch.distributed.sharding import _view
    sizes = _view(_MESH).shape
    spec = []
    used = set()
    for dim, role in zip(shape, roles):
        picked = []
        rem = dim
        for a in _role_axes(role):
            n = sizes[a]
            if n > 1 and rem % n == 0 and a not in used:
                picked.append(a)
                used.add(a)
                rem //= n
        spec.append(tuple(picked) if len(picked) > 1
                    else (picked[0] if picked else None))
    return tuple(spec)


def constrain(x: torch.Tensor, *roles) -> torch.Tensor:
    """roles: one of "dp" | "tp" | "fsdp" | None per dim of ``x``."""
    if _MESH is None:
        return x
    from repro_torch.distributed.sharding import to_placements
    spec = constrain_spec(tuple(x.shape), *roles)
    if is_dtensor(x):
        # redistributed even to the placements it has: the backward then
        # puts the gradient on them too, as the reference's constraint
        # binds the cotangent
        return x.redistribute(x.device_mesh,
                              to_placements(spec, x.device_mesh))
    if any(e is not None for e in spec):
        raise ValueError(
            f"constrain: a plain tensor of shape {tuple(x.shape)} under a "
            f"mesh, which the rule shards ({spec}); the sharded program "
            f"runs on DTensors (distributed/sharding.py::distribute_tree)")
    return x


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gather_weights(tree, skip: tuple = ("experts",)):
    """Every ``DTensor`` leaf of ``tree`` gathered on each mesh dim that
    is not the "tp" role's axis (module docstring), leaves under a key in
    ``skip`` (the expert-parallel weights) as they are; the tree itself
    without a mesh."""
    if _MESH is None:
        return tree
    from torch.distributed.tensor import Replicate
    keep = set(_role_axes("tp"))

    def one(x):
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        pl = [p if names[i] in keep else Replicate()
              for i, p in enumerate(x.placements)]
        return x if pl == list(x.placements) else \
            x.redistribute(x.device_mesh, pl)

    def walk(t):
        if isinstance(t, dict):
            return {k: (v if k in skip else walk(v)) for k, v in t.items()}
        return one(t)
    return walk(tree)


class _SumOver(torch.autograd.Function):
    """Sum over the ranks of ``groups`` (functional all-reduces, one a
    mesh axis); the gradient passes through as it is: every rank of
    those axes then holds the same gradient of the summed value."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed._functional_collectives as funcol
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """A local tensor summed over the mesh dims ``dims`` (indices), the
    backward the identity (``_SumOver``); ``x`` as it is over none."""
    groups = [mesh.get_group(i) for i in dims if mesh.size(i) > 1]
    return _SumOver.apply(x, groups) if groups else x


def embedding_lookup(table, ids):
    """Rows ``ids`` of a ``DTensor`` table, on each rank's local blocks:
    a table sharded on its rows (the vocab on "model") looks up the ids
    its block holds, zeros elsewhere, and the rows are summed over those
    axes (an all-reduce of (..., d)); the ids keep their batch sharding.
    DTensor's own rules for the lookup (``index`` and ``embedding``, and
    their backwards) fail on some of the placements and torch versions
    the port runs on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if any(p.is_shard() and not p.is_shard(0) for p in table.placements):
        raise ValueError(f"an embedding table sharded off its rows: "
                         f"{table.placements}")
    rows = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    id_pl = [Replicate() if i in rows or p.is_partial() else p
             for i, p in enumerate(ids.placements)]
    local_ids = ids.redistribute(mesh, id_pl).to_local()
    tab = table.to_local(grad_placements=[
        table.placements[i] if i in rows else
        (Partial() if id_pl[i].is_shard() else Replicate())
        for i in range(mesh.ndim)])
    n = tab.shape[0]
    start = 0
    coord = mesh.get_coordinate()
    for i in rows:
        start = start * mesh.size(i) + coord[i]
    start *= n
    if rows:
        at = local_ids.long() - start
        inside = (at >= 0) & (at < n)
        out = torch.nn.functional.embedding(at.clamp(0, n - 1), tab) \
            * inside[..., None].to(tab.dtype)
        out = sum_over(out, mesh, rows)
    else:
        out = torch.nn.functional.embedding(local_ids.long(), tab)
    return DTensor.from_local(out, mesh, id_pl, run_check=False)


def batch_local(fn, x, params, *state, **kw):
    """``fn(params, *state, x, **kw)`` on each rank's local blocks: ``x``
    and the ``state`` leaves sharded over the batch axes (dim 0) only,
    ``params`` gathered whole, and every tensor ``fn`` returns (batch
    first) taken back as sharded over those axes. The recurrent mixers
    (Mamba, mLSTM, sLSTM) run so: their scans are thousands of small ops
    a sequence, on which DTensor's rules differ between torch versions;
    the "model" axis computes the same rows (their parameters' gradients
    are partial over the batch axes only). Plain tensors: ``fn`` as it
    is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.tree import tree_map
    if not isinstance(x, DTensor):
        return fn(params, *state, x, **kw)
    mesh = x.device_mesh
    pl = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    grad = [Partial() if p.is_shard(0) else Replicate() for p in pl]
    whole = [Replicate()] * mesh.ndim

    def local(t, placements, grad_placements=None):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)
    out = fn(tree_map(lambda w: local(w, whole, grad), params),
             *(tree_map(lambda t: local(t, pl), st) for st in state),
             local(x, pl), **kw)
    return tree_map(lambda t: DTensor.from_local(t, mesh, pl,
                                                 run_check=False), out)
