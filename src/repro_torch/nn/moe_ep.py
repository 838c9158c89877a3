"""Expert-parallel MoE (counterpart of ``repro/nn/moe_ep.py``).

Without a mesh (or without a "model" axis) ``moe_apply_ep`` is
``moe.moe_apply``: the route of every one-card caller. Over a
``DeviceMesh`` with a "model" axis it is the reference's ``shard_map``
body, run by each rank on its local blocks of ``DTensor`` inputs:

- the tokens stay sharded over the batch axes ("pod", "data") and
  replicated over "model" (all of them replicated when the batch does not
  divide, or when ``expert_axes="data_model"`` spreads the experts over
  "data" too), so dispatch needs no communication: each rank routes its
  local tokens over all E experts, keeps the assignments of its own
  expert group (``j`` from its "model" coordinate, or data x model),
  gathers its (E_loc, C, d) slots by index and runs its E_loc experts;
- the capacity C is per data shard, as in the reference;
- the combined output is summed over the expert axes
  (``act_sharding.sum_over``: an all-reduce whose backward is the
  identity, since every rank of an expert axis then holds the same
  gradient), the layer's only collective;
- the aux losses are averaged over the axes whose ranks hold different
  tokens or experts (the same on the others), as the reference's
  ``pmean``s give.

The local blocks leave DTensor with the gradient placements autograd
needs: a token's gradient is partial over the expert axes, the router's
over every axis that splits tokens or experts. With dropless settings
(capacity = E / top_k) the result equals ``moe.moe_apply``'s up to the
order of float sums.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.distributed.act_sharding import sum_over
from . import moe as _moe
from .module import ACTIVATIONS

Params = Dict[str, Any]


def _names(mesh) -> tuple:
    # a launch/mesh.py MeshLayout names its axes ``axis_names``, a
    # DeviceMesh ``mesh_dim_names``
    return tuple(getattr(mesh, "mesh_dim_names", None)
                 or getattr(mesh, "axis_names", None) or ())


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    names = _names(mesh)
    return sum_over(x, mesh, [names.index(a) for a in axes])


def moe_apply_ep(p: Params, x: torch.Tensor, *, top_k: int,
                 act: str = "silu", capacity_factor: float = 1.25,
                 expert_axes: str = "model", mesh=None) -> tuple:
    """``moe.moe_apply`` when ``mesh`` is None or has no "model" axis;
    over a ``DeviceMesh`` with one, the expert-parallel route (module
    docstring) on ``DTensor`` parameters and ``x``.

    ``expert_axes``: "model" shards the experts over "model" only;
    "data_model" spreads them over "data" x "model" (where E divides), and
    the tokens are then replicated."""
    names = _names(mesh)
    if mesh is None or "model" not in names:
        return _moe.moe_apply(p, x, top_k=top_k, act=act,
                              capacity_factor=capacity_factor)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(mesh, DeviceMesh) or not isinstance(x, DTensor):
        raise TypeError("moe_apply_ep over a mesh runs on DTensors on a "
                        "DeviceMesh (distributed/sharding.py::"
                        "distribute_tree)")
    size = {a: mesh.size(i) for i, a in enumerate(names)}
    B, T, d = x.shape
    E = p["router"].shape[-1]
    e_axes = ("model",)
    if expert_axes == "data_model" and "data" in names \
            and E % (size["model"] * size["data"]) == 0:
        e_axes = ("data", "model")
    ep = math.prod(size[a] for a in e_axes)
    if E % ep:
        raise ValueError(f"{E} experts do not divide over {e_axes} "
                         f"({ep} ranks)")
    E_loc = E // ep
    dp = tuple(a for a in ("pod", "data") if a in names)
    n_dp = math.prod(size[a] for a in dp)
    N = B * T
    split_tokens = not (N % n_dp or "data" in e_axes)
    tok_axes = dp if split_tokens else ()
    N_loc = N // n_dp if split_tokens else N
    C = max(1, math.ceil(N_loc * top_k / E * capacity_factor))
    a_fn = ACTIVATIONS[act]

    tok_pl = [Shard(0) if a in tok_axes else Replicate() for a in names]
    tokens_dt = x.reshape(N, d)
    tok = tokens_dt.redistribute(mesh, tok_pl).to_local(
        grad_placements=[Partial() if a in e_axes else pl
                         for a, pl in zip(names, tok_pl)])
    split = set(e_axes) | set(tok_axes)
    router = p["router"].redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if a in split else Replicate()
                         for a in names])
    w_pl = [Shard(0) if a in e_axes else Replicate() for a in names]
    w_grad = [Shard(0) if a in e_axes else
              (Partial() if a in tok_axes else Replicate()) for a in names]
    wg, wi, wo = (p["experts"][k].redistribute(mesh, w_pl).to_local(
        grad_placements=w_grad) for k in ("w_gate", "w_in", "w_out"))

    coord = dict(zip(names, mesh.get_coordinate()))
    j = coord["model"]
    if len(e_axes) == 2:
        j = coord["data"] * size["model"] + j

    logits = tok.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(-1)
    flat_w = top_p.reshape(-1)
    n = tok.shape[0]
    dev = tok.device
    tok_idx = torch.arange(n, device=dev).repeat_interleave(top_k)
    # rank within expert (over all experts, computed locally)
    sort_idx = torch.argsort(flat_e, stable=True)
    # bincounts as index_adds: the same integers, and a shape a
    # fake-tensor count can follow
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n * top_k, device=dev) - \
        starts[flat_e[sort_idx]]
    rank = torch.empty_like(rank_sorted).index_put_((sort_idx,),
                                                     rank_sorted)
    keep = rank < C

    # this rank's expert group only; dispatch by slot indices: token ids
    # into the (E_loc, C) slot map, then one (E_loc * C, d) gather
    local = (flat_e >= j * E_loc) & (flat_e < (j + 1) * E_loc) & keep
    le = torch.where(local, flat_e - j * E_loc, 0)
    lr = torch.where(local, rank, C)              # C: the drop slot
    slot_tok = torch.full((E_loc, C + 1), n, dtype=torch.long, device=dev)
    slot_tok[le, lr] = tok_idx
    slot_tok = slot_tok[:, :C]
    slot_valid = slot_tok < n
    tok_pad = torch.cat([tok, tok.new_zeros((1, d))], dim=0)
    buf = tok_pad[slot_tok.reshape(-1)].reshape(E_loc, C, d)

    h = (a_fn(torch.einsum("ecd,edf->ecf", buf, wg))
         * torch.einsum("ecd,edf->ecf", buf, wi))
    y = torch.einsum("ecf,efd->ecd", h, wo)
    y = y * slot_valid[..., None].to(y.dtype)

    slot_of_assign = le * C + torch.clamp(lr, max=C - 1)
    out_flat = y.reshape(E_loc * C, d)[slot_of_assign] * \
        (flat_w.to(y.dtype) * local.to(y.dtype))[:, None]
    out = _sum_over(out_flat.reshape(n, top_k, d).sum(dim=1), mesh, e_axes)

    me = probs.mean(dim=0)
    cnt = torch.zeros(E, device=dev).index_add_(
        0, flat_e, keep.float()) / max(n * top_k, 1)
    lb = E * torch.sum(me * cnt)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    drop = 1.0 - keep.float().mean()
    n_split = math.prod(size[a] for a in split)
    aux = _sum_over(torch.stack([lb, zl, drop]) / n_split, mesh,
                    [a for a in names if a in split])

    out = DTensor.from_local(out, mesh, tok_pl, run_check=False,
                             shape=(N, d), stride=(d, 1))
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if "shared" in p:
        out = out + _moe.gated_mlp(p["shared"], tokens_dt, act)
    return out.reshape(B, T, d), {"lb_loss": aux[0], "z_loss": aux[1],
                                  "drop_frac": aux[2]}
