"""Mixture-of-Experts: top-k routing with capacity-based sort/scatter
dispatch (counterpart of ``repro/nn/moe.py``).

The GShard/Switch capacity formulation, as the reference writes it:
tokens are ranked within their expert by a stable argsort, scattered into
a dense (E, C, d) buffer, processed with a batched einsum over the expert
axis, and combined back with the router weights. An assignment ranked at
or past the capacity C is dropped; which ones drop follows the stable
order of the flattened (token, k) assignments, so the sort must be
stable. No data-dependent shapes.

Under a mesh the reference's ``constrain`` calls put the dispatched
tokens on the batch axes and the (E, C, d) buffer expert-major on
"model". On ``DTensor``s the routing indices (the flattened top-k
experts, N * k integers) are the one tensor gathered whole on every rank,
before the rank-within-expert count, which then runs on plain tensors
(``_whole``): DTensor has no sharding rule for ``bincount``, and each
rank's slot of a token depends on every earlier token's choice. The
gathers and the scatter by routing index run on each rank's local blocks
(``_dispatch_local``, ``_combine_local``; DTensor has no rule for
``index_put_`` or the index's backward in every torch the port runs on):
a rank scatters its own tokens' assignments into the slots of its own
experts, partial over the axes that shard the tokens (one all-reduce of
the (E / model, C, d) block), and picks its tokens' outputs from its own
experts, partial over "model" (one all-reduce of its (N * k / dp, d)
rows).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.distributed.act_sharding import (constrain, constrain_spec,
                                                  is_dtensor)
from .module import ACTIVATIONS, dense_init, init_device, normal

Params = Dict[str, Any]


def gated_mlp_init(generator, d_model: int, d_ff: int, *,
                   dtype=torch.float32, device=None) -> Params:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype=dtype,
                             device=device)["w"],
        "w_in": dense_init(generator, d_model, d_ff, dtype=dtype,
                           device=device)["w"],
        "w_out": dense_init(generator, d_ff, d_model, dtype=dtype,
                            device=device)["w"],
    }


def _ff(h: torch.Tensor) -> torch.Tensor:
    """A (batch, ..., d_ff) hidden activation pinned to the batch axes and
    "model" on its last dim (under a mesh; DTensor's own choice may shard
    the tokens instead, and a later reshape cannot follow it)."""
    return constrain(h, "dp", *([None] * (h.dim() - 2)), "tp")


def rows(h: torch.Tensor) -> torch.Tensor:
    """A (batch, ..., d) output pinned to the batch axes, whole on every
    other dim (under a mesh: a "model"-partial product is summed here,
    not left to DTensor, which may reduce-scatter it over the tokens)."""
    return constrain(h, "dp", *([None] * (h.dim() - 1)))


def gated_mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    a = ACTIVATIONS[act]
    return rows(_ff(a(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"])


def mlp_init(generator, d_model: int, d_ff: int, *, dtype=torch.float32,
             device=None) -> Params:
    return {
        "w_in": dense_init(generator, d_model, d_ff, dtype=dtype,
                           device=device)["w"],
        "w_out": dense_init(generator, d_ff, d_model, dtype=dtype,
                            device=device)["w"],
    }


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    return rows(_ff(ACTIVATIONS[act](x @ p["w_in"])) @ p["w_out"])


def moe_init(generator, d_model: int, d_expert: int, n_routed: int,
             n_shared: int, *, dtype=torch.float32, device=None) -> Params:
    """Router (float32), the E experts' stacked gated-MLP weights and, with
    ``n_shared``, one shared gated MLP of width ``d_expert * n_shared``.
    Each expert leaf is drawn one expert at a time, so the float32 draw
    never exceeds one expert's matrix."""
    def experts(d_in, d_out):
        w = torch.empty((n_routed, d_in, d_out), dtype=dtype,
                        device=init_device(generator, device))
        if w.device.type == "meta":
            return w
        for e in range(n_routed):
            w[e] = normal(generator, (d_in, d_out), scale=d_in ** -0.5,
                          dtype=dtype, device=w.device)
        return w

    p: Params = {
        "router": dense_init(generator, d_model, n_routed,
                             dtype=torch.float32, device=device)["w"],
        "experts": {"w_gate": experts(d_model, d_expert),
                    "w_in": experts(d_model, d_expert),
                    "w_out": experts(d_expert, d_model)},
    }
    if n_shared > 0:
        p["shared"] = gated_mlp_init(generator, d_model,
                                     d_expert * n_shared, dtype=dtype,
                                     device=device)
    return p


def _whole(idx: torch.Tensor) -> torch.Tensor:
    """Routing indices whole on every rank: a sharded ``DTensor``
    redistributed to ``Replicate`` (an all-gather of N * k integers) and
    taken as the plain tensor every rank then holds; anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(idx, DTensor):
        return idx
    return idx.redistribute(idx.device_mesh,
                            [Replicate()] * idx.device_mesh.ndim).to_local()


def _block(t: torch.Tensor, shape=None, placements=None) -> tuple:
    """(first, stop) of dim 0 of this rank's block of a ``DTensor`` (or
    of ``shape`` on ``placements``), which must shard dim 0 only."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(t.shape) if shape is None else shape
    placements = t.placements if placements is None else placements
    if any(p.is_partial() or (p.is_shard() and not p.is_shard(0))
           for p in placements):
        raise ValueError(f"the MoE dispatch on local blocks takes a tensor "
                         f"sharded on dim 0 only, not {placements}")
    local, off = compute_local_shape_and_global_offset(
        shape, t.device_mesh, placements)
    return off[0], off[0] + local[0]


def _dispatch_local(tokens, tok_idx, keep_t, safe_e, safe_r, E, C):
    """-> (vals, buf): the dispatched tokens (N * k, d) on the batch axes
    and the (E, C, d) buffer on the "tp" role's placements, built on
    local blocks. Each rank gathers its own tokens' assignments and
    scatters them into the slots of its own experts; the buffer is
    partial over the axes that shard the tokens (a slot holds one
    assignment, the other ranks' zeros) and its constraint sums it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.distributed.sharding import to_placements
    mesh = tokens.device_mesh
    d = tokens.shape[-1]
    k = tok_idx.shape[0] // tokens.shape[0]
    lo, hi = _block(tokens)
    v = tokens.to_local()[tok_idx[lo * k:hi * k] - lo] * \
        keep_t[lo * k:hi * k]
    vals = constrain(DTensor.from_local(v, mesh, tokens.placements,
                                        run_check=False), "dp", None)
    lo, hi = _block(vals)
    target = to_placements(constrain_spec((E, C, d), "tp", None, None),
                           mesh)
    e0, e1 = _block(vals, (E, C, d), target)
    pl = []
    for mine, want in zip(vals.placements, target):
        if mine.is_shard() and want.is_shard():
            raise ValueError(f"a mesh dim shards both the tokens and the "
                             f"experts: {vals.placements}, {target}")
        pl.append(want if want.is_shard() else
                  (Partial() if mine.is_shard() else Replicate()))
    e, r = safe_e[lo:hi], safe_r[lo:hi]
    here = ((e >= e0) & (e < e1))[:, None]
    # a rank reads back the gradient of its own experts' slots only: the
    # tokens' gradient is partial over the axes that shard the experts
    v = vals.to_local(grad_placements=[
        Partial() if want.is_shard() else mine
        for mine, want in zip(vals.placements, target)])
    local = v.new_zeros((e1 - e0, C, d)).index_put_(
        ((e - e0).clamp(0, e1 - e0 - 1), r), torch.where(here, v, 0),
        accumulate=True)
    return vals, DTensor.from_local(local, mesh, pl, run_check=False)


def _combine_local(y, safe_e, safe_r, like):
    """``y[safe_e, safe_r]`` for the assignments of ``like``'s rows (the
    dispatched tokens' layout), on local blocks: each rank picks the
    outputs of its own experts, zeros for the others', partial over the
    axes that shard the experts."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    lo, hi = _block(like)
    e0, e1 = _block(y)
    pl = []
    for rows, experts in zip(like.placements, y.placements):
        if rows.is_shard() and experts.is_shard():
            raise ValueError(f"a mesh dim shards both the tokens and the "
                             f"experts: {like.placements}, {y.placements}")
        pl.append(rows if rows.is_shard() else
                  (Partial() if experts.is_shard() else Replicate()))
    e, r = safe_e[lo:hi], safe_r[lo:hi]
    here = ((e >= e0) & (e < e1))[:, None]
    # and the gradient of its experts' outputs from its own rows only:
    # partial over the axes that shard the tokens
    yl = y.to_local(grad_placements=[
        Partial() if rows.is_shard() else experts
        for rows, experts in zip(like.placements, y.placements)])
    got = torch.where(here, yl[(e - e0).clamp(0, e1 - e0 - 1), r], 0)
    return DTensor.from_local(got, y.device_mesh, pl, run_check=False)


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25,
              router_noise: torch.Tensor | None = None) -> tuple:
    """x: (B, T, d) -> (out (B, T, d), aux dict with load-balance/z losses
    and the dropped share)."""
    B, T, d = x.shape
    E = p["router"].shape[-1]
    tokens = x.reshape(-1, d)
    N = tokens.shape[0]

    logits = tokens.float() @ p["router"]                # (N, E)
    if router_noise is not None:
        logits = logits + router_noise
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: ties go to the lower expert index (torch.topk
    # breaks them in no stated order)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]    # (N, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = _whole(top_i.reshape(-1))                   # (N*k,)
    flat_w = top_p.reshape(-1)
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(top_k)

    C = max(1, math.ceil(N * top_k / E * capacity_factor))
    C = min(C, N)  # no point exceeding token count

    # rank of each (token, expert) assignment within its expert
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=E)         # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(N * top_k, device=x.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted).index_put_((sort_idx,),
                                                     rank_sorted)
    keep = rank < C

    safe_e = torch.where(keep, flat_e, 0)
    safe_r = torch.where(keep, rank, 0)
    keep_t = keep[:, None].to(tokens.dtype)
    if is_dtensor(tokens):
        vals, buf = _dispatch_local(constrain(tokens, "dp", None), tok_idx,
                                    keep_t, safe_e, safe_r, E, C)
    else:
        vals = tokens[tok_idx] * keep_t
        buf = vals.new_zeros((E, C, d))
        buf.index_put_((safe_e, safe_r), vals, accumulate=True)
    # expert-major layout: one explicit reshard here
    buf = constrain(buf, "tp", None, None)

    a = ACTIVATIONS[act]
    ex = p["experts"]
    h = (a(torch.einsum("ecd,edf->ecf", buf, ex["w_gate"]))
         * torch.einsum("ecd,edf->ecf", buf, ex["w_in"]))
    y = constrain(torch.einsum("ecf,efd->ecd", h, ex["w_out"]),
                  "tp", None, None)                       # (E, C, d)

    picked = (_combine_local(y, safe_e, safe_r, vals) if is_dtensor(y)
              else y[safe_e, safe_r])
    out_flat = constrain(picked, "dp", None) * \
        (keep.to(y.dtype) * flat_w.to(y.dtype))[:, None]
    out = out_flat.reshape(N, top_k, d).sum(dim=1)

    if "shared" in p:
        out = out + gated_mlp(p["shared"], tokens, act)

    # aux losses: Switch load-balance + router z-loss
    me = probs.mean(dim=0)                               # (E,)
    ce = torch.bincount(flat_e, weights=keep.float(),
                        minlength=E) / max(N * top_k, 1)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - keep.float().mean()
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "drop_frac": dropped}
    return out.reshape(B, T, d), aux
