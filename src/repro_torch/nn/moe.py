"""Mixture-of-Experts: top-k routing with capacity-based sort/scatter
dispatch (counterpart of ``repro/nn/moe.py``).

The GShard/Switch capacity formulation, as the reference writes it:
tokens are ranked within their expert by a stable argsort, scattered into
a dense (E, C, d) buffer, processed with a batched einsum over the expert
axis, and combined back with the router weights. An assignment ranked at
or past the capacity C is dropped; which ones drop follows the stable
order of the flattened (token, k) assignments, so the sort must be
stable. No data-dependent shapes.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

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


def gated_mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    a = ACTIVATIONS[act]
    return (a(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


def mlp_init(generator, d_model: int, d_ff: int, *, dtype=torch.float32,
             device=None) -> Params:
    return {
        "w_in": dense_init(generator, d_model, d_ff, dtype=dtype,
                           device=device)["w"],
        "w_out": dense_init(generator, d_ff, d_model, dtype=dtype,
                            device=device)["w"],
    }


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    return ACTIVATIONS[act](x @ p["w_in"]) @ p["w_out"]


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

    flat_e = top_i.reshape(-1)                           # (N*k,)
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
    vals = tokens[tok_idx] * keep[:, None].to(tokens.dtype)
    buf = torch.zeros((E, C, d), dtype=tokens.dtype, device=x.device)
    buf.index_put_((safe_e, safe_r), vals, accumulate=True)

    a = ACTIVATIONS[act]
    ex = p["experts"]
    h = (a(torch.einsum("ecd,edf->ecf", buf, ex["w_gate"]))
         * torch.einsum("ecd,edf->ecf", buf, ex["w_in"]))
    y = torch.einsum("ecf,efd->ecd", h, ex["w_out"])     # (E, C, d)

    out_flat = y[safe_e, safe_r] * \
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
