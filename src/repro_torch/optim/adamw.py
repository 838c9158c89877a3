"""AdamW with global-norm clipping, written out (counterpart of
``repro/optim/adamw.py``).

Not ``torch.optim.AdamW``: the reference orders the update as
``(m / c1) / (sqrt(v / c2) + eps)`` and clips by
``min(1, max_norm / max(norm, 1e-9))`` over the whole parameter tree, and
torch's optimizer orders both differently, which would drift the parity
tests. Parameters are plain pytrees (nested dicts of tensors) and the
update is functional: ``update(grads, state, params) -> (params, state,
metrics)``.

``per_agent=True`` is the stacked form of a ``vmap`` over independent
fits (``influence.train_aip_batched``): every leaf carries a leading
agent axis, and each agent's gradient is clipped by that agent's own
norm.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32 on the host, as the reference's
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree, *, per_agent: bool = False) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, summed leaf by leaf in
    tree order; ``per_agent`` keeps the leading axis -> (A,)."""
    total = 0
    for x in tree_leaves(tree):
        sq = torch.square(x.to(torch.float32))
        total = total + (sq.reshape(sq.shape[0], -1).sum(1) if per_agent
                         else sq.sum())
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, *, per_agent: bool = False):
    norm = global_norm(tree, per_agent=per_agent)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(x):
        s = (scale.reshape((-1,) + (1,) * (x.dim() - 1)) if per_agent
             else scale)
        return (x.to(torch.float32) * s).to(x.dtype)

    return tree_map(clip, tree), norm


def adamw(lr: float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0, per_agent: bool = False) -> Optimizer:

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                           per_agent=per_agent)
        step = int(state.step) + 1
        # bias corrections in f32, as the reference computes them
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), step)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), step)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g32 = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g32
            v2 = b2 * v + (1 - b2) * g32 * g32
            u = (m2 / c1.to(g.device)) / (
                torch.sqrt(v2 / c2.to(g.device)) + eps)
            u = u + weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * u).to(p.dtype))
            new_m.append(m2)
            new_v.append(v2)
        return (tree_unflatten(params, new_p),
                AdamWState(step=torch.tensor(step, dtype=torch.int32),
                           mu=tree_unflatten(params, new_m),
                           nu=tree_unflatten(params, new_v)),
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init=init, update=update)
