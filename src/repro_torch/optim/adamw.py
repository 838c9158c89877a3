"""AdamW with global-norm clipping and schedules, written out
(counterpart of ``repro/optim/adamw.py``).

Not ``torch.optim.AdamW``: the reference orders the update as
``(m / c1) / (sqrt(v / c2) + eps)`` and clips by
``min(1, max_norm / max(norm, 1e-9))`` over the whole parameter tree, and
torch's optimizer orders both differently, which would drift the parity
tests. Parameters are plain pytrees (nested dicts of tensors). ``lr`` is
a float or a schedule (``cosine_schedule``, ``constant_schedule``): a
function of the step, evaluated at ``step + 1`` on the host as a 0-d
float32 tensor, which the metrics return.

Two forms of one update, bitwise equal:

- ``update(grads, state, params) -> (params, state, metrics)`` is
  functional: new parameter and moment trees (the RL fits use it);
- ``update_(grads, state, params)`` writes the new parameters and moments
  into ``params``, ``state.mu`` and ``state.nu`` and uses ``grads`` as
  scratch, the counterpart of the reference's donated buffers
  (``donate_argnums=(0, 1)`` in ``repro/launch/train.py``). The clip
  scale is folded into the update and each leaf is updated in slices of
  its leading axis, so the only temporaries are a slice's: at qwen3-4b
  the functional form would hold a second set of parameters, moments and
  clipped gradients (~56 GB) beside the first.

On ``DTensor`` leaves (the sharded train step, ``launch/steps.py``)
``update_`` runs on each rank's local blocks: a gradient is first
redistributed to its parameter's placements (a partial one is summed),
the global norm sums every block's squares once (a replicated block's
divided by its number of replicas, then one all-reduce over the mesh),
and where ``opt_state_specs`` shards a moment wider than its parameter
the update is computed on the moment's block and the parameter's block
gathered from it. Each element goes through the same ops as on one card.

``per_agent=True`` is the stacked form of a ``vmap`` over independent
fits (``influence.train_aip_batched``): every leaf carries a leading
agent axis, and each agent's gradient is clipped by that agent's own
norm.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed.act_sharding import is_dtensor
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32 on the host, as the reference's
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    update_: Callable = None     # in place (``adamw``: not per_agent)


# elements of one in-place update slice: 64 Mi float32, 256 MiB a temporary
SLICE_ELEMENTS = 1 << 26


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; float32, in the reference's
    order of operations."""
    def lr(step):
        s = _step_f32(step)
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: torch.tensor(lr_val, dtype=torch.float32)


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


def _sharded_norm(leaves) -> torch.Tensor:
    """The global norm of DTensor leaves (with no partial placement):
    each rank's squares once, a replicated block's over its replicas,
    summed over the mesh."""
    import torch.distributed._functional_collectives as funcol
    total = 0
    mesh = None
    for x in leaves:
        if not is_dtensor(x):
            raise TypeError("update_ takes a tree of DTensors or of plain "
                            "tensors, not both")
        mesh = x.device_mesh
        reps = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                         if p.is_replicate())
        total = total + torch.square(x.to_local().to(torch.float32)).sum() \
            / reps
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            total = funcol.wait_tensor(
                funcol.all_reduce(total, "sum", mesh.get_group(i)))
    return torch.sqrt(total)


def _sub_gathered(p, u_blk: torch.Tensor, wide) -> None:
    """``p -= u`` in place for a DTensor parameter ``p`` whose update
    ``u_blk`` was computed on the block of the wider placements of the
    moment ``wide``: the update is gathered to ``p``'s placements."""
    from torch.distributed.tensor import DTensor
    u = DTensor.from_local(u_blk, wide.device_mesh, wide.placements,
                           run_check=False, shape=wide.shape,
                           stride=wide.stride())
    u = u.redistribute(p.device_mesh, p.placements).to_local()
    loc = p.to_local()
    if loc.dtype == torch.float32:
        loc.sub_(u)
    else:
        loc.copy_(loc.to(torch.float32).sub_(u))


def _slices(x: torch.Tensor):
    """Views of ``x`` along its leading axis, each of at most
    ``SLICE_ELEMENTS`` elements (whole rows): in-place ops on them write
    into ``x``."""
    if x.dim() == 0 or x.numel() <= SLICE_ELEMENTS:
        return (x,)
    rows = max(1, SLICE_ELEMENTS // max(x[0].numel(), 1))
    return torch.split(x, rows)


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0, per_agent: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def corrections(step: int):
        """(lr, c1, c2) at ``step``: float32 0-d tensors on the host."""
        # bias corrections in f32, as the reference computes them
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), step)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), step)
        return lr_fn(torch.tensor(step, dtype=torch.int32)), c1, c2

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
        lr_t, c1, c2 = corrections(step)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g32 = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g32
            v2 = b2 * v + (1 - b2) * g32 * g32
            u = (m2 / c1.to(g.device)) / (
                torch.sqrt(v2 / c2.to(g.device)) + eps)
            u = u + weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr_t.to(g.device) * u)
                         .to(p.dtype))
            new_m.append(m2)
            new_v.append(v2)
        return (tree_unflatten(params, new_p),
                AdamWState(step=torch.tensor(step, dtype=torch.int32),
                           mu=tree_unflatten(params, new_m),
                           nu=tree_unflatten(params, new_v)),
                {"grad_norm": gnorm, "lr": lr_t})

    @torch.no_grad()
    def update_(grads, state: AdamWState, params):
        """``update`` in place: the new parameters and moments are written
        into ``params``, ``state.mu`` and ``state.nu`` (``grads`` is
        overwritten) -> (params, state with the new step, metrics)."""
        if per_agent:
            raise ValueError("update_ clips by one global norm; the "
                             "per-agent fits take the functional update")
        sharded = is_dtensor(tree_leaves(params)[0])
        if sharded:
            grads = tree_map(
                lambda g, p: g if tuple(g.placements) == tuple(p.placements)
                else g.redistribute(p.device_mesh, p.placements),
                grads, params)
            gnorm = _sharded_norm(tree_leaves(grads))
        else:
            gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = int(state.step) + 1
        lr_t, c1, c2 = corrections(step)
        dev = {}
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            if g.device not in dev:
                dev[g.device] = [x.to(g.device) for x in (lr_t, c1, c2)]
            lr_d, c1_d, c2_d = dev[g.device]
            wide = None              # a moment sharded wider than p
            p_param = p
            if sharded:
                if tuple(m.placements) != tuple(p.placements):
                    wide = m
                    g = g.redistribute(m.device_mesh, m.placements)
                    p_blk = p.redistribute(m.device_mesh, m.placements)
                    u_blk = torch.empty_like(m.to_local())
                g, m, v = (x.to_local() for x in (g, m, v))
                p = p_blk.to_local() if wide is not None else p.to_local()
            outs = _slices(u_blk) if wide is not None else _slices(p)
            for gs, ms, vs, ps, os_ in zip(_slices(g), _slices(m),
                                           _slices(v), _slices(p), outs):
                # each line is one op of ``update``'s, in its order
                if gs.dtype == torch.float32:
                    g32 = gs.mul_(scale)
                else:
                    g32 = (gs.to(torch.float32) * scale).to(gs.dtype) \
                        .to(torch.float32)
                ms.mul_(b1).add_((1 - b1) * g32)
                vs.mul_(b2).add_(((1 - b2) * g32).mul_(g32))
                u = (ms / c1_d).div_(torch.sqrt_(vs / c2_d).add_(eps))
                u.add_(weight_decay * ps.to(torch.float32))
                u.mul_(lr_d)
                if wide is not None:
                    os_.copy_(u)
                elif ps.dtype == torch.float32:
                    ps.sub_(u)
                else:
                    ps.copy_(ps.to(torch.float32).sub_(u))
            if wide is not None:
                _sub_gathered(p_param, u_blk, wide)
        return (params, AdamWState(step=torch.tensor(step, dtype=torch.int32),
                                   mu=state.mu, nu=state.nu),
                {"grad_norm": gnorm, "lr": lr_t})

    return Optimizer(init=init, update=update, update_=update_)
