"""Step functions of the LM (counterpart of ``repro/launch/steps.py``):
the loss, the train step (gradient accumulation and the optimizer), the
prefill step and the serve (decode) step, the units the training and
serving drivers call.

``make_train_step``'s gradients come from ``torch.autograd.grad`` over
the parameter leaves and accumulate in float32 whatever the parameters'
dtype, microbatch by microbatch as the reference's ``lax.scan``. The
optimizer then updates IN PLACE (``Optimizer.update_``): the step writes
the new parameters and moments into the trees it was given, the
counterpart of the reference's donated buffers. There is no mesh on one
card, so no activation sharding constraint either.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim.adamw import Optimizer
from repro_torch.tree import tree_leaves, tree_unflatten

AUX_METRICS = ("ce", "lb_loss", "z_loss", "drop_frac")


def make_loss_fn(cfg: ArchConfig) -> Callable:
    def loss(params, batch):
        return lm.loss_fn(params, cfg, batch)
    return loss


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    n_microbatches: int = 1) -> Callable:
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, updating ``params`` and the moments of ``opt_state`` in
    place. With ``n_microbatches`` > 1 the batch's rows split into that
    many contiguous microbatches (``(n, B / n, ...)``, as the reference
    reshapes it); gradients and metrics are summed from float32 zeros in
    microbatch order and multiplied by ``1 / n``. Metrics: ``loss``,
    ``ce``, ``lb_loss``, ``z_loss``, ``drop_frac``, ``grad_norm``, ``lr``
    (0-d tensors)."""
    loss = make_loss_fn(cfg)
    n = n_microbatches

    def value_and_grad(leaves, params, batch):
        """-> (loss, metrics, grads): the grads in the leaves' dtypes."""
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            l, metrics = loss(tree_unflatten(params, live), batch)
            grads = list(torch.autograd.grad(
                l, live, allow_unused=True, materialize_grads=True))
        return l.detach(), {k: metrics[k].detach() for k in AUX_METRICS}, \
            grads

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if n == 1:
            l, metrics, grads = value_and_grad(leaves, params, batch)
            for i, g in enumerate(grads):     # one leaf's copy at a time
                grads[i] = g.to(torch.float32)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not split into {n} "
                                 f"microbatches")
            b = B // n
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            zero = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            l, metrics = zero, {k: zero for k in AUX_METRICS}
            for i in range(n):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                l_i, m_i, g_i = value_and_grad(leaves, params, mb)
                with torch.no_grad():
                    for acc, g in zip(grads, g_i):
                        acc.add_(g)       # acc + g.astype(float32)
                del g_i
                l = l + l_i
                metrics = {k: metrics[k] + m_i[k] for k in AUX_METRICS}
            inv = 1.0 / n
            with torch.no_grad():
                for g in grads:
                    g.mul_(inv)
            l = l * inv
            metrics = {k: v * inv for k, v in metrics.items()}
        params, opt_state, om = optimizer.update_(
            tree_unflatten(params, grads), opt_state, params)
        metrics = dict(metrics, loss=l, **om)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    def prefill_step(params, inputs):
        return lm.prefill(params, cfg, inputs, max_len)
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, token, pos):
        """One decode step: write KV at ``pos`` (in place), return logits
        and the cache."""
        return lm.decode_step(params, cfg, cache, token, pos)
    return serve_step
