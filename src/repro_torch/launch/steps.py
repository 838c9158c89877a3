"""Step functions of the LM (counterpart of ``repro/launch/steps.py``):
the loss, the train step (gradient accumulation and the optimizer), the
prefill step and the serve (decode) step, the units the training and
serving drivers call.

``make_train_step``'s gradients come from ``torch.autograd.grad`` over
the parameter leaves and accumulate in float32 whatever the parameters'
dtype, microbatch by microbatch as the reference's ``lax.scan``. The
optimizer then updates IN PLACE (``Optimizer.update_``): the step writes
the new parameters and moments into the trees it was given, the
counterpart of the reference's donated buffers.

Under a mesh (``act_sharding.use_mesh`` with a ``DeviceMesh``) the same
steps run on ``DTensor`` parameters, optimizer state, inputs and caches
(``distributed/sharding.py``'s rules): each microbatch is constrained to
the batch axes as the reference's, and the tensors the model builds
itself (positions, masks, zero scalars) count as replicated
(``implicit_replication``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_sharding import (constrain, current_mesh,
                                                  is_dtensor)
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
            micro = {k: _microbatches(v, n) for k, v in batch.items()}
            sharded = is_dtensor(leaves[0])
            grads = None if sharded else [
                torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            zero = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            l, metrics = zero, {k: zero for k in AUX_METRICS}
            for i in range(n):
                mb = {k: v[i] for k, v in micro.items()}
                l_i, m_i, g_i = value_and_grad(leaves, params, mb)
                with torch.no_grad():
                    if grads is None:
                        # DTensor gradients stay partial over the batch
                        # axes until AdamW takes them: one reduction a
                        # step, not one a microbatch
                        grads = [g.to(torch.float32) for g in g_i]
                    elif sharded:
                        grads = [acc + g for acc, g in zip(grads, g_i)]
                    else:
                        for acc, g in zip(grads, g_i):
                            acc.add_(g)   # acc + g.astype(float32)
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

    return _on_mesh(train_step)


def make_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    def prefill_step(params, inputs):
        return lm.prefill(params, cfg, inputs, max_len)
    return _on_mesh(prefill_step)


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, token, pos):
        """One decode step: write KV at ``pos`` (in place), return logits
        and the cache."""
        return lm.decode_step(params, cfg, cache, token, pos)
    return _on_mesh(serve_step)


def _microbatches(v: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B / n, ...): microbatch i is rows [i * B / n,
    (i + 1) * B / n), each constrained to the batch axes. A ``DTensor``
    batch sharded on its rows moves to the microbatches' blocks in
    all-to-alls (``_route_rows``): a rank's block of the batch is not a
    microbatch's block. Where the rule shards a microbatch's rows over
    fewer axes than the batch's (B / n does not divide them), the batch
    is gathered whole first (an all-gather of the inputs)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed.act_sharding import constrain_spec
    from repro_torch.distributed.sharding import to_placements
    roles = (None, "dp") + (None,) * (v.dim() - 1)
    shape = (n, v.shape[0] // n) + tuple(v.shape[1:])
    if isinstance(v, DTensor):
        mesh = v.device_mesh
        target = to_placements(constrain_spec(shape, *roles), mesh)
        dims = [i for i, p in enumerate(v.placements) if p.is_shard(0)]
        if all(p.is_replicate() or p.is_shard(0) for p in v.placements) \
                and dims == [i for i, p in enumerate(target)
                             if p.is_shard(1)]:
            return DTensor.from_local(_route_rows(v.to_local(), n, mesh,
                                                  dims), mesh, target,
                                      run_check=False)
        v = v.redistribute(mesh, [Replicate()] * mesh.ndim)
    return constrain(v.reshape(shape), *roles)


def _route_rows(local: torch.Tensor, n: int, mesh, dims) -> torch.Tensor:
    """This rank's block of the batch's rows (sharded over the mesh dims
    ``dims``, the first major) -> its block of each of the ``n``
    microbatches, (n, c, ...). The batch is D * n pieces of c rows (D the
    ranks over ``dims``): rank r holds pieces [r * n, (r + 1) * n), and
    piece p belongs to rank p % D (microbatch p // D). The pieces move in
    one all-to-all a mesh dim, minor first, each to its owner's
    coordinate on that dim; which pieces a rank holds and receives
    follows from the indices alone."""
    import torch.distributed._functional_collectives as funcol
    sizes = [mesh.size(d) for d in dims]
    D = math.prod(sizes)
    c = local.shape[0] // n
    rest = tuple(local.shape[1:])

    def coords(flat):
        out = []
        for size in reversed(sizes):
            out.append(flat % size)
            flat //= size
        return out[::-1]
    src = [coords(p // n) for p in range(D * n)]
    dst = [coords(p % D) for p in range(D * n)]
    me = [mesh.get_local_rank(d) for d in dims]
    held = list(src)                          # each piece's holder
    first = _flat(me, sizes) * n
    mine = list(range(first, first + n))      # the pieces held here
    x = local.reshape((n * c,) + rest)
    for k in reversed(range(len(dims))):
        send = sorted(mine, key=lambda p: (dst[p][k], p))
        rows = torch.tensor([mine.index(p) for p in send],
                            device=local.device)
        x = x.reshape((len(mine), c) + rest)[rows].reshape((-1,) + rest)
        in_splits = [c * sum(1 for p in mine if dst[p][k] == s)
                     for s in range(sizes[k])]
        got = []
        for s in range(sizes[k]):
            frm = me[:k] + [s] + me[k + 1:]
            got.append(sorted(p for p in range(D * n) if held[p] == frm
                              and dst[p][k] == me[k]))
        for p in range(D * n):
            held[p] = held[p][:k] + [dst[p][k]] + held[p][k + 1:]
        x = funcol.wait_tensor(funcol.all_to_all_single(
            x.contiguous(), [c * len(g) for g in got], in_splits,
            mesh.get_group(dims[k])))
        mine = [p for g in got for p in g]
    rows = torch.tensor([mine.index(p) for p in sorted(mine)],
                        device=local.device)
    return x.reshape((n, c) + rest)[rows]


def _flat(coord, sizes) -> int:
    flat = 0
    for i, size in zip(coord, sizes):
        flat = flat * size + i
    return flat


def _on_mesh(step: Callable) -> Callable:
    """``step`` run with plain tensors taken as replicated when a
    ``DeviceMesh`` is installed (the model's own tables, masks and
    scalars beside the ``DTensor`` parameters); as it is otherwise."""
    def run(*args):
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(current_mesh(), DeviceMesh):
            return step(*args)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return step(*args)
    return run
