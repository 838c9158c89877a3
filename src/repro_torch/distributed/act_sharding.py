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

``mixer`` runs a recurrent mixer (Mamba, mLSTM, sLSTM) tensor-parallel
on "model" on plain local tensors, its weights on the rules' placements;
``batch_local`` runs a function on the batch blocks with its weights
gathered whole.
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
    first) taken back as sharded over those axes; a mesh axis that does
    not split the batch computes the same rows (the parameters'
    gradients are partial over the batch axes only). ``mixer`` runs the
    recurrent mixers so under the ``fsdp_only`` profile (where "model"
    is a batch axis) and where "model" is 1; under "tp" they run on
    "model". Plain tensors: ``fn`` as it is."""
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


# ---------------------------------------------------------------------------
# The recurrent mixers on "model"
# ---------------------------------------------------------------------------
#
# Inside ``mixer`` each rank runs its share of the layer on plain local
# tensors. A tensor every rank of "model" holds alike (the input, q and k,
# the sLSTM's recurrence) takes in the backward only the part of its
# gradient that flows through this rank's share, the ranks' parts summing
# to the gradient; so each collective's backward is its adjoint: an
# all-reduce's an all-reduce, an all-gather's a reduce-scatter.

def _wait(t):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(t)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The ranks' blocks of the last dim, in rank order."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_gather_tensor(x.contiguous(), x.dim() - 1,
                                              group))

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """Partial sums -> this rank's block of the last dim, summed."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum",
                                                  x.dim() - 1, group))

    @staticmethod
    def backward(ctx, grad):
        return _AllGather.apply(grad, ctx.group), None


def _intervals(size: int, parts: int, n: int, r: int) -> list:
    """Rank r's share of each of ``parts`` equal parts of ``size``:
    [(start, stop), ...] in ascending order (``nn/ssm.py::tp_layout``)."""
    P = size // parts
    return [(p * P + r * P // n, p * P + (r + 1) * P // n)
            for p in range(parts)]


def _overlap(a, b) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


class _Take(torch.autograd.Function):
    """This rank's intervals of dim 0 of a tensor sharded evenly on it
    over ``group``, from the ranks that hold them: one all-to-all (each
    element of a block goes to the one rank whose share it is); the
    backward sends the gradient back the same way."""

    @staticmethod
    def forward(ctx, blk, send, send_counts, recv_counts, group):
        import torch.distributed._functional_collectives as funcol
        ctx.send, ctx.counts, ctx.group = send, (send_counts,
                                                 recv_counts), group
        ctx.rows = blk.shape[0]
        buf = torch.cat([blk[a:b] for a, b in send]).contiguous()
        return _wait(funcol.all_to_all_single(buf, recv_counts, send_counts,
                                              group))

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed._functional_collectives as funcol
        send_counts, recv_counts = ctx.counts
        back = _wait(funcol.all_to_all_single(grad.contiguous(), send_counts,
                                              recv_counts, ctx.group))
        out = grad.new_empty((ctx.rows,) + tuple(grad.shape[1:]))
        at = 0
        for a, b in ctx.send:
            out[a:b] = back[at:at + b - a]
            at += b - a
        return out, None, None, None, None


def _share(w, split, mesh, md: int, rows: list):
    """A weight's local tensor for ``mixer``: ``split`` None -> whole (a
    weight the rules shard on "model" gathered there), else ``(dim,
    parts)`` -> this rank's share of each part (``_intervals``; from the
    ranks that hold it if the rules shard ``dim`` on "model", else
    sliced; where they shard another dim there, ``parts`` 1 -> this
    rank's block of ``dim``, moved in one all-to-all: the mLSTM's
    ``wq`` / ``wk`` / ``wv`` held by a head's rows, laid out by whole
    heads or by their output columns). The gradient: this rank's block
    where the weight is sharded
    on "model", else partial over "model" and over the mesh dims ``rows``
    (those that split the batch)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(w, DTensor):
        raise TypeError("mixer: a plain weight under a mesh")
    pl = list(w.placements)
    sharded = pl[md].is_shard()
    if split is None and sharded:
        pl[md] = Replicate()
        w = w.redistribute(mesh, pl)
        sharded = False
    elif sharded and not pl[md].is_shard(split[0]) and split[1] == 1:
        pl[md] = Shard(split[0])
        w = w.redistribute(mesh, pl)
    grad = [p if p.is_shard() else
            (Partial() if i == md or i in rows else Replicate())
            for i, p in enumerate(pl)]
    local = w.to_local(grad_placements=grad)
    if split is None:
        return local
    dim, parts = split
    n, r = mesh.size(md), mesh.get_local_rank(md)
    want = [_intervals(w.shape[dim], parts, n, q) for q in range(n)]
    if not sharded:
        return torch.cat([local.narrow(dim, a, b - a) for a, b in want[r]],
                         dim)
    if not pl[md].is_shard(dim) or w.shape[dim] % n:
        raise ValueError(f"mixer: a weight of shape {tuple(w.shape)} on "
                         f"{pl}, split on dim {dim}")
    blk = w.shape[dim] // n
    held = [(q * blk, (q + 1) * blk) for q in range(n)]
    if all(wq == [hq] for wq, hq in zip(want, held)):
        return local                  # every rank's share is its block
    # the rows of my block each rank takes, ascending (global order)
    send, send_counts = [], []
    for q in range(n):
        mine = [(max(a, held[r][0]) - held[r][0],
                 min(b, held[r][1]) - held[r][0])
                for a, b in want[q] if _overlap((a, b), held[r])]
        send += mine
        send_counts.append(sum(b - a for a, b in mine))
    recv_counts = [sum(_overlap(iv, held[q]) for iv in want[r])
                   for q in range(n)]
    out = _Take.apply(local.movedim(dim, 0), send, send_counts, recv_counts,
                      mesh.get_group(md))
    return out.movedim(0, dim)


def _state_share(t, split, n: int, r: int):
    """A decode state's local tensor (whole on "model", as the cache's
    rule lays it out): this rank's share on ``split``."""
    if split is None:
        return t
    dim, parts = split
    return torch.cat([t.narrow(dim, a, b - a)
                      for a, b in _intervals(t.shape[dim], parts, n, r)],
                     dim)


def _state_whole(t, split, n: int, group):
    """The ranks' shares of a state (``_state_share``) gathered whole."""
    if split is None:
        return t
    dim, parts = split
    t = _AllGather.apply(t.movedim(dim, -1), group)
    s = t.shape[-1] // (n * parts)
    t = t.unflatten(-1, (n, parts, s)).transpose(-3, -2).flatten(-3)
    return t.movedim(-1, dim)


def mixer(fn, layout, x, params, *state, **kw):
    """A recurrent mixer of ``nn/ssm.py`` (``fn``; ``layout(n)`` its
    ``tp_layout`` on n ranks) under the installed mesh.

    Under the "tp" profile, on "model" as the reference's rules lay its
    weights out: each weight is gathered over the FSDP axes only
    (``gather_weights``) and this rank takes its share of the layer's
    channels, heads, value rows or hidden units (``layout``), from the
    ranks whose blocks hold them in one all-to-all where the rules' even
    split cuts the parts otherwise (``in_proj``'s [xi | z], the mLSTM's
    heads or their rows) or sliced where the weight is whole on "model";
    ``fn`` runs on those local tensors and the input's batch block (a
    sequence loop sees no ``DTensor`` op), with the collectives of
    ``nn/ssm.py::Collectives`` where a product contracts over the split
    dim; its output, a partial sum over "model", is all-reduced there
    (the backward: the identity) and a state is gathered whole on
    "model" (the cache's layout, whose share a decode step takes). Whole
    on every rank of "model": the sLSTM's ``r_*`` (gathered once a call)
    and its recurrence, the small vectors the layout names, and, where
    "model" exceeds the mLSTM's heads, its q, k, n, m and gates
    (``docs/TORCH_ARCHITECTURE.md`` §9).

    Under ``fsdp_only`` or with "model" of size 1: ``batch_local``; a
    width of ``layout``'s ``even`` that "model" does not divide raises.
    Plain tensors: ``fn`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.tree import tree_map
    if not isinstance(x, DTensor):
        return fn(params, *state, x, **kw)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    md = names.index("model") if "model" in names else None
    if _PROFILE == "fsdp_only" or md is None or mesh.size(md) == 1:
        return batch_local(fn, x, params, *state, **kw)
    n, r = mesh.size(md), mesh.get_local_rank(md)
    lay = layout(n)
    for e in lay.even:
        if e % n:
            raise ValueError(f"mixer: a width of {e} that the 'model' axis "
                             f"of size {n} does not divide")
    group = mesh.get_group(md)
    pl = [Shard(0) if p.is_shard(0) and i != md else Replicate()
          for i, p in enumerate(x.placements)]
    rows = [i for i, p in enumerate(pl) if p.is_shard(0)]

    def walk(t, path=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in t.items()}
        return _share(t, lay.weights[path], mesh, md, rows)

    def whole_on_model(t):
        return t.redistribute(mesh, pl).to_local()
    local_state = [type(st)(*(_state_share(whole_on_model(t), s, n, r)
                              for t, s in zip(st, lay.state)))
                   for st in state]
    tp = _ssm_collectives(group, n, lay.heads)
    xl = x.redistribute(mesh, pl).to_local(
        grad_placements=[Partial() if i == md else p
                         for i, p in enumerate(pl)])
    res = fn(walk(params), *local_state, xl, tp=tp, **kw)
    out, st = res if isinstance(res, tuple) else (res, None)
    out = DTensor.from_local(_SumOver.apply(out, [group]), mesh, pl,
                             run_check=False)
    if st is None:
        return out
    st = type(st)(*(_state_whole(t, s, n, group)
                    for t, s in zip(st, lay.state)))
    return out, tree_map(lambda t: DTensor.from_local(t, mesh, pl,
                                                      run_check=False), st)


def _ssm_collectives(group, n: int, heads: int = 0):
    from repro_torch.nn.ssm import Collectives
    return Collectives(
        sum=lambda t: _AllReduce.apply(t, group),
        mean=lambda t: _AllReduce.apply(t, group) / n,
        scatter=lambda t: _ReduceScatter.apply(t, group),
        gather=lambda t: _AllGather.apply(t, group), heads=heads)
