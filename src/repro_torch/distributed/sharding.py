"""Lane data parallelism of the IALS engine and PPO (the IALS half of
``repro/distributed/sharding.py``, over ``torch.distributed``).

The rules are the reference's, pure functions of shapes and of the mesh's
axis names and sizes. The engine's state leaves are (B, ...) single-agent
or (B, A, ...) multi-agent, rollout-state leaves follow the same layout,
and streamed leaves prepend a horizon axis ((T, B, [A,] ...)):

- env lanes (B) shard over the data-parallel axes ("pod", "data"), plus
  "model" when the agent axis leaves it idle;
- the agent axis (A) and the stacked per-agent AIP weights (leading
  (A, ...) leaves) co-shard over "model" when A divides it;
- PPO policy and optimizer parameters replicate.

Every rule degrades to replication when a dim does not divide its axis.

A spec is a tuple with one entry per dimension (an axis name, a tuple of
names, or ``None``), trailing ``None``s trimmed: ``tuple(P(...))`` of the
reference's ``PartitionSpec``. A mesh is a ``DeviceMesh``
(``launch/mesh.py::make_host_mesh``) or any object with ``.axis_names`` /
``.mesh_dim_names`` and ``.shape`` (a dict, or a tuple in the names'
order). The rules read nothing else.

The eager counterparts of the reference's ``device_put`` /
``with_sharding_constraint``, for a ``DeviceMesh`` over the whole
process group (one rank a mesh position):

- ``shard_ials_state`` / ``shard_ials_stream`` take a *global* tree and
  return this rank's block of every leaf;
- ``gather_ials_state`` / ``gather_ials_stream`` are their inverse, an
  ``all_gather`` over the world that rebuilds the global tree;
- ``constrain_ials_state`` checks that local blocks match the rule (eager
  PyTorch has no layout to constrain); a no-op on a size-1 mesh.

A ``LayoutRank`` is one rank of a layout with no process group (the
pods' ``launch/mesh.py::MeshLayout``): every function here runs on it as
on a ``DeviceMesh``, its all-gather handing back the rank's own block for
every rank's. ``launch/dryrun.py`` counts a rank's program on it. Each
all-gather is noted into an active op count
(``op_analysis.note_collective``).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.distributed import op_analysis
from repro_torch.tree import tree_map

IALS_LANE_AXES = ("pod", "data")
IALS_AGENT_AXIS = "model"


class _View(NamedTuple):
    axis_names: tuple
    shape: dict


def _view(mesh) -> _View:
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    names = tuple(names)
    shape = mesh.shape
    if hasattr(shape, "items"):
        return _View(names, dict(shape))
    return _View(names, dict(zip(names, tuple(shape))))


def axis_size(mesh, name: str) -> int:
    m = _view(mesh)
    return m.shape[name] if name in m.axis_names else 1


def mesh_size(mesh) -> int:
    """Device count of a mesh (only its sizes consulted)."""
    n = 1
    for v in _view(mesh).shape.values():
        n *= v
    return n


def ials_lane_axes(batch: int, n_agents: int, mesh):
    """-> (lane_axes, agent_axis | None): which mesh axes the env-lane dim
    and the agent dim take, with divisibility fallback. The two are
    decided together so lanes can absorb an idle "model" axis."""
    m = _view(mesh)
    agent_ax = None
    if (n_agents > 1 and IALS_AGENT_AXIS in m.axis_names
            and m.shape[IALS_AGENT_AXIS] > 1
            and n_agents % m.shape[IALS_AGENT_AXIS] == 0):
        agent_ax = IALS_AGENT_AXIS
    lane = []
    rem = batch
    cand = IALS_LANE_AXES + (() if agent_ax else (IALS_AGENT_AXIS,))
    for a in cand:
        if a in m.axis_names and m.shape[a] > 1 and rem % m.shape[a] == 0:
            lane.append(a)
            rem //= m.shape[a]
    return tuple(lane), agent_ax


def _lead(axes):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _pspec(specs, ndim) -> tuple:
    """Pad to ndim, then trim trailing Nones (a replicated leaf is ())."""
    specs = list(specs) + [None] * (ndim - len(specs))
    while specs and specs[-1] is None:
        specs.pop()
    return tuple(specs)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def ials_state_pspec(leaf, mesh, n_agents: int) -> tuple:
    """One engine-state / rollout-state leaf -> spec. Dim 0 is the
    env-lane (B) dim; dim 1 is the agent dim when the leaf carries it
    (``shape[1] == n_agents``); everything else replicates."""
    shape = _shape(leaf)
    if len(shape) == 0:
        return ()
    lane, agent_ax = ials_lane_axes(shape[0], n_agents, mesh)
    specs = [_lead(lane)]
    if (n_agents > 1 and len(shape) >= 2 and shape[1] == n_agents
            and agent_ax is not None):
        specs.append(agent_ax)
    return _pspec(specs, len(shape))


def ials_state_specs(state, mesh, n_agents: int = 1):
    """The spec of every leaf of an engine ``IALSState`` (or a PPO
    ``RolloutState``), in the tree's structure (read the leaves back with
    ``spec_leaves``)."""
    return tree_map(lambda l: ials_state_pspec(l, mesh, n_agents), state)


def ials_stream_pspec(leaf, mesh, batch: int, n_agents: int) -> tuple:
    """A streamed (T, B, [A,] ...) leaf: time replicated, then the state
    rule shifted one dim right."""
    shape = _shape(leaf)
    if len(shape) <= 1:
        return ()
    lane, agent_ax = ials_lane_axes(batch, n_agents, mesh)
    specs = [None, _lead(lane) if shape[1] == batch else None]
    if (n_agents > 1 and len(shape) >= 3 and shape[2] == n_agents
            and agent_ax is not None and shape[1] == batch):
        specs.append(agent_ax)
    return _pspec(specs, len(shape))


def ials_stream_specs(tree, mesh, batch: int, n_agents: int = 1):
    return tree_map(lambda l: ials_stream_pspec(l, mesh, batch, n_agents),
                    tree)


def ials_aip_param_pspec(leaf, mesh, n_agents: int = 1,
                         batch: int = 0) -> tuple:
    """A stacked (A, ...) AIP leaf puts A on the axis the state's agent
    dim took (replicated when A does not divide); single-agent AIPs
    replicate."""
    _, agent_ax = ials_lane_axes(batch or 1, n_agents, mesh)
    shape = _shape(leaf)
    if (n_agents > 1 and len(shape) >= 1 and shape[0] == n_agents
            and agent_ax is not None):
        return _pspec([agent_ax], len(shape))
    return ()


def ials_aip_param_specs(params, mesh, n_agents: int = 1, batch: int = 0):
    return tree_map(
        lambda l: ials_aip_param_pspec(l, mesh, n_agents, batch), params)


def ials_replicated_specs(params):
    """PPO policy / optimizer params: replicated everywhere (pure DP)."""
    return tree_map(lambda _: (), params)


def spec_leaves(specs, like) -> list:
    """The specs of a ``*_specs`` tree in ``tree_leaves(like)`` order."""
    out = []
    tree_map(lambda _, s: out.append(s), like, specs)
    return out


# ---------------------------------------------------------------------------
# this rank's blocks
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class LayoutRank:
    """Rank ``rank`` of a layout of ``.axis_names`` and ``.shape``, with
    no process group: what this module reads of a ``DeviceMesh`` (its
    ``mesh``, the ranks laid out row-major, and ``get_coordinate()``), and
    an ``all_gather`` of its own that hands back this rank's block for
    every rank's (every block has its shape and dtype: what a count of the
    rank's program reads)."""

    def __init__(self, layout, rank: int = 0):
        view = _view(layout)
        self.axis_names = view.axis_names
        self.shape = tuple(view.shape[a] for a in view.axis_names)
        self.mesh = torch.arange(mesh_size(layout)).reshape(self.shape)
        coord = _rank_coordinates(self)[rank]
        self._coordinate = [coord[a] for a in self.axis_names]

    def get_coordinate(self) -> list:
        return self._coordinate

    def all_gather(self, blocks: list, tensor: torch.Tensor):
        blocks[:] = [tensor] * len(blocks)


def _all_gather(mesh):
    """``mesh``'s all-gather, ``fn(blocks, tensor)``: its own where it has
    one (a ``LayoutRank``), else ``dist.all_gather`` over the process
    group, which must hold the mesh's ranks."""
    own = getattr(mesh, "all_gather", None)
    if own is not None:
        return own
    if not dist.is_initialized():
        raise RuntimeError("gathering a sharded tree needs an initialised "
                           "process group")
    if dist.get_world_size() != mesh_size(mesh):
        raise ValueError(f"the mesh holds {mesh_size(mesh)} ranks, the "
                         f"process group {dist.get_world_size()}")
    return dist.all_gather


def _rank_coordinates(mesh) -> dict:
    """{rank: {axis name: index}} of a ``DeviceMesh`` (or a duck mesh with
    a ``mesh`` tensor of ranks). Read outside any dispatch mode: a
    ``DeviceMesh`` builds its tensor of ranks with aten ops on every read,
    bookkeeping that is not the program's work."""
    view = _view(mesh)
    with _disable_current_modes():
        grid = mesh.mesh.tolist()
    out = {}
    for idx in itertools.product(*(range(view.shape[a])
                                    for a in view.axis_names)):
        r = grid
        for i in idx:
            r = r[i]
        if r in out:
            raise ValueError(f"rank {r} is in the mesh twice")
        out[r] = dict(zip(view.axis_names, idx))
    return out


def _coordinate(mesh) -> dict:
    """{axis name: index} of this process in a ``DeviceMesh`` (or a duck
    mesh with ``get_coordinate()``)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(_view(mesh).axis_names, coord))


def _block_index(entry, sizes, coord):
    """-> (index of the block, number of blocks) of one spec entry: the
    first axis named is the major one, as in a ``PartitionSpec``."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def local_block(leaf: torch.Tensor, spec: tuple, mesh, coord=None):
    """This rank's block of a global ``leaf`` under ``spec``."""
    sizes = _view(mesh).shape
    coord = coord or _coordinate(mesh)
    out = leaf
    for dim, entry in enumerate(spec):
        idx, n = _block_index(entry, sizes, coord)
        if n == 1:
            continue
        if leaf.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"divide into {n} blocks ({entry})")
        size = leaf.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.contiguous()


def gather_block(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The global leaf of this rank's block ``local`` under ``spec``: one
    ``all_gather`` over the world (every rank's block, replicas
    included), each block written to its place."""
    if not any(_axes(e) for e in spec):
        return local
    gather = _all_gather(mesh)
    sizes = _view(mesh).shape
    src = local.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    blocks = [torch.empty_like(wire) for _ in range(mesh_size(mesh))]
    op_analysis.note_collective("all-gather", wire)
    gather(blocks, wire)
    gshape = list(local.shape)
    for dim, entry in enumerate(spec):
        gshape[dim] *= _block_index(entry, sizes, {a: 0 for a in sizes})[1]
    out = torch.empty(gshape, dtype=wire.dtype, device=local.device)
    coords = _rank_coordinates(mesh)
    for r, blk in enumerate(blocks):
        coord = coords[r]
        idx = []
        for dim, entry in enumerate(spec):
            i, n = _block_index(entry, sizes, coord)
            d = local.shape[dim]
            idx.append(slice(i * d, (i + 1) * d) if n > 1 else slice(None))
        out[tuple(idx)] = blk
    return out.view(torch.bool) if src.dtype == torch.bool else out


def lane_factor(n_agents: int, mesh) -> int:
    """How many lane blocks a fully lane-sharded batch has: the product of
    every lane-candidate axis the agents leave (the sharded engine and
    ``rl_train`` require such a batch; ``require_lane_sharding``)."""
    m = _view(mesh)
    _, agent_ax = ials_lane_axes(1, n_agents, mesh)
    n = 1
    for a in IALS_LANE_AXES + (() if agent_ax else (IALS_AGENT_AXIS,)):
        if a in m.axis_names:
            n *= m.shape[a]
    return n


def require_lane_sharding(batch: int, n_agents: int, mesh):
    """Raise unless ``batch`` lanes shard over every axis the agents leave
    (the reference would replicate them: under ``torch.distributed``
    every rank would then run every lane, which no caller asks for)."""
    k = lane_factor(n_agents, mesh)
    if batch % k:
        raise ValueError(
            f"n_envs={batch} does not divide over the {k} lane blocks of "
            f"the mesh {_view(mesh).shape} (n_agents={n_agents}); pick an "
            f"n_envs that is a multiple of {k}")


def _global_state_shape(shape, mesh, n_agents, batch):
    """The global shape of a rank's block of a ``batch``-lane state leaf."""
    _, agent_ax = ials_lane_axes(batch, n_agents, mesh)
    g = list(shape)
    if g:
        g[0] = batch
    if (agent_ax is not None and len(g) >= 2
            and g[1] * axis_size(mesh, agent_ax) == n_agents):
        g[1] = n_agents
    return tuple(g)


def _global_stream_shape(shape, mesh, n_agents, batch):
    return shape[:1] + _global_state_shape(shape[1:], mesh, n_agents, batch)


class _Leaf(NamedTuple):
    shape: tuple


def shard_ials_state(tree, mesh, n_agents: int = 1):
    """This rank's block of every leaf of a global engine / rollout state
    (the eager twin of ``constrain_ials_state``); the tree as it is on a
    size-1 mesh or ``None``."""
    if mesh is None or mesh_size(mesh) == 1:
        return tree
    coord = _coordinate(mesh)
    return tree_map(lambda l: local_block(
        l, ials_state_pspec(l, mesh, n_agents), mesh, coord), tree)


def shard_ials_stream(tree, mesh, batch: int, n_agents: int = 1):
    """This rank's block of every leaf of a global (T, B, [A,] ...)
    stream."""
    if mesh is None or mesh_size(mesh) == 1:
        return tree
    coord = _coordinate(mesh)
    return tree_map(lambda l: local_block(
        l, ials_stream_pspec(l, mesh, batch, n_agents), mesh, coord), tree)


def gather_ials_state(tree, mesh, n_agents: int, batch: int):
    """The inverse of ``shard_ials_state``: the global tree, on every rank.
    ``batch`` is the global lane count (a block's lanes cannot tell a
    sharded batch from a replicated one)."""
    if mesh is None or mesh_size(mesh) == 1:
        return tree
    return tree_map(lambda l: gather_block(l, ials_state_pspec(
        _Leaf(_global_state_shape(tuple(l.shape), mesh, n_agents, batch)),
        mesh, n_agents), mesh), tree)


def gather_ials_stream(tree, mesh, batch: int, n_agents: int = 1):
    """The inverse of ``shard_ials_stream``."""
    if mesh is None or mesh_size(mesh) == 1:
        return tree
    return tree_map(lambda l: gather_block(l, ials_stream_pspec(
        _Leaf(_global_stream_shape(tuple(l.shape), mesh, n_agents, batch)),
        mesh, batch, n_agents), mesh), tree)


def shard_ials_aip_params(params, mesh, n_agents: int = 1):
    """This rank's agents of stacked (A, ...) AIP weights
    (``ials_aip_param_specs``); single-agent AIPs as they are."""
    if mesh is None or mesh_size(mesh) == 1:
        return params
    coord = _coordinate(mesh)
    return tree_map(lambda l: local_block(
        l, ials_aip_param_pspec(l, mesh, n_agents), mesh, coord), params)


def constrain_ials_state(state, mesh, n_agents: int, batch: int):
    """Check that every leaf of ``state`` is the block the IALS rule gives
    a rank of a ``batch``-lane global state; returns ``state``. A no-op on
    a size-1 mesh or ``None``, as the reference's is."""
    if mesh is None or mesh_size(mesh) == 1:
        return state
    sizes = _view(mesh).shape

    def check(l):
        g = _global_state_shape(tuple(l.shape), mesh, n_agents, batch)
        spec = ials_state_pspec(_Leaf(g), mesh, n_agents)
        want = list(g)
        for dim, entry in enumerate(spec):
            want[dim] //= _block_index(entry, sizes,
                                       {a: 0 for a in sizes})[1]
        if tuple(want) != tuple(l.shape):
            raise ValueError(
                f"a leaf of shape {tuple(l.shape)} is not a rank's block "
                f"of a {batch}-lane state ({g} under {spec}, block "
                f"{tuple(want)})")
        return l

    tree_map(check, state)
    return state


def shard_env(env, mesh, n_agents: int = 1):
    """A ``BatchedEnv`` whose ``reset`` / ``noise_fn`` draw the global
    ``n_envs`` from the generator and keep this rank's lanes, and whose
    ``step`` draws the global noise: the GS under a mesh. Its agents never
    shard (a GS couples them), so a mesh whose "model" axis would take
    the agent axis raises. The env as it is on a size-1 mesh or ``None``."""
    if mesh is None or mesh_size(mesh) == 1:
        return env
    if ials_lane_axes(1, n_agents, mesh)[1] is not None:
        raise ValueError(
            f"shard_env: the mesh {_view(mesh).shape} would shard the "
            f"{n_agents} agents of {env.spec.name}, whose simulator couples "
            f"them; use a mesh with model = 1")
    if env.noise_fn is None or env.step_det is None:
        raise ValueError(f"shard_env: {env.spec.name} has no noise_fn / "
                         f"step_det to draw its global noise from")
    k = lane_factor(n_agents, mesh)

    def reset(gen, n_envs):
        require_lane_sharding(n_envs, n_agents, mesh)
        return shard_ials_state(env.reset(gen, n_envs), mesh, n_agents)

    def noise_fn(gen, n_envs):
        require_lane_sharding(n_envs, n_agents, mesh)
        return shard_ials_state(env.noise_fn(gen, n_envs), mesh, n_agents)

    def step(state, actions, gen):
        return env.step_det(state, actions,
                            noise_fn(gen, actions.shape[0] * k))

    return env._replace(reset=reset, noise_fn=noise_fn, step=step,
                        mesh=mesh)


# ---------------------------------------------------------------------------
# The LM half: every parameter / optimizer / input / cache leaf -> a spec
# (the reference's rules, ``repro/distributed/sharding.py``)
# ---------------------------------------------------------------------------
#
# - tensor parallelism on "model": attention heads, FFN hidden, experts,
#   vocab;
# - FSDP on "data": the d_model-sized dim of each weight;
# - pure DP on "pod": parameters replicated; optimizer moments widen over
#   "pod" (and "data") where divisible (ZeRO-1);
# - batch on ("pod", "data"); a batch-1 long-context cache shards its
#   sequence dim instead.
#
# LM specs keep one entry per dim (``tuple(P(*specs))`` of the
# reference's); a mesh is read through ``_view`` as above.

def _fits(dim: int, mesh, name):
    m = _view(mesh)
    if name is None:
        return None
    if isinstance(name, tuple):   # combined axes (fsdp_only profile)
        n = 1
        for a in name:
            if a not in m.axis_names:
                return None
            n *= m.shape[a]
        if dim % n == 0 and n > 1:
            return name
        return _fits(dim, mesh, name[0])   # the first axis alone
    if name in m.axis_names and dim % m.shape[name] == 0 \
            and m.shape[name] > 1:
        return name
    return None


def dp_axes(mesh, profile: str = "tp") -> tuple:
    """Batch axes: ("pod", "data") (+ "model" in the fsdp_only profile)."""
    names = (("pod", "data", "model") if profile == "fsdp_only"
             else ("pod", "data"))
    return tuple(a for a in names if a in _view(mesh).axis_names)


def batch_spec(mesh, batch: int, extra_dims: int = 1,
               profile: str = "tp") -> tuple:
    """Spec of (B, ...) activations: B over as many dp axes as divide."""
    sizes = _view(mesh).shape
    axes = []
    rem = batch
    for a in dp_axes(mesh, profile):
        if rem % sizes[a] == 0:
            axes.append(a)
            rem //= sizes[a]
    return (_lead(tuple(axes)),) + (None,) * extra_dims


# (matched path key) -> (dim roles), roles "fsdp" | "tp" | None per dim of
# the *unstacked* (per-layer) shape; a stacked leading layer dim gets None
_RULES = {
    # embeddings / heads: vocab on tp; the embed dim NOT fsdp-sharded
    "table": ("tp", None),
    "lm_head.w": ("fsdp", "tp"),
    # attention
    "wq.w": ("fsdp", "tp"), "wk.w": ("fsdp", "tp"), "wv.w": ("fsdp", "tp"),
    "wq.b": ("tp",), "wk.b": ("tp",), "wv.b": ("tp",),
    "wo.w": ("tp", "fsdp"), "wo.b": (None,),
    # MLA
    "wq_a.w": ("fsdp", "tp"), "wq_b.w": ("fsdp", "tp"),
    "wkv_a.w": ("fsdp", None), "wkv_b.w": ("fsdp", "tp"),
    # MLP
    "w_gate": ("fsdp", "tp"), "w_in": ("fsdp", "tp"), "w_out": ("tp", "fsdp"),
    # MoE: experts sharded on E only (pure expert parallelism)
    "experts.w_gate": ("tp", None, None),
    "experts.w_in": ("tp", None, None),
    "experts.w_out": ("tp", None, None),
    "router": (None, None),
    # mamba
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "conv_w": ("tp", None), "conv_b": ("tp",),
    "x_proj": ("tp", None), "dt_w": (None, "tp"),
    "A_log": ("tp", None), "D": ("tp",),
    # mLSTM / sLSTM (bare (NH, DH, DH) block-diagonal projections)
    "up_proj": ("fsdp", "tp"), "down_proj": ("tp", "fsdp"),
    "wq": (None, "tp", None), "wk": (None, "tp", None),
    "wv": (None, "tp", None),
    "w_if.w": ("tp", None), "w_if.b": (None,),
    "r_z": (None, "tp", None), "r_i": (None, "tp", None),
    "r_f": (None, "tp", None), "r_o": (None, "tp", None),
    "ff_up": ("fsdp", "tp"), "ff_down": ("tp", "fsdp"),
    "w_in.w": ("fsdp", "tp"), "w_in.b": ("tp",),
}

_AXIS_FOR_ROLE = {"fsdp": "data", "tp": "model"}
_AXIS_FOR_ROLE_FSDP_ONLY = {"fsdp": ("data", "model"), "tp": None}

# the expert-dim axes of "experts.*" leaves: ("model",), or ("data",
# "model") for 2-D EP (``ArchConfig.moe_expert_axes``)
_EP_AXES = ("model",)


def set_moe_expert_axes(axes: str) -> None:
    global _EP_AXES
    _EP_AXES = ("data", "model") if axes == "data_model" else ("model",)


def _map_with_keys(fn, tree, keys=()):
    """``tree_map`` with each leaf's tuple of keys (dict keys, NamedTuple
    field names, list indices as strings): the reference's tree path."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, tree[k], keys + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_keys(fn, t, keys + (f,))
                            for f, t in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_keys(fn, t, keys + (str(i),))
                          for i, t in enumerate(tree))
    return fn(keys, tree)


def param_pspec(names, leaf, mesh, *, profile: str = "tp") -> tuple:
    """The spec of one parameter leaf from its tree path ``names`` (the
    most specific rule whose dotted parts are all in the path)."""
    names = list(names)
    best = None
    for key, roles in _RULES.items():
        if all(p in names for p in key.split(".")):
            if best is None or len(key) > len(best[0]):
                best = (key, roles)
    shape = _shape(leaf)
    stacked = "blocks" in names       # decoder and encoder stacks
    if best is None:
        roles = (None,) * (len(shape) - (1 if stacked else 0))
    else:
        roles = best[1]
    role_map = dict(_AXIS_FOR_ROLE_FSDP_ONLY if profile == "fsdp_only"
                    else _AXIS_FOR_ROLE)
    if best is not None and best[0].startswith("experts."):
        role_map["tp"] = _EP_AXES if len(_EP_AXES) > 1 else _EP_AXES[0]
    specs = []
    offset = 0
    if stacked:
        specs.append(None)            # the layer-stack dim
        offset = 1
    for i in range(offset, len(shape)):
        ridx = i - offset
        role = roles[ridx] if ridx < len(roles) else None
        ax = role_map.get(role)
        specs.append(_fits(shape[i], mesh, ax) if ax else None)
    return tuple(specs)


def param_specs(params, mesh, profile: str = "tp"):
    """The spec of every leaf of a parameter tree (meta tensors will do)."""
    return _map_with_keys(
        lambda keys, leaf: param_pspec(keys, leaf, mesh, profile=profile),
        params)


def _lookup(tree, keys):
    """The node at ``keys`` (``_map_with_keys``'s path) if it is a spec."""
    node = tree
    for k in keys:
        try:
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                node = getattr(node, k)
            elif isinstance(node, (tuple, list)):
                node = node[int(k)]
            else:
                node = node[k]
        except (KeyError, TypeError, IndexError, ValueError,
                AttributeError):
            return None
    return node if isinstance(node, tuple) else None


def opt_state_specs(opt_state, mesh, pspecs):
    """AdamW's state: ``step`` replicated; the moments shard like their
    parameters, then widen over the axes the parameter leaves unused
    ("pod" always, ZeRO-1 across pods; "data" too), on the first dim
    that divides."""
    m = _view(mesh)

    def mom(tree):
        def widen(keys, leaf):
            base = _lookup(pspecs, keys)
            shape = _shape(leaf)
            if base is None:
                return ()
            parts = list(base) + [None] * (len(shape) - len(base))
            used = {a for cur in parts for a in _axes(cur)}
            for ax in ("pod", "data"):
                if ax not in m.axis_names or ax in used:
                    continue
                for i, (cur, dim) in enumerate(zip(parts, shape)):
                    if cur is None and dim % m.shape[ax] == 0 and dim > 1:
                        parts[i] = ax
                        used.add(ax)
                        break
            return tuple(parts)
        return _map_with_keys(widen, tree)

    return type(opt_state)(step=(), mu=mom(opt_state.mu),
                           nu=mom(opt_state.nu))


def cache_pspec(names, leaf, mesh, batch: int) -> tuple:
    """A KV / state cache leaf: the batch over the dp axes where they
    divide; KV heads over "model" where they divide; the axes left go to
    the sequence dim (a sequence-parallel cache)."""
    m = _view(mesh)
    names = list(names)
    stacked = "blocks" in names
    shape = _shape(leaf)
    specs = [None] * len(shape)
    bdim = 1 if stacked else 0
    used = set()
    axes = []
    rem = shape[bdim]
    for a in dp_axes(mesh):
        if rem % m.shape[a] == 0 and m.shape[a] > 1:
            axes.append(a)
            used.add(a)
            rem //= m.shape[a]
    if axes:
        specs[bdim] = tuple(axes) if len(axes) > 1 else axes[0]
    # kv heads on model where they divide: (..., S, KH, hd)
    if any(k in ("k", "v", "mk", "mv") for k in names) \
            and len(shape) >= bdim + 3 and "model" not in used:
        if _fits(shape[bdim + 2], mesh, "model"):
            specs[bdim + 2] = "model"
            used.add("model")
    if any(k in ("k", "v", "ckv", "krope") for k in names) \
            and len(shape) > bdim + 1:
        seq_axes = []
        rem = shape[bdim + 1]
        for a in ("data", "model"):
            if a in m.axis_names and a not in used \
                    and m.shape[a] > 1 and rem % m.shape[a] == 0:
                seq_axes.append(a)
                used.add(a)
                rem //= m.shape[a]
        if seq_axes:
            specs[bdim + 1] = (tuple(seq_axes) if len(seq_axes) > 1
                               else seq_axes[0])
    return tuple(specs)


def cache_specs(cache, mesh, batch: int):
    return _map_with_keys(
        lambda keys, leaf: cache_pspec(keys, leaf, mesh, batch), cache)


# ---------------------------------------------------------------------------
# specs -> DTensor placements, trees -> DTensors and back
# ---------------------------------------------------------------------------

def to_placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh`` (the counterpart of
    ``to_shardings``): ``Shard(d)`` on each mesh dim the spec names for
    tensor dim d, ``Replicate()`` elsewhere. A dim split over several
    axes is split over them in the mesh's order, the first major, as the
    spec orders them; a spec that orders them otherwise raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = _view(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes}, not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute_tree(tree, specs, mesh):
    """Global tensors -> DTensors on ``mesh``, each leaf cut to this
    rank's block of its spec in ``specs`` (a tree of the same structure;
    every rank holds the global tree, nothing is sent). A block is a copy:
    writing into the DTensor (AdamW's update, a cache) leaves the global
    tensor as it was."""
    from torch.distributed.tensor import DTensor
    coord = _coordinate(mesh)

    def one(keys, leaf):
        spec = _lookup(specs, keys)
        if spec is None:
            raise KeyError(f"no spec for the leaf at {keys}")
        blk = local_block(leaf, spec, mesh, coord)
        if blk.untyped_storage().data_ptr() == \
                leaf.untyped_storage().data_ptr():
            blk = blk.clone()
        return DTensor.from_local(
            blk, mesh,
            to_placements(spec, mesh), run_check=False,
            shape=leaf.shape, stride=leaf.contiguous().stride())
    return _map_with_keys(one, tree)


def undistribute_tree(tree):
    """DTensors -> their global tensors on every rank (``full_tensor``,
    on the local block's device); plain leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda l: l.full_tensor().to(l.to_local().device)
                    if isinstance(l, DTensor) else l, tree)
