"""Warehouse-commissioning domain, batched in torch (counterpart of
``repro/envs/warehouse.py``, paper §5.3-5.4).

A grid of R x R robots (paper: 36), each confined to a 5 x 5 region. The
12 item cells of a region sit on its edges and are shared with the
neighbouring region: globally the items live on horizontal shelf
segments ``items_h (B, R+1, R, 3)`` and vertical ones ``items_v (B, R,
R+1, 3)``, each cell holding the age + 1 of its item (0 = empty). Items
appear with probability ``p_item``, age every tick up to ``max_age``, and
are collected when a robot steps onto them. Scripted robots chase the
oldest active item of their region (L1-greedy; of equal ages the first
item cell, as ``jnp.argmax`` takes it); the agents' robots are trained.
An agent sees its 25-cell position one-hot and its region's 12 item bits.

u_t (12 bits): whether a neighbour robot stands on each of the agent's
(shared) item cells after this tick's moves; the LS removes those items.
With ``vanish_after`` k > 0 (§5.4) an item disappears after k ticks, and
an item whose age reached k before the tick counts as taken in u_t.
d-set: the 12 item bits, then 12 bits "the agent was or is on that item
cell".

Global simulator (GS): ``make_batched_multi_warehouse_env``; its
``step_det`` takes the tick's spawn draws (``noise_fn``: ``spawn_h``,
``spawn_v`` bool) as tensors, so tests can hand it the JAX package's
draws. Local simulator (LS): ``make_batched_local_warehouse_env``, one
region per lane; its ``noise_fn`` draws the (B, 12) spawns, and
``rollout_tick`` is the transition + reward core the CUDA kernels carry as
the warehouse device functor (``KernelDomain("warehouse")``). Positions
and ages are int32 leaves, as in the JAX package. Item-cell coordinates
come from the iota rule of ``_at_item_mask_k`` (groups of three per edge:
top, bottom, left, right); at the region side 5 they equal the reference's
``_ITEM_RC`` table.

The scalar protocol (``envs.api.Env`` / ``LocalEnv``, one floor or one
region, no env axis): ``make_multi_warehouse_env``,
``make_warehouse_env`` and ``make_local_warehouse_env`` port the
reference's scalar code, with its spawn draws moved into ``noise_fn``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.envs.api import (BatchedEnv, BatchedLocalEnv, Env,
                                  EnvSpec, KernelDomain, LocalEnv,
                                  agent_placement, squeeze_agent_env)


@dataclass(frozen=True)
class WarehouseConfig:
    grid: int = 6               # R x R robots (6 x 6 = 36)
    region: int = 5
    p_item: float = 0.02
    agent: Tuple[int, int] = (2, 2)
    vanish_after: int = 0       # > 0: §5.4 deterministic disappearance
    max_age: int = 64


class WarehouseState(NamedTuple):
    pos: torch.Tensor       # (B, R, R, 2) int32 robot positions
    items_h: torch.Tensor   # (B, R+1, R, 3) int32 age + 1, 0 = empty
    items_v: torch.Tensor   # (B, R, R+1, 3) int32


class LocalWarehouseState(NamedTuple):
    pos: torch.Tensor       # (B, 2) int32
    items: torch.Tensor     # (B, 12) int32 age + 1, 0 = empty


def item_cells(S: int, device=None):
    """The 12 item cells of a region of side S -> (rows (12,), columns
    (12,)) int64: groups of three per edge (top, bottom, left, right),
    the iota rule of the reference's ``_at_item_mask_k``."""
    idx = torch.arange(12, device=device)
    g, w = idx // 3, idx % 3
    r = torch.where(g == 0, 0, torch.where(g == 1, S - 1, w + 1))
    c = torch.where(g == 2, 0, torch.where(g == 3, S - 1, w + 1))
    return r, c


def _at_items(pos, cells):
    """(..., 2) positions -> (..., 12) bool: the item cells stood on."""
    r, c = cells
    return (r == pos[..., 0:1]) & (c == pos[..., 1:2])


def _move(pos, actions, S: int):
    """Clip(pos + move(action)): 0 stay, 1 up (-row), 2 down, 3 left
    (-column), 4 right; any other action stays."""
    a = actions.to(torch.int64)
    dr = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
    dc = torch.where(a == 3, -1, torch.where(a == 4, 1, 0))
    return torch.clamp(pos + torch.stack([dr, dc], dim=-1), 0,
                       S - 1).to(torch.int32)


def _bitmap(pos, S: int):
    """(..., 2) positions -> (..., S*S) f32 one-hot of the cell."""
    idx = torch.arange(S * S, device=pos.device)
    return ((idx // S == pos[..., 0:1])
            & (idx % S == pos[..., 1:2])).to(torch.float32)


def first_argmax(x):
    """Index of the FIRST maximum along the last axis, whatever the
    backend's habit for ties (the rule of ``jnp.argmax``): ages tie
    often, since items spawn together at age 1."""
    top = x.amax(dim=-1, keepdim=True)
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == top, idx, x.shape[-1]).amin(dim=-1)


def _age_items(items, collected, spawn, cfg: WarehouseConfig):
    """One tick of an item cell: collected items go, the rest age up to
    ``max_age`` (and vanish past ``vanish_after``), empty cells spawn."""
    items = torch.where(collected, 0, items)
    items = torch.where(items > 0, torch.clamp(items + 1, max=cfg.max_age),
                        0)
    if cfg.vanish_after > 0:
        items = torch.where(items > cfg.vanish_after, 0, items)
    return torch.where((items == 0) & spawn, 1, items).to(torch.int32)


def _region_ages_all(items_h, items_v):
    """(B, R+1, R, 3) / (B, R, R+1, 3) shelves -> (B, R, R, 12) ages of
    every region in item-cell order (top, bottom, left, right)."""
    R = items_h.shape[2]
    return torch.cat([items_h[:, :R], items_h[:, 1:], items_v[:, :, :R],
                      items_v[:, :, 1:]], dim=-1)


def local_warehouse_state(state: WarehouseState, i, j) -> LocalWarehouseState:
    """The LS view of region (i, j) of a GS state, scalar or batched (the
    state's leading axes are kept): (..., 2) pos and (..., 12) items;
    index tensors ``i``, ``j`` of shape (A,) give one view per agent."""
    return LocalWarehouseState(
        pos=state.pos[..., i, j, :],
        items=torch.cat([state.items_h[..., i, j, :],
                         state.items_h[..., i + 1, j, :],
                         state.items_v[..., i, j, :],
                         state.items_v[..., i, j + 1, :]], dim=-1))


def _region_items(items_h, items_v, i, j):
    """One floor's shelves -> the ages of region (i, j) in item-cell
    order (index tensors give a leading axis per index)."""
    return torch.cat([items_h[i, j], items_h[i + 1, j], items_v[i, j],
                      items_v[i, j + 1]], dim=-1)


def make_multi_warehouse_env(cfg: WarehouseConfig, agents,
                             device="cuda") -> Env:
    """Scalar GS with a trained robot in every listed region: state leaves
    (R, R, 2) pos, (R+1, R, 3) / (R, R+1, 3) shelves; ``step`` takes (A,)
    actions and obs / reward / info leaves lead with the agent axis. The
    reference's scalar step, with its two spawn draws in ``noise_fn``."""
    R, S = cfg.grid, cfg.region
    dev = resolve_device(device)
    agents = torch.as_tensor(agents, dtype=torch.long,
                             device=dev).reshape(-1, 2)
    A = agents.shape[0]
    ais, ajs = agents[:, 0], agents[:, 1]
    cells = item_cells(S, dev)
    sel = agent_placement(agents, R, dev)
    agent_mask = sel.sum(0) > 0
    ii, jj = torch.meshgrid(torch.arange(R, device=dev),
                            torch.arange(R, device=dev), indexing="ij")
    spec = EnvSpec(name="warehouse-gs-multi", obs_dim=S * S + 12,
                   n_actions=5, n_influence=12, dset_dim=24,
                   dset_full_dim=24 + S * S, n_agents=A)

    def observe(state: WarehouseState):
        ages = _region_items(state.items_h, state.items_v, ais, ajs)
        return torch.cat([_bitmap(state.pos[ais, ajs], S),
                          (ages > 0).to(torch.float32)], -1)

    def reset(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        pos = torch.randint(0, S, shape + (R, R, 2), generator=gen,
                            device=dev, dtype=torch.int32)
        items_h = (torch.rand(shape + (R + 1, R, 3), generator=gen,
                              device=dev) < 0.3).to(torch.int32)
        items_v = (torch.rand(shape + (R, R + 1, 3), generator=gen,
                              device=dev) < 0.3).to(torch.int32)
        return WarehouseState(pos=pos, items_h=items_h, items_v=items_v)

    def noise_fn(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        return {"spawn_h": torch.rand(shape + (R + 1, R, 3), generator=gen,
                                      device=dev) < cfg.p_item,
                "spawn_v": torch.rand(shape + (R, R + 1, 3), generator=gen,
                                      device=dev) < cfg.p_item}

    def step_det(state: WarehouseState, actions, noise):
        pos, items_h, items_v = state
        region_ages = _region_items(items_h, items_v, ii, jj)  # (R, R, 12)

        # scripted actions for every robot (L1-greedy toward the oldest
        # active item, the first of equal ages); agents overridden
        has = region_ages > 0
        target = first_argmax(torch.where(has, region_ages, -1))
        dr = cells[0][target] - pos[..., 0]
        dc = cells[1][target] - pos[..., 1]
        acts = torch.where(dr < 0, 1, torch.where(
            dr > 0, 2, torch.where(dc < 0, 3, torch.where(dc > 0, 4, 0))))
        acts = torch.where(has.any(-1), acts, 0)
        placed = (sel * actions.reshape(A, 1, 1).long()).sum(0)
        acts = torch.where(agent_mask, placed, acts)
        new_pos = _move(pos, acts, S)

        # pickups: robots standing on each shelf cell, from both regions
        # beside it
        at = _at_items(new_pos, cells).to(torch.int32)      # (R, R, 12)
        zh = torch.zeros((1, R, 3), dtype=torch.int32, device=dev)
        zv = torch.zeros((R, 1, 3), dtype=torch.int32, device=dev)
        occ_h = (torch.cat([at[..., 0:3], zh], 0)
                 + torch.cat([zh, at[..., 3:6]], 0))
        occ_v = (torch.cat([at[..., 6:9], zv], 1)
                 + torch.cat([zv, at[..., 9:12]], 1))
        new_h = _age_items(items_h, (occ_h > 0) & (items_h > 0),
                           noise["spawn_h"], cfg)
        new_v = _age_items(items_v, (occ_v > 0) & (items_v > 0),
                           noise["spawn_v"], cfg)
        new_state = WarehouseState(pos=new_pos, items_h=new_h,
                                   items_v=new_v)

        # each agent's view
        ages_before = region_ages[ais, ajs]                  # (A, 12)
        agent_pos = new_pos[ais, ajs]
        agent_at = _at_items(agent_pos, cells)
        reward = (agent_at & (ages_before > 0)).sum(-1).to(torch.float32)
        # influence sources: neighbour robots on the agent's cells (the
        # agent's own occupancy taken out)
        occ_agent = _region_items(occ_h, occ_v, ais, ajs)
        u = (occ_agent - agent_at.to(torch.int32)) > 0
        if cfg.vanish_after > 0:
            # §5.4: the influence event is the disappearance itself
            u = u | (ages_before >= cfg.vanish_after)
        at_before = _at_items(pos[ais, ajs], cells)
        dset = torch.cat([(ages_before > 0).to(torch.float32),
                          (at_before | agent_at).to(torch.float32)], -1)
        obs = torch.cat(
            [_bitmap(agent_pos, S),
             (_region_items(new_h, new_v, ais, ajs) > 0).to(torch.float32)],
            -1)
        info = {"u": u.to(torch.float32), "dset": dset,
                "dset_full": torch.cat([dset, _bitmap(pos[ais, ajs], S)],
                                       -1),
                "ages": ages_before}
        return new_state, obs, reward, info

    def step(state: WarehouseState, actions, gen: torch.Generator):
        return step_det(state, actions, noise_fn(gen))

    return Env(spec=spec, reset=reset, step=step, observe=observe,
               noise_fn=noise_fn, step_det=step_det)


def make_warehouse_env(cfg: WarehouseConfig = WarehouseConfig(),
                       device="cuda") -> Env:
    """Scalar single-agent GS: the multi-agent env at ``cfg.agent``,
    squeezed."""
    multi = make_multi_warehouse_env(cfg, [cfg.agent], device)
    return squeeze_agent_env(multi, "warehouse-gs")


def make_local_warehouse_env(cfg: WarehouseConfig = WarehouseConfig(),
                             device="cuda") -> LocalEnv:
    """Scalar LS: the agent's 5 x 5 region only, (2,) pos and (12,) items
    int32; u_t removes the items neighbours took; the (12,) spawn draw is
    its ``noise_fn``."""
    S = cfg.region
    dev = resolve_device(device)
    cells = item_cells(S, dev)
    spec = EnvSpec(name="warehouse-ls", obs_dim=S * S + 12, n_actions=5,
                   n_influence=12, dset_dim=24, dset_full_dim=24 + S * S)

    def observe(state: LocalWarehouseState):
        return torch.cat([_bitmap(state.pos, S),
                          (state.items > 0).to(torch.float32)])

    def reset(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        pos = torch.randint(0, S, shape + (2,), generator=gen, device=dev,
                            dtype=torch.int32)
        items = (torch.rand(shape + (12,), generator=gen, device=dev)
                 < 0.3).to(torch.int32)
        return LocalWarehouseState(pos=pos, items=items)

    def noise_fn(gen: torch.Generator, shape=()):
        return torch.rand(tuple(shape) + (12,), generator=gen,
                          device=dev) < cfg.p_item

    def step_det(state: LocalWarehouseState, action, u, spawn):
        pos, items = state
        new_pos = _move(pos, action, S)
        agent_at = _at_items(new_pos, cells)
        reward = (agent_at & (items > 0)).sum().to(torch.float32)
        new_items = _age_items(items, agent_at | (u > 0.5),
                               spawn.to(torch.bool), cfg)
        new_state = LocalWarehouseState(pos=new_pos, items=new_items)
        dset = torch.cat([(items > 0).to(torch.float32),
                          (_at_items(pos, cells) | agent_at
                           ).to(torch.float32)])
        info = {"dset": dset,
                "dset_full": torch.cat([dset, _bitmap(pos, S)]),
                "ages": items}
        return new_state, observe(new_state), reward, info

    def step(state: LocalWarehouseState, action, u, gen: torch.Generator):
        return step_det(state, action, u, noise_fn(gen))

    def dset_fn(state: LocalWarehouseState, action):
        new_pos = _move(state.pos, action, S)
        at = _at_items(state.pos, cells) | _at_items(new_pos, cells)
        return torch.cat([(state.items > 0).to(torch.float32),
                          at.to(torch.float32)])

    return LocalEnv(spec=spec, reset=reset, step=step, observe=observe,
                    dset_fn=dset_fn, noise_fn=noise_fn, step_det=step_det)


def make_batched_multi_warehouse_env(cfg: WarehouseConfig, agents,
                                     device="cuda") -> BatchedEnv:
    """Natively batched multi-agent GS: ``agents`` is an (A, 2) list of
    region coordinates whose robots are trained; actions are (B, A) and
    obs / reward / info leaves (B, A, ...)."""
    R, S = cfg.grid, cfg.region
    dev = resolve_device(device)
    agents = torch.as_tensor(agents, dtype=torch.long, device=dev)
    A = agents.shape[0]
    ais, ajs = agents[:, 0], agents[:, 1]
    cells = item_cells(S, dev)
    spec = EnvSpec(name="warehouse-gs-multi-b", obs_dim=S * S + 12,
                   n_actions=5, n_influence=12, dset_dim=24,
                   dset_full_dim=24 + S * S, n_agents=A)

    def observe(state: WarehouseState):
        ages = _region_ages_all(state.items_h, state.items_v)[:, ais, ajs]
        return torch.cat([_bitmap(state.pos[:, ais, ajs], S),
                          (ages > 0).to(torch.float32)], dim=-1)

    def reset(gen: torch.Generator, n_envs: int):
        pos = torch.randint(0, S, (n_envs, R, R, 2), generator=gen,
                            device=dev, dtype=torch.int32)
        items_h = (torch.rand((n_envs, R + 1, R, 3), generator=gen,
                              device=dev) < 0.3).to(torch.int32)
        items_v = (torch.rand((n_envs, R, R + 1, 3), generator=gen,
                              device=dev) < 0.3).to(torch.int32)
        return WarehouseState(pos=pos, items_h=items_h, items_v=items_v)

    def noise_fn(gen: torch.Generator, n_envs: int):
        return {"spawn_h": torch.rand((n_envs, R + 1, R, 3), generator=gen,
                                      device=dev) < cfg.p_item,
                "spawn_v": torch.rand((n_envs, R, R + 1, 3), generator=gen,
                                      device=dev) < cfg.p_item}

    def step_det(state: WarehouseState, actions, noise):
        pos, items_h, items_v = state
        B = pos.shape[0]
        region_ages = _region_ages_all(items_h, items_v)     # (B, R, R, 12)

        # scripted robots: L1-greedy toward the oldest active item (the
        # first of equal ages); the agents' robots take their actions
        has = region_ages > 0
        target = first_argmax(torch.where(has, region_ages, -1))
        dr = cells[0][target] - pos[..., 0]
        dc = cells[1][target] - pos[..., 1]
        acts = torch.where(dr < 0, 1, torch.where(
            dr > 0, 2, torch.where(dc < 0, 3, torch.where(dc > 0, 4, 0))))
        acts = torch.where(has.any(-1), acts, 0)
        acts[:, ais, ajs] = actions.reshape(B, A).to(acts.dtype)
        new_pos = _move(pos, acts, S)

        # pickups: robots standing on each shelf cell (a shelf segment is
        # shared by the two regions beside it)
        at = _at_items(new_pos, cells).to(torch.int32)       # (B, R, R, 12)
        occ_h = torch.zeros_like(items_h)
        occ_v = torch.zeros_like(items_v)
        occ_h[:, :R] += at[..., 0:3]
        occ_h[:, 1:] += at[..., 3:6]
        occ_v[:, :, :R] += at[..., 6:9]
        occ_v[:, :, 1:] += at[..., 9:12]
        new_h = _age_items(items_h, (occ_h > 0) & (items_h > 0),
                           noise["spawn_h"], cfg)
        new_v = _age_items(items_v, (occ_v > 0) & (items_v > 0),
                           noise["spawn_v"], cfg)
        new_state = WarehouseState(pos=new_pos, items_h=new_h, items_v=new_v)

        ages_before = region_ages[:, ais, ajs]               # (B, A, 12)
        agent_pos = new_pos[:, ais, ajs]
        agent_at = _at_items(agent_pos, cells)
        reward = (agent_at & (ages_before > 0)).sum(-1).to(torch.float32)
        occ_agent = torch.cat([occ_h[:, ais, ajs], occ_h[:, ais + 1, ajs],
                               occ_v[:, ais, ajs], occ_v[:, ais, ajs + 1]],
                              dim=-1)
        u = (occ_agent - agent_at.to(torch.int32)) > 0
        if cfg.vanish_after > 0:
            u = u | (ages_before >= cfg.vanish_after)
        at_before = _at_items(pos[:, ais, ajs], cells)
        dset = torch.cat([(ages_before > 0).to(torch.float32),
                          (at_before | agent_at).to(torch.float32)], dim=-1)
        new_ages = _region_ages_all(new_h, new_v)[:, ais, ajs]
        obs = torch.cat([_bitmap(agent_pos, S),
                         (new_ages > 0).to(torch.float32)], dim=-1)
        info = {"u": u.to(torch.float32), "dset": dset,
                "dset_full": torch.cat([dset, _bitmap(pos[:, ais, ajs], S)],
                                       dim=-1),
                "ages": ages_before}
        return new_state, obs, reward, info

    def step(state: WarehouseState, actions, gen: torch.Generator):
        return step_det(state, actions, noise_fn(gen, state.pos.shape[0]))

    return BatchedEnv(spec=spec, reset=reset, step=step, observe=observe,
                      noise_fn=noise_fn, step_det=step_det)


def make_batched_warehouse_env(cfg: WarehouseConfig = WarehouseConfig(),
                               device="cuda") -> BatchedEnv:
    """Single-agent GS: the batched multi-agent GS at ``cfg.agent``,
    squeezed."""
    multi = make_batched_multi_warehouse_env(cfg, [cfg.agent], device)
    return squeeze_agent_env(multi, "warehouse-gs")


def make_batched_local_warehouse_env(
        cfg: WarehouseConfig = WarehouseConfig(),
        device="cuda") -> BatchedLocalEnv:
    """Natively batched LS: the agent's region only, leaves (B, 2) pos and
    (B, 12) items int32; u_t removes the items neighbours took, and the
    spawns are its own noise ((B, 12) bool a tick)."""
    S = cfg.region
    dev = resolve_device(device)
    cells = item_cells(S, dev)
    spec = EnvSpec(name="warehouse-ls-b", obs_dim=S * S + 12, n_actions=5,
                   n_influence=12, dset_dim=24, dset_full_dim=24 + S * S)

    def observe(state: LocalWarehouseState):
        return torch.cat([_bitmap(state.pos, S),
                          (state.items > 0).to(torch.float32)], dim=-1)

    def reset(gen: torch.Generator, n_envs: int):
        pos = torch.randint(0, S, (n_envs, 2), generator=gen, device=dev,
                            dtype=torch.int32)
        items = (torch.rand((n_envs, 12), generator=gen, device=dev)
                 < 0.3).to(torch.int32)
        return LocalWarehouseState(pos=pos, items=items)

    def noise_fn(gen: torch.Generator, n_envs: int):
        return torch.rand((n_envs, 12), generator=gen,
                          device=dev) < cfg.p_item

    def rollout_tick(state: LocalWarehouseState, actions, u, spawn):
        new_pos = _move(state.pos, actions, S)
        agent_at = _at_items(new_pos, cells)
        reward = (agent_at & (state.items > 0)).sum(-1).to(torch.float32)
        new_items = _age_items(state.items, agent_at | (u > 0.5),
                               spawn.to(torch.bool), cfg)
        return LocalWarehouseState(pos=new_pos, items=new_items), reward

    def step_det(state: LocalWarehouseState, actions, u, spawn):
        new_state, reward = rollout_tick(state, actions, u, spawn)
        dset = dset_fn(state, actions)
        info = {"dset": dset,
                "dset_full": torch.cat([dset, _bitmap(state.pos, S)],
                                       dim=-1),
                "ages": state.items}
        return new_state, observe(new_state), reward, info

    def step(state: LocalWarehouseState, actions, u, gen: torch.Generator):
        return step_det(state, actions, u,
                        noise_fn(gen, state.pos.shape[0]))

    def dset_fn(state: LocalWarehouseState, actions):
        new_pos = _move(state.pos, actions, S)
        at = _at_items(state.pos, cells) | _at_items(new_pos, cells)
        return torch.cat([(state.items > 0).to(torch.float32),
                          at.to(torch.float32)], dim=-1)

    return BatchedLocalEnv(
        spec=spec, reset=reset, step=step, observe=observe, dset_fn=dset_fn,
        noise_fn=noise_fn, step_det=step_det, rollout_tick=rollout_tick,
        obs_fn=observe,
        kernel_domain=KernelDomain("warehouse", region=S,
                                   max_age=cfg.max_age,
                                   vanish_after=cfg.vanish_after))
