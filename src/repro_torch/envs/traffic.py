"""Traffic-grid domain, batched in torch (counterpart of
``repro/envs/traffic.py``).

Global simulator (GS): B whole G x G grids of intersections, four
incoming lanes of L cells each (direction 0 south, 1 north, 2 west,
3 east), boundary inflow with probability ``p_in``, actuated
queue-comparison controllers at non-agent intersections; the agents set
their own lights. ``step_det`` takes the tick's inflow draw (B, G, G, 4)
as a tensor (``noise_fn`` draws it from a generator), so tests can hand
it the draw the JAX package made.

Local simulator (LS): one agent's four incoming lanes; the influence
sources u_t (4 bits, 8 with ``ext_influence``) inject cars at the lane
tails. It draws no randomness of its own. ``rollout_tick`` is the
transition+reward core that the CUDA kernels carry as the traffic device
functor (``KernelDomain("traffic")``): the suffix-OR lane advance over a
10-bit mask per lane, injection ``u[:4] & ~tail``, and the reward
``n_moved / max(n_cars, 1)`` (1 when the lanes are empty).

The scalar protocol (``envs.api.Env`` / ``LocalEnv``, one simulator, no
env axis): ``make_multi_traffic_env``, ``make_traffic_env`` and
``make_local_traffic_env`` port the reference's scalar code, with its
inflow draw moved into ``noise_fn``; ``batch_env`` lifts them by vmap.
They are the loop baseline the batched envs are measured against.
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
class TrafficConfig:
    grid: int = 5
    lane_len: int = 10
    p_in: float = 0.1
    agent: Tuple[int, int] = (2, 2)
    min_phase: int = 2          # actuated controller hysteresis (steps)
    queue_window: int = 5       # cells from stop line counted as queue
    ext_influence: bool = False  # 8-bit u_t (+4 downstream-blocked bits)


class TrafficState(NamedTuple):
    lanes: torch.Tensor   # (B, G, G, 4, L) bool occupancy
    phase: torch.Tensor   # (B, G, G) int8: 0 = NS green, 1 = EW green
    timer: torch.Tensor   # (B, G, G) int32 steps since last switch


class LocalTrafficState(NamedTuple):
    lanes: torch.Tensor   # (B, 4, L) bool
    phase: torch.Tensor   # (B,) int8


def _advance_lane(occ, can_cross):
    """Synchronous advance of (..., L) boolean lanes -> (new_occ, moved,
    crossed). A car moves iff some cell strictly ahead is free, or every
    cell ahead is occupied and the stop-line car crosses (the suffix-OR
    closed form of the backward induction)."""
    L = occ.shape[-1]
    g = ~occ                                  # suffix-OR of free cells
    s = 1
    while s < L:
        g = torch.cat([g[..., :L - s] | g[..., s:], g[..., L - s:]], dim=-1)
        s *= 2
    gap = torch.cat([g[..., 1:], torch.zeros_like(g[..., :1])], dim=-1)
    moved = occ & (gap | can_cross[..., None])
    stay = occ & ~moved
    shifted = torch.cat([torch.zeros_like(occ[..., :1]), moved[..., :-1]],
                        dim=-1)
    return stay | shifted, moved, moved[..., -1]


# directions: 0 south(+i), 1 north(-i), 2 west(-j), 3 east(+j)
_DI = (1, -1, 0, 0)
_DJ = (0, 0, -1, 1)


def _green(phase):
    """(..., G, G) phase -> (..., G, G, 4) approach-green mask."""
    ns = phase == 0
    return torch.stack([ns, ns, ~ns, ~ns], dim=-1)


def _reward(n_cars, n_moved):
    return torch.where(n_cars > 0, n_moved / torch.clamp(n_cars, min=1),
                       torch.ones((), dtype=torch.float32,
                                  device=n_cars.device))


def local_traffic_state(state: TrafficState, i, j) -> LocalTrafficState:
    """The LS view of intersection (i, j) of a GS state, scalar or batched
    (the state's leading axes are kept); index tensors ``i``, ``j`` of
    shape (A,) give one view per agent."""
    return LocalTrafficState(lanes=state.lanes[..., i, j, :, :],
                             phase=state.phase[..., i, j])


def make_multi_traffic_env(cfg: TrafficConfig, agents,
                           device="cuda") -> Env:
    """Scalar GS with an agent at every listed intersection: state leaves
    (G, G, 4, L) lanes, (G, G) phase and timer; ``step`` takes (A,)
    actions and obs / reward / info leaves lead with the agent axis. The
    reference's scalar step, with its inflow draw in ``noise_fn``."""
    G, L = cfg.grid, cfg.lane_len
    dev = resolve_device(device)
    agents = torch.as_tensor(agents, dtype=torch.long,
                             device=dev).reshape(-1, 2)
    A = agents.shape[0]
    ais, ajs = agents[:, 0], agents[:, 1]
    sel = agent_placement(agents, G, dev)
    agent_mask = sel.sum(0) > 0
    M = 8 if cfg.ext_influence else 4
    spec = EnvSpec(name="traffic-gs-multi", obs_dim=4 * L + 1, n_actions=2,
                   n_influence=M, dset_dim=4 * L, dset_full_dim=4 * L + 1,
                   n_agents=A)
    # per direction: the row / column whose crossings leave the grid, and
    # the one boundary inflow enters
    edge = torch.zeros((4, G, G), dtype=torch.bool, device=dev)
    edge[0, G - 1, :] = edge[1, 0, :] = True
    edge[2, :, 0] = edge[3, :, G - 1] = True
    entry = torch.zeros((4, G, G), dtype=torch.bool, device=dev)
    entry[0, 0, :] = entry[1, G - 1, :] = True
    entry[2, :, G - 1] = entry[3, :, 0] = True

    def observe(state: TrafficState):
        local = state.lanes[ais, ajs].reshape(A, -1).float()
        return torch.cat([local, state.phase[ais, ajs, None].float()], -1)

    def reset(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        lanes = torch.rand(shape + (G, G, 4, L), generator=gen,
                           device=dev) < 0.15
        phase = torch.randint(0, 2, shape + (G, G), generator=gen,
                              device=dev).to(torch.int8)
        return TrafficState(lanes=lanes, phase=phase,
                            timer=torch.zeros(shape + (G, G),
                                              dtype=torch.int32, device=dev))

    def noise_fn(gen: torch.Generator, shape=()):
        return torch.rand(tuple(shape) + (G, G, 4), generator=gen,
                          device=dev) < cfg.p_in

    def step_det(state: TrafficState, actions, inflow):
        lanes, phase, timer = state
        placed = (sel * actions.reshape(A, 1, 1).long()).sum(0)
        phase = torch.where(agent_mask, placed, phase).to(torch.int8)
        green = _green(phase)                             # (G, G, 4)

        # crossing feasibility: the downstream tail must be free (edges
        # exit the grid)
        dest_free = torch.stack(
            [~torch.roll(lanes[:, :, d, 0], shifts=(-_DI[d], -_DJ[d]),
                         dims=(0, 1)) | edge[d] for d in range(4)], -1)
        new_lanes, moved, crossed = _advance_lane(lanes, green & dest_free)

        # injections: crossings arriving from upstream, else boundary
        # inflow
        inj = torch.stack(
            [(torch.roll(crossed[:, :, d], shifts=(_DI[d], _DJ[d]),
                         dims=(0, 1)) & ~entry[d])
             | (entry[d] & inflow[:, :, d]) for d in range(4)], -1)
        inj = inj & ~new_lanes[..., 0]
        new_lanes = torch.cat([(new_lanes[..., 0] | inj)[..., None],
                               new_lanes[..., 1:]], -1)

        # actuated controllers (non-agent intersections)
        q = lanes[..., L - cfg.queue_window:].sum(-1)     # (G, G, 4)
        q_ns, q_ew = q[..., 0] + q[..., 1], q[..., 2] + q[..., 3]
        green_q = torch.where(phase == 0, q_ns, q_ew)
        red_q = torch.where(phase == 0, q_ew, q_ns)
        want_switch = (red_q > green_q) & (timer >= cfg.min_phase)
        new_phase = torch.where(want_switch, 1 - phase, phase)
        new_timer = torch.where(want_switch, 0, timer + 1)
        new_phase = torch.where(agent_mask, phase, new_phase).to(torch.int8)
        new_timer = torch.where(agent_mask, 0, new_timer).to(torch.int32)
        new_state = TrafficState(lanes=new_lanes, phase=new_phase,
                                 timer=new_timer)

        # each agent's view: reward = average speed over its lanes
        la = lanes[ais, ajs]                              # (A, 4, L)
        n_cars = la.sum((1, 2))
        reward = _reward(n_cars, moved[ais, ajs].sum((1, 2)))
        dset = la.reshape(A, -1).float()
        u = inj[ais, ajs].float()
        if cfg.ext_influence:
            u = torch.cat([u, (~dest_free[ais, ajs]).float()], -1)
        obs = torch.cat([new_lanes[ais, ajs].reshape(A, -1).float(),
                         new_phase[ais, ajs, None].float()], -1)
        info = {"u": u, "dset": dset,
                "dset_full": torch.cat(
                    [dset, phase[ais, ajs, None].float()], -1),
                "n_cars": n_cars}
        return new_state, obs, reward, info

    def step(state: TrafficState, actions, gen: torch.Generator):
        return step_det(state, actions, noise_fn(gen))

    return Env(spec=spec, reset=reset, step=step, observe=observe,
               noise_fn=noise_fn, step_det=step_det)


def make_traffic_env(cfg: TrafficConfig = TrafficConfig(),
                     device="cuda") -> Env:
    """Scalar single-agent GS: the multi-agent env at ``cfg.agent``,
    squeezed."""
    multi = make_multi_traffic_env(cfg, [cfg.agent], device)
    return squeeze_agent_env(multi, "traffic-gs")


def make_local_traffic_env(cfg: TrafficConfig = TrafficConfig(),
                           device="cuda") -> LocalEnv:
    """Scalar LS: the agent's 4 incoming lanes, (4, L) bool and a 0-d int8
    phase; u_t drives boundary injection (and, with ``ext_influence``,
    blocks crossing onto congested downstream tails). Deterministic given
    u_t: ``noise_fn`` returns None."""
    L = cfg.lane_len
    dev = resolve_device(device)
    M = 8 if cfg.ext_influence else 4
    spec = EnvSpec(name="traffic-ls", obs_dim=4 * L + 1, n_actions=2,
                   n_influence=M, dset_dim=4 * L, dset_full_dim=4 * L + 1)

    def observe(state: LocalTrafficState):
        return torch.cat([state.lanes.reshape(-1).float(),
                          state.phase[None].float()])

    def reset(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        lanes = torch.rand(shape + (4, L), generator=gen, device=dev) < 0.15
        return LocalTrafficState(
            lanes=lanes, phase=torch.zeros(shape, dtype=torch.int8,
                                           device=dev))

    def noise_fn(gen: torch.Generator, shape=()):
        return None          # the traffic LS is deterministic given u_t

    def step_det(state: LocalTrafficState, action, u, noise):
        del noise
        lanes = state.lanes
        phase = action.to(torch.int8)
        ns = (phase == 0)
        green = torch.stack([ns, ns, ~ns, ~ns])           # (4,)
        # crossing cars leave the region freely (open boundary) unless the
        # 8-bit u_t marks the downstream tail as occupied
        can_cross = green
        if cfg.ext_influence:
            can_cross = green & ~u[4:].bool()
        new_lanes, moved, _ = _advance_lane(lanes, can_cross)
        inj = u[:4].bool() & ~new_lanes[:, 0]
        new_lanes = torch.cat([(new_lanes[:, 0] | inj)[:, None],
                               new_lanes[:, 1:]], -1)
        n_cars = lanes.sum()
        reward = _reward(n_cars, moved.sum())
        new_state = LocalTrafficState(lanes=new_lanes, phase=phase)
        dset = lanes.reshape(-1).float()
        info = {"dset": dset,
                "dset_full": torch.cat([dset, state.phase[None].float()]),
                "n_cars": n_cars}
        return new_state, observe(new_state), reward, info

    def step(state: LocalTrafficState, action, u, gen: torch.Generator):
        return step_det(state, action, u, noise_fn(gen))

    def dset_fn(state: LocalTrafficState, action):
        return state.lanes.reshape(-1).float()

    return LocalEnv(spec=spec, reset=reset, step=step, observe=observe,
                    dset_fn=dset_fn, noise_fn=noise_fn, step_det=step_det)


def make_batched_multi_traffic_env(cfg: TrafficConfig, agents,
                                   device="cuda") -> BatchedEnv:
    """Natively batched multi-agent GS: ``agents`` is an (A, 2) list of
    (i, j) intersections; actions are (B, A) and obs / reward / info
    leaves (B, A, ...)."""
    G, L = cfg.grid, cfg.lane_len
    dev = resolve_device(device)
    agents = torch.as_tensor(agents, dtype=torch.long, device=dev)
    A = agents.shape[0]
    ais, ajs = agents[:, 0], agents[:, 1]
    agent_mask = torch.zeros((G, G), dtype=torch.bool, device=dev)
    agent_mask[ais, ajs] = True
    M = 8 if cfg.ext_influence else 4
    spec = EnvSpec(name="traffic-gs-multi-b", obs_dim=4 * L + 1,
                   n_actions=2, n_influence=M, dset_dim=4 * L,
                   dset_full_dim=4 * L + 1, n_agents=A)
    edge = torch.zeros((4, G, G), dtype=torch.bool, device=dev)
    edge[0, G - 1, :] = True      # where a crossing leaves the grid
    edge[1, 0, :] = True
    edge[2, :, 0] = True
    edge[3, :, G - 1] = True
    boundary = torch.zeros((4, G, G), dtype=torch.bool, device=dev)
    boundary[0, 0, :] = True      # where boundary inflow enters
    boundary[1, G - 1, :] = True
    boundary[2, :, G - 1] = True
    boundary[3, :, 0] = True

    def observe(state: TrafficState):
        B = state.lanes.shape[0]
        local = state.lanes[:, ais, ajs].reshape(B, A, -1).float()
        return torch.cat([local, state.phase[:, ais, ajs, None].float()],
                         dim=-1)

    def reset(gen: torch.Generator, n_envs: int):
        lanes = torch.rand((n_envs, G, G, 4, L), generator=gen,
                           device=dev) < 0.15
        phase = torch.randint(0, 2, (n_envs, G, G), generator=gen,
                              device=dev).to(torch.int8)
        return TrafficState(lanes=lanes, phase=phase,
                            timer=torch.zeros((n_envs, G, G),
                                              dtype=torch.int32,
                                              device=dev))

    def noise_fn(gen: torch.Generator, n_envs: int):
        return torch.rand((n_envs, G, G, 4), generator=gen,
                          device=dev) < cfg.p_in

    def step_det(state: TrafficState, actions, inflow):
        lanes, phase, timer = state
        B = lanes.shape[0]
        phase = phase.clone()
        phase[:, ais, ajs] = actions.reshape(B, A).to(torch.int8)
        green = _green(phase)                            # (B, G, G, 4)

        # crossing feasibility: the downstream tail must be free
        dest_free = torch.stack([
            ~torch.roll(lanes[:, :, :, d, 0], shifts=(-_DI[d], -_DJ[d]),
                        dims=(1, 2)) | edge[d]
            for d in range(4)], dim=-1)
        new_lanes, moved, crossed = _advance_lane(lanes, green & dest_free)

        # injections: crossings arriving from upstream, else boundary inflow
        inj = torch.stack([
            (torch.roll(crossed[:, :, :, d], shifts=(_DI[d], _DJ[d]),
                        dims=(1, 2)) & ~boundary[d])
            | (boundary[d] & inflow[:, :, :, d])
            for d in range(4)], dim=-1)
        inj = inj & ~new_lanes[..., 0]
        new_lanes = new_lanes.clone()
        new_lanes[..., 0] |= inj

        # actuated controllers (non-agent intersections)
        q = lanes[..., L - cfg.queue_window:].sum(-1)    # (B, G, G, 4)
        q_ns, q_ew = q[..., 0] + q[..., 1], q[..., 2] + q[..., 3]
        green_q = torch.where(phase == 0, q_ns, q_ew)
        red_q = torch.where(phase == 0, q_ew, q_ns)
        want_switch = (red_q > green_q) & (timer >= cfg.min_phase)
        new_phase = torch.where(want_switch, 1 - phase, phase)
        new_timer = torch.where(want_switch, 0, timer + 1)
        new_phase = torch.where(agent_mask, phase, new_phase).to(torch.int8)
        new_timer = torch.where(agent_mask, 0, new_timer).to(torch.int32)
        new_state = TrafficState(lanes=new_lanes, phase=new_phase,
                                 timer=new_timer)

        la = lanes[:, ais, ajs]                          # (B, A, 4, L)
        n_cars = la.sum(dim=(2, 3))
        n_moved = moved[:, ais, ajs].sum(dim=(2, 3))
        reward = _reward(n_cars, n_moved)
        dset = la.reshape(B, A, -1).float()
        u = inj[:, ais, ajs].float()
        if cfg.ext_influence:
            u = torch.cat([u, (~dest_free[:, ais, ajs]).float()], dim=-1)
        obs = torch.cat([new_lanes[:, ais, ajs].reshape(B, A, -1).float(),
                         new_phase[:, ais, ajs, None].float()], dim=-1)
        info = {"u": u, "dset": dset,
                "dset_full": torch.cat(
                    [dset, phase[:, ais, ajs, None].float()], dim=-1),
                "n_cars": n_cars}
        return new_state, obs, reward, info

    def step(state: TrafficState, actions, gen: torch.Generator):
        return step_det(state, actions,
                        noise_fn(gen, state.lanes.shape[0]))

    return BatchedEnv(spec=spec, reset=reset, step=step, observe=observe,
                      noise_fn=noise_fn, step_det=step_det)


def make_batched_traffic_env(cfg: TrafficConfig = TrafficConfig(),
                             device="cuda") -> BatchedEnv:
    """Single-agent GS: the batched multi-agent GS at ``cfg.agent``,
    squeezed."""
    multi = make_batched_multi_traffic_env(cfg, [cfg.agent], device)
    return squeeze_agent_env(multi, "traffic-gs")


def make_batched_local_traffic_env(cfg: TrafficConfig = TrafficConfig(),
                                   device="cuda") -> BatchedLocalEnv:
    """Natively batched LS: leaves (B, 4, L) bool lanes and (B,) int8
    phase; deterministic given u_t, so ``noise_fn`` returns None."""
    L = cfg.lane_len
    dev = resolve_device(device)
    M = 8 if cfg.ext_influence else 4
    spec = EnvSpec(name="traffic-ls-b", obs_dim=4 * L + 1, n_actions=2,
                   n_influence=M, dset_dim=4 * L, dset_full_dim=4 * L + 1)

    def observe(state: LocalTrafficState):
        B = state.lanes.shape[0]
        return torch.cat([state.lanes.reshape(B, -1).float(),
                          state.phase[:, None].float()], dim=-1)

    def reset(gen: torch.Generator, n_envs: int):
        lanes = torch.rand((n_envs, 4, L), generator=gen, device=dev) < 0.15
        return LocalTrafficState(
            lanes=lanes,
            phase=torch.zeros((n_envs,), dtype=torch.int8, device=dev))

    def noise_fn(gen: torch.Generator, n_envs: int):
        return None          # the traffic LS is deterministic given u_t

    def rollout_tick(state: LocalTrafficState, actions, u, noise):
        del noise
        lanes = state.lanes                              # (B, 4, L)
        phase = actions.to(torch.int8)                   # (B,)
        ns = (phase == 0)[:, None]
        green = torch.cat([ns, ns, ~ns, ~ns], dim=-1)    # (B, 4)
        can_cross = green
        if cfg.ext_influence:
            can_cross = green & ~u[:, 4:].bool()
        new_lanes, moved, _ = _advance_lane(lanes, can_cross)
        inj = u[:, :4].bool() & ~new_lanes[:, :, 0]
        new_lanes = new_lanes.clone()
        new_lanes[:, :, 0] |= inj
        reward = _reward(lanes.sum(dim=(1, 2)), moved.sum(dim=(1, 2)))
        return LocalTrafficState(lanes=new_lanes, phase=phase), reward

    def step_det(state: LocalTrafficState, actions, u, noise):
        new_state, reward = rollout_tick(state, actions, u, noise)
        B = state.lanes.shape[0]
        dset = state.lanes.reshape(B, -1).float()
        info = {"dset": dset,
                "dset_full": torch.cat([dset, state.phase[:, None].float()],
                                       dim=-1),
                "n_cars": state.lanes.sum(dim=(1, 2))}
        return new_state, observe(new_state), reward, info

    def step(state: LocalTrafficState, actions, u, gen):
        return step_det(state, actions, u,
                        noise_fn(gen, state.lanes.shape[0]))

    def dset_fn(state: LocalTrafficState, actions):
        return state.lanes.reshape(state.lanes.shape[0], -1).float()

    return BatchedLocalEnv(
        spec=spec, reset=reset, step=step, observe=observe,
        dset_fn=dset_fn, noise_fn=noise_fn, step_det=step_det,
        rollout_tick=rollout_tick, obs_fn=observe,
        kernel_domain=KernelDomain("traffic", lane_len=L,
                                   ext_influence=cfg.ext_influence))
