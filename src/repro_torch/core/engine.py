"""The unified IALS rollout engine (counterpart of ``repro/core/engine.py``).

``make_unified_ials`` builds the natively batched IALS (a ``BatchedEnv``)
for either AIP backbone ({gru, fnn}) and any agent multiplicity A: the
agent axis is a batch dimension of one fused tick, and a grid dimension
of one whole-horizon kernel. State leaves are (B, ...) when A = 1 and
(B, A, ...) otherwise.

Per tick (``step_det``): d_t from the LS, one AIP tick with its Bernoulli
draw (``influence.step_sample[_multi]``; the GRU tick is the ``aip_step``
kernel on the card), one batched LS transition over all B*A lanes.

Whole horizon:
  - ``rollout(state, actions, noise)`` is ONE ``kernels.ops`` call —
    ``ials_rollout_multi`` (GRU) or ``fnn_rollout`` (FNN);
  - ``policy_rollout`` hands PPO's whole acting loop (policy forward,
    Gumbel-argmax, AIP, LS tick, reward, periodic resets) to ONE
    ``kernels.ops.policy_rollout`` call.
Both always take the kernel route: ``ops`` launches the CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors, so there is no
auto-detection that quietly picks a loop. ``policy_rollout`` is set
whenever the LS has ``rollout_tick``, ``noise_fn`` and ``obs_fn``.

F-IALS (paper App. E): ``fixed_marginal`` / ``fixed_marginal_vec`` draw
u_t from a fixed marginal instead of the AIP. As in the JAX package the
kernel route requires a real AIP, so an F-IALS engine's ``rollout`` is a
loop of its own ``step_det`` and ``policy_rollout`` is None (PPO runs its
plain loop). The choice follows the configuration, never the device.

``make_batched_ials`` / ``make_batched_multi_ials`` are the historical
entry points, thin wrappers of ``make_unified_ials``. The reference's
``use_horizon_kernel=`` argument is not taken: the route is chosen by the
tensor's device (``kernels/ops.py``).

``mesh=`` (a ``DeviceMesh`` of ``launch/mesh.py::make_host_mesh``, one
process a rank) makes the engine one rank's share of a lane-parallel
IALS under the rules of ``distributed/sharding.py``: ``reset`` and
``noise_fn`` take the global ``n_envs``, draw the global lanes and agents
from the generator (which advances as in the one-process run) and keep
this rank's block; every other entry works on blocks; the stacked AIP
weights are sliced to the rank's agents when the agent axis is taken. The
kernels launch on the block with the K-parts planned for the global
(A, B) (``aip_step.shard_plan``), so each lane sums in the order of
the one-process launch and the sharded horizon is bitwise equal to it.
The global batch must shard over every axis the agents leave
(``sharding.require_lane_sharding``). A size-1 mesh or ``None`` leaves
the one-process program untouched.

Lanes are agent-major (lane ``a*B + b``) at the kernel boundary, so each
kernel block indexes its own agent's stacked weights; bool/int8 LS leaves
travel as int32 (``envs.api.kernel_codec``). The episode-reset schedule
inside a horizon is closed-form from ``t_in_ep``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import influence
from repro_torch.distributed import sharding
from repro_torch.envs.api import (BatchedEnv, BatchedLocalEnv, index_tree,
                                  kernel_codec)
from repro_torch.nn.act import fast_sigmoid, random_bits, uniform_from_bits
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class IALSState(NamedTuple):
    ls_state: object        # LS state; (B, ...) leaves, (B, A, ...) if multi
    aip_state: torch.Tensor  # (B, [A,] H) GRU / (B, [A,] stack, d_in) FNN


# agent-major lane layout at the kernel boundary: lane a*B + b holds agent
# a of env b, so each kernel block belongs to one agent (no-ops at A = 1)
def lane_fold(x, A: int):
    """(B, A, ...) -> (A*B, ...)."""
    if A == 1:
        return x
    return x.transpose(0, 1).reshape((-1,) + x.shape[2:])


def lane_unfold(x, A: int, B: int):
    """(A*B, ...) -> (B, A, ...)."""
    if A == 1:
        return x
    return x.reshape((A, B) + x.shape[1:]).transpose(0, 1)


def stream_fold(x, A: int):
    """(T, B, A, ...) -> (T, A*B, ...)."""
    if A == 1:
        return x
    return x.transpose(1, 2).reshape((x.shape[0], -1) + x.shape[3:])


def stream_unfold(x, A: int, B: int):
    """(T, A*B, ...) -> (T, B, A, ...)."""
    if A == 1:
        return x
    return x.reshape((x.shape[0], A, B) + x.shape[2:]).transpose(1, 2)


class KernelIO(NamedTuple):
    """An LS state at the kernel boundary: its kernel-encoded leaves, its
    noise leaves, the codec, and the domain's plain functions on encoded
    leaves (the CPU route's ``tick_fn`` / ``dset_fn`` / ``obs_fn``)."""
    ls: tuple
    noise: tuple
    encode: object
    decode: object         # encoded leaves -> the LS state pytree
    tick_fn: object
    dset_fn: object
    obs_fn: object


def kernel_io(local_env: BatchedLocalEnv, ls_state, env_noise=None):
    """``ls_state`` ((L, ...) leaves, lanes already in kernel order) and
    its T-stacked ``env_noise`` -> ``KernelIO``."""
    ls_leaves = tree_leaves(ls_state)
    ls_enc, ls_dec = kernel_codec([l.dtype for l in ls_leaves])
    nz_leaves = tree_leaves(env_noise)
    nz_enc, nz_dec = kernel_codec([l.dtype for l in nz_leaves])

    def dec(vals):
        return tree_unflatten(ls_state, ls_dec(vals))

    def dset_fn(vals, a):
        return local_env.dset_fn(dec(vals), a)

    def tick_fn(vals, a, u, nzv):
        st2, r = local_env.rollout_tick(
            dec(vals), a, u, tree_unflatten(env_noise, nz_dec(nzv)))
        return ls_enc(tree_leaves(st2)), r

    def obs_fn(vals):
        return local_env.obs_fn(dec(vals))

    return KernelIO(ls_enc(ls_leaves), nz_enc(nz_leaves), ls_enc, dec,
                    tick_fn, dset_fn, obs_fn)


def _check_stateless(stateless, fixed_marginal, fixed_marginal_vec):
    if stateless and fixed_marginal is None and fixed_marginal_vec is None:
        raise ValueError(
            "stateless=True only makes sense for the F-IALS (fixed "
            "marginal) variants: a trained/untrained AIP needs its "
            "recurrent state advanced every tick")


def make_unified_ials(local_env: BatchedLocalEnv, aip_params,
                      aip_cfg: influence.AIPConfig, *,
                      n_agents: int = 1,
                      fixed_marginal: Optional[float] = None,
                      fixed_marginal_vec=None,
                      stateless: bool = False, mesh=None) -> BatchedEnv:
    """The fused rollout engine over a natively batched LS. With
    ``n_agents = A > 1`` the LS batch carries every agent of every env
    copy (B*A lanes) and ``aip_params`` leaves are (A, ...) stacked;
    actions are (B, A) and obs (B, A, obs_dim). With A = 1 the agent axis
    is squeezed off every leaf and ``aip_params`` is one AIP.

    ``fixed_marginal`` (scalar) / ``fixed_marginal_vec`` ((M,) shared or
    (A, M) per agent) make it an F-IALS: u_t ~ Bernoulli(marginal), the
    AIP's output ignored. ``stateless=True`` (F-IALS only) keeps the
    ignored AIP state at its init value instead of advancing it; the leaf
    stays, so the state has the same structure in every variant.

    ``mesh`` makes it one rank's share (module docstring): ``n_agents``
    stays the global A, and the blocks carry this rank's agents."""
    _check_stateless(stateless, fixed_marginal, fixed_marginal_vec)
    if mesh is not None and sharding.mesh_size(mesh) == 1:
        mesh = None
    A_glob = n_agents
    multi = A_glob > 1
    ash_glob = (A_glob,) if multi else ()
    M = local_env.spec.n_influence
    spec = dataclasses.replace(
        local_env.spec,
        name=local_env.spec.name + ("+multi-ials" if multi else "+ials"),
        n_agents=A_glob)
    domain = local_env.kernel_domain

    def _device():
        return tree_leaves(aip_params)[0].device

    if fixed_marginal_vec is not None:
        marg = torch.broadcast_to(
            torch.as_tensor(fixed_marginal_vec, dtype=torch.float32,
                            device=_device()), ash_glob + (M,))
    elif fixed_marginal is not None:
        marg = torch.full(ash_glob + (M,), fixed_marginal,
                          dtype=torch.float32, device=_device())
    else:
        marg = None
    if mesh is not None:        # this rank's agents of the stacked leaves
        aip_params = sharding.shard_ials_aip_params(aip_params, mesh, A_glob)
        if marg is not None:
            marg = sharding.shard_ials_aip_params(marg, mesh, A_glob)
        lanes_k = sharding.lane_factor(A_glob, mesh)
        agent_ax = sharding.ials_lane_axes(1, A_glob, mesh)[1]
    A = A_glob if mesh is None or agent_ax is None \
        else A_glob // sharding.axis_size(mesh, agent_ax)   # local agents
    ash = (A,) if multi else ()

    def _plan_for(B):
        """The global (A, B) whose launch plan a block's kernels take."""
        return None if mesh is None else (A_glob, B * lanes_k)

    # (B, A, ...) <-> (B*A, ...) batch-major: the LS's native lane order
    def _flat(tree, B):
        if not multi:
            return tree
        return tree_map(lambda l: l.reshape((B * A,) + l.shape[2:]), tree)

    def _unflat(tree, B):
        if not multi:
            return tree
        return tree_map(lambda l: l.reshape((B, A) + l.shape[1:]), tree)

    def _batch(state: IALSState) -> int:
        return tree_leaves(state.ls_state)[0].shape[0]

    def _unflat_glob(tree, B):
        if not multi:
            return tree
        return tree_map(lambda l: l.reshape((B, A_glob) + l.shape[1:]), tree)

    def reset(gen: torch.Generator, n_envs: int):
        """(n_envs global) -> the state, this rank's block under a mesh."""
        state = IALSState(
            ls_state=_unflat_glob(local_env.reset(gen, n_envs * A_glob),
                                  n_envs),
            aip_state=influence.init_state(aip_cfg, (n_envs,) + ash_glob,
                                           device=_device()))
        if mesh is None:
            return state
        sharding.require_lane_sharding(n_envs, A_glob, mesh)
        return sharding.shard_ials_state(state, mesh, A_glob)

    def noise_fn(gen: torch.Generator, n_envs: int):
        """(n_envs global) -> one tick's bits and LS noise (the LS noise's
        (n_envs * A, ...) lanes batch-major), this rank's block under a
        mesh."""
        bits = random_bits((n_envs,) + ash_glob + (M,), gen)
        env = (local_env.noise_fn(gen, n_envs * A_glob)
               if local_env.noise_fn is not None else None)
        if mesh is None:
            return {"bits": bits, "env": env}
        sharding.require_lane_sharding(n_envs, A_glob, mesh)
        env = _flat(sharding.shard_ials_state(_unflat_glob(env, n_envs),
                                              mesh, A_glob),
                    n_envs // lanes_k)
        return {"bits": sharding.shard_ials_state(bits, mesh, A_glob),
                "env": env}

    def step_det(state: IALSState, actions, noise):
        B = actions.shape[0]
        ls_flat = _flat(state.ls_state, B)
        a_flat = actions.reshape(B * A) if multi else actions
        d_t = local_env.dset_fn(ls_flat, a_flat)        # (B*A, Dd)
        if multi:
            d_t = d_t.reshape(B, A, -1)
        if marg is None:
            sample = (influence.step_sample_multi if multi
                      else influence.step_sample)
            logits, new_aip, u = sample(aip_params, aip_cfg,
                                        state.aip_state, d_t, noise["bits"])
            probs = fast_sigmoid(logits)
        else:
            if stateless:
                new_aip = state.aip_state
            else:   # eager: ops.aip_step would also draw a u to be ignored
                fwd = influence.step_multi if multi else influence.step
                _, new_aip = fwd(aip_params, aip_cfg, state.aip_state, d_t)
            probs = torch.broadcast_to(marg, (B,) + ash + (M,))
            u = (uniform_from_bits(noise["bits"]) < probs).to(torch.float32)
        u_flat = u.reshape(B * A, M) if multi else u
        ls2, obs, r, info = local_env.step_det(ls_flat, a_flat, u_flat,
                                               noise["env"])
        info = dict(_unflat(info, B))
        info["u"] = u
        info["u_probs"] = probs
        if multi:
            obs, r = obs.reshape(B, A, -1), r.reshape(B, A)
        return IALSState(ls_state=_unflat(ls2, B), aip_state=new_aip), \
            obs, r, info

    def step(state: IALSState, actions, gen: torch.Generator):
        B = actions.shape[0] * (1 if mesh is None else lanes_k)
        return step_det(state, actions, noise_fn(gen, B))

    # --- whole-horizon path: agent-major lanes at the kernel boundary ---
    # (the module's folds, with the agent axis kept at one local agent)
    def _lf(x):
        return lane_fold(x, A) if A > 1 or not multi else x[:, 0]

    def _lu(x, B):
        return lane_unfold(x, A, B) if A > 1 or not multi else x[:, None]

    def _sf(x):
        return stream_fold(x, A) if A > 1 or not multi else x[:, :, 0]

    def _su(x, B):
        return (stream_unfold(x, A, B) if A > 1 or not multi
                else x[:, :, None])

    def _noise_fold(x, B):   # (T, B*A, ...) batch-major -> (T, A*B, ...)
        if not multi:
            return x
        return _sf(x.reshape((x.shape[0], B, A) + x.shape[2:]))

    def _io(state, noise, B):
        return kernel_io(local_env,
                         tree_map(_lf, state.ls_state),
                         tree_map(lambda l: _noise_fold(l, B),
                                  noise["env"]))

    def _stacked(tree):
        """aip_params with a leading (A,) axis (A = 1 stacks on the fly)."""
        return tree if multi else tree_map(lambda l: l[None], tree)

    def _aip_weights(p):
        if aip_cfg.kind == "gru":
            return (p["gru"]["wx"], p["gru"]["wh"], p["gru"]["b"],
                    p["head"]["w"], p["head"]["b"])
        return (p["l1"]["w"], p["l1"]["b"], p["l2"]["w"], p["l2"]["b"],
                p["head"]["w"], p["head"]["b"])

    def _aip_fold(aip_state):             # -> (L, K) flat kernel state
        s = _lf(aip_state)
        return s.reshape(s.shape[0], -1)

    def _aip_unfold(sT, B):
        if aip_cfg.kind == "fnn":
            sT = sT.reshape(-1, aip_cfg.stack, aip_cfg.d_in)
        return _lu(sT, B)

    def loop_rollout(state: IALSState, actions, noise):
        """The F-IALS horizon: a loop of ``step_det`` over the T-stacked
        noise (the JAX engine's scan)."""
        rews = []
        for t in range(actions.shape[0]):
            state, _, r, _ = step_det(state, actions[t],
                                      index_tree(noise, t))
            rews.append(r)
        return state, torch.stack(rews)

    def rollout(state: IALSState, actions, noise):
        """(state, actions (T, B[, A]), noise = T-stacked ``noise_fn``) ->
        (state, rewards (T, B[, A])): the whole horizon in one kernel."""
        from repro_torch.kernels import ops
        B = _batch(state)
        io = _io(state, noise, B)
        fn = (ops.ials_rollout_multi if aip_cfg.kind == "gru"
              else ops.fnn_rollout)
        final, sT, rews = fn(
            io.ls, _aip_fold(state.aip_state),
            *_aip_weights(_stacked(aip_params)),
            _sf(actions).to(torch.int32), _sf(noise["bits"]), io.noise,
            n_agents=A, tick_fn=io.tick_fn, dset_fn=io.dset_fn,
            domain=domain, plan_for=_plan_for(B))
        ls_T = tree_map(lambda l: _lu(l, B), io.decode(final))
        return (IALSState(ls_state=ls_T, aip_state=_aip_unfold(sT, B)),
                _su(rews, B))

    def policy_rollout(state: IALSState, frames, t_in_ep, pol_params,
                       gumbel, noise, reset_states, *, episode_len: int,
                       fast_gates: bool):
        """T PPO acting ticks as ONE ``kernels.ops.policy_rollout`` call.
        Pre-drawn ``gumbel`` (T, B, [A,] n_actions), ``noise`` (T-stacked
        ``noise_fn``), ``reset_states`` (T-stacked ``reset``). Invariant
        0 <= t_in_ep < episode_len on entry; resets restore the streamed
        LS state and zero the AIP state."""
        from repro_torch.kernels import ops
        from repro_torch.rl.ppo import flat_policy_weights
        B = _batch(state)
        T = gumbel.shape[0]
        io = _io(state, noise, B)
        rls = io.encode(tree_leaves(tree_map(_sf, reset_states.ls_state)))
        ticks = (t_in_ep[None, :] + 1
                 + torch.arange(T, dtype=torch.int32,
                                device=t_in_ep.device)[:, None])
        done_env = (ticks % episode_len) == 0             # (T, B)
        t_out = ((t_in_ep + T) % episode_len).to(torch.int32)
        done_lanes = done_env.to(torch.int32)
        if multi:                       # lane a*B + b <-> env b
            done_lanes = done_lanes.repeat(1, A)
        frames_l = _lf(frames)                            # (L, k, d)
        stack, d_obs = frames_l.shape[-2], frames_l.shape[-1]
        fin, sT, fT, x, a, logits, v, r = ops.policy_rollout(
            io.ls, _aip_fold(state.aip_state),
            frames_l.reshape(frames_l.shape[0], -1),
            _aip_weights(_stacked(aip_params)),
            flat_policy_weights(pol_params), _sf(gumbel),
            _sf(noise["bits"]), done_lanes, io.noise, rls,
            kind=aip_cfg.kind, n_agents=A, fast_gates=fast_gates,
            tick_fn=io.tick_fn, dset_fn=io.dset_fn, obs_fn=io.obs_fn,
            domain=domain, plan_for=_plan_for(B))
        ls_T = tree_map(lambda l: _lu(l, B), io.decode(fin))
        frames_T = _lu(fT.reshape(-1, stack, d_obs), B)
        r_u = _su(r, B)
        done_b = torch.broadcast_to(
            done_env.reshape(done_env.shape + (1,) * (1 if multi else 0)),
            r_u.shape).to(torch.float32)
        out = {"x": _su(x, B), "a": _su(a, B), "logits": _su(logits, B),
               "v": _su(v, B), "r": r_u, "done": done_b}
        return (IALSState(ls_state=ls_T, aip_state=_aip_unfold(sT, B)),
                frames_T, t_out, out)

    def observe(state: IALSState):
        B = _batch(state)
        obs = local_env.observe(_flat(state.ls_state, B))
        return obs.reshape(B, A, -1) if multi else obs

    if marg is not None:
        return BatchedEnv(spec=spec, reset=reset, step=step,
                          observe=observe, rollout=loop_rollout,
                          noise_fn=noise_fn, step_det=step_det, mesh=mesh)
    has_horizon = (local_env.rollout_tick is not None
                   and local_env.noise_fn is not None)
    return BatchedEnv(
        spec=spec, reset=reset, step=step, observe=observe,
        rollout=rollout if has_horizon else None, noise_fn=noise_fn,
        step_det=step_det,
        policy_rollout=(policy_rollout
                        if has_horizon and local_env.obs_fn is not None
                        else None),
        mesh=mesh)


def make_batched_ials(local_env: BatchedLocalEnv, aip_params,
                      aip_cfg: influence.AIPConfig, *,
                      fixed_marginal: Optional[float] = None,
                      fixed_marginal_vec=None,
                      stateless: bool = False, mesh=None) -> BatchedEnv:
    """The single-agent engine: ``make_unified_ials`` at A = 1."""
    return make_unified_ials(local_env, aip_params, aip_cfg, n_agents=1,
                             fixed_marginal=fixed_marginal,
                             fixed_marginal_vec=fixed_marginal_vec,
                             stateless=stateless, mesh=mesh)


def make_batched_multi_ials(local_env: BatchedLocalEnv, aip_params,
                            aip_cfg: influence.AIPConfig, n_agents: int,
                            *, fixed_marginal: Optional[float] = None,
                            fixed_marginal_vec=None,
                            stateless: bool = False,
                            mesh=None) -> BatchedEnv:
    """The Distributed IALS, one AIP per agent region (``aip_params``
    leaves (A, ...) stacked): ``make_unified_ials`` with the agent axis
    on."""
    return make_unified_ials(local_env, aip_params, aip_cfg,
                             n_agents=n_agents,
                             fixed_marginal=fixed_marginal,
                             fixed_marginal_vec=fixed_marginal_vec,
                             stateless=stateless, mesh=mesh)
