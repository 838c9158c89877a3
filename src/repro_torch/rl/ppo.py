"""PPO (Schulman et al. 2017), the paper's RL algorithm (§5.1), in torch
(counterpart of ``repro/rl/ppo.py``).

Policies are FNNs over a stack of the last k observations. One training
iteration = a rollout over ``n_envs`` environments (and A agents, the
agent axis riding along as an extra batch dimension of one
parameter-shared policy) + GAE + clipped-objective minibatch epochs.

The rollout's randomness is drawn before the horizon, as the JAX
package's hoisted path draws it: per-tick Gumbel noise for action
sampling (``gumbel_argmax``), the env's per-tick noise and the per-tick
reset states (``draw_rollout_streams``). ``rollout`` takes those streams
ready-made when the caller passes them (the parity tests hand it the
ones the JAX package drew), and the learner takes its per-epoch
minibatch permutations the same way. Two routes:
  1. the env's ``policy_rollout`` (the unified IALS engine sets it): the
     whole acting loop is ONE ``kernels.ops.policy_rollout`` call, the
     CUDA kernel on the card;
  2. otherwise (the GS, ``--simulator gs``) the plain loop below.

Every entry point takes a ``BatchedEnv`` or a scalar ``Env`` (lifted by
``envs.api.as_batched``, the vmap adapter). ``make_train_iteration`` and
``make_evaluator`` are the reference's constructors: an optimizer and its
iteration, and a greedy evaluator (not cached: it compiles nothing).

Lane data parallelism (``mesh=``, a ``DeviceMesh`` of
``launch/mesh.py::make_host_mesh``, one process a rank): the env is made
for the mesh (``engine.make_unified_ials(mesh=)``, or
``distributed/sharding.py::shard_env`` for the GS), so its resets and
noise are this rank's blocks of the global draws; the Gumbel noise is
drawn globally and sliced the same way. The rollout runs on the rank's
block, then its batch and final frames are gathered, so ``v_last`` and
the learner see the global batch: the learner runs replicated, on every
rank with the same generator, and gives the one-process parameters,
optimizer state and metrics bit for bit, without an all-reduce whose
order would differ. The rollout state stays a block (``shard_rollout``
/ ``gather_rollout`` move it to and from the global layout).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.envs.api import (as_batched, horizon_noise, index_tree,
                                  stack_trees)
from repro_torch.nn.act import fast_tanh
from repro_torch.nn.module import dense, dense_init
from repro_torch.optim.adamw import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class PPOConfig:
    obs_dim: int
    n_actions: int
    frame_stack: int = 1
    hidden: int = 128
    n_envs: int = 16
    rollout_len: int = 128
    episode_len: int = 256        # periodic env reset (episodic tasks)
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    lr: float = 3e-4
    epochs: int = 4
    n_minibatches: int = 4
    n_agents: int = 1             # agent axis of the env (1 = none)
    fast_gates: bool = True       # rational tanh in the policy net

    @property
    def agent_shape(self) -> tuple:
        return (self.n_agents,) if self.n_agents > 1 else ()


# ---------------------------------------------------------------------------
# actor-critic network (FNN on frame-stacked obs)
# ---------------------------------------------------------------------------

def init_policy(cfg: PPOConfig, generator: torch.Generator, device=None):
    dev = device if device is not None else generator.device
    d_in = cfg.obs_dim * cfg.frame_stack
    return {
        "l1": dense_init(generator, d_in, cfg.hidden, bias=True, device=dev),
        "l2": dense_init(generator, cfg.hidden, cfg.hidden, bias=True,
                         device=dev),
        "pi": dense_init(generator, cfg.hidden, cfg.n_actions, bias=True,
                         scale=0.01, device=dev),
        "v": dense_init(generator, cfg.hidden, 1, bias=True, scale=0.1,
                        device=dev),
    }


def flat_policy_weights(params):
    """The flat ``(w1, b1, w2, b2, piw, pib, vw, vb)`` tuple: the policy
    ABI of the ``policy_rollout`` kernel and its plain version."""
    return (params["l1"]["w"], params["l1"]["b"],
            params["l2"]["w"], params["l2"]["b"],
            params["pi"]["w"], params["pi"]["b"],
            params["v"]["w"], params["v"]["b"])


def stack_policy_weights(params_list):
    """N checkpoints' ``flat_policy_weights`` tuples -> one tuple of
    (N, ...) tensors: the cross-policy serving ABI of
    ``kernels/ops.py::serve_forward_multi`` (index n of every leading axis
    is ``params_list[n]``). All checkpoints share one architecture;
    ``torch.stack`` raises otherwise."""
    flats = [flat_policy_weights(p) for p in params_list]
    return tuple(torch.stack(ws) for ws in zip(*flats))


def policy_forward(params, x, *, fast_gates: bool):
    """-> (logits (..., n_actions), value (...)); hidden layers through the
    rational tanh when ``fast_gates`` (exact tanh otherwise)."""
    act = fast_tanh if fast_gates else torch.tanh
    h = act(dense(params["l1"], x))
    h = act(dense(params["l2"], h))
    return dense(params["pi"], h), dense(params["v"], h)[..., 0]


# ---------------------------------------------------------------------------
# action sampling on pre-drawn Gumbel noise
# ---------------------------------------------------------------------------

def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_argmax(logits, g):
    """Gumbel-max sampling: argmax(logits + g) is a categorical draw."""
    return torch.argmax(logits + g, dim=-1)


# ---------------------------------------------------------------------------
# rollout with frame stacking + periodic resets
# ---------------------------------------------------------------------------

class RolloutState(NamedTuple):
    env_state: Any
    frames: torch.Tensor    # (n_envs, *agent_shape, k, obs_dim)
    t_in_ep: torch.Tensor   # (n_envs,) int32


def _stack_obs(frames):
    return frames.reshape(frames.shape[:-2] + (-1,))


def _seed_frames(obs, cfg: PPOConfig):
    """Frames of a fresh episode: zeros, the observation (n, [A,] obs_dim)
    last."""
    frames = torch.zeros(obs.shape[:-1] + (cfg.frame_stack, cfg.obs_dim),
                         dtype=torch.float32, device=obs.device)
    frames[..., -1, :] = obs
    return frames


def _mesh(env, mesh):
    """The mesh of a sharded call (None for a size-1 one); the env must
    have been made for it."""
    if mesh is None or sharding.mesh_size(mesh) == 1:
        return None
    if env.mesh is None:
        raise ValueError(
            f"a sharded rollout needs an env made for the mesh "
            f"(engine.make_unified_ials(mesh=) or sharding.shard_env); "
            f"{env.spec.name} draws its global lanes")
    return mesh


def shard_rollout(rs: RolloutState, mesh, n_agents: int = 1) -> RolloutState:
    """This rank's block of a global rollout state under the IALS rules
    (env lanes over the data axes, the agent axis of frames and engine
    state co-sharded over "model" when it divides). The state as it is
    for ``mesh=None`` or a size-1 mesh."""
    return sharding.shard_ials_state(rs, mesh, n_agents)


def gather_rollout(rs: RolloutState, mesh, n_agents: int,
                   n_envs: int) -> RolloutState:
    """The global rollout state of every rank's block (a collective): what
    a checkpoint holds, whatever the world size."""
    return sharding.gather_ials_state(rs, mesh, n_agents, n_envs)


@torch.no_grad()
def init_rollout_state(env, cfg: PPOConfig, generator: torch.Generator,
                       mesh=None) -> RolloutState:
    """The rollout state at its seeded init. An env made for a mesh gives
    this rank's block of it; with ``mesh`` and an env that draws its
    global lanes, the global state is made and ``shard_rollout`` keeps the
    rank's block (the reference's placement)."""
    env = as_batched(env)
    env_state = env.reset(generator, cfg.n_envs)
    frames = _seed_frames(env.observe(env_state), cfg)
    rs = RolloutState(env_state=env_state, frames=frames,
                      t_in_ep=torch.zeros((frames.shape[0],),
                                          dtype=torch.int32,
                                          device=frames.device))
    if env.mesh is not None:
        return rs
    return shard_rollout(rs, mesh, cfg.n_agents)


@torch.no_grad()
def draw_rollout_streams(env, cfg: PPOConfig,
                         generator: torch.Generator, mesh=None):
    """All of a rollout's randomness, drawn before the horizon: (Gumbel
    (T, n_envs, [A,] n_actions), T-stacked env noise, T-stacked reset
    states). Under a mesh, this rank's blocks of the global draws, the
    generator advancing as in the one-process run."""
    env = as_batched(env)
    mesh = _mesh(env, mesh)
    T = cfg.rollout_len
    gum = gumbel_noise(generator, (T, cfg.n_envs) + cfg.agent_shape
                       + (cfg.n_actions,))
    gum = sharding.shard_ials_stream(gum, mesh, cfg.n_envs, cfg.n_agents)
    env_noise = horizon_noise(env.noise_fn, generator, T, cfg.n_envs)
    resets = stack_trees([env.reset(generator, cfg.n_envs)
                          for _ in range(T)])
    return gum, env_noise, resets


def _where_done(done, new, old):
    return tree_map(lambda n, o: torch.where(
        done.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), new, old)


def _logp(logits, a):
    return torch.gather(F.log_softmax(logits, dim=-1), -1,
                        a.long()[..., None])[..., 0]


@torch.no_grad()
def rollout(env, cfg: PPOConfig, params, rs: RolloutState,
            generator: torch.Generator = None, streams=None, mesh=None):
    """-> (new RolloutState, batch with (T, n_envs, *agent_shape, ...)
    leaves, v_last). ``streams`` = ``draw_rollout_streams``'s triple;
    drawn from ``generator`` when not given. Under a mesh ``rs`` and
    ``streams`` are this rank's blocks, the returned state too; the batch
    and ``v_last`` are gathered (global)."""
    env = as_batched(env)
    mesh = _mesh(env, mesh)
    if streams is None:
        streams = draw_rollout_streams(env, cfg, generator, mesh)
    gum, env_noise, resets = streams
    if env.policy_rollout is not None:
        env_state, frames, t_in_ep, out = env.policy_rollout(
            rs.env_state, rs.frames, rs.t_in_ep, params, gum, env_noise,
            resets, episode_len=cfg.episode_len, fast_gates=cfg.fast_gates)
        batch = {"x": out["x"], "a": out["a"],
                 "logp": _logp(out["logits"], out["a"]), "v": out["v"],
                 "r": out["r"], "done": out["done"]}
        rs = RolloutState(env_state, frames, t_in_ep)
    else:
        rows = []
        for t in range(gum.shape[0]):
            x = _stack_obs(rs.frames)
            logits, value = policy_forward(params, x,
                                           fast_gates=cfg.fast_gates)
            a = gumbel_argmax(logits, gum[t])
            env_state, obs, r, _ = env.step_det(rs.env_state, a,
                                                index_tree(env_noise, t))
            frames = torch.cat([rs.frames[..., 1:, :], obs[..., None, :]],
                               dim=-2)
            tt = rs.t_in_ep + 1
            done = tt >= cfg.episode_len
            env_state = _where_done(done, index_tree(resets, t), env_state)
            frames0 = _seed_frames(env.observe(env_state), cfg)
            frames = torch.where(
                done.reshape((-1,) + (1,) * (frames.dim() - 1)), frames0,
                frames)
            tt = torch.where(done, torch.zeros_like(tt), tt)
            done_b = torch.broadcast_to(
                done.reshape((-1,) + (1,) * (r.dim() - 1)), r.shape)
            rows.append({"x": x, "a": a.to(torch.int32),
                         "logp": _logp(logits, a), "v": value, "r": r,
                         "done": done_b.to(torch.float32)})
            rs = RolloutState(env_state, frames, tt)
        batch = {k: torch.stack([row[k] for row in rows]) for k in rows[0]}
    # v_last on contiguous frames: a GEMM's algorithm may follow its
    # operand's strides, and the kernel route's unfolded frames are strided
    frames = rs.frames.contiguous()
    if mesh is not None:    # the global batch, v_last at the global shape
        batch = sharding.gather_ials_stream(batch, mesh, cfg.n_envs,
                                            cfg.n_agents)
        frames = sharding.gather_ials_state(frames, mesh, cfg.n_agents,
                                            cfg.n_envs)
    _, v_last = policy_forward(params, _stack_obs(frames),
                               fast_gates=cfg.fast_gates)
    return rs, batch, v_last


def gae(batch, v_last, gamma, lam):
    """Generalised advantage estimation, a reverse loop over T."""
    v, r, done = batch["v"], batch["r"], batch["done"]
    nonterm = 1.0 - done
    v_next = torch.cat([v[1:], v_last[None]], dim=0)
    delta = r + gamma * v_next * nonterm - v
    coeff = (gamma * lam) * nonterm
    adv = torch.zeros_like(v_last)
    advs = []
    for t in range(v.shape[0] - 1, -1, -1):
        adv = delta[t] + coeff[t] * adv
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + v


# ---------------------------------------------------------------------------
# PPO update
# ---------------------------------------------------------------------------

def ppo_loss(params, cfg: PPOConfig, mb):
    logits, v = policy_forward(params, mb["x"], fast_gates=cfg.fast_gates)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, mb["a"].long()[..., None])[..., 0]
    ratio = torch.exp(logp - mb["logp"])
    adv = mb["adv"]
    adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
    v_loss = torch.square(v - mb["ret"]).mean()
    ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg + cfg.value_coef * v_loss - cfg.entropy_coef * ent
    return total, {"pg_loss": pg, "v_loss": v_loss, "entropy": ent}


def make_optimizer(cfg: PPOConfig):
    return adamw(cfg.lr, weight_decay=0.0, b2=0.999, clip_norm=0.5)


def learner_update_fn(cfg: PPOConfig, opt):
    """-> ``learner_update(params, opt_state, batch, v_last, generator=None,
    perms=None) -> (params, opt_state, metrics)``: GAE + flatten +
    minibatch epochs. ``perms`` ((epochs, n_samples) permutations)
    replaces the draws from ``generator``."""

    def learner_update(params, opt_state, batch, v_last, generator=None,
                       perms=None):
        adv, ret = gae(batch, v_last, cfg.gamma, cfg.lam)
        total = batch["a"].numel()
        flat = {"x": batch["x"].reshape(total, -1),
                "a": batch["a"].reshape(total),
                "logp": batch["logp"].reshape(total),
                "adv": adv.reshape(total), "ret": ret.reshape(total)}
        n_mb = cfg.n_minibatches
        mb_size = total // n_mb
        dev = flat["x"].device
        epoch_losses = []
        for e in range(cfg.epochs):
            if perms is not None:
                perm = torch.as_tensor(perms[e], device=dev).long()
            else:
                perm = torch.randperm(total, generator=generator,
                                      device=generator.device).to(dev)
            perm = perm[:n_mb * mb_size]
            shuf = {k: v[perm].reshape((n_mb, mb_size) + v.shape[1:])
                    for k, v in flat.items()}
            mb_losses = []
            for i in range(n_mb):
                mb = {k: v[i] for k, v in shuf.items()}
                leaves = [l.detach().requires_grad_(True)
                          for l in tree_leaves(params)]
                loss, _ = ppo_loss(tree_unflatten(params, leaves), cfg, mb)
                grads = torch.autograd.grad(loss, leaves)
                params, opt_state, _ = opt.update(
                    tree_unflatten(params, grads), opt_state,
                    tree_unflatten(params, [l.detach() for l in leaves]))
                mb_losses.append(loss.detach())
            epoch_losses.append(torch.stack(mb_losses).mean())
        # means over contiguous copies: the order of the sum must not
        # follow the batch's strides (a gathered batch is contiguous, the
        # kernel route's unfolded one is not)
        metrics = {"loss": torch.stack(epoch_losses).mean(),
                   "mean_reward": batch["r"].contiguous().mean(),
                   "mean_value": batch["v"].contiguous().mean()}
        return params, opt_state, metrics

    return learner_update


def train_iteration_fn(env, cfg: PPOConfig, opt, mesh=None):
    """-> ``train_iteration(params, opt_state, rs, generator, streams=None,
    perms=None) -> (params, opt_state, rs, metrics)``: one rollout, then
    the learner update on its batch. ``mesh``: ``rs`` is this rank's block
    (checked against the rule at entry), the learner runs replicated on
    the gathered batch (the module docstring)."""
    env = as_batched(env)
    mesh = _mesh(env, mesh)
    learner_update = learner_update_fn(cfg, opt)

    def train_iteration(params, opt_state, rs: RolloutState, generator,
                        streams=None, perms=None):
        sharding.constrain_ials_state(rs, mesh, cfg.n_agents, cfg.n_envs)
        rs, batch, v_last = rollout(env, cfg, params, rs, generator,
                                    streams, mesh)
        params, opt_state, metrics = learner_update(
            params, opt_state, batch, v_last, generator, perms)
        return params, opt_state, rs, metrics

    return train_iteration


def make_train_iteration(env, cfg: PPOConfig, mesh=None):
    """-> (opt, ``train_iteration``): the optimizer of ``cfg`` and one PPO
    iteration on ``env`` (``train_iteration_fn``'s signature)."""
    opt = make_optimizer(cfg)
    return opt, train_iteration_fn(env, cfg, opt, mesh)


# ---------------------------------------------------------------------------
# greedy evaluation
# ---------------------------------------------------------------------------

def make_evaluator(env, cfg: PPOConfig, *, n_episodes: int = 8,
                   ep_len: int | None = None):
    """-> ``fn(params, generator) -> mean reward`` (a 0-d tensor, or
    (n_agents,) on a multi-agent env): the greedy policy over
    ``n_episodes`` episodes of ``ep_len`` ticks (default
    ``cfg.episode_len``), the episodes being the env batch."""
    benv = as_batched(env)
    ep_len = ep_len or cfg.episode_len

    @torch.no_grad()
    def run(params, generator: torch.Generator):
        state = benv.reset(generator, n_episodes)
        frames = _seed_frames(benv.observe(state), cfg)
        rews = []
        for _ in range(ep_len):
            logits, _ = policy_forward(params, _stack_obs(frames),
                                       fast_gates=cfg.fast_gates)
            state, obs, r, _ = benv.step(state, torch.argmax(logits, -1),
                                         generator)
            frames = torch.cat([frames[..., 1:, :], obs[..., None, :]],
                               dim=-2)
            rews.append(r)
        return torch.stack(rews).mean(0).mean(0)      # () or (n_agents,)

    return run


def evaluate(env, cfg: PPOConfig, params, generator: torch.Generator, *,
             n_episodes: int = 8, ep_len: int | None = None,
             per_agent: bool = False):
    """Mean per-step reward of the greedy policy on ``env`` (the paper's
    periodic evaluation on the GS); ``env`` a ``BatchedEnv`` or a scalar
    ``Env``. With ``per_agent`` on a multi-agent env -> the (n_agents,)
    means."""
    means = make_evaluator(env, cfg, n_episodes=n_episodes,
                           ep_len=ep_len)(params, generator)
    if per_agent and cfg.agent_shape:
        return means
    return float(means.mean())
