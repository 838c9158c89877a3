"""Environment protocols (counterpart of ``repro/envs/api.py``).

Batched protocol (``BatchedEnv``, ``BatchedLocalEnv``, the domains' native
simulators): every state leaf carries a leading env axis, ``reset(gen,
n)`` builds n environments, and one step advances the whole batch. Randomness comes from an explicit ``torch.Generator`` or
arrives pre-drawn:

GS:  ``step(state, actions, gen) == step_det(state, actions,
     noise_fn(gen, B))`` — ``step_det`` is the deterministic remainder.
LS:  ``step(state, actions, u, gen)``; ``rollout_tick(state, actions, u,
     noise) -> (state, reward)`` is the transition+reward core the CUDA
     kernels carry as a device functor (``kernel_domain`` names it).

``BatchedEnv.rollout(state, actions, noise)`` and ``policy_rollout`` are
the whole-horizon layer of the unified IALS engine (``core/engine.py``):
``noise`` is the T-stacked ``noise_fn`` pytree (``horizon_noise``), and
everything a whole horizon needs is passed in, so the parity tests can
hand the same streams to the JAX package and to the port.

``kernel_codec`` is the one place the kernel-boundary dtype rules live:
bool and int8 leaves travel as int32 through the CUDA kernels.

Scalar protocol (one simulator, no env axis): ``Env`` and ``LocalEnv``.
Each splits its tick the same way: ``noise_fn(gen, shape=())`` draws one
tick's randomness and ``step_det`` is the deterministic rest, so
``step(s, a, gen) == step_det(s, a, noise_fn(gen))``. ``reset(gen,
shape=())`` and ``noise_fn`` draw for a leading ``shape`` of simulators
in one call; ``step_det``, ``observe`` and ``dset_fn`` see one simulator.
That split is what lets ``batch_env`` / ``batch_local_env`` lift a scalar
env into the batched protocol with ``torch.func.vmap``: the B envs' noise
and reset states are drawn outside the vmap (a random op inside it
raises), and only the deterministic functions are vmapped. Those are
plain torch ops: no ``.item()``, no Python branch on a tensor value, no
in-place write into a captured tensor, no CUDA extension (which has no
batching rule). ``unbatch_env`` goes the other way, ``as_batched`` takes
either protocol, and ``env_rollout`` runs a whole horizon by the
reference's dispatch order (native ``rollout``, then a loop of
``step_det`` on pre-drawn noise, then a loop of ``step``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    n_actions: int
    n_influence: int      # M influence source bits
    dset_dim: int         # d-set feature size
    dset_full_dim: int    # d-set + confounders (ablation input)
    n_agents: int = 1     # agent axis of obs/action/reward/info


class KernelDomain(NamedTuple):
    """Which device functor the CUDA kernels run for a local simulator,
    and its constants: the counterpart of tracing its ``rollout_tick`` /
    ``dset_fn`` / ``obs_fn`` into a Pallas body. ``"traffic"`` reads
    ``lane_len`` and ``ext_influence``; ``"warehouse"`` the region's side
    ``region``, ``max_age`` and ``vanish_after``."""
    name: str
    lane_len: int = 0
    ext_influence: bool = False
    region: int = 0
    max_age: int = 0
    vanish_after: int = 0


class Env(NamedTuple):
    spec: EnvSpec
    reset: Callable        # (gen, shape=()) -> state, leaves lead `shape`
    step: Callable         # (state, action, gen) -> (state, obs, r, info)
    observe: Callable      # state -> obs
    noise_fn: Any = None   # (gen, shape=()) -> one tick's randomness
    step_det: Any = None   # (state, action, noise) -> (state, obs, r, info)


class LocalEnv(NamedTuple):
    spec: EnvSpec
    reset: Callable        # (gen, shape=()) -> state
    step: Callable         # (state, action, u (M,), gen) -> (state, obs, r,
    #                        info)
    observe: Callable
    dset_fn: Callable      # (state, action) -> d_t (dset_dim,) f32
    noise_fn: Any = None   # (gen, shape=()) -> the LS's own randomness
    step_det: Any = None   # (state, action, u, noise) -> (state, obs, r,
    #                        info)


class BatchedEnv(NamedTuple):
    spec: EnvSpec
    reset: Callable        # (gen, n_envs) -> state with (B, ...) leaves
    step: Callable         # (state, actions, gen) -> (state, obs, r, info)
    observe: Callable      # state -> obs (B, ...)
    rollout: Any = None    # (state, actions (T, B[, A]), noise) ->
    #                        (state, rewards (T, B[, A]))
    noise_fn: Any = None   # (gen, n_envs) -> one tick's randomness pytree
    step_det: Any = None   # (state, actions, noise) -> (state, obs, r, info)
    policy_rollout: Any = None  # the actor-in-the-loop horizon (engine)
    mesh: Any = None       # set: reset / noise_fn take the global n_envs
    #                        and return this rank's block, and every other
    #                        entry works on blocks (distributed/sharding.py)


class BatchedLocalEnv(NamedTuple):
    spec: EnvSpec
    reset: Callable        # (gen, n_envs) -> state
    step: Callable         # (state, actions, u (B, M), gen) -> (state, obs,
    #                        r, info)
    observe: Callable
    dset_fn: Callable      # (state, actions) -> d_t (B, dset_dim) f32
    noise_fn: Any = None   # (gen, n_envs) -> the LS's own randomness
    step_det: Any = None   # (state, actions, u, noise) -> (state, obs, r,
    #                        info)
    rollout_tick: Any = None  # (state, actions, u, noise) -> (state, r)
    obs_fn: Any = None     # state -> obs (B, obs_dim) f32
    kernel_domain: Any = None  # KernelDomain of the CUDA device functor


def squeeze_agent_env(multi, name: str):
    """A 1-agent multi-agent GS through the single-agent protocol, in
    either protocol: a scalar ``Env`` takes a 0-d action and drops the
    leading agent axis of obs / reward / info; a ``BatchedEnv`` takes
    (B,) actions and drops the agent axis after the env axis."""
    spec = dataclasses.replace(multi.spec, name=name, n_agents=1)
    if isinstance(multi, BatchedEnv):
        def pick(x):
            return x[:, 0]

        def lift(a):
            return a[:, None]
    else:
        def pick(x):
            return x[0]

        def lift(a):
            return torch.as_tensor(a)[None]

    def observe(state):
        return pick(multi.observe(state))

    def step_det(state, actions, noise):
        state, obs, r, info = multi.step_det(state, lift(actions), noise)
        return state, pick(obs), pick(r), {k: pick(v)
                                           for k, v in info.items()}

    if isinstance(multi, BatchedEnv):
        def step(state, actions, gen):
            return step_det(state, actions,
                            multi.noise_fn(gen, _batch_size(state)))

        return BatchedEnv(spec=spec, reset=multi.reset, step=step,
                          observe=observe, noise_fn=multi.noise_fn,
                          step_det=step_det)

    def step(state, action, gen):
        return step_det(state, action, multi.noise_fn(gen))

    return Env(spec=spec, reset=multi.reset, step=step, observe=observe,
               noise_fn=multi.noise_fn, step_det=step_det)


def _batch_size(state) -> int:
    return tree_leaves(state)[0].shape[0]


def agent_placement(agents, G: int, device):
    """(A, 2) grid cells -> (A, G, G) int64 one-hots: a scalar GS puts
    each agent's action on its own cell by a product and a sum (no
    scatter, so its step stays vmappable)."""
    A = agents.shape[0]
    sel = torch.zeros((A, G, G), dtype=torch.long, device=device)
    sel[torch.arange(A, device=device), agents[:, 0], agents[:, 1]] = 1
    return sel


# dtypes the CUDA kernels take as int32 at their boundary
KERNEL_ENC_DTYPES = (torch.bool, torch.int8)


def kernel_codec(dtypes):
    """leaf dtypes -> (encode, decode) for the kernel boundary: bool/int8
    leaves become int32 inside the kernels, ``decode`` restores them."""

    def encode(vals):
        return tuple(v.to(torch.int32) if v.dtype in KERNEL_ENC_DTYPES
                     else v for v in vals)

    def decode(vals):
        return tuple(v.to(dt) for v, dt in zip(vals, dtypes))

    return encode, decode


def pad_mask(n_valid: int, slot: int, device=None) -> torch.Tensor:
    """(slot,) bool lane-validity mask: True for the n_valid real lanes,
    False for the pad lanes. ``kernels/ops.py::serve_forward`` applies it
    at the kernel boundary, so pad lanes never perturb real lanes."""
    return torch.arange(slot, device=device) < n_valid


def pad_lanes(tree, slot: int, fill: str = "edge"):
    """Pack a ragged batch into a fixed slot: every (n, ...) leaf (n >= 1)
    becomes (slot, ...), lanes [0, n) the real rows and [n, slot) pads.
    ``fill="edge"`` replicates lane 0, ``fill="zero"`` writes zeros; pad
    outputs are garbage by contract either way (``pad_mask`` is the
    guarantee, not the fill)."""
    if fill not in ("edge", "zero"):
        raise ValueError(f"unknown fill mode: {fill!r}")

    def pad(leaf):
        leaf = torch.as_tensor(leaf)
        n = leaf.shape[0]
        if n > slot:
            raise ValueError(f"ragged batch of {n} rows does not fit a "
                             f"{slot}-lane slot")
        rows = (leaf[:1].expand((slot - n,) + leaf.shape[1:])
                if fill == "edge" else
                leaf.new_zeros((slot - n,) + leaf.shape[1:]))
        return torch.cat([leaf, rows], dim=0)

    return tree_map(pad, tree)


def stack_trees(trees):
    """A list of structurally equal pytrees -> one pytree of stacked
    leaves (leading axis = list index)."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def horizon_noise(noise_fn, generator: torch.Generator, T: int,
                  n_envs: int):
    """A whole horizon's randomness: leaf t is ``noise_fn(gen, n_envs)``
    at tick t, stacked along a leading T axis."""
    return stack_trees([noise_fn(generator, n_envs) for _ in range(T)])


def index_tree(tree, t: int):
    """Tick ``t`` of a T-stacked pytree."""
    return tree_map(lambda l: l[t], tree)


# ---------------------------------------------------------------------------
# scalar <-> batched adapters
# ---------------------------------------------------------------------------

def _in_dims(x):
    """``torch.func.vmap`` in_dims for an argument pytree: 0 on every
    tensor, None where the tree holds None (a deterministic env's noise)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _in_dims(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        dims = [_in_dims(v) for v in x]
        return type(x)(*dims) if hasattr(x, "_fields") else type(x)(dims)
    return 0


def vmapped(fn):
    """``fn`` over one simulator -> ``fn`` over a leading (B,) axis of
    every tensor argument (``torch.func.vmap``; None arguments pass
    through)."""
    def run(*args):
        return torch.func.vmap(fn, in_dims=tuple(_in_dims(a)
                                                 for a in args))(*args)
    return run


def _require_split(env, what):
    if env.step_det is None or env.noise_fn is None:
        raise ValueError(f"{what} lifts a scalar env through its noise_fn"
                         f" / step_det split; {env.spec.name!r} has none")


def batch_env(env: Env) -> BatchedEnv:
    """vmap adapter: a scalar ``Env`` through the batched protocol.
    ``reset`` and ``noise_fn`` draw for all B envs in one call (outside
    the vmap); ``step_det`` and ``observe`` are vmapped. ``noise_fn`` and
    ``step_det`` are filled, so PPO's pre-drawn streams
    (``ppo.draw_rollout_streams``) work on the lifted env."""
    _require_split(env, "batch_env")
    v_det = vmapped(env.step_det)

    def reset(gen, n_envs: int):
        return env.reset(gen, (n_envs,))

    def noise_fn(gen, n_envs: int):
        return env.noise_fn(gen, (n_envs,))

    def step(state, actions, gen):
        return v_det(state, actions, noise_fn(gen, _batch_size(state)))

    return BatchedEnv(spec=env.spec, reset=reset, step=step,
                      observe=vmapped(env.observe), noise_fn=noise_fn,
                      step_det=v_det)


def batch_local_env(env: LocalEnv) -> BatchedLocalEnv:
    """vmap adapter for the LS signature, as ``batch_env`` (the domains'
    native batched LS are the hot path; this lift has no device functor,
    so an engine over it takes no kernel route)."""
    _require_split(env, "batch_local_env")
    v_det = vmapped(env.step_det)

    def reset(gen, n_envs: int):
        return env.reset(gen, (n_envs,))

    def noise_fn(gen, n_envs: int):
        return env.noise_fn(gen, (n_envs,))

    def step(state, actions, u, gen):
        return v_det(state, actions, u, noise_fn(gen, _batch_size(state)))

    return BatchedLocalEnv(spec=env.spec, reset=reset, step=step,
                           observe=vmapped(env.observe),
                           dset_fn=vmapped(env.dset_fn), noise_fn=noise_fn,
                           step_det=v_det)


def as_batched(env) -> BatchedEnv:
    """Env | BatchedEnv -> BatchedEnv (identity when already batched)."""
    if isinstance(env, BatchedEnv):
        return env
    return batch_env(env)


def env_rollout(benv: BatchedEnv, state, actions, noise=None, *,
                generator: torch.Generator = None):
    """Whole-horizon rollout: actions (T, B, ...) -> (final state, rewards
    (T, B, ...)). ``noise`` is the T-stacked ``noise_fn`` pytree
    (``horizon_noise``); left None, it is drawn in bulk from
    ``generator``. Dispatch order, as the reference's:
      1. the env's native ``rollout`` (the engine's one kernel launch);
      2. a loop of ``step_det`` over the pre-drawn noise;
      3. a loop of ``step``, drawing from ``generator`` tick by tick
         (an env without the ``noise_fn`` / ``step_det`` split).
    Routes 2 and 3 agree exactly when ``noise`` is what ``generator``
    would draw; route 1 agrees up to the kernel's decision flips."""
    T = actions.shape[0]
    split = benv.step_det is not None and benv.noise_fn is not None
    if split and noise is None:
        noise = horizon_noise(benv.noise_fn, generator, T,
                              _batch_size(state))
    if benv.rollout is not None:
        return benv.rollout(state, actions, noise)
    rews = []
    for t in range(T):
        if split:
            state, _, r, _ = benv.step_det(state, actions[t],
                                           index_tree(noise, t))
        else:
            state, _, r, _ = benv.step(state, actions[t], generator)
        rews.append(r)
    return state, torch.stack(rews)


def unbatch_env(benv: BatchedEnv, name: str | None = None) -> Env:
    """Squeeze adapter: a batched env through the scalar protocol. The
    state stays the B = 1 batched state inside (opaque to callers); every
    exposed leaf has the env axis squeezed off. A leading ``shape`` of
    simulators (``reset(gen, shape)``) is ``prod(shape)`` envs of the
    batched env, each keeping its own axis of 1."""
    spec = (dataclasses.replace(benv.spec, name=name) if name
            else benv.spec)

    def lead(tree, shape):
        return tree_map(lambda l: l.reshape(tuple(shape) + (1,)
                                            + l.shape[1:]), tree)

    def reset(gen, shape=()):
        return lead(benv.reset(gen, math.prod(shape)), shape)

    def noise_fn(gen, shape=()):
        return lead(benv.noise_fn(gen, math.prod(shape)), shape)

    def step_det(state, action, noise):
        state, obs, r, info = benv.step_det(
            state, torch.as_tensor(action)[None], noise)
        return state, obs[0], r[0], {k: v[0] for k, v in info.items()}

    def step(state, action, gen):
        state, obs, r, info = benv.step(state, torch.as_tensor(action)[None],
                                        gen)
        return state, obs[0], r[0], {k: v[0] for k, v in info.items()}

    def observe(state):
        return benv.observe(state)[0]

    split = benv.step_det is not None and benv.noise_fn is not None
    return Env(spec=spec, reset=reset, step=step, observe=observe,
               noise_fn=noise_fn if split else None,
               step_det=step_det if split else None)
