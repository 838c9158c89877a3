"""Batched environment protocol (counterpart of ``repro/envs/api.py``).

Both simulators are natively batched: every state leaf carries a leading
env axis, ``reset(gen, n)`` builds n environments, and one step advances
the whole batch. Randomness comes from an explicit ``torch.Generator`` or
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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import dataclasses

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


def squeeze_agent_env(multi: BatchedEnv, name: str) -> BatchedEnv:
    """A 1-agent batched GS through the single-agent protocol: actions
    (B,), and the agent axis squeezed off obs / reward / info."""
    spec = dataclasses.replace(multi.spec, name=name, n_agents=1)

    def observe(state):
        return multi.observe(state)[:, 0]

    def step_det(state, actions, noise):
        state, obs, r, info = multi.step_det(state, actions[:, None], noise)
        return state, obs[:, 0], r[:, 0], {k: v[:, 0]
                                           for k, v in info.items()}

    def step(state, actions, gen):
        return step_det(state, actions,
                        multi.noise_fn(gen, tree_leaves(state)[0].shape[0]))

    return BatchedEnv(spec=spec, reset=multi.reset, step=step,
                      observe=observe, noise_fn=multi.noise_fn,
                      step_det=step_det)


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
