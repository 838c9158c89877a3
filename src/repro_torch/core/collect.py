"""Algorithm 1: collect a (d_t, u_t) dataset from the global simulator
(counterpart of ``repro/core/collect.py``).

Episodes are the GS batch: all ``n_episodes`` advance together for
``ep_len`` ticks under the exploratory policy pi_0 (uniform random, the
support condition of paper §4.2). A multi-agent GS yields every agent's
pairs at once; ``per_agent`` moves the agent axis first, the layout
``influence.train_aip_batched`` consumes. A scalar ``Env`` is collected
through ``envs.api.as_batched`` (the vmap adapter).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.envs.api import as_batched


@torch.no_grad()
def collect_dataset(env, generator: torch.Generator, *, n_episodes: int,
                    ep_len: int, policy: Optional[Callable] = None,
                    dset_key: str = "dset") -> Dict[str, torch.Tensor]:
    """-> {"d": (N, T, [A,] Dd), "u": (N, T, [A,] M), "reward": (N, T,
    [A])}. ``env`` is a ``BatchedEnv`` or a scalar ``Env``.
    ``policy(generator, obs (N, [A,] obs_dim)) -> actions`` defaults to
    pi_0, uniform random actions. ``dset_key`` picks "dset" (the
    d-separating set) or "dset_full" (d-set + confounders, the App. B
    ablation input)."""
    env = as_batched(env)
    A = env.spec.n_agents
    a_shape = (n_episodes, A) if A > 1 else (n_episodes,)
    state = env.reset(generator, n_episodes)
    obs = env.observe(state) if policy is not None else None
    ds, us, rs = [], [], []
    for _ in range(ep_len):
        if policy is None:
            a = torch.randint(0, env.spec.n_actions, a_shape,
                              generator=generator, device=generator.device)
        else:
            a = policy(generator, obs)
        state, obs, r, info = env.step(state, a, generator)
        ds.append(info[dset_key])
        us.append(info["u"])
        rs.append(r)
    return {"d": torch.stack(ds, 1), "u": torch.stack(us, 1),
            "reward": torch.stack(rs, 1)}


def per_agent(data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """(N, T, A, ...) multi-agent collection -> (A, N, T, ...)."""
    return {k: torch.movedim(v, 2, 0).contiguous() for k, v in data.items()}


def empirical_marginal(us: torch.Tensor, *,
                       per_agent: bool = False) -> torch.Tensor:
    """P(u) per head from collected data. (N, T, M) -> (M,); with
    ``per_agent`` the (A, N, T, M) layout -> (A, M)."""
    if per_agent:
        if us.dim() != 4:
            raise ValueError(f"per_agent expects (A, N, T, M), got "
                             f"{tuple(us.shape)}")
        return us.mean(dim=(1, 2))
    return us.reshape(-1, us.shape[-1]).mean(0)
