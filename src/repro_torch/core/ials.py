"""IALS on the scalar protocol (counterpart of ``repro/core/ials.py``,
paper Fig. 1 right, Alg. 2).

Composes a scalar local simulator with an AIP into something that looks
like a global simulator to the RL loop:

    step: 1. d_t = dset_fn(x_t, a_t)
          2. p   = sigmoid(I_theta(d_t | aip_state))   (or a fixed marginal)
          3. u_t ~ Bernoulli(p), drawn as ``uniform < p``
          4. x_t+1 = LS(x_t, a_t, u_t)

``make_ials`` is one simulator and ``make_multi_ials`` A of them, one AIP
each (the Distributed-IALS construction, stacked by ``torch.func.vmap``
over the agents). Both are ``envs.api.Env``: their ``noise_fn`` draws the
M float32 uniforms of the Bernoulli (``{"u": ...}``) beside the LS's own
noise (``"env"``), and ``step_det`` is the rest, plain torch (the AIP
through ``influence.step``, gates through ``fast_sigmoid``), so
``batch_env`` vmaps it. They are the loop baseline the unified engine is
measured against, and are kept on the vmap path on purpose.

``fixed_marginal`` / ``fixed_marginal_vec`` make an F-IALS (paper App.
E); ``stateless`` (F-IALS only) keeps the ignored AIP state at its init.

The batched production simulators live in ``core.engine``
(``make_unified_ials``); ``make_batched_ials`` and
``make_batched_multi_ials`` are re-exported here, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import influence
from repro_torch.core.engine import (IALSState, _check_stateless,  # noqa: F401
                                     make_batched_ials,
                                     make_batched_multi_ials,
                                     make_unified_ials)
from repro_torch.envs.api import Env, LocalEnv, vmapped
from repro_torch.nn.act import fast_sigmoid
from repro_torch.tree import tree_leaves


def _device(aip_params):
    return tree_leaves(aip_params)[0].device


def make_ials(local_env: LocalEnv, aip_params, aip_cfg: influence.AIPConfig,
              *, fixed_marginal: Optional[float] = None,
              fixed_marginal_vec=None, stateless: bool = False) -> Env:
    """-> ``Env`` with the GS signature over one LS and one AIP. Noise:
    ``{"u": (M,) uniforms, "env": the LS's noise}``; ``info`` carries
    ``u`` and ``u_probs``."""
    _check_stateless(stateless, fixed_marginal, fixed_marginal_vec)
    spec = dataclasses.replace(local_env.spec,
                               name=local_env.spec.name + "+ials")
    M = spec.n_influence
    dev = _device(aip_params)
    if fixed_marginal_vec is not None:
        marg = torch.as_tensor(fixed_marginal_vec, dtype=torch.float32,
                               device=dev)
    elif fixed_marginal is not None:
        marg = torch.full((M,), fixed_marginal, dtype=torch.float32,
                          device=dev)
    else:
        marg = None

    def reset(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        return IALSState(ls_state=local_env.reset(gen, shape),
                         aip_state=influence.init_state(aip_cfg, shape,
                                                        device=dev))

    def noise_fn(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        u = torch.rand(shape + (M,), generator=gen, device=gen.device)
        env = (local_env.noise_fn(gen, shape)
               if local_env.noise_fn is not None else None)
        return {"u": u, "env": env}

    def step_det(state: IALSState, action, noise):
        d_t = local_env.dset_fn(state.ls_state, action)
        if stateless:
            new_aip = state.aip_state
        else:
            logits, new_aip = influence.step(aip_params, aip_cfg,
                                             state.aip_state, d_t)
        probs = fast_sigmoid(logits) if marg is None else marg
        u = (noise["u"] < probs).to(torch.float32)
        ls2, obs, r, info = local_env.step_det(state.ls_state, action, u,
                                               noise["env"])
        info = dict(info)
        info["u"] = u
        info["u_probs"] = probs
        return IALSState(ls_state=ls2, aip_state=new_aip), obs, r, info

    def step(state: IALSState, action, gen: torch.Generator):
        return step_det(state, action, noise_fn(gen))

    def observe(state: IALSState):
        return local_env.observe(state.ls_state)

    return Env(spec=spec, reset=reset, step=step, observe=observe,
               noise_fn=noise_fn, step_det=step_det)


class MultiIALSState(NamedTuple):
    ls_state: object          # LS state with (A, ...) stacked leaves
    aip_state: torch.Tensor   # (A, ...) per-agent AIP recurrent state


def make_multi_ials(local_env: LocalEnv, aip_params,
                    aip_cfg: influence.AIPConfig, n_agents: int, *,
                    fixed_marginal: Optional[float] = None,
                    fixed_marginal_vec=None,
                    stateless: bool = False) -> Env:
    """-> ``Env`` with the multi-agent GS signature: A local simulators
    and A per-agent AIPs (``aip_params`` leaves (A, ...) stacked), one
    step vmapped over the agents. Actions (A,), obs (A, obs_dim). Noise:
    ``{"u": (A, M) uniforms, "env": the A LS's noise}``.
    ``fixed_marginal`` (scalar) or ``fixed_marginal_vec`` ((M,) shared or
    (A, M) per agent) make every simulator an F-IALS."""
    _check_stateless(stateless, fixed_marginal, fixed_marginal_vec)
    A = n_agents
    M = local_env.spec.n_influence
    spec = dataclasses.replace(local_env.spec,
                               name=local_env.spec.name + "+multi-ials",
                               n_agents=A)
    dev = _device(aip_params)
    if fixed_marginal_vec is not None:
        marg = torch.broadcast_to(
            torch.as_tensor(fixed_marginal_vec, dtype=torch.float32,
                            device=dev), (A, M))
    elif fixed_marginal is not None:
        marg = torch.full((A, M), fixed_marginal, dtype=torch.float32,
                          device=dev)
    else:
        marg = None

    def reset(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        return MultiIALSState(
            ls_state=local_env.reset(gen, shape + (A,)),
            aip_state=influence.init_state(aip_cfg, shape + (A,),
                                           device=dev))

    def noise_fn(gen: torch.Generator, shape=()):
        shape = tuple(shape)
        u = torch.rand(shape + (A, M), generator=gen, device=gen.device)
        env = (local_env.noise_fn(gen, shape + (A,))
               if local_env.noise_fn is not None else None)
        return {"u": u, "env": env}

    def single_step(params, ls_state, aip_state, action, probs_fixed,
                    noise):
        d_t = local_env.dset_fn(ls_state, action)
        if stateless:
            new_aip = aip_state
            probs = probs_fixed
        else:
            logits, new_aip = influence.step(params, aip_cfg, aip_state,
                                             d_t)
            probs = (probs_fixed if marg is not None
                     else fast_sigmoid(logits))
        u = (noise["u"] < probs).to(torch.float32)
        ls2, obs, r, info = local_env.step_det(ls_state, action, u,
                                               noise["env"])
        info = dict(info)
        info["u"] = u
        info["u_probs"] = probs
        return ls2, new_aip, obs, r, info

    vstep = vmapped(single_step)

    def step_det(state: MultiIALSState, actions, noise):
        fixed = (marg if marg is not None
                 else torch.zeros((A, M), dtype=torch.float32, device=dev))
        ls2, new_aip, obs, r, info = vstep(
            aip_params, state.ls_state, state.aip_state, actions, fixed,
            noise)
        return MultiIALSState(ls_state=ls2, aip_state=new_aip), obs, r, info

    def step(state: MultiIALSState, actions, gen: torch.Generator):
        return step_det(state, actions, noise_fn(gen))

    vobserve = vmapped(local_env.observe)

    def observe(state: MultiIALSState):
        return vobserve(state.ls_state)

    return Env(spec=spec, reset=reset, step=step, observe=observe,
               noise_fn=noise_fn, step_det=step_det)
