"""RL training entry point of the port — the paper's workflow end to end
(counterpart of ``repro/launch/rl_train.py``, integrated trainer only).

    PYTHONPATH=src python -m repro_torch.launch.rl_train --domain traffic \
        --simulator ials [--aip gru] [--n-agents 25] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.rl_train --domain warehouse \
        --simulator ials [--aip fnn] [--n-agents 36] [--vanish-after 8]

Pipeline (paper §5.1):
  1. collect a (d_t, u_t) dataset from the GS under a random policy;
  2. fit the AIP (one per agent; stacked when ``--n-agents`` > 1);
  3. train PPO on the chosen simulator (``ials`` or ``gs``) — on the IALS
     every iteration's acting horizon is one ``policy_rollout`` kernel;
  4. evaluate on the GS every ``--eval-every`` iterations.

Domains (paper §5.2-5.4): the traffic grid (policy on one observation,
the FNN AIP by default) and the warehouse floor (policy on 8 stacked
observations, the GRU AIP by default; ``--vanish-after k`` makes items
vanish after k ticks, the finite-memory experiment). Prints one JSON row
per iteration with the JAX entry point's field names (``iter``,
``wallclock_s``, ``train_reward``, ``env_steps``,
``gs_eval_reward[_per_agent]``) plus the PPO ``loss`` and the iteration's
wall time ``iter_s`` (ended by a device sync). Runs on the card unless
``--device cpu``; without CUDA the default raises. Randomness comes from
per-stream generators seeded from (seed, stream, position), the
counterpart of the JAX entry point's ``fold_in`` streams (the numbers
differ from the JAX package's). Not offered yet: ``--n-workers``,
``--ckpt-dir``, and the untrained-ials / f-ials simulators.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import collect, engine, influence
from repro_torch.envs.traffic import (TrafficConfig,
                                      make_batched_local_traffic_env,
                                      make_batched_multi_traffic_env,
                                      make_batched_traffic_env)
from repro_torch.envs.warehouse import (WarehouseConfig,
                                        make_batched_local_warehouse_env,
                                        make_batched_multi_warehouse_env,
                                        make_batched_warehouse_env)
from repro_torch.rl import ppo

# generator stream tags (the JAX entry point's fold_in tags)
_K_SIM, _K_POLICY, _K_ROLLOUT, _K_TRAIN, _K_EVAL = 0, 1, 2, 3, 4


def stream(device, seed: int, tag: int, position: int = 0):
    """A generator on ``device`` seeded by (seed, tag, position)."""
    s = int(np.random.SeedSequence([seed, tag, position]).generate_state(
        1, dtype=np.uint64)[0] >> 1)
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


def grid_agents(grid: int, n_agents: int):
    """First ``n_agents`` cells of a grid x grid board, row-major."""
    cells = [(i, j) for i in range(grid) for j in range(grid)]
    if n_agents > len(cells):
        raise ValueError(f"n_agents={n_agents} > {grid}x{grid} grid")
    return cells[:n_agents]


def build_domain(domain: str, vanish_after: int = 0, n_agents: int = 1,
                 device="cuda"):
    """-> (gs, batched_ls, frame_stack); the GS is multi-agent when
    n_agents > 1. ``vanish_after`` is the warehouse's (§5.4)."""
    if domain == "traffic":
        cfg = TrafficConfig()
        if n_agents > 1:
            gs = make_batched_multi_traffic_env(
                cfg, grid_agents(cfg.grid, n_agents), device)
        else:
            gs = make_batched_traffic_env(cfg, device)
        return gs, make_batched_local_traffic_env(cfg, device), 1
    if domain != "warehouse":
        raise ValueError(f"unknown domain {domain!r}")
    cfg = WarehouseConfig(vanish_after=vanish_after)
    if n_agents > 1:
        gs = make_batched_multi_warehouse_env(
            cfg, grid_agents(cfg.grid, n_agents), device)
    else:
        gs = make_batched_warehouse_env(cfg, device)
    return gs, make_batched_local_warehouse_env(cfg, device), 8


class SimBuild(NamedTuple):
    """``train(gen) -> (sim_params, diag)`` fits the simulator;
    ``make_env(sim_params)`` builds PPO's environment from it."""
    train: Callable
    make_env: Callable


def prepare_simulator(simulator: str, gs, ls, aip_kind: str, *,
                      collect_episodes: int, ep_len: int,
                      aip_epochs: int) -> SimBuild:
    if simulator == "gs":
        return SimBuild(train=lambda gen: ({}, {}), make_env=lambda p: gs)
    if simulator != "ials":
        raise NotImplementedError(f"simulator {simulator!r} is not ported")
    A = gs.spec.n_agents
    acfg = influence.AIPConfig(
        kind=aip_kind, d_in=gs.spec.dset_dim, n_out=gs.spec.n_influence,
        hidden=64, stack=8 if aip_kind == "fnn" else 1)

    def train(gen):
        t0 = time.time()
        data = collect.collect_dataset(gs, gen, n_episodes=collect_episodes,
                                       ep_len=ep_len)
        diag = {}
        if A > 1:
            data = collect.per_agent(data)          # (A, N, T, ...)
            params, m = influence.train_aip_batched(
                acfg, data["d"], data["u"], gen, epochs=aip_epochs)
            diag["aip_xent_per_agent"] = m["final_loss_per_agent"]
        else:
            params, m = influence.train_aip(acfg, data["d"], data["u"], gen,
                                            epochs=aip_epochs)
        diag["aip_xent"] = m["final_loss"]
        diag["aip_train_time_s"] = time.time() - t0
        return params, diag

    return SimBuild(train=train, make_env=lambda p: engine.make_unified_ials(
        ls, p, acfg, n_agents=A))


def run_training(args):
    """The training run, callable in-process."""
    dev = resolve_device(args.device)
    gs, ls, frame_stack = build_domain(args.domain, args.vanish_after,
                                       args.n_agents, dev)
    aip_kind = args.aip or ("gru" if args.domain == "warehouse" else "fnn")
    sb = prepare_simulator(args.simulator, gs, ls, aip_kind,
                           collect_episodes=args.collect_episodes,
                           ep_len=args.episode_len,
                           aip_epochs=args.aip_epochs)
    pcfg = ppo.PPOConfig(obs_dim=gs.spec.obs_dim,
                         n_actions=gs.spec.n_actions,
                         frame_stack=frame_stack, n_envs=args.n_envs,
                         rollout_len=args.rollout_len,
                         episode_len=args.episode_len,
                         n_agents=args.n_agents,
                         fast_gates=not args.exact_policy_tanh)
    t_start = time.time()
    sim_params, diag = sb.train(stream(dev, args.seed, _K_SIM))
    env = sb.make_env(sim_params)
    params = ppo.init_policy(pcfg, stream(dev, args.seed, _K_POLICY))
    opt = ppo.make_optimizer(pcfg)
    ost = opt.init(params)
    iteration = ppo.train_iteration_fn(env, pcfg, opt)
    rs = ppo.init_rollout_state(env, pcfg, stream(dev, args.seed,
                                                  _K_ROLLOUT))
    steps_per_iter = args.n_envs * args.rollout_len * max(args.n_agents, 1)
    history = []
    for it in range(args.iterations):
        t_it = time.time()
        params, ost, rs, m = iteration(
            params, ost, rs, stream(dev, args.seed, _K_TRAIN, it))
        row = {"iter": it, "wallclock_s": round(time.time() - t_start, 2),
               "train_reward": float(m["mean_reward"]),
               "loss": float(m["loss"]),
               "env_steps": (it + 1) * steps_per_iter,
               "iter_s": time.time() - t_it}
        if it % args.eval_every == 0 or it == args.iterations - 1:
            ke = stream(dev, args.seed, _K_EVAL, it)
            if args.n_agents > 1:
                per = ppo.evaluate(gs, pcfg, params, ke, n_episodes=8,
                                   per_agent=True)
                row["gs_eval_reward_per_agent"] = [round(float(r), 4)
                                                   for r in per]
                row["gs_eval_reward"] = float(per.mean())
            else:
                row["gs_eval_reward"] = ppo.evaluate(gs, pcfg, params, ke,
                                                     n_episodes=8)
        history.append(row)
        print(json.dumps(row), flush=True)
    out = {"args": vars(args), "diag": diag, "history": history,
           "device": str(dev),
           "total_wallclock_s": round(time.time() - t_start, 2)}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--domain", choices=["traffic", "warehouse"],
                    default="traffic")
    ap.add_argument("--simulator", default="ials", choices=["gs", "ials"])
    ap.add_argument("--aip", default=None, choices=[None, "gru", "fnn"])
    ap.add_argument("--exact-policy-tanh", action="store_true",
                    help="exact tanh in the policy net instead of the "
                         "rational gates")
    ap.add_argument("--n-agents", type=int, default=1)
    ap.add_argument("--vanish-after", type=int, default=0,
                    help="warehouse: items vanish after this many ticks "
                         "(0: never; paper §5.4)")
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--rollout-len", type=int, default=128)
    ap.add_argument("--episode-len", type=int, default=128)
    ap.add_argument("--collect-episodes", type=int, default=64)
    ap.add_argument("--aip-epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    return ap.parse_args(argv)


def main(argv=None):
    return run_training(parse_args(argv))


if __name__ == "__main__":
    main()
