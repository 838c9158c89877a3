"""RL training entry point of the port — the paper's workflow end to end
(counterpart of ``repro/launch/rl_train.py``).

    PYTHONPATH=src python -m repro_torch.launch.rl_train --domain traffic \
        --simulator ials [--aip gru] [--n-agents 25] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.rl_train --domain warehouse \
        --simulator f-ials --fixed-marginal 0.1 --stateless-f-ials
    PYTHONPATH=src python -m repro_torch.launch.rl_train --ckpt-dir D \
        [--save-every 5] [--n-workers 2 [--async-fleet]]

Pipeline (paper §5.1):
  1. collect a (d_t, u_t) dataset from the GS under a random policy;
  2. build the simulator PPO trains on (``--simulator``): ``gs``; ``ials``
     (the AIP fitted, one per agent, stacked when ``--n-agents`` > 1);
     ``untrained-ials`` (the AIP at its random init, its XE on 8
     episodes reported); ``f-ials`` (u_t from a fixed marginal: the
     empirical one, per agent when A > 1, or ``--fixed-marginal p``;
     ``--stateless-f-ials`` leaves the ignored AIP state frozen);
  3. train PPO on it — on the IALS and the untrained IALS every
     iteration's acting horizon is one ``policy_rollout`` kernel; the
     F-IALS runs PPO's plain loop, as in the JAX package;
  4. evaluate on the GS every ``--eval-every`` iterations.

Domains (paper §5.2-5.4): the traffic grid (policy on one observation,
the FNN AIP by default) and the warehouse floor (policy on 8 stacked
observations, the GRU AIP by default; ``--vanish-after k`` makes items
vanish after k ticks, the finite-memory experiment).

Fault tolerance (``--ckpt-dir``): every generator is
``repro_torch.stream`` of (seed, stream, position), so a checkpoint needs
only the iteration index to rewind the randomness. The checkpoint holds
``{"policy", "opt", "rs", "sim", "it"}`` with the JAX entry point's keys
and leaf order (so a checkpoint either package wrote restores in the
other); a run started again with the same command resumes from the
latest committed one, skipping collection and the AIP fit, and finishes
bitwise equal to the uninterrupted same-seed run. SIGTERM flushes a
checkpoint at the next iteration boundary and exits cleanly.

``--n-workers N`` (N >= 1) trains with the actor/learner fleet
(``distributed/actor_learner.py``): N workers, one learner, the
``--max-staleness`` drop policy, ``--kill-worker W:TICK`` /
``--delay-batch W:TICK:N`` scheduled faults. The default deterministic
schedule resumes bitwise; ``--async-fleet`` runs worker threads.

Lane data parallelism: under ``torch.distributed.run`` (``WORLD_SIZE`` >
1) each process is a rank of a ("data", "model" = 1) ``DeviceMesh``
(``launch/mesh.py``) and holds ``n_envs / world`` env lanes:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.rl_train --device cpu --dist-backend gloo ...

The simulator's parameters (rank 0 collects and fits), the policy init
and the global rollout state are broadcast from rank 0 and checked by md5
on every rank; every iteration's acting horizon runs on the rank's lanes,
the batch is gathered and the learner runs replicated, so the run equals
the one-process run bitwise on the kernel routes (``ials``,
``untrained-ials``; ``gs`` and ``f-ials`` run PPO's plain loop, whose
matrix products may take other algorithms at other row counts). Rank 0
evaluates, prints the rows, writes ``--out`` and writes the checkpoint, of
the gathered global state (a checkpoint resumes under any world size).
The preemption decision is agreed over the ranks (``all_reduce`` MAX).
``--dist-backend`` defaults to nccl on cuda and gloo on cpu; ranks on one
card need gloo. A world size that does not divide ``n_envs``, the fleet
under ranks and NCCL with more ranks than cards raise.

Prints one JSON row per iteration with the JAX entry point's field names
(``iter``, ``wallclock_s``, ``train_reward``, ``env_steps``,
``gs_eval_reward[_per_agent]``) plus the PPO ``loss`` and the iteration's
wall time ``iter_s`` (ended by a device sync), and returns the history
with ``final_params_md5`` (the resume oracle), ``resumed_from`` and
``preempted``. Runs on the card unless ``--device cpu``; without CUDA the
default raises. The numbers differ from the JAX package's: its
generators are threefry keys.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device, stream
from repro_torch.checkpoint import ckpt
from repro_torch.core import collect, engine, influence
from repro_torch.distributed import actor_learner, fault_injection, sharding
from repro_torch.distributed.fault_tolerance import TrainingGuard
from repro_torch.envs.traffic import (TrafficConfig,
                                      make_batched_local_traffic_env,
                                      make_batched_multi_traffic_env,
                                      make_batched_traffic_env)
from repro_torch.envs.warehouse import (WarehouseConfig,
                                        make_batched_local_warehouse_env,
                                        make_batched_multi_warehouse_env,
                                        make_batched_warehouse_env)
from repro_torch.launch.mesh import (init_ranks, make_host_mesh,
                                     rank0_alone)
from repro_torch.rl import ppo
from repro_torch.tree import tree_leaves, tree_map

# generator stream tags (the JAX entry point's fold_in tags)
_K_SIM, _K_POLICY, _K_ROLLOUT, _K_TRAIN, _K_EVAL = 0, 1, 2, 3, 4


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
    """A simulator recipe split at the checkpoint boundary: ``template()``
    is a cheap pytree of the simulator's state with the right shapes (the
    restore target), ``train(gen)`` makes the real one (collection and
    the AIP fit: what a resume skips) -> (sim_params, diag), and
    ``make_env(sim_params, mesh=None)`` builds PPO's environment from
    either (one rank's share of it under a mesh)."""
    template: Callable
    train: Callable
    make_env: Callable


def prepare_simulator(simulator: str, gs, ls, aip_kind: str, *,
                      collect_episodes: int, ep_len: int, aip_epochs: int,
                      fixed_marginal=None, stateless_f_ials: bool = False,
                      device="cuda") -> SimBuild:
    """-> SimBuild on ``device``. ``stateless_f_ials`` makes the f-ials
    simulator keep its (ignored) AIP state frozen instead of advancing
    it every tick."""
    if simulator == "gs":
        return SimBuild(template=lambda: {}, train=lambda gen: ({}, {}),
                        make_env=lambda p, mesh=None: sharding.shard_env(
                            gs, mesh, gs.spec.n_agents))
    if simulator not in ("ials", "untrained-ials", "f-ials"):
        raise ValueError(f"unknown simulator {simulator!r}")
    A = gs.spec.n_agents
    acfg = influence.AIPConfig(
        kind=aip_kind, d_in=gs.spec.dset_dim, n_out=gs.spec.n_influence,
        hidden=64, stack=8 if aip_kind == "fnn" else 1)

    def init_params(gen):
        if A > 1:
            return influence.init_aip_stacked(acfg, gen, A, device)
        return influence.init_aip(acfg, gen, device)

    def template_params():
        return init_params(stream(device, 0, 0))

    def agent_data(gen, n_eps):
        data = collect.collect_dataset(gs, gen, n_episodes=n_eps,
                                       ep_len=ep_len)
        return collect.per_agent(data) if A > 1 else data  # (A, N, T, ...)

    def make_ials(p, mesh=None, **kw):
        return engine.make_unified_ials(ls, p, acfg, n_agents=A, mesh=mesh,
                                        **kw)

    if simulator == "untrained-ials":
        @torch.no_grad()
        def train(gen):
            data = agent_data(gen, 8)
            params = init_params(gen)
            xent = (influence.xent_loss_per_agent(
                params, acfg, data["d"], data["u"]).mean() if A > 1
                else influence.xent_loss(params, acfg, data["d"], data["u"]))
            return params, {"aip_xent": float(xent)}
        return SimBuild(template=template_params, train=train,
                        make_env=make_ials)

    if simulator == "f-ials":
        marg_shape = (A, gs.spec.n_influence) if A > 1 \
            else (gs.spec.n_influence,)

        @torch.no_grad()
        def train(gen):
            t0 = time.time()
            data = agent_data(gen, collect_episodes)
            if fixed_marginal is not None:
                marg = torch.full(marg_shape, float(fixed_marginal),
                                  dtype=torch.float32, device=device)
            else:
                marg = collect.empirical_marginal(data["u"],
                                                  per_agent=A > 1)
            params = init_params(gen)
            # XE of the fixed marginal on the collected data
            p = torch.clamp(marg, 1e-6, 1 - 1e-6)
            if A > 1:
                p = p[:, None, None, :]         # over (A, N, T, M)
            u = data["u"]
            xe = -(u * torch.log(p) + (1 - u) * torch.log(1 - p))
            diag = {"aip_xent": float(xe.sum(-1).mean()),
                    "aip_train_time_s": time.time() - t0}
            return {"aip": params, "marg": marg}, diag
        return SimBuild(
            template=lambda: {"aip": template_params(),
                              "marg": torch.zeros(marg_shape,
                                                  dtype=torch.float32,
                                                  device=device)},
            train=train,
            make_env=lambda p, mesh=None: make_ials(
                p["aip"], mesh, fixed_marginal_vec=p["marg"],
                stateless=stateless_f_ials))

    def train(gen):
        t0 = time.time()
        data = agent_data(gen, collect_episodes)
        diag = {}
        if A > 1:
            params, m = influence.train_aip_batched(
                acfg, data["d"], data["u"], gen, epochs=aip_epochs)
            diag["aip_xent_per_agent"] = m["final_loss_per_agent"]
        else:
            params, m = influence.train_aip(acfg, data["d"], data["u"], gen,
                                            epochs=aip_epochs)
        diag["aip_xent"] = m["final_loss"]
        diag["aip_train_time_s"] = time.time() - t0
        return params, diag
    return SimBuild(template=template_params, train=train,
                    make_env=make_ials)


def build_simulator(simulator: str, gs, ls, aip_kind: str,
                    generator: torch.Generator, *, collect_episodes: int,
                    ep_len: int, aip_epochs: int, fixed_marginal=None,
                    stateless_f_ials: bool = False):
    """-> (env for PPO, the AIP's diagnostics): ``prepare_simulator``
    trained in one go, for callers that never resume."""
    sb = prepare_simulator(
        simulator, gs, ls, aip_kind, collect_episodes=collect_episodes,
        ep_len=ep_len, aip_epochs=aip_epochs, fixed_marginal=fixed_marginal,
        stateless_f_ials=stateless_f_ials, device=generator.device)
    sim_params, diag = sb.train(generator)
    return sb.make_env(sim_params), diag


def params_md5(tree) -> str:
    """Digest of every leaf's raw bytes in tree order: two runs agree iff
    their params are bitwise equal (the resume oracle)."""
    h = hashlib.md5()
    for leaf in tree_leaves(tree):
        h.update(np.ascontiguousarray(leaf.detach().cpu().numpy())
                 .tobytes())
    return h.hexdigest()


def _parse_faults(kills, delays):
    events = []
    for s in kills or []:
        w, t = (int(x) for x in s.split(":"))
        events.append(fault_injection.KillWorker(worker_id=w, at_tick=t))
    for s in delays or []:
        w, t, n = (int(x) for x in s.split(":"))
        events.append(fault_injection.DelayBatch(worker_id=w, at_tick=t,
                                                 ticks=n))
    return events


def join_ranks(args):
    """-> (device, mesh): under ``torch.distributed.run`` (``WORLD_SIZE`` >
    1) this rank joins the process group (``--dist-backend``, default nccl
    on cuda and gloo on cpu; ``--dist-init``, default ``env://``) and the
    mesh is ``make_host_mesh()``; a single process gets
    ``(resolve_device(--device), None)``. Refuses what it would otherwise
    run differently: the fleet under ranks, NCCL with more ranks than
    cards, and an ``n_envs`` the ranks do not divide."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return resolve_device(args.device), None
    if args.n_workers > 0:
        raise ValueError("--n-workers > 0 under torch.distributed.run: the "
                         "actor/learner fleet takes no mesh; run it as one "
                         "process")
    resolve_device(args.device)
    backend = args.dist_backend or ("nccl" if torch.device(
        args.device).type == "cuda" else "gloo")
    dev = init_ranks(backend, args.device, init_method=args.dist_init,
                     timeout_s=args.dist_timeout_s)
    mesh = make_host_mesh()
    try:
        sharding.require_lane_sharding(args.n_envs, args.n_agents, mesh)
    except ValueError:
        torch.distributed.destroy_process_group()
        raise
    return dev, mesh


def setup(args, dev=None):
    """-> (device, gs, SimBuild, PPOConfig) of a parsed command line: what
    both trainers start from (on ``dev``, default ``--device``)."""
    dev = dev if dev is not None else resolve_device(args.device)
    gs, ls, frame_stack = build_domain(args.domain, args.vanish_after,
                                       args.n_agents, dev)
    aip_kind = args.aip or ("gru" if args.domain == "warehouse" else "fnn")
    sb = prepare_simulator(
        args.simulator, gs, ls, aip_kind,
        collect_episodes=args.collect_episodes, ep_len=args.episode_len,
        aip_epochs=args.aip_epochs, fixed_marginal=args.fixed_marginal,
        stateless_f_ials=args.stateless_f_ials, device=dev)
    pcfg = ppo.PPOConfig(obs_dim=gs.spec.obs_dim,
                         n_actions=gs.spec.n_actions,
                         frame_stack=frame_stack, n_envs=args.n_envs,
                         rollout_len=args.rollout_len,
                         episode_len=args.episode_len,
                         n_agents=args.n_agents,
                         fast_gates=not args.exact_policy_tanh)
    return dev, gs, sb, pcfg


def fresh_state(args, dev, sb: SimBuild, pcfg, opt, mesh=None):
    """A run from its start: the simulator made (collection, AIP fit), the
    policy, optimizer and rollout state at their seeded init -> (sim
    params, diag, env, params, opt_state, rollout state). Under a mesh
    rank 0 collects and fits while the others wait (``rank0_alone``, not
    bound by ``--dist-timeout-s``) and start from templates; the simulator,
    the policy init and the global rollout state are then rank 0's on
    every rank (checked by md5), and each rank keeps its block of the
    rollout state."""
    with rank0_alone(mesh):
        if _rank0(mesh):
            sim_params, diag = sb.train(sim_stream(args, dev))
        else:
            sim_params, diag = sb.template(), None
    sim_params = _broadcast(sim_params, mesh)
    box = [diag]
    if mesh is not None:
        torch.distributed.broadcast_object_list(box, 0)
    env = sb.make_env(sim_params)
    params = _broadcast(ppo.init_policy(pcfg, stream(dev, args.seed,
                                                     _K_POLICY)), mesh)
    rs = _broadcast(ppo.init_rollout_state(env, pcfg, stream(
        dev, args.seed, _K_ROLLOUT)), mesh)
    for tree, what in ((sim_params, "the simulator"), (params, "the policy"),
                       (rs, "the rollout state")):
        _agree_md5(tree, what, mesh)
    if mesh is not None:
        env = sb.make_env(sim_params, mesh)
    return (sim_params, box[0], env, params, opt.init(params),
            ppo.shard_rollout(rs, mesh, pcfg.n_agents))


def sim_stream(args, dev) -> torch.Generator:
    """The simulator's generator: its collection, then its AIP."""
    return stream(dev, args.seed, _K_SIM)


def train_stream(args, dev, it: int) -> torch.Generator:
    """Iteration ``it``'s generator: its rollout, then its learner."""
    return stream(dev, args.seed, _K_TRAIN, it)


def fleet_config(args) -> actor_learner.FleetConfig:
    return actor_learner.FleetConfig(
        n_workers=args.n_workers, queue_size=args.queue_size,
        max_staleness=args.max_staleness, publish_every=args.publish_every,
        deterministic=not args.async_fleet, seed=args.seed)


def _rank0(mesh) -> bool:
    return mesh is None or torch.distributed.get_rank() == 0


def _broadcast(tree, mesh):
    """Rank 0's values of every leaf, on every rank (a new tree)."""
    if mesh is None:
        return tree

    def one(leaf):
        t = leaf.contiguous().clone()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        torch.distributed.broadcast(wire, 0)
        return t
    return tree_map(one, tree)


def _agree_md5(tree, what, mesh):
    """Raise unless every rank holds ``tree`` bitwise (by md5)."""
    if mesh is None:
        return
    md5s = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(md5s, params_md5(tree))
    if len(set(md5s)) != 1:
        raise RuntimeError(f"the ranks disagree on {what}: md5 {md5s}")


def _any_rank(flag: bool, mesh, dev) -> bool:
    """``flag`` reduced with MAX over the ranks (the flag itself alone)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def run_training(args):
    """The training run, callable in-process (the resume tests compare a
    stopped and resumed run against an uninterrupted one this way); one
    rank of it under ``torch.distributed.run``."""
    dev, mesh = join_ranks(args)
    try:
        return _run_training(args, dev, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _run_training(args, dev, mesh):
    dev, gs, sb, pcfg = setup(args, dev)
    t_start = time.time()
    guard = (TrainingGuard(args.ckpt_dir, save_every=args.save_every,
                           writer=_rank0(mesh))
             if args.ckpt_dir else None)
    resume_step = (ckpt.latest_step(args.ckpt_dir)
                   if args.ckpt_dir else None)

    def eval_row(row, params, it):
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
        return row

    try:
        if args.n_workers > 0:
            out = _run_fleet(args, dev, sb, pcfg, guard, resume_step,
                             eval_row, t_start)
        else:
            out = _run_integrated(args, dev, sb, pcfg, guard, resume_step,
                                  eval_row, t_start, mesh)
    finally:
        if guard is not None:
            guard.uninstall()
    out["device"] = str(dev)
    if mesh is not None:      # what each rank launched (kernels' counters)
        from repro_torch.kernels import aip_step
        out["world_size"] = torch.distributed.get_world_size()
        out["launches_per_rank"] = [None] * out["world_size"]
        torch.distributed.all_gather_object(
            out["launches_per_rank"],
            {k: v for k, v in aip_step.LAUNCHES.items() if v})
    if args.out and _rank0(mesh):
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


def _run_integrated(args, dev, sb: SimBuild, pcfg, guard, resume_step,
                    eval_row, t_start, mesh=None):
    """A train iteration a step, position-keyed generators, whole-state
    checkpoints; under a mesh each rank acts on its lanes and rank 0
    evaluates, prints and writes."""
    opt = ppo.make_optimizer(pcfg)
    start_it = 0
    if resume_step is not None:
        # restore into cheap templates first, THEN build the engine from
        # the restored simulator state (the engine holds its AIP)
        t0 = time.time()
        g0 = stream(dev, 0, 0)
        env_t = sb.make_env(sb.template())
        policy_t = ppo.init_policy(pcfg, g0)
        template = {"policy": policy_t, "opt": opt.init(policy_t),
                    "rs": ppo.init_rollout_state(env_t, pcfg, g0),
                    "sim": sb.template(),
                    "it": torch.tensor(0, dtype=torch.int32)}
        # (copies from pageable host memory: done when restore returns)
        tree, step, _ = ckpt.restore(args.ckpt_dir, template, resume_step)
        _agree_md5(tree, "the restored checkpoint", mesh)
        sim_params = tree["sim"]
        diag = {"resumed_from": step, "restore_s": time.time() - t0}
        env = sb.make_env(sim_params, mesh)
        params, ost = tree["policy"], tree["opt"]
        rs = ppo.shard_rollout(tree["rs"], mesh, pcfg.n_agents)
        start_it = int(tree["it"])
        if _rank0(mesh):
            print(f"resumed from iteration {start_it}", flush=True)
    else:
        sim_params, diag, env, params, ost, rs = fresh_state(
            args, dev, sb, pcfg, opt, mesh)
    iteration = ppo.train_iteration_fn(env, pcfg, opt, mesh)

    steps_per_iter = args.n_envs * args.rollout_len * max(args.n_agents, 1)
    history = []
    preempted = False
    for it in range(start_it, args.iterations):
        t_it = time.time()
        params, ost, rs, m = iteration(params, ost, rs,
                                       train_stream(args, dev, it))
        row = {"iter": it, "wallclock_s": round(time.time() - t_start, 2),
               "train_reward": float(m["mean_reward"]),
               "loss": float(m["loss"]),
               "env_steps": (it + 1) * steps_per_iter,
               "iter_s": time.time() - t_it}
        if _rank0(mesh) and (it % args.eval_every == 0
                             or it == args.iterations - 1):
            row = eval_row(row, params, it)
        history.append(row)
        if _rank0(mesh):
            print(json.dumps(row), flush=True)
        if guard is not None:
            t_s = time.time()
            # the checkpoint holds the global rollout state, whatever the
            # world size: gathered (a collective) only when a save is due,
            # which the ranks decide alike on the signal they agreed on
            saved = guard.maybe_save(
                it + 1, lambda: {
                    "policy": params, "opt": ost,
                    "rs": ppo.gather_rollout(rs, mesh, pcfg.n_agents,
                                             pcfg.n_envs),
                    "sim": sim_params,
                    "it": torch.tensor(it + 1, dtype=torch.int32)},
                metadata={"mode": "integrated", "iterations_done": it + 1},
                preempted=(None if mesh is None else
                           _any_rank(guard.preempted, mesh, dev)))
            if saved:
                row["ckpt_save_s"] = time.time() - t_s
            if guard.answered:
                if _rank0(mesh):
                    print("preempted: RL checkpoint flushed, exiting "
                          "cleanly", flush=True)
                preempted = True
                break

    _agree_md5(params, "the final policy", mesh)
    return {"args": vars(args), "diag": diag, "history": history,
            "preempted": preempted, "resumed_from": start_it,
            "final_params_md5": params_md5(params),
            "total_wallclock_s": round(time.time() - t_start, 2)}


def _run_fleet(args, dev, sb: SimBuild, pcfg, guard, resume_step,
               eval_row, t_start):
    """N workers -> bounded queue -> one learner, in chunks of
    ``eval_every`` updates (a chunk's end has no batch in flight: that is
    where checkpoints are taken)."""
    fcfg = fleet_config(args)
    events = _parse_faults(args.kill_worker, args.delay_batch)
    injector = (fault_injection.FaultInjector(
        fault_injection.FaultPlan.of(*events)) if events else None)

    diag = {}
    if resume_step is not None:
        env_t = sb.make_env(sb.template())
        trainer_t = actor_learner.ActorLearnerTrainer(env_t, pcfg, fcfg,
                                                      device=dev)
        state, sim_params, start_v = actor_learner.resume_fleet(
            args.ckpt_dir, trainer_t, extra_template=sb.template())
        diag["resumed_from"] = start_v
        print(f"resumed fleet at learner version {start_v}", flush=True)
    else:
        sim_params, diag = sb.train(sim_stream(args, dev))
        state = None
    env = sb.make_env(sim_params)
    trainer = actor_learner.ActorLearnerTrainer(env, pcfg, fcfg,
                                                injector=injector,
                                                device=dev)
    if state is None:
        state = trainer.init_state()

    # wallclock_s: the seconds in ``trainer.run`` (acting and learning,
    # without the evaluations)
    stats = {"produced": 0, "updates": 0, "dropped": 0, "delayed": 0,
             "wallclock_s": 0.0}
    history = []
    preempted = False
    v = int(state.version)
    while v < args.iterations:
        chunk = min(args.eval_every, args.iterations - v)
        should_stop = (lambda: guard.preempted) if guard is not None \
            else None
        state, info = trainer.run(state, chunk, should_stop=should_stop)
        for k in stats:
            stats[k] += info[k]
        v = int(state.version)
        for h in info["history"]:
            row = {"iter": h["version"], "worker": h["worker"],
                   "staleness": h["staleness"], "dropped": h["dropped"]}
            if not h["dropped"]:
                row["train_reward"] = h["mean_reward"]
                row["loss"] = h["loss"]
            history.append(row)
        row = eval_row({"iter": v,
                        "wallclock_s": round(time.time() - t_start, 2)},
                       state.params, v)
        history.append(row)
        print(json.dumps(row), flush=True)
        if guard is not None:
            guard.maybe_save(
                v, {"fleet": state, "extra": sim_params},
                metadata={"mode": "fleet", **trainer.save_metadata(state)})
            if guard.answered:
                print("preempted: fleet checkpoint flushed, exiting cleanly",
                      flush=True)
                preempted = True
                break
    if guard is not None and not preempted:
        guard.maybe_save(v, {"fleet": state, "extra": sim_params},
                         force=True,
                         metadata={"mode": "fleet",
                                   **trainer.save_metadata(state)})
    if injector is not None:
        stats["kills"] = injector.kills_applied
        stats["faults_exhausted"] = injector.exhausted

    return {"args": vars(args), "diag": diag, "history": history,
            "fleet": stats, "preempted": preempted,
            "final_params_md5": params_md5(state.params),
            "total_wallclock_s": round(time.time() - t_start, 2)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--domain", choices=["traffic", "warehouse"],
                    default="traffic")
    ap.add_argument("--simulator", default="ials",
                    choices=["gs", "ials", "untrained-ials", "f-ials"])
    ap.add_argument("--aip", default=None, choices=[None, "gru", "fnn"])
    ap.add_argument("--fixed-marginal", type=float, default=None,
                    help="f-ials: pin every source's marginal to this p "
                         "(default: the empirical marginal)")
    ap.add_argument("--stateless-f-ials", action="store_true",
                    help="f-ials only: freeze the ignored AIP state "
                         "instead of advancing it every tick")
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
    # ranks under torch.distributed.run (WORLD_SIZE > 1)
    ap.add_argument("--dist-backend", default=None,
                    choices=[None, "nccl", "gloo"],
                    help="process group backend under torch.distributed."
                         "run (default: nccl on cuda, gloo on cpu; ranks "
                         "sharing one card need gloo)")
    ap.add_argument("--dist-init", default=None,
                    help="process group init method (default env://; a "
                         "file:// store needs no port)")
    ap.add_argument("--dist-timeout-s", type=float, default=600,
                    help="a collective that waits longer fails, not hangs "
                         "(it spans rank 0's GS evaluation and checkpoint "
                         "writes, which the other ranks wait for; not its "
                         "collection and AIP fit at the start)")
    # fault tolerance and the actor/learner fleet
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint here and resume from the latest "
                         "committed checkpoint (bitwise on the "
                         "deterministic paths)")
    ap.add_argument("--save-every", type=int, default=5,
                    help="checkpoint every N learner iterations (SIGTERM "
                         "always forces a flush)")
    ap.add_argument("--n-workers", type=int, default=0,
                    help="rollout workers of the actor/learner fleet (0: "
                         "the integrated trainer)")
    ap.add_argument("--max-staleness", type=int, default=4,
                    help="drop batches staler than this many policy "
                         "versions")
    ap.add_argument("--publish-every", type=int, default=1,
                    help="learner updates between parameter publications")
    ap.add_argument("--queue-size", type=int, default=8)
    ap.add_argument("--async-fleet", action="store_true",
                    help="free-running worker threads (throughput mode; "
                         "no bitwise-resume claim)")
    ap.add_argument("--kill-worker", action="append", metavar="W:TICK",
                    help="kill and restart worker W before its produce at "
                         "fleet tick TICK (repeatable)")
    ap.add_argument("--delay-batch", action="append", metavar="W:TICK:N",
                    help="hold the batch worker W produces at TICK for N "
                         "ticks (drives it past --max-staleness)")
    return ap.parse_args(argv)


def main(argv=None):
    return run_training(parse_args(argv))


if __name__ == "__main__":
    main()
