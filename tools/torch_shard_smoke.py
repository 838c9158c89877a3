"""Bitwise check of the port's lane data parallelism, one process a rank:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        tools/torch_shard_smoke.py --device cuda --backend gloo
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tools/torch_shard_smoke.py --device cpu --model 2 --B 8 --T 8 \
        --hidden 16 --cases traffic:fnn:4,warehouse:gru:4

For each case (domain, AIP backbone, agents A, lanes B: ``--cases``
``traffic:gru:25:64``; B defaults to ``--B``) every rank runs, on the
("data", "model") mesh of ``launch/mesh.py::make_host_mesh(--model)``:
the sharded ``ppo.rollout`` (the engine's ``policy_rollout``), the sharded
``engine.rollout`` and one sharded ``ppo`` train iteration, each from the
same seeded weights and generators. Rank 0 also runs the one-process
program on the same inputs and compares every output leaf bitwise: the
rollout state (gathered), the batch and ``v_last``; the engine's final
state (gathered) and rewards; the iteration's parameters, optimizer state,
metrics and rollout state. Each rank counts its kernel launches around
its sharded calls: one ``policy_rollout`` a rollout and an iteration, one
``aip_rollout_multi`` / ``fnn_rollout`` an ``engine.rollout`` (on the
card; the CPU runs the plain versions and counts none).

With ``--time-reps N`` (on the card) each case also times, over N calls
after a warm-up: each rank's ``policy_rollout`` on its block, one rank at
a time while the others wait at a barrier, and the one-process
``policy_rollout`` on rank 0, in device ms (``torch.profiler``'s kernel
and copy events, every launch counted: ``chip_smoke.device_ms``; the
host's enqueue is left out); and the gathers a sharded rollout adds (the
batch and the final frames), in CUDA-event ms, host time included (gloo
stages CUDA tensors through the host).

Rank 0 prints the leaves that differ and exits 1 on any; its last line is
a JSON summary (``--json`` also writes it to a file). Without
``torch.distributed.run``, ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` in
the environment and ``--init-method file:///path`` start a rank.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import stream  # noqa: E402
from repro_torch.core import engine, influence  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.envs.api import horizon_noise  # noqa: E402
from repro_torch.envs.traffic import (  # noqa: E402
    TrafficConfig, make_batched_local_traffic_env)
from repro_torch.envs.warehouse import (  # noqa: E402
    WarehouseConfig, make_batched_local_warehouse_env)
from repro_torch.kernels import aip_step as cuda  # noqa: E402
from repro_torch.launch.mesh import init_ranks, make_host_mesh  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

DEFAULT_CASES = "traffic:fnn:1,traffic:gru:25,warehouse:gru:36,warehouse:fnn:36"


def parse_case(case, args):
    """"domain:backbone:agents[:lanes]" -> (domain, kind, A, B); B
    defaults to ``--B``."""
    domain, kind, A, *B = case.split(":")
    return domain, kind, int(A), int(B[0]) if B else args.B


def build(domain, kind, A, B, args, dev, mesh):
    """-> (env, sharded env, PPO config, policy params) from fixed seeds."""
    if domain == "traffic":
        ls, stack = make_batched_local_traffic_env(TrafficConfig(), dev), 1
    else:
        ls, stack = make_batched_local_warehouse_env(WarehouseConfig(),
                                                     dev), 8
    acfg = influence.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                               n_out=ls.spec.n_influence, hidden=args.hidden,
                               stack=8 if kind == "fnn" else 1)
    g = stream(dev, args.seed, 0)
    aip = (influence.init_aip_stacked(acfg, g, A, dev) if A > 1
           else influence.init_aip(acfg, g, dev))
    env1 = engine.make_unified_ials(ls, aip, acfg, n_agents=A)
    env2 = engine.make_unified_ials(ls, aip, acfg, n_agents=A, mesh=mesh)
    pcfg = ppo.PPOConfig(obs_dim=ls.spec.obs_dim,
                         n_actions=ls.spec.n_actions, frame_stack=stack,
                         n_envs=B, rollout_len=args.T,
                         episode_len=max(args.T // 2, 1), n_agents=A)
    params = ppo.init_policy(pcfg, stream(dev, args.seed, 1), dev)
    return env1, env2, pcfg, params


def engine_inputs(env, pcfg, gen):
    """The global actions (T, B[, A]) and this env's T-stacked noise."""
    T, B = pcfg.rollout_len, pcfg.n_envs
    acts = torch.randint(0, pcfg.n_actions, (T, B) + pcfg.agent_shape,
                         generator=gen, device=gen.device)
    return acts, horizon_noise(env.noise_fn, gen, T, B)


def counted(fn):
    """-> (fn's result, the launch counters that moved in it)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    cuda.reset_launches()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {k: v for k, v in cuda.LAUNCHES.items() if v}


def event_ms(fn, reps):
    """Median ms of ``fn`` over ``reps`` calls (CUDA events, host time
    included), after one."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def time_case(env1, env2, pcfg, params, args, dev, mesh):
    """-> {"block_device_ms": this rank's policy_rollout on its block,
    alone on the card (the others wait at a barrier), "gather_event_ms":
    the batch and frames gathers of one sharded rollout, host included,
    "one_process_device_ms" (rank 0)}. A device reading whose profiles
    all missed a launch is "not measured"."""
    import chip_smoke
    A, B = pcfg.n_agents, pcfg.n_envs

    def policy_call(env, rs, m):
        gum, nz, resets = ppo.draw_rollout_streams(env, pcfg,
                                                   stream(dev, 9, 9), m)
        return lambda: env.policy_rollout(
            rs.env_state, rs.frames, rs.t_in_ep, params, gum, nz, resets,
            episode_len=pcfg.episode_len, fast_gates=pcfg.fast_gates)

    def device_ms(call):
        return chip_smoke.device_ms(call, reps=args.time_reps, warmup=1,
                                    kernel="horizon_kernel")

    rs2 = ppo.init_rollout_state(env2, pcfg, stream(dev, 9, 7), mesh)
    call2 = policy_call(env2, rs2, mesh)
    _, frames, _, out = call2()
    # the leaves ppo.rollout gathers (logp has v's shape and dtype)
    local = {"x": out["x"], "a": out["a"], "logp": out["v"], "v": out["v"],
             "r": out["r"], "done": out["done"]}
    res = {}
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == dist.get_rank():
            res["block_device_ms"] = device_ms(call2)
    dist.barrier()
    res["gather_event_ms"] = event_ms(lambda: (
        sharding.gather_ials_stream(local, mesh, B, A),
        sharding.gather_ials_state(frames, mesh, A, B)), args.time_reps)
    dist.barrier()
    if dist.get_rank() == 0:
        rs1 = ppo.init_rollout_state(env1, pcfg, stream(dev, 9, 7))
        res["one_process_device_ms"] = device_ms(policy_call(env1, rs1,
                                                             None))
    dist.barrier()
    return res


def run_case(case, args, dev, mesh):
    domain, kind, A, B = parse_case(case, args)
    env1, env2, pcfg, params = build(domain, kind, A, B, args, dev, mesh)

    def gen(tag):
        return stream(dev, args.seed, tag)

    out = {}
    # 1. ppo.rollout: the engine's policy_rollout on the rank's block
    rs2 = ppo.init_rollout_state(env2, pcfg, gen(2), mesh)
    t0 = time.perf_counter()
    (rs2b, batch2, v2), n_roll = counted(lambda: ppo.rollout(
        env2, pcfg, params, rs2, gen(3), mesh=mesh))
    roll_s = time.perf_counter() - t0
    out["rollout"] = {"rs": ppo.gather_rollout(rs2b, mesh, A, B),
                      "batch": batch2, "v_last": v2}
    # 2. engine.rollout on the rank's block
    st2 = env2.reset(gen(4), B)
    acts, nz2 = engine_inputs(env2, pcfg, gen(5))
    acts2 = sharding.shard_ials_stream(acts, mesh, B, A)
    (st2b, rw2), n_eng = counted(lambda: env2.rollout(st2, acts2, nz2))
    out["engine"] = {"state": sharding.gather_ials_state(st2b, mesh, A, B),
                     "rewards": sharding.gather_ials_stream(rw2, mesh, B,
                                                            A)}
    # 3. one train iteration: the learner replicated on the gathered batch
    opt, it2 = ppo.make_train_iteration(env2, pcfg, mesh)
    (p2, o2, rs2c, m2), n_it = counted(lambda: it2(
        params, opt.init(params), rs2, gen(6)))
    out["train"] = {"params": p2, "opt": o2, "metrics": m2,
                    "rs": ppo.gather_rollout(rs2c, mesh, A, B)}
    counts = {"rollout": n_roll, "engine": n_eng, "train": n_it}
    if args.time_reps and dev.type == "cuda":
        out["_timing"] = time_case(env1, env2, pcfg, params, args, dev, mesh)

    ref = None
    if dist.get_rank() == 0:      # the one-process program, same inputs
        rs1 = ppo.init_rollout_state(env1, pcfg, gen(2))
        t0 = time.perf_counter()
        rs1b, batch1, v1 = ppo.rollout(env1, pcfg, params, rs1, gen(3))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        st1 = env1.reset(gen(4), B)
        acts1, nz1 = engine_inputs(env1, pcfg, gen(5))
        st1b, rw1 = env1.rollout(st1, acts1, nz1)
        opt1, it1 = ppo.make_train_iteration(env1, pcfg)
        p1, o1, rs1c, m1 = it1(params, opt1.init(params), rs1, gen(6))
        ref = {"rollout": {"rs": rs1b, "batch": batch1, "v_last": v1},
               "engine": {"state": st1b, "rewards": rw1},
               "train": {"params": p1, "opt": o1, "metrics": m1,
                         "rs": rs1c}}
        out["_times"] = {"sharded_rollout_s": roll_s,
                         "one_process_rollout_s": ref_s}
    return out, ref, counts


def compare(got, want):
    """-> [(path, reason)] of the leaves that differ (bitwise)."""
    g, w = tree_leaves_with_path(got), tree_leaves_with_path(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        return [("<structure>", f"{[p for p, _ in g]} != "
                                f"{[p for p, _ in w]}")]
    bad = []
    for (p, a), (_, b) in zip(g, w):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append((p, f"{a.dtype}{tuple(a.shape)} != "
                           f"{b.dtype}{tuple(b.shape)}"))
        elif not torch.equal(a, b):
            n = int((a != b).sum())
            bad.append((p, f"{n} of {a.numel()} elements differ"))
    return bad


def expected_counts(case, dev):
    """The launches a rank's sharded calls make: on the card each kernel
    counts under its name and its name with the domain; none on the CPU."""
    domain, kind = case.split(":")[:2]
    if dev.type != "cuda":
        return {"rollout": {}, "engine": {}, "train": {}}
    horizon = "aip_rollout_multi" if kind == "gru" else "fnn_rollout"
    pol = {f"policy_rollout_{kind}": 1, f"policy_rollout_{kind}[{domain}]": 1}
    return {"rollout": pol, "engine": {horizon: 1, f"{horizon}[{domain}]": 1},
            "train": pol}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--model", type=int, default=1,
                    help="size of the mesh's model axis")
    ap.add_argument("--cases", default=DEFAULT_CASES,
                    help="domain:backbone:agents[:lanes], comma-separated")
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--T", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="")
    ap.add_argument("--time-reps", type=int, default=0,
                    help="time each case's kernels over this many calls "
                         "(on the card)")
    args = ap.parse_args(argv)

    dev = init_ranks(args.backend, args.device, init_method=args.init_method)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh(model=args.model)
    summary = {"world": world, "mesh": dict(sharding._view(mesh).shape),
               "device": str(dev), "backend": args.backend, "cases": {}}
    failed = False
    try:
        for case in args.cases.split(","):
            out, ref, counts = run_case(case, args, dev, mesh)
            all_counts = [None] * world
            dist.all_gather_object(all_counts, counts)
            timing = [None] * world
            dist.all_gather_object(timing, out.pop("_timing", None))
            want = expected_counts(case, dev)
            bad_counts = [(r, c) for r, c in enumerate(all_counts)
                          if c != want]
            if rank != 0:
                continue
            bad, per_part = [], {}
            for part in ("rollout", "engine", "train"):
                diff = compare(out[part], ref[part])
                per_part[part] = {
                    "leaves": len(tree_leaves_with_path(out[part])),
                    "differing": len(diff)}
                bad += [(f"{part}{p}", why) for p, why in diff]
            leaves = sum(v["leaves"] for v in per_part.values())
            for p, why in bad:
                print(f"[shard] {case}: {p} differs: {why}", flush=True)
            for r, c in bad_counts:
                print(f"[shard] {case}: rank {r} launched {c}, expected "
                      f"{want}", flush=True)
            failed |= bool(bad or bad_counts)
            summary["cases"][case] = {
                "leaves": leaves, "differing": len(bad), "parts": per_part,
                "launches_per_rank": all_counts, **out.pop("_times")}
            if timing[0] is not None:
                summary["cases"][case]["timing_per_rank"] = timing
            print(f"[shard] {case}: {leaves} leaves, {len(bad)} differ; "
                  f"launches per rank {all_counts}"
                  + (f"; timing per rank {timing}"
                     if timing[0] is not None else ""), flush=True)
    finally:
        dist.barrier()
        dist.destroy_process_group()
    if rank == 0:
        summary["ok"] = not failed
        line = json.dumps(summary)
        if args.json:
            Path(args.json).write_text(line)
        print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
