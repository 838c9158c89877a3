"""The IALS dry-run on the H100: what each whole-horizon program costs (the
IALS half of ``repro/launch/dryrun.py``).

A cell is one of the repo's real programs at representative shapes (A in
{1, 25, 36}, a B sweep, both domains and backbones), on the pods' layouts
(``launch/mesh.py::make_production_mesh``) or on ``host`` (this process,
one rank with the whole batch):

- ``aip_rollout_multi`` / ``fnn_rollout``: the engine's fused horizon
  rollout, ``engine.make_unified_ials(...).rollout`` (GRU / FNN);
- ``policy_rollout``: PPO's acting horizon, ``ppo.rollout`` on the
  engine's ``policy_rollout``;
- ``train_iteration``: one PPO iteration, ``ppo.train_iteration_fn``.

How a cell is counted. Rank 0 of the cell's layout
(``sharding.LayoutRank``) takes its block of every input from the port's
rules (``ials_state_specs`` / ``ials_stream_specs`` /
``ials_aip_param_specs`` and ``local_block``'s shapes, replication
included), and its own program runs on the block under
``op_analysis.OpCounter``: the one-process program on the block (the
sharding contract: a sharded program equals it on each block, bitwise,
``distributed/sharding.py``), plus what
a rank adds: the gathers of ``sharding.gather_ials_*`` (each noted as an
all-gather of its operand bytes, every rank's block standing in as rank
0's) and, in ``policy_rollout`` and ``train_iteration``, the bootstrap
value and the replicated learner on the gathered batch. The count runs on
the CPU's plain route (``kernels/ops.py`` dispatches on the tensor's
device; ``counted_on``). A layout that ``sharding.require_lane_sharding``
refuses under ``torch.distributed`` (25 or 36 agents do not divide
``model`` = 16, so the reference replicates the lanes over it) is counted
all the same, on the reference's layout, and its cell carries the
refusal in ``ranks_refuse``.

Inputs: the rollout's randomness is drawn before the horizon, as the port
trains, from a CPU ``torch.Generator`` seeded with 0 (no number of a
cell depends on the values), and moved to the program's device, so the
card's run takes the counted run's inputs: the engine's noise, the Gumbel
noise, the reset states and the learner's minibatch permutations are
arguments of the program. So ``memory.argument_bytes_per_device`` holds
these streams where the reference's holds keys (and the rank's AIP
weights, which the engine holds).

With ``--device cuda`` (the default) a ``host`` cell also runs its program
once on the card's kernel route: its kernel launches are the cell's
``custom_call_count`` and ``launches``, and the bytes it holds plus the
most it allocates its ``memory.peak_bytes_per_device``. Pod cells and
``--device cpu`` leave the peak ``null``, with the reason. Times are
projections from the card's peaks (``op_analysis.roofline``), not
measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ials all \\
      [--mesh pod1|pod2|both|host] [--device cuda|cpu] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ials policy_rollout \\
      --domain traffic --n-agents 25 --batch 64 --horizon 128 --mesh pod1
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device, stream
from repro_torch.core import engine, influence
from repro_torch.distributed import op_analysis, sharding
from repro_torch.envs.api import horizon_noise
from repro_torch.envs.traffic import (TrafficConfig,
                                      make_batched_local_traffic_env)
from repro_torch.envs.warehouse import (WarehouseConfig,
                                        make_batched_local_warehouse_env)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.rl import ppo
from repro_torch.tree import tree_leaves, tree_map

RESULTS = (Path(__file__).resolve().parents[3] / "results" / "tmp"
           / "dryrun_torch")
COUNTED_ON = "cpu, plain route"

IALS_PROGRAMS = ("aip_rollout_multi", "fnn_rollout", "policy_rollout",
                 "train_iteration")

# (program, domain, backbone, A, B, T, mesh): the reference's committed
# sweep, every program, A in {1, 25, 36} (the full 5x5 traffic grid / 6x6
# warehouse floor), a B sweep, both domains, both backbones, pod1 + pod2
IALS_SWEEP = [
    ("aip_rollout_multi", "traffic", "gru", 25, 64, 128, "pod1"),
    ("aip_rollout_multi", "warehouse", "gru", 36, 64, 128, "pod1"),
    ("aip_rollout_multi", "warehouse", "gru", 1, 512, 128, "pod1"),
    ("fnn_rollout", "traffic", "fnn", 1, 512, 128, "pod1"),
    ("fnn_rollout", "traffic", "fnn", 25, 64, 128, "pod1"),
    ("fnn_rollout", "warehouse", "fnn", 36, 64, 128, "pod1"),
    ("policy_rollout", "traffic", "fnn", 25, 64, 128, "pod1"),
    ("policy_rollout", "warehouse", "gru", 36, 64, 128, "pod1"),
    ("train_iteration", "traffic", "fnn", 1, 256, 128, "pod1"),
    ("train_iteration", "warehouse", "gru", 1, 256, 128, "pod1"),
    ("aip_rollout_multi", "warehouse", "gru", 36, 64, 128, "pod2"),
    ("policy_rollout", "traffic", "fnn", 25, 64, 128, "pod2"),
]


def _ials_mesh(mesh_name: str):
    """pod1 / pod2: the pods' layouts; "host": this process alone."""
    if mesh_name == "host":
        return mesh_mod.MeshLayout(("data", "model"), (1, 1))
    return mesh_mod.make_production_mesh(multi_pod=(mesh_name == "pod2"))


def _ials_model_flops(program: str, acfg, pcfg, B: int, A: int,
                      T: int) -> float:
    """Analytic useful-FLOP lower bound: the matmul flops the modeled
    networks MUST do (2*m*k*n per GEMM), times lanes x ticks. Elementwise
    tick work and the LS transition are excluded, so the ratio reported
    against the op count is conservative."""
    H = acfg.hidden
    if acfg.kind == "gru":
        f_aip = 2.0 * (acfg.d_in * 3 * H + H * 3 * H + H * acfg.n_out)
    else:
        f_aip = 2.0 * (acfg.stack * acfg.d_in * H + H * H
                       + H * acfg.n_out)
    lanes = float(T) * B * A
    if program in ("aip_rollout_multi", "fnn_rollout"):
        return lanes * f_aip
    Hp = pcfg.hidden
    f_pol = 2.0 * (pcfg.frame_stack * pcfg.obs_dim * Hp + Hp * Hp
                   + Hp * (pcfg.n_actions + 1))
    if program == "policy_rollout":
        return lanes * (f_aip + f_pol)
    # train_iteration: the acting rollout plus epochs x (fwd + bwd ~ 3x
    # fwd) policy passes over every collected sample
    return lanes * (f_aip + f_pol) + pcfg.epochs * lanes * 3.0 * f_pol


def _ials_cell_filename(program, domain, backbone, A, B, T, mesh) -> str:
    return (f"ials_{program}__{domain}_{backbone}_A{A}_B{B}_T{T}"
            f"__{mesh}.json")


def _backbone(program: str, backbone: str) -> str:
    """The horizon programs fix their backbone, as the reference's do."""
    return {"aip_rollout_multi": "gru", "fnn_rollout": "fnn"}.get(
        program, backbone)


def ranks_refuse(batch: int, n_agents: int, layout):
    """The message ``sharding.require_lane_sharding`` refuses the layout
    with under ``torch.distributed``, or None."""
    try:
        sharding.require_lane_sharding(batch, n_agents, layout)
    except ValueError as e:
        return str(e)
    return None


def _nbytes(*trees) -> int:
    return sum(l.numel() * l.element_size() for t in trees
               for l in tree_leaves(t) if isinstance(l, torch.Tensor))


class IalsProgram(NamedTuple):
    """One cell's program as rank 0 of its layout runs it:
    ``fn(*args)``. ``held`` is what the rank holds besides its arguments
    (the engine's AIP weights, its block)."""
    fn: Callable
    args: tuple
    held: object
    n_params: int
    model_flops: float


def ials_program(program: str, domain: str, backbone: str, n_agents: int,
                 batch: int, horizon: int, layout, device) -> IalsProgram:
    """Build a cell's program on ``device`` (module docstring), rank 0's
    block of every input. Its random weights and streams are drawn on the
    CPU from seed 0 and moved to ``device``, so a program built on the
    card takes the inputs of the one the CPU counts."""
    if program not in IALS_PROGRAMS:
        raise ValueError(f"unknown IALS program {program!r} (one of "
                         f"{IALS_PROGRAMS})")
    backbone = _backbone(program, backbone)
    A, B, T = n_agents, batch, horizon
    cpu, dev = torch.device("cpu"), torch.device(device)

    def local_env(d):
        if domain == "traffic":
            return make_batched_local_traffic_env(TrafficConfig(), d), 1
        return make_batched_local_warehouse_env(WarehouseConfig(), d), 8
    bls_cpu, frame_stack = local_env(cpu)
    bls = bls_cpu if dev == cpu else local_env(dev)[0]
    spec = bls.spec
    acfg = influence.AIPConfig(
        kind=backbone, d_in=spec.dset_dim, n_out=spec.n_influence,
        hidden=64, stack=8 if backbone == "fnn" else 1)
    gen = stream(cpu, 0, 0)

    def to_dev(tree):
        return tree_map(lambda l: l.to(dev), tree)
    aip = (influence.init_aip_stacked(acfg, gen, A) if A > 1
           else influence.init_aip(acfg, gen))
    n_params = _nel(aip)
    rank = (sharding.LayoutRank(layout) if sharding.mesh_size(layout) > 1
            else None)
    whole = engine.make_unified_ials(bls_cpu, aip, acfg, n_agents=A)
    aip = to_dev(aip)
    env = engine.make_unified_ials(bls, aip, acfg, n_agents=A, mesh=rank)
    held = sharding.shard_ials_aip_params(aip, rank, A)

    def state_block(tree):
        return sharding.shard_ials_state(to_dev(tree), rank, A)

    def stream_block(tree):
        return sharding.shard_ials_stream(to_dev(tree), rank, B, A)

    def noise_block(noise):
        """The engine's T-stacked noise: bits (T, B, [A,] M) and LS noise
        (T, B*A, ...) lanes batch-major, as ``noise_fn`` lays them out."""
        def env_leaf(l):
            if A == 1:
                return stream_block(l)
            blk = stream_block(l.reshape((T, B, A) + l.shape[2:]))
            return blk.reshape((T, -1) + l.shape[2:])
        return {"bits": stream_block(noise["bits"]),
                "env": tree_map(env_leaf, noise["env"])}

    if program in ("aip_rollout_multi", "fnn_rollout"):
        model_flops = _ials_model_flops(program, acfg, None, B, A, T)
        state = whole.reset(gen, B)
        actions = torch.randint(0, spec.n_actions,
                                (T, B) + ((A,) if A > 1 else ()),
                                generator=gen, dtype=torch.int32)
        noise = horizon_noise(whole.noise_fn, gen, T, B)
        return IalsProgram(
            env.rollout, (state_block(state), stream_block(actions),
                          noise_block(noise)), held, n_params, model_flops)
    pcfg = ppo.PPOConfig(obs_dim=spec.obs_dim, n_actions=spec.n_actions,
                         frame_stack=frame_stack, n_envs=B, rollout_len=T,
                         episode_len=T, n_agents=A)
    model_flops = _ials_model_flops(program, acfg, pcfg, B, A, T)
    pol = ppo.init_policy(pcfg, gen)
    n_params += _nel(pol)
    pol = to_dev(pol)
    rs = ppo.shard_rollout(to_dev(ppo.init_rollout_state(whole, pcfg, gen)),
                           rank, A)
    gum, env_noise, resets = ppo.draw_rollout_streams(whole, pcfg, gen)
    streams = (stream_block(gum), noise_block(env_noise),
               stream_block(resets))
    if program == "policy_rollout":
        def rollout(pol, rs, streams):
            return ppo.rollout(env, pcfg, pol, rs, streams=streams,
                               mesh=rank)
        return IalsProgram(rollout, (pol, rs, streams), held, n_params,
                           model_flops)
    opt = ppo.make_optimizer(pcfg)
    iteration = ppo.train_iteration_fn(env, pcfg, opt, mesh=rank)
    total = T * B * A                   # the learner's (global) samples
    perms = to_dev(torch.stack([torch.randperm(total, generator=gen)
                                for _ in range(pcfg.epochs)]))

    def train_iteration(pol, opt_state, rs, streams, perms):
        return iteration(pol, opt_state, rs, None, streams, perms)
    return IalsProgram(train_iteration,
                       (pol, opt.init(pol), rs, streams, perms), held,
                       n_params, model_flops)


def _nel(tree) -> int:
    return sum(int(l.numel()) for l in tree_leaves(tree))


def count_ials_program(prog: IalsProgram, program: str, domain: str,
                       backbone: str, n_agents: int, batch: int,
                       horizon: int, mesh_name: str):
    """Count ``prog`` (a cell's program built on the CPU by
    ``ials_program``) -> (the cell's JSON record, the program's output on
    the CPU's plain route)."""
    n_chips = sharding.mesh_size(_ials_mesh(mesh_name))
    t0 = time.perf_counter()
    with op_analysis.OpCounter() as counter:
        out = prog.fn(*prog.args)
    count_s = time.perf_counter() - t0
    ops = counter.result()
    backbone = _backbone(program, backbone)
    A, B, T = n_agents, batch, horizon
    cell = {
        "arch": f"ials_{program}",
        "shape": f"{domain}_{backbone}_A{A}_B{B}_T{T}", "mesh": mesh_name,
        "status": "ok", "family": "ials", "program": program,
        "domain": domain, "backbone": backbone, "n_agents": A, "batch": B,
        "horizon": T, "n_chips": n_chips, "count_s": count_s,
        "counted_on": COUNTED_ON, "params_total": prog.n_params,
        "params_active": prog.n_params,
        "memory": {
            "argument_bytes_per_device": _nbytes(prog.args, prog.held),
            "output_bytes_per_device": _nbytes(out),
            "peak_bytes_per_device": None,
            "peak_not_measured": "counted on the CPU; only a host cell "
                                 "run on the card measures it",
        },
        "ops": ops,
        "roofline": op_analysis.roofline(ops, n_chips, prog.model_flops),
    }
    refuse = ranks_refuse(B, A, _ials_mesh(mesh_name))
    if refuse is not None:
        cell["ranks_refuse"] = refuse
    return cell, out


def count_ials_cell(program: str, domain: str, backbone: str,
                    n_agents: int, batch: int, horizon: int,
                    mesh_name: str) -> dict:
    """Count one cell on the CPU (module docstring) -> the cell's JSON
    record."""
    row = (program, domain, backbone, n_agents, batch, horizon)
    prog = ials_program(*row, _ials_mesh(mesh_name), "cpu")
    return count_ials_program(prog, *row, mesh_name)[0]


def measure_ials_program(prog: IalsProgram, cell: dict):
    """Run ``prog`` (built on the card) once and write what the run
    measures into ``cell``: its kernel launches (``launches``, and their
    sum as ``ops.custom_call_count``), the argument and output bytes, and
    the peak: the bytes the rank holds (arguments, weights) plus the most
    the run allocated above what was live before it (other tensors of
    the process left out). -> the run's output."""
    from repro_torch.kernels import aip_step
    dev = tree_leaves(prog.args)[0].device
    held = _nbytes(prog.args, prog.held)
    gc.collect()
    torch.cuda.synchronize(dev)
    before = dict(aip_step.LAUNCHES)
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    out = prog.fn(*prog.args)
    torch.cuda.synchronize(dev)
    peak = held + torch.cuda.max_memory_allocated(dev) - live
    launches = {k: v - before[k] for k, v in aip_step.LAUNCHES.items()
                if v != before[k]}
    cell["launches"] = launches
    cell["ops"]["custom_call_count"] = sum(
        v for k, v in launches.items() if "[" not in k)
    cell["measured_on"] = torch.cuda.get_device_name(dev)
    cell["memory"] = {
        "argument_bytes_per_device": held,
        "output_bytes_per_device": _nbytes(out),
        "peak_bytes_per_device": peak,
    }
    return out


def run_ials_cell(program, domain, backbone, n_agents, batch, horizon,
                  mesh_name, device="cuda") -> dict:
    """Count a cell on the CPU; on the card, a ``host`` cell's program also
    runs once there (``measure_ials_program``)."""
    dev = resolve_device(device)
    cell = count_ials_cell(program, domain, backbone, n_agents, batch,
                           horizon, mesh_name)
    if dev.type == "cuda" and mesh_name == "host":
        prog = ials_program(program, domain, backbone, n_agents, batch,
                            horizon, _ials_mesh("host"), dev)
        measure_ials_program(prog, cell)
    return cell


def _write(cell: dict, out: Path):
    fn = out / _ials_cell_filename(
        cell["program"], cell["domain"], cell["backbone"], cell["n_agents"],
        cell["batch"], cell["horizon"], cell["mesh"])
    fn.write_text(json.dumps(cell, indent=1))
    print(json.dumps({k: cell[k] for k in ("arch", "shape", "mesh",
                                           "status")}), flush=True)
    r, mem = cell["roofline"], cell["memory"]
    peak = mem["peak_bytes_per_device"]
    print(f"  count={cell['count_s']:.2f}s  peak_mem/dev="
          + (f"{peak / 2**20:.2f}MiB" if peak is not None
             else "not measured")
          + f"  t_comp={r['t_compute_s']:.6f}s t_mem={r['t_memory_s']:.6f}s"
          f" (unfused plain route) t_coll={r['t_collective_s']:.6f}s  -> "
          f"{r['bottleneck']}"
          + ("  [ranks refuse this layout]" if "ranks_refuse" in cell
             else ""), flush=True)


def _sweep_rows(mesh: str):
    """The sweep's rows for ``--mesh``: every row on host; pod2's rows
    alone; else (pod1, both) every row on its own mesh."""
    for prog, dom, bk, A, B, T, row_mesh in IALS_SWEEP:
        if mesh == "host":
            yield prog, dom, bk, A, B, T, "host"
        elif mesh != "pod2" or row_mesh == "pod2":
            yield prog, dom, bk, A, B, T, row_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ials", default=None, metavar="PROGRAM",
                    help="one of " + ", ".join(IALS_PROGRAMS) + ", or "
                         "'all' for the sweep")
    ap.add_argument("--domain", default="traffic",
                    choices=["traffic", "warehouse"])
    ap.add_argument("--backbone", default=None, choices=["gru", "fnn"])
    ap.add_argument("--n-agents", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--mesh", default="pod1",
                    choices=["pod1", "pod2", "both", "host"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=RESULTS)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.arch or args.shape or args.all:
        ap.error("the LM half of the dry-run (--arch / --shape / --all, "
                 "run_cell) is not ported: it comes with the LM training "
                 "and sharding slice")
    if not args.ials:
        ap.error("--ials PROGRAM|all is required")
    resolve_device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    if args.ials == "all":
        rows = list(_sweep_rows(args.mesh))
    else:
        backbone = args.backbone or (
            "gru" if args.domain == "warehouse" else "fnn")
        rows = [(args.ials, args.domain, backbone, args.n_agents,
                 args.batch, args.horizon,
                 "pod1" if args.mesh == "both" else args.mesh)]
    for row in rows:
        _write(run_ials_cell(*row, device=args.device),
               args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
