"""The dry-run on the H100 (counterpart of ``repro/launch/dryrun.py``):
what each program of a cell costs on one rank of the pods' layouts.

Two cell families, as in the reference:

- the LM cells (``--arch/--shape``, ``run_cell``): the sharded train,
  prefill or decode step of an LM config at its full width and depth;
- the IALS cells (``--ials``): this repo's whole-horizon programs.

How an LM cell is counted. Rank 0 of the pod1 (16 x 16) or pod2
(2 x 16 x 16) layout joins a fake process group of the layout's size
(``torch.testing._internal.distributed.fake_pg``: its collectives do
nothing) and builds the layout's ``DeviceMesh`` on it; under
``FakeTensorMode`` (nothing is allocated) every input is a ``DTensor``
of rank 0's fake local block on its spec (``distributed/sharding.py``:
the parameters from ``lm.param_shapes``, AdamW's state, the inputs of
``launch/specs.py``, the decode cache). The step
(``launch/steps.py``: ``make_train_step`` with ``cfg.force_microbatches
or shape.n_microbatches``, ``make_prefill_step``, ``make_serve_step`` at
the cache's last slot) runs under ``act_sharding.use_mesh`` and
``op_analysis.OpCounter``: the rank's local ops count, and the
collectives DTensor and the expert-parallel route issue count by kind
with their operand bytes. The roofline takes the reference's model
FLOPs (6 N D for train, 2 N D for prefill and decode, N the active
non-embedding parameters). ``memory.argument_bytes_per_device`` is the
sum of rank 0's local blocks; a fake run measures no peak, so
``peak_bytes_per_device`` is ``null`` with the reason.

Loops. The reference runs the decoder's layer groups, whisper's encoder
layers and a train step's microbatches under ``lax.scan``, and its
``hlo_analysis`` multiplies a body's count by the trip count. The port's
loops are Python loops that dispatch every iteration, so a cell is
counted at a few trip counts and extrapolated (``lm_trips``,
``trip_points``, ``at_trips``). The count is linear in each of these
loops from 2 trips on (one group leaves a stacked dim of size 1, which
DTensor gathers another way; one microbatch takes ``make_train_step``'s
path without a split or an accumulation) and multilinear across them
(every group runs once a microbatch), so the counts at two trip counts
a, b of each loop give the full count N exactly: a point's weight is the
product over loops of (b - N) / (b - a) or (N - a) / (b - a). A point
keeps the cell's widths: its config has the point's groups
(``n_layers``) and encoder layers, its batch the point's microbatches of
the full cell's rows each, and a trip count qualifies only where every
argument shards as in the full cell (the moments' widening and the
batch's axes follow divisibility). A loop extrapolates where that
counts fewer layers than its full count would; the rest count every
iteration. Every number the counter reports, and the step's output and
alias bytes, is that weighted sum of the points' (in integers: exact);
the argument bytes come from the full-depth arguments. ``counted_by``
says how (``"extrapolated"``, or ``"every iteration"``: ``exact=True``,
and ``record=True``, whose per-(op, shapes) rows do not extrapolate);
``trips`` holds the full trip counts and each point counted. The loops
over the sequence (the loss chunks, ``nn/ssm.py``'s chunks and steps)
depend on T and count iteration by iteration.

The IALS cells:

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
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh pod1 [--overrides JSON] [--tag T]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh pod1|pod2|both] [--force] [--jobs N]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ials all \\
      [--mesh pod1|pod2|both|host] [--device cuda|cpu] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ials policy_rollout \\
      --domain traffic --n-agents 25 --batch 64 --horizon 128 --mesh pod1
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

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
LM_COUNTED_ON = "rank 0 of a fake process group, fake tensors"
CELL_TIMEOUT_S = 7200        # a sweep cell's subprocess, as the reference's


# ---------------------------------------------------------------------------
# LM cells: the sharded train / prefill / decode step of a config
# ---------------------------------------------------------------------------

def _lm_layout(mesh_name: str):
    if mesh_name not in ("pod1", "pod2"):
        raise ValueError(f"an LM cell's mesh is pod1 or pod2, not "
                         f"{mesh_name!r}")
    layout = mesh_mod.make_production_mesh(multi_pod=(mesh_name == "pod2"))
    if not isinstance(layout, mesh_mod.MeshLayout):
        raise RuntimeError("an LM cell is counted in a fake process group "
                           "of its own: none may be initialised")
    return layout


def _counted_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's ``Shard(gather_dim)`` -> ``Shard(shard_dim)`` in a count:
    one all-to-all of the rank's block, noted as such (torch's route for a
    "cpu" mesh, which the fake group's is, would make it an all-gather and
    a chunk); it returns rank 0's block, uninitialised (fake data)."""
    n = mesh.size(mesh_dim)
    op_analysis.note_collective("all-to-all", input)
    shape = list(input.shape)
    shape[shard_dim] = -(-shape[shard_dim] // n)
    shape[gather_dim] *= n
    return input.new_empty(shape)


@contextlib.contextmanager
def fake_ranks(layout):
    """This process as rank 0 of a fake process group of ``layout``'s size
    (its collectives do nothing) and the layout's ``DeviceMesh`` on it,
    DTensor's all-to-alls counted as such (``_counted_alltoall``); the
    group is destroyed on exit."""
    import torch.distributed.tensor.placement_types as placement_types
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=layout.size)
    alltoall = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _counted_alltoall
    try:
        yield init_device_mesh("cpu", layout.shape,
                               mesh_dim_names=layout.axis_names)
    finally:
        placement_types.shard_dim_alltoall = alltoall
        dist.destroy_process_group()


def _fake_dtensors(tree, specs, mesh):
    """Each (meta) leaf of ``tree`` -> a ``DTensor`` of its global shape on
    its spec whose local block is rank 0's, a fake tensor (call under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    sizes = sharding._view(mesh).shape
    zero = {a: 0 for a in sizes}

    def one(keys, leaf):
        spec = sharding._lookup(specs, keys)
        local = list(leaf.shape)
        for d, entry in enumerate(spec):
            local[d] //= sharding._block_index(entry, sizes, zero)[1]
        blk = torch.empty(local, dtype=leaf.dtype, device="cpu")
        stride = torch.empty(leaf.shape, device="meta").stride()
        return DTensor.from_local(blk, mesh,
                                  sharding.to_placements(spec, mesh),
                                  run_check=False, shape=leaf.shape,
                                  stride=stride)
    return sharding._map_with_keys(one, tree)


def _local_nbytes(*trees) -> int:
    total = 0
    for t in trees:
        for x in tree_leaves(t):
            if isinstance(x, torch.Tensor):
                loc = x.to_local() if hasattr(x, "to_local") else x
                total += loc.numel() * loc.element_size()
    return total


def _global_nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for t in trees
               for x in tree_leaves(t) if isinstance(x, torch.Tensor))


def lm_model_flops(cfg, shape) -> float:
    """The reference's model FLOPs: 6 N D (train) / 2 N D (prefill,
    decode), N the active non-embedding parameters, D the tokens."""
    from repro_torch.models import lm
    counts = lm.count_params(cfg)
    n_active = counts["active"] - counts["embed"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind] \
        * n_active * tokens


def lm_cell_inputs(cfg, shape, mesh) -> list:
    """-> [(meta tree, spec tree)] of a cell's step arguments, in order
    (``mesh`` a ``DeviceMesh`` or a ``MeshLayout``): the parameters,
    then AdamW's state and the batch (train), the prompt (prefill) or the
    decode cache and token."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw
    sharding.set_moe_expert_axes(cfg.moe_expert_axes)
    pshapes = lm.param_shapes(cfg)
    pspecs = sharding.param_specs(pshapes, mesh, cfg.parallelism)
    out = [(pshapes, pspecs)]
    if shape.kind == "train":
        state = adamw(1e-4).init(pshapes)
        out.append((state, sharding.opt_state_specs(state, mesh, pspecs)))
        out.append(specs_lib.train_input_specs(cfg, shape, mesh))
    elif shape.kind == "prefill":
        out.append(specs_lib.prefill_input_specs(cfg, shape, mesh))
    else:
        inputs = specs_lib.decode_input_specs(cfg, shape, mesh)
        tensors, specs = dict(inputs.tensors), dict(inputs.specs)
        tensors.pop("pos")
        specs.pop("pos")
        out.append((tensors, specs))
    return [tuple(x) for x in out]


def lm_cell_program(cfg, shape, mesh):
    """-> (step, args) of a cell on ``mesh`` (a ``DeviceMesh`` of a fake
    process group; call under ``FakeTensorMode``): every argument a
    ``DTensor`` of rank 0's block on its spec, AdamW's step a host int."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim.adamw import adamw
    args = [_fake_dtensors(t, s, mesh)
            for t, s in lm_cell_inputs(cfg, shape, mesh)]
    if shape.kind == "train":
        n_micro = cfg.force_microbatches or shape.n_microbatches
        step = steps_lib.make_train_step(cfg, adamw(1e-4), n_micro)
        return step, (args[0], args[1]._replace(step=0), args[2])
    if shape.kind == "prefill":
        return steps_lib.make_prefill_step(cfg, shape.seq_len), tuple(args)
    d = args[1]
    # the cache's last slot: the step attends over every position
    return steps_lib.make_serve_step(cfg), (args[0], d["cache"], d["token"],
                                            shape.seq_len - 1)


def _check_counter(mesh):
    """The counter must see a ``DTensor`` product as rank 0's local one
    (not DTensor's propagation on the global shapes)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n = mesh.size(0)
    x = DTensor.from_local(torch.empty(8, 4), mesh,
                           [Shard(0)] + [Replicate()] * (mesh.ndim - 1),
                           run_check=False)
    w = DTensor.from_local(torch.empty(4, 2), mesh,
                           [Replicate()] * mesh.ndim, run_check=False)
    with op_analysis.OpCounter() as c:
        x @ w
    if c.flops_dot != 2.0 * 8 * 4 * 2:
        raise RuntimeError(
            f"the op counter saw {c.flops_dot} FLOPs for a local (8, 4) x "
            f"(4, 2) product on a {n}-way sharded DTensor: this torch's "
            f"DTensor propagation is not hidden from it")


# the least trip count from which a loop's count is linear in it
LINEAR_FROM = {"groups": 2, "encoder_layers": 2, "microbatches": 2}


def lm_trips(cfg, shape) -> dict:
    """The loops of a cell the reference scans over -> their full trip
    counts: ``groups`` (the decoder's layer groups), ``encoder_layers``
    (whisper), ``microbatches`` (a train step)."""
    trips = {"groups": cfg.layer_plan()[2]}
    if cfg.family == "encdec":
        trips["encoder_layers"] = cfg.n_encoder_layers
    if shape.kind == "train":
        trips["microbatches"] = cfg.force_microbatches or \
            shape.n_microbatches
    return trips


def at_trips(cfg, shape, point: dict):
    """``cfg`` and ``shape`` with the loops' trip counts set to ``point``'s
    (a microbatch keeps the full cell's rows)."""
    prologue, pattern, _ = cfg.layer_plan()
    kw = {"n_layers": len(prologue) + point["groups"] * len(pattern)}
    if "encoder_layers" in point:
        kw["n_encoder_layers"] = point["encoder_layers"]
    if "microbatches" in point:
        m = point["microbatches"]
        rows = shape.global_batch // lm_trips(cfg, shape)["microbatches"]
        kw["force_microbatches"] = m
        shape = dataclasses.replace(shape, global_batch=rows * m,
                                    n_microbatches=m)
    out = cfg.with_overrides(**kw)
    if out.layer_plan()[2] != point["groups"]:
        raise ValueError(f"{cfg.name}: {kw['n_layers']} layers give "
                         f"{out.layer_plan()[2]} groups, not "
                         f"{point['groups']}")
    return out, shape


def _signature(cfg, shape, mesh, point: dict) -> list:
    """The spec trees of the arguments at ``point``'s trip counts: equal to
    the full cell's where the point shards every argument alike (the
    moments' widening and the batch's axes follow divisibility)."""
    return [spec for _, spec in lm_cell_inputs(*at_trips(cfg, shape, point),
                                               mesh)]


def _layer_runs(cfg, point: dict) -> int:
    """A point's cost in layer applications: its layers times its
    microbatches."""
    prologue, pattern, _ = cfg.layer_plan()
    layers = len(prologue) + point["groups"] * len(pattern) + \
        point.get("encoder_layers", 0)
    return layers * point.get("microbatches", 1)


def trip_points(cfg, shape, mesh, extrapolate=None) -> dict:
    """-> {loop: the trip counts it is counted at}. A loop extrapolates
    from the two least counts from ``LINEAR_FROM[loop]`` on, below its
    full count, at which every argument shards as in the full cell (the
    other loops full); any other loop is counted at its full count.
    ``extrapolate`` names the loops that may extrapolate (``()``: none,
    every iteration); ``None`` takes the set whose points run the fewest
    layer applications (``_layer_runs``), none where that is not fewer
    than the full cell's. Where a combination of the points shards
    otherwise, every loop is counted at its full count."""
    trips = lm_trips(cfg, shape)
    axes = {name: [n] for name, n in trips.items()}
    if extrapolate == ():
        return axes
    full = _signature(cfg, shape, mesh, trips)
    cand = {}
    for name, n in trips.items():
        if extrapolate is not None and name not in extrapolate:
            continue
        ok = []
        for k in range(LINEAR_FROM[name], n):
            if _signature(cfg, shape, mesh, dict(trips, **{name: k})) \
                    == full:
                ok.append(k)
                if len(ok) == 2:
                    cand[name] = ok
                    break
    plans = [dict(axes, **{n: cand[n] for n in names})
             for k in range(len(cand) + 1)
             for names in itertools.combinations(cand, k)]
    if extrapolate is not None:
        plans = plans[-1:]
    best = min(plans, key=lambda ax: sum(
        _layer_runs(cfg, dict(zip(ax, c)))
        for c in itertools.product(*ax.values())))
    for c in itertools.product(*best.values()):
        if _signature(cfg, shape, mesh, dict(zip(best, c))) != full:
            return axes
    return best


def _weights(axes: dict, trips: dict, point: dict) -> Fraction:
    """A point's weight in the multilinear form that takes the points'
    counts to the full trip counts' (1 on a loop counted as it is)."""
    w = Fraction(1)
    for name, ps in axes.items():
        if len(ps) == 2:
            a, b, n = ps[0], ps[1], trips[name]
            w *= Fraction(n - a if point[name] == b else b - n, b - a)
    return w


def _combine(values: list, weights: list):
    """sum(w * v) over nested dicts of numbers (a missing key is 0), in
    exact rationals where every value is an integer (a count linear in
    the loops comes out an integer)."""
    if any(isinstance(v, dict) for v in values):
        keys = list(dict.fromkeys(k for v in values for k in v))
        return {k: _combine([v.get(k, 0) for v in values], weights)
                for k in keys}
    if all(float(v).is_integer() for v in values):
        total = sum(w * int(v) for w, v in zip(weights, values))
        if total.denominator == 1:
            return float(total.numerator) if any(
                isinstance(v, float) for v in values) else total.numerator
    return float(sum(float(w) * v for w, v in zip(weights, values)))


def _count_program(cfg, shape, mesh, record: bool):
    """Count one step of ``cfg`` / ``shape`` on ``mesh`` -> (the counter,
    its argument, global argument, output and alias bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.act_sharding import use_mesh
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = lm_cell_program(cfg, shape, mesh)
        with op_analysis.OpCounter(record=record) as counter, \
                use_mesh(mesh, cfg.parallelism):
            out = step(*args)
        ins = {id(x) for x in tree_leaves(args)}
        nbytes = {
            "argument": _local_nbytes(args),
            "global": _global_nbytes(args),
            "output": _local_nbytes(out),
            "alias": sum(_local_nbytes(x) for x in tree_leaves(out)
                         if id(x) in ins)}
    return counter, nbytes


def _argument_bytes(cfg, shape, mesh) -> dict:
    """The full-depth arguments' local and global bytes (built, not
    run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        _, args = lm_cell_program(cfg, shape, mesh)
        return {"argument": _local_nbytes(args),
                "global": _global_nbytes(args)}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             overrides: dict | None = None, *, record: bool = False,
             exact: bool = False):
    """Count one LM cell (module docstring) -> its JSON record; with
    ``record`` -> (record, the counter's ``rows()``). ``exact`` (implied
    by ``record``) counts every iteration of every loop; else the loops
    extrapolate where that counts fewer layers (``trip_points``)."""
    from repro_torch.configs.base import SHAPES, cell_applicable, get_config
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    shape = SHAPES[shape_name]
    layout = _lm_layout(mesh_name) if cell_applicable(cfg, shape)[0] \
        else None
    return count_cell(cfg, shape, layout, mesh_name, record=record,
                      extrapolate=() if exact else None)


def count_cell(cfg, shape, layout, mesh_name: str, *, record: bool = False,
               extrapolate=None):
    """``run_cell`` on a config, a ``ShapeCell`` and a layout (any
    ``MeshLayout``; ``mesh_name`` names it in the record); ``extrapolate``
    as ``trip_points`` takes it (``()``: every iteration)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import cell_applicable
    from repro_torch.models import lm
    arch = cfg.name
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        cell = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": reason}
        return (cell, []) if record else cell
    n_chips = layout.size
    if record:
        extrapolate = ()
    trips = lm_trips(cfg, shape)
    t0 = time.perf_counter()
    with fake_ranks(layout) as mesh:
        with FakeTensorMode(allow_non_fake_inputs=True):
            _check_counter(mesh)
        axes = trip_points(cfg, shape, mesh, extrapolate)
        points = [dict(zip(axes, c)) for c in itertools.product(
            *axes.values())]
        results, point_log = [], []
        for point in points:
            t1 = time.perf_counter()
            counter, nbytes = _count_program(*at_trips(cfg, shape, point),
                                             mesh, record)
            results.append((counter, nbytes))
            point_log.append(dict(point, count_s=time.perf_counter() - t1))
        every = points == [trips]
        nbytes = results[0][1] if every else _argument_bytes(cfg, shape,
                                                             mesh)
    count_s = time.perf_counter() - t0
    weights = [_weights(axes, trips, p) for p in points]
    ops = _combine([c.result() for c, _ in results], weights)
    moved = _combine([{k: b[k] for k in ("output", "alias")}
                      for _, b in results], weights)
    counts = lm.count_params(cfg)
    cell = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "family": cfg.family, "kind": shape.kind,
        "parallelism": cfg.parallelism, "n_chips": n_chips,
        "n_microbatches": trips.get("microbatches", 1),
        "count_s": count_s, "counted_on": LM_COUNTED_ON,
        "counted_by": "every iteration" if every else "extrapolated",
        "trips": dict(trips, points=point_log),
        "params_total": counts["total"], "params_active": counts["active"],
        "memory": {
            "argument_bytes_per_device": nbytes["argument"],
            "argument_bytes_global_over_chips": nbytes["global"] / n_chips,
            "output_bytes_per_device": moved["output"],
            "alias_bytes_per_device": moved["alias"],
            "peak_bytes_per_device": None,
            "peak_not_measured": "counted on fake tensors: nothing is "
                                 "allocated",
        },
        "ops": ops,
        "roofline": op_analysis.roofline(ops, n_chips,
                                         lm_model_flops(cfg, shape)),
    }
    # the model FLOPs alone at the card's peak for their dtype
    rf = cell["roofline"]
    rf["model_flops_bound_s"] = rf["model_flops_total"] / n_chips / \
        op_analysis.peak_flops(cfg.dtype())
    return (cell, results[0][0].rows()) if record else cell


def _lm_cell_filename(arch, shape, mesh, tag="") -> str:
    return f"{arch}__{shape}__{mesh}{tag}.json"


def _write_lm(cell: dict, fn: Path):
    fn.write_text(json.dumps(cell, indent=1))
    print(json.dumps({k: cell[k] for k in ("arch", "shape", "mesh",
                                           "status") if k in cell}),
          flush=True)
    if cell.get("status") != "ok":
        return
    r, mem = cell["roofline"], cell["memory"]
    print(f"  count={cell['count_s']:.1f}s  args/dev="
          f"{mem['argument_bytes_per_device'] / 2**30:.3f}GiB (global/"
          f"chips {mem['argument_bytes_global_over_chips'] / 2**30:.3f}GiB)"
          f"  coll={cell['ops']['collective_bytes_total'] / 2**30:.3f}GiB"
          f"  t_comp={r['t_compute_s']:.4f}s t_mem={r['t_memory_s']:.4f}s "
          f"(unfused) t_coll={r['t_collective_s']:.4f}s  model-FLOP "
          f"bound={r['model_flops_bound_s']:.4f}s  -> {r['bottleneck']}",
          flush=True)


def _lm_sweep(args):
    """Every (arch, shape, mesh) cell, one subprocess each, ``--jobs`` at
    a time (a crash is recorded as status "error"; ``cell_applicable``'s
    refusals are written as the status; a written cell is skipped unless
    ``--force``)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs.base import (SHAPES, cell_applicable,
                                          get_config, list_configs)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    todo = []
    for arch in list_configs():
        for shape in SHAPES:
            for mesh in meshes:
                fn = args.out / _lm_cell_filename(arch, shape, mesh,
                                                  args.tag)
                if fn.exists() and not args.force:
                    print(f"skip (cached): {fn.name}", flush=True)
                    continue
                ok, reason = cell_applicable(get_config(arch),
                                             SHAPES[shape])
                if not ok:
                    fn.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh,
                        "status": reason}))
                    print(f"{arch} {shape} {mesh}: {reason}", flush=True)
                    continue
                todo.append((arch, shape, mesh, fn))

    def count(cell):
        arch, shape, mesh, fn = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(args.out), "--tag", args.tag]
        if args.overrides:
            cmd += ["--overrides", args.overrides]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=CELL_TIMEOUT_S, env=env)
            rc, out, err = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = -1, "", f"overran {CELL_TIMEOUT_S} s: {e}"
        print(f"=== {arch} {shape} {mesh} ===\n{out[-2000:]}", flush=True)
        if rc != 0:
            print("FAILED:", err[-3000:], flush=True)
            fn.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh,
                "status": "error", "stderr": err[-3000:]}))

    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        list(pool.map(count, todo))


# ---------------------------------------------------------------------------
# IALS cells
# ---------------------------------------------------------------------------

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
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ArchConfig overrides")
    ap.add_argument("--tag", default="",
                    help="suffix of the result's file name")
    ap.add_argument("--force", action="store_true",
                    help="--all: recount cells already written")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells counted at a time")
    args = ap.parse_args(argv)
    if args.all or args.arch or args.shape:
        # LM cells: counted only, on fake tensors (no device runs them)
        if args.mesh == "host":
            ap.error("LM cells run on --mesh pod1, pod2 or both")
        args.out.mkdir(parents=True, exist_ok=True)
        if args.all:
            _lm_sweep(args)
            return 0
        if not (args.arch and args.shape):
            ap.error("--arch and --shape go together (or --all)")
        overrides = json.loads(args.overrides) if args.overrides else None
        meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
        for mesh in meshes:
            cell = run_cell(args.arch, args.shape, mesh, overrides)
            _write_lm(cell, args.out / _lm_cell_filename(
                args.arch, args.shape, mesh, args.tag))
        return 0
    if not args.ials:
        ap.error("--ials PROGRAM|all, or --arch/--shape, or --all is "
                 "required")
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
