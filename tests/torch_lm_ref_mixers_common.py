"""The LM parity runs of the port and the reference, and the 4-rank spawn
that runs them side by side.

Shared by ``tests/test_torch_lm_sharding_ref_mixers.py`` (the ranks'
scripts ``LM`` and ``EP``), ``tests/test_torch_lm_xlstm_truth.py`` (the
one-process runs, in this process) and ``tools/torch_lm_mixer_tp_check.py``
(``--parity``, ``--truth``).

A case (``setup``): an arch at ``reduced()``, float32 (MoE dropless, as
``torch_lm_truth_common.overrides``), the reference's weights from
``jax.random.PRNGKey(0)`` carried to the port, and three batches of
B = 8, T = 32 from ``np.random.RandomState(0)``: the "grad" batch, then
one a train step. A run (``port_run``, ``reference_run``): the
``value_and_grad`` of the loss on the "grad" batch at the first start's
weights, and two steps of ``make_train_step`` (2 microbatches, a cosine
AdamW), step k from start k, with the gradients each hands AdamW.

``LM`` (argv: the store, the arch, optionally an ``.npz`` path) runs R1
and RS (the reference on one device and sharded) and P1 and PS (the port
in one process and sharded) on 4 gloo ranks, each sharded run on (data
2, model 2) and (data 1, model 4), and prints rank 0's scores; given the
path, rank 0 also writes the starts, the train batches and every run's
records there (``torch_lm_truth_common.save_case``). Two hooks, from the
environment: ``REPRO_SMOKE_DIR``, the directory of the smoke the ranks
import (a float64 copy's, ``as_float64``), and ``REPRO_MIXER_WHOLE``, the
sites ``tools/torch_lm_mixer_tp_check.py::contract_whole`` contracts whole
("+"-joined; "none": none).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from typing import Any, NamedTuple

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding

import torch_lm_truth_common as truth
from repro.configs.base import get_config as jget, reduced as jreduced
from repro.distributed import sharding as jshd
from repro.distributed.act_sharding import use_mesh as juse
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.act_sharding import use_mesh
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (1, 4))                          # (data, model)
B, T = 8, 32


class Case(NamedTuple):
    jcfg: Any
    tcfg: Any
    params: Any          # the port's tree of the initial weights
    batches: list        # the "grad" batch, then one a train step
    topt: Any
    jopt: Any


def setup(arch: str) -> Case:
    base = jreduced(jget(arch))
    over = truth.overrides(base)
    jcfg = base.with_overrides(**over)
    tcfg = reduced(get_config(arch)).with_overrides(**over)
    jshd.set_moe_expert_axes(jcfg.moe_expert_axes)
    shd.set_moe_expert_axes(tcfg.moe_expert_axes)
    jparams = jax.jit(lambda k: jlm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    params = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    rs = np.random.RandomState(0)
    batches = [{k: rs.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    return Case(jcfg, tcfg, params, batches,
                tadamw.adamw(tadamw.cosine_schedule(*truth.SCHEDULE)),
                jadamw.adamw(jadamw.cosine_schedule(*truth.SCHEDULE)))


def clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def jmesh(data, model):
    """The reference's (data, model) mesh of the forced host devices, Auto
    axes."""
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(data, model),
                             ("data", "model"))


def place(jm, tree, specs):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(jm, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def port_run(case: Case, mesh, starts) -> tuple:
    """P1 (``mesh`` None) or PS (every rank): the run (module docstring);
    step k from ``starts[k]`` (None, in one process: the state after step
    k - 1) -> (the run, the one-process states after each step)."""
    tcfg = case.tcfg
    opt, seen = truth.recording(case.topt)
    step = steps.make_train_step(tcfg, opt, truth.MICRO)
    on = (lambda: use_mesh(mesh, tcfg.parallelism)) if mesh \
        else contextlib.nullcontext
    whole = shd.undistribute_tree if mesh else (lambda t: t)
    val = lambda t: float(t.full_tensor() if hasattr(t, "full_tensor")
                          else t)

    def put(p, s, b):
        p, s = clone(p), clone(s)
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if mesh is None:
            return p, s, b
        ps = shd.param_specs(p, mesh, tcfg.parallelism)
        bs = shd.batch_spec(mesh, B, 1, tcfg.parallelism)
        return (shd.distribute_tree(p, ps, mesh),
                shd.distribute_tree(s, shd.opt_state_specs(s, mesh, ps),
                                    mesh)._replace(step=s.step),
                shd.distribute_tree(b, {"tokens": bs, "labels": bs}, mesh))
    p, _, b = put(*starts[0], case.batches[0])
    live = [x.detach().requires_grad_() for x in tree_leaves(p)]

    def value_and_grad(live, b):
        l, _ = lm.loss_fn(tree_unflatten(p, live), tcfg, b)
        return l, torch.autograd.grad(l, live)
    with on():
        loss, g = (steps._on_mesh(value_and_grad) if mesh else
                   value_and_grad)(live, b)
    out = {"grad": {"loss": val(loss), "grads": [
        t.detach().numpy() for t in whole(list(g))]}, "train": []}
    after = []
    for start, b in zip(starts, case.batches[1:]):
        p, s, b = put(*(start or after[-1]), b)
        with on():
            p, s, met = step(p, s, b)
        out["train"].append({
            "loss": val(met["loss"]), "grad_norm": val(met["grad_norm"]),
            "grads": [t.numpy() for t in whole(tree_leaves(seen[-1]))]})
        if mesh is None:
            after.append((p, s))
    return out, after


def _grads_in(opt):
    """The reference's AdamW that also returns the gradients it was
    handed."""
    def update(g, s, p):
        p2, s2, om = opt.update(g, s, p)
        return p2, s2, dict(om, grads=g)
    return opt._replace(update=update)


def _to_j(p, s):
    npy = lambda t: tree_map(lambda x: x.detach().numpy(), t)
    return npy(p), jadamw.AdamWState(step=np.int32(int(s.step)),
                                     mu=npy(s.mu), nu=npy(s.nu))


def reference_run(case: Case, jm, starts) -> dict:
    """R1 (``jm`` None) or RS (``jm`` the reference's mesh): as
    ``port_run``, on the reference; every start given."""
    jcfg = case.jcfg
    with contextlib.ExitStack() as st:
        put = lambda t, spec: t
        jp0 = _to_j(*starts[0])[0]
        if jm is not None:
            st.enter_context(jm)
            st.enter_context(juse(jm, jcfg.parallelism))
            ps = jshd.param_specs(jp0, jm, jcfg.parallelism)
            bsp = jshd.batch_spec(jm, B, 1, jcfg.parallelism)
            put = lambda t, spec: place(jm, t, spec)
        bspec = {"tokens": bsp, "labels": bsp} if jm else None
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            put(jp0, ps if jm else None), put(case.batches[0], bspec))
        out = {"grad": {"loss": float(loss), "grads": [
            np.asarray(x) for x in jax.tree_util.tree_leaves(g)]},
            "train": []}
        step = jax.jit(jsteps.make_train_step(jcfg, _grads_in(case.jopt),
                                              truth.MICRO))
        for (p0, s0), b in zip(starts, case.batches[1:]):
            jp, js = _to_j(p0, s0)
            if jm is not None:
                jp = put(jp, ps)
                js = put(js, jshd.opt_state_specs(js, jm, ps))
            _, _, met = step(jp, js, put(b, bspec))
            out["train"].append({
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "grads": [np.asarray(x) for x in
                          jax.tree_util.tree_leaves(met["grads"])]})
    return out


PRELUDE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [os.environ.get("REPRO_SMOKE_DIR", "tools"), "tests",
                    "tools"]
    import jax, jax.numpy as jnp
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro.distributed.act_sharding import use_mesh as juse
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.launch.mesh import init_ranks, make_host_mesh, \\
        rank0_alone
    from repro_torch.tree import tree_leaves, tree_map
    from torch_lm_ref_mixers_common import jmesh

    init_ranks("gloo", "cpu", init_method=sys.argv[1])
    torch.set_num_threads(1)
    rank = dist.get_rank()
""")

LM = PRELUDE + textwrap.dedent("""
    import time
    from torch_lm_ref_mixers_common import (MESHES, port_run, reference_run,
                                            setup)
    from torch_lm_truth_common import run_share, save_case, start_leaves

    if os.environ.get("REPRO_MIXER_WHOLE", "none") != "none":
        import torch_lm_mixer_tp_check as chk
        chk.contract_whole(set(os.environ["REPRO_MIXER_WHOLE"].split("+")))
    arch = sys.argv[2]
    t0 = time.perf_counter()
    tmeshes = {dm: make_host_mesh(dm[1]) for dm in MESHES}
    case = setup(arch)
    init = (case.params, case.topt.init(case.params))
    # every run takes step k from the same state: the initial one, then
    # the one-process port's after its first step
    P1, after = port_run(case, None, [init, None])
    starts = [init, after[0]]
    mine = None
    with rank0_alone(tmeshes[MESHES[0]], 900):   # the reference, 3 ranks
        jm = {1: MESHES[0], 2: MESHES[1]}.get(rank)
        if rank < 3:
            mine = reference_run(case, jmesh(*jm) if jm else None, starts)
    runs = [None] * 4
    dist.all_gather_object(runs, mine)
    ref_s = time.perf_counter() - t0
    R1, RS = runs[0], dict(zip(MESHES, runs[1:3]))
    PS = {dm: port_run(case, tmeshes[dm], starts)[0] for dm in MESHES}

    if rank == 0:
        report = {"arch": arch, "cases": [], "reference_s": ref_s,
                  "s": time.perf_counter() - t0}
        for dm in MESHES:
            pairs = {"RS vs R1": run_share(RS[dm], R1),
                     "PS vs RS": run_share(PS[dm], RS[dm]),
                     "PS vs P1": run_share(PS[dm], P1),
                     "P1 vs R1": run_share(P1, R1),
                     "PS vs R1": run_share(PS[dm], R1)}
            for what in ("grad", "train"):
                loss = lambda r: r[what]["loss"] if what == "grad" else \\
                    [st["loss"] for st in r[what]]
                case_ = {"mesh": {"data": dm[0], "model": dm[1]},
                         "what": what,
                         **{k: v[what] for k, v in pairs.items()},
                         **({"by step": {k: v["by step"] for k, v in
                                         pairs.items()},
                             "loss": {k: v["train loss"] for k, v in
                                      pairs.items()}}
                            if what == "train" else {}),
                         "loss R1 / PS": [loss(R1), loss(PS[dm])]}
                report["cases"].append(case_)
                print("CASE " + json.dumps(case_), flush=True)
        if len(sys.argv) > 3:
            save_case(sys.argv[3], [start_leaves(*s) for s in starts],
                      case.batches[1:], runs={
                          "P1": P1, "R1": R1,
                          **{f"RS{d}{m}": RS[(d, m)] for d, m in MESHES},
                          **{f"PS{d}{m}": PS[(d, m)] for d, m in MESHES}})
        print("REPORT " + json.dumps(report), flush=True)
    dist.destroy_process_group()
""")

EP = PRELUDE + textwrap.dedent("""
    from repro.nn import moe as jmoe
    from repro.nn.moe_ep import moe_apply_ep as jep
    from repro_torch.nn.moe_ep import moe_apply_ep
    from test_torch_common import np_tree, to_t
    from test_torch_lm_layers import _routing_flips

    mesh = make_host_mesh(2)                       # (data 2, model 2)
    d, E, k, dff, cf = 32, 8, 2, 64, 1.25
    jp = jmoe.moe_init(jax.random.PRNGKey(1), d, dff, E, 1)
    # a skewed load: every token's expert-0 logit raised by 1, so expert
    # 0 overflows its capacity on each data shard and on the whole batch
    r0 = jp["router"][:, 0]
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 16, d)) + \\
        r0 / jnp.sum(r0 * r0)
    report = {}
    for axes in ("model", "data_model"):
        want = None
        with rank0_alone(mesh, 600):
            if rank == 0:
                jm = jmesh(2, 2)
                with jm, juse(jm):
                    out, aux = jax.jit(lambda p, x: jep(
                        p, x, top_k=k, capacity_factor=cf,
                        expert_axes=axes))(jp, x)
                    g = jax.jit(jax.grad(lambda p, x: jep(
                        p, x, top_k=k, capacity_factor=cf,
                        expert_axes=axes)[0].sum()))(jp, x)
                want = (np.asarray(out), float(aux["drop_frac"]),
                        [np.asarray(l) for l in jax.tree_util.tree_leaves(g)])
        shd.set_moe_expert_axes(axes)
        tp = to_t(np_tree(jp))
        dp = shd.distribute_tree(tp, shd.param_specs(tp, mesh, "tp"), mesh)
        dp = tree_map(lambda t: t.detach().requires_grad_(), dp)
        dx = shd.distribute_tree({"x": to_t(np.asarray(x))},
                                 {"x": shd.batch_spec(mesh, 8, 2)}, mesh)["x"]
        with use_mesh(mesh):
            out, aux = moe_apply_ep(dp, dx, top_k=k, capacity_factor=cf,
                                    expert_axes=axes, mesh=mesh)
            out.sum().backward()
        got = out.full_tensor().detach().numpy()
        drop = float(aux["drop_frac"].full_tensor())
        gg = [t.grad.full_tensor().numpy() for t in tree_leaves(dp)]
        if rank == 0:
            flips = _routing_flips(np_tree(jp), np.asarray(x), k)
            fwd = float(np.abs(got - want[0]).max())
            grad = max(float(np.abs(a - b).max())
                       for a, b in zip(gg, want[2]))
            report[axes] = {"fwd": fwd, "grad": grad, "drop_frac":
                            [drop, want[1]], "flips": flips}
            assert flips == 0, report
            assert want[1] > 0 and drop == want[1], report
            assert fwd < 1e-5 and grad < 1e-4, report
    shd.set_moe_expert_axes("model")
    if rank == 0:
        print("REPORT " + json.dumps(report), flush=True)
    dist.destroy_process_group()
""")


def rank_env(rank: int, world: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep +
               env.get("PYTHONPATH", ""))
    return env


def spawn(tmp_path, script, args, timeout_s, env=None) -> dict:
    """``script`` on 4 ranks -> rank 0's REPORT (every rank must exit 0
    within ``timeout_s``); each rank's output to a file under
    ``tmp_path`` (a rank blocked on a full pipe would stall the others
    in a collective); ``env`` over each rank's environment."""
    tmp_path = Path(tmp_path)
    logs = [tmp_path / f"rank{r}.log" for r in range(4)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", script,
                     f"file://{tmp_path / 'store'}", *args], cwd=ROOT,
                    env=dict(rank_env(r, 4), **(env or {})), stdout=f,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    assert [p.returncode for p in procs] == [0] * 4, \
        "\n".join(o[-4000:] for o in outs)
    print("\n".join(l for l in outs[0].splitlines()
                    if l.startswith(("CASE ", "REPORT "))))
    line = [l for l in outs[0].splitlines() if l.startswith("REPORT ")]
    return json.loads(line[-1][len("REPORT "):])
