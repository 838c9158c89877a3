"""The port's recurrent mixers on "model" against the reference's sharded
mixers, and the expert-parallel route where it drops tokens.

Four gloo ranks on the CPU; ranks also run the reference, each on a
forced 4-device JAX mesh with Auto axes (``tests/test_torch_lm_sharding_
ref.py`` builds it the same way), its inputs placed by its own
``param_specs`` / ``batch_spec`` under its ``use_mesh``, the weights
carried across by ``convert`` (``test_torch_common.to_t``); the
reference's runs of a case go side by side on ranks 0-2 and to every
rank after:

- xlstm-1.3b (mLSTM and sLSTM) and jamba-1.5-large-398b (Mamba, an
  attention layer, MoE layers dropless as in ``tools/torch_lm_shard_
  smoke.py``, without the load-balance term: the expert-parallel route
  averages it over the data shards) at ``reduced()``, float32, B = 8,
  T = 32, on (data 2, model 2) and (data 1, model 4): the jitted
  ``value_and_grad`` of ``lm.loss_fn`` on one batch ("grad"), and two
  steps of ``make_train_step`` (2 microbatches, a cosine AdamW) on two
  more ("train"), each step from the same state in every run (the
  initial one, then the one-process port's after its first step), with
  the gradients it hands AdamW. Four runs of each: the reference on one
  device (R1) and sharded (RS), the port in one process (P1) and sharded
  (PS). Each pair is scored as a share of the smoke's bounds (the loss
  and grad norm within ``LOSS_TOL``, every gradient within ``GRAD_TOL``
  of the second run's; the worst of these, a train step's each): RS vs
  R1, PS vs RS, PS vs P1, P1 vs R1 and PS vs R1, one report line a case.
  Every case, and each train step: the port sharded drifts from the
  reference on one device no further than the reference's own sharding
  does, by half again, or the bound (PS vs R1 <= max(1, 1.5 x RS vs
  R1)), and on (data 2, model 2), where "model" divides the heads and
  both packages contract each head on one rank, PS vs P1 <= 1; every
  pair's train losses within ``LOSS_TOL``. xlstm's train steps miss
  that (``xfail(strict=True)`` with their readings; ``ROADMAP.md``
  Queue 3): on both train batches the one-process port and reference
  already differ by 5.4x and 6.8x the bound in float32, and by 3.6e-08
  and 1.1e-09 of it with both packages in float64, where every share
  of these cases is at most 6.0e-08 (``tools/torch_lm_mixer_tp_check.py
  --parity xlstm-1.3b --float64``): the gradients amplify the two
  packages' different orders of sums, which no route on "model"
  removes.
- one MoE layer (E = 8, top 2, capacity 1.25; a skewed load, every
  token's expert-0 logit raised by 1, so tokens drop on each data shard
  and on the whole batch) on (data 2, model 2) for both
  ``expert_axes``: the reference's ``moe_apply_ep`` (``shard_map``)
  against the port's; both drop the same share of the assignments
  (``drop_frac`` equal and above 0), no token routes to another expert
  set (``tests/test_torch_lm_layers.py``'s count of routing flips), the
  output within 1e-5 and the gradients of ``out.sum()`` within 1e-4
  (``tests/test_moe_ep.py``'s bounds)."""
import json
import subprocess
import sys
import textwrap
import time

import pytest

from test_torch_sharding import ROOT, _env

MESHES = ((2, 2), (1, 4))                          # (data, model)

PRELUDE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "tests")
    sys.path.insert(0, "tools")
    import jax, jax.numpy as jnp
    import numpy as np
    import torch
    import torch.distributed as dist
    from jax.sharding import NamedSharding
    from test_torch_common import np_tree, to_t
    import torch_lm_shard_smoke as smoke
    from repro.distributed import sharding as jshd
    from repro.distributed.act_sharding import use_mesh as juse
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.launch.mesh import init_ranks, make_host_mesh, \\
        rank0_alone
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    init_ranks("gloo", "cpu", init_method=sys.argv[1])
    torch.set_num_threads(1)
    rank = dist.get_rank()

    def jmesh(data, model):
        return jax.sharding.Mesh(np.array(jax.devices()).reshape(
            data, model), ("data", "model"))                # Auto axes

    def place(jm, tree, specs):
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(jm, s)), tree,
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
""")

LM = PRELUDE + textwrap.dedent("""
    import contextlib, time
    from repro.configs.base import get_config as jget, reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw as tadamw

    arch = sys.argv[2]
    MESHES = ((2, 2), (1, 4))
    B, T, MICRO = 8, 32, 2
    SCHEDULE = (1e-3, 1, 4)                        # peak, warmup, total
    t0 = time.perf_counter()
    tmeshes = {dm: make_host_mesh(dm[1]) for dm in MESHES}
    over = {"param_dtype": "float32"}
    base = jreduced(jget(arch))
    if base.n_routed_experts:          # dropless, no load-balance term
        over.update(capacity_factor=base.n_routed_experts / base.moe_top_k,
                    lb_loss_weight=0.0)
    jcfg = base.with_overrides(**over)
    tcfg = reduced(get_config(arch)).with_overrides(**over)
    jshd.set_moe_expert_axes(jcfg.moe_expert_axes)
    shd.set_moe_expert_axes(tcfg.moe_expert_axes)
    jparams = jax.jit(lambda k: jlm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    params = to_t(np_tree(jparams))
    rs = np.random.RandomState(0)
    batches = [{k: rs.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    topt = tadamw.adamw(tadamw.cosine_schedule(*SCHEDULE))
    jopt = jadamw.adamw(jadamw.cosine_schedule(*SCHEDULE))

    def clone(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    def port(mesh, starts):
        # P1 (mesh None) or PS (every rank): the gradient of batch 0 from
        # the initial weights; step k on batch k + 1 from starts[k] (None,
        # in one process: the state after step k - 1); the one-process
        # states after each step
        seen = []

        def update_(g, s, p):
            seen.append(clone(g))
            return topt.update_(g, s, p)
        step = steps.make_train_step(tcfg, topt._replace(update_=update_),
                                     MICRO)
        on = (lambda: use_mesh(mesh, tcfg.parallelism)) if mesh \\
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
                    shd.distribute_tree(b, {"tokens": bs, "labels": bs},
                                        mesh))
        p, _, b = put(params, topt.init(params), batches[0])
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
        for start, b in zip(starts, batches[1:]):
            p, s, b = put(*(start or after[-1]), b)
            with on():
                p, s, met = step(p, s, b)
            out["train"].append({
                "loss": val(met["loss"]), "grad_norm": val(met["grad_norm"]),
                "grads": [t.numpy() for t in whole(tree_leaves(seen[-1]))]})
            if mesh is None:
                after.append((p, s))
        return out, after

    def jgrads_in(opt):
        # AdamW that also returns the gradients it was handed
        def update(g, s, p):
            p2, s2, om = opt.update(g, s, p)
            return p2, s2, dict(om, grads=g)
        return opt._replace(update=update)

    def to_j(p, s):
        npy = lambda t: tree_map(lambda x: x.detach().numpy(), t)
        return npy(p), jadamw.AdamWState(step=np.int32(int(s.step)),
                                         mu=npy(s.mu), nu=npy(s.nu))

    def reference(jm, starts):
        # R1 (jm None) or RS: as ``port``, on the reference
        with contextlib.ExitStack() as st:
            put = lambda t, spec: t
            if jm is not None:
                st.enter_context(jm)
                st.enter_context(juse(jm, jcfg.parallelism))
                ps = jshd.param_specs(jparams, jm, jcfg.parallelism)
                bsp = jshd.batch_spec(jm, B, 1, jcfg.parallelism)
                put = lambda t, spec: place(jm, t, spec)
            bspec = {"tokens": bsp, "labels": bsp} if jm else None
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
                put(jparams, ps if jm else None), put(batches[0], bspec))
            out = {"grad": {"loss": float(loss), "grads": [
                np.asarray(x) for x in jax.tree_util.tree_leaves(g)]},
                "train": []}
            step = jax.jit(jsteps.make_train_step(jcfg, jgrads_in(jopt),
                                                  MICRO))
            for (p0, s0), b in zip(starts, batches[1:]):
                jp, js = to_j(p0, s0)
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

    # every run takes step k from the same state: the initial one, then
    # the one-process port's after its first step
    P1, after = port(None, [(params, topt.init(params)), None])
    starts = [(params, topt.init(params)), after[0]]
    mine = None
    with rank0_alone(tmeshes[MESHES[0]], 900):   # the reference, 3 ranks
        jm = {1: MESHES[0], 2: MESHES[1]}.get(rank)
        if rank < 3:
            mine = reference(jmesh(*jm) if jm else None, starts)
    runs = [None] * 4
    dist.all_gather_object(runs, mine)
    ref_s = time.perf_counter() - t0
    R1, RS = runs[0], dict(zip(MESHES, runs[1:3]))
    PS = {dm: port(tmeshes[dm], starts)[0] for dm in MESHES}

    def share(a, b):
        # a against b (b the reference): the worst share of the smoke's
        # bounds over the loss, grad norm and every gradient; of the train
        # steps each step's, and the losses' alone
        def one(x, y):
            tg = [torch.from_numpy(np.asarray(t)) for t in y["grads"]]
            norm = float(sum(t.double().square().sum() for t in tg)) ** 0.5
            w = max(smoke.near_share(torch.tensor(x[k]), torch.tensor(y[k]))
                    for k in ("loss", "grad_norm") if k in y)
            assert len(x["grads"]) == len(tg)
            return max([w] + [smoke.grad_share(torch.from_numpy(
                np.asarray(u)), v, norm) for u, v in zip(x["grads"], tg)])
        by_step = [one(x, y) for x, y in zip(a["train"], b["train"])]
        return {"grad": one(a["grad"], b["grad"]), "train": max(by_step),
                "by step": by_step, "train loss": max(
                    smoke.near_share(torch.tensor(x["loss"]),
                                     torch.tensor(y["loss"]))
                    for x, y in zip(a["train"], b["train"]))}
    if rank == 0:
        report = {"arch": arch, "cases": [], "reference_s": ref_s,
                  "s": time.perf_counter() - t0}
        for dm in MESHES:
            pairs = {"RS vs R1": share(RS[dm], R1),
                     "PS vs RS": share(PS[dm], RS[dm]),
                     "PS vs P1": share(PS[dm], P1),
                     "P1 vs R1": share(P1, R1),
                     "PS vs R1": share(PS[dm], R1)}
            for what in ("grad", "train"):
                loss = lambda r: r[what]["loss"] if what == "grad" else \\
                    [st["loss"] for st in r[what]]
                case = {"mesh": {"data": dm[0], "model": dm[1]},
                        "what": what,
                        **{k: v[what] for k, v in pairs.items()},
                        **({"by step": {k: v["by step"] for k, v in
                                        pairs.items()},
                            "loss": {k: v["train loss"] for k, v in
                                     pairs.items()}}
                           if what == "train" else {}),
                        "loss R1 / PS": [loss(R1), loss(PS[dm])]}
                report["cases"].append(case)
                print("CASE " + json.dumps(case), flush=True)
        print("REPORT " + json.dumps(report), flush=True)
    dist.destroy_process_group()
""")

EP = PRELUDE + textwrap.dedent("""
    from repro.nn import moe as jmoe
    from repro.nn.moe_ep import moe_apply_ep as jep
    from repro_torch.nn.moe_ep import moe_apply_ep
    from test_torch_lm_layers import _routing_flips

    mesh = make_host_mesh(2)                       # (data 2, model 2)
    d, E, k, dff, cf = 32, 8, 2, 64, 1.25
    jp = jmoe.moe_init(jax.random.PRNGKey(1), d, dff, E, 1)
    # a skewed load: every token's expert-0 logit raised by 1, so expert
    # 0 overflows its capacity on each data shard and on the whole batch
    r0 = jp["router"][:, 0]
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 16, d)) + \
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


def _spawn(tmp_path, script, args, timeout_s, env=None):
    """``script`` on 4 ranks -> rank 0's REPORT (every rank must exit 0
    within ``timeout_s``); each rank's output to a file under
    ``tmp_path`` (a rank blocked on a full pipe would stall the others
    in a collective); ``env`` over each rank's environment."""
    logs = [tmp_path / f"rank{r}.log" for r in range(4)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", script,
                     f"file://{tmp_path / 'store'}", *args], cwd=ROOT,
                    env=dict(_env(r, 4), **(env or {})), stdout=f,
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


@pytest.fixture(scope="module")
def lm_report(tmp_path_factory):
    """arch -> the LM script's report, spawned once an arch."""
    reports = {}

    def get(arch):
        if arch not in reports:
            reports[arch] = _spawn(tmp_path_factory.mktemp("lm"), LM,
                                   [arch], 600)
        return reports[arch]
    return get


def _case(report, dm, what):
    mesh = {"data": dm[0], "model": dm[1]}
    return next(c for c in report["cases"]
                if c["mesh"] == mesh and c["what"] == what)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_the_sharded_mixers_drift_no_further_than_the_references(
        lm_report, arch):
    """The gradient of one batch on both meshes: the port sharded drifts
    from the reference on one device no further than the reference's
    own sharding, by half again, or the bound (PS vs R1 <= max(1, 1.5 x
    RS vs R1)); on (data 2, model 2), where "model" divides the heads
    and both packages contract each head on one rank, PS vs P1 <= 1. The
    train steps' losses, every pair, within ``LOSS_TOL`` (their
    gradients: the next test)."""
    report = lm_report(arch)
    assert report["arch"] == arch
    assert [(c["mesh"]["model"], c["what"]) for c in report["cases"]] == \
        [(2, "grad"), (2, "train"), (4, "grad"), (4, "train")]
    for dm in MESHES:
        c = _case(report, dm, "grad")
        assert c["PS vs R1"] <= max(1.0, 1.5 * c["RS vs R1"]), c
        assert dm != (2, 2) or c["PS vs P1"] <= 1.0, c
        assert max(_case(report, dm, "train")["loss"].values()) <= 1.0


# xlstm's train steps miss the bound (module docstring), the readings:
XLSTM_TRAIN_MISSES = {
    (2, 2): "PS vs R1 5.985 / 3.303 at steps 0 / 1 against max(1, 1.5 x "
            "RS vs R1 0.474 / 1.689); P1 vs R1 5.404 / 6.768; PS vs P1 "
            "0.584 / 4.045",
    (1, 4): "step 1: PS vs R1 5.319 against max(1, 1.5 x RS vs R1 2.848); "
            "P1 vs R1 6.768; PS vs P1 1.460 (step 0: PS vs R1 0.922)"}


@pytest.mark.parametrize("arch,dm", [
    pytest.param(arch, dm, id=f"{arch}-data{dm[0]}-model{dm[1]}",
                 marks=[pytest.mark.xfail(strict=True, reason=why)]
                 if why else [])
    for arch in ("xlstm-1.3b", "jamba-1.5-large-398b") for dm in MESHES
    for why in [arch == "xlstm-1.3b" and XLSTM_TRAIN_MISSES[dm]]])
def test_the_sharded_train_steps_drift_no_further_than_the_references(
        lm_report, arch, dm):
    """Each train step's gradients and grad norm: PS vs R1 <= max(1, 1.5
    x RS vs R1), and on (data 2, model 2) PS vs P1 <= 1."""
    st = _case(lm_report(arch), dm, "train")["by step"]
    for k, ps in enumerate(st["PS vs R1"]):
        assert ps <= max(1.0, 1.5 * st["RS vs R1"][k]), st
        assert dm != (2, 2) or st["PS vs P1"][k] <= 1.0, st


def test_the_ep_route_drops_the_references_tokens(tmp_path):
    report = _spawn(tmp_path, EP, [], 240)
    assert set(report) == {"model", "data_model"}
