"""The port's sharded LM against the reference's sharded LM.

Four gloo ranks on the CPU, a (data 2, model 2) mesh. Rank 0 runs the
reference on a forced 4-device JAX mesh with Auto axes (its
``jax.make_mesh`` builds Explicit axes, on which its ``constrain`` breaks
with this JAX; ``tests/test_torch_sharding_ref.py`` builds the mesh the
same way), its inputs placed by its own rules under its ``use_mesh``:

- llama3-405b at ``reduced()`` ("tp": heads, FFN and vocab on "model",
  FSDP on "data"), float32: the jitted ``value_and_grad`` of
  ``lm.loss_fn``; every rank runs the port's ``loss_fn`` on DTensors of
  the converted weights and batch under the port's ``use_mesh``, and rank
  0 holds the loss within ``LM_TOL`` and every gathered gradient within
  ``GRAD_TOL`` (``tests/torch_lm_grad_common.py``'s bounds);
- the same arch through two train steps, 2 microbatches, under a cosine
  AdamW: the reference's jitted ``make_train_step`` on its placed
  parameters, AdamW state (``opt_state_specs``) and batches, against the
  port's ``make_train_step`` on DTensors laid out by the port's rules;
  after each step every metric within ``LM_TOL`` (``grad_norm`` 1e-5
  relative, ``lr`` exact), the gathered parameters within ``OPT_ATOL``
  and the moments within ``MOMENT_TOL``, ``tests/test_torch_train_step.py``'s
  bounds for the one-process step;
- one MoE layer (E = 8, top 2, dropless) through the reference's
  ``moe_apply_ep`` (``shard_map``) and the port's expert-parallel route
  for both ``expert_axes``: the output within 1e-5 and the gradients of
  ``out.sum()`` within 1e-4, ``tests/test_moe_ep.py``'s bounds."""
import json
import textwrap

from test_torch_sharding import spawn

RANK = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp
    import numpy as np
    import torch
    import torch.distributed as dist
    from jax.sharding import NamedSharding
    from test_torch_common import np_tree, to_t
    from repro.configs.base import get_config as jget, reduced as jreduced
    from repro.distributed import sharding as jshd
    from repro.distributed.act_sharding import use_mesh as juse
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    from repro.nn import moe as jmoe
    from repro.nn.moe_ep import moe_apply_ep as jep
    from repro.optim import adamw as jadamw
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_ranks, make_host_mesh, \\
        rank0_alone
    from repro_torch.models import lm
    from repro_torch.nn.moe_ep import moe_apply_ep
    from repro_torch.optim import adamw as tadamw
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    LM_TOL = (1e-4, 1e-4)
    GRAD_TOL = (1e-5, 1e-4, 1e-3)
    init_ranks("gloo", "cpu", init_method=sys.argv[1])
    torch.set_num_threads(1)
    mesh = make_host_mesh(2)                       # (2, 2) (data, model)
    rank = dist.get_rank()
    report = {}

    def place(jm, tree, specs):
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(jm, s)), tree,
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    # --- the LM's loss and gradients --------------------------------
    arch = "llama3-405b"
    jcfg = jreduced(jget(arch)).with_overrides(param_dtype="float32")
    tcfg = reduced(get_config(arch)).with_overrides(param_dtype="float32")
    jparams = jax.jit(lambda k: jlm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    B, T = 8, 32
    toks = rs.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rs.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    ref = None
    with rank0_alone(mesh, 600):
        if rank == 0:
            jm = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                                   ("data", "model"))     # Auto axes
            jshd.set_moe_expert_axes(jcfg.moe_expert_axes)
            ps = jshd.param_specs(jparams, jm, jcfg.parallelism)
            bs = jshd.batch_spec(jm, B, 1, jcfg.parallelism)
            with jm, juse(jm, jcfg.parallelism):
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
                    place(jm, jparams, ps),
                    place(jm, {"tokens": toks, "labels": labels},
                          {"tokens": bs, "labels": bs}))
            ref = (np.asarray(loss), [np.asarray(g) for g in
                                      jax.tree_util.tree_leaves(grads)])
    params = to_t(np_tree(jparams))
    shd.set_moe_expert_axes(tcfg.moe_expert_axes)
    dparams = shd.distribute_tree(
        params, shd.param_specs(params, mesh, tcfg.parallelism), mesh)
    batch = {"tokens": torch.from_numpy(toks), "labels":
             torch.from_numpy(labels)}
    bs = shd.batch_spec(mesh, B, 1, tcfg.parallelism)
    dbatch = shd.distribute_tree(batch, {"tokens": bs, "labels": bs}, mesh)
    live = [x.detach().requires_grad_() for x in tree_leaves(dparams)]

    def value_and_grad(live, dbatch):
        l, _ = lm.loss_fn(tree_unflatten(dparams, live), tcfg, dbatch)
        return l, torch.autograd.grad(l, live)
    with use_mesh(mesh, tcfg.parallelism):
        loss, grads = steps._on_mesh(value_and_grad)(live, dbatch)
    loss = float(loss.full_tensor())
    grads = shd.undistribute_tree(list(grads))      # the inverse, on all
    if rank == 0:
        np.testing.assert_allclose(loss, ref[0], atol=LM_TOL[0],
                                   rtol=LM_TOL[1])
        worst = 0.0
        for got, want in zip(grads, ref[1]):
            bound = GRAD_TOL[0] + GRAD_TOL[1] * np.abs(want).max() + \\
                GRAD_TOL[2] * np.abs(want)
            worst = max(worst, float((np.abs(got.numpy() - want)
                                      / bound).max()))
        assert worst <= 1.0, worst
        report["lm"] = {"loss": [loss, float(ref[0])], "grad_share": worst,
                        "leaves": len(grads)}

    # --- two train steps: 2 microbatches, AdamW -----------------------
    SCHEDULE = (1e-3, 1, 4)                        # peak, warmup, total
    OPT_ATOL = 1e-4
    MOMENT_TOL = {"mu": (1e-6, 1e-3), "nu": (1e-7, 1e-3)}
    batches = [{"tokens": rs.randint(0, jcfg.vocab_size, (B, T)).astype(
        np.int32), "labels": rs.randint(0, jcfg.vocab_size, (B, T)).astype(
        np.int32)} for _ in range(2)]
    jsteps_out = None
    with rank0_alone(mesh, 900):
        if rank == 0:
            jopt = jadamw.adamw(jadamw.cosine_schedule(*SCHEDULE))
            with jm, juse(jm, jcfg.parallelism):
                jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, 2))
                jp = place(jm, jparams, ps)
                js = jopt.init(jp)
                js = place(jm, js, jshd.opt_state_specs(js, jm, ps))
                jbs = jshd.batch_spec(jm, B, 1, jcfg.parallelism)
                jsteps_out = []
                for b in batches:
                    jp, js, jmet = jstep(jp, js, place(
                        jm, b, {"tokens": jbs, "labels": jbs}))
                    jsteps_out.append(jax.tree_util.tree_map(
                        np.asarray, (jp, js.mu, js.nu, jmet)))
    topt = tadamw.adamw(tadamw.cosine_schedule(*SCHEDULE))
    tstep = steps.make_train_step(tcfg, topt, 2)
    pspecs = shd.param_specs(params, mesh, tcfg.parallelism)
    state = topt.init(params)
    tp = shd.distribute_tree(params, pspecs, mesh)
    ts = shd.distribute_tree(state, shd.opt_state_specs(state, mesh, pspecs),
                             mesh)._replace(step=state.step)
    for k, b in enumerate(batches):
        db = shd.distribute_tree(
            {n: torch.from_numpy(v) for n, v in b.items()},
            {"tokens": bs, "labels": bs}, mesh)
        with use_mesh(mesh, tcfg.parallelism):
            tp, ts, tmet = tstep(tp, ts, db)
        got = [shd.undistribute_tree(t) for t in (tp, ts.mu, ts.nu)]
        tmet = {n: float(v.full_tensor() if hasattr(v, "full_tensor")
                         else v) for n, v in tmet.items()}
        if rank == 0:
            want = jsteps_out[k]
            for n, w in want[3].items():
                if n == "lr":
                    assert tmet[n] == float(w), (k, n)
                elif n == "grad_norm":
                    np.testing.assert_allclose(tmet[n], w, rtol=1e-5)
                else:
                    np.testing.assert_allclose(tmet[n], w, atol=LM_TOL[0],
                                               rtol=LM_TOL[1], err_msg=n)
            for name, g, w, (atol, rtol) in zip(
                    ("params", "mu", "nu"), got, want[:3],
                    ((OPT_ATOL, 0.0), MOMENT_TOL["mu"], MOMENT_TOL["nu"])):
                gl, wl = tree_leaves(g), jax.tree_util.tree_leaves(w)
                assert len(gl) == len(wl), name
                for a, e in zip(gl, wl):
                    np.testing.assert_allclose(a.numpy(), e, atol=atol,
                                               rtol=rtol, err_msg=name)
            report.setdefault("train", []).append(
                {"loss": [tmet["loss"], float(want[3]["loss"])],
                 "grad_norm": [tmet["grad_norm"],
                               float(want[3]["grad_norm"])]})

    # --- the expert-parallel route ----------------------------------
    d, E, k, dff = 32, 8, 2, 64
    cf = E / k
    jp = jmoe.moe_init(jax.random.PRNGKey(1), d, dff, E, 1)
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 16, d))
    for axes in ("model", "data_model"):
        want = None
        with rank0_alone(mesh, 600):
            if rank == 0:
                jm = jax.sharding.Mesh(
                    np.array(jax.devices()).reshape(2, 2), ("data", "model"))
                with jm, juse(jm):
                    out = jax.jit(lambda p, x: jep(
                        p, x, top_k=k, capacity_factor=cf,
                        expert_axes=axes)[0])(jp, x)
                    g = jax.jit(jax.grad(lambda p, x: jep(
                        p, x, top_k=k, capacity_factor=cf,
                        expert_axes=axes)[0].sum()))(jp, x)
                want = (np.asarray(out),
                        [np.asarray(l) for l in jax.tree_util.tree_leaves(g)])
        shd.set_moe_expert_axes(axes)
        tp = to_t(np_tree(jp))
        dp = shd.distribute_tree(tp, shd.param_specs(tp, mesh, "tp"), mesh)
        dp = tree_map(lambda t: t.detach().requires_grad_(), dp)
        dx = shd.distribute_tree({"x": to_t(np.asarray(x))},
                                 {"x": shd.batch_spec(mesh, 8, 2)}, mesh)["x"]
        with use_mesh(mesh):
            out, _ = moe_apply_ep(dp, dx, top_k=k, capacity_factor=cf,
                                  expert_axes=axes, mesh=mesh)
            out.sum().backward()
        got = out.full_tensor().detach().numpy()
        gg = [t.grad.full_tensor().numpy() for t in tree_leaves(dp)]
        if rank == 0:
            fwd = float(np.abs(got - want[0]).max())
            grad = max(float(np.abs(a - b).max())
                       for a, b in zip(gg, want[1]))
            assert fwd < 1e-5 and grad < 1e-4, (axes, fwd, grad)
            report[axes] = {"fwd": fwd, "grad": grad}
    shd.set_moe_expert_axes("model")
    if rank == 0:
        print("REPORT " + json.dumps(report))
    dist.destroy_process_group()
""")


def test_the_sharded_lm_and_ep_route_match_the_references_sharded_ones(
        tmp_path):
    res = spawn(4, ["-c", RANK, f"file://{tmp_path / 'store'}"])
    assert [rc for rc, _ in res] == [0] * 4, \
        "\n".join(o[-3000:] for _, o in res)
    line = [l for l in res[0][1].splitlines() if l.startswith("REPORT ")]
    report = json.loads(line[-1][len("REPORT "):])
    assert report["lm"]["leaves"] > 10
    assert set(report) == {"lm", "train", "model", "data_model"}
    assert len(report["train"]) == 2
