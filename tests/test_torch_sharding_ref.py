"""The port's sharded PPO rollout against the reference's sharded one.

Two gloo ranks on the CPU (data = 2) each build, from the same keys, the
reference's IALS (``repro.core.engine.make_unified_ials``), policy,
rollout state and streams. Rank 0 runs the reference's ``ppo.rollout``
on a forced 2-device JAX mesh with Auto axes, ``mesh=`` passed to the
engine and to ``init_rollout_state`` (its final state comes back in lane
blocks). Both ranks then run the port's sharded ``ppo.rollout`` on the
converted weights and their blocks of the same streams, and rank 0 holds
the gathered batch, ``v_last`` and final rollout state against the
reference's sharded ones: integer leaves exactly, floats within
``FWD_ATOL``. The reference contract's shapes: A = 4, B = 8, T = 8,
hidden 16, both domains and both backbones, a spawn each. (The reference's own
``make_host_mesh`` builds Explicit axes, on which its sharding breaks
with this JAX; an Auto mesh does not.)"""
import json
import textwrap

import pytest

from test_torch_sharding import spawn

RANK = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "tests")
    import jax
    import numpy as np
    import torch
    import torch.distributed as dist
    from test_torch_common import FWD_ATOL, np_tree, to_t
    from repro.core import engine as jeng, influence as jinf
    from repro.envs.api import horizon_noise as jhorizon
    from repro.envs.traffic import (TrafficConfig as JTC,
                                    make_batched_local_traffic_env as jtls)
    from repro.envs.warehouse import (
        WarehouseConfig as JWC, make_batched_local_warehouse_env as jwls)
    from repro.rl import ppo as jppo
    from repro_torch.core import engine as teng, influence as tinf
    from repro_torch.distributed import sharding as shd
    from repro_torch.envs.traffic import (TrafficConfig,
                                          make_batched_local_traffic_env)
    from repro_torch.envs.warehouse import (
        WarehouseConfig, make_batched_local_warehouse_env)
    from repro_torch.launch.mesh import (init_ranks, make_host_mesh,
                                         rank0_alone)
    from repro_torch.rl import ppo as tppo
    from repro_torch.tree import tree_leaves, tree_map

    init_ranks("gloo", "cpu", init_method=sys.argv[1])
    mesh = make_host_mesh()                      # (2, 1) (data, model)
    rank = dist.get_rank()
    assert len(jax.devices()) == 2
    jmesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 1),
                              ("data", "model"))   # Auto axes
    A, B, T = 4, 8, 8
    report = {}
    for domain, kind in [sys.argv[2].split("-")]:
        if domain == "traffic":
            jls, fs = jtls(JTC()), 1
            tls = make_batched_local_traffic_env(TrafficConfig(), "cpu")
        else:
            jls, fs = jwls(JWC()), 8
            tls = make_batched_local_warehouse_env(WarehouseConfig(), "cpu")
        kw = dict(kind=kind, d_in=jls.spec.dset_dim,
                  n_out=jls.spec.n_influence, hidden=16,
                  stack=8 if kind == "fnn" else 1)
        ka, kp, ks, kr = jax.random.split(jax.random.PRNGKey(3), 4)
        jaip = jax.jit(jax.vmap(lambda k: jinf.init_aip(
            jinf.AIPConfig(**kw), k)))(jax.random.split(ka, A))
        cfg = dict(obs_dim=jls.spec.obs_dim, n_actions=jls.spec.n_actions,
                   frame_stack=fs, n_envs=B, rollout_len=T, episode_len=5,
                   n_agents=A, hidden=16)
        jc, tc = jppo.PPOConfig(**cfg), tppo.PPOConfig(**cfg)
        jenv1 = jeng.make_unified_ials(jls, jaip, jinf.AIPConfig(**kw),
                                       n_agents=A)

        @jax.jit
        def inputs(kp, ks, kr):
            # the streams the reference's hoisted rollout derives from kr
            k_a, k_s, k_r = jppo._split_tick_keys(kr, T)
            return (jppo.init_policy(jc, kp),
                    jppo.init_rollout_state(jenv1, jc, ks),
                    jppo.bulk_gumbel(k_a, (B, A, jc.n_actions)),
                    jhorizon(jenv1.noise_fn, k_s, B),
                    jax.vmap(lambda k: jenv1.reset(k, B))(k_r))
        pol, rs1, gum, noise, resets = inputs(kp, ks, kr)
        want = None
        with rank0_alone(mesh, 600):
            if rank == 0:   # the reference, sharded
                jenv2 = jeng.make_unified_ials(
                    jls, jaip, jinf.AIPConfig(**kw), n_agents=A, mesh=jmesh)
                rs2 = jppo.init_rollout_state(jenv2, jc, ks, mesh=jmesh)
                out = jax.jit(lambda p, r, k: jppo.rollout(
                    jenv2, jc, p, r, k))(pol, rs2, kr)
                placed = {str(l.sharding.spec) for l in
                          jax.tree_util.tree_leaves(out[0])}
                want = np_tree(out)
        # the port: this rank's blocks of the same state and streams
        tenv = teng.make_unified_ials(tls, to_t(jaip),
                                      tinf.AIPConfig(**kw), n_agents=A,
                                      mesh=mesh)
        trs = tppo.shard_rollout(to_t(rs1), mesh, A)
        tnoise = to_t(noise)
        env_block = None if tnoise["env"] is None else tree_map(
            lambda l: shd.shard_ials_stream(
                l.reshape((T, B, A) + l.shape[2:]), mesh, B, A).reshape(
                    (T, -1) + l.shape[2:]), tnoise["env"])
        streams = (shd.shard_ials_stream(to_t(gum), mesh, B, A),
                   {"bits": shd.shard_ials_stream(tnoise["bits"], mesh, B,
                                                  A), "env": env_block},
                   shd.shard_ials_stream(to_t(resets), mesh, B, A))
        rs_out, batch, v_last = tppo.rollout(tenv, tc, to_t(pol), trs,
                                             streams=streams, mesh=mesh)
        rs_out = tppo.gather_rollout(rs_out, mesh, A, B)
        if rank != 0:
            continue
        got = [rs_out, batch, v_last]
        ref = [want[0], want[1], want[2]]
        worst, bad = 0.0, []
        for i, (g, w) in enumerate(zip(tree_leaves(got),
                                       jax.tree_util.tree_leaves(ref))):
            g = g.numpy()
            w = np.asarray(w)
            if g.shape != w.shape:
                bad.append((i, "shape", g.shape, w.shape))
            elif np.issubdtype(w.dtype, np.floating):
                err = float(np.abs(g.astype(np.float64) - w).max())
                worst = max(worst, err)
                if err > FWD_ATOL:
                    bad.append((i, "err", err))
            elif not np.array_equal(g.astype(w.dtype), w):
                bad.append((i, "differ", int((g != w).sum())))
        report[f"{domain}-{kind}"] = {
            "leaves": len(tree_leaves(got)), "bad": bad,
            "max_abs_err": worst, "ref_placements": sorted(placed)}
    if rank == 0:
        print("REPORT " + json.dumps(report))
    dist.destroy_process_group()
""")


CASES = ["traffic-fnn", "traffic-gru", "warehouse-gru", "warehouse-fnn"]


@pytest.mark.parametrize("case", CASES)
def test_port_sharded_rollout_matches_the_reference_sharded_rollout(
        tmp_path, case):
    res = spawn(2, ["-c", RANK, f"file://{tmp_path / 'store'}", case])
    assert [rc for rc, _ in res] == [0, 0], res[0][1][-4000:] + \
        res[1][1][-2000:]
    line = [ln for ln in res[0][1].splitlines() if ln.startswith("REPORT ")]
    r = json.loads(line[-1][len("REPORT "):])[case]
    # the reference's final state really lies in lane blocks on its mesh
    assert any("data" in p for p in r["ref_placements"]), r
    assert r["leaves"] > 8 and r["bad"] == [], r
