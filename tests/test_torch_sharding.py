"""Lane data parallelism on gloo ranks on the CPU: the sharded
``ppo.rollout``, ``engine.rollout`` and PPO train iteration equal the
one-process program bitwise (``tools/torch_shard_smoke.py`` at the
reference contract's shapes, A = 4, B = 8, T = 8, hidden 16, both domains
and both backbones, 2 ranks (data = 2) and 4 ranks (data = 2, model = 2)),
``shard_ials_state`` / ``gather_ials_state`` round-trip, ``rl_train``
under 2 ranks repeats the one-process run and resumes across world sizes,
and the refusals raise.

Every rank is a subprocess joined with a timeout; its process group waits
at most 60 s for a collective (``launch/mesh.py::DIST_TIMEOUT_S``,
``rl_train --dist-timeout-s 60``) and meets the others through a
``file://`` store under ``tmp_path`` (no port)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import rl_train

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANK_TIMEOUT_S = 120
SMOKE_CASES = ["traffic:fnn:4", "traffic:gru:4", "warehouse:gru:4",
               "warehouse:fnn:4", "traffic:fnn:1", "traffic:gru:2"]


def _env(rank, world):
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def spawn(world, argv):
    """Run ``argv`` (after the interpreter) as ``world`` ranks -> [(exit
    code, output)] in rank order; every rank killed if one overruns."""
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=ROOT, env=_env(r, world),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=RANK_TIMEOUT_S)[0],
                         p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(rc, out) for out, rc in outs]


def one_process(argv):
    env = _env(0, 1)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k)
    p = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=RANK_TIMEOUT_S)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p


# ---------------------------------------------------------------------------
# the sharded programs against the one-process program, bitwise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """``tools/torch_shard_smoke.py`` on 2 and 4 gloo ranks -> {world:
    summary}."""
    tmp = tmp_path_factory.mktemp("shard")
    runs = {}
    for world, model in ((2, 1), (4, 2)):
        out = tmp / f"summary{world}.json"
        res = spawn(world, [
            "tools/torch_shard_smoke.py", "--device", "cpu", "--backend",
            "gloo", "--model", str(model), "--B", "8", "--T", "8",
            "--hidden", "16", "--cases", ",".join(SMOKE_CASES),
            "--init-method", f"file://{tmp / f'store{world}'}",
            "--json", str(out)])
        runs[world] = (res, json.loads(out.read_text())
                       if out.exists() else None)
    return runs


SHARD_IDS = [(w, c) for w in (2, 4) for c in SMOKE_CASES]


def _case(shard_runs, world, case):
    res, summary = shard_runs[world]
    assert summary is not None, res[0][1][-4000:]
    assert summary["world"] == world
    assert summary["mesh"] == {"data": 2, "model": world // 2}
    return summary["cases"][case]


@pytest.mark.parametrize("world,case", SHARD_IDS,
                         ids=[f"{w}ranks-{c}" for w, c in SHARD_IDS])
def test_sharded_ppo_rollout_is_bitwise_the_one_process_one(
        shard_runs, world, case):
    """The rollout state (gathered), the batch and v_last."""
    part = _case(shard_runs, world, case)["parts"]["rollout"]
    assert part["leaves"] > 8 and part["differing"] == 0, part


@pytest.mark.parametrize("world,case", SHARD_IDS,
                         ids=[f"{w}ranks-{c}" for w, c in SHARD_IDS])
def test_sharded_engine_rollout_is_bitwise_the_one_process_one(
        shard_runs, world, case):
    """The engine's final state (gathered) and rewards."""
    part = _case(shard_runs, world, case)["parts"]["engine"]
    assert part["leaves"] >= 3 and part["differing"] == 0, part


@pytest.mark.parametrize("world,case", SHARD_IDS,
                         ids=[f"{w}ranks-{c}" for w, c in SHARD_IDS])
def test_sharded_train_iteration_is_bitwise_the_one_process_one(
        shard_runs, world, case):
    """Parameters, optimizer state, metrics and rollout state."""
    part = _case(shard_runs, world, case)["parts"]["train"]
    assert part["leaves"] > 20 and part["differing"] == 0, part


def test_shard_smoke_exits_zero_on_every_rank(shard_runs):
    for world, (res, summary) in shard_runs.items():
        assert [rc for rc, _ in res] == [0] * world, res[0][1][-3000:]
        assert summary["ok"]


ROUND_TRIP = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch import stream
    from repro_torch.core import engine, influence
    from repro_torch.distributed import sharding as shd
    from repro_torch.envs.traffic import (
        TrafficConfig, make_batched_local_traffic_env)
    from repro_torch.envs.warehouse import (
        WarehouseConfig, make_batched_local_warehouse_env)
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.tree import tree_leaves
    init_ranks("gloo", "cpu", init_method=sys.argv[1])
    mesh = make_host_mesh(model=2)
    dev = torch.device("cpu")
    res = {}
    for domain, ls in (
            ("traffic", make_batched_local_traffic_env(TrafficConfig(), dev)),
            ("warehouse", make_batched_local_warehouse_env(
                WarehouseConfig(), dev))):
        for A in (1, 4, 6):
            acfg = influence.AIPConfig(kind="gru", d_in=ls.spec.dset_dim,
                                       n_out=ls.spec.n_influence, hidden=8)
            g = stream(dev, 0, A)
            aip = (influence.init_aip_stacked(acfg, g, A, dev) if A > 1
                   else influence.init_aip(acfg, g, dev))
            env = engine.make_unified_ials(ls, aip, acfg, n_agents=A)
            state = env.reset(g, 8)
            gum = torch.rand((3, 8) + ((A,) if A > 1 else ()) + (5,),
                             generator=g)
            local = shd.shard_ials_state(state, mesh, A)
            shd.constrain_ials_state(local, mesh, A, 8)
            back = shd.gather_ials_state(local, mesh, A, 8)
            sback = shd.gather_ials_stream(
                shd.shard_ials_stream(gum, mesh, 8, A), mesh, 8, A)
            ok = all(torch.equal(a, b) and a.dtype == b.dtype
                     for a, b in zip(tree_leaves(back), tree_leaves(state)))
            res[f"{domain}-{A}"] = {
                "state": ok, "stream": torch.equal(sback, gum),
                "local_lanes": int(local.aip_state.shape[0]),
                "local_agents": (int(local.aip_state.shape[1])
                                 if A > 1 else 1),
                "dtypes": sorted({str(l.dtype) for l in tree_leaves(local)})}
    if dist.get_rank() == 0:
        print(json.dumps(res))
    dist.destroy_process_group()
""")


def test_shard_and_gather_round_trip(tmp_path):
    """On 4 gloo ranks (data = 2, model = 2): the engine state of both
    domains (bool, int8 and float leaves) and a Gumbel stream go to the
    rank's block and back to the global tree unchanged; at A = 4 the
    agents co-shard (2 a rank, 4 lanes), at A = 6 too (3 a rank), at
    A = 1 the lanes take both axes (2 a rank)."""
    res = spawn(4, ["-c", ROUND_TRIP, f"file://{tmp_path / 'store'}"])
    assert [rc for rc, _ in res] == [0] * 4, res[0][1][-3000:]
    out = json.loads(res[0][1].strip().splitlines()[-1])
    for domain in ("traffic", "warehouse"):
        for A, want in ((1, (2, 1)), (4, (4, 2)), (6, (4, 3))):
            r = out[f"{domain}-{A}"]
            assert r["state"] and r["stream"], (domain, A, r)
            assert (r["local_lanes"], r["local_agents"]) == want, (A, r)
    assert "torch.bool" in out["traffic-4"]["dtypes"]


# ---------------------------------------------------------------------------
# rl_train under ranks
# ---------------------------------------------------------------------------

RL_ARGS = ["-m", "repro_torch.launch.rl_train", "--device", "cpu",
           "--eval-every", "1", "--collect-episodes", "4", "--aip-epochs",
           "1", "--n-envs", "8", "--rollout-len", "8", "--episode-len", "8",
           "--save-every", "1", "--dist-timeout-s", "60"]


def _hist(out):
    return [(r["loss"], r["train_reward"], r.get("gs_eval_reward"))
            for r in out["history"]]


def _rl_ranks(world, argv, tmp, tag):
    res = spawn(world, RL_ARGS + argv + [
        "--dist-init", f"file://{tmp / ('store_' + tag)}"])
    assert [rc for rc, _ in res] == [0] * world, res[0][1][-3000:]
    return res


def test_rl_train_on_two_ranks_repeats_the_one_process_run(tmp_path):
    """Traffic, FNN AIP, A = 1, 3 iterations: the final-parameter md5, the
    losses, the train rewards and the GS evaluations of rank 0 equal the
    one-process run's; rank 1 prints no row."""
    one_process(RL_ARGS + ["--iterations", "3", "--out",
                           str(tmp_path / "one.json")])
    res = _rl_ranks(2, ["--iterations", "3", "--out",
                        str(tmp_path / "two.json")], tmp_path, "two")
    one = json.loads((tmp_path / "one.json").read_text())
    two = json.loads((tmp_path / "two.json").read_text())
    assert two["world_size"] == 2
    assert two["final_params_md5"] == one["final_params_md5"]
    assert _hist(two) == _hist(one)
    assert '"iter": 0' in res[0][1] and '"iter"' not in res[1][1]


def test_rl_train_resumes_across_world_sizes(tmp_path):
    """A one-process checkpoint at iteration 1 resumed under 2 ranks to 3,
    and a 2-rank checkpoint at 2 resumed in one process to 3, end on the
    uninterrupted one-process run's parameters bitwise: the checkpoint
    holds the gathered global state."""
    one_process(RL_ARGS + ["--iterations", "3", "--out",
                           str(tmp_path / "ref.json")])
    ref = json.loads((tmp_path / "ref.json").read_text())
    ck1, ck2 = tmp_path / "ck1", tmp_path / "ck2"
    one_process(RL_ARGS + ["--iterations", "1", "--ckpt-dir", str(ck1)])
    _rl_ranks(2, ["--iterations", "3", "--ckpt-dir", str(ck1), "--out",
                  str(tmp_path / "a.json")], tmp_path, "a")
    _rl_ranks(2, ["--iterations", "2", "--ckpt-dir", str(ck2)], tmp_path,
              "b")
    one_process(RL_ARGS + ["--iterations", "3", "--ckpt-dir", str(ck2),
                           "--out", str(tmp_path / "b.json")])
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    assert (a["resumed_from"], b["resumed_from"]) == (1, 2)
    assert a["final_params_md5"] == b["final_params_md5"] == \
        ref["final_params_md5"]
    assert _hist(a) == _hist(ref)[1:] and _hist(b) == _hist(ref)[2:]


def test_rl_train_gs_on_two_ranks_runs(tmp_path):
    """``--simulator gs`` (PPO's plain loop on the GS's lanes of each
    rank) runs under ranks and reports its md5; it repeats the
    one-process run here on the CPU."""
    argv = ["--simulator", "gs", "--n-agents", "3", "--iterations", "2"]
    one_process(RL_ARGS + argv + ["--out", str(tmp_path / "one.json")])
    _rl_ranks(2, argv + ["--out", str(tmp_path / "two.json")], tmp_path,
              "gs")
    one = json.loads((tmp_path / "one.json").read_text())
    two = json.loads((tmp_path / "two.json").read_text())
    assert two["final_params_md5"] == one["final_params_md5"]


def test_rl_train_gathers_the_rollout_state_only_for_a_save(
        tmp_path, monkeypatch):
    """With ``--ckpt-dir`` the global rollout state is gathered (a
    collective under ranks) only on the iterations that save: at
    ``--save-every 2`` over 3 iterations, once, after the second."""
    from repro_torch.rl import ppo
    gathers = []
    real = ppo.gather_rollout

    def counted(rs, mesh, *a):
        gathers.append(mesh)
        return real(rs, mesh, *a)
    monkeypatch.setattr(ppo, "gather_rollout", counted)
    argv = RL_ARGS[2:] + ["--iterations", "3", "--eval-every", "100",
                          "--ckpt-dir", str(tmp_path / "ck")]
    argv[argv.index("--save-every") + 1] = "2"
    out = rl_train.run_training(rl_train.parse_args(argv))
    assert gathers == [None]
    assert ["ckpt_save_s" in r for r in out["history"]] == \
        [False, True, False]
    from repro_torch.checkpoint import ckpt
    assert ckpt.latest_step(tmp_path / "ck") == 2


RANK0_ALONE = textwrap.dedent("""
    import sys, time
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_ranks, make_host_mesh,
                                         rank0_alone)
    init_ranks("gloo", "cpu", init_method=sys.argv[1], timeout_s=5)
    mesh = make_host_mesh()
    with rank0_alone(mesh, 60):
        if dist.get_rank() == 0:
            time.sleep(10)    # rank 0's fit, longer than the group's 5 s
    t = torch.tensor([dist.get_rank() + 7.0])
    dist.broadcast(t, 0)
    assert float(t) == 7.0
    dist.destroy_process_group()
    print("rank0_alone ok")
""")


def test_the_ranks_wait_for_rank0s_fit_beyond_the_group_timeout(tmp_path):
    """Rank 0 works alone for 10 s (the collection and the AIP fit) in a
    process group whose collectives time out after 5 s: the other rank
    waits for it in ``rank0_alone``'s own gloo group, not in a collective
    of the process group, and both go on."""
    res = spawn(2, ["-c", RANK0_ALONE, f"file://{tmp_path / 'store'}"])
    assert [rc for rc, _ in res] == [0, 0], res[1][1][-3000:]
    assert all("rank0_alone ok" in out for _, out in res)


LATE_START = textwrap.dedent("""
    import os, sys, time
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    if os.environ["RANK"] == "1":
        time.sleep(8)     # a late interpreter, past the group's 5 s
    init_ranks("gloo", "cpu", init_method=sys.argv[1], timeout_s=5)
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    assert float(t) == 3.0
    dist.destroy_process_group()
    print("late start ok")
""")


def test_ranks_that_start_apart_join_a_group_with_a_short_timeout(tmp_path):
    """``init_ranks`` meets the ranks in the store (``RENDEZVOUS_S``)
    before the group connects: a rank that starts 8 s late joins a group
    whose waits time out after 5 s."""
    res = spawn(2, ["-c", LATE_START, f"file://{tmp_path / 'store'}"])
    assert [rc for rc, _ in res] == [0, 0], res[1][1][-3000:]
    assert all("late start ok" in out for _, out in res)


# ---------------------------------------------------------------------------
# refusals: nothing runs other than what was asked
# ---------------------------------------------------------------------------

def test_rl_train_refuses_n_envs_the_ranks_do_not_divide(tmp_path):
    res = spawn(2, RL_ARGS + ["--iterations", "1", "--n-envs", "3",
                              "--dist-init",
                              f"file://{tmp_path / 'store'}"])
    for rc, out in res:
        assert rc != 0
        assert "n_envs=3 does not divide over the 2 lane blocks" in out


def test_rl_train_refuses_the_fleet_under_ranks(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = rl_train.parse_args(["--device", "cpu", "--n-workers", "2"])
    with pytest.raises(ValueError, match="fleet takes no mesh"):
        rl_train.join_ranks(args)


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """Two ranks on one card: NCCL refuses them, so the launcher raises
    instead of switching backend; gloo may share the card."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        mesh_mod.mesh_rank_device("nccl", "cuda")
    assert mesh_mod.mesh_rank_device("gloo", "cuda") == \
        torch.device("cuda", 0)
    with pytest.raises(ValueError, match="nccl needs --device cuda"):
        mesh_mod.init_ranks("nccl", "cpu")


def test_sharded_ppo_refuses_an_env_not_made_for_the_mesh():
    """A mesh of more than one rank with an env that draws its global
    lanes raises (its noise could not be cut into blocks)."""
    from repro_torch.core import engine, influence
    from repro_torch.envs.traffic import (TrafficConfig,
                                          make_batched_local_traffic_env)
    from repro_torch.rl import ppo

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 1}
    dev = torch.device("cpu")
    ls = make_batched_local_traffic_env(TrafficConfig(), dev)
    acfg = influence.AIPConfig(kind="fnn", d_in=ls.spec.dset_dim,
                               n_out=ls.spec.n_influence, hidden=8,
                               stack=2)
    env = engine.make_unified_ials(
        ls, influence.init_aip(acfg, torch.Generator().manual_seed(0)),
        acfg)
    cfg = ppo.PPOConfig(obs_dim=ls.spec.obs_dim, n_actions=2, n_envs=4,
                        rollout_len=2)
    with pytest.raises(ValueError, match="env made for the mesh"):
        ppo.draw_rollout_streams(env, cfg, torch.Generator(), Mesh())


def test_a_sigterm_to_one_rank_stops_every_rank_after_one_flush(tmp_path):
    """SIGTERM to rank 1 alone, once rank 0 has printed a row: the ranks
    agree on it (``all_reduce`` MAX), rank 0 flushes the global
    checkpoint, both exit 0 at the same iteration, and one process
    resumes it to the uninterrupted run's parameters bitwise."""
    import signal
    import time
    argv = RL_ARGS + ["--iterations", "40", "--eval-every", "100"]
    one_process(argv + ["--out", str(tmp_path / "ref.json")])
    ck = tmp_path / "ck"
    procs = [subprocess.Popen(
        [sys.executable, *argv, "--ckpt-dir", str(ck), "--save-every",
         "1000", "--dist-init", f"file://{tmp_path / 'store'}"], cwd=ROOT,
        env=_env(r, 2), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        t0 = time.time()
        first = ""
        while '"iter": 0' not in first and time.time() - t0 < 90:
            first += procs[0].stdout.readline()
        procs[1].send_signal(signal.SIGTERM)
        outs = [first + p.communicate(timeout=RANK_TIMEOUT_S)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:]
    assert "checkpoint flushed, exiting cleanly" in outs[0]
    from repro_torch.checkpoint import ckpt
    step = ckpt.latest_step(ck)
    assert step is not None and 1 <= step < 40
    one_process(argv + ["--ckpt-dir", str(ck), "--out",
                        str(tmp_path / "res.json")])
    res = json.loads((tmp_path / "res.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert res["resumed_from"] == step
    assert res["final_params_md5"] == ref["final_params_md5"]
