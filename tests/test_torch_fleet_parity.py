"""The port's actor/learner fleet held against the JAX package's.

The deterministic schedule does not depend on the random draws: which
worker produces at each tick, the policy version each batch was acted
under, the staleness gate, the delivery of delayed batches, the quiesce
at a chunk's end and the counters are a function of the ``FleetConfig``,
the fault plan and ``should_stop`` alone. So the JAX
``ActorLearnerTrainer`` and the port's, run on the same configuration and
plan, must write the same ``(version, worker, staleness, dropped)``
history rows, the same counters and the same final clocks and stream
positions. And a checkpoint that the JAX ``rl_train --n-workers`` wrote
has the leaf paths and dtypes of the port's and resumes in the port's
``resume_fleet`` bitwise."""
import copy
import math

import jax
import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one torch thread)

import torch  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import influence as jinfluence  # noqa: E402
from repro.distributed import actor_learner as jal  # noqa: E402
from repro.distributed import fault_injection as jfi  # noqa: E402
from repro.envs.traffic import TrafficConfig  # noqa: E402
from repro.envs.traffic import (  # noqa: E402
    make_batched_local_traffic_env as jmake_bls)
from repro.launch import rl_train as jrl  # noqa: E402
from repro.rl import ppo as jppo  # noqa: E402
from repro_torch.checkpoint import ckpt, mpack  # noqa: E402
from repro_torch.core import engine, influence  # noqa: E402
from repro_torch.distributed import actor_learner as al  # noqa: E402
from repro_torch.distributed import fault_injection as fi  # noqa: E402
from repro_torch.envs.traffic import make_batched_local_traffic_env  # noqa
from repro_torch.launch import rl_train  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

PPO = dict(frame_stack=2, n_envs=4, rollout_len=5, episode_len=5, hidden=8,
           epochs=1)


@pytest.fixture(scope="module")
def trainers():
    """One JAX and one port trainer over the same tiny FNN IALS engine
    shape; each case copies them with its own fleet and injector (the JAX
    trainer's jitted programs do not depend on either, so they compile
    once)."""
    jbls = jmake_bls(TrafficConfig())
    jacfg = jinfluence.AIPConfig(kind="fnn", d_in=jbls.spec.dset_dim,
                                 n_out=jbls.spec.n_influence, hidden=8,
                                 stack=2)
    jenv = jengine.make_unified_ials(
        jbls, jinfluence.init_aip(jacfg, jax.random.PRNGKey(0)), jacfg)
    jcfg = jppo.PPOConfig(obs_dim=jenv.spec.obs_dim,
                          n_actions=jenv.spec.n_actions, **PPO)

    bls = make_batched_local_traffic_env(device="cpu")
    acfg = influence.AIPConfig(kind="fnn", d_in=bls.spec.dset_dim,
                               n_out=bls.spec.n_influence, hidden=8,
                               stack=2)
    env = engine.make_unified_ials(
        bls, influence.init_aip(acfg, torch.Generator().manual_seed(0)),
        acfg)
    cfg = ppo.PPOConfig(obs_dim=env.spec.obs_dim,
                        n_actions=env.spec.n_actions, **PPO)
    return (jal.ActorLearnerTrainer(jenv, jcfg, jal.FleetConfig()),
            al.ActorLearnerTrainer(env, cfg, al.FleetConfig(),
                                   device="cpu"))


def _schedule(base, fleet_mod, fi_mod, fleet_kw, plan, chunks, stop_after):
    """Run ``chunks`` (updates per ``run`` call) -> what the schedule
    decides: history rows without the losses, counters, clocks."""
    tr = copy.copy(base)
    tr.fleet = fleet_mod.FleetConfig(seed=5, **fleet_kw)
    tr.injector = (fi_mod.FaultInjector(fi_mod.FaultPlan.of(*(
        (fi_mod.KillWorker if kind == "kill" else fi_mod.DelayBatch)(*ev)
        for kind, *ev in plan))) if plan else None)
    state = tr.init_state()
    rows, counters = [], []
    for n in chunks:
        calls = []
        stop = (None if stop_after is None else
                lambda: calls.append(1) or len(calls) > stop_after)
        state, info = tr.run(state, n, should_stop=stop)
        rows += [(h["version"], h["worker"], h["staleness"], h["dropped"])
                 for h in info["history"]]
        counters.append({k: info[k] for k in ("produced", "updates",
                                              "dropped", "delayed")
                         if k in info} | ({"kills": info["kills"]}
                                          if "kills" in info else {}))
        assert all(math.isfinite(h["loss"]) for h in info["history"]
                   if not h["dropped"])
    return {"rows": rows, "counters": counters,
            "version": int(state.version), "tick": int(state.tick),
            "positions": [int(w.rng_position) for w in state.workers],
            "restarts": [int(w.restarts) for w in state.workers],
            "exhausted": None if tr.injector is None
            else tr.injector.exhausted}


# (fleet config, fault plan as (kind, worker, tick[, ticks]), updates per
# run() call, should_stop turning true after that many polls)
CASES = {
    "clean": (dict(max_staleness=2), [], [4], None),
    "kill": (dict(max_staleness=2), [("kill", 1, 1)], [4], None),
    "delay-past-bound-1": (dict(max_staleness=1), [("delay", 0, 0, 4)],
                           [4], None),
    "delay-within-bound-4": (dict(max_staleness=4), [("delay", 0, 0, 2)],
                             [4], None),
    "kill-and-delays-3-workers": (
        dict(n_workers=3, max_staleness=1),
        [("kill", 2, 2), ("delay", 0, 3, 3), ("delay", 1, 4, 1)], [6],
        None),
    "publish-every-2": (dict(max_staleness=3, publish_every=2),
                        [("delay", 1, 1, 2)], [5], None),
    "delayed-past-the-chunk": (dict(max_staleness=20),
                               [("delay", 1, 3, 10)], [4, 2], None),
    "stopped-then-quiesced": (dict(max_staleness=20),
                              [("delay", 0, 0, 10), ("delay", 1, 1, 10)],
                              [4], 2),
    "two-chunks-off-schedule-plan": (
        dict(max_staleness=1), [("kill", 1, 2), ("delay", 0, 1, 3)],
        [2, 2], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_deterministic_schedule_matches_the_reference(trainers, case):
    jtr, tr = trainers
    fleet_kw, plan, chunks, stop_after = CASES[case]
    want = _schedule(jtr, jal, jfi, fleet_kw, plan, chunks, stop_after)
    got = _schedule(tr, al, fi, fleet_kw, plan, chunks, stop_after)
    assert got == want
    # the cases reach every branch of the schedule between them
    if case == "kill":
        assert got["counters"][0]["kills"] == 1 and got["restarts"][1] == 1
    if case == "delay-past-bound-1":
        assert any(r[3] for r in got["rows"])
    if case == "delayed-past-the-chunk":
        assert got["counters"][0]["dropped"] == 1   # dropped at quiesce
    if case == "stopped-then-quiesced":
        assert got["version"] == 2 and got["counters"][0]["delayed"] == 2
    if case == "two-chunks-off-schedule-plan":
        assert got["exhausted"] is False


def _leaf_layout(d):
    raw = mpack.unpackb((d / "meta.msgpack").read_bytes())
    return raw["paths"], raw["dtypes"]


def test_a_jax_fleet_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX ``rl_train --n-workers 2`` writes ``{"fleet", "extra"}``
    after 2 updates; the port's checkpoint of the same run has the same
    leaf paths and dtypes; the port's ``rl_train`` resumes the JAX one
    through ``resume_fleet`` (every leaf bitwise) and trains on to 4."""
    base = ["--domain", "traffic", "--simulator", "ials", "--aip", "fnn",
            "--eval-every", "2", "--n-envs", "4", "--rollout-len", "8",
            "--episode-len", "8", "--collect-episodes", "2",
            "--aip-epochs", "1", "--seed", "4", "--n-workers", "2",
            "--save-every", "1"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jout = jrl.main(base + ["--iterations", "2", "--ckpt-dir", str(jdir)])
    assert ckpt.latest_step(jdir) == 2 and jout["fleet"]["updates"] == 2
    pout = rl_train.main(base + ["--iterations", "2", "--ckpt-dir",
                                 str(pdir), "--device", "cpu"])
    assert ckpt.latest_step(pdir) == 2 and pout["fleet"]["updates"] == 2
    jpaths, jdtypes = _leaf_layout(jdir / "step_000000002")
    assert (jpaths, jdtypes) == _leaf_layout(pdir / "step_000000002")
    assert ckpt.read_metadata(jdir) == ckpt.read_metadata(pdir)

    restored = []
    orig = ckpt.restore
    monkeypatch.setattr(ckpt, "restore", lambda *a, **kw: restored.append(
        orig(*a, **kw)) or restored[-1])
    out = rl_train.main(base + ["--iterations", "4", "--ckpt-dir",
                                str(jdir), "--device", "cpu"])
    assert out["diag"]["resumed_from"] == 2
    assert out["fleet"]["updates"] == 2
    rows = [r for r in out["history"] if "train_reward" in r]
    assert [r["iter"] for r in rows] == [3, 4]
    assert all(math.isfinite(r["train_reward"]) for r in rows)
    assert 0.0 <= out["history"][-1]["gs_eval_reward"] <= 1.0

    tree = restored[0][0]
    leaves = tree_leaves_with_path(tree)
    assert [p for p, _ in leaves] == jpaths
    d = jdir / "step_000000002"
    with np.load(d / "arrays.npz") as data:
        for i, (path, leaf) in enumerate(leaves):
            want = data[f"leaf_{i:05d}"].view(jdtypes[i])
            got = (leaf.numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf, want.dtype))
            assert got.dtype == want.dtype, path
            np.testing.assert_array_equal(got.reshape(-1), want,
                                          err_msg=path)
    assert int(tree["fleet"].version) == 2
