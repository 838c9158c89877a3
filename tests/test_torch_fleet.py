"""The port's actor/learner fleet (``repro_torch/distributed/
actor_learner.py``), mirroring ``tests/test_actor_learner.py`` but for its
8-device test: the deterministic fleet is a pure function of its seed; a
run stopped, checkpointed and resumed in a fresh trainer finishes bitwise
equal to the uninterrupted run; stale batches are dropped, never applied;
killed workers restart on their own streams; a scheduled fault fires
once; the async fleet reaches its target and joins its threads; a resize
on resume keeps the learner state; the fleet state round-trips through
the port's checkpoint with the simulator's parameters beside it. Every
produced batch is one ``policy_rollout`` (its plain version here), and
``rl_train --n-workers`` drives all of it from the command line."""
import math
import threading

import pytest

import test_torch_common  # noqa: F401  (one torch thread)

import torch  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import engine, influence  # noqa: E402
from repro_torch.distributed import actor_learner as al  # noqa: E402
from repro_torch.distributed import fault_injection as fi  # noqa: E402
from repro_torch.envs.traffic import (  # noqa: E402
    make_batched_local_traffic_env)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import rl_train  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x == y) if not isinstance(x, torch.Tensor)
        else (x.dtype == y.dtype and torch.equal(x, y))
        for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def tiny_env():
    """A small unified-IALS engine (the fleet's intended workload)."""
    bls = make_batched_local_traffic_env(device="cpu")
    acfg = influence.AIPConfig(kind="fnn", d_in=bls.spec.dset_dim,
                               n_out=bls.spec.n_influence, hidden=8,
                               stack=2)
    params = influence.init_aip(acfg, torch.Generator().manual_seed(0))
    return engine.make_unified_ials(bls, params, acfg)


@pytest.fixture(scope="module")
def tiny_cfg(tiny_env):
    return ppo.PPOConfig(obs_dim=tiny_env.spec.obs_dim,
                         n_actions=tiny_env.spec.n_actions,
                         frame_stack=2, n_envs=4, rollout_len=7,
                         episode_len=5, hidden=16, epochs=2)


def _fleet(deterministic=True, **kw):
    kw.setdefault("n_workers", 2)
    kw.setdefault("max_staleness", 2)
    kw.setdefault("seed", 5)
    return al.FleetConfig(deterministic=deterministic, **kw)


def _trainer(env, cfg, fleet=None, injector=None):
    return al.ActorLearnerTrainer(env, cfg, fleet or _fleet(),
                                  injector=injector, device="cpu")


def test_deterministic_fleet_is_seed_pure(tiny_env, tiny_cfg, monkeypatch):
    """Two same-seed runs are bitwise equal end to end, and each produced
    batch is one acting horizon on the engine's ``policy_rollout``."""
    calls = []
    orig = ref.policy_rollout_ref
    monkeypatch.setattr(ref, "policy_rollout_ref",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    outs = []
    for _ in range(2):
        tr = _trainer(tiny_env, tiny_cfg)
        outs.append(tr.run(tr.init_state(), 4))
    (s1, i1), (s2, i2) = outs
    assert _trees_equal(s1.params, s2.params)
    assert _trees_equal(s1.opt_state, s2.opt_state)
    assert int(s1.version) == int(s2.version) == 4
    assert [h["loss"] for h in i1["history"]] == \
           [h["loss"] for h in i2["history"]]
    assert len(calls) == i1["produced"] + i2["produced"]


def test_kill_and_resume_bitwise(tiny_env, tiny_cfg, tmp_path):
    """Run k updates, checkpoint, restore in a fresh trainer, run the
    remaining j: bitwise equal to the uninterrupted k + j run."""
    tr = _trainer(tiny_env, tiny_cfg)
    oracle, _ = tr.run(tr.init_state(), 5)

    tr1 = _trainer(tiny_env, tiny_cfg)
    mid, _ = tr1.run(tr1.init_state(), 2)
    ckpt.save(tmp_path, int(mid.version), mid,
              metadata=tr1.save_metadata(mid))

    tr2 = _trainer(tiny_env, tiny_cfg)
    restored, extra, start = al.resume_fleet(tmp_path, tr2)
    assert extra is None and start == 2
    assert _trees_equal(restored, mid)           # exact round trip
    final, _ = tr2.run(restored, 3)
    assert int(final.version) == 5
    assert _trees_equal(final.params, oracle.params)
    assert _trees_equal(final.opt_state, oracle.opt_state)
    for w_f, w_o in zip(final.workers, oracle.workers):
        assert int(w_f.rng_position) == int(w_o.rng_position)
        assert _trees_equal(w_f.rs, w_o.rs)


def test_resume_fleet_without_checkpoint(tmp_path, tiny_env, tiny_cfg):
    tr = _trainer(tiny_env, tiny_cfg)
    state, extra, start = al.resume_fleet(tmp_path / "none", tr)
    assert state is None and extra is None and start == 0


@pytest.mark.parametrize("bound,ticks,dropped", [(1, 4, 1), (4, 2, 0)],
                         ids=["past-the-bound", "within-the-bound"])
def test_staleness_drop_policy(tiny_env, tiny_cfg, bound, ticks, dropped):
    """A batch delayed past ``max_staleness`` is counted and recorded as
    dropped (with its staleness) and the learner still reaches its target;
    the same delay under a generous bound is applied."""
    inj = fi.FaultInjector(fi.FaultPlan.of(
        fi.DelayBatch(worker_id=0, at_tick=0, ticks=ticks)))
    tr = _trainer(tiny_env, tiny_cfg, _fleet(max_staleness=bound), inj)
    state, info = tr.run(tr.init_state(), 4)
    assert int(state.version) == 4
    assert info["delayed"] == 1 and info["dropped"] == dropped
    rows = [h for h in info["history"] if h["dropped"]]
    assert len(rows) == dropped and all(h["staleness"] > bound
                                        for h in rows)
    assert all(h["staleness"] <= bound for h in info["history"]
               if not h["dropped"])


def test_worker_kill_restarts_on_fresh_stream(tiny_env, tiny_cfg):
    """A killed worker loses its rollout state (restart count bumps) but
    the fleet trains on; the faulted run differs from the clean one and
    repeats itself."""
    def run_with(plan):
        inj = fi.FaultInjector(plan) if plan else None
        tr = _trainer(tiny_env, tiny_cfg, injector=inj)
        state, info = tr.run(tr.init_state(), 4)
        return state, info, inj

    plan = fi.FaultPlan.of(fi.KillWorker(worker_id=1, at_tick=1))
    clean, _, _ = run_with(None)
    s1, i1, inj1 = run_with(plan)
    s2, _, _ = run_with(plan)
    inj1.assert_exhausted()
    assert inj1.kills_applied == 1 and i1["kills"] == 1
    assert int(s1.workers[1].restarts) == 1
    assert int(s1.workers[0].restarts) == 0
    assert int(s1.version) == 4
    assert _trees_equal(s1.params, s2.params)         # faulted, replayable
    assert not _trees_equal(s1.params, clean.params)  # the fault is real


def test_fault_injector_fires_once():
    inj = fi.FaultInjector(fi.FaultPlan.of(
        fi.KillWorker(worker_id=0, at_tick=3)))
    assert not inj.should_kill(3, 1)      # wrong worker
    assert not inj.should_kill(2, 0)      # wrong tick
    with pytest.raises(AssertionError):
        inj.assert_exhausted()
    assert inj.should_kill(3, 0)
    assert not inj.should_kill(3, 0)      # consumed
    inj.assert_exhausted()
    assert inj.kills_applied == 1


def test_async_fleet_trains_and_joins(tiny_env, tiny_cfg):
    """Worker threads: the target version is reached, the threads are
    joined, applied batches respect the bound, worker states come back."""
    before = threading.active_count()
    tr = _trainer(tiny_env, tiny_cfg,
                  _fleet(deterministic=False, max_staleness=8))
    state, info = tr.run(tr.init_state(), 3)
    assert threading.active_count() == before
    assert int(state.version) == 3
    assert info["produced"] >= info["updates"]
    applied = [h for h in info["history"] if not h["dropped"]]
    assert all(h["staleness"] <= 8 for h in applied)
    assert all(math.isfinite(h["loss"]) for h in applied)
    assert sum(int(w.rng_position) for w in state.workers) \
        >= info["produced"]


def test_async_fleet_counts_every_batch_under_thread_churn(tiny_env,
                                                         tiny_cfg):
    """Eight worker threads (more than this machine's share of cores),
    switching every 10 us: every produced batch is counted once, so the
    workers' stream positions sum to ``produced``; the threads join."""
    import sys
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tr = _trainer(tiny_env, tiny_cfg,
                      _fleet(deterministic=False, n_workers=8,
                             max_staleness=64, queue_size=2))
        state, info = tr.run(tr.init_state(), 6)
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() == before
    assert int(state.version) == 6 and info["updates"] == 6
    assert sum(int(w.rng_position) for w in state.workers) \
        == info["produced"]


def test_fleet_resize_keeps_learner_state(tiny_env, tiny_cfg, tmp_path):
    """Resume with another worker count: the learner state survives
    bitwise, kept workers keep their stream positions, new ones start at
    0."""
    tr2 = _trainer(tiny_env, tiny_cfg, _fleet(n_workers=2))
    state, _ = tr2.run(tr2.init_state(), 4)
    ckpt.save(tmp_path, 4, state, metadata=tr2.save_metadata(state))

    tr3 = _trainer(tiny_env, tiny_cfg, _fleet(n_workers=3))
    grown, _, start = al.resume_fleet(tmp_path, tr3)
    assert start == 4 and len(grown.workers) == 3
    assert _trees_equal(grown.params, state.params)
    assert _trees_equal(grown.opt_state, state.opt_state)
    for w_old, w_new in zip(state.workers, grown.workers[:2]):
        assert int(w_new.rng_position) == int(w_old.rng_position)
    assert int(grown.workers[2].rng_position) == 0

    tr1 = _trainer(tiny_env, tiny_cfg, _fleet(n_workers=1))
    shrunk, _, _ = al.resume_fleet(tmp_path, tr1)
    assert len(shrunk.workers) == 1
    assert _trees_equal(shrunk.params, state.params)


def test_rl_state_roundtrip_with_sim_params(tiny_env, tiny_cfg, tmp_path):
    """The tree ``rl_train`` checkpoints — the fleet state and the
    simulator's AIP — round-trips bitwise; ``read_metadata`` reads the
    counters without the arrays."""
    tr = _trainer(tiny_env, tiny_cfg)
    state, _ = tr.run(tr.init_state(), 2)
    acfg = influence.AIPConfig(kind="fnn", d_in=3, n_out=2, hidden=8,
                               stack=2)
    sim = influence.init_aip(acfg, torch.Generator().manual_seed(7))
    ckpt.save(tmp_path, 2, {"fleet": state, "extra": sim},
              metadata=tr.save_metadata(state))

    tr2 = _trainer(tiny_env, tiny_cfg)
    restored, sim_back, start = al.resume_fleet(
        tmp_path, tr2, extra_template=influence.init_aip(
            acfg, torch.Generator().manual_seed(0)))
    assert start == 2
    assert _trees_equal(sim_back, sim)
    assert _trees_equal(restored, state)
    meta = ckpt.read_metadata(tmp_path)
    assert meta["n_workers"] == 2 and meta["version"] == 2
    assert meta["rng_positions"] == [int(w.rng_position)
                                     for w in state.workers]


FLEET = ["--iterations", "4", "--eval-every", "2", "--collect-episodes", "2",
         "--aip-epochs", "1", "--n-envs", "4", "--rollout-len", "8",
         "--episode-len", "8", "--device", "cpu", "--n-workers", "2",
         "--seed", "3"]


def _fleet_run(argv):
    return rl_train.run_training(rl_train.parse_args(FLEET + argv))


def test_rl_train_fleet_resumes_bitwise(tmp_path):
    """``rl_train --n-workers 2``: repeats itself, and 2 updates with a
    checkpoint then a resume to 4 give the uninterrupted run's params."""
    full = _fleet_run([])
    assert full["final_params_md5"] == _fleet_run([])["final_params_md5"]
    assert full["fleet"]["updates"] == 4
    part = _fleet_run(["--iterations", "2", "--ckpt-dir", str(tmp_path),
                       "--save-every", "1"])
    assert part["fleet"]["updates"] == 2
    res = _fleet_run(["--ckpt-dir", str(tmp_path), "--save-every", "1"])
    assert res["diag"]["resumed_from"] == 2
    assert res["final_params_md5"] == full["final_params_md5"]
    evals = [r["gs_eval_reward"] for r in full["history"]
             if "gs_eval_reward" in r]
    assert len(evals) == 2 and all(0.0 <= e <= 1.0 for e in evals)


# worker w produces at the ticks t with t % 2 == w: the plan's coordinates
# must lie on that schedule to fire
@pytest.mark.parametrize("argv", [
    ["--kill-worker", "1:3", "--delay-batch", "0:0:3", "--max-staleness",
     "1"],
    ["--async-fleet"]], ids=["faulted", "async"])
def test_rl_train_fleet_faults_and_async(argv, monkeypatch):
    calls = []
    orig = ref.policy_rollout_ref
    monkeypatch.setattr(ref, "policy_rollout_ref",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    out = _fleet_run(argv)
    st = out["fleet"]
    assert st["updates"] == 4 and len(calls) == st["produced"]
    losses = [r["loss"] for r in out["history"] if "loss" in r]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    if "--kill-worker" in argv:
        assert st["kills"] == 1 and st["dropped"] >= 1
        assert st["faults_exhausted"]
