"""The port's whole slice in-process on the CPU at a tiny size:
``repro_torch.launch.rl_train`` (GS collection -> AIP fit -> PPO on the
IALS through the engine's ``policy_rollout`` route -> GS evaluation) on
both domains, FNN and GRU at A = 1 and 3 (the warehouse also with
``--vanish-after 8``). Rows are finite and the GS evaluation reward lies
in [0, 1]."""
import math

import pytest

import test_torch_common  # noqa: F401  (one torch thread)

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import rl_train  # noqa: E402

TINY = ["--iterations", "2", "--eval-every", "1", "--collect-episodes", "4",
        "--aip-epochs", "1", "--n-envs", "4", "--rollout-len", "8",
        "--episode-len", "8", "--device", "cpu"]


@pytest.mark.parametrize("aip,agents", [("fnn", 1), ("gru", 3)])
def test_run_training_end_to_end(aip, agents, monkeypatch):
    calls = []
    orig = ref.policy_rollout_ref
    monkeypatch.setattr(ref, "policy_rollout_ref",
                        lambda *a, **kw: calls.append(kw["kind"])
                        or orig(*a, **kw))
    out = rl_train.run_training(rl_train.parse_args(
        TINY + ["--aip", aip, "--n-agents", str(agents)]))
    hist = out["history"]
    assert [r["iter"] for r in hist] == [0, 1]
    assert calls == [aip, aip]           # one acting horizon per iteration
    for r in hist:
        assert math.isfinite(r["loss"]) and math.isfinite(r["train_reward"])
        assert 0.0 <= r["gs_eval_reward"] <= 1.0
        if agents > 1:
            assert len(r["gs_eval_reward_per_agent"]) == agents
    assert out["diag"]["aip_xent"] > 0


def test_gs_simulator_trains_on_the_plain_loop():
    out = rl_train.run_training(rl_train.parse_args(
        TINY + ["--simulator", "gs", "--iterations", "1"]))
    assert 0.0 <= out["history"][0]["gs_eval_reward"] <= 1.0


@pytest.mark.parametrize("aip,agents,vanish", [
    ("fnn", 1, 0), ("gru", 1, 8), ("fnn", 3, 0), ("gru", 3, 0)])
def test_warehouse_training_end_to_end(aip, agents, vanish, monkeypatch):
    """``--domain warehouse``: the 8-frame policy over 37-wide
    observations, its acting horizon one ``policy_rollout`` call an
    iteration with the warehouse's spawn noise, the GS evaluation on the
    36-robot floor; the GRU AIP by default."""
    calls = []
    orig = ref.policy_rollout_ref
    monkeypatch.setattr(ref, "policy_rollout_ref",
                        lambda *a, **kw: calls.append(
                            (kw["kind"], a[2].shape[1], len(a[8])))
                        or orig(*a, **kw))
    argv = TINY + ["--domain", "warehouse", "--n-agents", str(agents),
                   "--vanish-after", str(vanish)]
    out = rl_train.run_training(rl_train.parse_args(
        argv + (["--aip", aip] if aip == "fnn" else [])))
    assert calls == [(aip, 296, 1)] * 2   # frames 8 x 37, the spawn leaf
    for r in out["history"]:
        assert math.isfinite(r["loss"]) and math.isfinite(r["train_reward"])
        assert 0.0 <= r["gs_eval_reward"] <= 1.0
        if agents > 1:
            assert len(r["gs_eval_reward_per_agent"]) == agents
    assert out["args"]["vanish_after"] == vanish


def test_unknown_domain_raises():
    with pytest.raises(ValueError, match="unknown domain"):
        rl_train.build_domain("storage", device="cpu")
