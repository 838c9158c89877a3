"""PPO's constructors and the quickstart on the port's scalar protocol:
``ppo.make_train_iteration`` equals ``train_iteration_fn`` on the same
streams, ``ppo.make_evaluator`` agrees with ``repro.rl.ppo.make_evaluator``
(``FWD_ATOL``) from the same reset states and policy with the GS noise off
(single-agent traffic and the multi-agent warehouse, ``per_agent``), the
scalar GS under the vmap adapter evaluates as the native batched GS, PPO
runs on a scalar IALS through ``as_batched``, ``collect_dataset`` takes either
protocol (and its ``policy=`` / ``dset_key=``), and
``examples/torch_quickstart.py`` runs end to end on ``--device cpu`` at a
tiny size: finite losses, a GS evaluation in [0, 1]."""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from test_torch_common import FWD_ATOL, to_t

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.envs import api as japi  # noqa: E402
from repro.envs import traffic as jtr  # noqa: E402
from repro.envs import warehouse as jwh  # noqa: E402
from repro.rl import ppo as jppo  # noqa: E402

from repro_torch.core import collect, engine, ials, influence  # noqa: E402
from repro_torch.envs import api  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402
from repro_torch.envs import warehouse as twh  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _scalar_ials(kind="fnn", seed=0):
    ls = ttr.make_local_traffic_env(device="cpu")
    acfg = influence.AIPConfig(kind=kind, d_in=40, n_out=4, hidden=16,
                               stack=3 if kind == "fnn" else 1)
    return ials.make_ials(ls, influence.init_aip(acfg, _gen(seed)), acfg)


def _pcfg(env, **kw):
    return ppo.PPOConfig(obs_dim=env.spec.obs_dim,
                         n_actions=env.spec.n_actions, hidden=16, n_envs=4,
                         rollout_len=6, episode_len=4, epochs=2,
                         n_minibatches=2, n_agents=env.spec.n_agents, **kw)


@pytest.mark.parametrize("kind", ["fnn", "gru"])
def test_make_train_iteration_equals_train_iteration_fn(kind):
    env = _scalar_ials(kind)
    cfg = _pcfg(env)
    params = ppo.init_policy(cfg, _gen(1))
    opt, iteration = ppo.make_train_iteration(env, cfg)
    direct = ppo.train_iteration_fn(env, cfg, ppo.make_optimizer(cfg))
    rs = ppo.init_rollout_state(env, cfg, _gen(2))
    streams = ppo.draw_rollout_streams(env, cfg, _gen(3))
    outs = []
    for fn in (iteration, direct):
        outs.append(fn(params, opt.init(params), rs, _gen(4),
                       streams=streams))
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)
    assert math.isfinite(float(outs[0][3]["loss"]))


def _gs_pair(domain):
    """(JAX GS, port GS) with the GS noise off (no inflow, no spawns), so
    that an evaluation is a function of its reset states and the policy
    alone: single-agent traffic, or the warehouse with three agents."""
    if domain == "traffic":
        return (jtr.make_traffic_env(jtr.TrafficConfig(p_in=0.0)),
                ttr.make_traffic_env(ttr.TrafficConfig(p_in=0.0), "cpu"))
    agents = [[0, 0], [1, 2], [3, 3]]
    return (jwh.make_multi_warehouse_env(jwh.WarehouseConfig(p_item=0.0),
                                         jnp.array(agents)),
            twh.make_multi_warehouse_env(twh.WarehouseConfig(p_item=0.0),
                                         agents, "cpu"))


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
def test_make_evaluator_matches_the_reference(domain):
    """The greedy loop (frame seeding and stacking, argmax, the mean over
    ticks and episodes, ``per_agent``) against ``repro.rl.ppo``'s, on the
    same converted policy and the JAX package's own reset states: each
    side's ``reset`` is wrapped to hand back those states."""
    jgs, tgs = _gs_pair(domain)
    n_eps, ep_len = 5, 12
    base = dict(obs_dim=tgs.spec.obs_dim, n_actions=tgs.spec.n_actions,
                hidden=16, n_envs=4, rollout_len=6, episode_len=ep_len,
                n_agents=tgs.spec.n_agents, frame_stack=3)
    jcfg, tcfg = jppo.PPOConfig(**base), ppo.PPOConfig(**base)
    jp = jppo.init_policy(jcfg, jax.random.PRNGKey(3))
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    jp = jax.tree_util.tree_unflatten(tdef, [   # logits well apart
        l + 0.5 * jax.random.normal(k, l.shape) for l, k in zip(leaves,
                                                                 keys)])
    jbat = japi.as_batched(jgs)
    states = jbat.reset(jax.random.PRNGKey(5), n_eps)
    jenv = jbat._replace(reset=lambda key, n: states)
    tbat = api.as_batched(tgs)
    tenv = tbat._replace(reset=lambda gen, n: to_t(states))
    want = np.asarray(jppo.make_evaluator(jenv, jcfg, n_episodes=n_eps)(
        jp, jax.random.PRNGKey(6)))
    got = ppo.make_evaluator(tenv, tcfg, n_episodes=n_eps)(to_t(jp),
                                                          _gen(6))
    assert got.shape == want.shape == ((3,) if domain == "warehouse"
                                       else ())
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)
    per = domain == "warehouse"
    jev = jppo.evaluate(jenv, jcfg, jp, jax.random.PRNGKey(7),
                        n_episodes=n_eps, per_agent=per)
    tev = ppo.evaluate(tenv, tcfg, to_t(jp), _gen(7), n_episodes=n_eps,
                       per_agent=per)
    np.testing.assert_allclose(np.asarray(tev), np.asarray(jev),
                               atol=FWD_ATOL, rtol=0)
    assert float(np.abs(want).sum()) > 0        # the agents earned reward


def test_the_scalar_gs_evaluates_as_the_native_batched_gs():
    gs = ttr.make_traffic_env(device="cpu")
    cfg = _pcfg(gs)
    params = ppo.init_policy(cfg, _gen(5))
    r = ppo.make_evaluator(gs, cfg, n_episodes=3, ep_len=5)(params,
                                                            _gen(6))
    assert r.shape == ()
    native = ttr.make_batched_traffic_env(device="cpu")
    assert float(r) == ppo.evaluate(native, cfg, params, _gen(6),
                                    n_episodes=3, ep_len=5)


def test_multi_agent_evaluator_per_agent():
    gs = twh.make_multi_warehouse_env(twh.WarehouseConfig(),
                                      [[0, 0], [1, 1]], "cpu")
    cfg = _pcfg(gs)
    params = ppo.init_policy(cfg, _gen(7))
    per = ppo.evaluate(gs, cfg, params, _gen(8), n_episodes=2, ep_len=4,
                       per_agent=True)
    assert per.shape == (2,)
    assert float(per.mean()) == ppo.evaluate(gs, cfg, params, _gen(8),
                                             n_episodes=2, ep_len=4)


@pytest.mark.parametrize("multi", [False, True])
def test_ppo_trains_on_a_scalar_ials_through_as_batched(multi):
    if multi:
        ls = twh.make_local_warehouse_env(device="cpu")
        acfg = influence.AIPConfig(kind="gru", d_in=24, n_out=12,
                                   hidden=16)
        env = ials.make_multi_ials(
            ls, influence.init_aip_stacked(acfg, _gen(9), 3), acfg, 3)
    else:
        env = _scalar_ials("fnn", 9)
    assert isinstance(env, api.Env)
    cfg = _pcfg(env)
    params = ppo.init_policy(cfg, _gen(10))
    opt, iteration = ppo.make_train_iteration(env, cfg)
    ost = opt.init(params)
    rs = ppo.init_rollout_state(env, cfg, _gen(11))
    g = _gen(12)
    for _ in range(2):
        params, ost, rs, m = iteration(params, ost, rs, g)
        assert math.isfinite(float(m["loss"]))
    lead = (cfg.n_envs,) + cfg.agent_shape
    assert rs.frames.shape[:len(lead)] == lead
    rs2, batch, v_last = ppo.rollout(env, cfg, params, rs, g)
    assert batch["r"].shape == (cfg.rollout_len,) + lead
    assert batch["done"].sum() > 0           # resets inside the horizon


def test_the_engine_and_its_historical_entry_point_train_alike():
    """``make_batched_ials`` takes PPO's kernel route (its
    ``policy_rollout``), as ``make_unified_ials`` does."""
    ls = ttr.make_batched_local_traffic_env(device="cpu")
    acfg = influence.AIPConfig(kind="fnn", d_in=40, n_out=4, hidden=16,
                               stack=3)
    aip = influence.init_aip(acfg, _gen(13))
    env = engine.make_batched_ials(ls, aip, acfg)
    assert env.policy_rollout is not None
    cfg = _pcfg(env)
    params = ppo.init_policy(cfg, _gen(14))
    opt, iteration = ppo.make_train_iteration(env, cfg)
    out = iteration(params, opt.init(params),
                    ppo.init_rollout_state(env, cfg, _gen(15)), _gen(16))
    assert math.isfinite(float(out[3]["loss"]))


def test_collect_dataset_takes_either_protocol():
    gs = ttr.make_traffic_env(device="cpu")
    a = collect.collect_dataset(gs, _gen(17), n_episodes=3, ep_len=5)
    b = collect.collect_dataset(api.batch_env(gs), _gen(17), n_episodes=3,
                                ep_len=5)
    native = collect.collect_dataset(ttr.make_batched_traffic_env(
        device="cpu"), _gen(17), n_episodes=3, ep_len=5)
    for k in ("d", "u", "reward"):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], native[k])
    assert a["d"].shape == (3, 5, 40) and a["u"].shape == (3, 5, 4)
    full = collect.collect_dataset(gs, _gen(17), n_episodes=3, ep_len=5,
                                   dset_key="dset_full")
    assert full["d"].shape == (3, 5, 41)
    assert torch.equal(full["d"][..., :40], a["d"])
    seen = []

    def always_one(gen, obs):
        seen.append(tuple(obs.shape))
        return torch.ones(obs.shape[:1], dtype=torch.long)

    pol = collect.collect_dataset(gs, _gen(18), n_episodes=2, ep_len=4,
                                  policy=always_one)
    assert seen == [(2, 41)] * 4 and pol["reward"].shape == (2, 4)


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_end_to_end_on_the_cpu():
    out = _quickstart().main(
        ["--device", "cpu", "--collect-episodes", "4", "--ep-len", "16",
         "--aip-epochs", "2", "--iterations", "2", "--n-envs", "4",
         "--rollout-len", "8", "--eval-episodes", "2"])
    assert out["transitions"] == 64
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"] + out["aip_xent"])
    assert 0.0 <= out["gs_eval_reward"] <= 1.0
    assert set(out["seconds"]) == {"collect", "aip", "ppo", "eval", "total"}


def test_quickstart_defaults_are_the_references_and_cuda():
    args = _quickstart().parse_args([])
    assert args.device == "cuda"
    assert (args.collect_episodes, args.ep_len, args.aip_epochs,
            args.iterations, args.n_envs, args.rollout_len,
            args.eval_episodes) == (48, 128, 10, 10, 16, 128, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _quickstart().main([])
