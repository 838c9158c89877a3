"""The port's PPO (``repro_torch/rl/ppo.py``) against ``repro.rl.ppo``:
the policy forward (``FWD_ATOL``), GAE against the JAX associative scan
(``FWD_ATOL``), the PPO loss and its gradient (``FWD_ATOL``), the learner
update given the JAX package's minibatch permutations (``OPT_ATOL``), and
one whole training iteration on the IALS at A = 1 and A = 3 from the same
weights and the same streams: the rollout batch leaf by leaf with the
lane and flip rule, then the updated parameters (``OPT_ATOL``)."""
import numpy as np
import pytest

from test_torch_common import (FWD_ATOL, OPT_ATOL, assert_close,
                               assert_lanes_match, to_t)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import influence as jinf  # noqa: E402
from repro.envs import traffic as jtr  # noqa: E402
from repro.envs.api import horizon_noise as jhorizon  # noqa: E402
from repro.rl import ppo as jppo  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import influence as tinf  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.rl import ppo as tppo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N_ENVS, T = 4, 8


def _cfgs(A=1, **kw):
    base = dict(obs_dim=41, n_actions=2, hidden=16, n_envs=N_ENVS,
                rollout_len=T, episode_len=5, n_agents=A, epochs=2,
                n_minibatches=2)
    base.update(kw)
    return jppo.PPOConfig(**base), tppo.PPOConfig(**base)


def _policy(seed=0):
    jc, _ = _cfgs()
    p = jppo.init_policy(jc, jax.random.PRNGKey(seed))
    leaves, tdef = jax.tree_util.tree_flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 50), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        l + 0.1 * jax.random.normal(k, l.shape) for l, k in zip(leaves,
                                                                 keys)])


def _grads_close(tg, jg, atol):
    for t, j in zip(tg, jax.tree_util.tree_leaves(jg)):
        assert_close(t, j, atol)


def test_policy_forward_matches():
    jp = _policy()
    x = np.random.default_rng(0).random((32, 41)).astype(np.float32)
    for fast in (True, False):
        jl, jv = jppo.policy_forward(jp, jnp.asarray(x), fast_gates=fast)
        tl, tv = tppo.policy_forward(to_t(jp), torch.from_numpy(x),
                                     fast_gates=fast)
        assert_close(tl, jl, FWD_ATOL)
        assert_close(tv, jv, FWD_ATOL)


def test_gae_matches_the_associative_scan():
    rng = np.random.default_rng(1)
    batch = {"v": rng.normal(size=(16, 6)).astype(np.float32),
             "r": rng.random((16, 6)).astype(np.float32),
             "done": (rng.random((16, 6)) < 0.2).astype(np.float32)}
    v_last = rng.normal(size=(6,)).astype(np.float32)
    ja, jr = jppo.gae({k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.asarray(v_last), 0.99, 0.95)
    ta, tr = tppo.gae({k: torch.from_numpy(v) for k, v in batch.items()},
                      torch.from_numpy(v_last), 0.99, 0.95)
    assert_close(ta, ja, FWD_ATOL)
    assert_close(tr, jr, FWD_ATOL)


def _minibatch(rng, n):
    return {"x": rng.random((n, 41)).astype(np.float32),
            "a": rng.integers(0, 2, n).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "adv": rng.normal(size=n).astype(np.float32),
            "ret": rng.normal(size=n).astype(np.float32)}


def test_ppo_loss_and_gradient_match():
    jc, tc = _cfgs()
    jp = _policy(2)
    mb = _minibatch(np.random.default_rng(2), 24)
    (jl, _), jg = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in mb.items()})
    tp = to_t(jp)
    leaves = [l.requires_grad_(True) for l in tree_leaves(tp)]
    tl, _ = tppo.ppo_loss(tp, tc, {k: torch.from_numpy(v)
                                   for k, v in mb.items()})
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) < FWD_ATOL
    _grads_close(tg, jg, FWD_ATOL)


def _jax_learner_perms(key, epochs, total):
    return np.stack([np.asarray(jax.random.permutation(k, total))
                     for k in jax.random.split(key, epochs)])


def test_learner_update_matches_given_jax_permutations():
    jc, tc = _cfgs()
    jp = _policy(3)
    rng = np.random.default_rng(3)
    batch = {"x": rng.random((T, N_ENVS, 41)).astype(np.float32),
             "a": rng.integers(0, 2, (T, N_ENVS)).astype(np.int32),
             "logp": np.log(rng.uniform(0.3, 0.7, (T, N_ENVS))
                            ).astype(np.float32),
             "v": rng.normal(size=(T, N_ENVS)).astype(np.float32),
             "r": rng.random((T, N_ENVS)).astype(np.float32),
             "done": (rng.random((T, N_ENVS)) < 0.2).astype(np.float32)}
    v_last = rng.normal(size=(N_ENVS,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jopt = jppo.make_optimizer(jc)
    jp2, _, jm = jppo.learner_update_fn(jc, jopt)(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(v_last), key)
    topt = tppo.make_optimizer(tc)
    tp = to_t(jp)
    tp2, _, tm = tppo.learner_update_fn(tc, topt)(
        tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(v_last),
        perms=_jax_learner_perms(key, jc.epochs, T * N_ENVS))
    _grads_close(tree_leaves(tp2), jp2, OPT_ATOL)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < OPT_ATOL


def _ials_pair(A):
    """The JAX engine (its scan route) and the port's engine (its
    policy_rollout route, the plain version on the CPU) on one FNN AIP."""
    acfg = jinf.AIPConfig(kind="fnn", d_in=40, n_out=4, hidden=8, stack=2)
    key = jax.random.PRNGKey(A)
    jaip = (jinf.init_aip(acfg, key) if A == 1 else
            jax.vmap(lambda k: jinf.init_aip(acfg, k))(
                jax.random.split(key, A)))
    jenv = jeng.make_unified_ials(
        jtr.make_batched_local_traffic_env(jtr.TrafficConfig()), jaip, acfg,
        n_agents=A)
    tcfg = tinf.AIPConfig(kind="fnn", d_in=40, n_out=4, hidden=8, stack=2)
    tenv = teng.make_unified_ials(ttr.make_batched_local_traffic_env(
        device="cpu"),
                                  to_t(jaip), tcfg, n_agents=A)
    return jenv, tenv


def _jax_streams(jenv, jc, key):
    """The rollout streams the JAX hoisted rollout derives from ``key``."""
    ka, ks, kr = jppo._split_tick_keys(key, jc.rollout_len)
    gum = jppo.bulk_gumbel(ka, (jc.n_envs,) + jc.agent_shape
                           + (jc.n_actions,))
    noise = jhorizon(jenv.noise_fn, ks, jc.n_envs)
    resets = jax.vmap(lambda k: jenv.reset(k, jc.n_envs))(kr)
    return gum, noise, resets


@pytest.mark.parametrize("A", [1, 3])
def test_train_iteration_matches_on_the_same_weights_and_streams(
        A, monkeypatch):
    jenv, tenv = _ials_pair(A)
    jc, tc = _cfgs(A)
    jp = _policy(5)
    key = jax.random.PRNGKey(6)
    rs = jppo.init_rollout_state(jenv, jc, key)
    k_roll, k_upd = jax.random.split(key)
    streams = _jax_streams(jenv, jc, k_roll)

    # the rollout batch, leaf by leaf
    trace = {}
    orig = ref.policy_rollout_ref
    monkeypatch.setattr(ref, "policy_rollout_ref",
                        lambda *a, **kw: orig(*a, trace=trace, **kw))
    jrs, jb, jv = jppo.rollout(jenv, jc, jp, rs, k_roll)
    trs, tb, tv = tppo.rollout(tenv, tc, to_t(jp), to_t(rs),
                               streams=to_t(streams))
    assert float(jb["done"].sum()) > 0
    L = N_ENVS * A
    margins = teng.stream_unfold(
        torch.minimum(torch.stack(trace["aip"]),
                      torch.stack(trace["policy"])), A, N_ENVS)
    flips = assert_lanes_match(
        [(tb[k].reshape(T, L, -1), np.asarray(jb[k]).reshape(T, L, -1),
          k in ("a", "done")) for k in ("x", "a", "logp", "v", "r", "done")],
        [(trs.env_state.ls_state.lanes.reshape(L, -1),
          np.asarray(jrs.env_state.ls_state.lanes).reshape(L, -1), True),
         (trs.frames.reshape(L, -1), np.asarray(jrs.frames).reshape(L, -1),
          False), (tv.reshape(L, 1), np.asarray(jv).reshape(L, 1), False)],
        margins.reshape(T, L), T, L)
    assert flips == 0      # these seeds take no decision near a threshold

    # the whole iteration: rollout + learner on the JAX permutations
    jopt = jppo.make_optimizer(jc)
    jp2, _, _, jm = jax.jit(jppo.train_iteration_fn(jenv, jc, jopt))(
        jp, jopt.init(jp), rs, key)
    topt = tppo.make_optimizer(tc)
    tp = to_t(jp)
    total = T * N_ENVS * A
    tp2, _, trs2, tm = tppo.train_iteration_fn(tenv, tc, topt)(
        tp, topt.init(tp), to_t(rs), None, streams=to_t(streams),
        perms=_jax_learner_perms(k_upd, jc.epochs, total))
    _grads_close(tree_leaves(tp2), jp2, OPT_ATOL)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < OPT_ATOL
    assert abs(float(tm["mean_reward"]) - float(jm["mean_reward"])) < \
        FWD_ATOL
