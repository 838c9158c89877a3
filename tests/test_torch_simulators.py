"""The paper's simulator grid in the port: the F-IALS route of
``repro_torch/core/engine.py`` (``fixed_marginal`` / ``fixed_marginal_vec``
/ ``stateless``), ``influence.accuracy``, and ``rl_train --simulator
untrained-ials | f-ials`` (``--fixed-marginal``, ``--stateless-f-ials``).

The F-IALS ``step_det`` is held against the JAX engine's (its scan route,
``use_horizon_kernel=False``) on the same LS state, AIP weights, actions,
bits and LS noise, on both domains at A = 1 and 3, GRU and FNN, shared
and per-agent marginals, stateless and not: ``u`` and the integer LS
leaves exactly, float leaves (the AIP state, obs, reward, ``u_probs``)
within ``FWD_ATOL``. The port's GRU AIP state of a non-stateless F-IALS
advances through the eager ``gru_cell``, never ``ops.aip_step``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import FWD_ATOL, assert_close, assert_equal, to_t

import torch  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import influence as jinf  # noqa: E402
from repro.envs import traffic as jtr  # noqa: E402
from repro.envs import warehouse as jwh  # noqa: E402
from repro_torch.core import collect, engine, influence  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402
from repro_torch.envs import warehouse as twh  # noqa: E402
from repro_torch.envs.api import horizon_noise  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import rl_train  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, TICKS, HID = 4, 3, 12
LS = {"traffic": (lambda: jtr.make_batched_local_traffic_env(
                      jtr.TrafficConfig()),
                  lambda: ttr.make_batched_local_traffic_env(device="cpu")),
      "warehouse": (lambda: jwh.make_batched_local_warehouse_env(
                        jwh.WarehouseConfig()),
                    lambda: twh.make_batched_local_warehouse_env(
                        device="cpu"))}
CASES = [pytest.param(d, kind, A, marg, stateless,
                      id=f"{d}-{A}-{kind}-{marg}"
                         + ("-stateless" if stateless else ""))
         for d in LS for A in (1, 3) for kind in ("gru", "fnn")
         for marg in ("scalar", "vec") for stateless in (False, True)]


def _aip(kind, A, ls, seed):
    cfg = jinf.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                         n_out=ls.spec.n_influence, hidden=HID,
                         stack=3 if kind == "fnn" else 1)
    key = jax.random.PRNGKey(seed)
    params = (jax.vmap(lambda k: jinf.init_aip(cfg, k))(
        jax.random.split(key, A)) if A > 1 else jinf.init_aip(cfg, key))
    tcfg = influence.AIPConfig(kind=kind, d_in=cfg.d_in, n_out=cfg.n_out,
                               hidden=HID, stack=cfg.stack)
    return cfg, tcfg, params


def _marg_kw(marg, A, M, rng):
    if marg == "scalar":
        return {"fixed_marginal": 0.3}
    shape = (A, M) if A > 1 else (M,)
    return {"fixed_marginal_vec": rng.uniform(0.05, 0.6, shape).astype(
        np.float32)}


@pytest.mark.parametrize("domain,kind,A,marg,stateless", CASES)
def test_f_ials_step_det_matches_the_jax_engine(domain, kind, A, marg,
                                                stateless, monkeypatch):
    rng = np.random.default_rng(7)
    jls, tls = LS[domain][0](), LS[domain][1]()
    M = jls.spec.n_influence
    cfg, tcfg, jp = _aip(kind, A, jls, 3)
    kw = _marg_kw(marg, A, M, rng)
    jenv = jengine.make_unified_ials(jls, jp, cfg, n_agents=A,
                                     stateless=stateless,
                                     use_horizon_kernel=False, **kw)
    tenv = engine.make_unified_ials(tls, to_t(jp), tcfg, n_agents=A,
                                    stateless=stateless, **kw)
    assert tenv.policy_rollout is None and jenv.policy_rollout is None
    monkeypatch.setattr(ops, "aip_step", None)        # never on this route
    monkeypatch.setattr(ops, "aip_step_multi", None)
    jst = jenv.reset(jax.random.PRNGKey(5), B)
    # a warmed-up AIP state, so the frozen and advanced cases differ
    jst = jst._replace(aip_state=jnp.asarray(
        0.5 * rng.normal(size=jst.aip_state.shape), jnp.float32))
    tst = to_t(jst)
    ash = (A,) if A > 1 else ()
    for _ in range(TICKS):
        acts = rng.integers(0, jls.spec.n_actions, (B,) + ash)
        bits = rng.integers(0, 2 ** 32, (B,) + ash + (M,), dtype=np.uint32)
        env_nz = (rng.random((B * A, 12)) < 0.3 if domain == "warehouse"
                  else None)
        jst2, jobs, jr, jinfo = jenv.step_det(
            jst, jnp.asarray(acts, jnp.int32),
            {"bits": jnp.asarray(bits), "env": None if env_nz is None
             else jnp.asarray(env_nz)})
        tst2, tobs, tr, tinfo = tenv.step_det(
            tst, torch.as_tensor(acts), {"bits": to_t(bits),
                                         "env": None if env_nz is None
                                         else torch.as_tensor(env_nz)})
        assert_equal(tinfo["u"], jinfo["u"])
        assert_equal(tinfo["u_probs"], jinfo["u_probs"])
        for a, b in zip(tree_leaves(tst2.ls_state),
                        jax.tree_util.tree_leaves(jst2.ls_state)):
            assert_equal(a, b)                       # integer LS leaves
        assert_close(tst2.aip_state, jst2.aip_state, FWD_ATOL)
        assert_close(tobs, jobs, FWD_ATOL)
        assert_close(tr, jr, FWD_ATOL)
        if stateless:
            assert torch.equal(tst2.aip_state, tst.aip_state)
        jst, tst = jst2, tst2


@pytest.mark.parametrize("domain", list(LS))
@pytest.mark.parametrize("stateless", [True, False])
def test_f_ials_rollout_freezes_only_a_stateless_aip(domain, stateless):
    tls = LS[domain][1]()
    cfg = influence.AIPConfig(kind="gru", d_in=tls.spec.dset_dim,
                              n_out=tls.spec.n_influence, hidden=HID)
    g = torch.Generator().manual_seed(0)
    env = engine.make_unified_ials(
        tls, influence.init_aip_stacked(cfg, g, 3), cfg, n_agents=3,
        fixed_marginal=0.2, stateless=stateless)
    st0 = env.reset(g, B)
    st0 = st0._replace(aip_state=torch.randn(st0.aip_state.shape,
                                             generator=g))
    acts = torch.randint(0, tls.spec.n_actions, (6, B, 3), generator=g)
    st, rews = env.rollout(st0, acts, horizon_noise(env.noise_fn, g, 6, B))
    assert rews.shape == (6, B, 3)
    assert torch.equal(st.aip_state, st0.aip_state) == stateless


def test_stateless_without_a_marginal_raises_the_reference_error():
    tls = LS["traffic"][1]()
    jls = LS["traffic"][0]()
    cfg, tcfg, jp = _aip("fnn", 1, jls, 0)
    with pytest.raises(ValueError) as jerr:
        jengine.make_unified_ials(jls, jp, cfg, stateless=True)
    with pytest.raises(ValueError) as terr:
        engine.make_unified_ials(tls, to_t(jp), tcfg, stateless=True)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kind,A", [("fnn", 1), ("gru", 1), ("gru", 3)])
def test_accuracy_matches_jax(kind, A):
    rng = np.random.default_rng(1)
    cfg, tcfg, jp = _aip(kind, A, LS["traffic"][0](), 2)
    lead = (A,) if A > 1 else ()
    d = rng.normal(size=lead + (5, 7, cfg.d_in)).astype(np.float32)
    u = (rng.random(lead + (5, 7, cfg.n_out)) < 0.3).astype(np.float32)
    if A > 1:
        want = float(jnp.mean(jax.vmap(
            lambda p, dd, uu: jinf.accuracy(p, cfg, dd, uu))(jp, d, u)))
    else:
        want = float(jinf.accuracy(jp, cfg, d, u))
    got = float(influence.accuracy(to_t(jp), tcfg, torch.from_numpy(d),
                                   torch.from_numpy(u)))
    assert got == pytest.approx(want, abs=1e-6)


TINY = ["--iterations", "2", "--eval-every", "1", "--collect-episodes", "4",
        "--aip-epochs", "1", "--n-envs", "4", "--rollout-len", "8",
        "--episode-len", "8", "--device", "cpu"]


@pytest.mark.parametrize("argv,kernel_route", [
    (["--simulator", "untrained-ials"], True),
    (["--simulator", "untrained-ials", "--aip", "gru", "--n-agents", "3"],
     True),
    (["--simulator", "untrained-ials", "--domain", "warehouse"], True),
    (["--simulator", "f-ials"], False),
    (["--simulator", "f-ials", "--aip", "gru", "--n-agents", "3"], False),
    (["--simulator", "f-ials", "--fixed-marginal", "0.1"], False),
    (["--simulator", "f-ials", "--domain", "warehouse", "--n-agents", "3",
      "--fixed-marginal", "0.1", "--stateless-f-ials"], False),
], ids=["untrained", "untrained-gru-3", "untrained-warehouse", "f-ials",
        "f-ials-gru-3", "f-ials-fixed", "f-ials-warehouse-stateless"])
def test_rl_train_runs_the_simulator_grid(argv, kernel_route, monkeypatch):
    calls = []
    orig = ref.policy_rollout_ref
    monkeypatch.setattr(ref, "policy_rollout_ref",
                        lambda *a, **kw: calls.append(kw["kind"])
                        or orig(*a, **kw))
    out = rl_train.run_training(rl_train.parse_args(TINY + argv))
    assert len(calls) == (2 if kernel_route else 0)
    for r in out["history"]:
        assert math.isfinite(r["loss"]) and math.isfinite(r["train_reward"])
        assert 0.0 <= r["gs_eval_reward"] <= 1.0
    assert out["diag"]["aip_xent"] > 0
    assert out["resumed_from"] == 0 and not out["preempted"]


def test_f_ials_xent_is_the_marginals():
    """``diag["aip_xent"]`` of ``--fixed-marginal 0.5`` is M log 2, the
    cross-entropy of a coin per source, whatever the data."""
    out = rl_train.run_training(rl_train.parse_args(
        TINY + ["--simulator", "f-ials", "--fixed-marginal", "0.5",
                "--iterations", "1"]))
    assert out["diag"]["aip_xent"] == pytest.approx(4 * math.log(2),
                                                    rel=1e-6)


def test_unknown_simulator_raises():
    gs, ls, _ = rl_train.build_domain("traffic", device="cpu")
    with pytest.raises(ValueError, match="unknown simulator"):
        rl_train.prepare_simulator("oracle", gs, ls, "fnn",
                                   collect_episodes=1, ep_len=1,
                                   aip_epochs=1, device="cpu")


def test_trained_aip_beats_untrained():
    """Fig. 3 bottom (``tests/test_system.py``'s claim) on the port's GS:
    the fitted AIP's cross-entropy is clearly below a random init's."""
    g = torch.Generator().manual_seed(0)
    gs = ttr.make_batched_traffic_env(device="cpu")
    data = collect.collect_dataset(gs, g, n_episodes=24, ep_len=48)
    cfg = influence.AIPConfig(kind="fnn", d_in=gs.spec.dset_dim,
                              n_out=gs.spec.n_influence, hidden=64, stack=8)
    aip, _ = influence.train_aip(cfg, data["d"], data["u"], g, epochs=8,
                                 batch_size=8)
    untrained = influence.init_aip(cfg, torch.Generator().manual_seed(99))
    with torch.no_grad():
        xe_tr = float(influence.xent_loss(aip, cfg, data["d"], data["u"]))
        xe_un = float(influence.xent_loss(untrained, cfg, data["d"],
                                          data["u"]))
        acc_tr = float(influence.accuracy(aip, cfg, data["d"], data["u"]))
    assert xe_tr < xe_un * 0.75
    assert acc_tr > 0.5


def test_build_simulator_trains_in_one_go():
    gs, ls, _ = rl_train.build_domain("traffic", device="cpu")
    env, diag = rl_train.build_simulator(
        "f-ials", gs, ls, "fnn", torch.Generator().manual_seed(0),
        collect_episodes=2, ep_len=4, aip_epochs=1, fixed_marginal=0.2)
    assert env.policy_rollout is None and diag["aip_xent"] > 0
    st = env.reset(torch.Generator().manual_seed(1), 2)
    assert tuple(st.aip_state.shape) == (2, 8, gs.spec.dset_dim)
