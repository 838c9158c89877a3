"""The port's traffic simulators (``repro_torch/envs/traffic.py``)
against ``repro.envs.traffic`` on the same states, actions, u_t and
inflow draws: every leaf exactly (the dynamics are integer algebra, the
rewards one correctly rounded division)."""
import numpy as np
import pytest

from test_torch_common import assert_equal, to_np, to_t

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.envs import traffic as jtr  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402


def _ls_inputs(seed, B, L, M):
    rng = np.random.default_rng(seed)
    lanes = rng.random((B, 4, L)) < 0.45
    phase = rng.integers(0, 2, B).astype(np.int8)
    a = rng.integers(0, 2, B).astype(np.int32)
    u = (rng.random((B, M)) < 0.4).astype(np.float32)
    return (jtr.LocalTrafficState(lanes=jnp.asarray(lanes),
                                  phase=jnp.asarray(phase)), a, u)


@pytest.mark.parametrize("ext", [False, True])
def test_local_env_functions_match(ext):
    cfg = jtr.TrafficConfig(ext_influence=ext)
    jls = jtr.make_batched_local_traffic_env(cfg)
    tls = ttr.make_batched_local_traffic_env(ttr.TrafficConfig(
        ext_influence=ext), device="cpu")
    M = jls.spec.n_influence
    st, a, u = _ls_inputs(0, 64, cfg.lane_len, M)
    tst = to_t(st)
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    js, jr = jls.rollout_tick(st, jnp.asarray(a), jnp.asarray(u), None)
    ts, tr = tls.rollout_tick(tst, ta, tu, None)
    assert_equal(ts.lanes, js.lanes)
    assert_equal(ts.phase, js.phase)
    assert_equal(tr, jr)
    assert_equal(tls.dset_fn(tst, ta), jls.dset_fn(st, jnp.asarray(a)))
    assert_equal(tls.obs_fn(tst), jls.obs_fn(st))
    js2, jo, jr2, ji = jls.step_det(st, jnp.asarray(a), jnp.asarray(u), None)
    ts2, to, tr2, ti = tls.step_det(tst, ta, tu, None)
    assert_equal(ts2.lanes, js2.lanes)
    assert_equal(to, jo)
    assert_equal(tr2, jr2)
    for k in ("dset", "dset_full", "n_cars"):
        assert_equal(ti[k], ji[k])


@pytest.mark.parametrize("agents", [[(2, 2)], [(0, 0), (2, 3), (4, 4)]])
def test_global_env_step_matches_given_jax_inflow(agents):
    """Five chained GS ticks; each tick's boundary inflow is the draw the
    JAX GS made from its key (``noise_fn``), handed to both."""
    cfg = jtr.TrafficConfig()
    jgs = jtr.make_batched_multi_traffic_env(cfg, jnp.asarray(agents))
    tgs = ttr.make_batched_multi_traffic_env(ttr.TrafficConfig(), agents,
                                             device="cpu")
    B, A = 6, len(agents)
    key = jax.random.PRNGKey(3)
    jst = jgs.reset(key, B)
    tst = to_t(jst)
    rng = np.random.default_rng(2)
    for t in range(5):
        a = rng.integers(0, 2, (B, A)).astype(np.int32)
        inflow = jgs.noise_fn(jax.random.fold_in(key, t), B)
        jst, jo, jr, ji = jgs.step_det(jst, jnp.asarray(a), inflow)
        tst, to, tr, ti = tgs.step_det(tst, torch.from_numpy(a),
                                       to_t(inflow))
        for f in ("lanes", "phase", "timer"):
            assert_equal(getattr(tst, f), getattr(jst, f))
        assert_equal(to, jo)
        assert_equal(tr, jr)
        for k in ("u", "dset", "dset_full", "n_cars"):
            assert_equal(ti[k], ji[k])
    assert_equal(tgs.observe(tst), jgs.observe(jst))


def test_ext_influence_local_replay_of_a_gs_rollout_is_exact():
    """With the 8-bit u_t, the LS fed the GS's own u_t reproduces the
    agent's observations and rewards exactly (a reference fact)."""
    cfg = ttr.TrafficConfig(ext_influence=True)
    gs = ttr.make_batched_traffic_env(cfg, device="cpu")
    ls = ttr.make_batched_local_traffic_env(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    B = 8
    st = gs.reset(g, B)
    i, j = cfg.agent
    lst = ttr.LocalTrafficState(lanes=st.lanes[:, i, j].clone(),
                                phase=st.phase[:, i, j].clone())
    for _ in range(30):
        a = torch.randint(0, 2, (B,), generator=g)
        st, obs, r, info = gs.step(st, a, g)
        lst, lobs, lr, _ = ls.step_det(lst, a, info["u"], None)
        np.testing.assert_array_equal(to_np(lobs), to_np(obs))
        np.testing.assert_array_equal(to_np(lr), to_np(r))


def test_single_agent_gs_squeezes_the_agent_axis():
    gs = ttr.make_batched_traffic_env(device="cpu")
    g = torch.Generator().manual_seed(1)
    st = gs.reset(g, 3)
    assert gs.observe(st).shape == (3, 41)
    _, obs, r, info = gs.step(st, torch.zeros(3, dtype=torch.long), g)
    assert obs.shape == (3, 41) and r.shape == (3,)
    assert info["u"].shape == (3, 4) and info["dset"].shape == (3, 40)


def test_collect_helpers_match():
    """``per_agent`` and ``empirical_marginal`` against the JAX package on
    the same collection, and ``collect_dataset``'s layout on the port's
    multi-agent GS."""
    from repro.core import collect as jcol
    from repro_torch.core import collect as tcol
    rng = np.random.default_rng(4)
    data = {"d": rng.random((5, 7, 3, 40)).astype(np.float32),
            "u": (rng.random((5, 7, 3, 4)) < 0.2).astype(np.float32)}
    jp = jcol.per_agent({k: jnp.asarray(v) for k, v in data.items()})
    tp = tcol.per_agent({k: torch.from_numpy(v) for k, v in data.items()})
    for k in data:
        assert_equal(tp[k], jp[k])
    np.testing.assert_allclose(
        to_np(tcol.empirical_marginal(tp["u"], per_agent=True)),
        np.asarray(jcol.empirical_marginal(jp["u"], per_agent=True)),
        atol=1e-7)
    gs = ttr.make_batched_multi_traffic_env(ttr.TrafficConfig(),
                                            [(0, 0), (1, 1)], device="cpu")
    out = tcol.collect_dataset(gs, torch.Generator().manual_seed(0),
                               n_episodes=3, ep_len=6)
    assert out["d"].shape == (3, 6, 2, 40) and out["u"].shape == (3, 6, 2, 4)
    assert out["reward"].shape == (3, 6, 2)
