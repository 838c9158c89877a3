"""The port's scalar IALS (``repro_torch/core/ials.py``: ``make_ials``,
``make_multi_ials``; ``core/multi_ials.py``) and the engine's historical
entry points (``engine.make_batched_ials[_multi]``).

Against ``repro.core.ials`` on the same converted weights and states,
both backbones, both domains: the port's ``step_det`` is handed the
uniforms the reference's Bernoulli draws (``k_u, k_env = split(key)``;
``uniform(k_u, (M,))``; per agent ``split(key, A)``) and the LS noise of
``k_env``. Each tick ``u`` must equal the reference's wherever the uniform
sits at least ``FLIP_EPS`` from its threshold; then u is teacher-forced
(the port's next tick starts from the reference's draw), and the LS state
is compared exactly, the AIP state and ``u_probs`` within ``FWD_ATOL``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import FLIP_EPS, FWD_ATOL, assert_close, \
    assert_equal, to_np, to_t

import torch  # noqa: E402

from repro.core import ials as jials  # noqa: E402
from repro.core import influence as jinf  # noqa: E402
from repro.envs import traffic as jtr  # noqa: E402
from repro.envs import warehouse as jwh  # noqa: E402
from repro_torch.core import engine, ials, influence, multi_ials  # noqa
from repro_torch.envs import api  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402
from repro_torch.envs import warehouse as twh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

A = 3


def _ls(domain):
    """(JAX LS, port LS, LS noise of one tick from the LS's key)."""
    if domain == "traffic":
        return (jtr.make_local_traffic_env(),
                ttr.make_local_traffic_env(device="cpu"), lambda k: None)
    cfg = jwh.WarehouseConfig()
    return (jwh.make_local_warehouse_env(cfg),
            twh.make_local_warehouse_env(device="cpu"),
            lambda k: jax.random.bernoulli(jax.random.split(k)[1],
                                           cfg.p_item, (12,)))


def _cfgs(ls, kind):
    kw = dict(kind=kind, d_in=ls.spec.dset_dim, n_out=ls.spec.n_influence,
              hidden=16, stack=3 if kind == "fnn" else 1)
    return jinf.AIPConfig(**kw), influence.AIPConfig(**kw)


def _noise(key, ls_draws, M):
    k_u, k_env = jax.random.split(key)
    return jax.random.uniform(k_u, (M,)), ls_draws(k_env)


def _forced(u):
    """Uniforms that reproduce the draw ``u`` at any probability in
    (0, 1]: 0 below every p > 0, 1 below none."""
    return jnp.where(u > 0.5, 0.0, 1.0)


def _check_draw(t_info, j_info, uni):
    """u equal except where the uniform sits within FLIP_EPS of its
    threshold -> the number of flipped draws."""
    flipped = to_np(t_info["u"]) != np.asarray(j_info["u"])
    margin = np.abs(np.asarray(uni) - to_np(t_info["u_probs"]))
    assert not (flipped & (margin >= FLIP_EPS)).any()
    assert_close(t_info["u_probs"], j_info["u_probs"], FWD_ATOL)
    return int(flipped.sum())


def _compare(t_out, j_out):
    ts, to, tr, ti = t_out
    js, jo, jr, ji = j_out
    for t, j in zip(tree_leaves(ts.ls_state),
                    jax.tree_util.tree_leaves(js.ls_state)):
        assert_equal(t, j)
    assert_close(ts.aip_state, js.aip_state, FWD_ATOL)
    assert_equal(to, jo)
    assert_close(tr, jr, FWD_ATOL)
    assert_equal(ti["u"], ji["u"])


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_make_ials_matches_jax(domain, kind):
    jls, tls, draws = _ls(domain)
    jcfg, tcfg = _cfgs(jls, kind)
    M = jls.spec.n_influence
    jp = jinf.init_aip(jcfg, jax.random.PRNGKey(1))
    jenv = jials.make_ials(jls, jp, jcfg)
    tenv = ials.make_ials(tls, to_t(jp), tcfg)
    assert tenv.spec.name == jenv.spec.name
    key = jax.random.PRNGKey(2)
    js = jenv.reset(key)
    ts = to_t(js)
    assert isinstance(ts, engine.IALSState)
    for _ in range(8):
        key, k = jax.random.split(key)
        a = jax.random.randint(jax.random.fold_in(k, 7), (), 0,
                               jls.spec.n_actions)
        uni, env_nz = _noise(k, draws, M)
        j_out = jenv.step(js, a, k)
        t_free = tenv.step_det(ts, to_t(a), {"u": to_t(uni),
                                             "env": to_t(env_nz)})
        _check_draw(t_free[3], j_out[3], uni)
        t_out = tenv.step_det(ts, to_t(a), {"u": to_t(_forced(j_out[3]["u"])),
                                            "env": to_t(env_nz)})
        _compare(t_out, j_out)
        js, ts = j_out[0], t_out[0]


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_make_multi_ials_matches_jax(domain, kind):
    jls, tls, draws = _ls(domain)
    jcfg, tcfg = _cfgs(jls, kind)
    M = jls.spec.n_influence
    jps = jax.vmap(lambda k: jinf.init_aip(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(3), A))
    jenv = jials.make_multi_ials(jls, jps, jcfg, A)
    tenv = multi_ials.make_multi_ials(tls, to_t(jps), tcfg, A)
    key = jax.random.PRNGKey(4)
    js = jenv.reset(key)
    ts = to_t(js)
    assert isinstance(ts, ials.MultiIALSState)
    for _ in range(6):
        key, k = jax.random.split(key)
        a = jax.random.randint(jax.random.fold_in(k, 7), (A,), 0,
                               jls.spec.n_actions)
        per = [_noise(kk, draws, M) for kk in jax.random.split(k, A)]
        uni = jnp.stack([p[0] for p in per])
        env_nz = (None if per[0][1] is None
                  else jnp.stack([p[1] for p in per]))
        j_out = jenv.step(js, a, k)
        t_free = tenv.step_det(ts, to_t(a), {"u": to_t(uni),
                                             "env": to_t(env_nz)})
        _check_draw(t_free[3], j_out[3], uni)
        t_out = tenv.step_det(ts, to_t(a), {"u": to_t(_forced(j_out[3]["u"])),
                                            "env": to_t(env_nz)})
        _compare(t_out, j_out)
        js, ts = j_out[0], t_out[0]


@pytest.mark.parametrize("variant", ["scalar", "vector", "stateless"])
def test_f_ials_marginals_match_jax(variant):
    """F-IALS: u ~ Bernoulli(fixed marginal), the AIP ignored; the
    stateless variant keeps the state leaf at its init value."""
    jls, tls, draws = _ls("traffic")
    jcfg, tcfg = _cfgs(jls, "gru")
    vec = np.array([0.1, 0.5, 0.9, 0.3], np.float32)
    kw = ({"fixed_marginal": 0.3} if variant == "scalar"
          else {"fixed_marginal_vec": vec})
    if variant == "stateless":
        kw["stateless"] = True
    jp = jinf.init_aip(jcfg, jax.random.PRNGKey(5))
    jenv = jials.make_ials(jls, jp, jcfg, **kw)
    tenv = ials.make_ials(tls, to_t(jp), tcfg, **kw)
    key = jax.random.PRNGKey(6)
    js = jenv.reset(key)
    ts = to_t(js)
    for _ in range(6):
        key, k = jax.random.split(key)
        a = jax.random.randint(jax.random.fold_in(k, 7), (), 0, 2)
        uni, _ = _noise(k, draws, 4)
        j_out = jenv.step(js, a, k)
        t_out = tenv.step_det(ts, to_t(a), {"u": to_t(uni), "env": None})
        _compare(t_out, j_out)      # a fixed threshold: no flips
        assert_equal(t_out[3]["u_probs"], j_out[3]["u_probs"])
        js, ts = j_out[0], t_out[0]
    if variant == "stateless":
        assert ts.aip_state.shape == (16,)
        assert not ts.aip_state.any()
    else:
        assert ts.aip_state.any()
    with pytest.raises(ValueError, match="stateless"):
        ials.make_ials(tls, to_t(jp), tcfg, stateless=True)


@pytest.mark.parametrize("shape", ["shared", "per-agent"])
def test_multi_f_ials_vector_marginals(shape):
    jls, tls, draws = _ls("warehouse")
    jcfg, tcfg = _cfgs(jls, "gru")
    rng = np.random.default_rng(0)
    vec = rng.random((12,) if shape == "shared" else (A, 12)).astype(
        np.float32)
    jps = jax.vmap(lambda k: jinf.init_aip(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(7), A))
    jenv = jials.make_multi_ials(jls, jps, jcfg, A, fixed_marginal_vec=vec,
                                 stateless=True)
    tenv = ials.make_multi_ials(tls, to_t(jps), tcfg, A,
                                fixed_marginal_vec=vec, stateless=True)
    key = jax.random.PRNGKey(8)
    js = jenv.reset(key)
    ts = to_t(js)
    for _ in range(4):
        key, k = jax.random.split(key)
        a = jax.random.randint(jax.random.fold_in(k, 7), (A,), 0, 5)
        per = [_noise(kk, draws, 12) for kk in jax.random.split(k, A)]
        j_out = jenv.step(js, a, k)
        t_out = tenv.step_det(ts, to_t(a), {
            "u": to_t(jnp.stack([p[0] for p in per])),
            "env": to_t(jnp.stack([p[1] for p in per]))})
        _compare(t_out, j_out)
        assert_equal(t_out[3]["u_probs"], j_out[3]["u_probs"])
        js, ts = j_out[0], t_out[0]
    assert ts.aip_state.shape == (A, 16) and not ts.aip_state.any()


@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_multi_ials_agent_i_matches_single_ials(kind):
    """Agent i of the multi-agent construction is a single IALS built from
    the same AIP, stepped with the same noise."""
    tls = ttr.make_local_traffic_env(device="cpu")
    _, tcfg = _cfgs(tls, kind)
    g = torch.Generator()
    g.manual_seed(9)
    params = influence.init_aip_stacked(tcfg, g, A)
    env = ials.make_multi_ials(tls, params, tcfg, A)
    s = env.reset(g)
    s, _, _, _ = env.step(s, torch.tensor([1, 0, 1]), g)  # h off zero
    acts = torch.tensor([0, 1, 1])
    nz = env.noise_fn(g)
    s2, obs, r, info = env.step_det(s, acts, nz)
    for i in range(A):
        single = ials.make_ials(tls, tree_map(lambda l: l[i], params), tcfg)
        s_i = engine.IALSState(
            ls_state=tree_map(lambda l: l[i], s.ls_state),
            aip_state=s.aip_state[i])
        s2_i, obs_i, r_i, info_i = single.step_det(
            s_i, acts[i], {"u": nz["u"][i], "env": None})
        assert torch.equal(obs_i, obs[i]) and torch.equal(r_i, r[i])
        assert torch.equal(info_i["u"], info["u"][i])
        assert torch.allclose(s2_i.aip_state, s2.aip_state[i], atol=1e-6)


def test_scalar_ials_lifts_to_the_batched_protocol():
    """``batch_env`` over the multi-agent scalar IALS: (B, A, ...) leaves,
    and lane b equals the scalar env stepped alone."""
    tls = twh.make_local_warehouse_env(device="cpu")
    _, tcfg = _cfgs(tls, "gru")
    g = torch.Generator()
    g.manual_seed(10)
    env = ials.make_multi_ials(tls, influence.init_aip_stacked(tcfg, g, A),
                               tcfg, A)
    benv = api.batch_env(env)
    B = 4
    st = benv.reset(g, B)
    assert st.aip_state.shape == (B, A, 16)
    assert st.ls_state.pos.shape == (B, A, 2)
    acts = torch.randint(0, 5, (B, A), generator=g)
    nz = benv.noise_fn(g, B)
    s2, obs, r, info = benv.step_det(st, acts, nz)
    assert obs.shape == (B, A, 37) and r.shape == (B, A)
    assert info["u_probs"].shape == (B, A, 12)
    for b in (0, 3):
        one = env.step_det(tree_map(lambda l: l[b], st), acts[b],
                           tree_map(lambda l: l[b], nz))
        assert torch.equal(one[1], obs[b]) and torch.equal(one[2], r[b])
        assert torch.allclose(one[0].aip_state, s2.aip_state[b], atol=1e-6)


@pytest.mark.parametrize("multi", [False, True])
def test_make_batched_ials_equals_make_unified_ials(multi):
    ls = ttr.make_batched_local_traffic_env(device="cpu")
    _, tcfg = _cfgs(ls, "gru")
    g = torch.Generator()
    g.manual_seed(11)
    if multi:
        p = influence.init_aip_stacked(tcfg, g, A)
        old = engine.make_batched_multi_ials(ls, p, tcfg, A)
        shim = multi_ials.make_batched_multi_ials(ls, p, tcfg, A)
        new = engine.make_unified_ials(ls, p, tcfg, n_agents=A)
        a_shape = (5, A)
    else:
        p = influence.init_aip(tcfg, g)
        old = ials.make_batched_ials(ls, p, tcfg)
        shim = old
        new = engine.make_unified_ials(ls, p, tcfg)
        a_shape = (5,)
    assert old.spec == new.spec == shim.spec
    st = new.reset(g, 5)
    acts = torch.randint(0, 2, a_shape, generator=g)
    nz = new.noise_fn(g, 5)
    for env in (old, shim):
        for x, y in zip(tree_leaves(env.step_det(st, acts, nz)),
                        tree_leaves(new.step_det(st, acts, nz))):
            assert torch.equal(x, y)
