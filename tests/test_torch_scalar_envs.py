"""The port's scalar protocol (``repro_torch/envs/api.py``: ``Env``,
``LocalEnv``, ``batch_env``, ``batch_local_env``, ``as_batched``,
``unbatch_env``, ``env_rollout``, ``squeeze_agent_env``) and its scalar
envs (``make_multi_traffic_env``, ``make_traffic_env``,
``make_local_traffic_env``, ``make_multi_warehouse_env``,
``make_warehouse_env``, ``make_local_warehouse_env``).

Against the JAX package: each env's reset specs, dtypes and shapes, and
its step from the same converted state with the draws the reference's own
key splits make (GS inflow ``key, kin = split(key)``; warehouse spawns
``key, kh, kv = split(key, 3)``; LS spawns ``key, ks = split(key)``).
Integer and bool leaves exactly, floats within ``FWD_ATOL``. Against the
port itself: the LS replays a GS rollout exactly (the 8-bit traffic
``u_t``; the warehouse without spawns), the vmap adapters equal the
native batched envs on the same state, actions, u and noise, and
``env_rollout``'s three routes agree on the same noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import FWD_ATOL, assert_close, assert_equal, to_np, \
    to_t

import torch  # noqa: E402

from repro.envs import traffic as jtr  # noqa: E402
from repro.envs import warehouse as jwh  # noqa: E402
from repro_torch.core import engine, influence  # noqa: E402
from repro_torch.envs import api  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402
from repro_torch.envs import warehouse as twh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

AGENTS4 = [[0, 0], [1, 3], [2, 2], [4, 1]]
ALL25 = [[i, j] for i in range(5) for j in range(5)]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# (JAX env, port env, draws of one tick from the key the JAX step takes)
def _traffic_gs(agents, ext=False):
    cfg = dict(ext_influence=ext)
    jcfg = jtr.TrafficConfig(**cfg)
    if agents is None:
        j, t = (jtr.make_traffic_env(jcfg),
                ttr.make_traffic_env(ttr.TrafficConfig(**cfg), "cpu"))
    else:
        j = jtr.make_multi_traffic_env(jcfg, jnp.array(agents))
        t = ttr.make_multi_traffic_env(ttr.TrafficConfig(**cfg), agents,
                                       "cpu")

    def draws(key):
        kin = jax.random.split(key)[1]
        return jax.random.bernoulli(kin, jcfg.p_in, (5, 5, 4))
    return j, t, draws


def _warehouse_gs(agents, vanish=0, p_item=0.02):
    cfg = dict(vanish_after=vanish, p_item=p_item)
    jcfg = jwh.WarehouseConfig(**cfg)
    if agents is None:
        j, t = (jwh.make_warehouse_env(jcfg),
                twh.make_warehouse_env(twh.WarehouseConfig(**cfg), "cpu"))
    else:
        j = jwh.make_multi_warehouse_env(jcfg, jnp.array(agents))
        t = twh.make_multi_warehouse_env(twh.WarehouseConfig(**cfg), agents,
                                         "cpu")

    def draws(key):
        _, kh, kv = jax.random.split(key, 3)
        return {"spawn_h": jax.random.bernoulli(kh, jcfg.p_item, (7, 6, 3)),
                "spawn_v": jax.random.bernoulli(kv, jcfg.p_item, (6, 7, 3))}
    return j, t, draws


GS_CASES = {
    "traffic-25": lambda: _traffic_gs(ALL25),
    "traffic-4-ext": lambda: _traffic_gs(AGENTS4, ext=True),
    "traffic-single": lambda: _traffic_gs(None),
    "warehouse-4": lambda: _warehouse_gs(AGENTS4),
    "warehouse-4-vanish8": lambda: _warehouse_gs(AGENTS4, vanish=8),
    "warehouse-single": lambda: _warehouse_gs(None),
}


def _traffic_ls(ext):
    return (jtr.make_local_traffic_env(jtr.TrafficConfig(ext_influence=ext)),
            ttr.make_local_traffic_env(ttr.TrafficConfig(ext_influence=ext),
                                       "cpu"),
            lambda key: None)


def _warehouse_ls(vanish):
    jcfg = jwh.WarehouseConfig(vanish_after=vanish)

    def draws(key):
        ks = jax.random.split(key)[1]
        return jax.random.bernoulli(ks, jcfg.p_item, (12,))
    return (jwh.make_local_warehouse_env(jcfg),
            twh.make_local_warehouse_env(twh.WarehouseConfig(
                vanish_after=vanish), "cpu"), draws)


LS_CASES = {
    "traffic": lambda: _traffic_ls(False),
    "traffic-ext": lambda: _traffic_ls(True),
    "warehouse": lambda: _warehouse_ls(0),
    "warehouse-vanish8": lambda: _warehouse_ls(8),
}


def _same_specs(jenv, tenv):
    for f in ("name", "obs_dim", "n_actions", "n_influence", "dset_dim",
              "dset_full_dim", "n_agents"):
        assert getattr(tenv.spec, f) == getattr(jenv.spec, f), f


def _same_layout(tstate, jstate, lead=()):
    jl = jax.tree_util.tree_leaves(jstate)
    tl = tree_leaves(tstate)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == lead + tuple(np.shape(j))
        assert to_np(t).dtype == np.asarray(j).dtype


@pytest.mark.parametrize("case", list(GS_CASES) + list(LS_CASES))
def test_reset_specs_dtypes_and_shapes(case):
    jenv, tenv, _ = (GS_CASES.get(case) or LS_CASES[case])()
    _same_specs(jenv, tenv)
    js = jenv.reset(jax.random.PRNGKey(0))
    _same_layout(tenv.reset(_gen(0)), js)
    _same_layout(tenv.reset(_gen(0), (3,)), js, (3,))
    assert tuple(tenv.observe(tenv.reset(_gen(1))).shape) == tuple(
        np.shape(jenv.observe(js)))


def _check_step(out_t, out_j, exact_reward=False):
    ts, to, tr, ti = out_t
    js, jo, jr, ji = out_j
    for t, j in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        assert_equal(t, j)
    assert_equal(to, jo)
    if exact_reward:
        assert_equal(tr, jr)
    else:
        assert_close(tr, jr, FWD_ATOL)
    assert set(ti) == set(ji)
    for k in ji:
        assert_equal(ti[k], ji[k])


@pytest.mark.parametrize("case", list(GS_CASES))
def test_gs_step_matches_jax(case):
    """Twelve ticks of the scalar GS from the same state on both sides,
    the port given the draws the reference's key splits make."""
    jenv, tenv, draws = GS_CASES[case]()
    key = jax.random.PRNGKey(3)
    js = jenv.reset(key)
    ts = to_t(js)
    a_shape = () if case.endswith("single") else (jenv.spec.n_agents,)
    for _ in range(12):
        key, k = jax.random.split(key)
        a = jax.random.randint(jax.random.fold_in(k, 1), a_shape, 0,
                               jenv.spec.n_actions)
        out_j = jenv.step(js, a, k)
        out_t = tenv.step_det(ts, to_t(a), to_t(draws(k)))
        _check_step(out_t, out_j, exact_reward=case.startswith("warehouse"))
        js, ts = out_j[0], out_t[0]


@pytest.mark.parametrize("case", list(LS_CASES))
def test_ls_step_matches_jax(case):
    jenv, tenv, draws = LS_CASES[case]()
    M = jenv.spec.n_influence
    key = jax.random.PRNGKey(4)
    js = jenv.reset(key)
    ts = to_t(js)
    for _ in range(12):
        key, k = jax.random.split(key)
        a = jax.random.randint(jax.random.fold_in(k, 1), (), 0,
                               jenv.spec.n_actions)
        u = jax.random.bernoulli(jax.random.fold_in(k, 2), 0.3,
                                 (M,)).astype(jnp.float32)
        out_j = jenv.step(js, a, u, k)
        out_t = tenv.step_det(ts, to_t(a), to_t(u), to_t(draws(k)))
        _check_step(out_t, out_j, exact_reward=case.startswith("warehouse"))
        assert_equal(tenv.dset_fn(ts, to_t(a)), jenv.dset_fn(js, a))
        js, ts = out_j[0], out_t[0]


# ---------------------------------------------------------------------------
# the LS replays a GS rollout exactly (mirrors tests/test_multi_ials.py)
# ---------------------------------------------------------------------------

def _gs_rollout(gs, T, seed):
    g = _gen(seed)
    s0 = gs.reset(g)
    A = gs.spec.n_agents
    acts = torch.randint(0, gs.spec.n_actions, (T, A) if A > 1 else (T,),
                         generator=g)
    s, rows = s0, []
    for t in range(T):
        s, obs, r, info = gs.step(s, acts[t], g)
        rows.append((obs, r, info["u"]))
    return s0, acts, [torch.stack(x) for x in zip(*rows)]


def _ls_replay(ls, s, acts, us):
    rows = []
    for t in range(acts.shape[0]):
        s, obs, r, _ = ls.step(s, acts[t], us[t], _gen(0))
        rows.append((obs, r))
    return [torch.stack(x) for x in zip(*rows)]


@pytest.mark.parametrize("case", ["traffic-single-ext", "traffic-4-ext",
                                  "warehouse-4"])
def test_ls_replays_a_gs_rollout_exactly(case):
    """With the 8-bit traffic u_t (and the warehouse without spawns, its
    only noise apart from u_t), replaying a GS rollout's true influence
    sources through the LS reproduces every agent's observations and
    rewards exactly."""
    if case.startswith("traffic"):
        cfg = ttr.TrafficConfig(ext_influence=True)
        gs = (ttr.make_traffic_env(cfg, "cpu") if "single" in case
              else ttr.make_multi_traffic_env(cfg, AGENTS4, "cpu"))
        ls = ttr.make_local_traffic_env(cfg, "cpu")
        view, T = ttr.local_traffic_state, 24
    else:
        cfg = twh.WarehouseConfig(p_item=0.0)
        gs = twh.make_multi_warehouse_env(cfg, AGENTS4, "cpu")
        ls = twh.make_local_warehouse_env(cfg, "cpu")
        view, T = twh.local_warehouse_state, 16
    s0, acts, (obs, rew, us) = _gs_rollout(gs, T, 5)
    agents = [tuple(cfg.agent)] if "single" in case else AGENTS4
    for n, (i, j) in enumerate(agents):
        pick = (lambda x: x) if "single" in case else (lambda x: x[:, n])
        r_obs, r_rew = _ls_replay(ls, view(s0, i, j), pick(acts), pick(us))
        assert torch.equal(r_obs, pick(obs))
        assert torch.allclose(r_rew, pick(rew), atol=1e-6)


# ---------------------------------------------------------------------------
# the vmap adapters against the native batched envs
# ---------------------------------------------------------------------------

def _equal_trees(a, b, atol=FWD_ATOL):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype.is_floating_point:
            assert torch.allclose(x, y, atol=atol, rtol=0)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["traffic", "warehouse", "warehouse-8"])
def test_batch_env_matches_native_batched_gs(case):
    B, T = 5, 10
    if case == "traffic":
        cfg = ttr.TrafficConfig(ext_influence=True)
        lifted = api.batch_env(ttr.make_multi_traffic_env(cfg, AGENTS4,
                                                          "cpu"))
        native = ttr.make_batched_multi_traffic_env(cfg, AGENTS4, "cpu")
    else:
        cfg = twh.WarehouseConfig(vanish_after=8 if "8" in case else 0,
                                  p_item=0.2)
        lifted = api.batch_env(twh.make_multi_warehouse_env(cfg, AGENTS4,
                                                            "cpu"))
        native = twh.make_batched_multi_warehouse_env(cfg, AGENTS4, "cpu")
    g = _gen(6)
    st = native.reset(g, B)
    _equal_trees(lifted.observe(st), native.observe(st))
    for _ in range(T):
        a = torch.randint(0, native.spec.n_actions, (B, 4), generator=g)
        nz = native.noise_fn(g, B)
        out_n = native.step_det(st, a, nz)
        out_l = lifted.step_det(st, a, nz)
        _equal_trees(out_l, out_n)
        st = out_n[0]


@pytest.mark.parametrize("case", ["traffic", "traffic-ext", "warehouse",
                                  "warehouse-8"])
def test_batch_local_env_matches_native_batched_ls(case):
    B, T = 7, 10
    if case.startswith("traffic"):
        cfg = ttr.TrafficConfig(ext_influence=case.endswith("ext"))
        lifted = api.batch_local_env(ttr.make_local_traffic_env(cfg, "cpu"))
        native = ttr.make_batched_local_traffic_env(cfg, "cpu")
    else:
        cfg = twh.WarehouseConfig(vanish_after=8 if "8" in case else 0,
                                  p_item=0.2)
        lifted = api.batch_local_env(twh.make_local_warehouse_env(cfg,
                                                                  "cpu"))
        native = twh.make_batched_local_warehouse_env(cfg, "cpu")
    M = native.spec.n_influence
    g = _gen(7)
    st = native.reset(g, B)
    for _ in range(T):
        a = torch.randint(0, native.spec.n_actions, (B,), generator=g)
        u = (torch.rand((B, M), generator=g) < 0.3).float()
        nz = native.noise_fn(g, B)
        _equal_trees(lifted.dset_fn(st, a), native.dset_fn(st, a))
        out_n = native.step_det(st, a, u, nz)
        out_l = lifted.step_det(st, a, u, nz)
        _equal_trees(out_l, out_n)
        st = out_n[0]
    # reset and noise_fn draw by the native envs' shapes and dtypes
    _same_layout(lifted.reset(_gen(1), 3), tree_map(lambda l: l.numpy(),
                                                    native.reset(_gen(1),
                                                                 3)))


def test_as_batched_identity_and_lift():
    env = ttr.make_traffic_env(device="cpu")
    benv = api.batch_env(env)
    assert api.as_batched(benv) is benv
    lifted = api.as_batched(env)
    assert isinstance(lifted, api.BatchedEnv)
    assert lifted.noise_fn is not None and lifted.step_det is not None
    with pytest.raises(ValueError, match="noise_fn"):
        api.batch_env(env._replace(step_det=None))


def test_squeeze_agent_env_takes_either_protocol():
    """The scalar squeeze of a 1-agent scalar GS equals the batched
    squeeze of the 1-agent batched GS, lane by lane."""
    cfg = ttr.TrafficConfig()
    scalar = api.squeeze_agent_env(
        ttr.make_multi_traffic_env(cfg, [cfg.agent], "cpu"), "s")
    batched = api.squeeze_agent_env(
        ttr.make_batched_multi_traffic_env(cfg, [cfg.agent], "cpu"), "b")
    assert isinstance(scalar, api.Env)
    assert isinstance(batched, api.BatchedEnv)
    g = _gen(8)
    st = batched.reset(g, 3)
    a = torch.tensor([0, 1, 1])
    nz = batched.noise_fn(g, 3)
    out_b = batched.step_det(st, a, nz)
    for n in range(3):
        out_s = scalar.step_det(tree_map(lambda l: l[n], st), a[n],
                                nz[n])
        _equal_trees(out_s, tree_map(lambda l: l[n], out_b))


def test_unbatch_env_round_trip():
    """``unbatch_env`` of the native single-agent GS: one env of it equals
    the native env at B = 1, and lifting it back by ``batch_env`` equals
    the native env at B = 3 (each lifted env keeping its axis of 1)."""
    native = ttr.make_batched_traffic_env(device="cpu")
    scalar = api.unbatch_env(native, name="traffic-rt")
    assert scalar.spec.name == "traffic-rt"
    g = _gen(9)
    st = scalar.reset(g)
    assert st.lanes.shape == (1, 5, 5, 4, 10)
    nz = scalar.noise_fn(_gen(10))
    out_s = scalar.step_det(st, torch.tensor(1), nz)
    out_n = native.step_det(st, torch.tensor([1]), nz)
    _equal_trees(out_s[0], out_n[0])
    _equal_trees(out_s[1:3], (out_n[1][0], out_n[2][0]))
    assert out_s[1].shape == (41,) and scalar.observe(st).shape == (41,)
    # step draws what noise_fn draws
    _equal_trees(scalar.step(st, torch.tensor(1), _gen(10)), out_s)
    relifted = api.batch_env(scalar)
    stb = relifted.reset(_gen(11), 3)
    a = torch.tensor([0, 1, 0])
    nzb = relifted.noise_fn(_gen(12), 3)
    flat = tree_map(lambda l: l[:, 0], stb)
    out_r = relifted.step_det(stb, a, nzb)
    out_n = native.step_det(flat, a, tree_map(lambda l: l[:, 0], nzb))
    _equal_trees(tree_map(lambda l: l[:, 0], out_r[0]), out_n[0])
    _equal_trees(out_r[1:3], out_n[1:3])


# ---------------------------------------------------------------------------
# env_rollout's three routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_env_rollout_routes_agree_on_the_same_noise(kind):
    """The engine's native rollout (the plain version of its kernel on the
    CPU), a loop of ``step_det`` on the pre-drawn noise and a loop of
    ``step`` on a generator reseeded to draw that noise give the same
    final state and rewards."""
    B, T = 6, 8
    ls = ttr.make_batched_local_traffic_env(device="cpu")
    acfg = influence.AIPConfig(kind=kind, d_in=40, n_out=4, hidden=16,
                               stack=3 if kind == "fnn" else 1)
    env = engine.make_batched_ials(ls, influence.init_aip(acfg, _gen(13)),
                                   acfg)
    st = env.reset(_gen(14), B)
    acts = torch.randint(0, 2, (T, B), generator=_gen(15))
    noise = api.horizon_noise(env.noise_fn, _gen(16), T, B)
    s1, r1 = api.env_rollout(env, st, acts, noise)
    no_native = env._replace(rollout=None)
    s2, r2 = api.env_rollout(no_native, st, acts, noise)
    s3, r3 = api.env_rollout(no_native._replace(step_det=None,
                                                noise_fn=None),
                             st, acts, generator=_gen(16))
    # the same draws without handing them over: drawn in bulk
    s4, r4 = api.env_rollout(no_native, st, acts, generator=_gen(16))
    for s, r in ((s2, r2), (s3, r3), (s4, r4)):
        _equal_trees(s.ls_state, s1.ls_state)
        assert torch.allclose(s.aip_state, s1.aip_state, atol=FWD_ATOL)
        assert torch.allclose(r, r1, atol=FWD_ATOL)


def test_env_rollout_on_a_lifted_scalar_gs():
    """The vmap-lifted scalar GS has no native rollout: its step_det loop
    and its step loop agree on the same generator seed."""
    env = api.as_batched(ttr.make_multi_traffic_env(ttr.TrafficConfig(),
                                                    AGENTS4, "cpu"))
    assert env.rollout is None
    st = env.reset(_gen(17), 3)
    acts = torch.randint(0, 2, (6, 3, 4), generator=_gen(18))
    s1, r1 = api.env_rollout(env, st, acts, generator=_gen(19))
    s2, r2 = api.env_rollout(env._replace(noise_fn=None), st, acts,
                             generator=_gen(19))
    assert r1.shape == (6, 3, 4)
    _equal_trees((s1, r1), (s2, r2), atol=0.0)
