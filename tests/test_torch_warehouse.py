"""The port's warehouse simulators (``repro_torch/envs/warehouse.py``)
against ``repro.envs.warehouse`` on the same states, actions, u_t and
spawn draws, at ``vanish_after`` 0 and 8: every leaf exactly (the
dynamics are integer algebra, the rewards counts). Also the reference's
env invariants, the scripted robots' tie rule, the GS replayed through
the LS, and a JAX warehouse policy and GRU AIP carried across by
``convert.py`` computing the same policy rollout in both packages."""
import numpy as np
import pytest

from test_torch_common import (assert_equal, assert_lanes_match, jax_ls_fns,
                               to_np, to_t)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.envs import warehouse as jwh  # noqa: E402
from repro_torch.envs import warehouse as twh  # noqa: E402

AGENTS = {"one": [(2, 2)], "four": [(0, 0), (1, 3), (4, 5), (5, 5)],
          "all": [(i, j) for i in range(6) for j in range(6)]}


def _cfgs(vanish):
    return (jwh.WarehouseConfig(vanish_after=vanish),
            twh.WarehouseConfig(vanish_after=vanish))


def _ls_inputs(seed, B, vanish):
    """Local states with ages spread over [0, 64] (and bunched at the
    vanish limit), every action, random u and spawns."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 5, (B, 2)).astype(np.int32)
    items = rng.integers(0, 65, (B, 12)).astype(np.int32)
    items[rng.random((B, 12)) < 0.4] = 0
    if vanish:
        near = rng.random((B, 12)) < 0.3
        items[near] = rng.integers(vanish - 1, vanish + 2, near.sum())
    a = rng.integers(0, 5, B).astype(np.int32)
    u = (rng.random((B, 12)) < 0.3).astype(np.float32)
    spawn = rng.random((B, 12)) < 0.3
    return jwh.LocalWarehouseState(pos=jnp.asarray(pos),
                                   items=jnp.asarray(items)), a, u, spawn


@pytest.mark.parametrize("vanish", [0, 8])
def test_local_env_functions_match(vanish):
    jcfg, tcfg = _cfgs(vanish)
    jls = jwh.make_batched_local_warehouse_env(jcfg)
    tls = twh.make_batched_local_warehouse_env(tcfg, device="cpu")
    for f in ("obs_dim", "n_actions", "n_influence", "dset_dim",
              "dset_full_dim"):
        assert getattr(tls.spec, f) == getattr(jls.spec, f)
    st, a, u, spawn = _ls_inputs(vanish, 256, vanish)
    tst = to_t(st)
    assert isinstance(tst, twh.LocalWarehouseState)
    ta, tu, tsp = (torch.from_numpy(a), torch.from_numpy(u),
                   torch.from_numpy(spawn))
    js, jr = jls.rollout_tick(st, jnp.asarray(a), jnp.asarray(u),
                              jnp.asarray(spawn))
    ts, tr = tls.rollout_tick(tst, ta, tu, tsp)
    assert_equal(ts.pos, js.pos)
    assert_equal(ts.items, js.items)
    assert ts.items.dtype == torch.int32 and ts.pos.dtype == torch.int32
    assert_equal(tr, jr)
    assert_equal(tls.dset_fn(tst, ta), jls.dset_fn(st, jnp.asarray(a)))
    assert_equal(tls.obs_fn(tst), jls.obs_fn(st))
    assert_equal(tls.observe(tst), jls.observe(st))
    js2, jo, jr2, ji = jls.step_det(st, jnp.asarray(a), jnp.asarray(u),
                                    jnp.asarray(spawn))
    ts2, to, tr2, ti = tls.step_det(tst, ta, tu, tsp)
    assert_equal(ts2.items, js2.items)
    assert_equal(to, jo)
    assert_equal(tr2, jr2)
    for k in ("dset", "dset_full", "ages"):
        assert_equal(ti[k], ji[k])
    assert tls.kernel_domain == ("warehouse", 0, False, 5, 64, vanish)


@pytest.mark.parametrize("agents,vanish", [("one", 0), ("four", 0),
                                           ("all", 0), ("four", 8)])
def test_global_env_step_matches_given_jax_spawns(agents, vanish):
    """Six chained GS ticks from the JAX reset; each tick's spawns are
    the draws the JAX GS made from its key (``noise_fn``), handed to
    both. The reset's items all have age 1, so the scripted robots' argmax
    meets ties from the first tick."""
    jcfg, tcfg = _cfgs(vanish)
    ag = AGENTS[agents]
    jgs = jwh.make_batched_multi_warehouse_env(jcfg, jnp.asarray(ag))
    tgs = twh.make_batched_multi_warehouse_env(tcfg, ag, device="cpu")
    assert tgs.spec.n_agents == len(ag) and tgs.spec.obs_dim == 37
    B, A = 5, len(ag)
    key = jax.random.PRNGKey(7 + vanish)
    jst = jgs.reset(key, B)
    tst = to_t(jst)
    assert isinstance(tst, twh.WarehouseState)
    rng = np.random.default_rng(3)
    for t in range(6):
        a = rng.integers(0, 5, (B, A)).astype(np.int32)
        spawns = jgs.noise_fn(jax.random.fold_in(key, t), B)
        jst, jo, jr, ji = jgs.step_det(jst, jnp.asarray(a), spawns)
        tst, to, tr, ti = tgs.step_det(tst, torch.from_numpy(a),
                                       to_t(spawns))
        for f in ("pos", "items_h", "items_v"):
            assert_equal(getattr(tst, f), getattr(jst, f))
        assert_equal(to, jo)
        assert_equal(tr, jr)
        for k in ("u", "dset", "dset_full", "ages"):
            assert_equal(ti[k], ji[k])
    assert_equal(tgs.observe(tst), jgs.observe(jst))


@pytest.mark.parametrize("vanish", [0, 8])
def test_gs_replay_through_ls_is_exact(vanish):
    """With no spawns, the LS fed the GS's own u_t reproduces every
    agent's observations and rewards exactly (the reference's
    ``test_warehouse_gs_replay_through_batched_ls``)."""
    cfg = twh.WarehouseConfig(p_item=0.0, vanish_after=vanish)
    ag = AGENTS["four"]
    gs = twh.make_batched_multi_warehouse_env(cfg, ag, device="cpu")
    ls = twh.make_batched_local_warehouse_env(cfg, device="cpu")
    g = torch.Generator().manual_seed(6)
    B, A = 3, len(ag)
    st = gs.reset(g, B)
    idx = torch.as_tensor(ag)
    lst = twh.local_warehouse_state(st, idx[:, 0], idx[:, 1])
    lst = twh.LocalWarehouseState(*(l.reshape((B * A,) + l.shape[2:])
                                    for l in lst))
    for _ in range(16):
        a = torch.randint(0, 5, (B, A), generator=g)
        st, obs, r, info = gs.step(st, a, g)
        lst, lobs, lr, _ = ls.step(lst, a.reshape(-1),
                                   info["u"].reshape(B * A, -1), g)
        assert torch.equal(lobs, obs.reshape(B * A, -1))
        assert torch.equal(lr, r.reshape(-1))


def test_robots_stay_in_their_region_and_rewards_are_counts():
    gs = twh.make_batched_warehouse_env(device="cpu")
    g = torch.Generator().manual_seed(0)
    st = gs.reset(g, 32)
    for _ in range(20):
        a = torch.randint(0, 5, (32,), generator=g)
        st, obs, r, info = gs.step(st, a, g)
        assert bool((st.pos >= 0).all()) and bool((st.pos <= 4).all())
        assert bool((r >= 0).all()) and torch.equal(r, r.round())
    assert obs.shape == (32, 37) and info["u"].shape == (32, 12)
    assert info["dset"].shape == (32, 24)
    assert info["dset_full"].shape == (32, 49)


def test_vanish_after_bounds_the_ages():
    gs = twh.make_batched_warehouse_env(twh.WarehouseConfig(vanish_after=8),
                                        device="cpu")
    g = torch.Generator().manual_seed(1)
    st = gs.reset(g, 16)
    for _ in range(24):
        st, _, _, _ = gs.step(st, torch.zeros(16, dtype=torch.long), g)
        assert int(st.items_h.max()) <= 8 and int(st.items_v.max()) <= 8


def test_item_cells_are_the_region_edges_of_the_reference_table():
    r, c = twh.item_cells(5)
    assert list(zip(r.tolist(), c.tolist())) == list(jwh._ITEM_RC)
    for rr, cc in zip(r.tolist(), c.tolist()):
        assert rr in (0, 4) or cc in (0, 4)


def test_u_removes_items_and_a_step_onto_an_item_is_rewarded():
    ls = twh.make_batched_local_warehouse_env(device="cpu")
    no_spawn = torch.zeros((2, 12), dtype=torch.bool)
    st = twh.LocalWarehouseState(
        pos=torch.tensor([[2, 2], [1, 1]], dtype=torch.int32),
        items=torch.ones((2, 12), dtype=torch.int32))
    # lane 0: neighbours took everything, the agent (centre) got none;
    # lane 1: no neighbour, the agent steps up onto item cell (0, 1)
    u = torch.stack([torch.ones(12), torch.zeros(12)])
    st2, _, r, _ = ls.step_det(st, torch.tensor([0, 1]), u, no_spawn)
    assert r.tolist() == [0.0, 1.0]
    assert int(st2.items[0].sum()) == 0
    assert int(st2.items[1, 0]) == 0 and bool((st2.items[1, 1:] == 2).all())


def test_scripted_robots_take_the_first_of_equal_ages():
    """Every item of region (0, 0) has age 3: the robot at (2, 1) heads
    for item cell 0, (0, 1), and moves up (the last of the tied cells,
    (3, 4), would send it down); with cell 0 empty, the robot at (1, 1)
    heads for cell 1, (0, 2): up again. Both packages agree."""
    for empty, start, move in (((), (2, 1), (1, 1)),
                               ((0,), (1, 1), (0, 1))):
        h = np.zeros((1, 7, 6, 3), np.int32)
        v = np.zeros((1, 6, 7, 3), np.int32)
        h[0, 0, 0] = h[0, 1, 0] = v[0, 0, 0] = v[0, 0, 1] = 3
        for i in empty:
            h[0, 0, 0, i] = 0
        pos = np.full((1, 6, 6, 2), 2, np.int32)
        pos[0, 0, 0] = start
        jst = jwh.WarehouseState(jnp.asarray(pos), jnp.asarray(h),
                                 jnp.asarray(v))
        cfg = jwh.WarehouseConfig(p_item=0.0)
        jgs = jwh.make_batched_multi_warehouse_env(cfg, jnp.asarray([(5, 5)]))
        tgs = twh.make_batched_multi_warehouse_env(
            twh.WarehouseConfig(p_item=0.0), [(5, 5)], device="cpu")
        zeros = {"spawn_h": np.zeros(h.shape, bool),
                 "spawn_v": np.zeros(v.shape, bool)}
        a = np.zeros((1, 1), np.int32)
        js, *_ = jgs.step_det(jst, jnp.asarray(a), zeros)
        ts, *_ = tgs.step_det(to_t(jst), torch.from_numpy(a), to_t(zeros))
        assert tuple(int(x) for x in js.pos[0, 0, 0]) == move
        assert_equal(ts.pos, js.pos)
    x = torch.tensor([[1, 5, 5, 2], [-1, -1, -1, -1], [0, 0, 7, 7]])
    assert twh.first_argmax(x).tolist() == [1, 0, 2]


def test_jax_warehouse_policy_and_gru_aip_carry_across():
    """A JAX warehouse policy (S = 296, hidden 128, 5 actions) and GRU
    AIP (D = 24, hidden 64, M = 12), initialised in JAX and carried across
    with ``convert.to_torch``, compute the same policy rollout on the same
    streams: the JAX package's ``ops.policy_rollout`` against the port's
    (CPU: the plain version), lanes under the lane and flip rule."""
    from repro.core import influence as jinf
    from repro.kernels import ops as jops
    from repro.rl import ppo as jppo
    from repro_torch.core import engine
    from repro_torch.kernels import ops, ref
    from repro_torch.rl import ppo as tppo
    T, B = 6, 4
    pcfg = jppo.PPOConfig(obs_dim=37, n_actions=5, frame_stack=8)
    acfg = jinf.AIPConfig(kind="gru", d_in=24, n_out=12, hidden=64)
    jpol = jppo.init_policy(pcfg, jax.random.PRNGKey(0))
    jaip = jinf.init_aip(acfg, jax.random.PRNGKey(1))
    tpol, taip = to_t(jpol), to_t(jaip)
    assert tpol["l1"]["w"].shape == (296, 128)
    assert taip["gru"]["wx"].shape == (24, 192)
    rng = np.random.default_rng(2)
    ls_env = twh.make_batched_local_warehouse_env(device="cpu")
    st = ls_env.reset(torch.Generator().manual_seed(3), B)
    spawn = rng.random((T, B, 12)) < 0.2
    io = engine.kernel_io(ls_env, st, torch.from_numpy(spawn))
    ls = tuple(to_np(l) for l in io.ls)
    s0 = (0.3 * rng.normal(size=(B, 64))).astype(np.float32)
    frames0 = np.zeros((B, 296), np.float32)
    frames0[:, -37:] = to_np(ls_env.obs_fn(st))
    gumbel = rng.gumbel(size=(T, B, 5)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (T, B, 12),
                        dtype=np.uint64).astype(np.uint32)
    done = np.zeros((T, B), np.int32)
    done[3, 1] = 1
    reset = (rng.integers(0, 5, (T, B, 2)).astype(np.int32),
             (rng.random((T, B, 12)) < 0.3).astype(np.int32))
    aw = lambda p: (p["gru"]["wx"][None], p["gru"]["wh"][None],
                    p["gru"]["b"][None], p["head"]["w"][None],
                    p["head"]["b"][None])
    tick, dset, obs = jax_ls_fns("warehouse")
    jout = jops.policy_rollout(
        ls, s0, frames0, aw(jaip), jppo.flat_policy_weights(jpol), gumbel,
        bits, done, (spawn.astype(np.int32),), reset, kind="gru",
        n_agents=1, fast_gates=True, tick_fn=tick, dset_fn=dset, obs_fn=obs)
    args = (io.ls, to_t(s0), to_t(frames0), aw(taip),
            tppo.flat_policy_weights(tpol), to_t(gumbel), to_t(bits),
            to_t(done), io.noise, tuple(to_t(r) for r in reset))
    kw = dict(kind="gru", n_agents=1, fast_gates=True, tick_fn=io.tick_fn,
              dset_fn=io.dset_fn, obs_fn=io.obs_fn)
    pout = ops.policy_rollout(*args, domain=ls_env.kernel_domain, **kw)
    trace = {}
    ref.policy_rollout_ref(*args, trace=trace, **kw)
    margins = np.minimum(np.stack([to_np(m) for m in trace["aip"]]),
                         np.stack([to_np(m) for m in trace["policy"]]))
    (pl, ps, pf, px, pa, plg, pv, pr), (jl, js, jf, jx, ja, jlg, jv, jr) = \
        pout, jout
    assert_lanes_match(
        [(px, jx, False), (pa, ja, True), (plg, jlg, False),
         (pv, jv, False), (pr, jr, False)],
        [(pl[0], jl[0], True), (pl[1], jl[1], True), (ps, js, False),
         (pf, jf, False)], margins, T, B)
