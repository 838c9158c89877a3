"""The port's unified IALS engine (``repro_torch/core/engine.py``) on the
CPU route: the whole-horizon ``rollout`` (one ``ops`` call) equals a loop
of its own per-tick ``step_det``; ``policy_rollout`` (one
``ops.policy_rollout`` call) equals PPO's plain hoisted loop on the same
streams; the agent-major lane fold round-trips. Both domains: the
warehouse with its spawn noise and its policy's 8-frame stack. Lanes are
compared with the lane and flip rule of ``test_torch_common``, margins
traced from the plain kernel version the engine calls."""
import pytest

from test_torch_common import assert_lanes_match, to_np

import torch  # noqa: E402

from repro_torch.core import engine, influence  # noqa: E402
from repro_torch.envs.api import horizon_noise, index_tree  # noqa: E402
from repro_torch.envs.traffic import make_batched_local_traffic_env  # noqa
from repro_torch.envs.warehouse import (  # noqa: E402
    make_batched_local_warehouse_env)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, T = 5, 8
# per domain: the LS and the frames its policy stacks
DOMAINS = {"traffic": (make_batched_local_traffic_env, 1),
           "warehouse": (make_batched_local_warehouse_env, 8)}
DOMAIN_CASES = [pytest.param(d, kind, A, id=("" if d == "traffic" else
                                               f"{d}-") + f"{A}-{kind}")
                for d in DOMAINS for A in (1, 3) for kind in ("gru", "fnn")]


def _engine(kind, A, seed=0, domain="traffic"):
    g = torch.Generator().manual_seed(seed)
    ls = DOMAINS[domain][0](device="cpu")
    cfg = influence.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                              n_out=ls.spec.n_influence, hidden=12,
                              stack=3 if kind == "fnn" else 1)
    p = (influence.init_aip(cfg, g) if A == 1
         else influence.init_aip_stacked(cfg, g, A))
    p = {k: {n: w + 0.1 * torch.randn(w.shape, generator=g)
             for n, w in v.items()} for k, v in p.items()}
    return engine.make_unified_ials(ls, p, cfg, n_agents=A), g


def _traced(monkeypatch, name):
    """Wrap ``ref.<name>`` so its decision margins are recorded."""
    trace = {}
    orig = getattr(ref, name)
    monkeypatch.setattr(ref, name,
                        lambda *a, **kw: orig(*a, trace=trace, **kw))
    return trace


def _batch_major(margins, A):
    """(T, L) agent-major lane margins -> (T, B*A) batch-major."""
    m = torch.stack(margins)
    return engine.stream_unfold(m, A, B).reshape(m.shape[0], -1)


@pytest.mark.parametrize("domain,kind,A", DOMAIN_CASES)
def test_rollout_equals_a_loop_of_step(domain, kind, A, monkeypatch):
    env, g = _engine(kind, A, domain=domain)
    st0 = env.reset(g, B)
    acts = torch.randint(0, env.spec.n_actions,
                         (T, B) + ((A,) if A > 1 else ()), generator=g)
    noise = horizon_noise(env.noise_fn, g, T, B)
    trace = _traced(monkeypatch, "ials_rollout_multi_ref" if kind == "gru"
                    else "fnn_rollout_ref")
    st_r, rew_r = env.rollout(st0, acts, noise)
    st, rews = st0, []
    for t in range(T):
        st, _, r, _ = env.step_det(st, acts[t], index_tree(noise, t))
        rews.append(r)
    rew_l = torch.stack(rews)
    L = B * A
    flat = lambda x: x.reshape(L, -1)
    assert_lanes_match(
        [(rew_r.reshape(T, L), to_np(rew_l.reshape(T, L)), False)],
        [(flat(a), to_np(flat(b)), True) for a, b in zip(
            tree_leaves(st_r.ls_state), tree_leaves(st.ls_state))]
        + [(flat(st_r.aip_state), to_np(flat(st.aip_state)), False)],
        _batch_major(trace["aip"], A), T, L)


@pytest.mark.parametrize("domain,kind,A", DOMAIN_CASES)
def test_policy_rollout_equals_the_plain_ppo_loop(domain, kind, A,
                                                  monkeypatch):
    env, g = _engine(kind, A, seed=1, domain=domain)
    assert env.policy_rollout is not None
    plain = env._replace(policy_rollout=None)
    cfg = ppo.PPOConfig(obs_dim=env.spec.obs_dim,
                        n_actions=env.spec.n_actions,
                        frame_stack=DOMAINS[domain][1], hidden=16, n_envs=B,
                        rollout_len=T, episode_len=3, n_agents=A)
    pol = ppo.init_policy(cfg, g)
    pol = {k: {n: w + 0.1 * torch.randn(w.shape, generator=g)
               for n, w in v.items()} for k, v in pol.items()}
    rs0 = ppo.init_rollout_state(env, cfg, g)
    streams = ppo.draw_rollout_streams(env, cfg, g)
    trace = _traced(monkeypatch, "policy_rollout_ref")
    rs_k, bk, vk = ppo.rollout(env, cfg, pol, rs0, streams=streams)
    rs_p, bp, vp = ppo.rollout(plain, cfg, pol, rs0, streams=streams)
    assert float(bp["done"].sum()) > 0                 # resets fired
    L = B * A
    margins = torch.minimum(_batch_major(trace["aip"], A),
                            _batch_major(trace["policy"], A))
    s = lambda x: x.reshape(T, L, -1)
    f = lambda x: x.reshape(L, -1)
    assert_lanes_match(
        [(s(bk[k]), to_np(s(bp[k])), k in ("a", "done"))
         for k in ("x", "a", "logp", "v", "r", "done")],
        [(f(a), to_np(f(b)), True) for a, b in zip(
            tree_leaves(rs_k.env_state.ls_state),
            tree_leaves(rs_p.env_state.ls_state))]
        + [(f(rs_k.env_state.aip_state), to_np(f(rs_p.env_state.aip_state)),
            False),
         (f(rs_k.frames), to_np(f(rs_p.frames)), False),
         (vk.reshape(L, 1), to_np(vp.reshape(L, 1)), False)],
        margins, T, L)
    assert torch.equal(rs_k.t_in_ep, rs_p.t_in_ep)


def test_lane_fold_round_trips():
    A = 3
    x = torch.arange(B * A * 2).reshape(B, A, 2)
    lanes = engine.lane_fold(x, A)
    assert torch.equal(lanes[1 * B + 4], x[4, 1])      # lane a*B + b
    assert torch.equal(engine.lane_unfold(lanes, A, B), x)
    s = torch.arange(T * B * A).reshape(T, B, A)
    assert torch.equal(engine.stream_unfold(engine.stream_fold(s, A), A, B),
                       s)
    y = x[:, 0]
    assert engine.lane_fold(y, 1) is y                  # A = 1: no-op


def test_policy_rollout_is_set_only_with_the_horizon_functions():
    env, _ = _engine("gru", 1)
    assert env.policy_rollout is not None and env.rollout is not None
    ls = make_batched_local_traffic_env(device="cpu")._replace(
        obs_fn=None)
    cfg = influence.AIPConfig(kind="gru", d_in=40, n_out=4, hidden=4)
    p = influence.init_aip(cfg, torch.Generator().manual_seed(0))
    bare = engine.make_unified_ials(ls, p, cfg)
    assert bare.policy_rollout is None and bare.rollout is not None
    assert tree_leaves(bare.reset(torch.Generator(), 2))[0].shape[0] == 2
