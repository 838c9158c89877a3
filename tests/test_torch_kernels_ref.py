"""The port's plain kernel versions (``repro_torch/kernels/ref.py``, the
CPU route of ``repro_torch/kernels/ops.py`` and the ground truth of the
CUDA kernels) against the JAX package's ``repro.kernels.ops`` on the CPU,
which its own tests pin bitwise to the Pallas kernels in interpret mode.

Same inputs on both sides, made with numpy: LS states, AIP and policy
weights, and every stream (actions, bits, gumbel, done, reset states, the
warehouse's spawn noise), for both backbones at A in {1, 3} on both
domains (the warehouse's policy on 8 stacked frames), resets inside the
horizon. Lanes are compared with the lane and flip rule of
``test_torch_common``."""
import numpy as np
import pytest

from test_torch_common import (FLIP_EPS, FWD_ATOL, assert_close,
                               assert_lanes_match, jax_ls_fns, to_np, to_t)

import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.envs import traffic as ttr  # noqa: E402
from repro_torch.envs import warehouse as twh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.nn.act import fast_sigmoid, uniform_from_bits  # noqa: E402

H, T, B = 16, 8, 6
# per domain: d-set width, influence sources, observation width, frames a
# policy input holds, actions
WIDTHS = {"traffic": (40, 4, 41, 1, 2), "warehouse": (24, 12, 37, 8, 5)}
LANE = 10                # traffic's lane length
D, M = 4 * LANE, 4       # traffic's d-set and sources (the aip_step test)
DOMAIN_CASES = [pytest.param(d, kind, A, id=("" if d == "traffic" else
                                               f"{d}-") + f"{A}-{kind}")
                for d in WIDTHS for A in (1, 3) for kind in ("gru", "fnn")]


class Inputs:
    def __init__(self, kind, A, seed, domain="traffic"):
        rng = np.random.default_rng(seed)
        L = A * B
        Dd, Md, obs, stack, NA = WIDTHS[domain]
        self.kind, self.A, self.L = kind, A, L
        if domain == "traffic":
            lanes = rng.random((L, 4, LANE)) < 0.4
            phase = rng.integers(0, 2, L).astype(np.int8)
            self.ls_state = ttr.LocalTrafficState(torch.from_numpy(lanes),
                                                  torch.from_numpy(phase))
            self.tls = ttr.make_batched_local_traffic_env(device="cpu")
        else:
            pos = rng.integers(0, 5, (L, 2)).astype(np.int32)
            items = rng.integers(0, 12, (L, 12)).astype(np.int32)
            items[rng.random((L, 12)) < 0.5] = 0
            self.ls_state = twh.LocalWarehouseState(torch.from_numpy(pos),
                                                    torch.from_numpy(items))
            self.tls = twh.make_batched_local_warehouse_env(device="cpu")
        w = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
        if kind == "gru":
            self.aw = (w(A, Dd, 3 * H), w(A, H, 3 * H), w(A, 3 * H),
                       w(A, H, Md), w(A, Md))
            self.s0 = w(L, H)
        else:
            self.aw = (w(A, 3 * Dd, H), w(A, H), w(A, H, H), w(A, H),
                       w(A, H, Md), w(A, Md))
            self.s0 = (rng.random((L, 3 * Dd)) < 0.4).astype(np.float32)
        S = obs * stack
        self.pw = (w(S, 16), w(16), w(16, 16), w(16), w(16, NA), w(NA),
                   w(16, 1), w(1))
        self.actions = rng.integers(0, NA, (T, L)).astype(np.int32)
        self.bits = rng.integers(0, 2 ** 32, (T, L, Md),
                                 dtype=np.uint64).astype(np.uint32)
        self.gumbel = rng.gumbel(size=(T, L, NA)).astype(np.float32)
        t_in = rng.integers(0, 5, B)
        done_env = ((t_in[None] + 1 + np.arange(T)[:, None]) % 5) == 0
        self.done = np.tile(done_env, (1, A)).astype(np.int32)
        if domain == "traffic":
            self.noise = ()
            self.reset = ((rng.random((T, L, 4, LANE)) < 0.2
                           ).astype(np.int32), np.zeros((T, L), np.int32))
        else:
            self.noise = ((rng.random((T, L, 12)) < 0.1).astype(np.int32),)
            self.reset = (rng.integers(0, 5, (T, L, 2)).astype(np.int32),
                          (rng.random((T, L, 12)) < 0.3).astype(np.int32))
        # the noise leaves' structure and dtype (bool) for the LS's decode
        self.io = engine.kernel_io(
            self.tls, self.ls_state,
            torch.from_numpy(self.noise[0] != 0) if self.noise else None)
        self.ls = tuple(to_np(l) for l in self.io.ls)
        # older frames hold other bits, so the frame shift carries data
        frames = (rng.random((L, S)) < 0.2).astype(np.float32)
        frames[:, S - obs:] = to_np(self.tls.obs_fn(self.ls_state))
        self.frames0 = frames

    def t(self, x):
        return tuple(to_t(v) for v in x) if isinstance(x, tuple) else to_t(x)


@pytest.mark.parametrize("A", [1, 3])
def test_aip_step_matches(A):
    x = Inputs("gru", A, A)
    rng = np.random.default_rng(10 + A)
    d = (rng.random((B, A, D)) < 0.4).astype(np.float32)
    h = x.s0.reshape(A, B, H).swapaxes(0, 1).copy()
    bits = x.bits[0].reshape(A, B, M).swapaxes(0, 1).copy()
    if A == 1:
        j = jops.aip_step(d[:, 0], h[:, 0], *(w[0] for w in x.aw),
                          bits[:, 0])
        p = ops.aip_step(to_t(d[:, 0]), to_t(h[:, 0]),
                         *(to_t(w[0]) for w in x.aw), to_t(bits[:, 0]))
    else:
        j = jops.aip_step_multi(d, h, *x.aw, bits)
        p = ops.aip_step_multi(to_t(d), to_t(h), *x.t(x.aw), to_t(bits))
    assert_close(p[0], j[0], FWD_ATOL)
    assert_close(p[1], j[1], FWD_ATOL)
    b = to_t(bits if A > 1 else bits[:, 0])
    margin = to_np((uniform_from_bits(b) - fast_sigmoid(p[1])).abs())
    flipped = to_np(p[2]) != np.asarray(j[2])
    assert not (flipped & (margin >= FLIP_EPS)).any()


@pytest.mark.parametrize("domain,kind,A", DOMAIN_CASES)
def test_rollout_matches(domain, kind, A):
    x = Inputs(kind, A, 20 + A, domain)
    tick, dset, _ = jax_ls_fns(domain)
    jfn = jops.ials_rollout_multi if kind == "gru" else jops.fnn_rollout
    j_ls, j_s, j_r = jfn(x.ls, x.s0, *x.aw, x.actions, x.bits, x.noise,
                         n_agents=A, tick_fn=tick, dset_fn=dset)
    rfn = (ref.ials_rollout_multi_ref if kind == "gru"
           else ref.fnn_rollout_ref)
    trace = {}
    p_ls, p_s, p_r = rfn(x.io.ls, to_t(x.s0), *x.t(x.aw), to_t(x.actions),
                         to_t(x.bits), x.t(x.noise), n_agents=A,
                         tick_fn=x.io.tick_fn, dset_fn=x.io.dset_fn,
                         trace=trace)
    assert_lanes_match(
        [(p_r, j_r, False)],
        [(p, j, True) for p, j in zip(p_ls, j_ls)] + [(p_s, j_s, False)],
        trace["aip"], T, x.L)


@pytest.mark.parametrize("domain,kind,A", DOMAIN_CASES)
def test_policy_rollout_matches(domain, kind, A):
    x = Inputs(kind, A, 30 + A, domain)
    assert x.done.any()                            # resets inside
    tick, dset, obs = jax_ls_fns(domain)
    jout = jops.policy_rollout(
        x.ls, x.s0, x.frames0, x.aw, x.pw, x.gumbel, x.bits, x.done,
        x.noise, x.reset, kind=kind, n_agents=A, fast_gates=True,
        tick_fn=tick, dset_fn=dset, obs_fn=obs)
    args = (x.io.ls, to_t(x.s0), to_t(x.frames0), x.t(x.aw), x.t(x.pw),
            to_t(x.gumbel), to_t(x.bits), to_t(x.done), x.t(x.noise),
            x.t(x.reset))
    kw = dict(kind=kind, n_agents=A, fast_gates=True, tick_fn=x.io.tick_fn,
              dset_fn=x.io.dset_fn, obs_fn=x.io.obs_fn)
    pout = ops.policy_rollout(*args, domain=None, **kw)
    # the CPU route is the plain version; re-run it traced for margins
    trace = {}
    ref.policy_rollout_ref(*args, trace=trace, **kw)
    margins = np.minimum(np.stack([to_np(m) for m in trace["aip"]]),
                         np.stack([to_np(m) for m in trace["policy"]]))
    (pl, ps, pf, px, pa, plg, pv, pr) = pout
    (jl, js, jf, jx, ja, jlg, jv, jr) = jout
    assert_lanes_match(
        [(px, jx, False), (pa, ja, True), (plg, jlg, False),
         (pv, jv, False), (pr, jr, False)],
        [(p, j, True) for p, j in zip(pl, jl)]
        + [(ps, js, False), (pf, jf, False)], margins, T, x.L)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from repro_torch.kernels import aip_step as cuda
    cuda.reset_launches()
    x = Inputs("fnn", 1, 40)
    ops.fnn_rollout(x.io.ls, to_t(x.s0), *x.t(x.aw), to_t(x.actions),
                    to_t(x.bits), (), n_agents=1, tick_fn=x.io.tick_fn,
                    dset_fn=x.io.dset_fn, domain=x.tls.kernel_domain)
    assert all(v == 0 for v in cuda.LAUNCHES.values())
    with pytest.raises(ValueError):
        cuda.fnn_rollout(x.io.ls, to_t(x.s0), *x.t(x.aw), to_t(x.actions),
                         to_t(x.bits), (), n_agents=1,
                         domain=x.tls.kernel_domain)
