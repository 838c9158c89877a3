"""The single-agent whole-horizon dispatch ``repro_torch.kernels.ops.
ials_rollout`` and its plain version ``kernels/ref.py::ials_rollout_ref``
(the ground truth of ``kernels/aip_step.py::aip_rollout``, the A = 1 case
of the ``aip_rollout_multi`` kernel) on the CPU, three ways:

  - against the reference's ``repro.kernels.ref.ials_rollout_ref`` on both
    domains' LS functions, with the same weights, states, bits and noise
    (the lane and flip rule of ``test_torch_common``);
  - against the reference's Pallas ``aip_rollout(interpret=True)`` on the
    toy LS of ``tests/test_rollout_engine.py::test_kernel_lane_blocking``
    (B = 6, T = 5);
  - against the port's own ``ials_rollout_multi_ref`` at n_agents = 1.

The kernel against its plain version on the card is
``tests/test_torch_kernels_gpu.py::test_aip_rollout_kernel_matches_plain``
(``gpu``-marked)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import FWD_ATOL, assert_close, assert_lanes_match, \
    jax_ls_fns, to_t
from test_torch_kernels_ref import Inputs

import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.aip_step import aip_rollout as j_aip_rollout  # noqa
from repro_torch.kernels import aip_step as cuda  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

T = 8


def _unstacked(x):
    return tuple(w[0] for w in x.aw)


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
def test_ials_rollout_matches_the_reference_oracle(domain):
    x = Inputs("gru", 1, 50, domain)
    tick, dset, _ = jax_ls_fns(domain)
    j_ls, j_h, j_r = jref.ials_rollout_ref(
        x.ls, x.s0, *_unstacked(x), x.actions, x.bits, x.noise,
        tick_fn=tick, dset_fn=dset)
    trace = {}
    p_ls, p_h, p_r = ref.ials_rollout_ref(
        x.io.ls, to_t(x.s0), *(to_t(w) for w in _unstacked(x)),
        to_t(x.actions), to_t(x.bits), x.t(x.noise), tick_fn=x.io.tick_fn,
        dset_fn=x.io.dset_fn, trace=trace)
    # ops.ials_rollout on CPU tensors is this plain version
    o_ls, o_h, o_r = ops.ials_rollout(
        x.io.ls, to_t(x.s0), *(to_t(w) for w in _unstacked(x)),
        to_t(x.actions), to_t(x.bits), x.t(x.noise), tick_fn=x.io.tick_fn,
        dset_fn=x.io.dset_fn, domain=x.tls.kernel_domain)
    for a, b in zip((o_ls, o_h, o_r), (p_ls, p_h, p_r)):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)
    assert_lanes_match(
        [(p_r, j_r, False)],
        [(p, j, True) for p, j in zip(p_ls, j_ls)] + [(p_h, j_h, False)],
        trace["aip"], T, x.L)


def test_ials_rollout_matches_the_pallas_kernel_in_interpret_mode():
    """The toy LS of the reference's lane-blocking test: the state drifts
    by the drawn u and the reward counts the u bits, so AIP and "LS"
    couple both ways."""
    H, M, Dd = 8, 4, 12
    ks = jax.random.split(jax.random.PRNGKey(7), 8)
    B, Tt = 6, 5
    wx = jax.random.normal(ks[0], (Dd, 3 * H)) * 0.2
    wh = jax.random.normal(ks[1], (H, 3 * H)) * 0.2
    b = jax.random.normal(ks[2], (3 * H,)) * 0.1
    hw = jax.random.normal(ks[3], (H, M)) * 0.2
    hb = jax.random.normal(ks[4], (M,)) * 0.1
    h0 = jax.random.normal(ks[5], (B, H)) * 0.5
    ls = (jax.random.normal(ks[6], (B, Dd)),)
    acts = jnp.zeros((Tt, B), jnp.int32)
    bits = jax.random.bits(ks[7], (Tt, B, M), jnp.uint32)

    def j_tick(leaves, a, u, noise):
        return (leaves[0] + jnp.pad(u, ((0, 0), (0, Dd - M))),), u.sum(-1)

    def t_tick(leaves, a, u, noise):
        return ((leaves[0] + torch.nn.functional.pad(u, (0, Dd - M)),),
                u.sum(-1))

    j_ls, j_h, j_r = j_aip_rollout(ls, h0, wx, wh, b, hw, hb, acts, bits,
                                   (), tick_fn=j_tick,
                                   dset_fn=lambda l, a: l[0],
                                   interpret=True)
    trace = {}
    p_ls, p_h, p_r = ref.ials_rollout_ref(
        (to_t(ls[0]),), to_t(h0), to_t(wx), to_t(wh), to_t(b), to_t(hw),
        to_t(hb), to_t(acts), to_t(bits), (), tick_fn=t_tick,
        dset_fn=lambda l, a: l[0], trace=trace)
    assert_lanes_match([(p_r, j_r, False)],
                       [(p_ls[0], j_ls[0], False), (p_h, j_h, False)],
                       trace["aip"], Tt, B)


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
def test_ials_rollout_equals_the_multi_oracle_at_one_agent(domain):
    x = Inputs("gru", 1, 51, domain)
    args = (to_t(x.actions), to_t(x.bits), x.t(x.noise))
    kw = dict(tick_fn=x.io.tick_fn, dset_fn=x.io.dset_fn)
    trace = {}
    one = ref.ials_rollout_ref(x.io.ls, to_t(x.s0),
                               *(to_t(w) for w in _unstacked(x)), *args,
                               trace=trace, **kw)
    multi = ref.ials_rollout_multi_ref(x.io.ls, to_t(x.s0), *x.t(x.aw),
                                       *args, n_agents=1, **kw)
    assert_lanes_match(
        [(one[2], multi[2].numpy(), False)],
        [(p, m.numpy(), True) for p, m in zip(one[0], multi[0])]
        + [(one[1], multi[1].numpy(), False)], trace["aip"], T, x.L)
    assert_close(one[1], multi[1].numpy(), FWD_ATOL)


def test_cpu_tensors_count_no_launch_and_the_kernel_wrapper_refuses_them():
    x = Inputs("gru", 1, 52)
    cuda.reset_launches()
    w = tuple(to_t(w) for w in _unstacked(x))
    args = (x.io.ls, to_t(x.s0), *w, to_t(x.actions), to_t(x.bits), ())
    ops.ials_rollout(*args, tick_fn=x.io.tick_fn, dset_fn=x.io.dset_fn,
                     domain=x.tls.kernel_domain)
    assert all(v == 0 for v in cuda.LAUNCHES.values())
    assert "aip_rollout" in cuda.LAUNCHES
    assert "aip_rollout[warehouse]" in cuda.LAUNCHES
    with pytest.raises(ValueError):
        cuda.aip_rollout(*args, domain=x.tls.kernel_domain)
    np.testing.assert_array_equal(x.actions.shape, (T, 6))
