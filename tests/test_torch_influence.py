"""The port's AIP (``repro_torch/core/influence.py``) against
``repro.core.influence``: one tick (``step``, ``step_sample[_multi]``) for
both backbones at A = 1 and stacked A = 3 (f32 forward, ``FWD_ATOL``;
draws exact unless within ``FLIP_EPS`` of their threshold), the
cross-entropy and its gradient against ``jax.grad``, and the whole fit
(``train_aip`` / ``train_aip_batched``, 2 epochs) given the JAX
package's own initial parameters and minibatch permutations
(``OPT_ATOL``)."""
import numpy as np
import pytest

from test_torch_common import (FLIP_EPS, FWD_ATOL, OPT_ATOL, assert_close,
                               to_np, to_t)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import influence as jinf  # noqa: E402
from repro_torch.core import influence as tinf  # noqa: E402
from repro_torch.nn.act import fast_sigmoid, uniform_from_bits  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

D, M = 12, 4


def _cfg(kind):
    return jinf.AIPConfig(kind=kind, d_in=D, n_out=M, hidden=16,
                          stack=3 if kind == "fnn" else 1)


def _tcfg(kind):
    c = _cfg(kind)
    return tinf.AIPConfig(kind=c.kind, d_in=c.d_in, n_out=c.n_out,
                          hidden=c.hidden, stack=c.stack)


def _params(kind, A, seed=0):
    cfg = _cfg(kind)
    key = jax.random.PRNGKey(seed)
    if A == 1:
        p = jinf.init_aip(cfg, key)
    else:
        p = jax.vmap(lambda k: jinf.init_aip(cfg, k))(
            jax.random.split(key, A))
    # non-zero biases, so every leaf matters
    leaves, tdef = jax.tree_util.tree_flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape)
              for l, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _state(kind, shape, rng):
    cfg = _cfg(kind)
    if kind == "gru":
        return rng.normal(0, 0.5, shape + (cfg.hidden,)).astype(np.float32)
    return (rng.random(shape + (cfg.stack, D)) < 0.4).astype(np.float32)


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A", [1, 3])
def test_step_and_step_sample_match(kind, A):
    rng = np.random.default_rng(A)
    B = 32
    bshape = (B,) if A == 1 else (B, A)
    jp = _params(kind, A)
    tp = to_t(jp)
    st = _state(kind, bshape, rng)
    d = (rng.random(bshape + (D,)) < 0.4).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, bshape + (M,),
                        dtype=np.uint64).astype(np.uint32)
    cfg, tcfg = _cfg(kind), _tcfg(kind)
    if A == 1:
        jl, js = jinf.step(jp, cfg, jnp.asarray(st), jnp.asarray(d))
        tl, ts = tinf.step(tp, tcfg, torch.from_numpy(st),
                           torch.from_numpy(d))
        jout = jinf.step_sample(jp, cfg, jnp.asarray(st), jnp.asarray(d),
                                jnp.asarray(bits))
        tout = tinf.step_sample(tp, tcfg, torch.from_numpy(st),
                                torch.from_numpy(d), to_t(bits))
    else:
        jl, js = jinf.step_multi(jp, cfg, jnp.asarray(st), jnp.asarray(d))
        tl, ts = tinf.step_multi(tp, tcfg, torch.from_numpy(st),
                                 torch.from_numpy(d))
        jout = jinf.step_sample_multi(jp, cfg, jnp.asarray(st),
                                      jnp.asarray(d), jnp.asarray(bits))
        tout = tinf.step_sample_multi(tp, tcfg, torch.from_numpy(st),
                                      torch.from_numpy(d), to_t(bits))
    assert_close(tl, jl, FWD_ATOL)
    assert_close(ts, js, FWD_ATOL)
    assert_close(tout[0], jout[0], FWD_ATOL)
    assert_close(tout[1], jout[1], FWD_ATOL)
    flipped = to_np(tout[2]) != np.asarray(jout[2])
    margin = to_np((uniform_from_bits(to_t(bits))
                    - fast_sigmoid(tout[0])).abs())
    assert not (flipped & (margin >= FLIP_EPS)).any()


@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_xent_loss_and_gradient_match(kind):
    rng = np.random.default_rng(5)
    jp = _params(kind, 1, seed=3)
    d = (rng.random((6, 7, D)) < 0.4).astype(np.float32)
    u = (rng.random((6, 7, M)) < 0.3).astype(np.float32)
    cfg = _cfg(kind)
    jl, jg = jax.value_and_grad(jinf.xent_loss)(jp, cfg, jnp.asarray(d),
                                                jnp.asarray(u))
    tp = to_t(jp)
    leaves = [l.requires_grad_(True) for l in tree_leaves(tp)]
    tl = tinf.xent_loss(tp, _tcfg(kind), torch.from_numpy(d),
                        torch.from_numpy(u))
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) < FWD_ATOL
    for t, j in zip(tg, jax.tree_util.tree_leaves(jg)):
        assert_close(t, j, FWD_ATOL)


def _jax_fit_perms(key, N, epochs):
    """The per-epoch permutations ``influence._train_core`` draws."""
    out = []
    k = key
    for _ in range(epochs):
        k, ke = jax.random.split(k)
        out.append(np.asarray(jax.random.permutation(ke, N)))
    return np.stack(out)


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("window", [0, 3])
def test_train_aip_matches_given_jax_permutations(kind, window):
    """``window`` > 0 cuts each sequence into BPTT windows of that many
    steps (Theorem 1's k), so the fit permutes N * (T // window) rows."""
    rng = np.random.default_rng(7)
    N, T, epochs = 12, 6, 2
    d = (rng.random((N, T, D)) < 0.4).astype(np.float32)
    u = (rng.random((N, T, M)) < 0.3).astype(np.float32)
    cfg = _cfg(kind)
    key = jax.random.PRNGKey(11)
    jp, jm = jinf.train_aip(cfg, jnp.asarray(d), jnp.asarray(u), key,
                            epochs=epochs, batch_size=4, window=window)
    rows = N * (T // window) if window else N
    tp, tm = tinf.train_aip(
        _tcfg(kind), torch.from_numpy(d), torch.from_numpy(u), None,
        epochs=epochs, batch_size=4, window=window,
        params=to_t(jinf.init_aip(cfg, key)),
        perms=_jax_fit_perms(key, rows, epochs))
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert_close(t, j, OPT_ATOL)
    np.testing.assert_allclose(tm["loss_history"], jm["loss_history"],
                               atol=OPT_ATOL)


@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_train_aip_batched_clips_and_permutes_per_agent(kind):
    rng = np.random.default_rng(8)
    A, N, T, epochs = 3, 10, 5, 2
    d = (rng.random((A, N, T, D)) < 0.4).astype(np.float32)
    u = (rng.random((A, N, T, M)) < 0.3).astype(np.float32)
    u[1] *= 4.0          # one agent with far larger gradients: its clip
    #                      must not scale the other agents' updates
    cfg = _cfg(kind)
    keys = jax.random.split(jax.random.PRNGKey(4), A)
    jp, jm = jinf.train_aip_batched(cfg, jnp.asarray(d), jnp.asarray(u),
                                    keys, epochs=epochs, batch_size=4)
    init = jax.vmap(lambda k: jinf.init_aip(cfg, k))(keys)
    perms = np.stack([_jax_fit_perms(k, N, epochs) for k in keys], 1)
    tp, tm = tinf.train_aip_batched(
        _tcfg(kind), torch.from_numpy(d), torch.from_numpy(u), None,
        epochs=epochs, batch_size=4, params=to_t(init), perms=perms)
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert_close(t, j, OPT_ATOL)
    np.testing.assert_allclose(tm["final_loss_per_agent"],
                               jm["final_loss_per_agent"], atol=OPT_ATOL)


def test_train_aip_from_a_generator_lowers_the_loss():
    rng = np.random.default_rng(9)
    d = torch.from_numpy((rng.random((16, 8, D)) < 0.4).astype(np.float32))
    u = d[..., :M].clone()                 # learnable: u copies d
    g = torch.Generator().manual_seed(0)
    _, m = tinf.train_aip(_tcfg("fnn"), d, u, g, epochs=6, batch_size=8)
    h = m["loss_history"]
    assert h[-1] < h[0] and np.isfinite(h).all()
