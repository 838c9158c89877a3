"""The recurrent blocks in the port (``repro_torch/nn/ssm.py``) against the
JAX package's (``repro/nn/ssm.py``) on the CPU: the causal conv and its
step; Mamba, mLSTM and sLSTM applied over a sequence that spans several
chunks (T = 20 at chunk 8 runs chunks of 5; T = 24 at chunk 8, three
chunks) with their final states, then stepped on from those states.
Every state comes back as the port's ``NamedTuple`` of the same name
(``convert.to_torch`` rebuilds the reference's).

Tolerance: ``SSM_TOL`` = 2e-5 absolute + 1e-5 relative (float32). The
port runs Mamba's associative scan in the reference's order
(``tests/test_torch_ssm_scan.py``) but its products and mLSTM's
chunk-parallel form through einsums that reduce in another order. bf16
weights: ``BF16_TOL`` 3e-2 plus one bf16 ulp.
"""
import numpy as np
import pytest

from test_torch_common import to_np

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from repro.nn import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

SSM_TOL = (2e-5, 1e-5)
BF16_TOL = (3e-2, 2.0 ** -7)
D, NH, B = 32, 4, 2


def _close(port, want, tol=SSM_TOL, what=""):
    np.testing.assert_allclose(to_np(port.float()),
                               np.asarray(want).astype(np.float32),
                               atol=tol[0], rtol=tol[1], err_msg=what)


def _close_state(port, want, tol=SSM_TOL):
    ref = convert.to_torch(jax.tree_util.tree_map(np.asarray, want),
                           device="cpu")
    assert type(port) is type(ref), (type(port), type(ref))
    got, exp = tree_leaves_with_path(port), dict(tree_leaves_with_path(ref))
    assert [p for p, _ in got] == list(exp)
    for path, leaf in got:
        assert leaf.dtype == exp[path].dtype, path
        _close(leaf, to_np(exp[path].float()), tol, path)


def _params(kind, dtype, seed=0):
    """The port's init (bias and gains perturbed) -> (numpy tree, port
    tree); the same arrays on both sides."""
    g = torch.Generator()
    g.manual_seed(seed)
    rs = np.random.RandomState(seed)
    tdt = getattr(torch, dtype)
    p = {"mamba": lambda: tssm.mamba_init(g, D, d_state=8, dtype=tdt,
                                          device="cpu"),
         "mlstm": lambda: tssm.mlstm_init(g, D, NH, dtype=tdt, device="cpu"),
         "slstm": lambda: tssm.slstm_init(g, D, NH, dtype=tdt,
                                          device="cpu")}[kind]()

    def to_np_leaf(t):
        a = t.float().numpy()
        if (a == a.flat[0]).all() and a.flat[0] in (0.0, 1.0):
            a = a + 0.2 * rs.standard_normal(a.shape).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 \
            else a

    np_p = jax.tree_util.tree_map(to_np_leaf, p)
    return np_p, convert.to_torch(np_p, device="cpu")


def _x(T, dtype, seed=1):
    a = np.random.RandomState(seed).standard_normal((B, T, D)).astype(
        np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def test_causal_conv1d_and_step():
    rs = np.random.RandomState(2)
    x = rs.standard_normal((B, 9, 6)).astype(np.float32)
    w = rs.standard_normal((6, 4)).astype(np.float32)
    b = rs.standard_normal((6,)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    _close(tssm.causal_conv1d(tx, tw, tb), jssm.causal_conv1d(x, w, b),
           (1e-6, 0))
    _close(tssm.conv_step(tx[:, -4:], tw, tb),
           jssm.conv_step(x[:, -4:], w, b), (1e-6, 0))
    # the step over the last K inputs is the conv's last output
    _close(tssm.conv_step(tx[:, -4:], tw, tb),
           to_np(tssm.causal_conv1d(tx, tw, tb)[:, -1]), (1e-5, 0))


def _apply(kind, mod, p, x, chunk, **kw):
    if kind == "mamba":
        return mod.mamba_apply(p, x, d_state=8, chunk=chunk,
                               return_state=True)
    fn = mod.mlstm_apply if kind == "mlstm" else mod.slstm_apply
    return fn(p, x, NH, chunk=chunk, return_state=True)


def _step(kind, mod, p, st, x):
    if kind == "mamba":
        return mod.mamba_step(p, st, x, d_state=8)
    fn = mod.mlstm_step if kind == "mlstm" else mod.slstm_step
    return fn(p, st, x, NH)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("T,chunk", [(20, 8), (24, 8), (3, 8)])
def test_apply_then_steps_match(kind, T, chunk):
    """Apply over T (several chunks; T = 3 is shorter than the conv
    window), the final state, then three steps from it."""
    np_p, tp = _params(kind, "float32")
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    jx, tx = _x(T + 3, "float32")
    j_out, j_st = _apply(kind, jssm, jp, jx[:, :T], chunk)
    t_out, t_st = _apply(kind, tssm, tp, tx[:, :T], chunk)
    _close(t_out, j_out, what="apply out")
    _close_state(t_st, j_st)
    for i in range(T, T + 3):
        j_y, j_st = _step(kind, jssm, jp, j_st, jx[:, i])
        t_y, t_st = _step(kind, tssm, tp, t_st, tx[:, i])
        _close(t_y, j_y, what=f"step {i}")
        _close_state(t_st, j_st)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_the_port_steps_on_where_its_apply_would_go(kind):
    """apply(T) then step == apply(T + 1)'s last output and state, in the
    port alone (chunks of 4 over T = 12)."""
    _, tp = _params(kind, "float32", seed=4)
    _, tx = _x(13, "float32", seed=5)
    _, st = _apply(kind, tssm, tp, tx[:, :12], 4)
    y, st1 = _step(kind, tssm, tp, st, tx[:, 12])
    full, st_full = _apply(kind, tssm, tp, tx, 13)
    _close(y, to_np(full[:, -1]), (1e-4, 1e-4))
    for a, b in zip(st1, st_full):
        _close(a, to_np(b.float()), (1e-4, 1e-4))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_bf16_weights(kind):
    np_p, tp = _params(kind, "bfloat16", seed=6)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    jx, tx = _x(10, "bfloat16", seed=7)
    j_out, j_st = _apply(kind, jssm, jp, jx, 4)
    t_out, t_st = _apply(kind, tssm, tp, tx, 4)
    assert t_out.dtype == torch.bfloat16
    _close(t_out, j_out.astype(jnp.float32), BF16_TOL)
    j_y, _ = _step(kind, jssm, jp, j_st, jx[:, -1])
    t_y, _ = _step(kind, tssm, tp, t_st, tx[:, -1])
    _close(t_y, j_y.astype(jnp.float32), BF16_TOL)


def test_init_states_match_the_reference():
    """Shapes, dtypes and values of the three empty states; the sLSTM's
    leaves are distinct tensors (decode writes each in place)."""
    pairs = [
        (tssm.mamba_init_state(B, 16, 4, 8, torch.bfloat16),
         jssm.mamba_init_state(B, 16, 4, 8, jnp.bfloat16)),
        (tssm.mlstm_init_state(B, 16, NH, 4),
         jssm.mlstm_init_state(B, 16, NH, 4)),
        (tssm.slstm_init_state(B, NH, 8), jssm.slstm_init_state(B, NH, 8))]
    for t, j in pairs:
        _close_state(t, j, (0, 0))
    st = pairs[2][0]
    assert len({x.data_ptr() for x in st}) == len(st)
