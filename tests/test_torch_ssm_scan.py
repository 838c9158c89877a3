"""Mamba's chunked associative scan and mLSTM's step-by-step path in the
port (``repro_torch/nn/ssm.py``) against the JAX package's
(``repro/nn/ssm.py``) on the CPU.

- ``mamba_apply``: the output, the final state and the ``jax.grad``
  gradients (every parameter and the input) at chunk lengths 1, 3, 5, 6,
  8 and 12 (odd and even lengths of ``associative_scan``'s recursion),
  T shorter than the chunk, and bf16 weights. The step-by-step form the
  port ran before (``_mamba_stepwise`` below, kept here only as the
  yardstick) is held to the reference too, and each case records both
  largest differences, forward (out and h) and gradients apart
  (``record_property``: ``max_diff_scan`` and ``max_diff_stepwise``).
- The aten ops ``OpCounter(record=True)`` records for ``mamba_apply`` at
  T = chunk = 128: fewer than half of the step-by-step form's.
- ``mlstm_apply(chunkwise=False)`` against the reference's
  ``chunkwise=False`` and ``chunkwise=True``.

Tolerances: ``SSM_TOL`` = 2e-5 absolute + 1e-5 relative (float32),
``BF16_TOL`` 3e-2 plus one bf16 ulp, as ``tests/test_torch_ssm.py``.
"""
import numpy as np
import pytest

from test_torch_common import to_np
from test_torch_ssm import BF16_TOL, NH, SSM_TOL, B, D, _close, \
    _close_state, _params, _x

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.distributed import op_analysis  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

D_STATE = 8


def _mamba_stepwise(p, x, *, d_state, chunk):
    """The recurrence ``h = decay * h + u`` step by step inside each
    chunk: the port's form before the associative scan -> (out, h)."""
    B, T, _ = x.shape
    dI = p["conv_w"].shape[0]
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(tssm.causal_conv1d(xi, p["conv_w"], p["conv_b"]))
    dt, B_, C_ = tssm._mamba_inputs(p, xc, d_state)
    A = -torch.exp(p["A_log"])
    xc32 = xc.float()
    ck = tssm._chunk(T, chunk)
    h = torch.zeros((B, dI, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, T, ck):
        sl = slice(c0, c0 + ck)
        decay = torch.exp(dt[:, sl, :, None] * A)
        u = (dt[:, sl] * xc32[:, sl])[..., None] * B_[:, sl, None, :]
        hs = []
        for t in range(ck):
            h = decay[:, t] * h + u[:, t]
            hs.append(h)
        ys.append(torch.einsum("btds,bts->btd", torch.stack(hs, 1),
                               C_[:, sl]))
    y = torch.cat(ys, dim=1) + p["D"] * xc32
    return (y.to(x.dtype) * F.silu(z)) @ p["out_proj"], h


def _cotangents(T, dI, seed):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, T, D)).astype(np.float32),
            rs.standard_normal((B, dI, D_STATE)).astype(np.float32))


def _ref_grads(jp, jx, chunk, gy, gh):
    """The reference's output, final state and ``jax.grad`` of
    <out, gy> + <h, gh> over the parameters and the input."""
    def f(p, x):
        out, st = jssm.mamba_apply(p, x, d_state=D_STATE, chunk=chunk,
                                   return_state=True)
        return (jnp.sum(out.astype(jnp.float32) * gy)
                + jnp.sum(st.h * gh)), (out, st)
    (_, (out, st)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(jp, jx)
    return out, st, grads


def _port_grads(fn, tp, tx, gy, gh):
    leaves = {k: v.detach().clone().requires_grad_(v.is_floating_point())
              for k, v in tp.items()}
    x = tx.detach().clone().requires_grad_()
    out, h = fn(leaves, x)
    loss = (out.float() * torch.from_numpy(gy)).sum() + \
        (h * torch.from_numpy(gh)).sum()
    names = [k for k, v in leaves.items() if v.requires_grad]
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [x])
    return out, h, dict(zip(names + ["x"], grads))


def _max_diff(port, want):
    return float(np.max(np.abs(to_np(port.float()).astype(np.float64)
                               - np.asarray(want, np.float64))))


@pytest.mark.parametrize("T,chunk", [(24, 1), (24, 3), (20, 5), (24, 6),
                                     (24, 8), (24, 12), (5, 8)])
def test_mamba_scan_holds_the_reference(T, chunk, record_property):
    """Output, final state and gradients within ``SSM_TOL``; T = 5 at
    chunk 8 is one chunk shorter than asked (an odd scan length)."""
    np_p, tp = _params("mamba", "float32", seed=10 + chunk)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    jx, tx = _x(T, "float32", seed=20 + T)
    dI = tp["conv_w"].shape[0]
    gy, gh = _cotangents(T, dI, seed=chunk)
    j_out, j_st, (j_gp, j_gx) = _ref_grads(jp, jx, chunk, gy, gh)

    def scan(p, x):
        out, st = tssm.mamba_apply(p, x, d_state=D_STATE, chunk=chunk,
                                   return_state=True)
        return out, st.h

    def stepwise(p, x):
        return _mamba_stepwise(p, x, d_state=D_STATE, chunk=chunk)

    want = {"out": j_out, "h": j_st.h, "x": j_gx,
            **{f"d{k}": v for k, v in j_gp.items()}}
    worst = {}
    for name, fn in (("scan", scan), ("stepwise", stepwise)):
        out, h, grads = _port_grads(fn, tp, tx, gy, gh)
        got = {"out": out, "h": h, "x": grads["x"],
               **{f"d{k}": v for k, v in grads.items() if k != "x"}}
        assert set(got) == set(want)
        worst[name] = {
            "forward": max(_max_diff(got[k], want[k]) for k in ("out", "h")),
            "gradients": max(_max_diff(got[k], want[k]) for k in want
                             if k not in ("out", "h"))}
        if name == "scan":
            for k in want:
                _close(got[k], want[k], SSM_TOL, k)
            _, t_st = tssm.mamba_apply(tp, tx, d_state=D_STATE, chunk=chunk,
                                       return_state=True)
            _close_state(t_st, j_st)
    record_property("max_diff_scan", worst["scan"])
    record_property("max_diff_stepwise", worst["stepwise"])
    print(f"mamba T={T} chunk={chunk}: max |port - reference| (out and "
          f"h; gradients): scan {worst['scan']}, step by step "
          f"{worst['stepwise']}")


def test_mamba_scan_bf16_weights():
    np_p, tp = _params("mamba", "bfloat16", seed=6)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    jx, tx = _x(20, "bfloat16", seed=7)
    j_out, j_st = jssm.mamba_apply(jp, jx, d_state=D_STATE, chunk=6,
                                   return_state=True)
    t_out, t_st = tssm.mamba_apply(tp, tx, d_state=D_STATE, chunk=6,
                                   return_state=True)
    assert t_out.dtype == torch.bfloat16
    _close(t_out, j_out.astype(jnp.float32), BF16_TOL)
    _close_state(t_st, j_st, BF16_TOL)


def test_associative_scan_is_the_inclusive_scan():
    """Integer sums (exact in any order) at every length up to 17: each
    position is the sum of the first ones."""
    for n in range(1, 18):
        x = torch.arange(1, 3 * n + 1, dtype=torch.float64).reshape(3, n)
        (got,) = tssm.associative_scan(lambda a, b: (a[0] + b[0],), (x,), 1)
        assert torch.equal(got, torch.cumsum(x, 1)), n


def _recorded_ops(fn):
    with op_analysis.OpCounter(record=True) as c:
        fn()
    return sum(r[5] for r in c.rows())


def test_mamba_scan_records_under_half_the_stepwise_ops():
    """At T = chunk = 128 the step-by-step form records ~2 x 128 ops in
    its scan alone; the associative scan ~log2(128) levels of a few."""
    _, tp = _params("mamba", "float32", seed=3)
    _, tx = _x(128, "float32", seed=4)
    scan = _recorded_ops(lambda: tssm.mamba_apply(tp, tx, d_state=D_STATE,
                                                  chunk=128))
    step = _recorded_ops(lambda: _mamba_stepwise(tp, tx, d_state=D_STATE,
                                                 chunk=128))
    print(f"aten ops recorded at T = chunk = 128: scan {scan}, step by "
          f"step {step}")
    assert step > 2 * 128
    assert scan < step / 2, (scan, step)


@pytest.mark.parametrize("T,chunk", [(20, 8), (24, 8), (3, 8)])
def test_mlstm_stepwise_holds_the_reference(T, chunk):
    """``chunkwise=False`` against the reference's recurrent scan and its
    chunkwise form: output and final state."""
    np_p, tp = _params("mlstm", "float32", seed=T)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    jx, tx = _x(T, "float32", seed=T + 1)
    t_out, t_st = tssm.mlstm_apply(tp, tx, NH, chunk=chunk,
                                   return_state=True, chunkwise=False)
    for chunkwise in (False, True):
        j_out, j_st = jssm.mlstm_apply(jp, jx, NH, chunk=chunk,
                                       return_state=True,
                                       chunkwise=chunkwise)
        _close(t_out, j_out, what=f"out, reference chunkwise={chunkwise}")
        _close_state(t_st, j_st)
    # the port's two forms agree with each other as well
    c_out = tssm.mlstm_apply(tp, tx, NH, chunk=chunk)
    _close(t_out, to_np(c_out), what="port chunkwise vs step by step")
