"""The port's layer ops against the JAX package on the CPU: the three
Pallas kernels (``gru_sequence``, ``rmsnorm``, ``flash_attention``, run in
interpret mode as ``tests/test_kernels.py`` runs them) and their XLA-path
``nn`` counterparts, against ``repro_torch.kernels.ops`` (whose CPU route
is the plain version in ``kernels/ref.py``), the plain versions and the
port's ``nn`` functions; the Pallas block rule; the CUDA wrappers'
refusal of CPU tensors; and ``convert.array_to_torch`` on bf16 and
float16 arrays.

Inputs are made with numpy from a seed; bf16 inputs are rounded by each
framework from the same float32 arrays. Tolerances are the reference
tests' own where they exist (flash 2e-5 f32 / 2e-2 bf16; GRU 1e-5 f32 /
3e-2 bf16; rmsnorm 1e-2), plus, for bf16 outputs, one bf16 ulp of the
value (``rtol`` 2**-7): the two frameworks reduce a row or a dot product
in another order, so a float32 result may straddle a bf16 rounding
boundary and round one ulp apart. f32 RMSNorm is held to 1e-5."""
import numpy as np
import pytest

from test_torch_common import FWD_ATOL, to_np, to_t

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jfa  # noqa
from repro.kernels.gru import gru_sequence as jgru  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jrms  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import module as jmod  # noqa: E402
from repro.nn import rnn as jrnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import aip_step as cuda_build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import gru as tgru  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import module as tmod  # noqa: E402
from repro_torch.nn import rnn as trnn  # noqa: E402

BF16_RTOL = 2.0 ** -7
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRU_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _pair(a, dtype):
    """One float32 numpy array -> (JAX array, CPU tensor) of ``dtype``,
    each rounded by its own framework."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                               dtype))
    return j, t


def _close(port, want, atol, dtype="float32"):
    np.testing.assert_allclose(
        to_np(port.float()), np.asarray(want).astype(np.float32), atol=atol,
        rtol=BF16_RTOL if dtype == "bfloat16" else 0)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,S,D,causal,dtype", [
    (128, 128, 64, True, "float32"),
    (128, 128, 64, False, "float32"),
    (256, 256, 128, True, "float32"),
    (128, 256, 64, False, "float32"),     # cross-attention shape (T != S)
    (128, 128, 64, True, "bfloat16"),
])
def test_flash_attention_matches_the_pallas_kernel(T, S, D, causal, dtype):
    rng = np.random.default_rng(T + S + D + causal)
    BH = 4
    jq, tq = _pair(_randn(rng, BH, T, D), dtype)
    jk, tk = _pair(_randn(rng, BH, S, D), dtype)
    jv, tv = _pair(_randn(rng, BH, S, D), dtype)
    want = jfa(jq, jk, jv, causal=causal, bq=128, bk=128, interpret=True)
    tol = FLASH_TOL[dtype]
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert plain.dtype == tq.dtype
    _close(plain, want, tol, dtype)
    # the ops entry point with one head per batch row is the same function
    got = ops.flash_attention_mha(tq[:, :, None], tk[:, :, None],
                                  tv[:, :, None], causal=causal)
    _close(got[:, :, 0], want, tol, dtype)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 32), (32, 128)])
def test_flash_attention_block_shapes(bq, bk):
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 256, 64)
    jx, tx = _pair(x, "float32")
    want = jfa(jx, jx, jx, causal=True, bq=bq, bk=bk, interpret=True)
    got = ops.flash_attention_mha(tx[:, :, None], tx[:, :, None],
                                  tx[:, :, None], causal=True, bq=bq, bk=bk)
    _close(got[:, :, 0], want, FLASH_TOL["float32"])


@pytest.mark.parametrize("T,S,H,KH,D,Dv,causal,dtype", [
    (128, 128, 8, 2, 64, 64, True, "float32"),    # test_kernels.py's case
    (64, 128, 4, 4, 32, 32, False, "float32"),    # T != S, plain MHA
    (64, 64, 6, 2, 32, 16, True, "float32"),      # Dv != D
    (128, 128, 4, 1, 64, 64, True, "bfloat16"),   # MQA in bf16
])
def test_flash_attention_mha_matches_jax_ops(T, S, H, KH, D, Dv, causal,
                                             dtype):
    rng = np.random.default_rng(H * 10 + KH)
    jq, tq = _pair(_randn(rng, 2, T, H, D), dtype)
    jk, tk = _pair(_randn(rng, 2, S, KH, D), dtype)
    jv, tv = _pair(_randn(rng, 2, S, KH, Dv), dtype)
    want = jops.flash_attention_mha(jq, jk, jv, causal=causal)
    got = ops.flash_attention_mha(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, T, H, Dv) and got.dtype == tq.dtype
    _close(got, want, FLASH_TOL[dtype], dtype)


@pytest.mark.parametrize("T,S,bq,bk", [
    (100, 128, 64, 64),     # T % bq
    (128, 96, 128, 64),     # S % bk
    (128, 128, 48, 128),    # T % bq with bq < T
])
def test_flash_attention_refuses_what_the_pallas_kernel_refuses(T, S, bq,
                                                                 bk):
    q = np.zeros((1, T, 16), np.float32)
    kv = np.zeros((1, S, 16), np.float32)
    with pytest.raises(AssertionError):
        jfa(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), bq=bq, bk=bk,
            interpret=True)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        ops.flash_attention_mha(torch.zeros(1, T, 1, 16),
                                torch.zeros(1, S, 1, 16),
                                torch.zeros(1, S, 1, 16), bq=bq, bk=bk)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tfa.check_blocks(T, S, bq, bk)


def test_flash_attention_blocks_clip_to_the_sequence():
    """``min(bq, T)`` and ``min(bk, S)``: short sequences take any block."""
    rng = np.random.default_rng(5)
    jq, tq = _pair(_randn(rng, 1, 32, 16), "float32")
    jk, tk = _pair(_randn(rng, 1, 48, 16), "float32")
    want = jfa(jq, jk, jk, causal=False, bq=128, bk=128, interpret=True)
    got = ops.flash_attention_mha(tq[:, :, None], tk[:, :, None],
                                  tk[:, :, None], causal=False)
    _close(got[:, :, 0], want, FLASH_TOL["float32"])


@pytest.mark.parametrize("n,want", [(1500, 1024), (1024, 1024), (100, 1024),
                                    (4096, 1024), (1000, 64), (97, 8)])
def test_pick_chunk_matches_jax(n, want):
    assert tatt._pick_chunk(n, want) == jatt._pick_chunk(n, want)


@pytest.mark.parametrize("case", [
    dict(T=128, S=128, H=4, KH=2, D=32, Dv=32, causal=True),
    dict(T=64, S=96, H=4, KH=4, D=16, Dv=16, causal=False),
    dict(T=32, S=96, H=2, KH=1, D=16, Dv=16, causal=True, q_offset=64),
    dict(T=64, S=64, H=4, KH=2, D=32, Dv=8, causal=True),
    dict(T=128, S=128, H=4, KH=2, D=32, Dv=32, causal=True,
         dtype="bfloat16"),
    dict(T=128, S=128, H=4, KH=2, D=32, Dv=32, causal=True,
         dtype="bfloat16", p_bf16=False),
    dict(T=1500, S=1500, H=2, KH=1, D=16, Dv=16, causal=True),  # chunk 750
    dict(T=96, S=96, H=2, KH=2, D=16, Dv=16, causal=True, q_chunk=32,
         k_chunk=48),
], ids=["gqa", "cross", "q_offset", "dv_ne_d", "bf16_p_bf16", "bf16_p_f32",
        "pick_chunk_1500", "chunks"])
def test_nn_flash_attention_matches_jax(case):
    c = dict(case)
    T, S, H, KH, D, Dv = (c.pop(n) for n in ("T", "S", "H", "KH", "D",
                                              "Dv"))
    dtype = c.pop("dtype", "float32")
    rng = np.random.default_rng(T + S + Dv)
    jq, tq = _pair(_randn(rng, 1, T, H, D), dtype)
    jk, tk = _pair(_randn(rng, 1, S, KH, D), dtype)
    jv, tv = _pair(_randn(rng, 1, S, KH, Dv), dtype)
    want = jatt.flash_attention(jq, jk, jv, **c)
    got = tatt.flash_attention(tq, tk, tv, **c)
    assert tuple(got.shape) == (1, T, H, Dv) and got.dtype == tq.dtype
    # the XLA path is the same math as the oracle: f32 to the forward
    # tolerance of every parity file, bf16 as the flash kernel
    _close(got, want, FWD_ATOL if dtype == "float32" else FLASH_TOL[dtype],
           dtype)


def test_nn_flash_attention_matches_the_fused_route():
    """The XLA path and the ops entry point compute one function."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_randn(rng, 2, 64, 4, 32))
    k = torch.from_numpy(_randn(rng, 2, 64, 2, 32))
    v = torch.from_numpy(_randn(rng, 2, 64, 2, 32))
    a = tatt.flash_attention(q, k, v, q_chunk=16, k_chunk=32)
    b = ops.flash_attention_mha(q, k, v)
    np.testing.assert_allclose(to_np(a), to_np(b), atol=FLASH_TOL["float32"],
                               rtol=0)


# ---------------------------------------------------------------------------
# GRU sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,D,H,dtype", [
    (4, 20, 24, 32, "float32"),
    (1, 1, 8, 16, "float32"),
    (8, 64, 40, 64, "float32"),
    (2, 16, 12, 32, "bfloat16"),
])
def test_gru_sequence_matches_the_pallas_kernel(B, T, D, H, dtype):
    rng = np.random.default_rng(B * 100 + T)
    jwx, twx = _pair(_randn(rng, D, 3 * H, scale=0.2), dtype)
    jwh, twh = _pair(_randn(rng, H, 3 * H, scale=0.2), dtype)
    jb, tb = _pair(_randn(rng, 3 * H, scale=0.1), dtype)
    jx, tx = _pair(_randn(rng, B, T, D), dtype)
    jh0, th0 = _pair(_randn(rng, B, H, scale=0.5), dtype)
    hs_k, hT_k = jgru(jx, jwx, jwh, jb, jh0, interpret=True)
    hs_r, hT_r = jref.gru_sequence_ref(jx, jwx, jwh, jb, jh0)
    tol = GRU_TOL[dtype]
    p = {"wx": twx, "wh": twh, "b": tb}
    hs, hT = ops.gru_sequence(p, tx, th0)
    assert hs.dtype == tx.dtype and tuple(hs.shape) == (B, T, H)
    _close(hs, hs_k, tol, dtype)
    _close(hT, hT_k, tol, dtype)
    # the plain version is the reference's oracle, dtype for dtype
    hs_p, hT_p = ref.gru_sequence_ref(tx, twx, twh, tb, th0)
    _close(hs_p, hs_r, tol, dtype)
    _close(hT_p, hT_r, tol, dtype)


def test_gru_sequence_is_a_drop_in_for_nn_rnn():
    """ops.gru_sequence with h0=None is nn.rnn.gru_sequence, on both
    sides (test_kernels.py::test_gru_kernel_matches_nn_rnn's case)."""
    jp = jrnn.gru_init(jax.random.PRNGKey(10), 16, 32)
    jp = {**jp, "b": jnp.asarray(
        np.random.default_rng(1).standard_normal(96).astype(np.float32)
        * 0.1)}
    x = np.random.default_rng(2).standard_normal((3, 12, 16)).astype(
        np.float32)
    want, want_T = jrnn.gru_sequence(jp, jnp.asarray(x))
    tp = to_t(jp)
    tx = torch.from_numpy(x)
    for hs, hT in (ops.gru_sequence(tp, tx), trnn.gru_sequence(tp, tx)):
        _close(hs, want, GRU_TOL["float32"])
        _close(hT, want_T, GRU_TOL["float32"])
    jk, _ = jops.gru_sequence(jp, jnp.asarray(x))
    _close(ops.gru_sequence(tp, tx)[0], jk, GRU_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nn_gru_sequence_matches_jax(dtype):
    rng = np.random.default_rng(21)
    B, T, D, H = 3, 10, 6, 8
    jp = {"wx": _randn(rng, D, 3 * H, scale=0.3),
          "wh": _randn(rng, H, 3 * H, scale=0.3),
          "b": _randn(rng, 3 * H, scale=0.1)}
    pairs = {n: _pair(w, dtype) for n, w in jp.items()}
    jx, tx = _pair(_randn(rng, B, T, D), dtype)
    jh0, th0 = _pair(_randn(rng, B, H, scale=0.5), dtype)
    want, want_T = jrnn.gru_sequence({n: j for n, (j, _) in pairs.items()},
                                     jx, jh0)
    got, got_T = trnn.gru_sequence({n: t for n, (_, t) in pairs.items()},
                                   tx, th0)
    assert got.dtype == tx.dtype
    _close(got, want, GRU_TOL[dtype], dtype)
    _close(got_T, want_T, GRU_TOL[dtype], dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

RMS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("N,d,dtype", [
    (256, 128, "float32"),
    (1000, 512, "float32"),     # N not divisible by the Pallas row block
    (64, 256, "bfloat16"),
])
def test_rmsnorm_matches_the_pallas_kernel(N, d, dtype):
    rng = np.random.default_rng(N + d)
    jx, tx = _pair(_randn(rng, N, d), dtype)
    g = _randn(rng, d)
    want = jrms(jx, jnp.asarray(g), interpret=True)
    for got in (ops.rmsnorm(tx, torch.from_numpy(g)),
                ref.rmsnorm_ref(tx, torch.from_numpy(g))):
        assert got.dtype == tx.dtype
        _close(got, want, RMS_TOL[dtype], dtype)


def test_rmsnorm_ops_takes_any_leading_shape():
    rng = np.random.default_rng(4)
    x, g = _randn(rng, 2, 3, 5, 64), _randn(rng, 64)
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(g))
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), eps=1e-6)
    assert tuple(got.shape) == x.shape
    _close(got, want, RMS_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_two_rmsnorm_orders_each_match_their_counterpart(dtype):
    """nn.module.rmsnorm rounds to x's dtype BEFORE the multiply by g;
    the kernel (ops.rmsnorm) multiplies in float32 and rounds once. Each
    port function matches its own JAX counterpart; in bf16 the two orders
    give different bits."""
    rng = np.random.default_rng(17)
    jx, tx = _pair(_randn(rng, 64, 256, scale=3.0), dtype)
    jg, tg = _pair(_randn(rng, 256), dtype)
    want_nn = jmod.rmsnorm({"g": jg}, jx)
    want_ops = jops.rmsnorm(jx, jg)
    got_nn = tmod.rmsnorm({"g": tg}, tx)
    got_ops = ops.rmsnorm(tx, tg)
    assert got_nn.dtype == got_ops.dtype == tx.dtype
    _close(got_nn, want_nn, RMS_TOL[dtype], dtype)
    _close(got_ops, want_ops, RMS_TOL[dtype], dtype)
    if dtype == "bfloat16":
        assert not np.array_equal(np.asarray(want_nn, np.float32),
                                  np.asarray(want_ops, np.float32))
        assert not torch.equal(got_nn, got_ops)


def test_rmsnorm_init_matches_jax():
    p = tmod.rmsnorm_init(12, dtype=torch.bfloat16, device="cpu")
    jp = jmod.rmsnorm_init(12, dtype=jnp.bfloat16)
    assert p["g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(p["g"].float()),
                                  np.asarray(jp["g"], np.float32))


# ---------------------------------------------------------------------------
# the CUDA routes and the dispatch
# ---------------------------------------------------------------------------

def test_ops_on_cpu_tensors_launch_no_kernel():
    cuda_build.reset_launches()
    x = torch.zeros(2, 8, 1, 16)
    ops.flash_attention_mha(x, x, x)
    ops.gru_sequence({"wx": torch.zeros(16, 12), "wh": torch.zeros(4, 12),
                      "b": torch.zeros(12)}, torch.zeros(2, 8, 16))
    ops.rmsnorm(torch.ones(3, 16), torch.ones(16))
    assert all(n == 0 for n in cuda_build.LAUNCHES.values())
    assert {"gru_sequence", "rmsnorm", "flash_attention"} <= set(
        cuda_build.LAUNCHES)


@pytest.mark.parametrize("route", ["gru", "rmsnorm", "flash", "flash_mha"])
def test_cuda_routes_refuse_cpu_tensors(route):
    """The kernel wrappers take CUDA tensors only (no quiet CPU run)."""
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if route == "gru":
            tgru.gru_sequence(x, torch.zeros(16, 12), torch.zeros(4, 12),
                              torch.zeros(12), torch.zeros(2, 4))
        elif route == "rmsnorm":
            trms.rmsnorm(x[0], torch.ones(16))
        elif route == "flash":
            tfa.flash_attention(x, x, x)
        else:
            tfa.flash_attention_mha(x[:, :, None], x[:, :, None],
                                    x[:, :, None])


def test_flash_attention_mha_refuses_heads_not_in_groups():
    x = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="KV heads"):
        tfa.flash_attention_mha(x, kv, kv)


# ---------------------------------------------------------------------------
# convert.py: bf16 and float16 carried across
# ---------------------------------------------------------------------------

def test_convert_carries_bf16_bits_across():
    a = np.random.default_rng(0).standard_normal(257).astype(np.float32)
    a[:4] = [0.0, -0.0, np.inf, 1e-40]
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = convert.array_to_torch(j, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(t.view(torch.int16)),
                                  np.asarray(j).view(np.int16))
    np.testing.assert_array_equal(
        to_np(t.float()), np.asarray(j).astype(ml_dtypes.bfloat16).astype(
            np.float32))


@pytest.mark.parametrize("dtype,want", [("float16", torch.float16),
                                        ("float32", torch.float32),
                                        ("float64", torch.float32)])
def test_convert_float_widths(dtype, want):
    a = np.array([1.5, -2.25, 65504.0, 6e-8], dtype=dtype)
    t = convert.array_to_torch(a, device="cpu")
    assert t.dtype == want
    np.testing.assert_array_equal(to_np(t), a.astype(to_np(t).dtype))
    if dtype == "float16":
        np.testing.assert_array_equal(to_np(t.view(torch.int16)),
                                      a.view(np.int16))
