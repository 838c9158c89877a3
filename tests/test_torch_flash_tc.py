"""The numerical design of the tensor-core flash-attention kernel
(``repro_torch/kernels/csrc/flash_wgmma.cu``), held on the CPU.

The kernel cannot run here, so its rounding points are emulated in plain
torch below (``tc_emulate``): bf16 q, k, v; the products ``q k^T`` and
``p v`` of bf16 values summed in f32 (exact products, as ``wgmma`` forms
them); the scale applied after ``q k^T``; the online softmax over key
tiles of the kernel's width in f32 with the reference's constants; p split
into ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, both multiplied by V; l
summed from the f32 p; one bf16 rounding of the output. The emulation is
held against the JAX Pallas kernel in interpret mode (through the JAX
``ops.flash_attention_mha`` wrapper, which repeats KV heads) and against
the port's plain version ``ref.flash_attention_mha_ref``, at the
tolerance ``chip_smoke.py`` holds the kernel to on the card: 1e-4 plus one
bf16 ulp of the value (2^-7 |ref|). On a row whose output cancels (v = +1
and -1 on alternate keys) a single bf16 rounding of p exceeds that bound,
which is why the kernel splits p. The routing rule that sends a call to
the tensor-core kernel is tested here too. Inputs are made with numpy
from a seed."""
import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ATOL = 1e-4            # chip_smoke.LAYER_TOL["flash_attention"][1]
RTOL = 2.0 ** -7       # one bf16 ulp of the value
NEG_INF = -1e30


def key_tile(Dv):
    """The kernel's keys per tile (``flash_wgmma.cu::launch_tc``), from Dv
    padded to 64, 128 or 256: the registers of S, P and O."""
    return 64 if Dv <= 128 else 32


def tc_emulate(q, k, v, *, causal, scale=None, split=True):
    """The tensor-core kernel's arithmetic on CPU tensors: q (B, T, H, D),
    k, v (B, S, KH, D[v]) bf16 -> (B, T, H, Dv) bf16. ``split=False``
    rounds p once to bf16 instead (the textbook tensor-core kernel)."""
    B, T, H, D = q.shape
    S, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = D ** -0.5 if scale is None else scale
    bk = key_tile(Dv)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    m = torch.full((B, H, T), NEG_INF)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, Dv))
    rows = torch.arange(T)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        if split:
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            pv = hi @ vt + lo @ vt
        else:
            pv = p.bfloat16().float() @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / l.clamp_min(1e-20)[..., None]).bfloat16()
    return out.permute(0, 2, 1, 3)


def _bf16_pair(a):
    """float32 numpy -> (JAX bf16 array, CPU bf16 tensor), each rounded by
    its own framework (both round to nearest even)."""
    return (jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).bfloat16())


def _f32(x):
    """A tensor or a JAX / numpy array -> a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(np.asarray(x, np.float32))


def _excess(got, want):
    """How far ``got`` lies outside 1e-4 + 2^-7 |want| (<= 0: inside)."""
    g, w = _f32(got), _f32(want)
    return float(((g - w).abs() - (ATOL + RTOL * w.abs())).max())


def _cancel_inputs(rng, B, T, S, H, KH, D, Dv):
    """Scores of one spread and v = +1, -1 on alternate keys: each output
    is a small difference of two near-equal sums."""
    q = (0.3 * rng.standard_normal((B, T, H, D))).astype(np.float32)
    k = (0.3 * rng.standard_normal((B, S, KH, D))).astype(np.float32)
    sign = np.where(np.arange(S) % 2 == 0, 1.0, -1.0).astype(np.float32)
    v = np.broadcast_to(sign[None, :, None, None], (B, S, KH, Dv)).copy()
    return q, k, v


# (B, T, S, H, KH, D, Dv, causal, bq, bk): the Pallas blocks divide T, S
CASES = {
    "causal": (1, 128, 128, 2, 2, 64, 64, True, 128, 128),
    "non-causal": (1, 128, 128, 2, 2, 64, 64, False, 128, 128),
    "GQA group 4": (1, 128, 128, 8, 2, 64, 64, True, 128, 128),
    "ragged T = S = 200": (1, 200, 200, 2, 1, 64, 64, True, 40, 40),
    "cross T 64, S 384": (1, 64, 384, 2, 2, 32, 32, False, 64, 128),
    "D 64, Dv 128": (1, 128, 128, 2, 1, 64, 128, True, 128, 128),
    "D = Dv = 256": (1, 96, 160, 1, 1, 256, 256, True, 32, 32),
    "cancellation": (1, 64, 8, 2, 1, 64, 64, False, 64, 8),
}


@pytest.mark.parametrize("label", list(CASES))
def test_tc_design_matches_pallas_and_plain(label):
    B, T, S, H, KH, D, Dv, causal, bq, bk = CASES[label]
    rng = np.random.default_rng(sum(map(ord, label)))
    if label == "cancellation":
        q, k, v = _cancel_inputs(rng, B, T, S, H, KH, D, Dv)
    else:
        q, k, v = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((B, T, H, D), (B, S, KH, D),
                                 (B, S, KH, Dv)))
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    got = tc_emulate(tq, tk, tv, causal=causal)
    assert got.shape == (B, T, H, Dv) and got.dtype == torch.bfloat16
    pallas = jops.flash_attention_mha(jq, jk, jv, causal=causal, bq=bq,
                                      bk=bk)
    plain = ref.flash_attention_mha_ref(tq, tk, tv, causal=causal)
    assert _excess(got, pallas.astype(jnp.float32)) <= 0
    assert _excess(got, plain) <= 0


def test_one_rounding_of_p_fails_where_the_split_holds():
    """The split's reason: on the cancelling rows a single bf16 rounding
    of p misses the bound that the hi/lo split meets."""
    B, T, S, H, KH, D, Dv = 1, 64, 8, 2, 1, 64, 64
    rng = np.random.default_rng(sum(map(ord, "cancellation")))
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _cancel_inputs(rng, B, T, S, H, KH, D, Dv))
    plain = ref.flash_attention_mha_ref(tq, tk, tv, causal=False)
    split = tc_emulate(tq, tk, tv, causal=False)
    once = tc_emulate(tq, tk, tv, causal=False, split=False)
    assert _excess(split, plain) <= 0
    assert _excess(once, plain) > 0


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 128, 128, True),     # qwen3_4b
    (torch.bfloat16, 64, 128, True),
    (torch.bfloat16, 16, 16, True),
    (torch.bfloat16, 256, 256, True),
    (torch.bfloat16, 256, 48, True),
    (torch.float32, 128, 128, False),     # f32: the CUDA-core kernel
    (torch.float32, 64, 64, False),
    (torch.bfloat16, 40, 128, False),     # D not a multiple of 16
    (torch.bfloat16, 128, 72, False),     # Dv not a multiple of 16
    (torch.bfloat16, 8, 8, False),
    (torch.bfloat16, 272, 128, False),    # above 256
])
def test_tensor_core_route_is_a_function_of_dtype_and_widths(dtype, D, Dv,
                                                             want):
    assert tfa.tensor_core_route(dtype, D, Dv) is want
