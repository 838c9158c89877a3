"""The design of the CUDA-core flash-attention kernel
(``repro_torch/kernels/csrc/flash_f32.cu``), held on the CPU.

The kernel cannot run here, so what can be held without the card is:
- its launch plan, ``flash_attention.f32_plan``: it fits the 227 KB of
  shared memory a block may use at every D, Dv <= 256; up to D = Dv = 128
  it takes 128 query rows a block and a register tile of 8 x 4 scores a
  lane (8 warps an SM: two blocks of 128 query rows do not fit beside
  their K and V tiles in float32), and 64-row blocks, two an SM, where
  128-row ones would leave SMs idle; it refuses the plans the kernel is
  not built for;
- the key tiles the kernel walks and the ones it runs the mask test on
  (``f32_tiles``): exactly the tiles that cross the diagonal or S, against
  a brute-force count over every (row, key) pair, T = 1, cross attention
  (S > T) and ragged Dv < D included;
- its order of operations, emulated in plain torch (``f32_emulate``): q
  scaled before ``q k^T`` (rounded once, as ``__fmul_rn``), key tiles of
  the plan's width walked as ``f32_tiles`` gives them, the mask on the
  marked tiles only, the online softmax per tile with the reference's
  constants, one rounding of the output. The emulation is held against
  the JAX Pallas kernel in interpret mode (through the JAX
  ``ops.flash_attention_mha``, which repeats KV heads) and against the
  port's plain version ``ref.flash_attention_mha_ref``, at the tolerance
  ``chip_smoke.py`` holds the kernel to on the card: 2e-5 in float32.
Inputs are made with numpy from a seed."""
import ctypes

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ATOL = 2e-5            # chip_smoke.LAYER_TOL["flash_attention"][0]
NEG_INF = -1e30
WIDTHS = [(1, 1), (4, 4), (32, 16), (40, 40), (64, 32), (64, 64),
          (96, 128), (128, 128), (129, 64), (160, 160), (256, 48),
          (256, 256)]


@pytest.mark.parametrize("D,Dv", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_plan_fits_and_takes_8x4_tiles(D, Dv, dtype):
    p = tfa.f32_plan(4096, 4096, D, Dv, dtype)
    assert p.smem == tfa.f32_smem(p.rows, p.keys, D, Dv, p.stages)
    assert p.smem <= tfa.F32_SMEM_MAX == 232_448
    assert (p.rows, p.keys, p.threads) in tfa.F32_CONFIGS
    assert p.stages in (2, 3)
    assert p.blocks_per_sm >= 1
    warp_rows = p.rows // (p.threads // 32)
    if max(D, Dv) <= 128:
        # 128 query rows a block, a lane 8 rows x 4 keys of the scores
        assert (p.rows, p.keys, p.threads) == (128, 64, 256)
        assert warp_rows // 2 == 8 and p.keys // 16 == 4
        assert p.warps_per_sm >= 8
        # 64-row blocks at the same widths: two an SM, 16 warps
        assert tfa.f32_plan(4096, 4096, D, Dv, dtype,
                            rows=64).warps_per_sm >= 16
    else:
        assert p.rows == 64
    # each warp owns an even number of rows, a lane a multiple of 4 rows
    # and 2 or 4 keys of the score tile
    assert warp_rows % 2 == 0 and (warp_rows // 2) % 4 == 0
    assert p.keys % tfa.F32_CHUNK == 0


def test_f32_plan_fits_at_every_width():
    """Every D, Dv <= 256 has a plan inside 227 KB, and every D, Dv <= 128
    keeps 8 warps an SM at 128 rows and 16 at 64 rows."""
    for D in range(1, 257):
        for Dv in range(1, 257, 5):
            p = tfa.f32_plan(512, 512, D, Dv)
            assert p.smem <= tfa.F32_SMEM_MAX
            if max(D, Dv) <= 128:
                assert p.warps_per_sm >= 8
                for kw in (dict(rows=64), dict(heads=1)):
                    q = tfa.f32_plan(512, 512, D, Dv, **kw)
                    assert q.smem <= tfa.F32_SMEM_MAX
                    assert q.warps_per_sm >= 16


def test_f32_plan_smem_counts_the_kernels_regions():
    """The q tile at an odd number of 16-byte vectors a row, the ring of
    (K, V) stages with Dv padded to 64, the p chunk: at the qwen3_4b
    widths 217,600 bytes with two stages."""
    assert tfa.qk_stride(128) == 132 and tfa.qk_stride(64) == 68
    assert tfa.qk_stride(40) == 44 and tfa.qk_stride(44) == 44
    assert tfa.qk_stride(1) == 4 and tfa.qk_stride(256) == 260
    for D in range(1, 257):
        s = tfa.qk_stride(D)
        assert s >= D and s % 4 == 0 and (s // 4) % 2 == 1
    p = tfa.f32_plan(4096, 4096, 128, 128)
    assert (p.rows, p.keys, p.threads, p.stages) == (128, 64, 256, 2)
    assert p.smem == 4 * (128 * 132 + 2 * (64 * 132 + 64 * 128)
                          + 32 * 132) == 217_600
    # the bench shape (D 64) takes three stages
    assert tfa.f32_plan(512, 512, 64, 64).stages == 3


@pytest.mark.parametrize("kw,match", [
    (dict(rows=32), "no kernel"),
    (dict(rows=256), "no kernel"),
    (dict(stages=4), "stages"),
    (dict(stages=3, D=256, Dv=256), "shared bytes"),
    (dict(rows=128, D=64, Dv=256), "Dv"),
    (dict(D=257), "D=257"),
    (dict(T=0), "T=0"),
])
def test_f32_plan_refuses_what_the_kernel_cannot_run(kw, match):
    dims = dict(T=256, S=256, D=64, Dv=64)
    dims.update({k: kw.pop(k) for k in list(kw) if k in dims})
    with pytest.raises(ValueError, match=match):
        tfa.f32_plan(dims["T"], dims["S"], dims["D"], dims["Dv"], **kw)


def test_f32_plan_overrides_for_the_ablation():
    """The 64-row build keeps two blocks an SM at D = 128 (two stages),
    a lane 4 rows x 2 keys of the score tile; 128 rows at the bench shape
    (where the plan takes 64) keep three stages; the other ring depth."""
    p = tfa.f32_plan(4096, 4096, 128, 128, rows=64)
    assert (p.rows, p.keys, p.threads, p.stages) == (64, 32, 256, 2)
    assert p.blocks_per_sm == 2 and p.warps_per_sm == 16
    assert p.rows // (p.threads // 32) // 2 == 4 and p.keys // 16 == 2
    p = tfa.f32_plan(512, 512, 64, 64, heads=16, rows=128)
    assert (p.rows, p.keys, p.threads, p.stages) == (128, 64, 256, 3)
    p = tfa.f32_plan(512, 512, 64, 64, stages=2)
    assert p.stages == 2 and p.smem == tfa.f32_smem(128, 64, 64, 64, 2)


@pytest.mark.parametrize("T,heads,rows", [
    (4096, 32, 128),      # qwen3_4b: 1,024 blocks of 128 rows
    (512, 16, 64),        # the bench shape: 64 blocks of 128 would idle
    (512, 33, 128),       # 132 blocks of 128 rows: one a SM
    (512, 32, 64),
    (128, 4, 64),
    (1, 4, 64),
])
def test_f32_plan_takes_64_rows_where_128_would_idle_sms(T, heads, rows):
    p = tfa.f32_plan(T, T, 64, 64, heads=heads)
    assert p.rows == rows
    assert tfa.f32_plan(T, T, 256, 256, heads=heads).rows == 64


# (T, S, causal, D, Dv)
TILE_CASES = [
    (4096, 4096, True, 128, 128),     # qwen3_4b
    (512, 512, True, 64, 64),         # the bench shape
    (200, 200, True, 40, 40),         # ragged T = S
    (1, 128, False, 64, 64),          # T = 1
    (1, 128, True, 64, 64),
    (128, 384, False, 64, 64),        # cross attention, S > T
    (128, 384, True, 64, 64),
    (96, 160, True, 64, 32),          # ragged Dv < D, S > T
    (300, 100, True, 64, 64),         # S < T
    (100, 300, True, 256, 256),       # 64-row blocks, 32-key tiles
    (130, 70, False, 256, 96),
]


@pytest.mark.parametrize("T,S,causal,D,Dv", TILE_CASES)
def test_f32_tiles_mask_exactly_the_crossing_tiles(T, S, causal, D, Dv):
    p = tfa.f32_plan(T, S, D, Dv)
    tiles = tfa.f32_tiles(p, causal)
    rows = np.arange(T)[:, None]
    keys = np.arange(-(-S // p.keys) * p.keys)[None, :]
    # (row, key) pairs whose score the mask sets: past S, or above the
    # diagonal
    masked = (keys >= S) | ((keys > rows) if causal else (rows < 0))
    seen = set()
    for qb, kt, mask in tiles:
        r0, k0 = qb * p.rows, kt * p.keys
        block = masked[r0:min(r0 + p.rows, T), k0:k0 + p.keys]
        assert block.size > 0
        assert mask == bool(block.any()), (qb, kt)
        seen.add((qb, kt))
    # every tile with an unmasked pair is walked
    for qb in range(p.q_tiles):
        r0 = qb * p.rows
        for kt in range(-(-S // p.keys)):
            k0 = kt * p.keys
            block = masked[r0:min(r0 + p.rows, T), k0:k0 + p.keys]
            if not block.all():
                assert (qb, kt) in seen, (qb, kt)
    if causal:
        # tiles wholly above the diagonal are skipped
        assert all(kt * p.keys < qb * p.rows + p.rows for qb, kt, _ in tiles)
    # the mask test runs on the diagonal tiles and the one crossing S:
    # at most two (three at a ragged S) per query block of 128 rows
    per_block = {}
    for qb, _, mask in tiles:
        per_block[qb] = per_block.get(qb, 0) + mask
    assert max(per_block.values()) <= (p.rows // p.keys + 1 if causal
                                       else 1)


def f32_emulate(q, k, v, *, causal, scale=None, plan=None):
    """The CUDA-core kernel's order on CPU tensors: q (B, T, H, D), k, v
    (B, S, KH, D[v]) float32 or bf16 -> (B, T, H, Dv) in q's dtype. Each
    query block walks the key tiles of ``f32_tiles`` in order; the mask
    (past S, above the diagonal) on the marked tiles only, p = 0 under
    it; float32 throughout."""
    B, T, H, D = q.shape
    S, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = D ** -0.5 if scale is None else scale
    plan = plan or tfa.f32_plan(T, S, D, Dv, q.dtype)
    qf = q.float().permute(0, 2, 1, 3) * torch.tensor(scale,
                                                      dtype=torch.float32)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.zeros((B, H, T, Dv))
    tiles = {}
    for qb, kt, mask in tfa.f32_tiles(plan, causal):
        tiles.setdefault(qb, []).append((kt, mask))
    for qb, walk in tiles.items():
        r0, r1 = qb * plan.rows, min(T, (qb + 1) * plan.rows)
        rows = torch.arange(r0, r1)[:, None]
        qt = qf[:, :, r0:r1]
        m = torch.full((B, H, r1 - r0), NEG_INF)
        l = torch.zeros((B, H, r1 - r0))
        acc = torch.zeros((B, H, r1 - r0, Dv))
        for kt, mask in walk:
            k0, k1 = kt * plan.keys, min(S, (kt + 1) * plan.keys)
            s = qt @ kf[:, :, k0:k1].transpose(-1, -2)
            if mask:
                cols = torch.arange(k0, k1)[None, :]
                if causal:
                    s = s.masked_fill(cols > rows, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if mask:
                p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, r0:r1] = acc / l.clamp_min(1e-20)[..., None]
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(np.asarray(x, np.float32))


# (B, T, S, H, KH, D, Dv, causal, bq, bk): the Pallas blocks divide T, S
EMU_CASES = {
    "causal, two query blocks": (1, 256, 256, 2, 2, 64, 64, True, 128, 128),
    "non-causal": (1, 128, 128, 2, 2, 64, 64, False, 128, 128),
    "GQA group 4": (1, 128, 128, 8, 2, 64, 64, True, 128, 128),
    "ragged T = S = 200": (1, 200, 200, 2, 1, 40, 40, True, 40, 40),
    "cross T 64, S 384": (1, 64, 384, 2, 2, 32, 32, False, 64, 128),
    "ragged Dv < D": (2, 96, 160, 4, 2, 64, 32, True, 32, 32),
    "T = 1": (1, 1, 128, 4, 4, 64, 64, False, 128, 128),
    "D = Dv = 256": (1, 96, 160, 1, 1, 256, 256, True, 32, 32),
    "D 128, 64-row blocks": (1, 192, 192, 2, 1, 128, 160, True, 64, 64),
}


@pytest.mark.parametrize("label", list(EMU_CASES))
def test_f32_order_matches_pallas_and_plain(label):
    B, T, S, H, KH, D, Dv, causal, bq, bk = EMU_CASES[label]
    rng = np.random.default_rng(sum(map(ord, label)))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, T, H, D), (B, S, KH, D), (B, S, KH, Dv)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = f32_emulate(tq, tk, tv, causal=causal)
    assert got.shape == (B, T, H, Dv) and got.dtype == torch.float32
    pallas = jops.flash_attention_mha(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal, bq=bq,
                                      bk=bk)
    plain = ref.flash_attention_mha_ref(tq, tk, tv, causal=causal)
    assert float((got - _f32(pallas)).abs().max()) <= ATOL
    assert float((got - plain).abs().max()) <= ATOL


@pytest.mark.parametrize("rows", [64, 128])
def test_f32_order_does_not_depend_on_the_query_blocks(rows):
    """Rows are independent: 64- and 128-row blocks walk other tiles but
    give the same rows within float32 noise."""
    rng = np.random.default_rng(7)
    B, T, S, H, D = 1, 200, 200, 2, 64
    tq, tk, tv = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((B, T, H, D), (B, S, H, D), (B, S, H, D)))
    plan = tfa.f32_plan(T, S, D, D, rows=rows)
    got = f32_emulate(tq, tk, tv, causal=True, plan=plan)
    plain = ref.flash_attention_mha_ref(tq, tk, tv, causal=True)
    assert float((got - plain).abs().max()) <= ATOL


def test_f32_args_carry_the_plan():
    """``set_f32_plan`` fills the FlashArgs fields the kernel reads."""
    a = tfa.FlashArgs()
    p = tfa.f32_plan(4096, 4096, 128, 128)
    tfa.set_f32_plan(a, p)
    assert (a.f32_rows, a.f32_keys, a.f32_threads, a.f32_stages,
            a.f32_smem) == (128, 64, 256, 2, 217_600)
    assert a.marks is None
    # every field is 8 bytes, as in csrc/flash_args.cuh
    assert ctypes.sizeof(tfa.FlashArgs) == 8 * len(tfa.FlashArgs._fields_)
