"""The launch plan of the ``gru_sequence`` kernel
(``repro_torch/kernels/gru.py::gru_plan``) and its numerical design, on
the CPU.

The plan: it fits shared memory and the block, its tiles cover every
row once, each product's items cover every (row, column, k) once, the
gate updates cover every (row, unit) once, it fills the card in one wave
at the traffic AIP's B = 1024, it takes the "l2" route where a part's
weights do not fit in registers, and it raises for what it cannot hold.
The ctypes mirror ``GruArgs`` names the CUDA struct's fields in order.

The arithmetic: the kernel cannot run here, so ``emulate`` below walks
its order of operations lane by lane (``csrc/gru_kernels.cu``): each
K-part's products as one fmaf chain in k order, the parts summed across
the lanes by the reduce-scatter of ``Reduce`` (the rows a lane keeps, and
which lane's sum each row takes), the bias after the sum, the gates
rounding as ``gates.cuh``, h in float32, hs rounded once to x's dtype.
It is held against the port's plain version ``ref.gru_sequence_ref`` and
the JAX Pallas kernel in interpret mode, at ``GRU_TOL`` of
``tests/test_torch_layer_kernels.py`` (1e-5 f32, 3e-2 bf16, plus one bf16
ulp), for the plans of several shapes (parts below, equal to and above
the rows). fmaf is a float64 product and sum rounded to float32. Inputs
are made with numpy from a seed."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.gru import gru_sequence as jgru  # noqa: E402
from repro_torch.kernels import gru as tgru  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.nn.act import fast_sigmoid, fast_tanh  # noqa: E402

GRU_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
BF16_RTOL = 2.0 ** -7

# (B, T, D, H, dtype): the traffic AIP's widths (main and bench), the
# reference tests' cases, the chip check's "weights via L2", ragged B
SHAPES = [
    (1024, 128, 40, 64, torch.float32),
    (8, 64, 40, 64, torch.float32),
    (4, 20, 24, 32, torch.float32),
    (1, 1, 8, 16, torch.float32),
    (2, 16, 12, 32, torch.bfloat16),
    (16, 8, 256, 256, torch.float32),
    (1000, 128, 40, 64, torch.float32),
    (7, 5, 40, 64, torch.float32),
    (3000, 4, 40, 64, torch.bfloat16),
    (2, 3, 40, 1000, torch.float32),     # l2, units in two passes
    (3, 2, 7000, 16, torch.float32),     # l2, a wide x
]


def _id(s):
    B, T, D, H, dt = s
    return f"B{B}-T{T}-D{D}-H{H}-{str(dt).split('.')[-1]}"


@pytest.mark.parametrize("B,T,D,H,dtype", SHAPES, ids=[_id(s) for s in SHAPES])
def test_gru_plan_fits_and_covers(B, T, D, H, dtype):
    p = tgru.gru_plan(B, T, D, H, dtype)
    # fits one block of the card
    assert p.smem == tgru.gru_smem(p.rows, p.parts, D, H, p.route) <= 232_448
    assert p.threads % 32 == 0
    lanes = -(-p.units // p.units_per_thread) * p.parts
    assert lanes <= p.threads <= tgru.max_threads(
        p.route, p.units_per_thread, p.parts)
    assert p.threads < lanes + 32
    assert p.rows in tgru.GRU_ROWS and p.parts in tgru.GRU_PARTS
    if p.route == "registers":
        assert p.units == H and p.passes == 1
        assert (p.parts, p.units_per_thread) == (tgru.REG_PARTS,
                                                 tgru.REG_UNITS)
        assert max(H, D) <= tgru.REG_WIDTH
    else:
        assert p.units_per_thread == 1
    # the tiles cover every row once
    rows = [b for tile in range(p.grid)
            for b in range(tile * p.rows, min(B, (tile + 1) * p.rows))]
    assert rows == list(range(B))
    # each product's items cover every (row, column, k) of a tile once
    for product, K in (("x", D), ("h", H)):
        cover = {}
        for items in tgru.gru_items(p, product).values():
            for rs, c, (k0, k1) in items:
                for r in rs:
                    for k in range(k0, k1):
                        cover[(r, c, k)] = cover.get((r, c, k), 0) + 1
        assert len(cover) == p.rows * 3 * H * K
        assert set(cover.values()) == {1}
    # and one thread updates each (row, unit) after the parts are summed
    owners = tgru.gru_owners(p)
    assert sorted(owners) == [(r, j) for r in range(p.rows)
                              for j in range(H)]


def test_gru_plan_fills_the_card_in_one_wave():
    """B = 1024: tiles of 8 rows, 128 blocks of 512 threads (64 units x 8
    parts), weights in registers; the first body's fixed tile was the
    same 8 rows on 192 of 256 threads. Fewer rows where B is smaller."""
    p = tgru.gru_plan(1024, 128, 40, 64)
    assert (p.rows, p.parts, p.units_per_thread, p.threads, p.route) == (
        8, 8, 1, 512, "registers")
    assert p.grid == 128 <= tgru.GRU_SMS
    assert tgru.gru_plan(1056, 1, 40, 64).grid == 132
    assert tgru.gru_plan(1057, 1, 40, 64).rows == 8      # past one wave
    assert tgru.gru_plan(500, 1, 40, 64).rows == 4
    assert tgru.gru_plan(8, 64, 40, 64).rows == 1


def test_gru_plan_takes_the_l2_route_where_the_weights_do_not_fit():
    """D = H = 256 (the chip check's "weights via L2", 1.5 MB of
    weights): one part a unit, every weight read through the cache."""
    p = tgru.gru_plan(16, 8, 256, 256)
    assert (p.route, p.parts, p.units, p.threads) == ("l2", 2, 256, 512)
    assert tgru.gru_plan(16, 8, 40, 128).route == "l2"
    # past 512 units a block the units go in passes
    assert tgru.gru_plan(2, 2, 40, 1000).passes == 2
    # the main shape forced onto the l2 route: one unit a thread
    q = tgru.gru_plan(1024, 128, 40, 64, route="l2")
    assert (q.rows, q.parts, q.units_per_thread, q.threads) == (8, 8, 1,
                                                                512)


@pytest.mark.parametrize("B,T,D,H,kw", [
    (4, 4, 40, 64, {"route": "registers", "parts": 2}),  # 32 k-steps
    (4, 4, 40, 128, {"route": "registers"}),             # 16 k-steps
    (4, 4, 40, 64, {"rows": 3}),
    (4, 4, 40, 64, {"route": "l2", "parts": 16}),
    (4, 4, 40, 64, {"units_per_thread": 3}),
    (4, 4, 40, 64, {"parts": 4, "units_per_thread": 2}),
    (4, 4, 40, 64, {"route": "l2", "units_per_thread": 2}),
    (4, 4, 40, 64, {"route": "tensor cores"}),
    (2, 2, 60_000, 16, {}),              # x^T alone over shared memory
    (0, 4, 40, 64, {}),
    (4, 4, 40, 64, {"dtype": torch.float16}),
])
def test_gru_plan_raises_for_what_it_cannot_hold(B, T, D, H, kw):
    with pytest.raises(ValueError, match="gru_plan"):
        tgru.gru_plan(B, T, D, H, **kw)


def test_gru_plan_holds_every_width_the_first_body_took():
    """The first body took any widths whose 8-row state fit shared
    memory (4 x 8 x (7H + D) <= 232,448 bytes); the plan holds each."""
    for H in (1, 16, 64, 257, 1000, 1037):
        D = 7264 - 7 * H
        tgru.gru_plan(8, 2, D, H)
        tgru.gru_plan(8, 2, D, H, torch.bfloat16)


@pytest.mark.parametrize("rows,parts", [(8, 8), (8, 4), (4, 8), (4, 4),
                                        (2, 8), (1, 8)])
def test_parts_load_a_k_step_from_distinct_banks(rows, parts):
    """The P parts of one k-step are read in the same 16-byte load
    instruction (by lanes of one quarter warp): ``part_stride`` puts their
    rows on distinct banks, so that a load is not replayed P times."""
    for kl in (1, 5, 8, 10, 16):
        stride = tgru.part_stride(kl, rows)
        vec = min(rows, 4)
        assert stride % vec == 0 and stride >= kl * rows
        for half in range(0, rows, vec):
            banks = [set(range(p * stride + half, p * stride + half + vec))
                     for p in range(parts)]
            words = [{b % 32 for b in bs} for bs in banks]
            assert sum(len(w) for w in words) == len(set().union(*words))


def test_gru_args_mirror_matches_the_cuda_struct():
    src = (Path(tgru.__file__).parent / "csrc" / "gru_kernels.cu")
    body = re.search(r"struct GruArgs \{(.*?)\};", src.read_text(),
                     re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            decl = decl.split("*")[-1] if "*" in decl else \
                decl.replace("long long", "")
            names += [n.strip() for n in decl.split(",")]
    assert [n for n, _ in tgru.GruArgs._fields_] == names
    assert ctypes.sizeof(tgru.GruArgs) == 8 * len(names)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated lane by lane
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _parts(act, W, P):
    """Each K-part's fmaf chain: act (R, K), W (K, 3H) -> (P, 3, R, H)."""
    R, K = act.shape
    H = W.shape[1] // 3
    kl = -(-K // P)
    out = torch.zeros((P, R, 3 * H))
    for p in range(P):
        acc = torch.zeros((R, 3 * H))
        for k in range(p * kl, min(K, (p + 1) * kl)):
            acc = _fma(act[:, k:k + 1], W[k][None], acc)
        out[p] = acc
    return out.view(P, R, 3, H).permute(0, 2, 1, 3)


def _reduce(a, R, P):
    """``Reduce`` on the P lanes of every unit: a (P, 3, R, H) -> the
    full sums (3, R, H), each row taken from its owning lane."""
    lanes = [a[p].clone() for p in range(P)]
    n, m = R, P // 2
    while m:
        new = []
        for p in range(P):
            up = bool(p & m)
            if n > 1:
                h = n // 2
                keep = lanes[p][:, h:n] if up else lanes[p][:, :h]
                q = p ^ m
                got = lanes[q][:, h:n] if up else lanes[q][:, :h]
                x = lanes[p].clone()
                x[:, :h] = keep + got
                new.append(x)
            else:
                x = lanes[p].clone()
                x[:, :1] = lanes[p][:, :1] + lanes[p ^ m][:, :1]
                new.append(x)
        lanes = new
        n = max(n // 2, 1)
        m //= 2
    nr, dup = (R // P, 1) if R >= P else (1, P // R)
    out = torch.full((3, R, a.shape[-1]), float("nan"))
    for p in range(0, P, dup):
        row0 = (p // dup) * nr
        out[:, row0:row0 + nr] = lanes[p][:, :nr]
    return out


def emulate(x, wx, wh, b, h0, plan):
    """The kernel's order of operations on CPU tensors -> (hs, h_T)."""
    B, T, D = x.shape
    R, P = plan.rows, plan.parts
    xf, wx, wh, b = x.float(), wx.float(), wh.float(), b.float()
    H = wh.shape[0]
    hs = torch.zeros((B, T, H), dtype=x.dtype)
    for b0 in range(0, B, R):
        n = min(R, B - b0)
        pad = lambda t: torch.cat([t, torch.zeros((R - n,) + t.shape[1:])])
        h = pad(h0[b0:b0 + n].float())
        for t in range(T):
            gx = _reduce(_parts(pad(xf[b0:b0 + n, t]), wx, P), R, P)
            gx = gx + b.view(3, 1, H)
            gh = _reduce(_parts(h, wh, P), R, P)
            r = fast_sigmoid(gx[0] + gh[0])
            z = fast_sigmoid(gx[1] + gh[1])
            nn_ = fast_tanh(gx[2] + r * gh[2])
            h = (1.0 - z) * nn_ + z * h
            hs[b0:b0 + n, t] = h[:n].to(x.dtype)
    return hs, hs[:, -1]


@pytest.mark.parametrize("B,T,D,H,dtype,kw", [
    (8, 6, 40, 64, "float32", {}),                 # rows 1 < parts 4
    (8, 6, 40, 64, "float32", {"rows": 8}),        # the main shape's plan
    (6, 5, 40, 64, "float32", {"rows": 4}),        # a ragged tile
    (5, 7, 24, 32, "float32", {"rows": 2}),        # parts 8 > rows 2
    (3, 4, 40, 64, "float32", {"rows": 8, "units_per_thread": 2}),
    (5, 4, 40, 64, "float32", {"rows": 8, "parts": 4}),
    (6, 3, 40, 64, "float32", {"rows": 8, "route": "l2", "parts": 4}),
    (4, 5, 12, 32, "bfloat16", {"rows": 4}),
    (3, 3, 20, 20, "float32", {"rows": 4, "route": "l2", "parts": 1}),
])
def test_the_kernels_order_of_sums_meets_the_tolerance(B, T, D, H, dtype,
                                                        kw):
    rng = np.random.default_rng(B * 1000 + T * 10 + D)
    arrs = [(0.2 * rng.standard_normal(s)).astype(np.float32)
            for s in ((D, 3 * H), (H, 3 * H))]
    arrs.append((0.1 * rng.standard_normal(3 * H)).astype(np.float32))
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, th0 = torch.from_numpy(x).to(tdt), torch.from_numpy(h0).to(tdt)
    twx, twh, tb = (torch.from_numpy(a).to(tdt) for a in arrs)
    plan = tgru.gru_plan(B, T, D, H, tdt, **kw)
    hs, hT = emulate(tx, twx, twh, tb, th0, plan)
    assert hs.dtype == tdt and not torch.isnan(hs.float()).any()
    tol, rtol = GRU_TOL[dtype], (BF16_RTOL if dtype == "bfloat16" else 0)
    want, _ = jgru(*(jnp.asarray(a, jnp.float32).astype(jdt)
                     for a in (x, *arrs, h0)), interpret=True)
    np.testing.assert_allclose(hs.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=tol, rtol=rtol)
    plain, plain_T = ref.gru_sequence_ref(tx, twx, twh, tb, th0)
    np.testing.assert_allclose(hs.float().numpy(), plain.float().numpy(),
                               atol=tol, rtol=rtol)
    assert torch.equal(hT, hs[:, -1])
