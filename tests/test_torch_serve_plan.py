"""The serving kernels' launch plan (``repro_torch.kernels.aip_step.
serve_plan``), checked on the CPU: it is plain Python, and the CUDA kernel
(``csrc/serve_kernels.cu``) runs only the plans it produces. For both
serving widths, hidden 64-256, 1 or 4 policies and slots of 1 to 4096
lanes: shared memory within the card's 232,448 bytes a block, tiles that
cover the slot exactly once, bulk copies 16-byte aligned and sized that
cover every weight row once, threads for every column, a grid that fills
the card at the 128-lane slot; widths that cannot fit raise; and the
ctypes mirror of ``IalsArgs`` field for field against the CUDA header."""
import ctypes
import re
from pathlib import Path

import pytest

from repro_torch.kernels import aip_step as cuda

# (frame width D, actions) of the two serving widths, as chip_smoke.py
SERVE_WIDTHS = {"traffic": (41, 2), "warehouse": (37 * 8, 5)}
FIRST_VERSION_BLOCKS_AT_128 = 8   # one block per 16 lanes


def _plans():
    for domain, (D, NA) in SERVE_WIDTHS.items():
        for Hp in (64, 128, 256):
            for N in (1, 4):
                for S in (1, 13, 128, 4096):
                    yield pytest.param(D, NA + 1, Hp, N, S,
                                       id=f"{domain}-Hp{Hp}-N{N}-S{S}")


@pytest.mark.parametrize("D,NH,Hp,N,S", list(_plans()))
def test_serve_plan_fits_covers_and_aligns(D, NH, Hp, N, S):
    plan = cuda.serve_plan(S, D, Hp, NH, N)
    # shared memory: the card's limit, and the kernel's own layout
    assert plan.smem <= 232_448
    assert plan.smem == cuda._serve_smem(plan.lanes, D, Hp, NH,
                                         plan.chunk_rows, plan.stages)
    assert 1 <= plan.stages <= plan.chunks
    # tiles cover the slot exactly once
    gx, gy = plan.grid
    covered = [lane for t in range(gx)
               for lane in range(t * plan.lanes,
                                 min(S, (t + 1) * plan.lanes))]
    assert covered == list(range(S))
    assert (gx - 1) * plan.lanes < S
    # a block per (tile, policy) while that fits one wave of the card
    assert gy == (N if gx * N <= cuda.SERVE_WAVE_BLOCKS else 1)
    # threads: whole warps, one register tile (RP rows, CP columns) of
    # every row group, and one head column
    R, RP, CP = plan.lanes, plan.rows_per_thread, plan.cols_per_thread
    assert R <= cuda.SERVE_MAX_LANES and R % RP == 0 and RP in (1, 2, 4, 8)
    assert CP in (1, 2, 4) and Hp % CP == 0
    assert plan.threads % 32 == 0 and plan.threads <= cuda.SERVE_MAX_THREADS
    assert plan.threads >= max(Hp // CP, NH) * (R // RP)
    # every bulk copy aligned and sized; they cover w1, w2, head once
    assert plan.ring_bulk and plan.head_bulk
    pieces = cuda.serve_pieces(plan)
    assert all(off % 16 == 0 and size % 16 == 0 and size > 0
               for _, off, size in pieces)
    for name, total in (("w1", N * D * Hp * 4), ("w2", N * Hp * Hp * 4),
                        ("head", N * Hp * NH * 4)):
        spans = sorted((off, off + size) for t, off, size in pieces
                       if t == name)
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # a chunk fits its stage
    assert plan.chunk_rows * plan.chunks >= D + Hp
    assert plan.chunk_rows * (plan.chunks - 1) < D + Hp


@pytest.mark.parametrize("domain", list(SERVE_WIDTHS))
@pytest.mark.parametrize("N", [1, 4])
def test_serve_plan_fills_the_card_at_the_128_lane_slot(domain, N):
    D, NA = SERVE_WIDTHS[domain]
    gx, gy = cuda.serve_plan(128, D, 128, NA + 1, N).grid
    assert gx * gy >= 2 * FIRST_VERSION_BLOCKS_AT_128


def test_serve_plan_keeps_every_chunk_resident_at_the_traffic_widths():
    """87 KB of weights fit beside the lane tile: the whole policy is in
    flight before the first product, nothing is refilled."""
    for S in (1, 128, 4096):
        plan = cuda.serve_plan(S, 41, 128, 3, 4)
        assert plan.stages == plan.chunks


def test_serve_plan_rings_the_warehouse_weights():
    """w1 alone is 148 KB at D = 296: beside a 32-lane tile the ring
    holds fewer stages than chunks and refills."""
    plan = cuda.serve_plan(4096, 296, 128, 6, 1)
    assert plan.lanes == 32 and plan.stages < plan.chunks


def test_serve_plan_stages_unaligned_rows_by_plain_loads():
    plan = cuda.serve_plan(48, 41, 66, 3, 3)
    assert not plan.ring_bulk and not plan.head_bulk
    assert cuda.serve_pieces(plan) == []
    assert plan.smem <= 232_448


@pytest.mark.parametrize("D,Hp,lanes", [
    (60_000, 128, None),   # one lane's frame row alone overflows
    (41, 4099, None),      # 4,099 columns (no 2 or 4 divides) need more
    #                        than 512 threads
    (41, 128, 3),          # lanes must be a power of two
    (41, 128, 64),         # and at most one warp's ballot
    (2_000, 128, 32),      # a forced tile whose frames do not fit
])
def test_serve_plan_raises_for_what_it_cannot_hold(D, Hp, lanes):
    with pytest.raises(ValueError):
        cuda.serve_plan(128, D, Hp, 3, 1, lanes=lanes)


def test_serve_plan_without_the_policy_axis_and_with_set_lanes():
    plan = cuda.serve_plan(128, 41, 128, 3, 4, lanes=8, policy_axis=False)
    assert plan.grid == (16, 1) and plan.lanes == 8
    # 128 tiles x 4 policies is two waves: the blocks walk the policies
    assert cuda.serve_plan(4096, 41, 128, 3, 4).grid == (128, 1)
    assert cuda.serve_plan(4096, 41, 128, 3, 4,
                           policy_axis=True).grid == (128, 4)


def test_serve_plan_widens_the_register_tile_only_to_fit_the_block():
    """One column a thread while the block fits 512 threads; at 32 lanes
    and hidden 256 the tile takes 2 columns, at hidden 512 4."""
    assert cuda.serve_plan(4096, 41, 128, 3, 1).cols_per_thread == 1
    assert cuda.serve_plan(4096, 41, 256, 3, 1).cols_per_thread == 2
    assert cuda.serve_plan(4096, 41, 512, 3, 1).cols_per_thread == 4
    assert cuda.serve_plan(128, 41, 512, 3, 1).cols_per_thread == 1


def test_ials_args_mirror_matches_the_cuda_header():
    """``IalsArgs``'s ctypes mirror names the header's fields in order,
    with the same array lengths, every one 8 bytes: the size check the
    library makes at load time can only pass on a layout that agrees."""
    header = (Path(cuda.__file__).parent / "csrc" / "ials_args.cuh")
    body = re.search(r"struct IalsArgs \{(.*?)\};", header.read_text(),
                     re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        names = decl.split("*")[-1] if "*" in decl else \
            decl.replace("long long", "")
        for name in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\w+)\])?\s*", name)
            n = {"kMaxLeaves": 4}.get(m.group(2), m.group(2))
            fields.append((m.group(1), int(n) if n else 1))
    mirror = [(name, getattr(t, "_length_", 1))
              for name, t in cuda.IalsArgs._fields_]
    assert mirror == fields
    # the LS functor and its constants, in the order both sides read them
    names = [n for n, _ in fields]
    i = names.index("domain")
    assert names[i:i + 6] == ["domain", "lane_len", "ext_influence",
                              "region", "max_age", "vanish_after"]
    assert (cuda._DOMAINS["traffic"], cuda._DOMAINS["warehouse"]) == (0, 1)
    assert ctypes.sizeof(cuda.IalsArgs) == 8 * sum(n for _, n in fields)
