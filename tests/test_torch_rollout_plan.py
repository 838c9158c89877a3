"""The launch plan of the horizon kernels (``aip_rollout_multi``,
``fnn_rollout``, ``policy_rollout``),
``repro_torch.kernels.aip_step.rollout_plan``, on the CPU: it fits shared
memory and the block, its tiles cover every lane of every agent once,
each product's items cover every (row, column, k) once, it fills the
card at the main path's shapes without a second wave, and it raises for
widths it cannot hold."""
import pytest

from repro_torch.kernels import aip_step as cuda

W = cuda.RolloutWidths
TRAFFIC_FNN = W(D=40, H=64, M=4, stack=8, S=41, obs_dim=41, Hp=128, n_act=2)
TRAFFIC_GRU = W(D=40, H=64, M=4, S=41, obs_dim=41, Hp=128, n_act=2)
# the warehouse: 37-wide observations stacked 8 deep, five actions, a
# 24-wide d-set, 12 influence sources and a 14-int lane state (row,
# column, 12 ages)
WH = cuda.WAREHOUSE_STATE_INTS
WAREHOUSE_GRU = W(D=24, H=64, M=12, S=296, obs_dim=37, Hp=128, n_act=5,
                  state_ints=WH)
WAREHOUSE_FNN = W(D=24, H=64, M=12, stack=8, S=296, obs_dim=37, Hp=128,
                  n_act=5, state_ints=WH)

CASES = [
    # (A, B, widths, cell, with_policy, overrides)
    (1, 16, TRAFFIC_FNN, "fnn", True, {}),       # the main path, FNN
    (25, 16, TRAFFIC_GRU, "gru", True, {}),      # the main path, GRU
    (1, 16, TRAFFIC_FNN, "fnn", False, {}),      # engine.rollout, FNN
    (1, 1, TRAFFIC_FNN, "fnn", True, {}),
    (1, 1, TRAFFIC_GRU, "gru", True, {}),
    (1, 17, TRAFFIC_FNN, "fnn", True, {}),
    (3, 100, TRAFFIC_GRU, "gru", True, {}),
    (3, 17, TRAFFIC_FNN, "fnn", False, {}),
    (25, 512, TRAFFIC_GRU, "gru", True, {}),
    (25, 512, TRAFFIC_FNN, "fnn", False, {}),
    (1, 512, TRAFFIC_FNN, "fnn", True, {}),
    (25, 64, TRAFFIC_GRU, "gru", True, {}),
    (36, 16, WAREHOUSE_GRU, "gru", True, {}),
    (4, 16, WAREHOUSE_FNN, "fnn", False, {}),
    (1, 16, TRAFFIC_FNN, "fnn", True, {"cluster": 1}),
    (25, 16, TRAFFIC_GRU, "gru", True, {"cluster": 1, "threads": 128}),
    (1, 16, TRAFFIC_FNN, "fnn", True, {"lanes": 32}),
    (1, 16, TRAFFIC_GRU, "gru", True, {"lanes": 1, "threads": 64}),
    # engine.rollout, GRU: aip_rollout_multi on the horizon kernel
    (16, 16, TRAFFIC_GRU, "gru", False, {}),
    (25, 16, TRAFFIC_GRU, "gru", False, {}),
    (1, 512, TRAFFIC_GRU, "gru", False, {}),
    (25, 64, TRAFFIC_GRU, "gru", False, {}),
    (3, 17, TRAFFIC_GRU, "gru", False, {}),
    (36, 16, WAREHOUSE_GRU, "gru", False, {}),
]


def _ids(c):
    A, B, w, cell, pol, kw = c
    return f"A{A}-B{B}-{cell}-D{w.D}-{'pol' if pol else 'aip'}-{kw}"


@pytest.mark.parametrize("A,B,w,cell,pol,kw", CASES,
                         ids=[_ids(c) for c in CASES])
def test_rollout_plan_fits_and_covers(A, B, w, cell, pol, kw):
    p = cuda.rollout_plan(A, B, w, cell, pol, **kw)
    for k, v in kw.items():
        assert getattr(p, k) == v
    # fits one CTA of the card
    assert p.smem <= cuda.ROLL_SMEM_MAX == 232_448
    assert 1 <= p.cluster <= 8
    assert p.cluster == (kw.get("cluster", 2) if pol else 1)
    assert p.threads % 32 == 0 and p.threads <= cuda.ROLL_MAX_THREADS
    assert p.threads >= p.lanes * max(w.M, w.n_act if pol else 0)
    assert p.lanes in cuda.ROLL_LANES
    assert p.rows_per_thread == min(p.lanes, 4)
    # the bytes are the two roles' (one CTA each, or both in one)
    pol_b, aip_b = cuda.roll_smem(w, cell, p.lanes, p.splits, p.layers)
    assert (pol_b, aip_b) == p.smem_roles
    assert p.smem == (max(pol_b, aip_b) if p.cluster == 2
                      else pol_b + aip_b)
    assert (pol_b > 0) == pol
    # the tiles cover every lane of every agent exactly once
    seen = []
    for tile in range(p.tiles):
        per_agent = -(-B // p.lanes)
        agent, b0 = tile // per_agent, (tile % per_agent) * p.lanes
        seen += [(agent, b) for b in range(b0, min(B, b0 + p.lanes))]
    assert sorted(seen) == [(a, b) for a in range(A) for b in range(B)]
    assert p.grid == p.tiles * p.cluster
    # every product's items cover each (row, column, k) exactly once
    for layer, (K, N) in enumerate(p.layers):
        if K == 0:
            continue
        ks = p.splits[layer]
        assert 1 <= ks <= cuda.ROLL_MAX_SPLIT and ks <= K
        cover = {}
        for items in cuda.rollout_items(p, layer).values():
            for rows, n, (k0, k1) in items:
                for r in rows:
                    for k in range(k0, k1):
                        cover[(r, n, k)] = cover.get((r, n, k), 0) + 1
        assert len(cover) == p.lanes * N * K
        assert set(cover.values()) == {1}


def test_rollout_plan_fills_the_card_in_one_wave():
    """At the main path's shapes the grid spreads over more SMs than the
    first body's one block a 16-lane tile, and the card holds all of it at
    once: one CTA an SM, two where two clusters of two fit."""
    fnn = cuda.rollout_plan(1, 16, TRAFFIC_FNN, "fnn", True)
    gru = cuda.rollout_plan(25, 16, TRAFFIC_GRU, "gru", True)
    aip = cuda.rollout_plan(1, 16, TRAFFIC_FNN, "fnn", False)
    # aip_rollout_multi: 100 CTAs of 4 lanes at A = 25, B = 16 and 128 at
    # A = 1, B = 512, against the first body's 25 and 32 blocks of 16
    multi = cuda.rollout_plan(25, 16, TRAFFIC_GRU, "gru", False)
    multi512 = cuda.rollout_plan(1, 512, TRAFFIC_GRU, "gru", False)
    assert (multi.lanes, multi.grid) == (4, 100)
    assert (multi512.lanes, multi512.grid) == (4, 128)
    assert fnn.grid > 1 and aip.grid > 1 and gru.grid > 25
    for p in (fnn, gru, aip, multi, multi512,
              cuda.rollout_plan(1, 512, TRAFFIC_FNN, "fnn", True),
              cuda.rollout_plan(25, 64, TRAFFIC_GRU, "gru", True)):
        assert p.grid <= cuda.roll_resident(p.cluster, p.threads, p.smem,
                                            p.lanes)
        assert p.grid <= p.cluster * cuda.ROLL_SMS
    # the policy and the AIP run on the two CTAs of a cluster
    assert fnn.cluster == gru.cluster == 2
    assert aip.cluster == multi.cluster == multi512.cluster == 1
    # two clusters an SM where they fit: 100 KB of shared memory each
    assert cuda.roll_resident(2, 256, 99_376) == 2 * cuda.ROLL_SMS
    assert cuda.roll_resident(2, 512, 99_376) == cuda.ROLL_SMS
    assert cuda.roll_resident(2, 256, 131_552) == cuda.ROLL_SMS
    assert cuda.roll_resident(1, 256, 99_376) == cuda.ROLL_SMS
    # without the policy, two CTAs an SM from 8 lanes a tile where they
    # fit: the GRU AIP's 8-lane CTA does (99 KB), the FNN's not (119 KB)
    assert cuda.roll_resident(1, 256, 98_816, 8) == 2 * cuda.ROLL_SMS
    assert cuda.roll_resident(1, 256, 118_784, 8) == cuda.ROLL_SMS
    assert cuda.roll_resident(1, 256, 90_256, 4) == cuda.ROLL_SMS
    multi64 = cuda.rollout_plan(25, 64, TRAFFIC_GRU, "gru", False)
    fnn64 = cuda.rollout_plan(25, 64, TRAFFIC_FNN, "fnn", False)
    assert (multi64.lanes, multi64.grid) == (8, 200)
    assert (fnn64.lanes, fnn64.grid) == (16, 100)


def test_domain_layouts_give_the_widths_and_state_ints():
    """``domain_layout`` is what the wrappers hand the plan and the kernel:
    the d-set and observation widths, the functor's state ints, the leaf
    shapes and noise leaves; a domain without a functor raises."""
    from repro_torch.envs.api import KernelDomain
    tr = cuda.domain_layout(KernelDomain("traffic", lane_len=10))
    wh = cuda.domain_layout(KernelDomain("warehouse", region=5, max_age=64))
    assert (tr.D, tr.obs_dim, tr.state_ints, tr.noise) == (40, 41, 5, ())
    assert (wh.D, wh.obs_dim, wh.state_ints) == (24, 37, 14)
    assert wh.leaves == (("pos", (2,)), ("items", (12,)))
    assert wh.noise == (("spawn", (12,)),)
    for bad in (None, KernelDomain("storage")):
        with pytest.raises(NotImplementedError, match="device functor"):
            cuda.domain_layout(bad)


def test_warehouse_policy_plan_sits_at_the_edge_of_shared_memory():
    """A = 36, B = 16 with the policy (GRU AIP): no tile of more lanes
    fits, so 2 lanes a tile on a cluster of two, 576 CTAs at one an SM
    (4.4 waves); the policy role's weights (296 x 128 and 128 x 128 f32)
    leave under 2 KB of the block's shared memory. The warehouse's 14
    state ints cost the AIP role 9 ints a lane more than traffic's 5."""
    p = cuda.rollout_plan(36, 16, WAREHOUSE_GRU, "gru", True)
    assert (p.lanes, p.cluster, p.grid) == (2, 2, 576)
    assert cuda.roll_resident(p.cluster, p.threads, p.smem, p.lanes) == \
        cuda.ROLL_SMS
    assert 0 <= cuda.ROLL_SMEM_MAX - p.smem < 2_048
    with pytest.raises(ValueError, match="rollout_plan"):
        cuda.rollout_plan(36, 16, WAREHOUSE_GRU, "gru", True, lanes=4)
    traffic_ints = cuda.RolloutWidths(**{
        **WAREHOUSE_GRU.__dict__, "state_ints": cuda.TRAFFIC_STATE_INTS})
    for R in (2, 8):
        a = cuda.roll_smem(WAREHOUSE_GRU, "gru", R, p.splits, p.layers)[1]
        b = cuda.roll_smem(traffic_ints, "gru", R, p.splits, p.layers)[1]
        assert a - b == cuda._r16(4 * R * WH) - cuda._r16(4 * R * 5)


def test_rollout_plan_splits_narrow_products_over_k():
    """The heads (3 and 4 columns) are cut into K-parts of at least
    ROLL_MIN_CHAIN steps; the wide layers keep one part where their items
    already fill the block."""
    p = cuda.rollout_plan(25, 64, TRAFFIC_GRU, "gru", True)
    assert p.lanes == 32
    assert p.splits[2] == 16 and p.splits[5] == 8
    assert p.splits[1] == 1 and p.splits[4] == 1
    for (K, _), ks in zip(p.layers, p.splits):
        assert ks == 1 or K // ks >= cuda.ROLL_MIN_CHAIN


@pytest.mark.parametrize("w,cell,pol,kw", [
    (W(D=40, H=64, M=4, stack=8, S=41, obs_dim=41, Hp=256, n_act=2),
     "fnn", True, {}),                             # w2 alone is 256 KB
    (W(D=40, H=256, M=4, stack=8), "fnn", False, {}),   # w1 is 320 KB
    (TRAFFIC_FNN, "fnn", True, {"cluster": 1, "lanes": 32}),
    (TRAFFIC_FNN, "fnn", True, {"threads": 100}),
    (TRAFFIC_FNN, "fnn", True, {"lanes": 3}),
    (TRAFFIC_FNN, "fnn", True, {"cluster": 4}),
    (TRAFFIC_FNN, "fnn", True, {"lanes": 32, "threads": 64}),  # u's lanes
    (TRAFFIC_GRU, "gru", False, {"cluster": 2}),   # a cluster needs the
    #                                                policy
])
def test_rollout_plan_raises_for_what_it_cannot_hold(w, cell, pol, kw):
    with pytest.raises(ValueError, match="rollout_plan"):
        cuda.rollout_plan(16, 16, w, cell, pol, **kw)


def test_set_plan_fills_the_wrapper_arguments():
    """``_set_plan`` writes every plan field the kernel reads into the
    IalsArgs mirror."""
    p = cuda.rollout_plan(25, 16, TRAFFIC_GRU, "gru", True)
    args = cuda.IalsArgs()
    cuda._set_plan(args, p)
    assert (args.roll_lanes, args.roll_rows_per_thread, args.roll_cluster,
            args.roll_threads, args.roll_smem) == (
        p.lanes, p.rows_per_thread, p.cluster, p.threads, p.smem)
    assert tuple(args.roll_split) == p.splits


# aip_step: the GRU horizon's plan without the policy, one tick
STEP_CASES = [(25, 16), (1, 512), (25, 512), (1, 1), (25, 1), (3, 17),
              (7, 100)]


@pytest.mark.parametrize("A,B", STEP_CASES)
def test_step_plan_covers_fits_and_equals_the_rollouts(A, B):
    """``aip_step``'s plan covers every (agent, lane) once, fits one CTA
    and takes ``rollout_plan``'s K-parts for the GRU horizon at the same
    (A, B), so a step and a one-tick rollout sum in the same order; its
    lanes are the rollout's up to STEP_MAX_LANES, and where the rollout
    takes no more the two plans are one."""
    p = cuda.step_plan(A, B, 40, 64, 4)
    roll = cuda.rollout_plan(A, B, TRAFFIC_GRU, "gru", False)
    assert p.splits == roll.splits
    assert p.lanes == min(roll.lanes, cuda.STEP_MAX_LANES)
    if roll.lanes <= cuda.STEP_MAX_LANES:
        assert p == roll
    assert p.cell == "gru" and not p.with_policy and p.cluster == 1
    assert p.smem <= cuda.ROLL_SMEM_MAX
    assert p.threads % 32 == 0 and p.threads <= cuda.ROLL_MAX_THREADS
    assert p.threads >= p.lanes * 4     # the draw: a thread a (lane, m)
    seen = []
    per_agent = -(-B // p.lanes)
    for tile in range(p.grid):
        agent, b0 = tile // per_agent, (tile % per_agent) * p.lanes
        seen += [(agent, b) for b in range(b0, min(B, b0 + p.lanes))]
    assert sorted(seen) == [(a, b) for a in range(A) for b in range(B)]
    for layer in (3, 4, 5):
        K, N = p.layers[layer]
        cover = {}
        for items in cuda.rollout_items(p, layer).values():
            for rows, n, (k0, k1) in items:
                for r in rows:
                    for k in range(k0, k1):
                        cover[(r, n, k)] = cover.get((r, n, k), 0) + 1
        assert len(cover) == p.lanes * N * K and set(cover.values()) == {1}


def test_step_plan_at_the_main_shape():
    """A = 25, B = 16: 100 CTAs of 4 lanes (the first body ran 25 blocks of
    16), the heads cut into 8 K-parts of 8 steps."""
    p = cuda.step_plan(25, 16, 40, 64, 4)
    assert (p.lanes, p.grid, p.threads) == (4, 100, 256)
    assert p.splits == (1, 1, 1, 1, 1, 8)


def test_step_plan_caps_the_tile_where_the_rollout_widens_it():
    """A = 25, B = 512: the rollout takes 32 lanes a tile (400 CTAs, one
    wave for the horizon); a step takes 8 (1,600 CTAs, two an SM) on 256
    threads with the rollout's K-parts, and the lanes override keeps
    them too."""
    roll = cuda.rollout_plan(25, 512, TRAFFIC_GRU, "gru", False)
    assert (roll.lanes, roll.grid, roll.threads) == (32, 400, 512)
    p = cuda.step_plan(25, 512, 40, 64, 4)
    assert (p.lanes, p.grid, p.threads) == (8, 1600, 256)
    assert p.splits == roll.splits
    assert p.smem == sum(cuda.roll_smem(TRAFFIC_GRU, "gru", 8, roll.splits,
                                        roll.layers))
    for R in cuda.ROLL_LANES:
        assert cuda.step_plan(25, 512, 40, 64, 4, lanes=R).splits == \
            roll.splits


@pytest.mark.parametrize("splits", [(1, 1, 1, 1, 8), (1, 1, 1, 1, 1, 0),
                                    (1, 1, 1, 1, 1, 32)])
def test_rollout_plan_refuses_splits_the_kernel_cannot_run(splits):
    with pytest.raises(ValueError, match="splits"):
        cuda.rollout_plan(25, 16, TRAFFIC_GRU, "gru", False, splits=splits)


@pytest.mark.parametrize("A,B", [(25, 16), (25, 512), (3, 17)])
def test_set_plan_fills_the_ials_args(A, B):
    p = cuda.step_plan(A, B, 40, 64, 4)
    args = cuda.IalsArgs(A=A, B=B, D=40, H=64, M=4)
    cuda._set_plan(args, p)
    assert (args.roll_lanes, args.roll_rows_per_thread, args.roll_cluster,
            args.roll_threads, args.roll_smem) == (
        p.lanes, p.rows_per_thread, p.cluster, p.threads, p.smem)
    assert tuple(args.roll_split) == p.splits


SHARD_CASES = [
    # (global A, global B, agent blocks, lane blocks, widths, cell, policy)
    (25, 64, 1, 4, TRAFFIC_GRU, "gru", True),    # own plan: other K-parts
    (1, 512, 1, 4, TRAFFIC_GRU, "gru", True),
    (1, 16, 1, 2, TRAFFIC_FNN, "fnn", True),     # the main path, 2 ranks
    (25, 16, 1, 4, TRAFFIC_GRU, "gru", True),
    (36, 16, 2, 2, WAREHOUSE_GRU, "gru", True),  # 18 agents x 8 lanes
    (25, 64, 1, 4, TRAFFIC_GRU, "gru", False),
    (36, 16, 2, 2, WAREHOUSE_FNN, "fnn", False),
]


@pytest.mark.parametrize("A,B,ka,kb,w,cell,pol", SHARD_CASES,
                         ids=[f"A{c[0]}-B{c[1]}-{c[2]}x{c[3]}-{c[5]}-"
                              f"{'pol' if c[6] else 'aip'}"
                              for c in SHARD_CASES])
def test_shard_plan_carries_the_global_splits(A, B, ka, kb, w, cell, pol):
    """A rank's block of A / ka agents x B / kb lanes plans its own tile,
    threads and shared bytes but takes the global launch's K-parts
    (``aip_step.shard_plan``), so every lane sums in the order of the
    one-process launch; without ``plan_for`` it is the block's own plan.
    At traffic A = 25, 64 lanes on 4 ranks, the block's own plan would
    split the policy's first two products differently."""
    a, b = A // ka, B // kb
    glob = cuda.rollout_plan(A, B, w, cell, pol)
    own = cuda.rollout_plan(a, b, w, cell, pol)
    pinned = cuda.shard_plan(a, b, w, cell, pol, plan_for=(A, B))
    assert pinned.splits == glob.splits
    assert (pinned.A, pinned.B) == (a, b)
    assert pinned.smem <= cuda.ROLL_SMEM_MAX
    assert cuda.shard_plan(a, b, w, cell, pol) == own
    if (A, B, pol) == (25, 64, True):
        assert own.splits != glob.splits
