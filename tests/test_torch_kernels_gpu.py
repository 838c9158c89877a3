"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at test size (both cells, A in {1, 3}, resets inside the horizon),
with the lane and flip rule of ``chip_smoke.py``; the horizon kernels
(``aip_rollout_multi``, ``fnn_rollout``, ``policy_rollout``) also at 1,
17 and 100 lanes an agent, with exact tanh gates, a bitwise repeat and a
refused plan; ``gru_sequence`` at odd B (1, 7, 1000), T = 1 and bf16, a
bitwise repeat and a refused plan; the serving kernels
at both domains' widths, slots of 1 to 4096 lanes, 1, 3 and 4 policies,
shaped slots (an empty policy, one policy, all masked), plain-load
staging, hidden layers of 256 and 512 and a refused launch, with the three bitwise contracts of the
serving tier (pad contents, lane position, multi vs single policy); the
layer kernels (``gru_sequence``, ``rmsnorm``, ``flash_attention``) through
``kernels.ops`` at ``chip_smoke.py``'s test-size cases, f32 and bf16
(bf16 flash cases with head widths in steps of 16 take the tensor-core
kernel), the flash kernel's (BH, T, D) entry, the Pallas kernel's own
layout, and the route counters of the two flash kernels; the CUDA-core
flash kernel repeats bitwise at every f32 case and the off-16 bf16 one;
``aip_step`` at odd shapes (B = 1, ragged B, A = 1) against its plain
version and bitwise on a repeat; ``ops.ials_rollout`` (``aip_rollout``)
on both domains at B = 1, 17, 512 with one launch a call; ``engine.step`` equals a one-tick
``engine.rollout`` bitwise; the horizon kernels with the warehouse
functor (spawn noise, 8 stacked frames, the action read by the d-set, on
a cluster of two and on one CTA, ``vanish_after``), bitwise on a repeat,
with their per-domain launch counters and refused launches; and a host
cell of the dry-run (``launch/dryrun.py``) per program, run once on the
card with one launch of its horizon kernel.
These tests need a CUDA card and ``nvcc``: they carry the ``gpu`` marker
and skip without a card.
They import no JAX, so on a machine without it they run without the
repo's conftest: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_kernels_gpu.py``."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (imports nothing but the standard library)

pytestmark = pytest.mark.gpu
# the layer cases at test size (the configuration-width ones run in
# chip_smoke.py's phase 7)
_BIG = ("main", "qwen3_4b non-causal", "qwen3_4b f32", "qk-norm")
LAYER_CASES = [(op, label) for op, cases in (
    ("gru_sequence", chip_smoke.GRU_CASES), ("rmsnorm", chip_smoke.RMS_CASES),
    ("flash_attention", chip_smoke.FLASH_CASES))
    for label in cases if label not in _BIG]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A", [1, 3])
def test_rollout_kernel_matches_plain(kind, A, dev):
    case = chip_smoke.Case(kind, A, 20, 16, seed=A, dev=dev)
    flips, err = chip_smoke.check_rollout(case, f"rollout {kind} A={A}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A", [1, 3])
def test_policy_rollout_kernel_matches_plain(kind, A, dev):
    case = chip_smoke.Case(kind, A, 20, 48, seed=10 + A, dev=dev)
    assert bool(case.done.any())
    flips, err = chip_smoke.check_policy(case, f"policy {kind} A={A}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("B", [1, 17, 512])
def test_aip_rollout_kernel_matches_plain(domain, B, dev):
    """``ops.ials_rollout`` (``aip_rollout``: the ``aip_rollout_multi``
    kernel at one agent, unstacked weights) against its plain version
    ``ref.ials_rollout_ref``, one ``aip_rollout`` launch a call."""
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.Case("gru", 1, B, 20, seed=70 + B, dev=dev,
                           domain=domain)
    cuda.reset_launches()
    out = chip_smoke.ials_rollout_call(case)
    torch.cuda.synchronize()
    assert chip_smoke.nonzero(cuda.LAUNCHES) == {
        "aip_rollout": 1, f"aip_rollout[{domain}]": 1}
    flips, err = chip_smoke.check_ials_rollout(case, f"aip_rollout B={B}",
                                               out)
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A,B", [(1, 1), (1, 17), (3, 17), (3, 100)])
def test_policy_rollout_at_odd_shapes(kind, A, B, dev):
    """The horizon kernel at lane counts off its tile (1, 17, 100 lanes an
    agent), resets inside the horizon."""
    case = chip_smoke.Case(kind, A, B, 48, seed=30 + A + B, dev=dev)
    assert bool(case.done.any())
    flips, err = chip_smoke.check_policy(case, f"policy {kind} A={A} B={B}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("A,B", [(1, 1), (1, 17), (3, 100)])
def test_fnn_rollout_at_odd_shapes(A, B, dev):
    case = chip_smoke.Case("fnn", A, B, 40, seed=40 + A + B, dev=dev)
    flips, err = chip_smoke.check_rollout(case, f"fnn_rollout A={A} B={B}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("A,B", [(1, 1), (1, 17), (3, 17), (3, 100),
                                 (25, 17)])
def test_aip_rollout_multi_at_odd_shapes(A, B, dev):
    """The GRU horizon without the policy at lane counts off its tile."""
    case = chip_smoke.Case("gru", A, B, 40, seed=45 + A + B, dev=dev)
    flips, err = chip_smoke.check_rollout(case, f"aip_rollout_multi A={A} "
                                                f"B={B}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_policy_rollout_with_exact_tanh(kind, dev):
    case = chip_smoke.Case(kind, 3, 20, 48, seed=50, dev=dev)
    case.fast_gates = False
    flips, err = chip_smoke.check_policy(case, f"policy {kind} tanh")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kernel", ["policy fnn", "policy gru",
                                    "fnn_rollout", "aip_rollout_multi"])
def test_horizon_kernels_repeat_bitwise(kernel, dev):
    """The K-parts are summed in a fixed order: two launches on the same
    inputs give the same bits."""
    kind = "fnn" if kernel.endswith("fnn") or kernel == "fnn_rollout" \
        else "gru"
    case = chip_smoke.Case(kind, 3 if kind == "gru" else 1, 64, 48, seed=60,
                           dev=dev)
    call = case.policy_call if kernel.startswith("policy") \
        else case.rollout_call
    first, second = call(), call()
    torch.cuda.synchronize()
    leaves = [(a, b) for x, y in zip(first, second)
              for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)])]
    assert all(torch.equal(a, b) for a, b in leaves)


def test_horizon_launch_refused_raises(dev):
    """A plan the horizon kernel cannot run is refused and the wrapper
    raises: no fallback."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.Case("fnn", 1, 16, 8, seed=70, dev=dev)
    entry, counter, args, _, _, keep = cuda.policy_rollout_args(
        case.io.ls, case.s0, case.frames0, case.aw, case.pw, case.gumbel,
        case.bits, case.done, (), case.reset_ls, kind="fnn", n_agents=1,
        fast_gates=True, domain=case.ls_env.kernel_domain)
    args.roll_cluster = 3
    with pytest.raises(RuntimeError, match="failed to launch"):
        cuda.launch(entry, counter, dev, ctypes.byref(args))
    args.roll_cluster, args.roll_smem = 2, args.roll_smem - 16
    with pytest.raises(RuntimeError, match="failed to launch"):
        cuda.launch(entry, counter, dev, ctypes.byref(args))


@pytest.mark.parametrize("A", [1, 3])
def test_aip_step_kernel_matches_plain(A, dev):
    rec = chip_smoke.check_aip_step(A, 20, seed=20 + A, dev=dev)
    assert rec["max_abs_err"] <= chip_smoke.ATOL


@pytest.mark.parametrize("A,B", [(1, 1), (25, 1), (1, 17), (3, 100),
                                 (2, 33)])
def test_aip_step_at_odd_shapes_repeats_bitwise(A, B, dev):
    """One tick on the horizon kernel's GRU role at B = 1, ragged B and
    A = 1: within the flip rule of the plain version, and two launches on
    the same inputs give the same bits."""
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.nn.act import random_bits
    rec = chip_smoke.check_aip_step(A, B, seed=30 + A + B, dev=dev)
    assert rec["max_abs_err"] <= chip_smoke.ATOL
    case = chip_smoke.Case("gru", A, B, 1, seed=40 + B, dev=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(41 + B)
    d = (torch.rand((B, A, 40), generator=g, device=dev) < 0.3).float()
    h = 0.5 * torch.randn((B, A, 64), generator=g, device=dev)
    bits = random_bits((B, A, 4), g)
    first = cuda.aip_step_multi(d, h, *case.aw, bits)
    second = cuda.aip_step_multi(d, h, *case.aw, bits)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("A,B", [(25, 16), (1, 1), (3, 17), (1, 512),
                                 (25, 512)])
def test_engine_step_equals_one_tick_rollout(A, B, dev):
    """``engine.step`` (``aip_step``, then the LS tick in torch) and a
    one-tick ``engine.rollout`` (``aip_rollout_multi``) from the same
    state, actions and bits: the new h, the LS state and the reward are
    bitwise equal, since both kernels run the GRU role on the same
    K-parts (at 25 x 512 on tiles of 8 and 32 lanes)."""
    assert chip_smoke.step_matches_rollout(A, B, seed=80 + A + B,
                                           dev=dev) == {
        "aip_step": 1, "aip_rollout_multi": 1}


# the warehouse functor: 8 stacked 37-wide frames, five actions, a 24-wide
# d-set read after the action, 12 sources and the LS's spawn noise
W = "warehouse"


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A,B", [(1, 16), (3, 17), (36, 4)])
def test_warehouse_rollout_kernels_match_plain(kind, A, B, dev):
    case = chip_smoke.Case(kind, A, B, 40, seed=100 + A + B, dev=dev,
                           domain=W)
    flips, err = chip_smoke.check_rollout(case, f"{W} rollout {kind} "
                                                f"A={A} B={B}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A,B,vanish", [(1, 1, 0), (1, 16, 0), (3, 17, 8),
                                        (36, 4, 0)])
def test_warehouse_policy_rollout_matches_plain(kind, A, B, vanish, dev):
    """Both routes of the action to the d-set: a cluster of two (the
    policy's argmax, then the cluster meets) at every shape here, resets
    inside the horizon, spawns on, items that vanish after 8 ticks."""
    case = chip_smoke.Case(kind, A, B, 48, seed=110 + A + B, dev=dev,
                           domain=W, vanish_after=vanish)
    assert bool(case.done.any())
    flips, err = chip_smoke.check_policy(case, f"{W} policy {kind} A={A} "
                                               f"B={B} vanish={vanish}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kind", ["gru", "fnn"])
def test_warehouse_policy_rollout_on_one_cta(kind, dev):
    """The plan's other route: policy and AIP in one CTA (cluster 1, one
    lane a tile), where a block barrier takes the action to the d-set. At
    policy hidden 128 the two roles do not fit one CTA; at 64 they do."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.Case(kind, 1, 4, 24, seed=130, dev=dev, domain=W,
                           pol_hidden=64)
    entry, counters, args, out, plan, keep = cuda.policy_rollout_args(
        case.io.ls, case.s0, case.frames0, case.aw, case.pw, case.gumbel,
        case.bits, case.done, case.io.noise, case.reset_ls, kind=kind,
        n_agents=1, fast_gates=True, domain=case.ls_env.kernel_domain,
        lanes=1, cluster=1)
    assert plan.cluster == 1
    cuda.launch(entry, counters, dev, ctypes.byref(args))
    torch.cuda.synchronize()
    trace = {}
    plain = case.policy_call(plain=True, trace=trace)
    margins = torch.minimum(torch.stack(trace["aip"]),
                            torch.stack(trace["policy"]))
    (kl, ks, kf, kx, ka, klg, kv, kr), (pl, ps, pf, px, pa, plg, pv, pr) = \
        out, plain
    chip_smoke.compare_lanes(
        f"{W} policy {kind} one CTA",
        [(kx, px, False), (ka, pa, True), (klg, plg, False),
         (kv, pv, False), (kr, pr, False)],
        [(k, p, True) for k, p in zip(kl, pl)]
        + [(ks, ps, False), (kf, pf, False)], margins, case.T, 4)


@pytest.mark.parametrize("kernel", ["policy fnn", "policy gru",
                                    "fnn_rollout", "aip_rollout_multi"])
def test_warehouse_horizon_kernels_repeat_bitwise(kernel, dev):
    kind = "fnn" if "fnn" in kernel else "gru"
    case = chip_smoke.Case(kind, 3, 16, 32, seed=140, dev=dev, domain=W)
    call = case.policy_call if kernel.startswith("policy") \
        else case.rollout_call
    first, second = call(), call()
    torch.cuda.synchronize()
    leaves = [(a, b) for x, y in zip(first, second)
              for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)])]
    assert all(torch.equal(a, b) for a, b in leaves)


@pytest.mark.parametrize("A,B", [(36, 16), (1, 16), (3, 17)])
def test_warehouse_engine_step_equals_one_tick_rollout(A, B, dev):
    assert chip_smoke.step_matches_rollout(A, B, seed=150 + A + B, dev=dev,
                                           domain=W) == {
        "aip_step": 1, "aip_rollout_multi": 1}


def test_warehouse_launches_count_per_domain_and_refusals_raise(dev):
    """A warehouse launch counts on its kernel's counter and on its
    "[warehouse]" one; an unknown domain, a missing spawn leaf and a
    d-set width the functor does not compute are refused by the kernel,
    and the wrapper raises."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.Case("gru", 3, 8, 8, seed=160, dev=dev, domain=W)
    cuda.reset_launches()
    case.policy_call()
    case.rollout_call()
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["policy_rollout_gru"] == 1
    assert cuda.LAUNCHES["policy_rollout_gru[warehouse]"] == 1
    assert cuda.LAUNCHES["aip_rollout_multi[warehouse]"] == 1
    assert cuda.LAUNCHES["aip_rollout_multi[traffic]"] == 0
    for field, value in (("domain", 2), ("D", 25), ("noise", 0)):
        entry, counters, args, _, _, keep = cuda.policy_rollout_args(
            case.io.ls, case.s0, case.frames0, case.aw, case.pw,
            case.gumbel, case.bits, case.done, case.io.noise,
            case.reset_ls, kind="gru", n_agents=3, fast_gates=True,
            domain=case.ls_env.kernel_domain)
        if field == "noise":
            args.noise[0] = None
        else:
            setattr(args, field, value)
        with pytest.raises(RuntimeError, match="failed to launch"):
            cuda.launch(entry, counters, dev, ctypes.byref(args))


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("S", [1, 13, 48, 128, 4096])
@pytest.mark.parametrize("N", [1, 3, 4])
def test_serve_kernels_match_plain_and_hold_the_contracts(domain, S, N,
                                                          dev):
    """Each regime of the launch plan (4 to 32 lanes a tile, every chunk
    resident at the traffic widths, a ring at the warehouse widths), with
    pidx of -1 and N among the lanes from S = 13 on."""
    case = chip_smoke.ServeCase(domain, S, N, seed=30 + S + N, dev=dev)
    for multi in ((False, True) if N == 1 else (True,)):
        flips, err = chip_smoke.check_serve(
            case, multi, f"serve multi={multi} {domain} S={S} N={N}")
        assert err <= chip_smoke.ATOL and flips <= max(
            1, chip_smoke.MAX_FLIP_SHARE * S)


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("route", ["skip", "one", "masked"])
def test_serve_kernels_on_shaped_slots(domain, route, dev):
    """A slot where one policy has no lane, one where every lane routes to
    one policy, and an all-masked slot (every lane must come back 0)."""
    case = chip_smoke.ServeCase(domain, 128, 4, seed=60, dev=dev,
                                route=route)
    flips, err = chip_smoke.check_serve(case, True,
                                        f"serve {domain} {route}")
    assert err <= chip_smoke.ATOL and flips <= 1
    if route == "masked":
        single = chip_smoke.ServeCase(domain, 128, 1, seed=61, dev=dev,
                                      route=route)
        chip_smoke.check_serve(single, False, f"serve {domain} masked")


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("N", [1, 3])
def test_serve_kernels_stage_unaligned_rows_by_plain_loads(domain, N, dev):
    """Hidden 66: rows of 264 bytes and a 792- or 1,584-byte head are no
    16-byte multiples, so the plan stages them by plain loads."""
    from repro_torch.kernels.aip_step import serve_plan
    D, NA = chip_smoke.SERVE_WIDTHS[domain]
    plan = serve_plan(48, D, 66, NA + 1, N)
    assert not plan.ring_bulk
    case = chip_smoke.ServeCase(domain, 48, N, seed=70 + N, dev=dev, hp=66)
    for multi in ((False, True) if N == 1 else (True,)):
        flips, err = chip_smoke.check_serve(case, multi,
                                            f"serve {domain} hp=66")
        assert err <= chip_smoke.ATOL and flips <= 1


@pytest.mark.parametrize("hp,cols", [(256, 2), (512, 4)])
def test_serve_kernels_at_wide_hidden_layers(hp, cols, dev):
    """4096 lanes at hidden 256 and 512: a ring of K-chunks, and register
    tiles of 2 and 4 columns a thread to stay within 512 threads."""
    from repro_torch.kernels.aip_step import serve_plan
    assert serve_plan(4096, 41, hp, 3, 1).cols_per_thread == cols
    case = chip_smoke.ServeCase("traffic", 4096, 1, seed=90 + cols, dev=dev,
                                hp=hp)
    for multi in (False, True):
        flips, err = chip_smoke.check_serve(case, multi,
                                            f"serve hidden {hp}")
        assert err <= chip_smoke.ATOL and flips <= max(
            1, chip_smoke.MAX_FLIP_SHARE * case.S)


def test_serve_launch_refused_raises(dev):
    """A plan the kernel cannot run is refused and the wrapper raises:
    no fallback."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.ServeCase("traffic", 128, 1, seed=80, dev=dev)
    args, *_, keep = cuda.serve_args(case.frames, case.mask, None,
                                     case.single[0], fast_gates=True,
                                     lead=())
    args.serve_threads = 1024
    with pytest.raises(RuntimeError, match="failed to launch"):
        cuda.launch("ials_serve_forward", "serve_forward", dev,
                    ctypes.byref(args))


@pytest.mark.parametrize("B,T,dtype", [(1, 16, "float32"),
                                        (7, 16, "float32"),
                                        (1000, 16, "float32"),
                                        (1000, 1, "float32"),
                                        (7, 16, "bfloat16"),
                                        (1000, 16, "bfloat16")])
def test_gru_sequence_at_odd_shapes(B, T, dtype, dev):
    """Rows off the tile (1 and 7 rows: a tile of 1; 1000: tiles of 8
    whose grid misses a wave's 132 by 7), one tick, bf16."""
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.LayerCase("gru_sequence", (B, T, 40, 64, dtype),
                                seed=B + T, dev=dev)
    cuda.reset_launches()
    chip_smoke.check_layer(case, f"gru_sequence B={B} T={T} {dtype}")
    assert cuda.LAUNCHES["gru_sequence"] == 1


@pytest.mark.parametrize("kw", [{}, {"rows": 4}, {"route": "l2",
                                                "parts": 8},
                                {"route": "l2", "parts": 4}])
def test_gru_sequence_repeats_bitwise(kw, dev):
    """The K-parts are summed in a fixed order: two launches give the same
    bits, under the plan and under other plans with the same parts (rows,
    the "l2" route) or other parts."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import gru
    g = torch.Generator(device=dev)
    g.manual_seed(80)
    x = torch.randn((1024, 32, 40), generator=g, device=dev)
    wx, wh = (0.2 * torch.randn(s, generator=g, device=dev)
              for s in ((40, 192), (64, 192)))
    b, h0 = (0.1 * torch.randn(s, generator=g, device=dev)
             for s in ((192,), (1024, 64)))
    outs = []
    for _ in range(2):
        args, hs, plan, keep = gru.gru_args(x, wx, wh, b, h0, **kw)
        cuda.launch("gru_sequence_run", "gru_sequence", dev,
                    ctypes.byref(args))
        torch.cuda.synchronize()
        outs.append(hs)
    assert torch.equal(outs[0], outs[1])
    if kw.get("parts", 8) == 8:
        # the same parts sum in the same order, whatever the rows a tile
        # or where the weights are read from: the plan's bits
        want, _ = gru.gru_sequence(x, wx, wh, b, h0)
        assert torch.equal(outs[0], want)


def test_gru_launch_refused_raises(dev):
    """A plan the GRU kernel cannot run is refused and the wrapper raises:
    no fallback."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import gru
    x = torch.zeros((16, 4, 40), device=dev)
    w = [torch.zeros(s, device=dev) for s in ((40, 192), (64, 192), (192,),
                                              (16, 64))]
    for field, value in (("parts", 3), ("rows", 16), ("smem", 16),
                         ("threads", 1024), ("units", 32),
                         ("units_per_thread", 2)):
        args, *_ = gru.gru_args(x, *w)
        setattr(args, field, value)
        with pytest.raises(RuntimeError, match="failed to launch"):
            cuda.launch("gru_sequence_run", "gru_sequence", dev,
                        ctypes.byref(args))


@pytest.mark.parametrize("op,label", LAYER_CASES)
def test_layer_kernel_matches_plain(op, label, dev):
    from repro_torch.kernels import aip_step as cuda
    cases = {"gru_sequence": chip_smoke.GRU_CASES,
             "rmsnorm": chip_smoke.RMS_CASES,
             "flash_attention": chip_smoke.FLASH_CASES}[op]
    case = chip_smoke.LayerCase(op, cases[label], seed=len(label), dev=dev)
    cuda.reset_launches()
    chip_smoke.check_layer(case, f"{op} {label}")   # raises if outside tol
    assert cuda.LAUNCHES[op] == 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bh_entry_matches_plain(causal, dtype, dev):
    """``flash_attention`` on heads pre-flattened into the batch (head
    stride 0, one head): T != S, Dv != D, against ``flash_attention_ref``."""
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev)
    g.manual_seed(40 + causal)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((6, 128, 64), (6, 192, 64), (6, 192, 32)))
    cuda.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, bq=64, bk=64)
    assert cuda.LAUNCHES["flash_attention"] == 1
    chip_smoke._near(out, ref.flash_attention_ref(q, k, v, causal=causal),
                     chip_smoke.LAYER_TOL["flash_attention"], "flash (BH)")


@pytest.mark.parametrize("dtype,D,route", [
    ("bfloat16", 128, "flash_attention[wgmma]"),
    ("float32", 128, "flash_attention[f32]"),
    ("bfloat16", 40, "flash_attention[f32]"),
])
def test_flash_attention_counts_the_route_it_took(dtype, D, route, dev):
    """bf16 with D in steps of 16 moves the tensor-core counter and not
    the CUDA-core one; f32, or a width off the steps, the reverse."""
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev)
    g.manual_seed(50 + D)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((1, 128, 4, D), generator=g, device=dev).to(dt)
               for _ in range(3))
    cuda.reset_launches()
    ops.flash_attention_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    other = ({"flash_attention[wgmma]", "flash_attention[f32]"}
             - {route}).pop()
    assert cuda.LAUNCHES[route] == 1 and cuda.LAUNCHES[other] == 0
    assert cuda.LAUNCHES["flash_attention"] == 1


_F32_CASES = [label for label, dims in chip_smoke.FLASH_CASES.items()
              if dims[8] == "float32" or label == "bf16 D40 off-16"]


@pytest.mark.parametrize("label", _F32_CASES)
def test_flash_f32_kernel_repeats_bitwise(label, dev):
    """The CUDA-core flash kernel sums in a fixed order (d in order, keys
    in order, shuffle trees): two calls on the same inputs give the same
    bits, and both take that kernel."""
    from repro_torch.kernels import aip_step as cuda
    case = chip_smoke.LayerCase("flash_attention",
                                chip_smoke.FLASH_CASES[label],
                                seed=len(label) + 3, dev=dev)
    cuda.reset_launches()
    first, second = case.call(), case.call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert cuda.LAUNCHES["flash_attention[f32]"] == 2
    assert cuda.LAUNCHES["flash_attention[wgmma]"] == 0


def test_flash_f32_plan_refused_raises(dev):
    """A plan the CUDA-core kernel is not built for, or whose shared
    bytes disagree with the kernel's, is refused: the wrapper raises."""
    import ctypes
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((1, 128, 2, 64), device=dev)
    o = torch.empty_like(q)
    a = fa.FlashArgs(q=q.data_ptr(), k=q.data_ptr(), v=q.data_ptr(),
                     o=o.data_ptr(), nbh=2, nh=2, group=1, T=128, S=128,
                     D=64, Dv=64, causal=1, q_sb=128 * 128, q_sh=64,
                     q_st=128, k_sb=128 * 128, k_sh=64, k_ss=128,
                     v_sb=128 * 128, v_sh=64, v_ss=128, o_sb=128 * 128,
                     o_sh=64, o_st=128, scale=0.125)
    fa.set_f32_plan(a, fa.f32_plan(128, 128, 64, 64))
    for field, value in (("f32_rows", 32), ("f32_threads", 128),
                         ("f32_stages", 4), ("f32_smem", 16)):
        b = fa.FlashArgs.from_buffer_copy(a)
        setattr(b, field, value)
        with pytest.raises(RuntimeError, match="failed to launch"):
            cuda.launch("layer_flash_attention", "flash_attention[f32]",
                        dev, ctypes.byref(b), 0)


_PLANS = {"128 rows, 8 x 4": dict(rows=128), "64 rows": dict(rows=64)}
_PLAN_CASES = ["T128 causal", "T128 S256 cross", "ragged Dv<D", "T1",
               "GQA wrapper", "T256 D128", "D256", "bf16 D40 off-16",
               "f32 128-row blocks ragged", "f32 odd widths",
               "f32 causal S<T"]


# 128-row blocks hold D, Dv <= 128: D256 takes the 64-row build only
_PLAN_PAIRS = [(label, plan) for label in _PLAN_CASES for plan in _PLANS
               if label != "D256" or plan == "64 rows"]


@pytest.mark.parametrize("label,plan", _PLAN_PAIRS)
def test_flash_f32_every_plan_matches_plain(label, plan, dev):
    """Each build of the CUDA-core kernel that ``f32_plan`` can ask for
    (128 rows, 64 rows), launched from the port's
    library by ``tools/flash_f32_ablation.py``'s runner at ragged, cross,
    T = 1, GQA and off-16 bf16 shapes, within chip_smoke's tolerance."""
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import ref
    from tools import flash_f32_ablation as tool
    B, T, S, H, KH, D, Dv, causal, dt = chip_smoke.FLASH_CASES[label][:9]
    g = torch.Generator(device=dev)
    g.manual_seed(len(label) + len(plan))
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, T, H, D), (B, S, KH, D), (B, S, KH, Dv)))
    call, out, _, _ = tool.runner(cuda.build(), q, k, v, causal,
                                  **_PLANS[plan])
    call()
    torch.cuda.synchronize()
    chip_smoke._near(out, ref.flash_attention_mha_ref(q, k, v,
                                                      causal=causal),
                     chip_smoke.LAYER_TOL["flash_attention"],
                     f"{label} {plan}")


_DRYRUN_CELLS = [("aip_rollout_multi", "warehouse", "gru", 4, 8),
                 ("fnn_rollout", "traffic", "fnn", 1, 8),
                 ("policy_rollout", "traffic", "fnn", 3, 8),
                 ("train_iteration", "warehouse", "gru", 1, 8)]


@pytest.mark.parametrize("program,domain,backbone,A,B", _DRYRUN_CELLS)
def test_a_dry_run_host_cell_runs_on_the_card(program, domain, backbone, A,
                                              B, dev):
    """``launch/dryrun.py``'s host cell at a small shape (T = 8): counted on
    the CPU, its program run once on the card: one launch of its horizon
    kernel (``custom_call_count``), the peak at least what it holds."""
    from repro_torch.launch import dryrun
    cell = dryrun.run_ials_cell(program, domain, backbone, A, B, 8, "host",
                                device="cuda")
    kernel = (f"policy_rollout_{backbone}"
              if program in ("policy_rollout", "train_iteration")
              else program)
    assert cell["status"] == "ok" and "ranks_refuse" not in cell
    assert cell["launches"] == {kernel: 1, f"{kernel}[{domain}]": 1}
    assert cell["ops"]["custom_call_count"] == 1
    mem = cell["memory"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"]
    assert cell["measured_on"] == torch.cuda.get_device_name(0)
