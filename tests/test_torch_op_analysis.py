"""``distributed/op_analysis.py``, the counted aten ops of the port's
roofline (counterpart of ``tests/test_hlo_analysis.py``), on the CPU: the
matrix products count 2*M*N*K, elementwise ops their result's elements and
reductions their input's, an eager loop of n ticks n bodies (nested loops
multiply: the eager counterpart of the reference's loop correction),
views are free in the HBM bytes, ``flops`` is ``flops_dot`` plus
``flops_elementwise``, the port's gather notes its operand bytes, a kernel
launch counts as an opaque call, ``roofline`` follows the H100's
constants and the dots' dtype, and the dot FLOPs agree with
``torch.utils.flop_counter.FlopCounterMode`` (a cross-check only) on an
MLP forward and backward."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import test_torch_common  # noqa: F401  (one torch thread)

from repro_torch.distributed import op_analysis, sharding  # noqa: E402
from repro_torch.distributed.op_analysis import analyze, roofline  # noqa
from repro_torch.kernels import aip_step  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402


def _r(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g).to(dtype)


M, K, N, NB = 5, 7, 3, 4
DOT_CASES = {
    "mm": (lambda: torch.mm(_r(M, K), _r(K, N)), 2 * M * N * K),
    "bmm": (lambda: torch.bmm(_r(NB, M, K), _r(NB, K, N)),
            2 * NB * M * N * K),
    "addmm": (lambda: torch.addmm(_r(N), _r(M, K), _r(K, N)),
              2 * M * N * K),
    "baddbmm": (lambda: torch.baddbmm(_r(NB, M, N), _r(NB, M, K),
                                      _r(NB, K, N)), 2 * NB * M * N * K),
    "mv": (lambda: torch.mv(_r(M, K), _r(K)), 2 * M * K),
    "dot": (lambda: torch.dot(_r(K), _r(K)), 2 * K),
    "matmul 3-D x 2-D": (lambda: torch.matmul(_r(NB, M, K), _r(K, N)),
                         2 * NB * M * N * K),
    "linear": (lambda: torch.nn.functional.linear(_r(M, K), _r(N, K),
                                                  _r(N)), 2 * M * N * K),
    "einsum": (lambda: torch.einsum("bmk,bkn->bmn", _r(NB, M, K),
                                    _r(NB, K, N)), 2 * NB * M * N * K),
}


@pytest.mark.parametrize("case", sorted(DOT_CASES))
def test_matmul_family_dots_count_2mnk(case):
    fn, want = DOT_CASES[case]
    assert analyze(fn)["flops_dot"] == want


ELEM_CASES = {
    # (fn, elementwise FLOPs): the result's elements, a reduction its
    # input's, a foreach op its list's, an addmm its bias add's
    "broadcast add": (lambda: _r(M, K) + _r(K), M * K),
    "exp": (lambda: torch.exp(_r(M, K)), M * K),
    "compare + where": (lambda: torch.where(_r(M, K) > 0, _r(M, K), 0.0),
                        2 * M * K),
    "sum over the last axis": (lambda: _r(M, K).sum(-1), M * K),
    "mean of all": (lambda: _r(M, K).mean(), M * K),
    "argmax": (lambda: torch.argmax(_r(M, K), -1), M * K),
    "foreach mul": (lambda: torch._foreach_mul([_r(M, K), _r(N)], 2.0),
                    M * K + N),
    "in-place foreach add": (lambda: torch._foreach_add_(
        [_r(M, K), _r(N)], 1.0), M * K + N),
    "addmm's bias": (lambda: torch.addmm(_r(N), _r(M, K), _r(K, N)),
                     M * N),
    "a copy": (lambda: _r(M, K).clone(), 0),
}


@pytest.mark.parametrize("case", sorted(ELEM_CASES))
def test_elementwise_ops_count_their_result_and_reductions_their_input(
        case):
    fn, want = ELEM_CASES[case]
    got = analyze(fn)
    assert got["flops_elementwise"] == want


def _tick(h, w):
    return torch.tanh(h @ w) * 0.5


@pytest.mark.parametrize("n", [1, 3, 7])
def test_a_loop_of_n_ticks_counts_n_bodies(n):
    h, w = _r(4, 8), _r(8, 8)

    def horizon(h, ticks):
        for _ in range(ticks):
            h = _tick(h, w)
        return h

    one = analyze(horizon, h, 1)
    got = analyze(horizon, h, n)
    for key in ("flops", "flops_dot", "flops_elementwise", "hbm_bytes",
                "n_ops"):
        assert got[key] == n * one[key], key
    assert one["flops_dot"] == 2 * 4 * 8 * 8


def test_nested_loops_multiply():
    h, w = _r(4, 8), _r(8, 8)

    def nested(h, outer, inner):
        for _ in range(outer):
            for _ in range(inner):
                h = _tick(h, w)
        return h

    one = analyze(nested, h, 1, 1)
    got = analyze(nested, h, 3, 4)
    assert got["flops"] == 12 * one["flops"]
    assert got["n_ops"] == 12 * one["n_ops"]


def test_views_are_free_in_hbm_bytes():
    x = _r(4, 6)

    def views(x):
        return x.reshape(6, 4).t()[1:].unsqueeze(0).detach().expand(
            2, 3, 6).transpose(0, 2)

    got = analyze(views, x)
    assert got["hbm_bytes"] == 0 and got["flops"] == 0
    assert got["n_ops"] >= 6
    # a copy moves its operand and its result
    assert analyze(lambda: x.clone())["hbm_bytes"] == 2 * x.numel() * 4


def test_flops_is_dot_plus_elementwise():
    w1, w2 = _r(6, 16).requires_grad_(), _r(16, 3).requires_grad_()
    x = _r(10, 6)

    def step():
        loss = torch.log_softmax(torch.relu(x @ w1) @ w2, -1).sum()
        return torch.autograd.grad(loss, [w1, w2])

    got = analyze(step)
    assert got["flops_dot"] > 0 and got["flops_elementwise"] > 0
    assert got["flops"] == got["flops_dot"] + got["flops_elementwise"]


def test_the_ports_gather_counts_its_operand_bytes():
    """``sharding.gather_block`` on rank 0 of a (data = 2) layout: one
    all-gather of this rank's block, its bytes (a bool block as its uint8
    wire), every rank's block standing in as this rank's."""
    rank = sharding.LayoutRank(MeshLayout(("data", "model"), (2, 1)))
    blk = _r(3, 5)
    got = op_analysis.OpCounter()
    with got:
        full = sharding.gather_block(blk, ("data",), rank)
        flags = sharding.gather_block(blk > 0, ("data",), rank)
        sharding.gather_block(blk, (), rank)          # replicated: none
    assert torch.equal(full, torch.cat([blk, blk]))
    assert torch.equal(flags, torch.cat([blk > 0, blk > 0]))
    res = got.result()
    assert res["collective_counts"] == {"all-gather": 2}
    assert res["collective_bytes"] == {"all-gather": 15 * 4 + 15}
    assert res["collective_bytes_total"] == 75
    with op_analysis.OpCounter() as red:
        op_analysis.note_collective("all-reduce", blk)
    assert red.result()["collective_bytes_total"] == 2 * 15 * 4
    op_analysis.note_collective("all-gather", blk)   # no count active


def test_a_kernel_launch_is_an_opaque_call():
    """A launch of the port's CUDA kernels counts in custom_call_count and
    adds no FLOPs (a Pallas custom-call to the reference); the per-domain
    copy of a counter is not a second launch."""
    def launch():
        aip_step.LAUNCHES["fnn_rollout"] += 1
        aip_step.LAUNCHES["fnn_rollout[traffic]"] += 1

    before = dict(aip_step.LAUNCHES)
    try:
        got = analyze(launch)
    finally:
        aip_step.LAUNCHES.update(before)
    assert got["custom_call_count"] == 1
    assert got["flops"] == 0 and got["n_ops"] == 0


def _ana(flops_dot, elem, hbm, coll, dtype="float32"):
    return {"flops": flops_dot + elem, "flops_dot": flops_dot,
            "flops_dot_by_dtype": {dtype: flops_dot},
            "flops_elementwise": elem, "hbm_bytes": hbm,
            "collective_bytes_total": coll}


def test_roofline_follows_the_h100_constants():
    rf = roofline(_ana(67e12, 0.0, 1.675e12, 4.5e9), 1, model_flops=33.5e12)
    assert rf["t_compute_s"] == pytest.approx(1.0)
    assert rf["t_memory_s"] == pytest.approx(0.5)
    assert rf["t_collective_s"] == pytest.approx(0.01)    # NVLink
    assert rf["bottleneck"] == "compute"
    assert rf["step_time_lower_bound_s"] == pytest.approx(1.0)
    assert rf["peak_flops"] == 67e12
    assert rf["model_flops_total"] == 33.5e12
    assert rf["useful_flops_ratio"] == pytest.approx(0.5)
    assert rf["mfu_upper_bound"] == pytest.approx(0.5)
    mem = roofline(_ana(1e9, 1e9, 3.35e12, 0.0), 256)
    assert mem["bottleneck"] == "memory"
    assert mem["t_memory_s"] == pytest.approx(1.0)
    # past one 8-card NVLink domain, a NIC a card
    coll = roofline(_ana(0.0, 0.0, 0.0, 50e9), 256)
    assert coll["bottleneck"] == "collective"
    assert coll["t_collective_s"] == pytest.approx(1.0)
    assert roofline(_ana(0.0, 0.0, 0.0, 450e9), 8)["t_collective_s"] == \
        pytest.approx(1.0)


@pytest.mark.parametrize("dtype,peak", [("float32", 67e12),
                                        ("bfloat16", 989e12),
                                        ("float16", 989e12)])
def test_the_compute_peak_follows_the_dots_dtype(dtype, peak):
    x, w = _r(8, 16, dtype=getattr(torch, dtype)), \
        _r(16, 4, dtype=getattr(torch, dtype))
    got = analyze(lambda: x @ w)
    assert got["flops_dot_by_dtype"] == {dtype: 2 * 8 * 16 * 4}
    rf = roofline(got, 1)
    assert rf["peak_flops"] == peak
    assert rf["t_compute_s"] == pytest.approx(2 * 8 * 16 * 4 / peak)


def test_dot_flops_agree_with_flop_counter_mode():
    """A small MLP, forward and backward: the dispatch mode's dot FLOPs
    equal ``FlopCounterMode``'s total (which counts products only)."""
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn((a, b), generator=g, requires_grad=True)
          for a, b in ((12, 32), (32, 32), (32, 5))]
    bs = [torch.zeros((b,), requires_grad=True) for b in (32, 32, 5)]
    x = torch.randn((24, 12), generator=g)

    def step():
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = torch.nn.functional.linear(h, w.t(), b)
            h = torch.tanh(h) if i < 2 else h
        loss = torch.nn.functional.cross_entropy(
            h, torch.arange(24) % 5)
        return torch.autograd.grad(loss, ws + bs)

    flop_counter = FlopCounterMode(display=False)
    with flop_counter:
        step()
    assert analyze(step)["flops_dot"] == flop_counter.get_total_flops()
