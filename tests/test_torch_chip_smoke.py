"""``chip_smoke.py``'s counting of profiled launches
(``timed_events``), on the CPU with stand-in profiler events: the timed
calls' events are those after the device's idle gap that follows the
untimed call, each name must come a whole number of times a call, and a
profile that misses a launch gives None, so a lost launch is never
averaged over."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (imports nothing but the standard library)

REPS = 10
GAP = 5e5 * chip_smoke.PROFILE_GAP_S     # us


def _events(calls, names=("cat", "horizon"), pause_after=()):
    """Device events (us) of one untimed call, the sleep, then ``calls``
    timed calls each launching ``names`` back to back; a pause as long
    as the sleep after each call in ``pause_after``."""
    out, t = [], 0.0
    for c in range(calls + 1):
        for n in names:
            out.append(SimpleNamespace(name=n, call=c,
                                       time_range=SimpleNamespace(
                                           start=t, end=t + 3.0)))
            t += 5.0
        t += 2 * GAP if c == 0 or c in pause_after else 40.0
    return out


def test_the_timed_calls_are_those_after_the_sleep():
    timed = chip_smoke.timed_events(_events(REPS), REPS)
    assert len(timed) == 2 * REPS
    assert {e.call for e in timed} == set(range(1, REPS + 1))


def test_losing_the_untimed_calls_events_costs_nothing():
    events = [e for e in _events(REPS) if e.call > 0]
    timed = chip_smoke.timed_events(events, REPS)
    assert len(timed) == 2 * REPS


@pytest.mark.parametrize("lost", [2, 3, 9, 2 * REPS + 1])
def test_a_lost_timed_launch_fails_the_profile(lost):
    events = _events(REPS)
    del events[lost]
    assert chip_smoke.timed_events(events, REPS) is None
    assert chip_smoke.timed_events([], REPS) is None


def test_an_idle_pause_among_the_timed_calls_fails_the_profile():
    """A pause of the host (a collection, the scheduler) among the timed
    calls would hide the calls before it: the count shows it."""
    assert chip_smoke.timed_events(_events(REPS, pause_after=(4,)),
                                   REPS) is None


def test_two_launches_of_one_name_a_call():
    events = _events(REPS, names=("cat", "cat", "horizon"))
    timed = chip_smoke.timed_events(events, REPS)
    assert sum(e.name == "cat" for e in timed) == 2 * REPS


def test_the_lm_phase_parts_run_on_the_cpu():
    """Phase 8's reduced-arch comparison and its router log run on the CPU
    (here the "card" is the CPU, so every difference is 0), so a fault in
    the phase's own code shows before a chip call."""
    import torch
    from repro_torch.configs.base import get_config, list_configs, reduced
    from repro_torch.models import lm
    from repro_torch.nn import moe
    worst = chip_smoke._lm_reduced_all(torch.device("cpu"))
    assert sorted(worst) == list_configs()
    assert all(v == 0.0 for v in worst.values())
    cfg = reduced(get_config("deepseek-moe-16b"))
    g = torch.Generator()
    g.manual_seed(0)
    params = lm.init_params(cfg, g, device="cpu")
    toks, _ = chip_smoke._lm_inputs(cfg, 2, 5, g, "cpu")
    with chip_smoke._RouterLog() as log:
        lm.forward(params, cfg, {"tokens": toks})
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert len(log.calls) == n_moe
    assert tuple(log.calls[0].shape) == (10, cfg.moe_top_k)
    assert moe.moe_apply is log._real          # restored on exit


def test_the_train_phase_helpers():
    """Phase 9's pure helpers: the dry-run's model FLOPs of a qwen3-4b
    step (6 x (active - embed) x tokens: 89.3 TFLOP at 8 x 512 tokens),
    the row checks, the steady step time, the changed share and the
    gradient share."""
    import math
    import torch
    from repro_torch.configs.base import get_config
    flops = chip_smoke.train_model_flops(get_config("qwen3-4b"), 8 * 512)
    assert flops == 6.0 * (4_022_468_096 - 151_936 * 2560) * 4096
    assert round(flops / 1e12, 1) == 89.3
    rows = [{"step": i, "loss": 5.0, "ce": 5.0, "grad_norm": 1.0,
             "step_time_s": t} for i, t in enumerate([3.0, 0.5, 0.7, 0.6])]
    assert chip_smoke.check_train_rows(rows, 4, "x") == [3.0, 0.5, 0.7, 0.6]
    assert chip_smoke.steady_s([3.0, 0.5, 0.7, 0.6]) == 0.6
    with pytest.raises(AssertionError, match="rows of steps"):
        chip_smoke.check_train_rows(rows[:3], 4, "x")
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check_train_rows(
            rows[:1] + [dict(rows[1], grad_norm=math.nan)] + rows[2:], 4,
            "x")
    a = {"blk": {"w": torch.zeros(4)}, "norm": {"g": torch.ones(4)}}
    b = {"blk": {"w": torch.tensor([0., 1., 0., 1.])},
         "norm": {"g": torch.ones(4)}}
    assert chip_smoke.changed_share(a, b) == (0.25, [])
    assert chip_smoke.changed_share(a, a) == (0.0, ["['blk']['w']"])
    assert chip_smoke.grad_share(torch.tensor([1., 2.]),
                                 torch.tensor([1., 4.])) == 0.5


def test_the_train_phase_resume_signal_is_restored():
    """``_SigtermAfter`` wraps the guard's save for the run and restores
    it on exit."""
    from repro_torch.distributed import fault_tolerance as ft
    real = ft.TrainingGuard.maybe_save
    with chip_smoke._SigtermAfter(3):
        assert ft.TrainingGuard.maybe_save is not real
    assert ft.TrainingGuard.maybe_save is real


def test_the_train_phase_reduced_part_runs_on_the_cpu():
    """Phase 9's reduced-arch train step comparison runs on the CPU (the
    "card" is the CPU: every share is 0)."""
    import torch
    from repro_torch.configs.base import list_configs
    worst = chip_smoke._train_reduced_all(torch.device("cpu"))
    assert sorted(worst) == list_configs()
    for w in worst.values():
        assert w == {"grads": 0.0, "metrics": 0.0, "replay_ulps": 0.0,
                     "params_direct": 0.0}


def test_the_train_phase_bounds():
    """The gradient bound (share of the global norm, of the leaf's max,
    rtol) and the replay's ulps."""
    import torch
    b = torch.tensor([10.0, 0.0, -1e-3])
    tol = chip_smoke.TRAIN_GRAD_TOL
    # 1e-6 x 10 + 1e-4 x 10 = 1.01e-3 of room at 0
    share = chip_smoke.grad_tol_share(b + torch.tensor([0.0, 5e-4, 0.0]),
                                      b, tol, 10.0, "g")
    assert abs(share - 5e-4 / 1.01e-3) < 1e-6
    with pytest.raises(AssertionError, match="at a CPU value 0"):
        chip_smoke.grad_tol_share(b + torch.tensor([0.0, 2e-3, 0.0]), b,
                                  tol, 10.0, "g")
    one = torch.tensor([1.0, 2.0])
    nxt = torch.nextafter(one, torch.tensor([2.0, 3.0]))
    assert chip_smoke.ulps(nxt, one, "p") == 1.0
    assert chip_smoke.ulps(one, one, "p") == 0.0
    # in ulps of the larger of the value and its scale
    small = torch.tensor([2.0 ** -20])         # an ulp of 2^-43
    assert chip_smoke.ulps(small + 2.0 ** -33, small, "p") == 2.0 ** 10
    assert chip_smoke.ulps(small + 2.0 ** -33, small, "p",
                           scale=torch.tensor([2.0 ** -10])) == 1.0


def test_the_step_profile_helpers():
    from types import SimpleNamespace as NS
    ev = [NS(time_range=NS(start=0.0, end=10.0)),
          NS(time_range=NS(start=5.0, end=12.0)),
          NS(time_range=NS(start=20.0, end=25.0))]
    assert chip_smoke.busy_us(ev) == 17.0
    assert chip_smoke.kernel_kind("sm90_xmma_gemm_bf16") == "gemm"
    assert chip_smoke.kernel_kind("nvjet_tst_256x128_64x4_1x2_h") == "gemm"
    assert chip_smoke.kernel_kind("reduce_kernel<512>") == "reduce"
    assert chip_smoke.kernel_kind(
        "vectorized_elementwise_kernel<4>") == "elementwise"
    assert chip_smoke.kernel_kind("Memcpy DtoD") == "copy"
    assert chip_smoke.kernel_kind("foo") == "other"


def _lm_cell(**kw):
    cell = {"arch": "whisper-base", "shape": "decode_32k", "mesh": "pod2",
            "status": "ok", "n_chips": 512, "parallelism": "tp",
            "count_s": 2.5, "counted_by": "extrapolated",
            "trips": {"groups": 6, "encoder_layers": 6, "points": [
                {"groups": 2, "encoder_layers": 6, "count_s": 1.0},
                {"groups": 3, "encoder_layers": 6, "count_s": 1.5}]},
            "ops": {"collective_bytes_total": 3.0 * 2**30,
                    "collective_bytes": {"all-gather": 2.0 * 2**30,
                                         "all-reduce": 1.0 * 2**30},
                    "custom_call_count": 0, "flops": 4.4e8,
                    "hbm_bytes": 1.3e10},
            "memory": {"argument_bytes_per_device": 235000000,
                       "argument_bytes_global_over_chips": 105000000.0},
            "roofline": {"model_flops_bound_s": 3.1e-9,
                         "step_time_lower_bound_s": 4.1e-3,
                         "bottleneck": "memory",
                         "useful_flops_ratio": 0.0123}}
    cell.update(kw)
    return cell


def test_the_lm_sharding_phase_reads_a_dryrun_cell():
    line = chip_smoke.lm_dryrun_line(_lm_cell())
    assert line.startswith("[dryrun] whisper-base decode_32k pod2 (512")
    assert "model-FLOP bound 3.1e-09 s" in line
    assert "argument bytes 235000000 (global over chips 105000000)" in line
    assert ("counted in 2.5 s, extrapolated (trips: groups 6, "
            "encoder_layers 6; counted at [(2, 6), (3, 6)])") in line
    with pytest.raises(AssertionError, match="error"):
        chip_smoke.lm_dryrun_line(_lm_cell(status="error", stderr="x"))
    no_coll = _lm_cell()
    no_coll["ops"] = dict(no_coll["ops"], collective_bytes_total=0.0)
    with pytest.raises(AssertionError, match="no collective"):
        chip_smoke.lm_dryrun_line(no_coll)
    launched = _lm_cell()
    launched["ops"] = dict(launched["ops"], custom_call_count=2)
    with pytest.raises(AssertionError, match="kernel launches"):
        chip_smoke.lm_dryrun_line(launched)
    assert len(chip_smoke.LM_DRYRUN_CELLS) == 5


def _shard_summary(**kw):
    rank = {"param_bytes": 10, "param_bytes_expected": 10,
            "moment_bytes": 20, "moment_bytes_expected": 20,
            "max_memory_allocated": 123, "step_s": [2.0, 1.0],
            "kernel_launches": 0}
    s = {"ok": True, "failed": [], "worst_share": {"step 0 loss": 0.01},
         "per_rank": [dict(rank), dict(rank)], "step_s": [2.0, 1.0],
         "steady_step_s": 1.0, "one_process_step_s": [0.5, 0.4],
         "loss": [[1.0, 1.0], [0.9, 0.9]]}
    s.update(kw)
    return s


def test_the_lm_sharding_phase_reads_a_shard_summary():
    line = chip_smoke.lm_shard_line(_shard_summary(), "x")
    assert "steady 1.000 s beside one process 0.400 s" in line
    assert "max_memory_allocated [123, 123]" in line
    with pytest.raises(AssertionError, match="bound"):
        chip_smoke.lm_shard_line(_shard_summary(
            ok=False, failed=["step 0 loss: 2 of the bound"]), "x")
    s = _shard_summary()
    s["per_rank"][1]["param_bytes"] = 11
    with pytest.raises(AssertionError, match="rank 1 holds 11 param"):
        chip_smoke.lm_shard_line(s, "x")
    s = _shard_summary()
    s["per_rank"][0]["kernel_launches"] = 1
    with pytest.raises(AssertionError, match="launched 1 kernels"):
        chip_smoke.lm_shard_line(s, "x")
    ep = {"ok": True, "failed": [], "worst_share": {"ep forward": 0.1},
          "per_rank": [{"param_bytes": None, "param_bytes_expected": None,
                        "moment_bytes": None, "moment_bytes_expected": None,
                        "kernel_launches": 0}],
          "ep_fwd_err": 1e-6, "ep_grad_err": 2e-5, "ep_drop_frac": 0.0,
          "ep_fwd_bwd_s": 1.5}
    assert "EP forward max |diff| 1e-06" in chip_smoke.lm_shard_line(ep,
                                                                      "ep")


def test_the_lm_sharding_phase_reads_a_mixers_summary():
    """Phase 10 (d): each mixer's times and each rank's bytes of its
    layer's weights, a rank off the global bytes over its shards fails;
    the runs cover Mamba, the mLSTM and the sLSTM at full width."""
    rank = {"param_bytes": None, "param_bytes_expected": None,
            "moment_bytes": None, "moment_bytes_expected": None,
            "kernel_launches": 0, "mixer_bytes": {"mamba": [8, 8]}}
    s = {"ok": True, "failed": [], "worst_share": {"mamba forward": 0.05},
         "per_rank": [dict(rank), dict(rank)],
         "mixers": {"mamba": {"fwd_bwd_s": 4.0, "one_process_s": 0.5}}}
    line = chip_smoke.lm_shard_line(s, "(d)")
    assert ("mamba: forward + backward 4.000 s (one process 0.500 s), the "
            "layer's weight bytes per rank [8, 8] (global over shards 8)"
            ) in line
    s["per_rank"][1] = dict(rank, mixer_bytes={"mamba": [16, 8]})
    with pytest.raises(AssertionError, match="rank 1 holds 16 bytes"):
        chip_smoke.lm_shard_line(s, "(d)")
    from repro_torch.configs.base import get_config
    kinds = set()
    for arch in chip_smoke.LM_MIXER_ARCHS:
        prologue, pattern, _ = get_config(arch).layer_plan()
        kinds |= {sp.kind for sp in list(prologue) + pattern}
    assert {"mamba", "mlstm", "slstm"} <= kinds
