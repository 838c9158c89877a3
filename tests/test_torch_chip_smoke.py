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
