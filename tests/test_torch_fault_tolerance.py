"""The port's ``distributed/fault_tolerance.py`` against the reference's
(``tests/test_checkpoint.py``'s guard, straggler and elastic tests, on
the port's ``checkpoint/ckpt.py``): the guard resumes from the latest
committed checkpoint, a SIGTERM forces one flush and is then answered,
stacked guards chain their handlers and ``uninstall`` restores them; the
straggler detector and ``elastic_plan`` equal the reference's on a grid
of inputs."""
import itertools
import os
import signal

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one torch thread)

import torch  # noqa: E402

from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    ElasticPlan, StragglerDetector, TrainingGuard, elastic_plan)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.zeros((16,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_guard_resume(tmp_path):
    guard = TrainingGuard(tmp_path, save_every=2,
                          install_signal_handler=False)
    state, start = guard.resume_or(lambda: _tree())
    assert start == 0
    assert not guard.maybe_save(1, state)          # not due
    assert guard.maybe_save(2, state)
    guard2 = TrainingGuard(tmp_path, install_signal_handler=False)
    state2, start2 = guard2.resume_or(lambda: _tree(seed=99))
    assert start2 == 2
    # restored values are the SAVED ones, not the fresh init
    assert torch.equal(state2["params"]["w"], state["params"]["w"])
    assert state2["params"]["b"].dtype == torch.bfloat16


def test_guard_preemption_flush(tmp_path):
    guard = TrainingGuard(tmp_path, save_every=1000,
                          install_signal_handler=False)
    guard.preempted = True          # as the SIGTERM handler would set
    assert guard.maybe_save(3, _tree())
    assert ckpt.latest_step(tmp_path) == 3


def test_guard_clears_preempted_after_flush(tmp_path):
    """A forced save answers the signal exactly once."""
    guard = TrainingGuard(tmp_path, save_every=1000,
                          install_signal_handler=False)
    guard.preempted = True
    assert guard.maybe_save(3, _tree())
    assert not guard.preempted
    assert not guard.maybe_save(4, _tree())     # no longer forced
    assert ckpt.latest_step(tmp_path) == 3


def test_guard_keeps_a_signal_that_lands_during_a_save(tmp_path,
                                                      monkeypatch):
    """A SIGTERM that arrives while a periodic save is being written is
    not cleared by that save: the next ``maybe_save`` flushes for it."""
    guard = TrainingGuard(tmp_path, save_every=1,
                          install_signal_handler=False)
    orig = ckpt.save

    def save_and_signal(*a, **kw):
        out = orig(*a, **kw)
        guard.preempted = True          # the handler, mid-save
        return out

    monkeypatch.setattr(ckpt, "save", save_and_signal)
    assert guard.maybe_save(1, _tree())
    assert guard.preempted              # still to be answered
    monkeypatch.setattr(ckpt, "save", orig)
    guard.save_every = 1000
    assert guard.maybe_save(2, _tree()) and not guard.preempted


def test_guard_decides_on_the_agreed_flag_and_makes_the_state_when_due(
        tmp_path):
    """Under ranks: ``preempted=`` (the flag the ranks agreed on) decides
    in place of this process's own, a signal that arrived after the
    agreement stays set for the next call, and a state given as a
    function is made only when a save is due, on a writer and a
    non-writer alike (it may be a collective); a non-writer writes
    nothing."""
    made = []

    def make():
        made.append(1)
        return _tree()
    for writer, d in ((True, tmp_path / "w"), (False, tmp_path / "n")):
        made.clear()
        guard = TrainingGuard(d, save_every=3, writer=writer,
                              install_signal_handler=False)
        assert not guard.maybe_save(1, make, preempted=False)
        guard.preempted = True         # after the ranks agreed on False
        assert not guard.maybe_save(2, make, preempted=False)
        assert made == [] and guard.preempted and not guard.answered
        assert guard.maybe_save(3, make, preempted=False)   # periodic
        assert made == [1] and guard.preempted and not guard.answered
        assert guard.maybe_save(4, make, preempted=True)    # agreed
        assert made == [1, 1] and guard.answered and not guard.preempted
        assert ckpt.all_steps(d) == ([3, 4] if writer else [])


def test_guard_sigterm_chains_and_uninstalls(tmp_path):
    """Stacked guards both see SIGTERM (the newer handler chains the
    displaced one), and uninstall() restores exactly what it displaced."""
    orig = signal.getsignal(signal.SIGTERM)
    g1 = TrainingGuard(tmp_path / "a")
    g2 = TrainingGuard(tmp_path / "b")
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert g2.preempted and g1.preempted    # chained, not swallowed
        g1.preempted = g2.preempted = False
        g2.uninstall()
        os.kill(os.getpid(), signal.SIGTERM)
        assert g1.preempted and not g2.preempted
    finally:
        g2.uninstall()                          # idempotent
        g1.uninstall()
    assert signal.getsignal(signal.SIGTERM) == orig


def test_straggler_detector_fires_on_sustained_slowdown():
    det = StragglerDetector(threshold=2.0, patience=3, warmup=5)
    fired = [s for s in range(30) if det.update(s, 1.0 if s < 20 else 5.0)]
    assert fired and fired[0] >= 20


def test_straggler_detector_ignores_blips():
    det = StragglerDetector(threshold=2.0, patience=3, warmup=5)
    for step in range(50):
        assert not det.update(step, 5.0 if step % 10 == 0 else 1.0)


@pytest.mark.parametrize("seed", range(3))
def test_straggler_detector_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    times = np.where(rng.random(200) < 0.15, 4.0, 1.0) * rng.uniform(
        0.8, 1.2, 200)
    times[120:140] *= 3.0                        # one sustained straggle
    port = StragglerDetector(threshold=2.0, patience=3, warmup=5)
    jref = jft.StragglerDetector(threshold=2.0, patience=3, warmup=5)
    got = [port.update(i, float(t)) for i, t in enumerate(times)]
    want = [jref.update(i, float(t)) for i, t in enumerate(times)]
    assert got == want and any(got)
    assert port.events == jref.events


def test_elastic_plan_shrinks_data_axis():
    p = elastic_plan(15, 16, model_parallel=16, global_batch=240)
    assert p.mesh_shape[-1] == 16
    data = p.mesh_shape[0]
    assert data * 16 <= 15 * 16
    assert 240 % data == 0


def test_elastic_plan_raises_when_too_small():
    with pytest.raises(ValueError):
        elastic_plan(1, 4, model_parallel=16, global_batch=64)


@pytest.mark.parametrize("pods", [1, 2, 4])
def test_elastic_plan_equals_the_reference(pods):
    """Over a grid of surviving hosts, chips a host, model degrees and
    global batches: the same plan, or the same refusal."""
    n = 0
    for hosts, cph, mp, gb in itertools.product(
            range(1, 17), (1, 4, 8), (1, 2, 4, 8, 16), (6, 64, 96, 240)):
        try:
            want = jft.elastic_plan(hosts, cph, model_parallel=mp,
                                    global_batch=gb, pods=pods)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                elastic_plan(hosts, cph, model_parallel=mp, global_batch=gb,
                             pods=pods)
            assert str(err.value) == str(e)
            continue
        got = elastic_plan(hosts, cph, model_parallel=mp, global_batch=gb,
                           pods=pods)
        assert isinstance(got, ElasticPlan)
        assert got.__dict__ == want.__dict__
        n += 1
    assert n > 500
