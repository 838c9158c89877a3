"""Fault tolerance: preemption-safe training, stragglers, elastic resize
(counterpart of ``repro/distributed/fault_tolerance.py``, a copy of its
plain-Python logic over the port's ``checkpoint/ckpt.py``).

- ``TrainingGuard``: wraps a step loop — periodic and preemption-triggered
  checkpoints (a SIGTERM handler, chained to the one it displaces),
  automatic resume from the latest committed checkpoint.
- ``StragglerDetector``: EWMA step-time watchdog; sustained slow steps
  flag a straggler so an orchestrator can restart without it.
- ``elastic_plan``: given the surviving hosts, the largest valid
  (data, model) layout on them and the per-host batch.
"""
from __future__ import annotations

import signal
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint import ckpt


class TrainingGuard:
    """Preemption-safe step-loop guard.

    SIGTERM sets ``preempted``; the next ``maybe_save`` then flushes a
    checkpoint and *clears the flag* (a forced save answers the signal
    once, not at every later step); a signal that arrives while a save is
    being written is answered by the next call, not lost. The displaced
    SIGTERM handler is chained, not replaced, and ``uninstall()`` restores
    it. Drivers that exit on preemption read ``answered`` *after*
    ``maybe_save``: it is set by the same read of the flag that decided
    the save, so a signal landing just before the call is both flushed
    and seen (a driver reading ``preempted`` before the call would miss
    it while the save cleared it)."""

    def __init__(self, ckpt_dir: str | Path, *, save_every: int = 100,
                 keep: int = 3, install_signal_handler: bool = True,
                 writer: bool = True):
        self.ckpt_dir = Path(ckpt_dir)
        self.save_every = save_every
        self.keep = keep
        self.writer = writer      # False: decide as a writer would, write
        #                           nothing (the ranks other than 0)
        self.preempted = False
        self.answered = False     # the last maybe_save answered a signal
        self._prev_handler = None
        self._installed = False
        if install_signal_handler:
            try:
                self._prev_handler = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
                self._installed = True
            except ValueError:
                pass  # not on the main thread

    def _on_sigterm(self, signum, frame):
        self.preempted = True
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)   # chain, don't swallow

    def uninstall(self):
        """Restore the SIGTERM handler this guard displaced."""
        if self._installed:
            signal.signal(signal.SIGTERM,
                          self._prev_handler or signal.SIG_DFL)
            self._installed = False

    def resume_or(self, init_fn: Callable, target=None):
        """-> (state, start_step): the latest committed checkpoint restored
        into ``target`` (default ``init_fn()``), else ``init_fn()``."""
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return init_fn(), 0
        target = target if target is not None else init_fn()
        state, step, _ = ckpt.restore(self.ckpt_dir, target, step)
        return state, step

    def periodic(self, step: int) -> bool:
        """Whether ``step`` is a periodic save's (every ``save_every``)."""
        return self.save_every > 0 and step > 0 and step % self.save_every == 0

    def maybe_save(self, step: int, state, *, force: bool = False,
                   metadata: Optional[Dict] = None,
                   preempted: Optional[bool] = None) -> bool:
        """Save ``state`` if a save is due: forced, periodic, or answering
        a signal -> whether it was due. ``state`` may be a function that
        makes the tree, called only when a save is due (on every rank
        alike, writer or not: it may be a collective). ``preempted``: the
        signal as the ranks agreed on it, read instead of this process's
        flag, so every rank decides alike; a signal that arrives after
        the agreement stays set for the next call."""
        # only a signal seen before the save is answered by it: one that
        # lands while a periodic save writes stays set for the next call
        # (the reference clears it either way, and so loses such a signal)
        answered = self.answered = (self.preempted if preempted is None
                                    else preempted)
        due = force or answered or self.periodic(step)
        if due:
            tree = state() if callable(state) else state
            if self.writer:
                ckpt.save(self.ckpt_dir, step, tree, metadata=metadata,
                          keep=self.keep)
            if answered:
                self.preempted = False  # the flush answered the signal
        return due


@dataclass
class StragglerDetector:
    """Step times above ``threshold x EWMA`` for ``patience`` steps in a
    row, after ``warmup`` steps, mean a straggler."""
    threshold: float = 2.0
    alpha: float = 0.05
    patience: int = 5
    warmup: int = 10
    _ewma: float = 0.0
    _n: int = 0
    _over: int = 0
    events: List[Tuple[int, float, float]] = field(default_factory=list)

    def update(self, step: int, step_time_s: float) -> bool:
        """True when a sustained straggle is detected at ``step``."""
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = (step_time_s if self._n == 1 else
                          (1 - self.alpha) * self._ewma
                          + self.alpha * step_time_s)
            return False
        if step_time_s > self.threshold * self._ewma:
            self._over += 1
        else:
            self._over = 0
            self._ewma = (1 - self.alpha) * self._ewma \
                + self.alpha * step_time_s
        if self._over >= self.patience:
            self.events.append((step, step_time_s, self._ewma))
            self._over = 0
            return True
        return False


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    active_hosts: int
    global_batch: int
    per_host_batch: int
    dropped_hosts: Tuple[int, ...]


def elastic_plan(n_hosts_alive: int, chips_per_host: int, *,
                 model_parallel: int, global_batch: int,
                 pods: int = 1) -> ElasticPlan:
    """The largest valid layout on the surviving hosts: ``model`` stays
    (its degree is architectural), ``data`` shrinks to the largest value
    with data * model within the surviving chips and dividing the global
    batch. Raises when fewer chips remain than one model replica needs."""
    chips = n_hosts_alive * chips_per_host
    if chips < model_parallel:
        raise ValueError(
            f"{chips} chips cannot host model_parallel={model_parallel}")
    data = chips // model_parallel
    while data > 1 and global_batch % data != 0:
        data -= 1
    used_hosts = (data * model_parallel) // chips_per_host
    shape = ((pods, data // pods, model_parallel)
             if pods > 1 and data % pods == 0
             else (data, model_parallel))
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    return ElasticPlan(
        mesh_shape=shape, mesh_axes=axes, active_hosts=used_hosts,
        global_batch=global_batch,
        per_host_batch=global_batch // max(data, 1),
        dropped_hosts=tuple(range(used_hosts, n_hosts_alive)))
