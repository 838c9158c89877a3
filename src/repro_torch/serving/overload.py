"""Overload hardening: admission control, load shedding, brownout
(counterpart of ``repro/serving/overload.py``, plain Python).

The schedulers in ``scheduler.py`` are deliberately drop-free — every
admitted request is dispatched, and a missed deadline is *recorded*,
never used to shed load. That is the right contract for the scheduler's
own accounting, but it means a server run past saturation admits
everything, the queue grows without bound, and misses pile up silently:
past ~1x capacity, *every* class's latency collapses together. This
module is the policy layer on top — the overload contract of
docs/ARCHITECTURE.md §8 — which turns silent misses into explicit,
counted sheds at admit time and degrades the service gracefully instead
of collapsing it:

- ``DispatchLatencyModel`` — an EWMA of *measured* per-shape dispatch
  latency, the server's own service-time estimate (seeded with a
  configured default until the first dispatch of a shape lands).
- ``AdmissionController`` — three admit-time gates, in order: a
  **bounded queue** (``queue_cap`` pending requests; beyond it the
  server is saturated by definition and the request is shed), a
  **brownout shed** (below), and **deadline feasibility**: with ``P``
  requests pending and the drain running full slots of shape ``S``, a
  new request completes no earlier than
  ``now + (P // S + 1) * ewma(S) * slack`` — if that is already past
  its absolute deadline, admitting it can only burn capacity on a
  guaranteed miss, so it is rejected at the door. Every shed is counted
  (``ServeStats.rejected`` / ``rejected_by_reason`` / ``shed_by_class``)
  — explicit rejections replace silent deadline misses.
- ``BrownoutController`` — graceful degradation with hysteresis. The
  backlog estimate is observed at every admit and dispatch; after
  ``hold`` consecutive observations above ``enter_s`` the brownout
  level rises, and only after ``hold`` consecutive observations below
  ``exit_s`` (< ``enter_s``: the hysteresis band prevents flapping)
  does it fall. Level k sheds the k *loosest* deadline classes — the
  bulk traffic with the most slack is degraded first so the queue stays
  short enough for latency-sensitive classes to remain feasible; the
  tightest class is never shed by brownout. At ``max_level`` the
  controller also collapses a bucketed scheduler to its coarsest shape
  (``BucketedSlotScheduler.set_coarse``): under sustained overload
  batches are large anyway, and one big program amortises per-dispatch
  overhead. Recovery undoes both as the backlog drains.

The controller is deliberately stateful-but-replayable: its decisions
are a pure function of the observed request/latency sequence, so a
``mode="virtual"`` replay (fixed service time per dispatch) makes every
admission decision deterministic — the property the overload tests and
the overload tests of both packages pin.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class OverloadConfig:
    """Admission + brownout policy knobs (see the module docstring).

    ``queue_cap`` bounds pending requests; ``default_latency_s`` seeds
    the per-shape EWMA before the first dispatch lands (match it to the
    virtual-mode ``service_time_s`` for exact replays); ``slack`` > 1
    makes the feasibility estimate more conservative. Brownout enters a
    level after ``brownout_hold`` consecutive backlog observations above
    ``brownout_enter_s`` and exits after as many below
    ``brownout_exit_s`` — the gap is the hysteresis band."""
    queue_cap: int = 8192
    ewma_alpha: float = 0.25
    default_latency_s: float = 1e-3
    slack: float = 1.0
    feasibility: bool = True
    brownout: bool = True
    brownout_enter_s: float = 0.05
    brownout_exit_s: float = 0.02
    brownout_hold: int = 3
    max_level: int = 2
    coarse_in_brownout: bool = True

    def __post_init__(self):
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
        if self.brownout_exit_s >= self.brownout_enter_s:
            raise ValueError(
                f"hysteresis needs brownout_exit_s < brownout_enter_s, got "
                f"exit {self.brownout_exit_s} >= enter "
                f"{self.brownout_enter_s}")
        if self.brownout_hold < 1:
            raise ValueError(f"brownout_hold must be >= 1, got "
                             f"{self.brownout_hold}")
        if self.max_level < 1:
            raise ValueError(f"max_level must be >= 1, got {self.max_level}")


class DispatchLatencyModel:
    """EWMA of measured per-shape dispatch latency — the admission
    controller's service-time estimate. One EWMA per slot shape (a
    dispatch's cost depends on its shape, so its latency does too); a
    shape that has never dispatched estimates ``default_s``."""

    def __init__(self, alpha: float = 0.25, default_s: float = 1e-3):
        self.alpha = alpha
        self.default_s = default_s
        self._ewma: Dict[int, float] = {}

    def observe(self, shape: int, seconds: float) -> None:
        prev = self._ewma.get(shape)
        self._ewma[shape] = (seconds if prev is None else
                             (1 - self.alpha) * prev + self.alpha * seconds)

    def estimate(self, shape: int) -> float:
        got = self._ewma.get(shape)
        if got is not None:
            return got
        # nearest observed shape is a better guess than the cold default
        if self._ewma:
            near = min(self._ewma, key=lambda s: abs(s - shape))
            return self._ewma[near]
        return self.default_s


class BrownoutController:
    """Degradation level with hysteresis (0 = normal service).

    ``observe(backlog_s)`` drives a small state machine: ``hold``
    consecutive observations above ``enter_s`` raise the level (up to
    ``max_level``), ``hold`` consecutive below ``exit_s`` lower it;
    observations inside the hysteresis band reset both streaks, holding
    the current level. ``entries``/``exits`` count transitions (the
    chaos harness asserts the controller actually cycled)."""

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self.level = 0
        self.entries = 0
        self.exits = 0
        self._over = 0
        self._under = 0

    def observe(self, backlog_s: float) -> int:
        cfg = self.cfg
        if backlog_s > cfg.brownout_enter_s:
            self._over += 1
            self._under = 0
            if self._over >= cfg.brownout_hold and self.level < cfg.max_level:
                self.level += 1
                self.entries += 1
                self._over = 0
        elif backlog_s < cfg.brownout_exit_s:
            self._under += 1
            self._over = 0
            if self._under >= cfg.brownout_hold and self.level > 0:
                self.level -= 1
                self.exits += 1
                self._under = 0
        else:                       # inside the band: hold the level
            self._over = 0
            self._under = 0
        return self.level


class AdmissionController:
    """Admit-or-shed policy in front of a ``SlotScheduler``.

    ``admit(req, now, sched, stats)`` either enqueues ``req`` on
    ``sched`` and returns True, or records one counted rejection on
    ``stats`` (reason ∈ {``queue_full``, ``brownout``, ``infeasible``})
    and returns False. ``observe_dispatch(shape, seconds, sched)``
    feeds the latency EWMA + brownout after every dispatch. The
    controller owns no per-replay counters — those live in the
    ``ServeStats`` of the serve call — so one controller can persist
    across replays (its latency model and brownout state carry over,
    like a long-running server's would).

    Deadline-class bounds are *learned* from the requests themselves
    (``deadline - arrival``), so the controller needs no trace config;
    brownout level k sheds the k loosest learned classes, never the
    tightest."""

    def __init__(self, cfg: Optional[OverloadConfig] = None):
        self.cfg = cfg if cfg is not None else OverloadConfig()
        self.latency = DispatchLatencyModel(self.cfg.ewma_alpha,
                                            self.cfg.default_latency_s)
        self.brownout = BrownoutController(self.cfg)
        self._class_bound: Dict[int, float] = {}

    def backlog_s(self, sched) -> float:
        """Estimated time to drain ``sched``'s pending queue at full
        slots of the scheduler's largest shape."""
        slot = sched.slot
        est = self.latency.estimate(slot) * self.cfg.slack
        return -(-sched.pending // slot) * est if sched.pending else 0.0

    def shed_classes(self) -> Tuple[int, ...]:
        """Classes the current brownout level sheds: the ``level``
        loosest learned deadline classes — never all of them (the
        tightest class always stays admissible)."""
        level = self.brownout.level
        if level == 0 or len(self._class_bound) < 2:
            return ()
        ranked = sorted(self._class_bound,
                        key=lambda k: (-self._class_bound[k], k))
        return tuple(ranked[:min(level, len(ranked) - 1)])

    def _sync_coarse(self, sched) -> None:
        if self.cfg.coarse_in_brownout and hasattr(sched, "set_coarse"):
            sched.set_coarse(self.brownout.level >= self.cfg.max_level)

    def admit(self, req, now: float, sched, stats) -> bool:
        """One admit-or-shed decision (see the class docstring)."""
        bound = req.deadline - req.arrival
        prev = self._class_bound.get(req.klass)
        if prev is None or bound > prev:
            self._class_bound[req.klass] = bound
        backlog = self.backlog_s(sched)
        if self.cfg.brownout:
            self.brownout.observe(backlog)
            self._sync_coarse(sched)
        reason = None
        if sched.pending >= self.cfg.queue_cap:
            reason = "queue_full"
        elif self.cfg.brownout and req.klass in self.shed_classes():
            reason = "brownout"
        elif self.cfg.feasibility:
            # with P pending draining in full slots of shape S, this
            # request rides dispatch P // S (0-indexed from the next
            # one) and completes no earlier than (P // S + 1) slots out
            est = self.latency.estimate(sched.slot) * self.cfg.slack
            eta = now + (sched.pending // sched.slot + 1) * est
            if eta > req.deadline:
                reason = "infeasible"
        if reason is not None:
            stats.record_rejection(reason, req.klass)
            return False
        sched.admit(req)
        return True

    def observe_dispatch(self, shape: int, seconds: float, sched) -> None:
        """Feed one measured dispatch back into the latency EWMA and the
        brownout state machine (recovery happens here: draining backlog
        is only observable when dispatches complete)."""
        self.latency.observe(shape, seconds)
        if self.cfg.brownout:
            self.brownout.observe(self.backlog_s(sched))
            self._sync_coarse(sched)
