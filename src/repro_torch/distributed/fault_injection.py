"""Deterministic fault injection for the disaggregated trainer + server
(counterpart of ``repro/distributed/fault_injection.py``: plain Python,
but for ``corrupt_tree`` on tensors and ``torn_save`` over the port's
``checkpoint/ckpt.py``).

Fleet RL is only as trustworthy as its behavior under churn, and churn
is miserable to reproduce from real preemptions — so this module makes
faults *first-class, scheduled events*. A ``FaultPlan`` is a literal
list of what goes wrong and when, keyed on a deterministic counter
(the trainer's tick, the server's dispatch/reload index), which means a
faulted run is exactly replayable: the fault-injection tests pin the
behavior under faults (restart streams, staleness drops, torn-save
recovery, rejected reloads) bitwise, not statistically.

Training fault families, matching the seams in
``repro/distributed/actor_learner.py`` (the port's fleet is not
written yet):

- ``KillWorker(worker_id, at_tick)`` — consulted by the trainer's
  ``before-produce`` seam: the worker's in-memory rollout state is
  discarded and re-initialized from its restart RNG stream (restart
  count increments), modeling a preempted actor process whose
  supervisor restarts it.
- ``DelayBatch(worker_id, at_tick, ticks)`` — the batch produced at
  that tick is held for ``ticks`` scheduler ticks before delivery,
  aging it so it arrives staler than it was produced — the way to drive
  batches past ``max_staleness`` and exercise the drop policy on
  purpose.
- ``torn_save(...)`` — not an event but a harness: reconstructs the
  on-disk layouts a crash mid-``ckpt.save`` can leave behind (tmp-only,
  missing COMMITTED sentinel, truncated array payload) so tests can
  assert the COMMITTED contract holds: ``latest_step`` never surfaces a
  torn checkpoint and ``restore`` falls back to the previous committed
  one.

Serving fault families, matching the seams in
``serving/server.py::PolicyServer.serve`` (the overload contract,
docs/ARCHITECTURE.md §8):

- ``SlowDispatch(at_dispatch, extra_s)`` — inflate dispatch
  ``at_dispatch``'s service latency by ``extra_s`` seconds (added to
  the virtual clock, or slept on the wall clock): a GC pause, a
  neighbor stall, a straggling device.
- ``RequestFlood(at_s, duration_s, multiplier)`` — every trace request
  arriving in ``[at_s, at_s + duration_s)`` is duplicated to
  ``multiplier`` copies before replay
  (``serving/request.py::flood_trace``): a deterministic traffic spike
  on top of the open-loop trace.
- ``CorruptCheckpoint(at_reload, mode)`` — the params handed to the
  server's ``at_reload``-th hot-reload attempt are mutated first
  (``corrupt_tree``): the payload a torn/bit-rotted checkpoint would
  deliver, which the reload validation must reject.

``parse_serve_faults`` parses the ``policy_serve --faults`` plan syntax
(``slow:IDX:EXTRA_S``, ``flood:AT_S:DUR_S:MULT``,
``corrupt:IDX[:MODE]``, comma-separated).
"""
from __future__ import annotations

import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class KillWorker:
    """Kill worker ``worker_id`` just before it produces at ``at_tick``
    (its rollout state is lost; the supervisor restarts it immediately)."""
    worker_id: int
    at_tick: int


@dataclass(frozen=True)
class DelayBatch:
    """Hold the batch worker ``worker_id`` produces at ``at_tick`` for
    ``ticks`` additional scheduler ticks before it reaches the learner."""
    worker_id: int
    at_tick: int
    ticks: int


@dataclass(frozen=True)
class SlowDispatch:
    """Inflate dispatch ``at_dispatch``'s service latency by ``extra_s``
    seconds (virtual clock advance, or a wall-clock sleep) — a GC pause
    or straggler landing on exactly one dispatch, deterministically."""
    at_dispatch: int
    extra_s: float


@dataclass(frozen=True)
class RequestFlood:
    """Duplicate every trace request arriving in ``[at_s, at_s +
    duration_s)`` to ``multiplier`` copies before replay — a
    deterministic traffic spike over a window of the open-loop trace."""
    at_s: float
    duration_s: float
    multiplier: int


@dataclass(frozen=True)
class CorruptCheckpoint:
    """Mutate the params handed to the server's ``at_reload``-th
    hot-reload attempt (``corrupt_tree``), modeling a torn or
    bit-rotted checkpoint payload the reload validation must reject."""
    at_reload: int
    mode: str = "nan"


def corrupt_tree(tree: Any, mode: str = "nan") -> Any:
    """-> ``tree`` with every leaf poisoned: ``"nan"`` fills NaN,
    ``"huge"`` fills +inf (a GEMM of an all-inf weight against a
    mixed-sign input produces ``inf - inf = NaN`` partial sums, so the
    poison survives even saturating activations — a merely-large finite
    fill like 1e30 would be laundered to ±1 by the first ``tanh``).
    Both are caught by the reload canary's finite check; a corruption
    that leaves every activation finite is indistinguishable from a
    valid (if bad) policy by construction, which is why reload
    validation is canary-based, not checksum-based (checksums live one
    layer down, in ``ckpt``'s COMMITTED contract)."""
    fills = {"nan": float("nan"), "huge": float("inf")}
    if mode not in fills:
        raise ValueError(f"unknown corruption mode: {mode!r}")
    return tree_map(lambda leaf: torch.full_like(leaf, fills[mode]), tree)


@dataclass(frozen=True)
class FaultPlan:
    events: Tuple = ()

    @staticmethod
    def of(*events) -> "FaultPlan":
        return FaultPlan(events=tuple(events))


def parse_serve_faults(spec: str) -> FaultPlan:
    """Parse the ``policy_serve --faults`` plan syntax: comma-separated
    ``slow:IDX:EXTRA_S`` / ``flood:AT_S:DUR_S:MULT`` /
    ``corrupt:IDX[:MODE]`` events -> a ``FaultPlan``."""
    events: List = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kind = fields[0]
        try:
            if kind == "slow" and len(fields) == 3:
                events.append(SlowDispatch(at_dispatch=int(fields[1]),
                                           extra_s=float(fields[2])))
            elif kind == "flood" and len(fields) == 4:
                events.append(RequestFlood(at_s=float(fields[1]),
                                           duration_s=float(fields[2]),
                                           multiplier=int(fields[3])))
            elif kind == "corrupt" and len(fields) in (2, 3):
                events.append(CorruptCheckpoint(
                    at_reload=int(fields[1]),
                    mode=fields[2] if len(fields) == 3 else "nan"))
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad fault spec {part!r} — expected slow:IDX:EXTRA_S, "
                f"flood:AT_S:DUR_S:MULT, or corrupt:IDX[:MODE]") from None
    return FaultPlan(events=tuple(events))


class FaultInjector:
    """Stateful view over a ``FaultPlan``: the trainer consults it at
    its deterministic seams; each event fires at most once and every
    applied event is logged (``applied``) so tests can assert the plan
    actually executed, not just that nothing crashed."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending: List = list(plan.events)
        self.applied: List = []

    def _take_where(self, kind, pred):
        for ev in self._pending:
            if isinstance(ev, kind) and pred(ev):
                self._pending.remove(ev)
                self.applied.append(ev)
                return ev
        return None

    def _take(self, kind, tick: int, worker_id: int):
        return self._take_where(
            kind, lambda ev: (ev.at_tick == tick
                              and ev.worker_id == worker_id))

    def should_kill(self, tick: int, worker_id: int) -> bool:
        return self._take(KillWorker, tick, worker_id) is not None

    def delay_ticks(self, tick: int, worker_id: int) -> int:
        ev = self._take(DelayBatch, tick, worker_id)
        return ev.ticks if ev is not None else 0

    # ------------------------------------------------- serving seams

    def dispatch_delay_s(self, dispatch_idx: int) -> float:
        """Extra service seconds for dispatch ``dispatch_idx`` (the
        ``SlowDispatch`` seam in ``PolicyServer.serve``); 0.0 when no
        event targets it."""
        ev = self._take_where(SlowDispatch,
                              lambda e: e.at_dispatch == dispatch_idx)
        return ev.extra_s if ev is not None else 0.0

    def take_floods(self) -> List[RequestFlood]:
        """Pop (and log as applied) every pending ``RequestFlood`` —
        the server applies them to the trace before replay starts."""
        evs = [ev for ev in self._pending
               if isinstance(ev, RequestFlood)]
        for ev in evs:
            self._pending.remove(ev)
            self.applied.append(ev)
        return evs

    def corrupt_params(self, reload_idx: int, params: Any) -> Any:
        """The ``CorruptCheckpoint`` seam: mutate the params of the
        ``reload_idx``-th hot-reload attempt when an event targets it,
        pass them through untouched otherwise."""
        ev = self._take_where(CorruptCheckpoint,
                              lambda e: e.at_reload == reload_idx)
        if ev is None:
            return params
        return corrupt_tree(params, mode=ev.mode)

    # --------------------------------------------------- accounting

    @property
    def kills_applied(self) -> int:
        return sum(isinstance(ev, KillWorker) for ev in self.applied)

    @property
    def exhausted(self) -> bool:
        return not self._pending

    def applied_counts(self) -> Dict[str, int]:
        """Applied events per type name — the stats snapshot the chaos
        smoke compares against the plan's literal event counts."""
        out: Dict[str, int] = {}
        for ev in self.applied:
            name = type(ev).__name__
            out[name] = out.get(name, 0) + 1
        return out

    def assert_exhausted(self) -> None:
        """Fail loudly when any planned event never fired. ``exhausted``
        is only meaningful *after* a run — a fault test that forgets to
        check it passes vacuously when the plan's coordinates drift off
        the schedule, which is exactly the silent rot this raises on."""
        if self._pending:
            raise AssertionError(
                f"fault plan not exhausted: {len(self._pending)} event(s) "
                f"never fired: {self._pending!r} "
                f"(applied: {self.applied!r})")


def torn_save(ckpt_dir, step: int, tree, tear: str = "no-commit",
              metadata=None) -> Path:
    """Simulate a save killed mid-write. Performs a real ``ckpt.save``
    into a scratch directory, then reconstructs the torn layout in
    ``ckpt_dir``:

    - ``"tmp-only"``: the crash hit before the atomic rename —
      ``step_X.tmp`` exists, no final directory.
    - ``"no-commit"``: the final directory exists but the COMMITTED
      sentinel (written last) is missing — e.g. a foreign writer that
      renamed early.
    - ``"truncated"``: COMMITTED missing *and* the array payload is cut
      short — the worst case a hard kill can leave.
    - ``"torn-meta"``: COMMITTED missing *and* ``meta.msgpack`` is cut
      short — the kill landed inside the metadata write itself, so even
      the cheap no-payload readers (``ckpt.read_metadata``) see a
      partial file.

    Returns the torn path. The contract under test: ``ckpt.latest_step``
    must not surface ``step``, ``ckpt.restore`` must fall back to the
    previous committed checkpoint, the explicit-step readers raise
    instead of decoding garbage, and the next successful ``ckpt.save``
    sweeps the debris.
    """
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    scratch = ckpt_dir / f".torn_scratch_{step}"
    if scratch.exists():
        shutil.rmtree(scratch)
    ckpt.save(scratch, step, tree, metadata=metadata)
    src = scratch / f"step_{step:09d}"
    (src / "COMMITTED").unlink()
    if tear == "tmp-only":
        dst = ckpt_dir / f"step_{step:09d}.tmp"
    elif tear in ("no-commit", "truncated", "torn-meta"):
        dst = ckpt_dir / f"step_{step:09d}"
    else:
        raise ValueError(f"unknown tear mode: {tear!r}")
    if dst.exists():
        shutil.rmtree(dst)
    shutil.move(str(src), str(dst))
    shutil.rmtree(scratch, ignore_errors=True)
    if tear == "truncated":
        npz = dst / "arrays.npz"
        raw = npz.read_bytes()
        npz.write_bytes(raw[: max(1, len(raw) // 2)])
    elif tear == "torn-meta":
        mp = dst / "meta.msgpack"
        raw = mp.read_bytes()
        mp.write_bytes(raw[: max(1, len(raw) // 2)])
    return dst
