"""Disaggregated actor/learner PPO: N rollout workers, one learner
(counterpart of ``repro/distributed/actor_learner.py``).

Each **worker** runs PPO's acting horizon (``rl/ppo.py::rollout`` over
the unified engine: one ``policy_rollout`` kernel launch on the card) and
hands trajectory batches, tagged ``(worker_id, policy_version,
rng_position)``, through a bounded queue to one **learner**, which applies
the integrated trainer's own update (``ppo.learner_update_fn``), so the
two trainers are interchangeable on the same batches.

Staleness: a batch acted under policy version ``p`` that reaches the
learner at version ``v`` has staleness ``v - p``. Batches with
``staleness <= max_staleness`` are applied (PPO's clipped ratio against
the batch's acting ``logp`` is the importance correction for the gap);
staler ones are dropped and counted, never averaged in.
``publish_every`` throttles the publication of parameters.

Two schedules, one state:

- ``deterministic=True`` (default): workers produce round-robin on the
  learner's thread. Every generator is ``repro_torch.stream`` of
  (seed, tag, position) — worker w's rollout p, worker w's restart r,
  learner update v — never a generator carried along, so a run stopped
  at version k and resumed from a ``FleetState`` checkpoint replays the
  bitwise identical remaining run.
- ``deterministic=False``: free-running worker threads (torch ops
  release the GIL), the throughput mode; no bitwise claim. Every thread
  works on the same device and its default stream. A worker records a
  CUDA event after its produce and the learner's stream waits on it
  before the batch's first use, so the learner never reads a buffer
  still being written, and neither thread blocks on the card.

``FleetState`` is the whole RL state — policy, optimizer state, learner
version, scheduler tick and per worker (rollout state, stream position,
restart count) — a pytree the port's ``checkpoint/ckpt.py`` saves with
the JAX package's leaf order. ``resume_fleet`` restores it, resizing the
fleet when the worker count changed.

Fault seams (``distributed/fault_injection.py``): ``should_kill`` before a
produce (the worker's rollout state is lost and re-initialised from its
restart stream) and ``delay_ticks`` after it (the batch is held so it
ages past ``max_staleness``). Both are consulted at deterministic points.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device, stream
from repro_torch.checkpoint import ckpt
from repro_torch.rl import ppo


@dataclass(frozen=True)
class FleetConfig:
    n_workers: int = 2
    queue_size: int = 8        # bounded trajectory queue (backpressure)
    max_staleness: int = 4     # drop batches staler than this many versions
    publish_every: int = 1     # learner updates between publications
    deterministic: bool = True  # round-robin schedule (bitwise-resumable)
    seed: int = 0


class TrajectoryBatch(NamedTuple):
    worker_id: int
    policy_version: int
    rng_position: int
    batch: Any                 # PPO streams, (T, n_envs, [A,] ...) leaves
    v_last: Any                # bootstrap values from the acting policy


class WorkerState(NamedTuple):
    rs: Any                    # ppo.RolloutState
    rng_position: torch.Tensor  # () int32: rollouts produced on the stream
    restarts: torch.Tensor     # () int32: kill/restart count


class FleetState(NamedTuple):
    params: Any
    opt_state: Any
    version: torch.Tensor      # () int32: learner updates applied
    tick: torch.Tensor         # () int32: deterministic scheduler ticks
    workers: Tuple[WorkerState, ...]


def _i32(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


class ParamStore:
    """Versioned, lock-protected publication point between the learner
    and the workers."""

    def __init__(self, params, version: int = 0):
        self._lock = threading.Lock()
        self._params = params
        self._version = version

    def publish(self, params, version: int):
        with self._lock:
            self._params, self._version = params, version

    def snapshot(self):
        with self._lock:
            return self._params, self._version


class ActorLearnerTrainer:
    """The disaggregated trainer over ``env`` (anything PPO acts in; the
    unified IALS engine is the intended workload), on ``device``."""

    # stream tags
    _LEARNER, _POLICY, _WORKER, _RESTART = 1, 2, 1000, 2000

    def __init__(self, env, cfg: ppo.PPOConfig, fleet: FleetConfig,
                 injector=None, device="cuda"):
        self.env = env
        self.cfg = cfg
        self.fleet = fleet
        self.injector = injector
        self.device = resolve_device(device)
        self.opt = ppo.make_optimizer(cfg)
        self._update = ppo.learner_update_fn(cfg, self.opt)

    def _stream(self, tag: int, position: int = 0):
        return stream(self.device, self.fleet.seed, tag, position)

    # -- state construction --------------------------------------------
    def _init_worker(self, w: int, restarts: int = 0) -> WorkerState:
        rs = ppo.init_rollout_state(self.env, self.cfg,
                                    self._stream(self._RESTART + w,
                                                 restarts))
        return WorkerState(rs=rs, rng_position=_i32(0),
                           restarts=_i32(restarts))

    def init_state(self) -> FleetState:
        return self.state_template()

    def state_template(self, n_workers: Optional[int] = None) -> FleetState:
        """A FleetState with ``n_workers`` worker slots (default: this
        fleet's): the restore target for a checkpoint of that size."""
        n = self.fleet.n_workers if n_workers is None else n_workers
        params = ppo.init_policy(self.cfg, self._stream(self._POLICY))
        return FleetState(
            params=params, opt_state=self.opt.init(params),
            version=_i32(0), tick=_i32(0),
            workers=tuple(self._init_worker(min(w, self.fleet.n_workers - 1)
                                            if self.fleet.n_workers else 0)
                          for w in range(n)))

    # -- the produce step (both schedules) -------------------------------
    def _produce_one(self, w: int, wstate: WorkerState, params,
                     version: int, tick: int):
        """-> (WorkerState, TrajectoryBatch). A worker the injector kills
        here restarts from its restart stream, then produces."""
        if self.injector is not None and self.injector.should_kill(tick, w):
            wstate = self._init_worker(w, int(wstate.restarts) + 1)
        pos = int(wstate.rng_position)
        rs, batch, v_last = ppo.rollout(
            self.env, self.cfg, params, wstate.rs,
            self._stream(self._WORKER + w, pos))
        wstate = wstate._replace(rs=rs, rng_position=_i32(pos + 1))
        return wstate, TrajectoryBatch(worker_id=w, policy_version=version,
                                       rng_position=pos, batch=batch,
                                       v_last=v_last)

    def _ready(self):
        """-> an event recorded behind a worker's produce on the current
        stream, for the learner to wait on (None off the card)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _apply(self, state: FleetState, item: TrajectoryBatch,
               stats: dict, history: list):
        """Staleness gate + learner update -> the new FleetState
        (unchanged when the batch is dropped)."""
        version = int(state.version)
        staleness = version - item.policy_version
        if staleness > self.fleet.max_staleness:
            stats["dropped"] += 1
            history.append({"version": version, "worker": item.worker_id,
                            "staleness": staleness, "dropped": True})
            return state
        params, opt_state, metrics = self._update(
            state.params, state.opt_state, item.batch, item.v_last,
            self._stream(self._LEARNER, version))
        stats["updates"] += 1
        history.append({"version": version + 1, "worker": item.worker_id,
                        "staleness": staleness, "dropped": False,
                        "loss": float(metrics["loss"]),
                        "mean_reward": float(metrics["mean_reward"])})
        return state._replace(params=params, opt_state=opt_state,
                              version=_i32(version + 1))

    # -- deterministic (round-robin) schedule ---------------------------
    def _run_deterministic(self, state: FleetState, n_updates: int,
                           should_stop, stats, history):
        target = int(state.version) + n_updates
        workers = list(state.workers)
        store = ParamStore(state.params, int(state.version))
        pending: List[Tuple[int, TrajectoryBatch]] = []  # (due tick, item)
        # the tick lives in FleetState: fault schedules and resume see one
        # monotonic clock across run() chunks
        tick = int(state.tick)
        # every tick produces a batch that is applied or dropped, so the
        # only slack is drops: cap generously
        max_ticks = tick + n_updates * (self.fleet.max_staleness + 4) + 16
        while int(state.version) < target and tick < max_ticks:
            if should_stop is not None and should_stop():
                break
            w = tick % self.fleet.n_workers
            params, version = store.snapshot()
            workers[w], item = self._produce_one(w, workers[w], params,
                                                 version, tick)
            stats["produced"] += 1
            delay = (self.injector.delay_ticks(tick, w)
                     if self.injector is not None else 0)
            if delay > 0:
                stats["delayed"] += 1
            pending.append((tick + delay, item))
            # deliver everything due, in order of due tick then age
            pending.sort(key=lambda p: p[0])
            while pending and pending[0][0] <= tick \
                    and int(state.version) < target:
                _, due = pending.pop(0)
                state = self._apply(state, due, stats, history)
                if int(state.version) % self.fleet.publish_every == 0:
                    store.publish(state.params, int(state.version))
            tick += 1
        # quiesce: apply (or drop) what is still in flight, so the returned
        # state describes the whole run
        for _, due in sorted(pending, key=lambda p: p[0]):
            if int(state.version) < target:
                state = self._apply(state, due, stats, history)
            else:
                stats["dropped"] += 1   # delayed past the chunk's end
        return state._replace(workers=tuple(workers), tick=_i32(tick))

    # -- async (free-running threads) schedule --------------------------
    def _run_async(self, state: FleetState, n_updates: int, should_stop,
                   stats, history):
        target = int(state.version) + n_updates
        store = ParamStore(state.params, int(state.version))
        q: queue.Queue = queue.Queue(maxsize=self.fleet.queue_size)
        stop = threading.Event()
        workers = list(state.workers)
        wlock = threading.Lock()

        def worker_loop(w: int):
            wstate = workers[w]
            while not stop.is_set():
                params, version = store.snapshot()
                # async ticks are the worker's produce count (its stream
                # position): fault plans stay meaningful without a clock
                wstate, item = self._produce_one(
                    w, wstate, params, version, int(wstate.rng_position))
                ready = self._ready()
                with wlock:
                    stats["produced"] += 1
                while not stop.is_set():
                    try:
                        q.put((item, ready), timeout=0.05)
                        break
                    except queue.Full:
                        continue
            with wlock:
                workers[w] = wstate

        threads = [threading.Thread(target=worker_loop, args=(w,),
                                    daemon=True)
                   for w in range(self.fleet.n_workers)]
        for t in threads:
            t.start()
        try:
            while int(state.version) < target:
                if should_stop is not None and should_stop():
                    break
                try:
                    item, ready = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                state = self._apply(state, item, stats, history)
                if int(state.version) % self.fleet.publish_every == 0:
                    store.publish(state.params, int(state.version))
        finally:
            stop.set()
            try:                     # unblock producers mid-put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            for t in threads:
                t.join(timeout=60.0)
        return state._replace(workers=tuple(workers))

    def run(self, state: FleetState, n_updates: int, *,
            should_stop: Optional[Callable[[], bool]] = None):
        """Advance the fleet by ``n_updates`` learner updates ->
        (FleetState, info); returns early when ``should_stop()`` turns
        true (the SIGTERM hook; the returned state has no batch in
        flight). ``info``: ``history`` (one row per applied or dropped
        batch) and the fleet counters."""
        stats = {"produced": 0, "updates": 0, "dropped": 0, "delayed": 0}
        history: list = []
        t0 = time.perf_counter()
        run = (self._run_deterministic if self.fleet.deterministic
               else self._run_async)
        state = run(state, n_updates, should_stop, stats, history)
        stats["wallclock_s"] = time.perf_counter() - t0
        if self.injector is not None:
            stats["kills"] = self.injector.kills_applied
        return state, {"history": history, **stats}

    # -- checkpoint plumbing -------------------------------------------
    def save_metadata(self, state: FleetState) -> dict:
        return {"n_workers": self.fleet.n_workers,
                "version": int(state.version),
                "tick": int(state.tick),
                "rng_positions": [int(w.rng_position)
                                  for w in state.workers],
                "restarts": [int(w.restarts) for w in state.workers]}


def resume_fleet(ckpt_dir, trainer: ActorLearnerTrainer,
                 extra_template=None):
    """Restore a ``FleetState`` (with an ``extra`` pytree beside it when
    ``extra_template`` is given, e.g. the simulator's AIP) from the latest
    committed checkpoint, resizing the fleet if the worker count changed:

    - same ``n_workers``: exact restore, every worker at its recorded
      stream position with its rollout state (the bitwise-resume path);
    - another ``n_workers``: the learner state (params, optimizer state,
      version) survives, workers in the checkpoint keep their streams,
      new ones start from their restart streams. No bitwise claim.

    -> (FleetState, extra, start_version), or (None, None, 0) without a
    committed checkpoint."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return None, None, 0
    meta = ckpt.read_metadata(ckpt_dir, step)
    saved_workers = int(meta.get("n_workers", trainer.fleet.n_workers))
    target = trainer.state_template(saved_workers)
    if extra_template is not None:
        target = {"fleet": target, "extra": extra_template}
    tree, step, _ = ckpt.restore(ckpt_dir, target, step)
    if extra_template is not None:
        state, extra = tree["fleet"], tree["extra"]
    else:
        state, extra = tree, None
    n = trainer.fleet.n_workers
    if saved_workers != n:
        kept = list(state.workers[:n])
        fresh = [trainer._init_worker(w) for w in range(len(kept), n)]
        state = state._replace(workers=tuple(kept + fresh))
    return state, extra, int(state.version)
