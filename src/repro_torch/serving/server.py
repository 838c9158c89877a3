"""PolicyServer: multi-slot, multi-policy continuous-batching inference
(counterpart of ``repro/serving/server.py``, same lifecycle, stats,
replay loop and reload gates).

One server = one or more trained policies + a table of slot shapes.
Every dispatch runs one masked slot forward on a packed (shape,
frame_dim) batch with a lane-validity mask; pad lanes are zeroed inside
the dispatch (the ragged-batch contract of ``envs/api.py``), and actions
are the greedy ``argmax`` over the masked logits, computed outside the
kernel as the reference does.

**Slot shapes.** ``slot`` is one shape (every dispatch padded to it) or
an ascending bucket set, e.g. ``(16, 64, 256)``, all warmed before the
serving clock starts (``warmup``), with ``BucketedSlotScheduler``
right-sizing each dispatch. Each shape has one staging buffer, allocated
once and reused: its frames, mask and policy-index rows are views of one
host buffer (pinned on the card), so a dispatch on the card is ONE
host-to-device copy into a device buffer of the same layout, one kernel
launch and one ``argmax``. Pad lanes keep whatever the previous dispatch
left: garbage by contract, masked at the kernel boundary.

**Policies.** ``params`` is one policy tree (``kernels/ops.py::
serve_forward``) or a list of N trees: the weights stack on a leading
policy axis (``rl/ppo.py::stack_policy_weights``) and each lane selects
its checkpoint by index inside the one dispatch
(``kernels/ops.py::serve_forward_multi``). The [pi|v] head is fused once,
when the weights are built (``kernels/ref.py::fuse_head``), not per
dispatch.

**Routes.** ``"auto"`` is the ``ops`` dispatch: the hand-written CUDA
kernel for a server on the card, the plain PyTorch version on the CPU.
``"policy_forward"`` is the training net verbatim, masked
(``rl/ppo.py::policy_forward``; the reference calls this route
``"xla"``): its separate value-head GEMM makes ``v`` the documented
allclose-not-bitwise leaf against the fused route. The reference's
``"interpret"`` route (Pallas interpret mode) has no counterpart and is
refused.

**Lifecycle + overload hardening** (the overload contract of
docs/ARCHITECTURE.md §8), as in the reference: ``warming -> serving ->
draining -> drained``, an optional ``AdmissionController``, a
``FaultInjector`` (``SlowDispatch``, ``RequestFlood``,
``CorruptCheckpoint``) and ``reload_at`` hot-reload points.

**Hot policy reload.** The forward is a plain function that takes the
weight tuple as an argument, so ``reload(params)`` rebinds the tuple and
rebuilds nothing, after three gates on the candidate: (1) an ABI check
(leaf paths, shapes and dtypes of the built weights equal the serving
ones), (2) a canary forward on a pinned probe slot whose outputs must be
finite, and (3) bitwise agreement of that canary with a fresh server
built from the candidate. Any failure rolls back and counts
``reload_rejected``. ``reload_from_checkpoint`` puts
``checkpoint/ckpt.py::restore_subtree`` in front of the same gate, so a
torn or corrupt checkpoint is rejected at restore.

Reproducibility contract (ARCHITECTURE §8): within one slot shape a real
lane's (logits, v, action) are bitwise the same whatever the pad lanes
hold and wherever the lane sits, and a lane of a multi-policy server is
bitwise the single-policy server of its own checkpoint at the same
shape. The CUDA kernel reduces every output in one fixed sequential
chain per row; the plain version gets the same from torch's row-wise
matmul at a fixed shape (pinned by ``tests/test_torch_serving.py`` on
the CPU and by ``chip_smoke.py`` on the card).

Latency: open-loop trace replay on a wall clock; request latency = slot
dispatch completion (``forward_slot`` returns after the device has
finished, as ``jax.block_until_ready`` does) minus trace arrival.
``mode="virtual"`` replaces the wall clock with a fixed per-dispatch
service time, so every scheduling, overload and fault decision replays
exactly, and identically to the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fuse_head
from repro_torch.rl.ppo import (flat_policy_weights, policy_forward,
                                stack_policy_weights)
from repro_torch.serving.request import Request, flood_trace
from repro_torch.serving.scheduler import BucketedSlotScheduler, SlotScheduler
from repro_torch.tree import tree_leaves_with_path, tree_map

#: occupancy-fraction bins per slot shape in ``ServeStats`` histograms
HIST_BINS = 8

#: server lifecycle states, in order
LIFECYCLE = ("warming", "serving", "draining", "drained")


@dataclass
class ServeStats:
    """Padding-waste + overload observability, accumulated per replay.

    ``record(shape, n)`` logs one dispatch of ``n`` real lanes in a
    ``shape``-lane program; ``record_rejection(reason, klass)`` logs one
    counted admission shed. The exported counters (all in ``summary()``
    and surfaced by ``repro_torch.launch.policy_serve``'s
    JSON): dispatches and real/padded lane totals per slot shape, the
    aggregate ``padded_lane_frac`` (padded lanes / dispatched lanes —
    the pure-waste FLOP fraction the bucketed scheduler exists to
    shrink), a per-shape occupancy histogram (``HIST_BINS`` equal
    occupancy-fraction bins; a healthy bucket loads the last bin), and
    the overload counters: ``rejected`` total with
    ``rejected_by_reason`` (queue_full / brownout / infeasible) and
    ``shed_by_class`` breakdowns, plus the replay's hot-reload outcomes
    (``reloads`` accepted, ``reload_rejected`` rolled back) and the
    lifecycle state at snapshot time (``final_state``). Every ratio is
    guarded for the zero-dispatch replay (empty or fully shed trace):
    ``summary()`` on a fresh instance is all zeros/empties, never a
    division error."""
    dispatches_by_slot: Dict[int, int] = field(default_factory=dict)
    lanes_by_slot: Dict[int, int] = field(default_factory=dict)
    occupancy_hist_by_slot: Dict[int, List[int]] = field(
        default_factory=dict)
    rejected: int = 0
    rejected_by_reason: Dict[str, int] = field(default_factory=dict)
    shed_by_class: Dict[int, int] = field(default_factory=dict)
    reloads: int = 0
    reload_rejected: int = 0
    final_state: str = ""

    def record(self, shape: int, n: int) -> None:
        self.dispatches_by_slot[shape] = (
            self.dispatches_by_slot.get(shape, 0) + 1)
        self.lanes_by_slot[shape] = self.lanes_by_slot.get(shape, 0) + n
        hist = self.occupancy_hist_by_slot.setdefault(
            shape, [0] * HIST_BINS)
        hist[min(HIST_BINS - 1, max(0, (n - 1) * HIST_BINS // shape))] += 1

    def record_rejection(self, reason: str, klass: int) -> None:
        """One counted admission shed (the overload contract: explicit
        rejections replace silent deadline misses)."""
        self.rejected += 1
        self.rejected_by_reason[reason] = (
            self.rejected_by_reason.get(reason, 0) + 1)
        self.shed_by_class[klass] = self.shed_by_class.get(klass, 0) + 1

    @property
    def dispatches(self) -> int:
        return sum(self.dispatches_by_slot.values())

    @property
    def total_lanes(self) -> int:
        """Dispatched lanes, real + padded (occupancy denominator)."""
        return sum(s * k for s, k in self.dispatches_by_slot.items())

    @property
    def real_lanes(self) -> int:
        return sum(self.lanes_by_slot.values())

    @property
    def padded_lane_frac(self) -> float:
        total = self.total_lanes
        return (total - self.real_lanes) / total if total else 0.0

    def summary(self) -> Dict:
        return {
            "padded_lane_frac": self.padded_lane_frac,
            "dispatches_by_slot": {str(s): k for s, k in
                                   sorted(self.dispatches_by_slot.items())},
            "mean_occupancy_by_slot": {
                str(s): self.lanes_by_slot[s] / (s * k)
                for s, k in sorted(self.dispatches_by_slot.items())},
            "occupancy_hist_by_slot": {
                str(s): list(h) for s, h in
                sorted(self.occupancy_hist_by_slot.items())},
            "rejected": self.rejected,
            "rejected_by_reason": dict(sorted(
                self.rejected_by_reason.items())),
            "shed_by_class": {str(k): v for k, v in
                              sorted(self.shed_by_class.items())},
            "reloads": self.reloads,
            "reload_rejected": self.reload_rejected,
            "final_state": self.final_state,
        }


@dataclass
class ServeReport:
    """One trace replay's results. Latencies in seconds; ``qps`` is
    served requests / makespan (first arrival -> last completion);
    ``stats`` is the padding-waste + overload observability
    (``ServeStats`` — rejections, sheds, reload outcomes, lifecycle)."""
    requests: int
    served: int
    p50_s: float
    p99_s: float
    qps: float
    deadline_misses: int
    misses_by_class: Dict[int, int]
    max_queue_depth: int
    dispatches: int
    mean_occupancy: float        # mean real lanes per dispatched slot
    stats: ServeStats = field(default_factory=ServeStats)
    latencies_s: List[float] = field(repr=False, default_factory=list)

    def summary(self) -> Dict:
        """JSON-ready summary (drops the raw latency list)."""
        return {
            "requests": self.requests, "served": self.served,
            "p50_ms": self.p50_s * 1e3, "p99_ms": self.p99_s * 1e3,
            "qps": self.qps, "deadline_misses": self.deadline_misses,
            "misses_by_class": {str(k): v for k, v
                                in sorted(self.misses_by_class.items())},
            "max_queue_depth": self.max_queue_depth,
            "dispatches": self.dispatches,
            "mean_occupancy": self.mean_occupancy,
            **self.stats.summary(),
        }


class _ReloadRejected(Exception):
    """Internal: a reload validation gate failed (reason in args)."""


class _Stage:
    """One slot shape's staging: frames (shape, frame_dim) f32, mask and
    pidx (shape,) int32, all views of ONE int32 host buffer (pinned for a
    server on the card, where a device buffer of the same layout takes one
    copy per dispatch). ``frames_np`` / ``pidx_np`` / ``mask_np`` are
    numpy views of the same memory for packing."""

    def __init__(self, shape: int, frame_dim: int, device: torch.device):
        on_card = device.type == "cuda"
        self.host = torch.zeros(shape * (frame_dim + 2), dtype=torch.int32,
                                pin_memory=on_card)
        self.frames, self.mask, self.pidx = self._views(self.host, shape,
                                                        frame_dim)
        self.frames_np = self.frames.numpy()
        self.mask_np = self.mask.numpy()
        self.pidx_np = self.pidx.numpy()
        self.dev = (torch.empty_like(self.host, device=device) if on_card
                    else None)
        self.dev_views = (self._views(self.dev, shape, frame_dim)
                          if on_card else None)

    @staticmethod
    def _views(buf, shape, frame_dim):
        n = shape * frame_dim
        return (buf[:n].view(torch.float32).view(shape, frame_dim),
                buf[n:n + shape], buf[n + shape:])

    def inputs(self):
        """(frames, mask, pidx) where the forward reads them: the host
        views on the CPU; on the card the device views, after one
        asynchronous copy on the current stream."""
        if self.dev is None:
            return self.frames, self.mask, self.pidx
        self.dev.copy_(self.host, non_blocking=True)
        return self.dev_views


class PolicyServer:
    """Continuous-batching inference over a table of slot shapes.

    ``slot``: one shape or an ascending bucket set. ``params``: one
    policy tree (nested dict of tensors), or a list of N trees for
    cross-policy batching (lane -> checkpoint by the request's
    ``policy``). ``route``: ``"auto"`` (the ``ops`` dispatch: the CUDA
    kernel on the card, the plain version on the CPU) or
    ``"policy_forward"`` (the masked training net; the reference's
    ``"xla"`` route). ``device``: where the weights live and the forward
    runs; the default ``"cuda"`` raises without a card."""

    def __init__(self, params, *, obs_dim: int, n_actions: int,
                 frame_stack: int = 1,
                 slot: Union[int, Sequence[int]] = 64,
                 fast_gates: bool = True, route: str = "auto",
                 device="cuda"):
        if route == "interpret":
            raise ValueError(
                "route 'interpret' (Pallas interpret mode) has no "
                "counterpart in the port: use 'auto' or 'policy_forward'")
        if route not in ("auto", "policy_forward"):
            raise ValueError(f"unknown route: {route!r}")
        shapes = (slot,) if isinstance(slot, int) else tuple(slot)
        shapes = tuple(sorted(set(int(s) for s in shapes)))
        if not shapes or shapes[0] < 1:
            raise ValueError(f"slot shapes must be >= 1, got {slot!r}")
        self.slots = shapes
        self.slot = shapes[-1]           # the largest shape
        self.obs_dim = obs_dim
        self.frame_stack = frame_stack
        self.frame_dim = obs_dim * frame_stack
        self.n_actions = n_actions
        self.fast_gates = fast_gates
        self.route = route
        self.device = resolve_device(device)
        multi = isinstance(params, (list, tuple))
        self.n_policies = len(params) if multi else 1
        self._stages: Dict[int, _Stage] = {}
        self._warmed: set = set()
        self.state = "warming"
        self.policy_version = 0
        self.reloads = 0
        self.reload_rejected = 0
        self.reload_log: List[Tuple[str, str]] = []
        # pinned probe slot for reload canaries: fixed frames at the
        # smallest shape, every checkpoint exercised (the reference's
        # numpy draw, so both packages probe with the same frames)
        self._probe_frames = np.random.default_rng(0).standard_normal(
            (self.slots[0], self.frame_dim)).astype(np.float32)
        probe = self.slots[0]
        self._probe_stage = _Stage(probe, self.frame_dim, self.device)
        self._probe_stage.frames_np[:] = self._probe_frames
        self._probe_stage.mask_np[:] = 1
        self._probe_stage.pidx_np[:] = self._probe_pidx(probe)

        dev = self.device

        def on_dev(tree):
            return tree_map(lambda w: w.to(dev), tree)

        if multi:
            if route == "policy_forward":
                def fwd(frames, mask, pidx, weights):
                    logits = frames.new_zeros((frames.shape[0], n_actions))
                    v = frames.new_zeros((frames.shape[0],))
                    for n, p in enumerate(weights):
                        lg_n, v_n = policy_forward(p, frames,
                                                   fast_gates=fast_gates)
                        sel = pidx == n
                        logits = torch.where(sel[:, None], lg_n, logits)
                        v = torch.where(sel, v_n, v)
                    return _masked(logits, v, mask)

                def make_weights(ps):
                    return tuple(on_dev(p) for p in ps)
            else:
                def fwd(frames, mask, pidx, weights):
                    logits, v = ops.serve_forward_multi(
                        frames, mask, pidx, weights, fast_gates=fast_gates)
                    return torch.argmax(logits, -1), logits, v

                def make_weights(ps):
                    return on_dev(fuse_head(stack_policy_weights(list(ps))))
        else:
            if route == "policy_forward":
                def fwd(frames, mask, pidx, weights):
                    del pidx             # single policy: one checkpoint
                    logits, v = policy_forward(weights, frames,
                                               fast_gates=fast_gates)
                    return _masked(logits, v, mask)

                def make_weights(ps):
                    return on_dev(ps)
            else:
                def fwd(frames, mask, pidx, weights):
                    del pidx             # single policy: one checkpoint
                    logits, v = ops.serve_forward(frames, mask, weights,
                                                  fast_gates=fast_gates)
                    return torch.argmax(logits, -1), logits, v

                def make_weights(ps):
                    return on_dev(fuse_head(flat_policy_weights(ps)))

        self._params = list(params) if multi else params
        self._make_weights = make_weights
        self._weights = make_weights(self._params)
        self._fwd = fwd

    def _stage(self, shape: int) -> _Stage:
        st = self._stages.get(shape)
        if st is None:
            st = self._stages[shape] = _Stage(shape, self.frame_dim,
                                              self.device)
        return st

    def _run(self, st: _Stage, weights):
        """The forward on a stage's contents, returned after the device
        has finished (latency is measured to that point)."""
        out = self._fwd(*st.inputs(), weights)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def forward_slot(self, frames, n_valid: int, pidx=None):
        """One dispatch on an already-padded (shape, frame_dim) batch
        with ``n_valid`` real lanes -> (actions (shape,), logits, v) on
        the server's device, after the device has finished. ``frames``
        and ``pidx`` may be the shape's own staging views (``_pack``, no
        copy) or any array or tensor, copied into them. ``pidx`` (shape,)
        int32 routes each lane to its checkpoint on a multi-policy server
        (zeros when omitted). Pad-lane outputs are zeros (and action 0)
        by the kernel-boundary mask."""
        shape = int(frames.shape[0])
        st = self._stage(shape)
        if frames is not st.frames:
            st.frames.copy_(torch.as_tensor(frames))
        if pidx is None:
            st.pidx.zero_()
        elif pidx is not st.pidx:
            st.pidx.copy_(torch.as_tensor(np.asarray(pidx)))
        st.mask_np[:n_valid] = 1
        st.mask_np[n_valid:] = 0
        out = self._run(st, self._weights)
        self._warmed.add(shape)
        return out

    def warmup(self, shapes: Optional[Sequence[int]] = None) -> None:
        """Run every slot shape once before the serving clock starts
        (staging allocation and the first launch of a shape never land
        on a dispatch latency). Idempotent per shape."""
        for shape in shapes if shapes is not None else self.slots:
            if shape not in self._warmed:
                frames, pidx = self._pack([], shape)
                self.forward_slot(frames, 0, pidx)

    # ---------------------------------------------------- hot reload

    def _probe_pidx(self, shape: int) -> np.ndarray:
        return (np.arange(shape, dtype=np.int32) % self.n_policies)

    def reload(self, params) -> bool:
        """Validated atomic hot swap of the serving weights. Three gates,
        in order, all on the candidate (the serving weights are untouched
        until every gate passes): the ABI check, the finite canary on the
        pinned probe slot, and bitwise parity of that canary with a fresh
        server built from the candidate. Success rebinds weights and
        params, bumps ``policy_version`` and ``reloads``, and returns
        True; any failure (a malformed candidate included) rolls back,
        counts ``reload_rejected``, logs the reason in ``reload_log`` and
        returns False."""
        multi = isinstance(self._params, list)
        try:
            if multi != isinstance(params, (list, tuple)):
                raise _ReloadRejected(
                    "abi: single/multi policy kind mismatch")
            if multi and len(params) != self.n_policies:
                raise _ReloadRejected(
                    f"abi: {len(params)} policies for a "
                    f"{self.n_policies}-policy server")
            cand_params = list(params) if multi else params
            try:
                cand = self._make_weights(cand_params)
            except Exception as e:
                raise _ReloadRejected(f"abi: weight build failed: {e}")
            cur = tree_leaves_with_path(self._weights)
            new = tree_leaves_with_path(cand)
            if [p for p, _ in cur] != [p for p, _ in new]:
                raise _ReloadRejected("abi: weight tree structure differs")
            for (_, old), (_, nw) in zip(cur, new):
                if (tuple(old.shape) != tuple(nw.shape)
                        or old.dtype != nw.dtype):
                    raise _ReloadRejected(
                        f"abi: leaf {tuple(old.shape)}/{old.dtype} != "
                        f"{tuple(nw.shape)}/{nw.dtype}")

            probe = self.slots[0]
            out = self._run(self._probe_stage, cand)
            if not all(bool(torch.isfinite(x).all()) for x in out[1:]):
                raise _ReloadRejected(
                    "canary: non-finite logits/values on the probe slot")
            fresh = PolicyServer(
                cand_params, obs_dim=self.obs_dim,
                n_actions=self.n_actions, frame_stack=self.frame_stack,
                slot=probe, fast_gates=self.fast_gates, route=self.route,
                device=self.device)
            ref = fresh.forward_slot(self._probe_frames, probe,
                                     self._probe_pidx(probe))
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise _ReloadRejected(
                    "canary: probe outputs differ from the candidate's "
                    "own fresh server (not bitwise)")
        except _ReloadRejected as e:
            reason = str(e)
        except Exception as e:           # malformed candidate trees etc.
            reason = f"abi: {type(e).__name__}: {e}"
        else:
            self._weights = cand
            self._params = cand_params
            self.policy_version += 1
            self.reloads += 1
            self.reload_log.append(("ok", f"v{self.policy_version}"))
            return True
        self.reload_rejected += 1
        self.reload_log.append(("rejected", reason))
        return False

    def reload_from_checkpoint(self, ckpt_dir, step: Optional[int] = None
                               ) -> bool:
        """Hot-reload the policy subtree of an ``rl_train`` checkpoint
        through the full reload gate. A torn or corrupt checkpoint (every
        layout ``distributed/fault_injection.py::torn_save`` builds)
        makes ``ckpt.restore_subtree`` raise, which counts as a rejected
        reload; the server keeps serving on the old weights."""
        if self.n_policies != 1:
            raise ValueError(
                "reload_from_checkpoint serves single-policy servers; "
                "restore each checkpoint and call reload([..]) instead")
        try:
            params, _, _ = ckpt.restore_subtree(
                ckpt_dir, self._params, "['policy']", step=step)
        except Exception as e:
            self.reload_rejected += 1
            self.reload_log.append(
                ("rejected", f"restore: {type(e).__name__}: {e}"))
            return False
        return self.reload(params)

    # ------------------------------------------------------- packing

    def _pack(self, batch: List[Request], shape: int):
        """Pack ``batch`` into the ``shape``-lane staging views -> (frames
        (shape, frame_dim) f32, pidx (shape,) int32), the same tensors
        every dispatch of that shape: no per-dispatch allocation and no
        re-pad of the tail (pad lanes keep the previous dispatch's rows,
        garbage by contract)."""
        st = self._stage(shape)
        if batch:
            st.frames_np[:len(batch)] = [req.frame for req in batch]
            st.pidx_np[:len(batch)] = [req.policy for req in batch]
        return st.frames, st.pidx

    def make_scheduler(self) -> SlotScheduler:
        """Bucketed over ``slots`` when the server has several shapes,
        fixed-slot otherwise."""
        if len(self.slots) > 1:
            return BucketedSlotScheduler(self.slots)
        return SlotScheduler(self.slot)

    # -------------------------------------------------------- replay

    def _dispatch_once(self, sched, stats: ServeStats,
                       latencies: List[float], now: float, mode: str,
                       service_time_s: float, t_start: float,
                       extra_s: float):
        """Pop + pack + forward one batch, advance the clock (virtual:
        ``service_time_s + extra_s``; wallclock: real time plus a slept
        ``extra_s``), complete the batch -> (new now, dispatch seconds,
        shape)."""
        t_disp = time.perf_counter()
        shape, batch = sched.next_dispatch()
        frames, pidx = self._pack(batch, shape)
        self.forward_slot(frames, len(batch), pidx)
        if mode == "wallclock":
            if extra_s > 0:
                time.sleep(extra_s)
            now = time.perf_counter() - t_start
            dt = time.perf_counter() - t_disp
        else:
            dt = service_time_s + extra_s
            now = now + dt
        sched.complete(batch, now)
        stats.record(shape, len(batch))
        latencies.extend(now - r.arrival for r in batch)
        return now, dt, shape

    def drain(self, sched, *, stats: Optional[ServeStats] = None,
              now: float = 0.0, service_time_s: float = 1e-3
              ) -> Tuple[ServeStats, float]:
        """Complete every in-flight batch on ``sched`` (no new
        admissions) on a virtual clock starting at ``now``, then land on
        ``drained`` with a final stats snapshot -> (stats, completion
        time)."""
        self.state = "draining"
        stats = stats if stats is not None else ServeStats()
        latencies: List[float] = []
        while sched.pending:
            now, _, _ = self._dispatch_once(
                sched, stats, latencies, now, "virtual", service_time_s,
                0.0, 0.0)
        self.state = "drained"
        stats.final_state = self.state
        return stats, now

    def serve(self, trace: List[Request],
              scheduler: Optional[SlotScheduler] = None, *,
              mode: str = "wallclock",
              service_time_s: float = 1e-3,
              admission=None, faults=None,
              reload_at: Sequence[int] = (),
              reload_params=None) -> ServeReport:
        """Replay an arrival-sorted open-loop ``trace`` to completion.

        ``mode="wallclock"`` measures real dispatch latency (idles until
        the next arrival when the queue runs dry, so offered load stays
        open-loop); ``mode="virtual"`` advances a deterministic clock by
        ``service_time_s`` per dispatch. ``admission`` (an
        ``AdmissionController``) gates every admit, its rejections
        counted in the report's stats. ``faults`` (a ``FaultInjector``)
        fires ``RequestFlood`` on the trace before replay,
        ``SlowDispatch`` at its dispatch index and ``CorruptCheckpoint``
        at the matching hot-reload attempt. ``reload_at`` lists dispatch
        indices at which the server attempts ``reload(reload_params)``
        (its own current params when None); attempts past the last
        dispatch fire during the final drain. Lifecycle: ``serving``
        while arrivals remain, ``draining`` once only backlog is left,
        ``drained`` at return."""
        if mode not in ("wallclock", "virtual"):
            raise ValueError(f"unknown mode: {mode!r}")
        if faults is not None:
            for fl in faults.take_floods():
                trace = flood_trace(trace, fl.at_s, fl.duration_s,
                                    fl.multiplier)
        sched = scheduler if scheduler is not None else \
            self.make_scheduler()
        self.warmup(getattr(sched, "buckets", (sched.slot,)))
        self.state = "serving"
        stats = ServeStats()
        reloads0 = self.reloads
        rejected0 = self.reload_rejected
        pending_reloads = sorted(set(int(d) for d in reload_at))
        reload_attempt = 0

        def try_reloads(dispatch_idx: Optional[int]) -> None:
            nonlocal reload_attempt
            while pending_reloads and (
                    dispatch_idx is None
                    or pending_reloads[0] <= dispatch_idx):
                pending_reloads.pop(0)
                cand = (reload_params if reload_params is not None
                        else self._params)
                if faults is not None:
                    cand = faults.corrupt_params(reload_attempt, cand)
                self.reload(cand)
                reload_attempt += 1

        latencies: List[float] = []
        next_req = 0
        dispatch_idx = 0
        n = len(trace)
        t_start = time.perf_counter()
        now = 0.0
        last_done = 0.0

        while next_req < n or sched.pending:
            if mode == "wallclock":
                now = time.perf_counter() - t_start
            while next_req < n and trace[next_req].arrival <= now:
                req = trace[next_req]
                if admission is None:
                    sched.admit(req)
                else:
                    admission.admit(req, now, sched, stats)
                next_req = next_req + 1
            if next_req >= n and self.state == "serving":
                self.state = "draining"   # only backlog left
            if not sched.pending:
                if next_req >= n:
                    break                 # everything shed: nothing to run
                # open-loop idle: jump/sleep to the next arrival
                now = trace[next_req].arrival
                if mode == "wallclock":
                    wait = now - (time.perf_counter() - t_start)
                    if wait > 0:
                        time.sleep(wait)
                continue
            try_reloads(dispatch_idx)
            extra = (faults.dispatch_delay_s(dispatch_idx)
                     if faults is not None else 0.0)
            now, dt, shape = self._dispatch_once(
                sched, stats, latencies, now, mode, service_time_s,
                t_start, extra)
            if admission is not None:
                admission.observe_dispatch(shape, dt, sched)
            last_done = now
            dispatch_idx += 1
        try_reloads(None)                 # leftover plan: fire at drain
        self.state = "drained"
        stats.reloads = self.reloads - reloads0
        stats.reload_rejected = self.reload_rejected - rejected0
        stats.final_state = self.state

        makespan = max(last_done - (trace[0].arrival if trace else 0.0),
                       1e-9)
        lat = np.asarray(latencies) if latencies else np.zeros(1)
        return ServeReport(
            requests=n, served=sched.served,
            p50_s=float(np.percentile(lat, 50)),
            p99_s=float(np.percentile(lat, 99)),
            qps=sched.served / makespan,
            deadline_misses=sched.deadline_misses,
            misses_by_class=dict(sched.misses_by_class),
            max_queue_depth=sched.max_queue_depth,
            dispatches=stats.dispatches,
            mean_occupancy=(stats.real_lanes / stats.dispatches
                            if stats.dispatches else 0.0),
            stats=stats,
            latencies_s=latencies)


def _masked(logits, v, mask):
    """The policy_forward route's boundary: pad lanes zeroed, greedy
    actions -> (actions, logits, v)."""
    m = mask != 0
    logits = torch.where(m[:, None], logits, torch.zeros_like(logits))
    v = torch.where(m, v, torch.zeros_like(v))
    return torch.argmax(logits, -1), logits, v
