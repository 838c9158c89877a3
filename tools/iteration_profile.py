"""Where a PPO iteration's time goes on the card, per simulator: the IALS
(its acting horizon one ``policy_rollout`` launch) against the F-IALS
(PPO's plain loop over ``step_det``, as in the JAX package).

    python3 tools/iteration_profile.py [--iterations 5]

For traffic (FNN AIP, A = 1) and the warehouse (GRU AIP, A = 36; its
F-IALS with ``--fixed-marginal 0.1 --stateless-f-ials``), at
``chip_smoke.py``'s widths (16 envs, 128-tick rollouts and episodes), it
builds the simulator as ``rl_train`` does (8 collection episodes and one
AIP epoch: the AIP's quality does not change the time), warms up two
iterations, then reports per configuration, medians over ``--iterations``:

- the iteration's wall time, and its two halves, each ended by a device
  sync: the rollout (stream drawing and the acting horizon) and the
  learner (GAE and the 16 minibatch updates);
- from one iteration under ``torch.profiler``: the device events (kernels,
  copies, fills) it enqueued, their summed device time, and that sum over
  the profiled iteration's wall time (the device's busy share; one stream,
  so events do not overlap), with the five kernels that took the most.

Then the fleet against the integrated trainer, timed the same way, on
traffic FNN A = 1 with 2 workers: each trainer warms up 2 updates, then
``--fleet-updates`` (16) are timed from the first call to the last
device sync; samples/s counts the applied batches. The fleet runs
deterministic, async (its design: a CUDA event a batch, the learner's
stream waits on it), async with a device-wide sync a batch (the first
design) and async with a queue of 1. Each fleet line has host spans
summed over threads (``apply_s``: the learner's updates; ``produce_s``:
the workers' rollouts, enqueue only in async mode) and, from 4 more
updates under ``torch.profiler``, the device's busy share.

One JSON line a configuration, then the ``nvidia-smi`` line of the card.
``--only iteration|fleet`` runs one part. Needs a CUDA card; exits 1
without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

WIDTHS = ["--n-envs", "16", "--rollout-len", "128", "--episode-len", "128",
          "--collect-episodes", "8", "--aip-epochs", "1", "--device", "cuda",
          "--seed", "0"]
CONFIGS = {
    "traffic fnn A=1 ials": ["--domain", "traffic", "--aip", "fnn",
                             "--simulator", "ials"],
    "traffic fnn A=1 f-ials": ["--domain", "traffic", "--aip", "fnn",
                               "--simulator", "f-ials"],
    "warehouse gru A=36 ials": ["--domain", "warehouse", "--n-agents", "36",
                                "--simulator", "ials"],
    "warehouse gru A=36 f-ials": ["--domain", "warehouse", "--n-agents",
                                  "36", "--simulator", "f-ials",
                                  "--fixed-marginal", "0.1",
                                  "--stateless-f-ials"],
}


def build(argv):
    """-> (parsed args, device, PPO config, optimizer, env, state dict
    with params / ost / rs / it), as ``rl_train`` builds a run from its
    start."""
    from repro_torch.launch import rl_train
    from repro_torch.rl import ppo
    args = rl_train.parse_args(WIDTHS + argv)
    dev, _, sb, pcfg = rl_train.setup(args)
    opt = ppo.make_optimizer(pcfg)
    _, _, env, params, ost, rs = rl_train.fresh_state(args, dev, sb, pcfg,
                                                      opt)
    return args, dev, pcfg, opt, env, {"params": params, "ost": ost,
                                       "rs": rs, "it": 0}


def halves(argv):
    """-> (one-iteration fn, rollout fn, learner fn) over a fresh run,
    each ended by a device sync; the generators are ``rl_train``'s."""
    import torch
    from repro_torch.launch import rl_train
    from repro_torch.rl import ppo
    args, dev, cfg, opt, env, st = build(argv)
    learner = ppo.learner_update_fn(cfg, opt)

    def rollout():
        g = rl_train.train_stream(args, dev, st["it"])
        st["rs"], st["batch"], st["v_last"] = ppo.rollout(
            env, cfg, st["params"], st["rs"], g)
        st["gen"] = g
        torch.cuda.synchronize()

    def learn():
        st["params"], st["ost"], m = learner(
            st["params"], st["ost"], st["batch"], st["v_last"], st["gen"])
        float(m["loss"])
        torch.cuda.synchronize()
        st["it"] += 1

    def iteration():
        rollout()
        learn()

    return iteration, rollout, learn


def wall(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def profile_iteration(iteration):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = wall(iteration)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    per = collections.defaultdict(float)
    for e in events:
        per[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"device_events": len(events), "device_busy_s": busy,
            "profiled_wall_s": w, "busy_share": busy / w,
            "top_kernels_ms": [[n, round(ms, 4)] for n, ms in top]}


def timed(cls):
    """``cls`` with host spans summed over its threads: the learner's
    updates (``apply_s``) and the workers' produces (``produce_s``)."""
    class Timed(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.spans = collections.Counter()
            self._span_lock = threading.Lock()

        def _span(self, key, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            with self._span_lock:
                self.spans[key] += time.perf_counter() - t0
            return out

        def _produce_one(self, *a):
            return self._span("produce_s", super()._produce_one, *a)

        def _apply(self, *a):
            return self._span("apply_s", super()._apply, *a)
    return Timed


def device_sync_handoff(cls):
    """``cls`` with the first async handoff: a device-wide sync after
    each produce instead of an event."""
    import torch

    class DeviceSync(cls):
        def _ready(self):
            torch.cuda.synchronize(self.device)
            return None
    return DeviceSync


def fleet_compare(updates):
    """The integrated trainer and four fleets, ``updates`` timed updates
    each after 2 warm-up updates -> one record each."""
    import dataclasses
    import torch
    from repro_torch.distributed import actor_learner as al
    from repro_torch.launch import rl_train
    from repro_torch.rl import ppo
    args, dev, cfg, opt, env, st = build(CONFIGS["traffic fnn A=1 ials"] +
                                         ["--n-workers", "2"])
    samples = args.n_envs * args.rollout_len
    iteration = ppo.train_iteration_fn(env, cfg, opt)

    def integrated(n):
        for _ in range(n):
            st["params"], st["ost"], st["rs"], m = iteration(
                st["params"], st["ost"], st["rs"],
                rl_train.train_stream(args, dev, st["it"]))
            float(m["loss"])
            st["it"] += 1
        torch.cuda.synchronize()

    integrated(2)
    el = wall(lambda: integrated(updates))
    out = [{"trainer": "integrated", "updates": updates, "elapsed_s": el,
            "samples_per_s": updates * samples / el}]
    det = rl_train.fleet_config(args)
    asy = dataclasses.replace(det, deterministic=False)
    variants = {
        "fleet deterministic": (det, al.ActorLearnerTrainer),
        "fleet async": (asy, al.ActorLearnerTrainer),
        "fleet async, device sync a batch": (
            asy, device_sync_handoff(al.ActorLearnerTrainer)),
        "fleet async, queue 1": (dataclasses.replace(asy, queue_size=1),
                                 al.ActorLearnerTrainer)}
    for name, (fcfg, cls) in variants.items():
        tr = timed(cls)(env, cfg, fcfg, device=dev)
        state, _ = tr.run(tr.init_state(), 2)
        torch.cuda.synchronize()
        tr.spans.clear()
        res = {}

        def timed_run():
            res["state"], res["info"] = tr.run(state, updates)
            torch.cuda.synchronize()

        el = wall(timed_run)
        info, spans = res["info"], dict(tr.spans)
        own = spans.get("apply_s", 0.0) + (
            spans.get("produce_s", 0.0) if fcfg.deterministic else 0.0)
        rec = {"trainer": name, "updates": info["updates"],
               "produced": info["produced"], "dropped": info["dropped"],
               "elapsed_s": el,
               "samples_per_s": info["updates"] * samples / el,
               **spans, "learner_other_s": el - own}
        prof = profile_iteration(lambda: tr.run(res["state"], 4))
        rec["busy_share"] = prof["busy_share"]
        rec["device_events"] = prof["device_events"]
        out.append(rec)
    return out


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--fleet-updates", type=int, default=16)
    ap.add_argument("--only", choices=["iteration", "fleet"], default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("iteration_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for rec in (fleet_compare(args.fleet_updates)
                if args.only != "iteration" else []):
        print(json.dumps(rec), flush=True)
    for name, argv_c in (CONFIGS.items() if args.only != "fleet" else []):
        iteration, rollout, learn = halves(argv_c)
        for _ in range(2):
            iteration()
        its, rolls, learns = [], [], []
        for _ in range(args.iterations):
            rolls.append(wall(rollout))
            learns.append(wall(learn))
            its.append(rolls[-1] + learns[-1])
        rec = {"config": name,
               "iteration_s": statistics.median(its),
               "rollout_s": statistics.median(rolls),
               "learner_s": statistics.median(learns),
               "iteration_s_all": its}
        rec.update(profile_iteration(iteration))
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
