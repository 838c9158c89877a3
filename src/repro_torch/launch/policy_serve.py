"""Serve a trained policy against synthetic open-loop traffic (counterpart
of ``repro/launch/policy_serve.py``: the same flags and JSON, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.policy_serve \
        --domain traffic --regions 256 --rps 20000 --duration-s 2 --slot 128
    PYTHONPATH=src python -m repro_torch.launch.policy_serve \
        --bimodal --calibrate 3 --n-policies 4   # calibrated + cross-policy
    PYTHONPATH=src python -m repro_torch.launch.policy_serve --virtual \
        --admission --faults slow:10:0.05,flood:0.5:0.2:4,corrupt:0:nan \
        --reload-at 100,200                        # the chaos plan
    PYTHONPATH=src python -m repro_torch.launch.policy_serve \
        --ckpt-dir ckpts/traffic --slot 64 --out serve.json

Agent regions stream action requests at a fixed offered load
(``serving/request.py``; ``--bimodal`` for the heavy-tailed burst mix);
``serving/scheduler.py`` packs them into slots earliest-deadline-first
(one shape ``--slot``, a bucket set ``--buckets``, or one calibrated from
the trace ``--calibrate K``); ``serving/server.py::PolicyServer`` runs
each slot through the masked slot forward, on the card the hand-written
``serve_forward`` kernel (``serve_forward_multi`` with ``--n-policies
N``). The replay reports p50/p99 latency (arrival -> slot completion,
queueing included), QPS and the padded-lane waste counters.

``--ckpt-dir`` restores the policy from an ``rl_train`` checkpoint with
``checkpoint/ckpt.py::restore_subtree`` (the ``['policy']`` leaves only;
a checkpoint of either package). With ``--n-policies N`` it seeds
checkpoint 0 and the other N-1 are fresh inits. ``--admission``,
``--faults``, ``--reload-at`` and ``--virtual`` are the overload and
chaos controls of the reference; after a fault run the plan must be
exhausted. ``--domain warehouse`` serves the warehouse policy (8 stacked
37-wide observations, 5 actions). Runs on the card unless ``--device
cpu``; without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault_injection import (FaultInjector,
                                                     parse_serve_faults)
from repro_torch.launch.rl_train import build_domain
from repro_torch.rl import ppo
from repro_torch.serving import (BIMODAL_SIZES, BIMODAL_WEIGHTS,
                                 AdmissionController, OverloadConfig,
                                 PolicyServer, TraceConfig,
                                 calibrate_buckets, synthetic_trace)


def _init_policy(pcfg, seed: int, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return ppo.init_policy(pcfg, g)


def build_server_and_trace(args):
    """-> (PolicyServer, trace, info dict): the entry point's body, callable
    in-process."""
    dev = resolve_device(args.device)
    gs, _, frame_stack = build_domain(args.domain, device=dev)
    pcfg = ppo.PPOConfig(obs_dim=gs.spec.obs_dim,
                         n_actions=gs.spec.n_actions,
                         frame_stack=frame_stack)
    n_policies = args.n_policies
    template = _init_policy(pcfg, args.seed, dev)
    info = {"domain": args.domain, "route": args.route,
            "n_policies": n_policies, "device": str(dev)}
    if args.ckpt_dir:
        params, step, meta = ckpt.restore_subtree(
            args.ckpt_dir, template, "['policy']", step=args.step)
        info["restored_step"] = step
        info["ckpt_metadata"] = meta
    else:
        params = template
    if n_policies > 1:
        params = [params] + [_init_policy(pcfg, args.seed + 1 + n, dev)
                             for n in range(n_policies - 1)]

    tcfg = TraceConfig(n_regions=args.regions, mean_rps=args.rps,
                       horizon_s=args.duration_s,
                       frame_dim=gs.spec.obs_dim * frame_stack,
                       seed=args.seed, n_policies=n_policies)
    if args.bimodal:
        tcfg = dataclasses.replace(tcfg, region_sizes=BIMODAL_SIZES,
                                   region_size_weights=BIMODAL_WEIGHTS)
    trace = synthetic_trace(tcfg)
    info["requests"] = len(trace)

    if args.calibrate:
        slot = calibrate_buckets(trace, max_buckets=args.calibrate,
                                 max_slot=args.slot)
        info["calibrated"] = True
    elif args.buckets:
        slot = tuple(int(s) for s in args.buckets.split(","))
    else:
        slot = args.slot
    info["slot"] = list(slot) if isinstance(slot, tuple) else slot

    server = PolicyServer(params, obs_dim=pcfg.obs_dim,
                          n_actions=pcfg.n_actions,
                          frame_stack=frame_stack, slot=slot,
                          route=args.route, device=dev)
    return server, trace, info


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--domain", choices=["traffic", "warehouse"],
                    default="traffic")
    ap.add_argument("--slot", type=int, default=128,
                    help="single slot shape (also the max_slot cap for "
                         "--calibrate)")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated ascending slot shapes, e.g. "
                         "16,64,256: the bucketed multi-slot server")
    ap.add_argument("--calibrate", type=int, default=None, metavar="K",
                    help="pick <= K bucket shapes offline from the trace's "
                         "burst-size distribution; overrides "
                         "--buckets/--slot")
    ap.add_argument("--n-policies", type=int, default=1,
                    help="cross-policy batching: serve N checkpoints from "
                         "one server, lane-routed by region family")
    ap.add_argument("--bimodal", action="store_true",
                    help="bimodal region burst sizes")
    ap.add_argument("--regions", type=int, default=256)
    ap.add_argument("--rps", type=float, default=20000.0)
    ap.add_argument("--duration-s", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--route", choices=["auto", "policy_forward"],
                    default="auto",
                    help="auto: the serve_forward kernel on the card, its "
                         "plain version on the CPU; policy_forward: the "
                         "masked training net")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the policy subtree from an rl_train "
                         "checkpoint (no training-state payload read)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--admission", action="store_true",
                    help="admission control in front of the scheduler: "
                         "bounded queue + deadline feasibility + brownout")
    ap.add_argument("--queue-cap", type=int, default=8192,
                    help="bounded admission queue (pending requests)")
    ap.add_argument("--faults", default=None,
                    help="deterministic serving fault plan, e.g. "
                         "'slow:10:0.05,flood:0.5:0.2:4,corrupt:0:nan'")
    ap.add_argument("--reload-at", default=None,
                    help="comma-separated dispatch indices at which to "
                         "attempt a hot self-reload")
    ap.add_argument("--virtual", action="store_true",
                    help="deterministic virtual-clock replay")
    ap.add_argument("--service-time-s", type=float, default=1e-3,
                    help="per-dispatch service time of the virtual clock")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    inj = (FaultInjector(parse_serve_faults(args.faults)) if args.faults
           else None)
    server, trace, info = build_server_and_trace(args)
    admission = None
    if args.admission:
        admission = AdmissionController(OverloadConfig(
            queue_cap=args.queue_cap,
            default_latency_s=args.service_time_s))
    if inj is not None:
        info["fault_plan"] = args.faults
    reload_at = (tuple(int(d) for d in args.reload_at.split(","))
                 if args.reload_at else ())
    server.warmup()          # every slot shape runs once before the clock
    report = server.serve(
        trace, mode="virtual" if args.virtual else "wallclock",
        service_time_s=args.service_time_s, admission=admission,
        faults=inj, reload_at=reload_at)
    out = {**info, **report.summary(),
           "policy_version": server.policy_version,
           "reload_log": [list(e) for e in server.reload_log]}
    if inj is not None:
        inj.assert_exhausted()   # a fault that never fired is a config bug
        out["faults_applied"] = inj.applied_counts()
    print(json.dumps(out, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
