"""Quickstart on the PyTorch/CUDA port: the paper's whole pipeline, step
for step as ``examples/quickstart.py`` runs it on the JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Build the traffic-grid Global Simulator (25 intersections; the scalar
   protocol, lifted to a batch by ``torch.func.vmap``).
2. Algorithm 1: collect (d_t, u_t) from the GS under a random policy.
3. Train the Approximate Influence Predictor (cross-entropy, Eq. 3).
4. Compose the IALS (local simulator + AIP, Algorithm 2) on the scalar
   protocol (``core.ials.make_ials``).
5. Train PPO on the IALS; evaluate on the GS.

The device defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the same pipeline on the CPU. The size flags exist so a test
can run the pipeline small; their defaults are the reference's sizes.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import collect, ials, influence  # noqa: E402
from repro_torch.envs.traffic import (make_local_traffic_env,  # noqa: E402
                                      make_traffic_env)
from repro_torch.rl import ppo  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--collect-episodes", type=int, default=48)
    ap.add_argument("--ep-len", type=int, default=128)
    ap.add_argument("--aip-epochs", type=int, default=10)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--rollout-len", type=int, default=128)
    ap.add_argument("--eval-episodes", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the pipeline -> its numbers: transitions, the AIP's first and
    final cross-entropy, per-iteration loss and IALS reward, the GS
    evaluation reward and the seconds of each stage."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gs = make_traffic_env(device=dev)
    ls = make_local_traffic_env(device=dev)
    seconds = {}
    t_all = time.perf_counter()

    print("1) collecting (d_t, u_t) from the GS (Algorithm 1)...")
    t0 = time.perf_counter()
    data = collect.collect_dataset(gs, gen, n_episodes=args.collect_episodes,
                                   ep_len=args.ep_len)
    sync()
    seconds["collect"] = time.perf_counter() - t0
    n_trans = data["d"].shape[0] * data["d"].shape[1]
    print(f"   {n_trans} transitions in {seconds['collect']:.1f}s")

    print("2) training the AIP (Eq. 3)...")
    t0 = time.perf_counter()
    acfg = influence.AIPConfig(kind="fnn", d_in=gs.spec.dset_dim,
                               n_out=gs.spec.n_influence, hidden=64, stack=8)
    aip, metrics = influence.train_aip(acfg, data["d"], data["u"], gen,
                                       epochs=args.aip_epochs)
    sync()
    seconds["aip"] = time.perf_counter() - t0
    print(f"   cross-entropy {metrics['loss_history'][0]:.3f} -> "
          f"{metrics['final_loss']:.3f}")

    print("3) composing the IALS (Algorithm 2) and training PPO on it...")
    sim = ials.make_ials(ls, aip, acfg)
    pcfg = ppo.PPOConfig(obs_dim=gs.spec.obs_dim,
                         n_actions=gs.spec.n_actions, n_envs=args.n_envs,
                         rollout_len=args.rollout_len,
                         episode_len=args.rollout_len)
    params = ppo.init_policy(pcfg, gen)
    opt, iteration = ppo.make_train_iteration(sim, pcfg)
    ost = opt.init(params)
    rs = ppo.init_rollout_state(sim, pcfg, gen)
    losses, rewards = [], []
    t0 = time.perf_counter()
    for it in range(args.iterations):
        params, ost, rs, m = iteration(params, ost, rs, gen)
        losses.append(float(m["loss"]))
        rewards.append(float(m["mean_reward"]))
        print(f"   iter {it}: IALS reward {rewards[-1]:.3f}, loss "
              f"{losses[-1]:.4f} ({time.perf_counter() - t0:.1f}s)")
    sync()
    seconds["ppo"] = time.perf_counter() - t0

    print("4) evaluating on the GS (deployment environment)...")
    t0 = time.perf_counter()
    r = ppo.evaluate(gs, pcfg, params, gen, n_episodes=args.eval_episodes)
    sync()
    seconds["eval"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_all
    print(f"   GS eval mean reward: {r:.3f}  "
          f"(random-policy baseline ~0.81, saturated-fixed ~varies)")
    out = {"transitions": n_trans,
           "aip_xent": [metrics["loss_history"][0], metrics["final_loss"]],
           "losses": losses, "ials_rewards": rewards, "gs_eval_reward": r,
           "seconds": seconds}
    if not all(math.isfinite(x) for x in losses + out["aip_xent"]):
        raise RuntimeError(f"non-finite loss: {out}")
    return out


if __name__ == "__main__":
    main()
