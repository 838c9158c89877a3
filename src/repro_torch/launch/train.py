"""LM training driver (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --steps 6 --batch 8 --seq 512 --microbatches 2     # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen3-4b --reduced --steps 100 --batch 8 --seq 128 \
        --ckpt-dir /tmp/run1

Wires: ``TokenPipeline`` (host-sharded, seeded data) -> ``train_step``
(gradient accumulation over ``--microbatches``, remat as the config's
``remat`` says) -> AdamW under a cosine schedule, updating in place ->
``TrainingGuard`` (atomic checkpoints, auto-resume, SIGTERM answered by
a flush and a clean exit) -> ``StragglerDetector``. Weights are random
from ``--seed`` (``repro_torch.stream``, a seeded ``torch.Generator``);
VLM and enc-dec archs get zero vision / audio-frame inputs, as the
reference's driver gives them. One JSON row is printed every
``--log-every`` steps and at the last (step, loss, ce, grad_norm,
step_time_s, the step's wall time ended by ``torch.cuda.synchronize()``
on the card); ``--metrics-out`` writes the rows. Runs on the card unless
``--device cpu``; without CUDA the default raises.

Beyond the reference's flags: ``--device`` and ``--layers``, the depth
cut to N layers at the config's width (0: the config's depth), which
keeps a full-width run of a large config on one card.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device, stream
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.fault_tolerance import StragglerDetector, \
    TrainingGuard
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.optim.adamw import adamw, cosine_schedule

TAG_PARAMS = 0     # repro_torch.stream tag of the weights (as serve's)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = cfg.with_overrides(n_layers=args.layers)
    return cfg


def modality_inputs(cfg, batch: int, dev) -> dict:
    """Zero vision / audio-frame embeddings for the VLM / enc-dec archs."""
    extra = {}
    if cfg.family == "vlm":
        extra["vision"] = torch.zeros((batch, cfg.n_vision_tokens,
                                       cfg.d_model), dtype=cfg.dtype(),
                                      device=dev)
    if cfg.family == "encdec":
        extra["frames"] = torch.zeros((batch, cfg.n_audio_frames,
                                       cfg.d_model), dtype=cfg.dtype(),
                                      device=dev)
    return extra


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    """The driver -> {history, metrics, state (params, opt), cfg,
    start_step, preempted}: ``metrics`` holds every step's metrics
    (``loss``, ``ce``, ``lb_loss``, ``z_loss``, ``drop_frac``,
    ``grad_norm``, ``lr``) as floats, ``state`` is the last step's
    (updated in place)."""
    dev = resolve_device(args.device)
    cfg = config(args)
    data = TokenPipeline(DataConfig(seq_len=args.seq,
                                    global_batch=args.batch,
                                    vocab_size=cfg.vocab_size,
                                    seed=args.seed))
    opt = adamw(cosine_schedule(args.lr, args.warmup, args.steps))
    step_fn = steps_lib.make_train_step(cfg, opt, args.microbatches)

    def init_state():
        params = lm.init_params(cfg, stream(dev, args.seed, TAG_PARAMS))
        return {"params": params, "opt": opt.init(params)}

    guard = None
    start_step = 0
    if args.ckpt_dir:
        guard = TrainingGuard(args.ckpt_dir, save_every=args.save_every)
        state, start_step = guard.resume_or(init_state)
        if start_step:
            print(f"resumed from step {start_step}", flush=True)
    else:
        state = init_state()

    detector = StragglerDetector()
    history, step_metrics = [], []
    extra = modality_inputs(cfg, args.batch, dev)
    preempted = False
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                dev, dtype=torch.long)
                for k, v in data.get_batch(step).items()}
            batch.update(extra)
            _sync(dev)
            t0 = time.perf_counter()
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], batch)
            _sync(dev)
            dt = time.perf_counter() - t0
            step_metrics.append({k: float(v) for k, v in metrics.items()})
            if detector.update(step, dt):
                print(f"[straggler] sustained slow steps at {step} "
                      f"(would trigger elastic restart on a cluster)")
            if step % args.log_every == 0 or step == args.steps - 1:
                row = {"step": step, "loss": float(metrics["loss"]),
                       "ce": float(metrics["ce"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_time_s": round(dt, 4)}
                history.append(row)
                print(json.dumps(row), flush=True)
            if guard is not None:
                guard.maybe_save(step + 1, state)
                if guard.answered:   # the flush answered a SIGTERM
                    print("preempted: checkpoint flushed, exiting cleanly",
                          flush=True)
                    preempted = True
                    break
        if guard is not None and not preempted:
            guard.maybe_save(args.steps, state, force=True)
    finally:
        if guard is not None:
            guard.uninstall()
    if args.metrics_out and not preempted:
        Path(args.metrics_out).write_text(json.dumps(history, indent=1))
    return {"history": history, "metrics": step_metrics, "state": state,
            "cfg": cfg, "start_step": start_step, "preempted": preempted}


def main(argv=None):
    """-> the history rows (the reference's return value)."""
    return run(parse_args(argv))["history"]


if __name__ == "__main__":
    main()
