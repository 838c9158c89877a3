#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; exits non-zero on any
                                     # failed check, and without a card

Phases, each printing its result and time on its own line:
  1. device and build: the card's name and power limit, torch and CUDA
     versions; the kernels are built from ``src/repro_torch/kernels/csrc``
     with nvcc (set-up time, printed);
  2. every kernel against its plain PyTorch version on the card, with the
     traffic functor and random weights made from a seed, at the main
     path's shapes and at larger ones, resets inside the horizon; then
     the four horizon kernels with the warehouse functor (spawn noise, 8
     stacked frames, the d-set read after the action) at A = 36 and 1,
     B = 16, T = 128, and two ``vanish_after = 8`` cases; and
     ``ops.ials_rollout`` (the ``aip_rollout`` kernel:
     ``aip_rollout_multi``'s at one agent, unstacked weights) at traffic
     A = 1, B = 16 and 512. Lanes are independent: a lane passes when every leaf matches (integer leaves
     exactly, float leaves within ATOL); a lane whose first mismatch
     follows a decision the plain version took within FLIP_EPS of its
     threshold counts as a flip; any other mismatch, or flips in more than
     MAX_FLIP_SHARE of the lanes, fails. Kernel and plain-version times
     (CUDA events around each call, median after warm-up) and the
     kernel's device time (``torch.profiler``, without the host's enqueue
     time, every launch of the profile counted: ``profile_calls``, which
     takes a profile again when it misses a launch and logs a
     ``[profile]`` line) are measured here; the ``[kernel]`` line of each
     horizon
     kernel (``aip_rollout_multi``, ``fnn_rollout``, ``policy_rollout``)
     and of ``aip_step`` names the launch plan it took
     (``aip_step.rollout_plan``; ``aip_step.step_plan``, the GRU
     horizon's K-parts on tiles of at most 8 lanes);
  3. the main path: ``rl_train --simulator ials`` at full width: traffic
     (FNN AIP, A = 1, twice with the same seed; then GRU AIP, A = 25) and
     the warehouse (GRU AIP, A = 36; FNN AIP, A = 1, ``--vanish-after
     8``), with the launch counters zeroed before each run and read after
     it: ``policy_rollout`` must launch once per PPO iteration (on the
     warehouse its ``[warehouse]`` counter), losses must be finite, the
     GS evaluation reward in [0, 1], and the two FNN runs must give the
     same losses, GS evaluation and final parameters bitwise;
  3b. the paper's simulator grid, resume and the fleet, at phase 3's
     widths, counters zeroed before each run and read after it: the
     untrained IALS (traffic GRU, A = 25; one ``policy_rollout`` launch an
     iteration); the F-IALS on traffic (FNN, A = 1, the empirical
     marginal) and the warehouse (GRU, A = 36, ``--fixed-marginal 0.1
     --stateless-f-ials``), which launch no kernel (PPO's plain loop, as
     in the JAX package), losses finite, GS evaluation in [0, 1], the
     iteration time logged; the AIP cross-entropies on one traffic
     dataset (trained, untrained, empirical marginal, fixed 0.1 and 0.5)
     as a finding, gating nothing; ``--ckpt-dir`` resumes (traffic FNN
     A = 1, 1 -> 3 iterations; warehouse GRU A = 36, 1 -> 2) whose final
     parameters equal phase 3's uninterrupted runs' bitwise, with the
     save and restore times; ``tools/torch_fault_smoke.py --device cuda``
     (a real SIGTERM to a real process, a clean exit after the flush, a
     bitwise resume); the actor/learner fleet (traffic FNN A = 1, 2
     workers, 4 updates): the deterministic run twice, bitwise equal, a
     2-update run checkpointed and resumed to 4 bitwise equal to it, a
     faulted run (a kill and a delayed batch on the round-robin
     schedule, one batch past ``--max-staleness 1``) with its kill and
     drop counted, an ``--async-fleet`` run; ``policy_rollout_fnn``
     launches once a produced batch, and the fleet's samples/s is logged
     beside the integrated trainer's;
  3c. lane data parallelism: ranks of ``python -m torch.distributed.run``
     sharing the card on gloo, each a subprocess whose failure fails the
     script: (a) ``tools/torch_shard_smoke.py`` at 2 ranks (data 2:
     traffic FNN A = 1, warehouse GRU A = 36) and 4 (data 2, model 2:
     traffic GRU A = 25, agents replicated, the lanes take "model";
     warehouse FNN A = 36, 18 agents a rank), B = 16, T = 128 at phase
     3's widths, and on 4 ranks also traffic GRU A = 25 at B = 64 (16
     lanes a rank, where a rank's own launch plan would take other
     K-parts than the one-process launch's): every output leaf of the
     sharded ``ppo.rollout``, ``engine.rollout`` and train iteration
     bitwise equal to the one-process program's, one ``policy_rollout``
     launch per rank a rollout, one ``aip_rollout_multi`` /
     ``fnn_rollout`` a rank an ``engine.rollout``; each rank's
     ``policy_rollout`` device ms on its block (``torch.profiler``, one
     rank at a time, B = 8 a rank at 2 ranks), the one-process launch's,
     and the gathers' event ms of one sharded rollout (host included);
     (b) ``rl_train`` at 4 ranks (warehouse GRU A = 36, 2 iterations):
     final-parameter md5, losses and GS evaluations equal to phase 3's
     one-process run, each rank launching ``policy_rollout`` once an
     iteration; (c) at 2 ranks (traffic FNN A = 1), phase 3b's
     one-process traffic
     checkpoint at iteration 1 resumed under 2 ranks to 3 at
     ``--save-every 2`` (a save, its gather included, after the second
     iteration only), equal to phase 3's uninterrupted run; the F-IALS
     (phase 3b's traffic run) and the GS (one process here) on 2 ranks,
     PPO's plain loop, whose bitwise repeat is reported, not required (no
     kernel launched); (b), (c) and these three runs side by side; (d)
     the steady iteration time at 1 and 2 ranks (traffic, the resumed
     run) and 1 and 4 (warehouse), taken so;
  4. the engine's own entry points on both domains (``engine.rollout``
     per backbone, ``engine.step`` with the GRU AIP), counters zeroed
     before and read after: ``fnn_rollout``, ``aip_rollout_multi`` (each
     with both functors) and ``aip_step`` must have launched; and
     ``engine.step`` must equal a one-tick ``engine.rollout`` bitwise
     (the AIP state, the LS state and the reward, from the same state,
     actions, bits and LS noise) at traffic A = 25, B = 16, A = 1,
     B = 512 and A = 25, B = 512 (where the step's tile is 8 lanes and
     the rollout's 32, on the same K-parts), warehouse A = 36 and 1,
     B = 16;
  4b. the scalar protocol and the loop baseline, counters zeroed before
     each run and read after it: (a) the path ``ops.ials_rollout`` at
     traffic, GRU hidden 64, B = 16 and 512, T = 128: one ``aip_rollout``
     launch a call (the JSON line's ``launches``), each result held
     against ``ref.ials_rollout_ref`` by the lane and flip rule; (b) ``batch_local_env`` /
     ``batch_env`` over the scalar LS (traffic; the warehouse at
     ``vanish_after`` 0 and 8) and multi-agent GS (traffic A = 25,
     warehouse A = 36) against the native batched envs, 32 ticks from the
     same state, actions, u and noise: integer leaves exactly, floats
     within ATOL; (c) the rows of ``benchmarks/multi_agent_throughput.py``
     (gs, gs-multi, ials-1, multi-ials, loop-ials) at 16 envs x 128 ticks
     (loop-ials over 32 of them: a rate a tick, cut for the script's time),
     traffic A = 25 (FNN AIP, stack 8) and the warehouse A = 36 (GRU),
     AIPs random from a seed, agent-steps/s each: multi-ials launches one
     ``fnn_rollout`` / ``aip_rollout_multi[warehouse]`` a horizon,
     loop-ials (a Python loop over A vmapped scalar IALS a tick) none, and
     ``batched_over_loop`` must exceed 5 in both domains; (d)
     ``engine.make_batched_ials`` under ``ppo.make_train_iteration``, one
     ``policy_rollout[fnn]`` launch an iteration, and ``ppo.make_evaluator``
     on the scalar GS; (e) ``examples/torch_quickstart.py`` in-process at
     the reference's sizes: finite losses, GS evaluation in [0, 1], its
     wall time logged;
  4c. analysis, the dry-run's IALS cells (``launch/dryrun.py``): the 12
     rows of ``IALS_SWEEP`` on the host mesh (one rank with the whole
     batch), each counted on the CPU's plain route (``op_analysis``) and
     run once on the card's kernel route from the same inputs (drawn on
     the CPU and moved), counters zeroed before and read after: every
     cell ``ok``, one ``policy_rollout`` launch for ``policy_rollout``
     and ``train_iteration``, one ``aip_rollout_multi`` / ``fnn_rollout``
     for an ``engine.rollout``, and nothing else; every output leaf of
     the card's run held against the counted plain run by the lane and
     flip rule (``train_iteration``: its rollout's outputs, then the
     learner's within ATOL when no lane flipped); each program's device
     ms (``device_ms``; where no profile holds every launch, the calls
     queued behind a spin kernel and timed by CUDA events, the host's
     enqueue left out: ``queued_device_ms``) must not fall below its
     model-FLOP bound (``model_flops_total / n_chips / peak``); logged
     with the share, the counted HBM bytes and the unfused plain route's
     ``t_memory``, and the peak bytes on the card; then a pod1 and a
     pod2 row, counted only;
  5. the serving kernels against their plain versions: ``serve_forward``
     and ``serve_forward_multi`` (N = 1 and 4) at the traffic (D = 41,
     2 actions) and warehouse (D = 296, 5 actions) widths, hidden 128,
     slots S in {1, 13, 16, 48, 64, 128, 256, 4096} with a random mask
     and unroutable lanes; at S = 128, N = 4 a slot where one policy has
     no lane, one where every lane routes to one policy and an all-masked
     one; hidden 66 (rows staged by plain loads) at S = 48, N = 1 and 3:
     floats within ATOL, an action may differ only where
     the plain version's top-two logits are within FLIP_EPS, pad and
     unroutable lanes exactly 0, and on the card bitwise: a real lane is
     the same whatever the pad lanes hold and wherever it sits, and a
     lane of the multi kernel is the single-policy kernel's for its own
     checkpoint. Timed (event and device ms, with the launch plan each
     took) at S = 128 and 4096 at both widths, N = 1 and 4; the main
     serving shape (traffic, S = 128) goes into the JSON line;
  6. the serving path ``policy_serve`` in-process at full width, counters
     zeroed before each run and read after: the fixed 128-lane slot (wall
     clock; traffic, then warehouse), the calibrated bimodal buckets with
     4 policies, the chaos
     plan on the virtual clock (exactly the corrupt reload rejected, the
     plan exhausted), and ``--ckpt-dir`` on a checkpoint the port's
     ``ckpt.save`` wrote in ``rl_train``'s layout (restored bitwise).
     Each kernel must launch at least once per dispatch of its run;
  7. the layer kernels (``gru_sequence``, ``rmsnorm``, ``flash_attention``)
     against their plain versions through ``repro_torch.kernels.ops``, at
     ``benchmarks/kernel_bench.py``'s shapes, ``tests/test_kernels.py``'s
     cases and the widths of the repo's configurations (the traffic AIP,
     ``qwen3_4b``), f32 and bf16, with cases for each route of the two
     redesigned kernels (flash: the tensor-core kernel for bf16 at head
     widths in steps of 16, the CUDA-core one for the rest, each of whose
     cases prints the launch plan it took, ``flash_attention.f32_plan``;
     rmsnorm: the
     16-byte vector routes and the scalar one for unaligned or off-vector
     rows; gru_sequence: weights in registers at 1, 2, 4 and 8 rows a
     tile and 4 or 8 K-parts, the "l2" route for wide layers and in
     passes, ragged and past-one-wave B, bf16; each case prints the
     launch plan it took, ``gru.gru_plan``); the TIMED cases timed beside
     the one PyTorch call that
     computes the same function (``library_ms``, a yardstick the port
     never calls); then the ``kernels.ops`` path itself at those widths,
     launch counters zeroed before and read after (the bf16 ``qwen3_4b``
     call must take the tensor-core route), its outputs held against the
     port's ``nn`` functions;
  8. LM serving (``launch/serve``, ``models/lm.py``), the launch counters
     read before and after (the LM calls the ``nn`` functions, as the
     reference's LM calls its XLA path: no kernel may launch): (a)
     ``serve --arch qwen3-4b --batch 4 --prompt-len 128 --gen 32`` at
     full width in bf16, twice in one process (the first call's lazy
     loads apart), its prefill seconds, decode tokens/s and
     ``max_memory_allocated``, the two runs' tokens equal; (b) qwen3-4b at full width in float32:
     prefill of 32 tokens and one decode step against forward over 33
     within 2e-3 (``tests/test_models.py``'s bound); (c) deepseek-moe-16b
     at full width in bf16, dropless (64 experts, top 6): B = 2, a
     32-token prompt, 8 greedy steps, the logits finite and within
     ``LM_MOE_BF16_REL`` of the largest logit of forward's over the same
     tokens, the routing flips between the two runs counted; the same in
     float32 with the depth cut to 8 layers, within 2e-3; (d) every
     arch at ``reduced()``, float32: forward, prefill and one decode step
     on the card against the port's CPU run of the same weights, every
     cache leaf within ``LM_REDUCED_TOL``;
  9. LM training (``launch/train``, ``launch/steps.py``'s train step,
     ``optim/adamw.py``'s in-place update, ``models/lm.py``'s remat), the
     launch counters read before and after (no kernel may launch): (a)
     ``train --arch qwen3-4b --steps 6 --batch 8 --seq 512
     --microbatches 2`` at full width and depth in bf16 (remat ``full``,
     the config's), every row's loss and grad_norm finite, each step's
     ``step_time_s``, tokens/s and model-FLOP share (the reference
     dry-run's 6 x (active - embed) x tokens over the bf16 peak,
     ``train_model_flops``), ``max_memory_allocated``, and the share of
     the parameters changed from their init; (b) qwen3-4b at full width
     cut to ``TRAIN_REMAT_LAYERS`` layers, one forward and backward in
     each remat mode: losses equal, gradients within
     ``TRAIN_REMAT_GRAD_SHARE`` of ``none``'s, the peak bytes of each
     (``full`` below ``none``); then ``train`` cut to
     ``TRAIN_RESUME_LAYERS`` layers: 4 steps uninterrupted against 2
     steps, a real SIGTERM, the flushed checkpoint and 2 resumed steps,
     every parameter and optimizer leaf bitwise equal; (c) ``train
     --arch deepseek-moe-16b --layers 4`` (full width: the dense first
     layer and 3 MoE layers of 64 experts, top 6, capacity 1.25), 3
     steps: losses finite, ``lb_loss`` > 0, ``drop_frac`` printed, then
     every MoE layer's router gradient non-zero; (d) every arch at
     ``reduced()``, float32: one ``make_train_step`` (2 microbatches) on
     the card against the CPU's: the gradients handed to the optimizer
     within ``TRAIN_GRAD_TOL``, the metrics within ``LM_REDUCED_TOL``,
     and the CPU's update on the card's gradients equal to the card's
     parameters and moments within ``TRAIN_REPLAY_ULPS`` ulps;
  10. LM sharding (``distributed/act_sharding.py``, the LM half of
     ``distributed/sharding.py``, ``nn/moe_ep.py``'s mesh route,
     ``launch/specs.py``, ``launch/dryrun.py``'s LM cells), the launch
     counters read before and after (no kernel may launch, in this
     process or a rank's): (a) ``launch/dryrun.py`` counts
     ``LM_DRYRUN_CELLS`` (qwen3-4b ``train_4k`` pod1, deepseek-moe-16b
     ``train_4k`` pod1, qwen3-4b ``decode_32k`` pod2, whisper-base's
     ``train_4k`` pod1 and ``decode_32k`` pod2), each in a process of
     its own on the CPU, started together at the phase's start (the
     counts run beside (b) and (c), whose step times are taken so;
     phases 8 and 9 run without them) and read at its end: each
     ``ok``, collective bytes above 0, its model-FLOP bound and argument
     bytes per device beside the global bytes over the chips printed,
     and how it was counted (``counted_by``: the layer groups, encoder
     layers and microbatches extrapolated from a few trip counts, or
     every iteration; ``trips``: the full trip counts and the points);
     (b) ``tools/torch_lm_shard_smoke.py`` at qwen3-4b's full width cut
     to 2 layers, float32, B = 8 x 512, 2 microbatches, 2 steps, on 2
     ranks (data 2, the config's ``fsdp_only``) and 4 (data 2, model 2,
     ``tp``: heads, FFN and vocab on "model") sharing the card over gloo
     (``launch/mesh.py::gloo_on_card``): each step's loss,
     metrics and gradients against the one-process step from the same
     state, the AdamW update replayed within 4 ulps, each rank's
     parameter and moment bytes the global bytes over the ranks that
     shard them, its ``max_memory_allocated``, the steady step time
     beside the one-process step's; (c) one MoE layer of
     deepseek-moe-16b at full width (64 experts, top 6, 2 shared),
     dropless, through the expert-parallel route on 4 ranks (data 2,
     model 2) against ``moe_apply``: output and gradients of
     ``out.sum()`` within the reference test's 1e-5 and 1e-4, of the
     largest value where it exceeds 1; (d) the recurrent mixers on
     "model" (``act_sharding.mixer``) at full width, float32, on 4
     ranks (data 2, model 2), one launch, B = 2 x 512: one Mamba layer
     of jamba-1.5-large-398b (d 8192, dI 16384, d_state 16; four scan
     chunks) and one mLSTM and one sLSTM layer of xlstm-1.3b (d 2048, 4
     heads, two whole heads a rank; two mLSTM chunks) against each mixer
     in one process: the output and the gradients of ``(out * w).sum()``,
     the prefill state and one decode step within the shard smoke's
     bounds, each rank's
     bytes of the layer's weights the global bytes over its shards.
The build phase also prints ptxas's register and spill lines per kernel
and the HGMMA count of the tensor-core kernel's SASS (``cuobjdump``).
Then one JSON line lists every kernel (route, source, the TPU kernel it
replaces, launches on its path, max error, times and the card's bound;
the horizon kernels once per LS functor, the warehouse's as
``name[warehouse]``;
``flash_attention`` is the tensor-core kernel, timed at the main shape,
``flash_attention[f32]`` the CUDA-core one, timed at ``qwen3_4b f32``;
``flips`` counts the decisions that flipped for the kernels that make
decisions, phases 2 and 5, and is null for the layer kernels, which make
none; ``plan`` is the launch plan of the horizon kernels, ``aip_step``,
``gru_sequence`` and the CUDA-core flash kernel, else null),
the ``nvidia-smi`` line, and last ``{"ok": true, "device": ...}``. Any
failure prints its reason on stderr and as a ``chip_smoke: FAILED`` line
on stdout, and exits 1.
"""
from __future__ import annotations

import json
import math
import statistics
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ATOL = 1e-4            # float leaves, kernel vs plain version (fp32 GEMM
#                        reduction order differs; gates round identically)
FLIP_EPS = 1e-4        # a decision this close to its threshold may flip
MAX_FLIP_SHARE = 0.01
SOURCE = "src/repro_torch/kernels/csrc/ials_kernels.cu"
LAYER_SOURCE = "src/repro_torch/kernels/csrc/layer_kernels.cu"
GRU_SOURCE = "src/repro_torch/kernels/csrc/gru_kernels.cu"
TC_SOURCE = "src/repro_torch/kernels/csrc/flash_wgmma.cu"
F32_SOURCE = "src/repro_torch/kernels/csrc/flash_f32.cu"
SERVE_SOURCE = "src/repro_torch/kernels/csrc/serve_kernels.cu"
# the layer kernels' tolerances against their plain versions, (f32, bf16):
# the reference tests' own (flash f32 2e-5, rmsnorm 1e-2), GRU f32 at
# ATOL for matmul order over T steps, rmsnorm f32 1e-5; bf16 outputs may
# also differ by one bf16 ulp of the value (BF16_RTOL), where the f32
# results straddle a rounding boundary. Flash bf16 does its math in f32
# on both sides, so beyond that ulp it differs by f32 noise only: 1e-4
# (the reference tests' 2e-2 was set at T = 128, outputs ~0.15; at the
# qwen3_4b widths outputs are ~0.03 and a dropped KV tile moves ~0.003)
LAYER_TOL = {"flash_attention": (2e-5, 1e-4), "gru_sequence": (ATOL, 3e-2),
             "rmsnorm": (1e-5, 1e-2)}
BF16_RTOL = 2.0 ** -7
REPLACES = {
    "aip_step": "src/repro/kernels/aip_step.py:150",
    "aip_rollout_multi": "src/repro/kernels/aip_step.py:476",
    "aip_rollout": "src/repro/kernels/aip_step.py:543",
    "fnn_rollout": "src/repro/kernels/aip_step.py:514",
    "policy_rollout[fnn]": "src/repro/kernels/aip_step.py:745",
    "policy_rollout[gru]": "src/repro/kernels/aip_step.py:745",
    "aip_rollout_multi[warehouse]": "src/repro/kernels/aip_step.py:476",
    "fnn_rollout[warehouse]": "src/repro/kernels/aip_step.py:514",
    "policy_rollout[fnn][warehouse]": "src/repro/kernels/aip_step.py:745",
    "policy_rollout[gru][warehouse]": "src/repro/kernels/aip_step.py:745",
    "serve_forward": "src/repro/kernels/aip_step.py:205",
    "serve_forward_multi": "src/repro/kernels/aip_step.py:291",
    "gru_sequence": "src/repro/kernels/gru.py:50",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:25",
    "flash_attention": "src/repro/kernels/flash_attention.py:69",
    "flash_attention[f32]": "src/repro/kernels/flash_attention.py:69",
}
SOURCES = {"serve_forward": SERVE_SOURCE,
           "serve_forward_multi": SERVE_SOURCE,
           "gru_sequence": GRU_SOURCE, "rmsnorm": LAYER_SOURCE,
           "flash_attention": TC_SOURCE, "flash_attention[f32]": F32_SOURCE}
PATHS = {"serve_forward": "policy_serve", "serve_forward_multi":
         "policy_serve", "policy_rollout[fnn]": "rl_train",
         "policy_rollout[gru]": "rl_train",
         "policy_rollout[fnn][warehouse]": "rl_train --domain warehouse",
         "policy_rollout[gru][warehouse]": "rl_train --domain warehouse",
         "aip_rollout": "kernels.ops.ials_rollout",
         "gru_sequence": "kernels.ops",
         "rmsnorm": "kernels.ops", "flash_attention": "kernels.ops",
         "flash_attention[f32]": "kernels.ops"}
# the serving widths: (frame width D, actions); policy hidden 128
SERVE_WIDTHS = {"traffic": (41, 2), "warehouse": (37 * 8, 5)}
SERVE_SLOTS = (1, 13, 16, 48, 64, 128, 256, 4096)
SERVE_TIMED_SLOTS = (128, 4096)
SERVE_ROUTES = ("skip", "one", "masked")   # at S = 128, N = 4
SERVE_HP = 128


def log(msg):
    print(msg, flush=True)


def phase(name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            log(f"[phase] {name}: ok in {time.perf_counter() - t0:.2f} s")
            return out
        return run
    return deco


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_cuda(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


PROFILE_ATTEMPTS = 5
PROFILE_GAP_S = 0.02   # the host's sleep between the untimed call and the
#                        timed ones: the device idles through it
PROFILE_LOSSES = []    # the launches by name of each profile that missed
#                        one


def _profile_once(fn, reps):
    """One profile of ``fn``: one untimed call (the trace's first events
    may be lost while the profiler starts), a sleep of PROFILE_GAP_S, then
    ``reps`` timed calls, the garbage collector off throughout (a
    collection would idle the device mid-loop) -> (every device event of
    the profile in the device's order, the timed calls' wall seconds)."""
    import gc
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    collecting = gc.isenabled()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        if collecting:
            gc.enable()
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start), wall


def timed_events(events, reps, gap_us=5e5 * PROFILE_GAP_S):
    """A profile's device events in the device's order -> the timed
    calls' events, or None when a launch is missing. The timed calls'
    events are those after the last idle gap of at least ``gap_us`` on
    the device's own timeline (the sleep after the untimed call): the
    host's and the device's clocks are never compared, since they
    disagree by 100-340 us and drift (``tools/profile_count.py``). Each
    event name must then come a whole number of times a call."""
    import collections
    cut, end = 0, -math.inf
    for i, e in enumerate(events):
        if e.time_range.start - end >= gap_us:
            cut = i
        end = max(end, e.time_range.end)
    timed = events[cut:]
    counts = collections.Counter(e.name for e in timed)
    if not counts or any(c % reps for c in counts.values()):
        return None
    return timed


def profile_calls(fn, reps, kernel=None):
    """Profile ``fn`` with ``torch.profiler`` (``_profile_once``), its
    device events counted against the launches made (``timed_events``;
    with ``kernel``, the names holding that string must come exactly
    ``reps`` times). A profile that misses a launch is logged, kept in
    ``PROFILE_LOSSES`` and taken again, up to PROFILE_ATTEMPTS profiles;
    then the reading fails: a lost launch is never averaged over.
    -> (the timed calls' device events, their wall seconds), or None
    when the reading failed."""
    import collections
    for _ in range(PROFILE_ATTEMPTS):
        events, wall = _profile_once(fn, reps)
        timed = timed_events(events, reps)
        if timed is not None and (kernel is None or sum(
                kernel in e.name for e in timed) == reps):
            return timed, wall
        PROFILE_LOSSES.append({n[:48]: c for n, c in collections.Counter(
            e.name for e in events).items()})
        log(f"[profile] launches by name {PROFILE_LOSSES[-1]} for 1 + "
            f"{reps} calls: one is missing; profiled again")
    log(f"[profile] {PROFILE_ATTEMPTS} profiles in turn missed a launch: "
        f"not measured")
    return None


def events_us(events):
    """Summed duration of device events (kernels, copies), in us."""
    return sum(e.time_range.elapsed_us() for e in events)


def device_ms(fn, reps=10, warmup=2, kernel=None):
    """Mean device milliseconds per call of ``fn``: the summed device time
    of every kernel and copy it launches, from ``torch.profiler``, every
    launch counted (``profile_calls``) -> a float, or "not measured" when
    no profile held every launch. Unlike CUDA events around one
    call, it leaves out the host's time to enqueue the launch, which
    dominates a kernel of ~0.1 ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    got = profile_calls(fn, reps, kernel)
    return ("not measured" if got is None
            else events_us(got[0]) * 1e-3 / reps)


def nbytes(*tensors):
    import torch
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def bound(flops, bytes_, dtype="float32"):
    """(bound_ms, bound_by): the larger of the operations and the bytes
    over the card's published rates (``op_analysis``'s constants): the
    fp32 rate of the CUDA cores for float32 inputs, the bf16 tensor-core
    rate for bfloat16 inputs (bf16 products summed in f32 are what
    ``wgmma`` computes), and the memory rate."""
    from repro_torch.distributed import op_analysis
    t_ops = flops / op_analysis.peak_flops(dtype) * 1e3
    t_mem = bytes_ / op_analysis.HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------------------
# fixtures: a domain's LS, random weights and streams made from a seed
# ---------------------------------------------------------------------------

def local_env(domain, dev, vanish_after=0):
    """The batched LS of ``domain`` ("traffic" or "warehouse") on ``dev``
    and the frame stack its policy sees (1 and 8, as ``rl_train``)."""
    if domain == "traffic":
        from repro_torch.envs.traffic import (TrafficConfig,
                                              make_batched_local_traffic_env)
        return make_batched_local_traffic_env(TrafficConfig(), dev), 1
    from repro_torch.envs.warehouse import (WarehouseConfig,
                                            make_batched_local_warehouse_env)
    return make_batched_local_warehouse_env(
        WarehouseConfig(vanish_after=vanish_after), dev), 8


class Case:
    """One kernel call's inputs at (A, B, T) on ``domain``'s LS, made on
    the card from a seed: the AIP of ``rl_train`` (hidden 64, FNN stack
    8), a policy of hidden ``pol_hidden`` (``rl_train``'s 128) over the
    domain's frame stack, the LS's own noise (the warehouse's spawns),
    and resets inside the horizon."""

    def __init__(self, kind, A, B, T, seed, dev, domain="traffic",
                 vanish_after=0, pol_hidden=128):
        import torch
        from repro_torch.core import engine, influence
        from repro_torch.envs.api import horizon_noise, stack_trees
        from repro_torch.nn.act import random_bits
        from repro_torch.rl import ppo
        from repro_torch.tree import tree_leaves
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        self.kind, self.A, self.B, self.T = kind, A, B, T
        self.domain = domain
        self.fast_gates = True     # the policy's gates (False: tanh)
        L = A * B
        self.ls_env, stack = local_env(domain, dev, vanish_after)
        spec = self.ls_env.spec
        self.acfg = influence.AIPConfig(
            kind=kind, d_in=spec.dset_dim, n_out=spec.n_influence,
            hidden=64, stack=8 if kind == "fnn" else 1)
        params = influence.init_aip_stacked(self.acfg, g, A, dev)
        # non-zero biases so every weight leaf is exercised
        params = {k: {n: (w + 0.05 * torch.randn(w.shape, generator=g,
                                                  device=dev))
                      for n, w in v.items()} for k, v in params.items()}
        self.aip_params = params
        if kind == "gru":
            self.aw = (params["gru"]["wx"], params["gru"]["wh"],
                       params["gru"]["b"], params["head"]["w"],
                       params["head"]["b"])
            self.s0 = 0.5 * torch.randn((L, 64), generator=g, device=dev)
        else:
            self.aw = (params["l1"]["w"], params["l1"]["b"],
                       params["l2"]["w"], params["l2"]["b"],
                       params["head"]["w"], params["head"]["b"])
            self.s0 = (torch.rand((L, 8 * spec.dset_dim), generator=g,
                                  device=dev) < 0.3).float()
        self.pcfg = ppo.PPOConfig(obs_dim=spec.obs_dim,
                                  n_actions=spec.n_actions,
                                  frame_stack=stack, hidden=pol_hidden)
        pol = ppo.init_policy(self.pcfg, g)
        pol = {k: {n: w + 0.05 * torch.randn(w.shape, generator=g,
                                             device=dev)
                   for n, w in v.items()} for k, v in pol.items()}
        self.pw = ppo.flat_policy_weights(pol)
        st = self.ls_env.reset(g, L)
        if domain == "traffic":
            st = type(st)(st.lanes, torch.randint(
                0, 2, (L,), generator=g, device=dev).to(torch.int8))
        self.noise = horizon_noise(self.ls_env.noise_fn, g, T, L)
        self.io = engine.kernel_io(self.ls_env, st, self.noise)
        # older frames from other states, so the frame shift carries data
        self.frames0 = torch.cat(
            [self.ls_env.obs_fn(self.ls_env.reset(g, L))
             for _ in range(stack - 1)] + [self.ls_env.obs_fn(st)], dim=-1)
        self.actions = torch.randint(0, spec.n_actions, (T, L), generator=g,
                                     device=dev, dtype=torch.int32)
        self.bits = random_bits((T, L, spec.n_influence), g)
        self.gumbel = ppo.gumbel_noise(g, (T, L, spec.n_actions))
        # resets inside the horizon: each env on its own episode phase
        t_in = torch.randint(0, 40, (B,), generator=g, device=dev)
        ticks = t_in[None] + 1 + torch.arange(T, device=dev)[:, None]
        self.done = ((ticks % 40) == 0).to(torch.int32).repeat(1, A)
        resets = [self.ls_env.reset(g, L) for _ in range(T)]
        self.reset_ls = self.io.encode(tree_leaves(stack_trees(resets)))

    # --- the kernel and its plain version on the same inputs -------------
    def rollout_call(self, plain=False, trace=None):
        from repro_torch.kernels import aip_step as cuda
        from repro_torch.kernels import ref
        args = (self.io.ls, self.s0, *self.aw, self.actions, self.bits,
                self.io.noise)
        if self.kind == "gru":
            if plain:
                return ref.ials_rollout_multi_ref(
                    *args, n_agents=self.A, tick_fn=self.io.tick_fn,
                    dset_fn=self.io.dset_fn, trace=trace)
            return cuda.aip_rollout_multi(*args, n_agents=self.A,
                                          domain=self.ls_env.kernel_domain)
        if plain:
            return ref.fnn_rollout_ref(*args, n_agents=self.A,
                                       tick_fn=self.io.tick_fn,
                                       dset_fn=self.io.dset_fn, trace=trace)
        return cuda.fnn_rollout(*args, n_agents=self.A,
                                domain=self.ls_env.kernel_domain)

    def policy_call(self, plain=False, trace=None):
        from repro_torch.kernels import aip_step as cuda
        from repro_torch.kernels import ref
        args = (self.io.ls, self.s0, self.frames0, self.aw, self.pw,
                self.gumbel, self.bits, self.done, self.io.noise,
                self.reset_ls)
        if plain:
            return ref.policy_rollout_ref(
                *args, kind=self.kind, n_agents=self.A,
                fast_gates=self.fast_gates, tick_fn=self.io.tick_fn,
                dset_fn=self.io.dset_fn, obs_fn=self.io.obs_fn, trace=trace)
        return cuda.policy_rollout(*args, kind=self.kind, n_agents=self.A,
                                   fast_gates=self.fast_gates,
                                   domain=self.ls_env.kernel_domain)

    def widths(self):
        """The ``RolloutWidths`` of this case's launches."""
        from repro_torch.kernels.aip_step import RolloutWidths, domain_layout
        a, c = self.acfg, self.pcfg
        return RolloutWidths(
            D=a.d_in, H=a.hidden, M=a.n_out, stack=a.stack,
            S=self.frames0.shape[1], obs_dim=c.obs_dim, Hp=c.hidden,
            n_act=c.n_actions,
            state_ints=domain_layout(self.ls_env.kernel_domain).state_ints)

    def flops_per_lane_tick(self, policy):
        """The products of one lane's tick: the dry-run's model FLOPs of
        one lane and one tick."""
        from repro_torch.launch.dryrun import _ials_model_flops
        if policy:
            return _ials_model_flops("policy_rollout", self.acfg, self.pcfg,
                                     1, 1, 1)
        return _ials_model_flops("aip_rollout_multi", self.acfg, None, 1, 1,
                                 1)


# ---------------------------------------------------------------------------
# the lane and flip rule
# ---------------------------------------------------------------------------

def compare_lanes(name, streams, finals, margins, T, L):
    """``streams``: [(kernel (T, L, ...), plain, exact)]; ``finals``:
    [(kernel (L, ...), plain, exact)]; ``margins``: (T, L) decision
    distances of the plain run. -> (n_flips, max float error)."""
    import torch
    bad_t = torch.full((L,), T, dtype=torch.long, device=margins.device)
    max_err = 0.0
    ticks = torch.arange(T, device=margins.device)[:, None]

    ok_lanes_err = []
    for k, p, exact in streams:
        k2 = k.reshape(T, L, -1)
        p2 = p.reshape(T, L, -1)
        if exact:
            m = (k2 != p2).any(-1)
        else:
            err = (k2.float() - p2.float()).abs()
            m = (err > ATOL).any(-1)
            ok_lanes_err.append(err.amax(-1))
        first = torch.where(m, ticks.expand(T, L), T).amin(0)
        bad_t = torch.minimum(bad_t, first)
    for k, p, exact in finals:
        k2 = k.reshape(L, -1)
        p2 = p.reshape(L, -1)
        if exact:
            m = (k2 != p2).any(-1)
        else:
            err = (k2.float() - p2.float()).abs()
            m = (err > ATOL).any(-1)
            ok_lanes_err.append(err.amax(-1)[None])
        bad_t = torch.where(m & (bad_t == T), T - 1, bad_t)
    bad = bad_t < T
    # min decision margin of the plain run up to each lane's first mismatch
    upto = ticks <= bad_t[None]
    near = torch.where(upto, margins, math.inf).amin(0) < FLIP_EPS
    flips = bad & near
    faults = bad & ~near
    good = ~bad
    for e in ok_lanes_err:
        e = e.reshape(-1, L).amax(0)
        if good.any():
            max_err = max(max_err, float(e[good].max()))
    n_flip, n_fault = int(flips.sum()), int(faults.sum())
    if n_fault:
        lane = int(torch.nonzero(faults)[0])
        raise AssertionError(
            f"{name}: {n_fault} of {L} lanes disagree with the plain version "
            f"away from any decision threshold (first: lane {lane}, tick "
            f"{int(bad_t[lane])})")
    if n_flip > MAX_FLIP_SHARE * L:
        raise AssertionError(f"{name}: decision flips in {n_flip} of {L} "
                             f"lanes (> {MAX_FLIP_SHARE:.0%})")
    return n_flip, max_err


def check_rollout(case, name):
    import torch
    k_ls, k_s, k_r = case.rollout_call()
    torch.cuda.synchronize()
    trace = {}
    p_ls, p_s, p_r = case.rollout_call(plain=True, trace=trace)
    L = case.A * case.B
    margins = torch.stack(trace["aip"])
    flips, err = compare_lanes(
        name, [(k_r, p_r, False)],
        [(k, p, True) for k, p in zip(k_ls, p_ls)] + [(k_s, p_s, False)],
        margins, case.T, L)
    return flips, err


def check_policy(case, name):
    import torch
    out_k = case.policy_call()
    torch.cuda.synchronize()
    trace = {}
    out_p = case.policy_call(plain=True, trace=trace)
    L = case.A * case.B
    margins = torch.minimum(torch.stack(trace["aip"]),
                            torch.stack(trace["policy"]))
    (kl, ks, kf, kx, ka, klg, kv, kr) = out_k
    (pl, ps, pf, px, pa, plg, pv, pr) = out_p
    return compare_lanes(
        name, [(kx, px, False), (ka, pa, True), (klg, plg, False),
               (kv, pv, False), (kr, pr, False)],
        [(k, p, True) for k, p in zip(kl, pl)]
        + [(ks, ps, False), (kf, pf, False)], margins, case.T, L)


def check_aip_step(A, B, seed, dev):
    """One GRU tick over (B, A) lanes against its plain version; the u
    lanes that differ must sit within FLIP_EPS of their threshold."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import ref
    from repro_torch.nn.act import fast_sigmoid, random_bits, \
        uniform_from_bits
    case = Case("gru", A, B, 1, seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    d = (torch.rand((B, A, 40), generator=g, device=dev) < 0.3).float()
    h = 0.5 * torch.randn((B, A, 64), generator=g, device=dev)
    bits = random_bits((B, A, 4), g)
    args = (d, h, *case.aw, bits)
    kh, kl, ku = cuda.aip_step_multi(*args)
    torch.cuda.synchronize()
    ph, pl, pu = ref.aip_step_multi_ref(*args)
    err = max(float((kh - ph).abs().max()), float((kl - pl).abs().max()))
    if err > ATOL:
        raise AssertionError(f"aip_step A={A} B={B}: max error {err}")
    diff = ku != pu
    margin = (uniform_from_bits(bits) - fast_sigmoid(pl)).abs()
    if bool((diff & (margin >= FLIP_EPS)).any()):
        raise AssertionError(f"aip_step A={A} B={B}: a draw flipped away "
                             f"from its threshold")
    flips = int(diff.any(-1).sum())
    timing = dict(ms=time_cuda(lambda: cuda.aip_step_multi(*args)),
                  plain_ms=time_cuda(lambda: ref.aip_step_multi_ref(*args)),
                  device_ms=device_ms(lambda: cuda.aip_step_multi(*args),
                                      kernel="step_kernel"))
    flops = 2 * (40 * 192 + 64 * 192 + 64 * 4) * A * B
    by = nbytes(args, kh, kl, ku)
    p = cuda.step_plan(A, B, 40, 64, 4)
    plan = (f"lanes/tile {p.lanes}, grid {p.grid}, threads {p.threads}, "
            f"K-splits {p.splits}, smem {p.smem}")
    log(f"[kernel] aip_step A={A} B={B}: lanes {A * B}, flips {flips}, "
        f"max err {err:.3g}, ms {timing['ms']:.4f} (device "
        f"{timing['device_ms']}), plain ms "
        f"{timing['plain_ms']:.4f}; plan {plan}")
    return dict(max_abs_err=err, flips=flips, flops=flops, bytes=by,
                plan=plan, **timing)


def step_matches_rollout(A, B, seed, dev, domain="traffic"):
    """``engine.step`` and a one-tick ``engine.rollout`` with the GRU AIP
    from the same state, actions, bits and LS noise, on the card: the new
    AIP state h, the LS state and the reward must be bitwise equal (the
    LS state follows u, so equal LS states mean equal draws) -> the
    launches of the two calls."""
    import torch
    from repro_torch.core import engine, influence
    from repro_torch.envs.api import horizon_noise, index_tree
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.tree import tree_leaves
    ls, _ = local_env(domain, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    acfg = influence.AIPConfig(kind="gru", d_in=ls.spec.dset_dim,
                               n_out=ls.spec.n_influence, hidden=64)
    p = (influence.init_aip(acfg, g) if A == 1
         else influence.init_aip_stacked(acfg, g, A))
    env = engine.make_unified_ials(ls, p, acfg, n_agents=A)
    acts = torch.randint(0, ls.spec.n_actions,
                         (2, B) + ((A,) if A > 1 else ()), generator=g,
                         device=dev)
    # one tick first, so that h is not the reset's zeros
    st, _ = env.rollout(env.reset(g, B), acts[:1],
                        horizon_noise(env.noise_fn, g, 1, B))
    noise = horizon_noise(env.noise_fn, g, 1, B)
    cuda.reset_launches()
    s1, _, r1, _ = env.step_det(st, acts[1], index_tree(noise, 0))
    s2, r2 = env.rollout(st, acts[1:], noise)
    torch.cuda.synchronize()
    launches = {k: cuda.LAUNCHES[k] for k in ("aip_step",
                                              "aip_rollout_multi")}
    pairs = ([("h", s1.aip_state, s2.aip_state), ("reward", r1, r2[0])]
             + [(f"LS leaf {i}", a, b) for i, (a, b) in enumerate(zip(
                 tree_leaves(s1.ls_state), tree_leaves(s2.ls_state)))])
    for what, a, b in pairs:
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"engine.step and a one-tick "
                                 f"engine.rollout differ in {what} at A={A}"
                                 f" B={B}")
    if launches != {"aip_step": 1, "aip_rollout_multi": 1}:
        raise AssertionError(f"engine.step vs engine.rollout launches "
                             f"{launches}")
    log(f"[engine] engine.step equals a one-tick engine.rollout bitwise on "
        f"{domain} at A={A} B={B} (h, LS state, reward); launches "
        f"{launches}")
    return launches


def run_case(name, kind, A, B, T, seed, dev, policy, timed,
             domain="traffic", vanish_after=0):
    case = Case(kind, A, B, T, seed, dev, domain, vanish_after)
    check = check_policy if policy else check_rollout
    if domain != "traffic":
        name += f" {domain}" + (f" vanish_after={vanish_after}"
                                if vanish_after else "")
    flips, err = check(case, f"{name} A={A} B={B} T={T}")
    rec = dict(max_abs_err=err, flips=flips,
               plan=rollout_plan_text(case, policy))
    call = case.policy_call if policy else case.rollout_call
    if timed:
        rec["ms"] = time_cuda(call)
        rec["device_ms"] = device_ms(call, reps=10, warmup=2,
                                     kernel="horizon_kernel")
        rec["plain_ms"] = time_cuda(lambda: call(plain=True), reps=3,
                                    warmup=1)
        out = call()
        inputs = ((case.io.ls, case.io.noise, case.s0, case.aw, case.bits)
                  + ((case.frames0, case.pw, case.gumbel, case.done,
                      case.reset_ls) if policy else (case.actions,)))
        rec["flops"] = case.flops_per_lane_tick(policy) * A * B * T
        rec["bytes"] = nbytes(inputs, out)
    log(f"[kernel] {name} A={A} B={B} T={T}: lanes {A * B}, flips {flips}, "
        f"max err {err:.3g}"
        + (f", ms {rec['ms']:.3f} (device {rec['device_ms']}), plain ms "
           f"{rec['plain_ms']:.3f}"
           if timed else "")
        + f"; plan {rec['plan']}")
    return rec


def rollout_plan_text(case, policy):
    """The launch plan a horizon kernel takes for ``case``, as one line."""
    from repro_torch.kernels.aip_step import rollout_plan
    p = rollout_plan(case.A, case.B, case.widths(), case.kind, policy)
    return (f"lanes/tile {p.lanes}, cluster {p.cluster}, grid {p.grid}, "
            f"threads {p.threads}, K-splits {p.splits}, smem "
            f"{p.smem_roles[0]}/{p.smem_roles[1]}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@phase("device and build")
def phase_build():
    import torch
    from repro_torch.kernels import aip_step as cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    log(f"[device] {card}")
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}; CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda.library()
    log(f"[build] nvcc + load {time.perf_counter() - t0:.2f} s -> "
        f"{cuda.BUILD_LOG['path']}")
    for name, line in ptxas_lines(cuda.BUILD_LOG["ptxas"] or ""):
        log(f"[ptxas] {name}: {line}")
    counts = hgmma_counts(cuda.BUILD_LOG["path"])
    total = sum(counts.values())
    log(f"[sass] HGMMA instructions in flash_tc_kernel: {total} over "
        f"{len(counts)} instantiations; {json.dumps(counts)}")
    if total == 0:
        raise AssertionError("the tensor-core flash kernel has no HGMMA "
                             "instruction in its SASS")
    return card


def ptxas_lines(log_text):
    """``nvcc -Xptxas -v``'s register and spill lines, each with the short
    name of the kernel it is about -> [(name, line)]."""
    import re
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = short_kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def short_kernel_name(mangled):
    """``_ZN..flash_tc_kernelILi2ELi2ELi128ELi128ELi128EEEv..`` ->
    ``flash_tc_kernel<2,2,128,128,128>``; other names their identifier."""
    import re
    m = re.search(r"\d([a-z][a-z_]*_kernel)(I.*?E)?(?:EEv|Ev|v)", mangled)
    if not m:
        return mangled[:60]
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    types = re.findall(r"I(f|13__nv_bfloat16)", m.group(2) or "")
    tag = ["bf16" if t.startswith("13") else "f32" for t in types[:1]]
    return m.group(1) + (f"<{','.join(tag + args)}>" if tag or args else "")


def hgmma_counts(lib_path):
    """HGMMA instructions in the SASS of each instantiation of the
    tensor-core flash kernel (``cuobjdump -sass`` on the built library)
    -> {short name: count}."""
    import os
    import re
    import shutil
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = (short_kernel_name(m.group(1))
                  if "flash_tc_kernel" in m.group(1) else None)
        elif fn and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


@phase("kernels against their plain versions")
def phase_kernels(dev):
    recs = {}
    # the main path's shapes (timed for the kernels line) ...
    recs["aip_step"] = check_aip_step(25, 16, 11, dev)
    recs["aip_rollout_multi"] = run_case("aip_rollout_multi", "gru", 25, 16,
                                         128, 12, dev, False, True)
    recs["fnn_rollout"] = run_case("fnn_rollout", "fnn", 1, 16, 128, 13,
                                   dev, False, True)
    recs["policy_rollout[fnn]"] = run_case("policy_rollout[fnn]", "fnn", 1,
                                           16, 128, 14, dev, True, True)
    recs["policy_rollout[gru]"] = run_case("policy_rollout[gru]", "gru", 25,
                                           16, 128, 15, dev, True, True)
    # the single-agent horizon (ops.ials_rollout, row 2's kernel at A = 1)
    recs["aip_rollout"] = run_ials_rollout_case(16, 16, dev)
    run_ials_rollout_case(512, 17, dev)
    # ... and larger ones, with resets inside the horizon (timed, printed)
    check_aip_step(1, 512, 21, dev)
    check_aip_step(25, 512, 22, dev)
    for i, (A, B) in enumerate(((1, 512), (25, 64))):
        run_case("aip_rollout_multi", "gru", A, B, 128, 30 + i, dev, False,
                 True)
        run_case("fnn_rollout", "fnn", A, B, 128, 40 + i, dev, False, True)
        run_case("policy_rollout[fnn]", "fnn", A, B, 128, 50 + i, dev, True,
                 True)
        run_case("policy_rollout[gru]", "gru", A, B, 128, 60 + i, dev, True,
                 True)
    # the warehouse functor: the main path's A = 36 (the JSON line's rows)
    # and one agent, spawn noise on, resets inside, one vanish_after case
    W = "warehouse"
    for i, (A, B) in enumerate(((36, 16), (1, 16))):
        for name, kind, policy in (
                ("aip_rollout_multi", "gru", False),
                ("fnn_rollout", "fnn", False),
                ("policy_rollout[gru]", "gru", True),
                ("policy_rollout[fnn]", "fnn", True)):
            rec = run_case(name, kind, A, B, 128, 110 + 10 * i + len(name),
                           dev, policy, True, W)
            if A == 36:
                recs[f"{name}[{W}]"] = rec
    run_case("policy_rollout[gru]", "gru", 36, 16, 128, 140, dev, True, False,
             W, vanish_after=8)
    run_case("aip_rollout_multi", "gru", 1, 16, 128, 141, dev, False, False,
             W, vanish_after=8)
    return recs


def _train(argv, label):
    import torch
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.launch import rl_train
    args = rl_train.parse_args(argv)
    cuda.reset_launches()
    out = rl_train.run_training(args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    hist = out["history"]
    launches["history"] = [(r["loss"], r.get("gs_eval_reward"))
                           for r in hist] + [out["final_params_md5"]]
    for row in hist:
        if not math.isfinite(row["loss"]):
            raise AssertionError(f"non-finite loss: {row}")
    evals = [r["gs_eval_reward"] for r in hist if "gs_eval_reward" in r]
    if not evals or not all(0.0 <= e <= 1.0 for e in evals):
        raise AssertionError(f"GS evaluation missing or out of [0, 1]: "
                             f"{evals}")
    steps = args.n_envs * args.rollout_len * args.n_agents
    for row in hist:
        log(f"[train] {label} iter {row['iter']}: {row['iter_s']:.3f} s, "
            f"{steps / row['iter_s']:.0f} samples/s, loss {row['loss']:.4f}, "
            f"train reward {row['train_reward']:.4f}"
            + (f", GS eval {row['gs_eval_reward']:.4f}"
               if "gs_eval_reward" in row else "")
            + (f", checkpoint saved in {row['ckpt_save_s'] * 1e3:.2f} ms"
               if "ckpt_save_s" in row else ""))
    return launches, len(hist), out


# the full widths of phases 3 and 3b (a resume in 3b must repeat a run of
# phase 3 bitwise, so both build their commands from these)
MAIN_ARGS = ["--n-envs", "16", "--rollout-len", "128", "--episode-len",
             "128", "--eval-every", "1", "--collect-episodes", "64",
             "--aip-epochs", "2", "--device", "cuda", "--seed", "0"]


@phase("main path: rl_train --simulator ials, traffic and warehouse")
def phase_main_path():
    common = ["--simulator", "ials"] + MAIN_ARGS
    traffic = common + ["--domain", "traffic"]
    fnn, n_fnn, fnn_out = _train(
        traffic + ["--iterations", "3", "--aip", "fnn"], "traffic fnn A=1")
    again, _, _ = _train(traffic + ["--iterations", "3", "--aip", "fnn"],
                         "traffic fnn A=1 (repeat)")
    hist = fnn.pop("history")
    if hist != again.pop("history") or again != fnn:
        raise AssertionError("the FNN main path does not repeat itself "
                             "bitwise with the same seed")
    log(f"[train] the FNN main path repeated itself bitwise: (loss, GS "
        f"eval) per iteration and final params md5 {hist!r}, launch counts "
        f"equal")
    gru, n_gru, gru_out = _train(traffic + ["--iterations", "2",
                                            "--n-agents", "25", "--aip",
                                            "gru"], "traffic gru A=25")
    # the warehouse: its main path (GRU AIP, all 36 robots trained), and
    # the FNN AIP on one robot with the finite-memory items (§5.4)
    wh = common + ["--domain", "warehouse", "--iterations", "2"]
    w_gru, n_w_gru, w_gru_out = _train(wh + ["--n-agents", "36"],
                                       "warehouse gru A=36")
    w_fnn, n_w_fnn, _ = _train(wh + ["--aip", "fnn", "--vanish-after", "8"],
                               "warehouse fnn A=1 vanish_after=8")
    if fnn["policy_rollout_fnn"] != n_fnn:
        raise AssertionError(f"policy_rollout[fnn] launched "
                             f"{fnn['policy_rollout_fnn']} times in "
                             f"{n_fnn} iterations")
    if gru["policy_rollout_gru"] != n_gru:
        raise AssertionError(f"policy_rollout[gru] launched "
                             f"{gru['policy_rollout_gru']} times in "
                             f"{n_gru} iterations")
    for counts, key, n in ((w_gru, "policy_rollout_gru[warehouse]",
                            n_w_gru),
                           (w_fnn, "policy_rollout_fnn[warehouse]",
                            n_w_fnn)):
        if counts[key] != n:
            raise AssertionError(f"{key} launched {counts[key]} times in {n}"
                                 f" iterations")
    for counts in (gru, w_gru, w_fnn):
        counts.pop("history")
    log(f"[counts] main path traffic FNN A=1: {nonzero(fnn)}; traffic GRU "
        f"A=25: {nonzero(gru)}; warehouse GRU A=36: {nonzero(w_gru)}; "
        f"warehouse FNN A=1: {nonzero(w_fnn)}")
    # what phase 3b holds its resumes and untrained IALS against
    ref = {"fnn": fnn_out, "gru": gru_out, "warehouse gru": w_gru_out}
    return {"policy_rollout[fnn]": fnn["policy_rollout_fnn"],
            "policy_rollout[gru]": gru["policy_rollout_gru"],
            "policy_rollout[gru][warehouse]":
                w_gru["policy_rollout_gru[warehouse]"],
            "policy_rollout[fnn][warehouse]":
                w_fnn["policy_rollout_fnn[warehouse]"]}, ref


def nonzero(counts):
    """The launch counters that moved."""
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# the paper's simulator grid, resume and the fleet (phase 3b)
# ---------------------------------------------------------------------------

def _no_kernel(counts, label):
    moved = nonzero({k: v for k, v in counts.items() if k != "history"})
    if moved:
        raise AssertionError(f"{label}: the F-IALS runs PPO's plain loop, "
                             f"but kernels launched: {moved}")


def _steady_s(out):
    """Mean wall time of the iterations after the first."""
    its = [r["iter_s"] for r in out["history"] if "iter_s" in r][1:]
    return sum(its) / len(its) if its else float("nan")


def _resume(argv, k, n, ref, label, counter, tmp, keep=None):
    """``argv`` run for k iterations with ``--ckpt-dir``, then to n from
    the checkpoint: the resumed run must end on ``ref``'s parameters
    (phase 3's uninterrupted n-iteration run) bitwise, and act through
    ``counter`` once an iteration in each part. ``keep``: a directory to
    copy the k-iteration checkpoint to (phase 3c resumes it)."""
    import shutil
    ck = ["--ckpt-dir", tmp, "--save-every", "1"]
    first, n1, out1 = _train(argv + ["--iterations", str(k)] + ck,
                             f"{label}, {k} iteration(s) checkpointed")
    if keep is not None:
        shutil.copytree(tmp, keep)
    res, n2, out2 = _train(argv + ["--iterations", str(n)] + ck,
                           f"{label}, resumed to {n}")
    if (first[counter], res[counter]) != (n1, n2):
        raise AssertionError(f"{label}: {counter} launched {first[counter]}"
                             f" and {res[counter]} times in {n1} and {n2} "
                             f"iterations")
    if out2["resumed_from"] != k:
        raise AssertionError(f"{label}: resumed from {out2['resumed_from']}"
                             f", not {k}")
    want = ref["final_params_md5"]
    if out2["final_params_md5"] != want:
        raise AssertionError(f"{label}: the resumed run's params "
                             f"{out2['final_params_md5']} differ from the "
                             f"uninterrupted run's {want}")
    save = [r["ckpt_save_s"] for r in out1["history"] + out2["history"]]
    log(f"[resume] {label}: resumed from {k}, final params md5 {want} "
        f"bitwise equal to phase 3's {n}-iteration run; checkpoint save "
        f"{', '.join(f'{x * 1e3:.2f}' for x in save)} ms, restore "
        f"{out2['diag']['restore_s'] * 1e3:.2f} ms (templates, read, "
        f"copy to the card)")


def _fleet(argv, label):
    import torch
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.launch import rl_train
    args = rl_train.parse_args(argv)
    cuda.reset_launches()
    out = rl_train.run_training(args)
    torch.cuda.synchronize()
    counts = dict(cuda.LAUNCHES)
    st = out["fleet"]
    if counts["policy_rollout_fnn"] != st["produced"]:
        raise AssertionError(f"{label}: policy_rollout[fnn] launched "
                             f"{counts['policy_rollout_fnn']} times for "
                             f"{st['produced']} produced batches")
    losses = [r["loss"] for r in out["history"] if "loss" in r]
    if len(losses) != st["updates"] or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses} for "
                             f"{st['updates']} updates")
    evals = [r["gs_eval_reward"] for r in out["history"]
             if "gs_eval_reward" in r]
    if not evals or not all(0.0 <= e <= 1.0 for e in evals):
        raise AssertionError(f"{label}: GS evaluation {evals}")
    sps = st["updates"] * args.n_envs * args.rollout_len / st["wallclock_s"]
    log(f"[fleet] {label}: {st}, {sps:.0f} samples/s applied, launches "
        f"{nonzero(counts)}, final params md5 {out['final_params_md5']}")
    return out, sps


def xent_findings(trained, empirical):
    """The AIP cross-entropies in the diagnostics of the paper's
    simulators (Fig. 3 bottom, App. E), traffic FNN A = 1 on phase 3's
    seed: ``trained`` (phase 3's fit, its final loss) and ``empirical``
    (the F-IALS's empirical marginal) come from the runs; the untrained
    AIP and the fixed marginals from ``rl_train``'s own simulator build on
    the same collection stream. A finding, gating nothing but
    finiteness: the JAX package records Eq. 9's ordering as not holding
    on traffic, and nothing here expects it to."""
    from repro_torch.launch import rl_train

    def diag_xent(argv):
        args = rl_train.parse_args(MAIN_ARGS + ["--domain", "traffic",
                                                "--aip", "fnn"] + argv)
        dev, _, sb, _ = rl_train.setup(args)
        return sb.train(rl_train.sim_stream(args, dev))[1]["aip_xent"]

    f_ials = ["--simulator", "f-ials", "--fixed-marginal"]
    xe = {"trained": trained,
          "untrained": diag_xent(["--simulator", "untrained-ials"]),
          "empirical marginal": empirical,
          "fixed 0.1": diag_xent(f_ials + ["0.1"]),
          "fixed 0.5": diag_xent(f_ials + ["0.5"])}
    if not all(math.isfinite(v) for v in xe.values()):
        raise AssertionError(f"non-finite cross-entropy: {xe}")
    log("[xent] traffic, FNN AIP, A = 1, the diagnostics' aip_xent (a "
        "finding; nothing gated on the order; the untrained AIP's on 8 "
        "GS episodes, the rest on 64, x 128 ticks): "
        + ", ".join(f"{k} {v:.4f}" for k, v in xe.items()))
    return xe


def _fault_smoke(device):
    """``tools/torch_fault_smoke.py --device <device>`` in its own process
    group, killed whole if it overruns."""
    import os
    import signal
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "torch_fault_smoke.py"),
         "--device", device], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=420)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("tools/torch_fault_smoke.py overran 420 s")
    if proc.returncode != 0:
        raise AssertionError(f"tools/torch_fault_smoke.py exited "
                             f"{proc.returncode}:\n{text[-4000:]}")
    summary = json.loads(text.strip().splitlines()[-1])
    log(f"[fault-smoke] {summary}")


@phase("the paper's simulator grid, resume and the fleet")
def phase_grid(dev, ref, keep):
    import tempfile
    traffic = MAIN_ARGS + ["--domain", "traffic"]
    wh = MAIN_ARGS + ["--domain", "warehouse"]

    # 1. the untrained IALS: the IALS's kernel on an AIP at its init
    un, n_un, un_out = _train(
        traffic + ["--simulator", "untrained-ials", "--iterations", "2",
                   "--n-agents", "25", "--aip", "gru"],
        "untrained-ials traffic gru A=25")
    if un["policy_rollout_gru"] != n_un:
        raise AssertionError(f"untrained-ials: policy_rollout[gru] "
                             f"launched {un['policy_rollout_gru']} times in "
                             f"{n_un} iterations")
    log(f"[grid] untrained-ials traffic GRU A=25: steady iteration "
        f"{_steady_s(un_out):.4f} s against the IALS's "
        f"{_steady_s(ref['gru']):.4f} s (phase 3), AIP XE "
        f"{un_out['diag']['aip_xent']:.4f} (trained "
        f"{ref['gru']['diag']['aip_xent']:.4f})")

    # 2-3. the F-IALS: PPO's plain loop, no kernel
    f_tr, _, f_tr_out = _train(
        traffic + ["--simulator", "f-ials", "--iterations", "2", "--aip",
                   "fnn"], "f-ials traffic fnn A=1 (empirical marginal)")
    _no_kernel(f_tr, "f-ials traffic")
    ref["f-ials"] = f_tr_out        # phase 3c runs it again on 2 ranks
    f_wh, _, f_wh_out = _train(
        wh + ["--simulator", "f-ials", "--iterations", "2", "--n-agents",
              "36", "--fixed-marginal", "0.1", "--stateless-f-ials"],
        "f-ials warehouse gru A=36 (fixed 0.1, stateless)")
    _no_kernel(f_wh, "f-ials warehouse")
    log(f"[grid] f-ials steady iteration: traffic FNN A=1 "
        f"{_steady_s(f_tr_out):.4f} s (the IALS {_steady_s(ref['fnn']):.4f}"
        f" s), warehouse GRU A=36 {_steady_s(f_wh_out):.4f} s (the IALS "
        f"{_steady_s(ref['warehouse gru']):.4f} s); marginal XE "
        f"{f_tr_out['diag']['aip_xent']:.4f} and "
        f"{f_wh_out['diag']['aip_xent']:.4f}")
    xent_findings(ref["fnn"]["diag"]["aip_xent"],
                  f_tr_out["diag"]["aip_xent"])

    # 4. resume, bitwise against phase 3's uninterrupted runs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        _resume(traffic + ["--simulator", "ials", "--aip", "fnn"], 1, 3,
                ref["fnn"], "traffic fnn A=1", "policy_rollout_fnn",
                str(Path(tmp) / "traffic"), keep=keep)
        _resume(wh + ["--simulator", "ials", "--n-agents", "36"], 1, 2,
                ref["warehouse gru"], "warehouse gru A=36",
                "policy_rollout_gru[warehouse]", str(Path(tmp) / "wh"))

    # 5. the signal path: a real SIGTERM to a real process
    _fault_smoke(dev.type)

    # 6. the actor/learner fleet
    fleet = traffic + ["--simulator", "ials", "--aip", "fnn", "--n-workers",
                       "2", "--iterations", "4", "--eval-every", "2"]
    det, sps = _fleet(fleet, "fleet deterministic")
    again, _ = _fleet(fleet, "fleet deterministic (repeat)")
    if again["final_params_md5"] != det["final_params_md5"]:
        raise AssertionError("the deterministic fleet does not repeat "
                             "itself bitwise")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        ck = ["--ckpt-dir", tmp, "--save-every", "1"]
        _fleet(fleet + ["--iterations", "2"] + ck,
               "fleet, 2 updates checkpointed")
        res, _ = _fleet(fleet + ck, "fleet, resumed to 4")
    if res["diag"].get("resumed_from") != 2 or \
            res["final_params_md5"] != det["final_params_md5"]:
        raise AssertionError(f"the resumed fleet ({res['diag']}, "
                             f"{res['final_params_md5']}) is not the "
                             f"uninterrupted one ({det['final_params_md5']})")
    # worker w produces at the scheduler ticks t with t % 2 == w
    faulted, _ = _fleet(fleet + ["--kill-worker", "1:3", "--delay-batch",
                                 "0:0:3", "--max-staleness", "1"],
                        "fleet faulted")
    st = faulted["fleet"]
    if st["kills"] != 1 or st["dropped"] < 1 or not st["faults_exhausted"]:
        raise AssertionError(f"the faulted fleet counted {st}")
    _, sps_async = _fleet(fleet + ["--async-fleet"], "fleet async")
    # phase 3's integrated rate carries the process's first iteration,
    # the fleet's not: tools/iteration_profile.py --only fleet times both
    # alike
    log(f"[fleet] samples/s over 4 updates, evaluations excluded: "
        f"deterministic {sps:.0f}, async {sps_async:.0f}")


# ---------------------------------------------------------------------------
# lane data parallelism under torch.distributed (phase 3c)
# ---------------------------------------------------------------------------

RANKS_TIMEOUT_S = 240


def _ranks(world, argv, label, timeout=None):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    world <argv>`` in its own process group, killed whole if it overruns
    (``timeout``, default ``RANKS_TIMEOUT_S``) -> its output; a non-zero
    exit fails the phase."""
    timeout = timeout or RANKS_TIMEOUT_S
    import os
    import signal
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{label}: {world} ranks overran {timeout} s")
    if proc.returncode != 0:
        errors = [ln for ln in text.splitlines() if "Error" in ln][:20]
        raise AssertionError(f"{label}: {world} ranks exited "
                             f"{proc.returncode}:\n" + "\n".join(errors)
                             + f"\n{text[-6000:]}")
    log(f"[ranks] {label}: {world} ranks in "
        f"{time.perf_counter() - t0:.1f} s (processes started included)")
    return text


def _shard_smoke(world, model, extra, label, tmp):
    out = Path(tmp) / f"shard_{label}.json"
    _ranks(world, ["tools/torch_shard_smoke.py", "--device", "cuda",
                   "--backend", "gloo", "--model", str(model),
                   "--time-reps", "5", "--json", str(out), *extra],
           f"shard smoke {label}")
    summary = json.loads(out.read_text())
    if not summary["ok"]:
        raise AssertionError(f"shard smoke {label}: {summary}")
    for case, r in summary["cases"].items():
        tim = r.get("timing_per_rank") or []
        times = "" if not tim else (
            "; policy_rollout device ms per rank on its block, one rank at "
            "a time: " + ", ".join(str(t["block_device_ms"]) for t in tim)
            + f"; one process {tim[0]['one_process_device_ms']}; gathers "
            "of one sharded rollout, event ms per rank (host included): "
            + ", ".join(f"{t['gather_event_ms']:.3f}" for t in tim))
        log(f"[shard] {label} {case}: {r['leaves']} leaves bitwise equal "
            f"to the one-process program (rollout "
            f"{r['parts']['rollout']['leaves']}, engine "
            f"{r['parts']['engine']['leaves']}, train "
            f"{r['parts']['train']['leaves']}); launches per rank "
            f"{r['launches_per_rank'][0]}{times}")
    return summary


def _rl_ranks(world, argv, label, tmp):
    """``rl_train`` on ``world`` gloo ranks -> its ``--out`` summary."""
    out = Path(tmp) / f"rl_{label.replace(' ', '_')}.json"
    _ranks(world, ["-m", "repro_torch.launch.rl_train", *argv,
                   "--dist-backend", "gloo", "--out", str(out)],
           f"rl_train {label}")
    return json.loads(out.read_text())


def _train_ranks(world, argv, ref, label, tmp, bitwise=True,
                 counter=None, got=None):
    """``rl_train`` on ``world`` gloo ranks (or its summary ``got``): its
    final params, losses and GS evaluations must equal ``ref``'s (the
    one-process run) bitwise; with ``bitwise`` False (PPO's plain loop,
    whose GEMMs may take other algorithms at other row counts) they are
    compared and reported. Each rank must launch ``counter`` once an
    iteration it ran (None: no kernel at all)."""
    if got is None:
        got = _rl_ranks(world, argv, label, tmp)

    def hist(o):
        return [(r["loss"], r.get("gs_eval_reward")) for r in o["history"]
                if "loss" in r]
    skip = got["resumed_from"]
    same = (got["final_params_md5"] == ref["final_params_md5"]
            and hist(got) == hist(ref)[skip:])
    if got["world_size"] != world or (bitwise and not same):
        raise AssertionError(
            f"rl_train {label} on {world} ranks: md5 "
            f"{got['final_params_md5']}, (loss, GS eval) {hist(got)}; the "
            f"one-process run: {ref['final_params_md5']}, "
            f"{hist(ref)[skip:]}")
    if not all(math.isfinite(x) for x, _ in hist(got)):
        raise AssertionError(f"rl_train {label}: non-finite loss")
    want = {} if counter is None else {counter: len(hist(got))}
    for r, counts in enumerate(got["launches_per_rank"]):
        if {k: v for k, v in counts.items() if k == counter or
                counter is None} != want:
            raise AssertionError(f"rl_train {label}: rank {r} launched "
                                 f"{counts}, expected {want}")
    log(f"[ranks] rl_train {label} on {world} ranks: final params md5 "
        f"{got['final_params_md5']}, losses and GS evaluations "
        + ("bitwise equal to" if same else
           f"NOT bitwise equal to (a finding; md5 "
           f"{ref['final_params_md5']}, (loss, GS eval) "
           f"{hist(ref)[skip:]} against {hist(got)})")
        + f" the one-process run; steady iteration "
        f"{_steady_s(got):.4f} s (one process {_steady_s(ref):.4f} s); "
        f"launches per rank {got['launches_per_rank']}")
    return got


@phase("lane data parallelism: ranks of torch.distributed.run on gloo")
def phase_ranks(ref, keep):
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        # (a) the sharded programs against the one-process one: each
        # domain and backbone once a world size (the four cases once on
        # each were cut for the script's time)
        _shard_smoke(2, 1, ["--cases", "traffic:fnn:1,warehouse:gru:36"],
                     "2 ranks (data 2)", tmp)
        # + 64 lanes of traffic GRU A = 25, 16 a rank: a rank's own plan
        # would take other K-parts than the one-process launch's
        _shard_smoke(4, 2, ["--cases", "traffic:gru:25,warehouse:fnn:36,"
                            "traffic:gru:25:64"],
                     "4 ranks (data 2, model 2)", tmp)
        # (b) rl_train under ranks, (c) a one-process checkpoint resumed:
        # the 2-rank traffic run is the resumed one (its own run from
        # iteration 0 was cut for the script's time); PPO's plain loop on
        # the ranks' lanes: runs, bitwise reported. The four runs of
        # ranks and the GS's one-process run side by side (their
        # iteration times are then taken beside each other)
        from concurrent.futures import ThreadPoolExecutor
        traffic = MAIN_ARGS + ["--domain", "traffic", "--simulator", "ials",
                               "--aip", "fnn", "--iterations", "3"]
        pol_fnn = "policy_rollout_fnn"
        gs = MAIN_ARGS + ["--domain", "traffic", "--simulator", "gs",
                          "--iterations", "2"]
        with ThreadPoolExecutor(4) as pool:
            w4 = pool.submit(_train_ranks, 4, MAIN_ARGS + [
                "--domain", "warehouse", "--simulator", "ials",
                "--n-agents", "36", "--iterations", "2"],
                ref["warehouse gru"], "warehouse gru A=36", tmp,
                counter="policy_rollout_gru[warehouse]")
            res = pool.submit(_train_ranks, 2, traffic + [
                "--ckpt-dir", keep, "--save-every", "2"], ref["fnn"],
                "traffic fnn A=1 resumed from 1", tmp, counter=pol_fnn)
            f_ials = pool.submit(_train_ranks, 2, MAIN_ARGS + [
                "--domain", "traffic", "--simulator", "f-ials",
                "--iterations", "2", "--aip", "fnn"], ref["f-ials"],
                "f-ials traffic fnn A=1", tmp, bitwise=False)
            gs_ranks = pool.submit(_rl_ranks, 2, gs, "gs traffic A=1", tmp)
            _, _, gs_one = _train(gs, "gs traffic A=1 (one process, beside "
                                  "the runs of ranks)")
            w4, res = w4.result(), res.result()
            f_ials.result()
            _train_ranks(2, gs, gs_one, "gs traffic A=1", tmp,
                         bitwise=False, got=gs_ranks.result())
        saves = [r.get("ckpt_save_s") for r in res["history"]]
        if res["resumed_from"] != 1 or [s is not None for s in saves] != [
                True, False]:
            raise AssertionError(f"the 2-rank run resumed from "
                                 f"{res['resumed_from']}, not 1, or saved "
                                 f"off --save-every 2: {saves}")
        log(f"[ranks] resumed at --save-every 2: iteration 1 saved in "
            f"{saves[0] * 1e3:.2f} ms (the global rollout state's gather "
            f"and rank 0's write), iteration 2 saved nothing")
    # (d) the steady iteration time at 1, 2 and 4 ranks
    log(f"[ranks] steady iteration, traffic FNN A=1 (16 envs): 1 rank "
        f"{_steady_s(ref['fnn']):.4f} s, 2 ranks {_steady_s(res):.4f} s "
        f"(resumed); "
        f"warehouse GRU A=36: 1 rank "
        f"{_steady_s(ref['warehouse gru']):.4f} s, 4 ranks "
        f"{_steady_s(w4):.4f} s (ranks share the card on gloo; the runs of "
        f"ranks side by side)")


@phase("engine entry points: engine.rollout, engine.step")
def phase_engine(dev):
    import torch
    from repro_torch.core import engine, influence
    from repro_torch.envs.api import horizon_noise
    from repro_torch.kernels import aip_step as cuda
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B, T = 16, 128
    cuda.reset_launches()
    # rewards: traffic's moved share, the warehouse's pickups (at most one
    # item cell under a robot) both lie in [0, 1]
    for domain, kind, A in (("traffic", "fnn", 1), ("traffic", "gru", 25),
                            ("warehouse", "fnn", 36),
                            ("warehouse", "gru", 36)):
        ls, _ = local_env(domain, dev)
        acfg = influence.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                                   n_out=ls.spec.n_influence, hidden=64,
                                   stack=8 if kind == "fnn" else 1)
        p = (influence.init_aip(acfg, g) if A == 1
             else influence.init_aip_stacked(acfg, g, A))
        env = engine.make_unified_ials(ls, p, acfg, n_agents=A)
        st = env.reset(g, B)
        acts = torch.randint(0, ls.spec.n_actions,
                             (T, B) + ((A,) if A > 1 else ()), generator=g,
                             device=dev)
        st2, rew = env.rollout(st, acts, horizon_noise(env.noise_fn, g, T,
                                                         B))
        if not bool(torch.isfinite(rew).all()) or \
                not (0 <= float(rew.min()) <= float(rew.max()) <= 1):
            raise AssertionError(f"engine.rollout {domain} {kind}: bad "
                                 f"rewards")
        if kind == "gru":
            _, obs, r, _ = env.step(st2, acts[0], g)
            if tuple(obs.shape) != (B, A, ls.spec.obs_dim):
                raise AssertionError(f"engine.step {domain} obs "
                                     f"{tuple(obs.shape)}")
    torch.cuda.synchronize()
    counts = dict(cuda.LAUNCHES)
    want = ("fnn_rollout[traffic]", "aip_rollout_multi[traffic]",
            "aip_step", "fnn_rollout[warehouse]",
            "aip_rollout_multi[warehouse]")
    for k in want:
        if counts[k] < 1:
            raise AssertionError(f"{k} did not launch on its path: {counts}")
    log(f"[counts] engine entry points: {nonzero(counts)}")
    step_matches_rollout(25, 16, 8, dev)
    step_matches_rollout(1, 512, 9, dev)
    step_matches_rollout(25, 512, 10, dev)
    step_matches_rollout(36, 16, 11, dev, "warehouse")
    step_matches_rollout(1, 16, 12, dev, "warehouse")
    return {"fnn_rollout": counts["fnn_rollout[traffic]"],
            "aip_rollout_multi": counts["aip_rollout_multi[traffic]"],
            "aip_step": counts["aip_step"],
            "fnn_rollout[warehouse]": counts["fnn_rollout[warehouse]"],
            "aip_rollout_multi[warehouse]":
                counts["aip_rollout_multi[warehouse]"]}


# ---------------------------------------------------------------------------
# the scalar protocol and the loop baseline (phase 4b)
# ---------------------------------------------------------------------------

# phase 4b's widths: the loop baseline at benchmarks/multi_agent_throughput
# .py's full size, every region an agent
LOOP_ENVS, LOOP_T = 16, 128
# loop-ials steps a Python loop tick by tick (nothing is amortized over
# the horizon, so its rate a tick does not depend on the ticks): timed
# over 32 of them, for the script's time
LOOP_IALS_T = 32
LOOP_DOMAINS = {"traffic": ("fnn", 8, 25), "warehouse": ("gru", 1, 36)}
MIN_LOOP_SPEEDUP = 5.0     # the reference's bar for batched_over_loop


def ials_rollout_call(case, plain=False, trace=None):
    """``ops.ials_rollout`` (the ``aip_rollout`` kernel) on ``case``'s
    inputs with its one AIP's unstacked weights, or its plain version
    ``ref.ials_rollout_ref`` on the card."""
    from repro_torch.kernels import ops, ref
    args = (case.io.ls, case.s0, *(w[0] for w in case.aw), case.actions,
            case.bits, case.io.noise)
    if plain:
        return ref.ials_rollout_ref(*args, tick_fn=case.io.tick_fn,
                                    dset_fn=case.io.dset_fn, trace=trace)
    return ops.ials_rollout(*args, tick_fn=case.io.tick_fn,
                            dset_fn=case.io.dset_fn,
                            domain=case.ls_env.kernel_domain)


def check_ials_rollout(case, name, out=None):
    """``out`` (a kernel call's result; made here when None) against the
    plain version, by the lane and flip rule -> (flips, max error)."""
    import torch
    k_ls, k_h, k_r = ials_rollout_call(case) if out is None else out
    torch.cuda.synchronize()
    trace = {}
    p_ls, p_h, p_r = ials_rollout_call(case, plain=True, trace=trace)
    return compare_lanes(
        name, [(k_r, p_r, False)],
        [(k, p, True) for k, p in zip(k_ls, p_ls)] + [(k_h, p_h, False)],
        torch.stack(trace["aip"]), case.T, case.B)


def run_ials_rollout_case(B, seed, dev):
    """``ops.ials_rollout`` at traffic, GRU hidden 64, A = 1, B lanes,
    T = 128 against its plain version, and timed -> its record."""
    case = Case("gru", 1, B, 128, seed, dev)
    name = f"aip_rollout A=1 B={B} T=128"
    flips, err = check_ials_rollout(case, name)

    def call(plain=False):
        return ials_rollout_call(case, plain)
    rec = dict(max_abs_err=err, flips=flips,
               plan=rollout_plan_text(case, False), ms=time_cuda(call),
               device_ms=device_ms(call, kernel="horizon_kernel"),
               plain_ms=time_cuda(lambda: call(True), reps=3, warmup=1),
               flops=case.flops_per_lane_tick(False) * B * 128,
               bytes=nbytes((case.io.ls, case.io.noise, case.s0,
                             [w[0] for w in case.aw], case.bits,
                             case.actions), call()))
    log(f"[kernel] {name}: lanes {B}, flips {flips}, max err {err:.3g}, ms "
        f"{rec['ms']:.3f} (device {rec['device_ms']}), plain ms "
        f"{rec['plain_ms']:.3f}; plan {rec['plan']}")
    return rec


def _ials_rollout_path(dev):
    """(a): the path ``ops.ials_rollout`` at traffic, GRU hidden 64,
    B = 16 and 512, T = 128, counters zeroed before each call and read
    after it (one ``aip_rollout`` launch, nothing else), each result held
    against the plain version -> launches on the path."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    total = 0
    for B, seed in ((16, 150), (512, 151)):
        case = Case("gru", 1, B, 128, seed, dev)
        cuda.reset_launches()
        out = ials_rollout_call(case)
        torch.cuda.synchronize()
        counts = nonzero(cuda.LAUNCHES)
        if counts != {"aip_rollout": 1, "aip_rollout[traffic]": 1}:
            raise AssertionError(f"ops.ials_rollout B={B}: launches "
                                 f"{counts}, not one aip_rollout")
        total += counts["aip_rollout"]
        flips, err = check_ials_rollout(case, f"ops.ials_rollout B={B}",
                                        out)
        log(f"[scalar] ops.ials_rollout A=1 B={B} T=128: launches "
            f"{counts}, flips {flips}, max err {err:.3g}")
    return total


def _adapters(dev, ticks=32, B=16):
    """(b): ``batch_local_env`` / ``batch_env`` over the scalar envs
    against the native batched ones from the same state, actions, u and
    noise: integer and bool leaves exactly, floats within ATOL."""
    import torch
    from repro_torch.envs import api
    from repro_torch.envs import traffic as tr
    from repro_torch.envs import warehouse as wh
    from repro_torch.tree import tree_leaves
    g = torch.Generator(device=dev)
    g.manual_seed(160)
    pairs = [("LS traffic", api.batch_local_env(
                 tr.make_local_traffic_env(tr.TrafficConfig(), dev)),
              tr.make_batched_local_traffic_env(tr.TrafficConfig(), dev))]
    for va in (0, 8):
        cfg = wh.WarehouseConfig(vanish_after=va)
        pairs.append((f"LS warehouse vanish_after={va}",
                      api.batch_local_env(wh.make_local_warehouse_env(cfg,
                                                                      dev)),
                      wh.make_batched_local_warehouse_env(cfg, dev)))
    G, R = tr.TrafficConfig().grid, wh.WarehouseConfig().grid
    t_ag = [(i, j) for i in range(G) for j in range(G)]
    w_ag = [(i, j) for i in range(R) for j in range(R)]
    pairs += [
        ("GS traffic A=25", api.batch_env(tr.make_multi_traffic_env(
            tr.TrafficConfig(), t_ag, dev)),
         tr.make_batched_multi_traffic_env(tr.TrafficConfig(), t_ag, dev)),
        ("GS warehouse A=36", api.batch_env(wh.make_multi_warehouse_env(
            wh.WarehouseConfig(), w_ag, dev)),
         wh.make_batched_multi_warehouse_env(wh.WarehouseConfig(), w_ag,
                                             dev))]
    for label, lifted, native in pairs:
        local = isinstance(native, api.BatchedLocalEnv)
        A = native.spec.n_agents
        st = native.reset(g, B)
        worst = 0.0
        for t in range(ticks):
            a = torch.randint(0, native.spec.n_actions,
                              (B, A) if A > 1 else (B,), generator=g,
                              device=dev)
            nz = native.noise_fn(g, B)
            if local:
                u = (torch.rand((B, native.spec.n_influence), generator=g,
                                device=dev) < 0.3).float()
                out_n = native.step_det(st, a, u, nz)
                out_l = lifted.step_det(st, a, u, nz)
            else:
                out_n = native.step_det(st, a, nz)
                out_l = lifted.step_det(st, a, nz)
            for x, y in zip(tree_leaves(out_l), tree_leaves(out_n)):
                if x.shape != y.shape or x.dtype != y.dtype:
                    raise AssertionError(f"{label} tick {t}: leaf "
                                         f"{tuple(x.shape)} {x.dtype} "
                                         f"against {tuple(y.shape)} "
                                         f"{y.dtype}")
                if x.dtype.is_floating_point:
                    err = float((x - y).abs().max()) if x.numel() else 0.0
                    worst = max(worst, err)
                    ok = err <= ATOL
                else:
                    ok = torch.equal(x, y)
                if not ok:
                    raise AssertionError(f"{label}: the vmap adapter and "
                                         f"the native env differ at tick "
                                         f"{t}")
            st = out_n[0]
        log(f"[scalar] adapter {label}: {ticks} ticks at B={B} equal to "
            f"the native env (integer leaves exact, max float err "
            f"{worst:.3g})")


def _rollout_fn(env, n_envs, T, seed, dev):
    """A random-policy horizon through ``env_rollout`` (the native
    ``rollout`` when the env has one, else a loop of ``step_det``),
    reset and noise drawn from a seed -> fn() returning the reward sum."""
    import torch
    from repro_torch.envs import api
    benv = api.as_batched(env)
    A = env.spec.n_agents

    def run():
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        st = benv.reset(g, n_envs)
        acts = torch.randint(0, env.spec.n_actions,
                             (T, n_envs) + ((A,) if A > 1 else ()),
                             generator=g, device=dev)
        _, rews = api.env_rollout(benv, st, acts, generator=g)
        return rews.sum()
    return run


def loop_rollout(single_envs, n_envs, T, seed, dev):
    """``benchmarks/multi_agent_throughput.py::loop_rollout`` on the port:
    each agent's scalar IALS lifted by ``batch_env`` (one vmapped step), a
    Python loop over the agents every tick -> fn() returning the reward
    sum."""
    import torch
    from repro_torch.envs import api
    benvs = [api.batch_env(e) for e in single_envs]

    def run():
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        states = [b.reset(g, n_envs) for b in benvs]
        total = 0.0
        for _ in range(T):
            a = torch.randint(0, single_envs[0].spec.n_actions, (n_envs,),
                              generator=g, device=dev)
            for i, b in enumerate(benvs):
                states[i], _, r, _ = b.step(states[i], a, g)
                total = total + r.sum()
        return total
    return run


def _wall_s(fn, reps=1):
    """Median wall seconds of ``fn()`` to its last device operation."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def _loop_baseline(domain, dev):
    """(c): the rows of ``benchmarks/multi_agent_throughput.py`` at full
    width, agent-steps/s each, with the launches of multi-ials and
    loop-ials -> (rates, speedup)."""
    import torch
    from repro_torch.core import engine, ials, influence
    from repro_torch.envs import traffic as tr
    from repro_torch.envs import warehouse as wh
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.tree import tree_map
    kind, stack, A = LOOP_DOMAINS[domain]
    mod, cfg = ((tr, tr.TrafficConfig()) if domain == "traffic"
                else (wh, wh.WarehouseConfig()))
    G = cfg.grid
    agents = [(i, j) for i in range(G) for j in range(G)]
    assert len(agents) == A
    gs = (mod.make_traffic_env(cfg, dev) if domain == "traffic"
          else mod.make_warehouse_env(cfg, dev))
    gs_multi = getattr(mod, f"make_batched_multi_{domain}_env")(cfg, agents,
                                                                dev)
    ls = getattr(mod, f"make_local_{domain}_env")(cfg, dev)
    bls = getattr(mod, f"make_batched_local_{domain}_env")(cfg, dev)
    acfg = influence.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                               n_out=ls.spec.n_influence, hidden=64,
                               stack=stack)
    g = torch.Generator(device=dev)
    g.manual_seed(170)
    aips = influence.init_aip_stacked(acfg, g, A, dev)
    aip0 = tree_map(lambda l: l[0], aips)
    n, T = LOOP_ENVS, LOOP_T
    rows = {"gs": (gs, A), "gs-multi": (gs_multi, A),
            "ials-1": (engine.make_unified_ials(bls, aip0, acfg), 1),
            "multi-ials": (engine.make_unified_ials(bls, aips, acfg,
                                                    n_agents=A), A)}
    rates, launches = {}, {}
    for name, (env, per_tick) in rows.items():
        fn = _rollout_fn(env, n, T, 171, dev)
        fn()                                     # warm-up
        cuda.reset_launches()
        s = _wall_s(fn, reps=3)
        torch.cuda.synchronize()
        launches[name] = nonzero(cuda.LAUNCHES)
        rates[name] = n * T * per_tick / s
        log(f"[loop] {domain} {name}: {rates[name]:.0f} agent-steps/s "
            f"({s:.4f} s for {n} envs x {T} ticks x {per_tick} agents a "
            f"tick); launches {launches[name]}")
    singles = [ials.make_ials(ls, tree_map(lambda l, i=i: l[i], aips), acfg)
               for i in range(A)]
    loop_rollout(singles, n, 8, 172, dev)()     # warm-up, 8 ticks
    cuda.reset_launches()
    s = _wall_s(loop_rollout(singles, n, LOOP_IALS_T, 172, dev))
    launches["loop-ials"] = nonzero(cuda.LAUNCHES)
    rates["loop-ials"] = n * LOOP_IALS_T * A / s
    log(f"[loop] {domain} loop-ials: {rates['loop-ials']:.0f} agent-steps/s "
        f"({s:.3f} s: {LOOP_IALS_T} ticks x {A} vmapped scalar IALS steps "
        f"of {n} envs); launches {launches['loop-ials']}")
    want = ("fnn_rollout[traffic]" if domain == "traffic"
            else "aip_rollout_multi[warehouse]")
    if launches["multi-ials"].get(want) != 3 or launches["loop-ials"]:
        raise AssertionError(f"{domain}: multi-ials launched "
                             f"{launches['multi-ials']} (want {want} once a "
                             f"horizon), loop-ials {launches['loop-ials']} "
                             f"(want none)")
    speedup = rates["multi-ials"] / rates["loop-ials"]
    log(f"[loop] {domain} batched_over_loop: speedup {speedup:.1f} "
        f"(multi-ials over loop-ials, A={A}; acceptance > "
        f"{MIN_LOOP_SPEEDUP:g}); the AIPs are random from a seed: the rate "
        f"does not depend on training")
    if not speedup > MIN_LOOP_SPEEDUP:
        raise AssertionError(f"{domain} batched_over_loop speedup "
                             f"{speedup:.2f} <= {MIN_LOOP_SPEEDUP}")
    return rates, speedup


def _batched_ials_training(dev):
    """(d): ``engine.make_batched_ials`` (traffic FNN A = 1) under
    ``ppo.make_train_iteration``, two iterations, one ``policy_rollout``
    launch each; then ``ppo.make_evaluator`` on the scalar GS."""
    import torch
    from repro_torch.core import engine, influence
    from repro_torch.envs import traffic as tr
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.rl import ppo
    g = torch.Generator(device=dev)
    g.manual_seed(180)
    bls = tr.make_batched_local_traffic_env(tr.TrafficConfig(), dev)
    acfg = influence.AIPConfig(kind="fnn", d_in=40, n_out=4, hidden=64,
                               stack=8)
    env = engine.make_batched_ials(bls, influence.init_aip(acfg, g), acfg)
    pcfg = ppo.PPOConfig(obs_dim=41, n_actions=2, n_envs=LOOP_ENVS,
                         rollout_len=LOOP_T, episode_len=LOOP_T)
    params = ppo.init_policy(pcfg, g)
    opt, iteration = ppo.make_train_iteration(env, pcfg)
    ost = opt.init(params)
    rs = ppo.init_rollout_state(env, pcfg, g)
    cuda.reset_launches()
    losses = []
    for _ in range(2):
        params, ost, rs, m = iteration(params, ost, rs, g)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    counts = nonzero(cuda.LAUNCHES)
    if counts.get("policy_rollout_fnn") != 2 or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"make_batched_ials under make_train_iteration:"
                             f" launches {counts}, losses {losses}")
    gs = tr.make_traffic_env(tr.TrafficConfig(), dev)
    evaluator = ppo.make_evaluator(gs, pcfg, n_episodes=8)
    t0 = time.perf_counter()
    r = float(evaluator(params, g).mean())
    eval_s = time.perf_counter() - t0
    if not 0.0 <= r <= 1.0:
        raise AssertionError(f"make_evaluator on the scalar GS: {r}")
    log(f"[scalar] make_batched_ials under make_train_iteration: losses "
        f"{losses}, launches {counts}; make_evaluator on the scalar GS: "
        f"reward {r:.4f} in {eval_s:.3f} s (8 episodes x {LOOP_T} ticks)")
    return counts["policy_rollout_fnn"]


def _quickstart():
    """(e): ``examples/torch_quickstart.py`` in-process at the reference's
    sizes on the card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cuda"])
    r = out["gs_eval_reward"]
    if not (all(math.isfinite(x) for x in out["losses"])
            and 0.0 <= r <= 1.0):
        raise AssertionError(f"quickstart: losses {out['losses']}, GS "
                             f"evaluation {r}")
    sec = out["seconds"]
    log(f"[quickstart] {out['transitions']} transitions, AIP cross-entropy "
        f"{out['aip_xent'][0]:.4f} -> {out['aip_xent'][1]:.4f}, final loss "
        f"{out['losses'][-1]:.4f}, IALS reward {out['ials_rewards'][-1]:.4f}"
        f", GS eval {r:.4f}; wall s: collect {sec['collect']:.2f}, AIP "
        f"{sec['aip']:.2f}, PPO {sec['ppo']:.2f} (10 iterations), eval "
        f"{sec['eval']:.2f}, total {sec['total']:.2f}")
    return out


@phase("the scalar protocol and the loop baseline")
def phase_scalar(dev):
    n = _ials_rollout_path(dev)
    _adapters(dev)
    for domain in LOOP_DOMAINS:
        _loop_baseline(domain, dev)
    _batched_ials_training(dev)
    _quickstart()
    return {"aip_rollout": n}


# ---------------------------------------------------------------------------
# the dry-run's IALS cells on the card (phase 4c)
# ---------------------------------------------------------------------------

# counted only, on the pods' layouts: a row the ranks run (256 ranks, one
# lane each) and one they refuse (the lanes replicated over "model")
ANALYSIS_POD_ROWS = (
    ("train_iteration", "traffic", "fnn", 1, 256, 128, "pod1"),
    ("policy_rollout", "traffic", "fnn", 25, 64, 128, "pod2"))


def queued_device_ms(fn, reps=3):
    """Device milliseconds per call of ``fn``, the host's enqueue left
    out, for a callable whose profiles lose a launch: ``reps`` calls
    enqueued behind a spin kernel that outlasts their enqueue, timed by
    CUDA events around the calls alone. The device reaches the first
    event only after the host has enqueued the last call (checked: the
    event is still pending then, else this raises), so it runs the calls
    back to back and never waits for the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(1 << 20)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = (1 << 20) / a.elapsed_time(b)
    # twice the calls' enqueue, and 20 ms
    torch.cuda._sleep(int(cycles_per_ms * (2e3 * enqueue_s * reps + 20)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    if a.query():
        raise AssertionError("the device reached the timed calls before "
                             "the host had enqueued them: not device time")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _lane_leaves(tree, T, B, A, stream):
    """A dry-run program's output leaves in lanes, batch-major (lane
    b * A + a: env b, agent a): (T, L, -1) for a stream, (L, -1) for a
    final leaf; a leaf with no agent axis (one per env) repeated over its
    env's agents."""
    from repro_torch.tree import tree_leaves
    lead = (T, B) if stream else (B,)
    out = []
    for l in tree_leaves(tree):
        agents = A > 1 and l.dim() > len(lead) and l.shape[len(lead)] == A
        x = l.reshape(lead + ((A,) if agents else (1,)) + (-1,))
        x = x.expand(lead + (A, x.shape[-1]))
        out.append(x.reshape(lead[:-1] + (B * A, -1)))
    return out


def _program_lanes(program, out, rollouts, T, B, A):
    """(streams, finals) of a dry-run program's run: an engine rollout's
    (state, rewards); PPO's rollout (state, batch, v_last), which
    ``train_iteration`` makes inside (``rollouts``, its recorded
    outputs)."""
    if program in ("aip_rollout_multi", "fnn_rollout"):
        return (_lane_leaves(out[1], T, B, A, True),
                _lane_leaves(out[0], T, B, A, False))
    rs, batch, v_last = rollouts[-1]
    return (_lane_leaves(batch, T, B, A, True),
            _lane_leaves((rs, v_last), T, B, A, False))


class _RecordRollouts:
    """``ppo.rollout`` recorded while active: what ``train_iteration``'s
    rollout returned, whatever its route (nothing added to a count)."""

    def __init__(self):
        self.outs = []

    def __enter__(self):
        from repro_torch.rl import ppo
        self._orig = ppo.rollout

        def rollout(*args, **kw):
            out = self._orig(*args, **kw)
            self.outs.append(out)
            return out
        ppo.rollout = rollout
        return self.outs

    def __exit__(self, *exc):
        from repro_torch.rl import ppo
        ppo.rollout = self._orig


def _plain_margins(prog, program, T, B, A):
    """The CPU plain run of ``prog`` again, its horizon traced: the (T,
    L) distance of each lane's closest decision (AIP draw, and the
    policy's top-two gap) from its threshold, lanes batch-major."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import ref
    trace = {}
    names = ("ials_rollout_multi_ref", "fnn_rollout_ref",
             "policy_rollout_ref")
    orig = {n: getattr(ref, n) for n in names}
    for n in names:
        setattr(ref, n, (lambda f: lambda *a, **kw: f(*a, trace=trace,
                                                       **kw))(orig[n]))
    try:
        prog.fn(*prog.args)
    finally:
        for n in names:
            setattr(ref, n, orig[n])
    m = torch.stack(trace["aip"])
    if "policy" in trace:
        m = torch.minimum(m, torch.stack(trace["policy"]))
    return engine.stream_unfold(m, A, B).reshape(T, B * A)


def hold_program(what, program, prog, plain_out, plain_rolls, out, rolls,
                 T, B, A, dev):
    """The card's run of a dry-run program against the CPU plain run on
    the same inputs: the horizon's outputs by the lane and flip rule
    (margins traced in a second plain run only when a lane differs), then
    ``train_iteration``'s learner (weights, optimizer state, metrics)
    within ATOL when no lane flipped, since a flipped lane changes the
    learner's batch -> (flips, max float error, learner held)."""
    import torch
    from repro_torch.tree import tree_leaves, tree_map
    plain_out, plain_rolls = tree_map(lambda l: l.to(dev),
                                      (plain_out, plain_rolls))
    ks, kf = _program_lanes(program, out, rolls, T, B, A)
    ps, pf = _program_lanes(program, plain_out, plain_rolls, T, B, A)
    streams = [(k, p, not k.dtype.is_floating_point)
               for k, p in zip(ks, ps)]
    finals = [(k, p, not k.dtype.is_floating_point)
              for k, p in zip(kf, pf)]
    L = B * A
    try:         # no lane may differ until one does
        flips, err = compare_lanes(
            what, streams, finals,
            torch.full((T, L), math.inf, device=dev), T, L)
    except AssertionError:
        flips, err = compare_lanes(
            what, streams, finals,
            _plain_margins(prog, program, T, B, A).to(dev), T, L)
    if program != "train_iteration" or flips:
        return flips, err, False
    learner = (out[0], out[1], out[3])
    for k, p in zip(tree_leaves(learner),
                    tree_leaves((plain_out[0], plain_out[1],
                                 plain_out[3]))):
        p = p.to(k.device)      # a leaf the optimizer keeps on the host
        if k.dtype.is_floating_point:
            e = float((k.float() - p.float()).abs().max()) if k.numel() \
                else 0.0
            ok, err = e <= ATOL, max(err, e)
        else:
            ok = torch.equal(k, p)
        if not ok:
            raise AssertionError(f"{what}: the learner's outputs differ "
                                 f"from the plain run's on the same batch")
    return flips, err, True


@phase("analysis: the dry-run's IALS cells on the card")
def phase_analysis(dev):
    """Every sweep row on the host mesh: counted on the CPU's plain
    route, then run once on the card from the counted program's inputs
    (counters zeroed before, read after) and held against the plain run;
    timed in device ms; a device time under the model-FLOP bound fails (a
    share above 100 % is impossible). Then the pod rows, counted only."""
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.launch import dryrun
    host = dryrun._ials_mesh("host")
    for program, domain, backbone, A, B, T, _ in dryrun.IALS_SWEEP:
        what = f"{program} {domain} {backbone} A={A} B={B} T={T} host"
        row = (program, domain, backbone, A, B, T)
        prog_cpu = dryrun.ials_program(*row, host, "cpu")
        with _RecordRollouts() as plain_rolls:
            cell, plain_out = dryrun.count_ials_program(prog_cpu, *row,
                                                        "host")
        prog = dryrun.ials_program(*row, host, dev)
        cuda.reset_launches()
        with _RecordRollouts() as rolls:
            out = dryrun.measure_ials_program(prog, cell)
        # its horizon kernel once, under its own and its domain's counter
        kernel = (f"policy_rollout_{cell['backbone']}"
                  if program in ("policy_rollout", "train_iteration")
                  else program)
        want = {kernel: 1, f"{kernel}[{domain}]": 1}
        if cell["status"] != "ok" or cell["launches"] != want:
            raise AssertionError(f"dry-run {what}: status {cell['status']}"
                                 f", launches {cell['launches']} (want "
                                 f"{want})")
        flips, err, learner = hold_program(what, program, prog_cpu,
                                           plain_out, plain_rolls, out,
                                           rolls, T, B, A, dev)

        def call():
            return prog.fn(*prog.args)
        ms, timed = device_ms(call, reps=3, warmup=1), "device"
        if not isinstance(ms, float):
            # no profile held every launch: device time by CUDA events
            # with the calls queued behind a spin kernel
            ms, timed = queued_device_ms(call), "queued device"
        rf = cell["roofline"]
        bound_ms = (rf["model_flops_total"] / cell["n_chips"]
                    / rf["peak_flops"] * 1e3)
        share = bound_ms / ms
        if share > 1.0:
            raise AssertionError(f"dry-run {what}: {timed} {ms:.4f} ms is "
                                 f"below its model-FLOP bound "
                                 f"{bound_ms:.4f} ms: the count or the "
                                 f"time is wrong")
        log(f"[analysis] {what}: {timed} ms {ms}, model-FLOP bound "
            f"{bound_ms:.6f} ms (share {share:.4%}), counted hbm_bytes "
            f"{cell['ops']['hbm_bytes']:.0f} (the unfused plain route's "
            f"t_memory {rf['t_memory_s'] * 1e3:.6f} ms), "
            f"{cell['ops']['n_ops']} aten ops counted in "
            f"{cell['count_s']:.2f} s, peak bytes on the card "
            f"{cell['memory']['peak_bytes_per_device']}, launches "
            f"{cell['launches']}; against the plain run: flips {flips} of "
            f"{A * B} lanes, max err {err:.3g}"
            + ("" if program != "train_iteration"
               else ", learner within ATOL" if learner
               else ", learner not held (a lane flipped: its batch "
                    "differs)"))
    for row in ANALYSIS_POD_ROWS:
        cell = dryrun.count_ials_cell(*row)
        if cell["status"] != "ok":
            raise AssertionError(f"dry-run {row}: {cell['status']}")
        rf = cell["roofline"]
        log(f"[analysis] {' '.join(map(str, row))}: {cell['n_chips']} "
            f"ranks, counted only: {cell['ops']['n_ops']} aten ops, "
            f"all-gathers {cell['ops']['collective_counts']} of "
            f"{cell['ops']['collective_bytes_total']:.0f} bytes, t_compute "
            f"{rf['t_compute_s'] * 1e3:.6f} ms, t_memory (unfused plain "
            f"route) {rf['t_memory_s'] * 1e3:.6f} ms, t_collective "
            f"{rf['t_collective_s'] * 1e3:.6f} ms; ranks refuse: "
            f"{cell.get('ranks_refuse', 'no')}")


# ---------------------------------------------------------------------------
# the serving kernels (phase 5) and the serving path (phase 6)
# ---------------------------------------------------------------------------

class ServeCase:
    """One serving slot at (domain widths, S, N) on the card: frames, a
    random mask, per-lane policy indices with unroutable lanes, and N
    policies of hidden width ``hp`` made from a seed (init plus noise, so
    every weight and the head matter). ``route`` shapes the slot:
    "random" as above, "skip" (no lane routes to the last policy), "one"
    (every lane live and routed to policy 0), "masked" (every lane
    masked off)."""

    def __init__(self, domain, S, N, seed, dev, route="random",
                 hp=SERVE_HP):
        import torch
        from repro_torch.kernels.ref import fuse_head
        from repro_torch.rl import ppo
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        D, NA = SERVE_WIDTHS[domain]
        self.domain, self.S, self.N, self.D, self.NA = domain, S, N, D, NA
        self.hp, self.route = hp, route
        cfg = ppo.PPOConfig(obs_dim=D, n_actions=NA, hidden=hp)
        pols = []
        for _ in range(N):
            p = ppo.init_policy(cfg, g)
            pols.append({k: {n: w + 0.05 * torch.randn(
                w.shape, generator=g, device=dev) for n, w in v.items()}
                for k, v in p.items()})
        self.single = [fuse_head(ppo.flat_policy_weights(p)) for p in pols]
        self.stacked = fuse_head(ppo.stack_policy_weights(pols))
        self.frames = torch.randn((S, D), generator=g, device=dev)
        self.mask = (torch.rand((S,), generator=g, device=dev)
                     < 0.75).to(torch.int32)
        self.pidx = torch.randint(0, N, (S,), generator=g, device=dev,
                                  dtype=torch.int32)
        self.pidx[3::7] = N                       # unroutable lanes
        self.pidx[5::11] = -1
        if route == "skip":
            self.pidx[self.pidx == N - 1] = N
        elif route == "one":
            self.mask.fill_(1)
            self.pidx.zero_()
        elif route == "masked":
            self.mask.zero_()
        elif route != "random":
            raise ValueError(f"unknown route {route!r}")

    def call(self, multi, plain=False, frames=None, mask=None, pidx=None):
        from repro_torch.kernels import aip_step as cuda
        from repro_torch.kernels import ref
        f = self.frames if frames is None else frames
        m = self.mask if mask is None else mask
        p = self.pidx if pidx is None else pidx
        if multi:
            if plain:
                return ref.serve_forward_multi_ref(self.stacked, f, m, p,
                                                   fast_gates=True)
            return cuda.serve_forward_multi(f, m, p, self.stacked,
                                            fast_gates=True)
        if plain:
            return ref.serve_forward_ref(self.single[0], f, m,
                                         fast_gates=True)
        return cuda.serve_forward(f, m, self.single[0], fast_gates=True)

    def live(self, multi):
        """Lanes some policy answers (the rest must come back 0)."""
        if not multi:
            return self.mask != 0
        return (self.mask != 0) & (self.pidx >= 0) & (self.pidx < self.N)

    def work(self, multi):
        """(FLOPs, bytes) this call needs: one forward per answered lane;
        inputs (frames, mask, pidx, every policy's weights) read once and
        outputs written once."""
        D, NH, hp = self.D, self.NA + 1, self.hp
        lanes = int(self.live(multi).sum())
        flops = 2 * lanes * (D * hp + hp * hp + hp * NH)
        w = self.stacked if multi else self.single[0]
        by = nbytes(self.frames, self.mask, w) + self.S * NH * 4
        if multi:
            by += nbytes(self.pidx)
        return flops, by


def _bitwise(a, b, what):
    import torch
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: not bitwise equal")


def check_serve(case, multi, name):
    """Kernel vs plain version, the pad/unroutable zeros and the bitwise
    contracts on the card -> (flips, max error)."""
    import torch
    k_lg, k_v = case.call(multi)
    torch.cuda.synchronize()
    p_lg, p_v = case.call(multi, plain=True)
    live = case.live(multi)
    err = max(float((k_lg - p_lg).abs().max()),
              float((k_v - p_v).abs().max()))
    if err > ATOL:
        raise AssertionError(f"{name}: max error {err} > {ATOL}")
    if bool(k_lg[~live].any()) or bool(k_v[~live].any()):
        raise AssertionError(f"{name}: a pad or unroutable lane is not 0")
    k_a, p_a = torch.argmax(k_lg, -1), torch.argmax(p_lg, -1)
    top2 = torch.topk(p_lg, 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < FLIP_EPS
    diff = k_a != p_a
    if bool((diff & ~near).any()):
        raise AssertionError(f"{name}: an action differs away from a tie")
    # contract 1: junk in the pad lanes, lanes permuted -> bitwise
    junk = case.frames.clone()
    junk[case.mask == 0] = float("nan")
    j_lg, j_v = case.call(multi, frames=junk)
    _bitwise((j_lg[live], j_v[live]), (k_lg[live], k_v[live]),
             f"{name} pad contents")
    g = torch.Generator(device=case.frames.device)
    g.manual_seed(case.S)
    perm = torch.randperm(case.S, generator=g, device=case.frames.device)
    q_lg, q_v = case.call(multi, frames=case.frames[perm],
                          mask=case.mask[perm], pidx=case.pidx[perm])
    _bitwise((q_lg, q_v), (k_lg[perm], k_v[perm]), f"{name} lane position")
    if multi:   # contract 2: a lane is its own checkpoint's single kernel
        from repro_torch.kernels import aip_step as cuda
        for n in range(case.N):
            s_lg, s_v = cuda.serve_forward(case.frames, case.mask,
                                           case.single[n], fast_gates=True)
            sel = live & (case.pidx == n)
            _bitwise((k_lg[sel], k_v[sel]), (s_lg[sel], s_v[sel]),
                     f"{name} policy {n} vs its single kernel")
    return int(diff.sum()), err


def serve_plan_text(case, multi):
    """The launch plan the kernel takes for ``case``, as one line."""
    from repro_torch.kernels.aip_step import serve_plan
    p = serve_plan(case.S, case.D, case.hp, case.NA + 1,
                   case.N if multi else 1)
    return (f"lanes/tile {p.lanes}, register tile {p.rows_per_thread} rows"
            f" x {p.cols_per_thread} cols, chunk rows {p.chunk_rows}, "
            f"stages {p.stages}/{p.chunks}, threads {p.threads}, grid "
            f"{p.grid}, smem {p.smem}, bulk ring/head {int(p.ring_bulk)}/"
            f"{int(p.head_bulk)}")


@phase("serving kernels against their plain versions")
def phase_serve_kernels(dev):
    recs = {"serve_forward": dict(flips=0, lanes=0, max_abs_err=0.0),
            "serve_forward_multi": dict(flips=0, lanes=0, max_abs_err=0.0)}

    def check(case, multi):
        name = "serve_forward_multi" if multi else "serve_forward"
        flips, err = check_serve(
            case, multi, f"{name} {case.domain} S={case.S} N={case.N} "
            f"{case.route} hp={case.hp}")
        r = recs[name]
        r["flips"] += flips
        r["lanes"] += case.S
        r["max_abs_err"] = max(r["max_abs_err"], err)

    seed, timed = 100, []
    for domain in SERVE_WIDTHS:
        for S in SERVE_SLOTS:
            for N in (1, 4):
                seed += 1
                case = ServeCase(domain, S, N, seed, dev)
                for multi in ((False, True) if N == 1 else (True,)):
                    check(case, multi)
                if S in SERVE_TIMED_SLOTS:
                    timed.append(case)
        for route in SERVE_ROUTES:
            seed += 1
            check(ServeCase(domain, 128, 4, seed, dev, route=route), True)
        # rows of 66 floats are no 16-byte multiple: plain-load staging
        for N in (1, 3):
            seed += 1
            case = ServeCase(domain, 48, N, seed, dev, hp=66)
            for multi in ((False, True) if N == 1 else (True,)):
                check(case, multi)
    for case in timed:
        for multi in ((False,) if case.N == 1 else (True,)):
            name = "serve_forward_multi" if multi else "serve_forward"
            ms = time_cuda(lambda: case.call(multi), reps=50, warmup=5)
            dms = device_ms(lambda: case.call(multi), reps=50, warmup=5,
                            kernel="serve_kernel")
            at = f"{case.domain} S={case.S} N={case.N}"
            log(f"[serve] {name} {at}: ms {ms:.4f}, device {dms}; plan "
                f"{serve_plan_text(case, multi)}")
            if (case.domain, case.S) == ("traffic", 128):
                recs[name].update(
                    ms=ms, device_ms=dms, timed_at=at,
                    plain_ms=time_cuda(lambda: case.call(multi, plain=True),
                                       reps=50, warmup=5))
                recs[name]["flops"], recs[name]["bytes"] = case.work(multi)
    for name, r in recs.items():
        if r["flips"] > MAX_FLIP_SHARE * r["lanes"]:
            raise AssertionError(f"{name}: {r['flips']} flips in "
                                 f"{r['lanes']} lanes")
        log(f"[kernel] {name}: {r['lanes']} lanes over {len(SERVE_WIDTHS)}"
            f" widths x {len(SERVE_SLOTS)} slots, the routes "
            f"{', '.join(SERVE_ROUTES)} and hidden 66, flips {r['flips']}, "
            f"max err {r['max_abs_err']:.3g}, ms {r['ms']:.4f} (device "
            f"{r['device_ms']}, plain {r['plain_ms']:.4f}) at "
            f"{r['timed_at']}; pad/unroutable "
            f"zeros and the bitwise contracts held")
    return recs


def _policy_serve(argv, counter):
    """One in-process ``policy_serve`` run with the launch counters zeroed
    before it and read after it -> (JSON result, launches of ``counter``)."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.launch import policy_serve
    cuda.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        res = policy_serve.main(argv)
    torch.cuda.synchronize()
    launches = cuda.LAUNCHES[counter]
    if launches < res["dispatches"]:
        raise AssertionError(f"{counter} launched {launches} times in "
                             f"{res['dispatches']} dispatches: {argv}")
    log(f"[serve] {' '.join(argv)}: requests {res['requests']}, served "
        f"{res['served']}, rejected {res['rejected']}, dispatches "
        f"{res['dispatches']}, {counter} launches {launches}, p50 "
        f"{res['p50_ms']:.4f} ms, p99 {res['p99_ms']:.4f} ms, qps "
        f"{res['qps']:.1f}, padded_lane_frac {res['padded_lane_frac']:.4f}"
        f", slot {res['slot']}")
    return res, launches


def dispatch_breakdown(server, trace, reps=200):
    """Where one fixed-slot dispatch's time goes at the main serving shape:
    host ms to pack a batch of the trace's first burst, host ms of
    ``forward_slot`` (one host-to-device copy, the kernel, ``argmax``, the
    sync; median and p99 over ``reps``), and from ``torch.profiler`` the
    device time per dispatch (every kernel and copy) and the device's busy
    share (that time over the wall time)."""
    import numpy as np
    shape = server.slot
    burst = [r for r in trace[:shape] if r.arrival == trace[0].arrival]
    t_pack = []
    for _ in range(reps):
        t0 = time.perf_counter()
        frames, pidx = server._pack(burst, shape)
        t_pack.append(time.perf_counter() - t0)
    server.forward_slot(frames, len(burst), pidx)
    t_fwd = []
    for _ in range(reps):
        t0 = time.perf_counter()
        server.forward_slot(frames, len(burst), pidx)
        t_fwd.append(time.perf_counter() - t0)
    got = profile_calls(
        lambda: server.forward_slot(frames, len(burst), pidx), reps,
        kernel="serve_kernel")
    dev_us, wall = (events_us(got[0]), got[1]) if got else (0.0, 1.0)
    rec = {"burst_lanes": len(burst),
           "pack_ms": 1e3 * statistics.median(t_pack),
           "forward_slot_ms": 1e3 * statistics.median(t_fwd),
           "forward_slot_p99_ms": 1e3 * float(np.percentile(t_fwd, 99)),
           "device_ms_per_dispatch": (dev_us * 1e-3 / reps if dev_us > 0
                                      else "not measured"),
           "device_busy_share": (dev_us * 1e-6 / wall if dev_us > 0
                                 else "not measured")}
    log(f"[serve] dispatch breakdown at slot {shape}: {rec}")
    return rec


@phase("serving path: policy_serve")
def phase_serving_path(dev):
    import shutil
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import policy_serve
    from repro_torch.rl import ppo
    from repro_torch.tree import tree_leaves
    base = ["--domain", "traffic", "--regions", "256", "--rps", "20000",
            "--duration-s", "2"]
    fixed, n_fixed = _policy_serve(base + ["--slot", "128"],
                                   "serve_forward")
    server, trace, _ = policy_serve.build_server_and_trace(
        policy_serve.parse_args(base + ["--slot", "128"]))
    dispatch_breakdown(server, trace)
    multi, n_multi = _policy_serve(base + ["--bimodal", "--calibrate", "3",
                                           "--n-policies", "4"],
                                   "serve_forward_multi")
    chaos, _ = _policy_serve(
        base + ["--virtual", "--admission", "--faults",
                "slow:10:0.05,flood:0.5:0.2:4,corrupt:0:nan",
                "--reload-at", "100,200"], "serve_forward")
    warehouse, _ = _policy_serve(
        ["--domain", "warehouse"] + base[2:] + ["--slot", "128"],
        "serve_forward")
    for res in (fixed, multi, warehouse):
        if res["served"] != res["requests"]:
            raise AssertionError(f"served {res['served']} of "
                                 f"{res['requests']} without admission")
    log_ = chaos["reload_log"]
    if (chaos["reload_rejected"] != 1 or chaos["reloads"] != 1
            or log_[0][0] != "rejected" or "canary" not in log_[0][1]):
        raise AssertionError(f"chaos run: the corrupt reload alone must be "
                             f"rejected: {log_}")
    if chaos["faults_applied"] != {"SlowDispatch": 1, "RequestFlood": 1,
                                   "CorruptCheckpoint": 1}:
        raise AssertionError(f"chaos plan: {chaos['faults_applied']}")
    # an rl_train-layout checkpoint written by the port, served back
    d = ROOT / "build" / "serve_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    cfg = ppo.PPOConfig(obs_dim=41, n_actions=2)
    pol = ppo.init_policy(cfg, g)
    ckpt.save(d, 40, {"policy": pol,
                      "opt": ppo.make_optimizer(cfg).init(pol)},
              metadata={"iteration": 40})
    argv = base[:-1] + ["0.5", "--slot", "128", "--ckpt-dir", str(d)]
    restored, _ = _policy_serve(argv, "serve_forward")
    server, _, _ = policy_serve.build_server_and_trace(
        policy_serve.parse_args(argv))
    for a, b in zip(tree_leaves(pol), tree_leaves(server._params)):
        if not torch.equal(a, b):
            raise AssertionError("--ckpt-dir: restored policy differs")
    if restored["restored_step"] != 40 or \
            restored["served"] != restored["requests"]:
        raise AssertionError(f"--ckpt-dir run: {restored['restored_step']}"
                             f", served {restored['served']}")
    shutil.rmtree(d, ignore_errors=True)
    log(f"[serve] chaos reload_log {log_}; --ckpt-dir restored step 40 "
        f"bitwise")
    return {"serve_forward": n_fixed, "serve_forward_multi": n_multi}


# ---------------------------------------------------------------------------
# the layer kernels (phase 7): gru_sequence, rmsnorm, flash_attention
# ---------------------------------------------------------------------------

# flash (B, T, S, H, KH, D, Dv, causal, dtype, bq, bk[, "cancel"]), GRU (B,
# T, D, H, dtype), rmsnorm (N, d, dtype[, offset of x into its storage, in
# elements]); "bench" = benchmarks/kernel_bench.py's
# shape, "main" = the widths of the repo's configurations that the
# kernels line reports (qwen3_4b attention and d_model, the traffic AIP)
FLASH_CASES = {
    "bench": (2, 512, 512, 8, 4, 64, 64, True, "float32", 128, 128),
    "main": (1, 4096, 4096, 32, 8, 128, 128, True, "bfloat16", 128, 128),
    "qwen3_4b non-causal": (1, 4096, 4096, 32, 8, 128, 128, False,
                            "bfloat16", 128, 128),
    "qwen3_4b f32": (1, 4096, 4096, 32, 8, 128, 128, True, "float32", 128,
                     128),
    "T128 causal": (4, 128, 128, 1, 1, 64, 64, True, "float32", 128, 128),
    "T128 non-causal": (4, 128, 128, 1, 1, 64, 64, False, "float32", 128,
                        128),
    "T256 D128": (4, 256, 256, 1, 1, 128, 128, True, "float32", 128, 128),
    "T128 S256 cross": (4, 128, 256, 1, 1, 64, 64, False, "float32", 128,
                        128),
    "T128 bf16": (4, 128, 128, 1, 1, 64, 64, True, "bfloat16", 128, 128),
    "blocks 64x64": (2, 256, 256, 1, 1, 64, 64, True, "float32", 64, 64),
    "blocks 128x32": (2, 256, 256, 1, 1, 64, 64, True, "float32", 128, 32),
    "blocks 32x128": (2, 256, 256, 1, 1, 64, 64, True, "float32", 32, 128),
    "GQA wrapper": (2, 128, 128, 8, 2, 64, 64, True, "float32", 128, 128),
    "ragged Dv<D": (2, 96, 160, 4, 2, 64, 32, True, "float32", 32, 32),
    "D256": (1, 128, 128, 2, 1, 256, 256, True, "float32", 128, 128),
    "T1": (1, 1, 128, 4, 4, 64, 64, False, "float32", 128, 128),
    # enough heads for 128-row blocks (f32_plan): ragged T and S, Dv < D,
    # GQA group 3; and non-causal, cross attention
    "f32 128-row blocks ragged": (1, 520, 600, 33, 11, 64, 48, True,
                                  "float32", 8, 8),
    "f32 128-row blocks cross": (2, 256, 384, 40, 8, 128, 128, False,
                                 "float32", 128, 128),
    # widths off 16-byte rows (staged by plain loads); causal with S < T
    "f32 odd widths": (1, 100, 130, 4, 2, 33, 17, True, "float32", 100,
                       130),
    "f32 causal S<T": (1, 300, 100, 4, 2, 64, 64, True, "float32", 100,
                       100),
    # the tensor-core route (bf16, D and Dv multiples of 16)
    "bf16 T200 ragged": (1, 200, 200, 4, 2, 128, 128, True, "bfloat16", 40,
                         40),
    "bf16 T128 S384 cross": (2, 128, 384, 4, 4, 128, 128, False, "bfloat16",
                             128, 128),
    "bf16 GQA group 1": (2, 256, 256, 4, 4, 128, 128, True, "bfloat16", 128,
                         128),
    "bf16 GQA group 4": (2, 256, 256, 8, 2, 128, 128, True, "bfloat16", 128,
                         128),
    "bf16 D64 Dv128": (2, 256, 256, 4, 2, 64, 128, True, "bfloat16", 128,
                       128),
    "bf16 D256": (1, 256, 256, 4, 2, 256, 256, True, "bfloat16", 128, 128),
    "bf16 T1": (1, 1, 128, 4, 4, 128, 128, False, "bfloat16", 128, 128),
    # bf16 off the tensor-core kernel's steps of 16: the CUDA-core kernel
    # (its tiles staged by plain loads, converted to float32)
    "bf16 D40 off-16": (2, 128, 128, 4, 2, 40, 40, True, "bfloat16", 128,
                        128),
    # v = +1, -1 on alternate keys: outputs cancel, and a p rounded once to
    # bf16 would miss the bound (tests/test_torch_flash_tc.py)
    "bf16 cancellation": (1, 64, 8, 2, 1, 64, 64, False, "bfloat16", 64, 8,
                          "cancel"),
}
GRU_CASES = {
    "bench": (8, 64, 40, 64, "float32"),
    "main": (1024, 128, 40, 64, "float32"),
    "B4 T20": (4, 20, 24, 32, "float32"),
    "B1 T1": (1, 1, 8, 16, "float32"),
    "bf16": (2, 16, 12, 32, "bfloat16"),
    "weights via L2": (16, 8, 256, 256, "float32"),
    # the routes of gru.gru_plan: registers at 2 and 4 rows a tile, at
    # H = 32 (its h @ wh steps padded), a ragged last tile, past one wave,
    # bf16 at the main widths; "l2" for H = 128 and in two passes (H =
    # 1000)
    "rows 2": (200, 16, 40, 64, "float32"),
    "rows 4": (500, 16, 40, 64, "float32"),
    "H32": (1024, 16, 24, 32, "float32"),
    "ragged B1003": (1003, 16, 40, 64, "float32"),
    "past one wave": (3000, 8, 40, 64, "float32"),
    "bf16 main widths": (1024, 32, 40, 64, "bfloat16"),
    "l2 H128": (64, 8, 40, 128, "float32"),
    "l2 in passes": (4, 4, 40, 1000, "float32"),
}
RMS_CASES = {
    "bench": (4096, 512, "bfloat16"),
    "main": (4096, 2560, "bfloat16"),
    "qk-norm": (4096 * 32, 128, "bfloat16"),
    "N256": (256, 128, "float32"),
    "N1000": (1000, 512, "float32"),
    "bf16 d256": (64, 256, "bfloat16"),
    "block per row f32": (37, 3000, "float32"),
    # the scalar route (not a whole number of 16-byte vectors; a view one
    # element into its storage), the block route (above the warp route's
    # registers) and the scalar block route (above the block route's)
    "d2564 bf16": (64, 2564, "bfloat16"),
    "misaligned view": (256, 2560, "bfloat16", 1),
    "above the register limit": (512, 4096, "bfloat16"),
    "above the block limit": (8, 20000, "bfloat16"),
}
# the cases whose times the kernels line or PERF.md reads
TIMED = ("bench", "main", "qk-norm", "qwen3_4b f32", "qwen3_4b non-causal")


class LayerCase:
    """One layer op's inputs on the card at one shape, made from a seed:
    ``call()`` the ``kernels.ops`` entry point (the CUDA kernel),
    ``plain()`` its plain version, ``library()`` the one PyTorch call that
    computes the same function (or None), and the work the function
    needs (``flops``: its matrix products, or 4 operations an element for
    RMSNorm; ``bytes``: inputs read once, outputs written once)."""

    def __init__(self, op, dims, seed, dev):
        import torch
        import torch.nn.functional as F
        from repro_torch.kernels import ops, ref
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        self.op, self.dims = op, dims
        self.dtype = dims[{"flash_attention": 8, "gru_sequence": 4,
                           "rmsnorm": 2}[op]]
        dt = getattr(torch, self.dtype)

        def rn(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=g, device=dev)
                    ).to(dt)

        self.library = None
        if op == "flash_attention":
            B, T, S, H, KH, D, Dv, causal, _, bq, bk = dims[:11]
            if dims[11:] == ("cancel",):
                q, k = rn(B, T, H, D, scale=0.3), rn(B, S, KH, D, scale=0.3)
                sign = 1.0 - 2.0 * (torch.arange(S, device=dev) % 2)
                v = sign[None, :, None, None].expand(B, S, KH, Dv).to(dt)
                v = v.contiguous()
            else:
                q, k, v = rn(B, T, H, D), rn(B, S, KH, D), rn(B, S, KH, Dv)
            self.call = lambda: ops.flash_attention_mha(
                q, k, v, causal=causal, bq=bq, bk=bk)
            self.plain = lambda: ref.flash_attention_mha_ref(
                q, k, v, causal=causal)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            self.library = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            pairs = (sum(min(i + 1, S) for i in range(T)) if causal
                     else T * S)
            self.flops = 2 * B * H * pairs * (D + Dv)
            self.bytes = nbytes(q, k, v) + B * T * H * Dv * q.element_size()
        elif op == "gru_sequence":
            B, T, D, H, _ = dims
            p = {"wx": rn(D, 3 * H, scale=0.2), "wh": rn(H, 3 * H, scale=0.2),
                 "b": rn(3 * H, scale=0.1)}
            xs, h0 = rn(B, T, D), rn(B, H, scale=0.5)
            self.call = lambda: ops.gru_sequence(p, xs, h0)
            self.plain = lambda: ref.gru_sequence_ref(xs, p["wx"], p["wh"],
                                                      p["b"], h0)
            self.flops = 2 * B * T * (D + H) * 3 * H
            self.bytes = nbytes(xs, h0, p) + B * T * H * xs.element_size()
        else:
            N, d, _ = dims[:3]
            x = rn(N, d)
            if dims[3:]:
                # the same values in a view that starts off a 16-byte line
                off = dims[3]
                buf = torch.empty(N * d + off, dtype=dt, device=dev)
                x = buf[off:].view(N, d).copy_(x)
            gw = torch.randn((d,), generator=g, device=dev)
            self.call = lambda: ops.rmsnorm(x, gw)
            self.plain = lambda: ref.rmsnorm_ref(x, gw)
            g_dt = gw.to(dt)
            self.library = lambda: F.rms_norm(x, (d,), weight=g_dt, eps=1e-6)
            self.flops = 4 * N * d
            self.bytes = 2 * nbytes(x) + nbytes(gw)


def gru_plan_text(dims):
    """The launch plan ``gru_sequence`` takes at (B, T, D, H, dtype), as
    one line."""
    import torch
    from repro_torch.kernels.gru import gru_plan
    B, T, D, H, dt = dims
    p = gru_plan(B, T, D, H, getattr(torch, dt))
    return (f"rows/tile {p.rows}, grid {p.grid}, parts {p.parts}, units/"
            f"thread {p.units_per_thread}, threads {p.threads}, route "
            f"{p.route}, passes {p.passes}, smem {p.smem}")


def f32_plan_text(dims):
    """The launch plan the CUDA-core flash kernel takes for a flash case,
    as one line."""
    import torch
    from repro_torch.kernels.flash_attention import f32_plan
    B, T, S, H, KH, D, Dv, _, dt = dims[:9]
    p = f32_plan(T, S, D, Dv, getattr(torch, dt), heads=B * H)
    return (f"rows/block {p.rows}, keys/tile {p.keys}, threads "
            f"{p.threads}, stages {p.stages}, smem {p.smem}, blocks/SM "
            f"{p.blocks_per_sm}, grid {(B * H, p.q_tiles)}")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def check_layer(case, name):
    """Kernel (through ``kernels.ops``) against its plain version on the
    same inputs: shapes and dtypes equal, finite, within the stated
    tolerance -> max abs error."""
    import torch
    k_out = _outputs(case.call())
    torch.cuda.synchronize()
    p_out = _outputs(case.plain())
    return max(_near(k, p, LAYER_TOL[case.op], name)
               for k, p in zip(k_out, p_out))


def time_layer(case):
    """Kernel, device, plain and library times of one case; the library
    call's device time too, since the event time of a ~0.02 ms kernel is
    mostly its caller's enqueue (a Python wrapper's more than a C++
    operator's)."""
    import torch
    reps = 10
    rec = {"ms": time_cuda(case.call, reps=reps),
           "device_ms": device_ms(case.call, reps=reps),
           "plain_ms": time_cuda(case.plain, reps=3, warmup=1),
           "library_ms": None, "library_device_ms": None}
    if case.library is not None:
        rec["library_ms"] = time_cuda(case.library, reps=reps)
        rec["library_device_ms"] = device_ms(case.library, reps=reps)
        # how far the yardstick agrees
        lib = case.library()
        if case.op == "flash_attention":
            lib = lib.transpose(1, 2)
        rec["library_diff"] = float((lib.float() - case.call().float()
                                     ).abs().max())
    torch.cuda.synchronize()
    return rec


@phase("layer kernels against their plain versions")
def phase_layer_kernels(dev):
    """Every case against its plain version; the TIMED cases timed. Flash
    cases are filed under the kernel that took them (the launch counters
    say which): "flash_attention" the tensor-core kernel, timed at the
    main shape, "flash_attention[f32]" the CUDA-core one, timed at the
    qwen3_4b f32 case."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    recs, worst = {}, {}
    seed = 700
    for op, cases in (("gru_sequence", GRU_CASES), ("rmsnorm", RMS_CASES),
                      ("flash_attention", FLASH_CASES)):
        for label, dims in cases.items():
            seed += 1
            case = LayerCase(op, dims, seed, dev)
            cuda.reset_launches()
            err = check_layer(case, f"{op} {label} {dims}")
            name = op
            if op == "flash_attention" and cuda.LAUNCHES[
                    "flash_attention[wgmma]"] == 0:
                name = "flash_attention[f32]"
            worst[name] = max(worst.get(name, 0.0), err)
            line = (f"[kernel] {op} {label} {dims}: {name}, max err "
                    f"{err:.3g}")
            if op == "gru_sequence":
                line += f"; plan {gru_plan_text(dims)}"
            if name == "flash_attention[f32]":
                line += f"; plan {f32_plan_text(dims)}"
            if label in TIMED:
                rec = time_layer(case)
                b_ms, b_by = bound(case.flops, case.bytes, case.dtype)
                line += (f", ms {rec['ms']:.4f} (device {rec['device_ms']}),"
                         f" plain ms {rec['plain_ms']:.4f}, library ms "
                         f"{rec['library_ms']} (device "
                         f"{rec['library_device_ms']}), bound ms "
                         f"{b_ms:.6f} ({b_by})"
                         + (f", library diff {rec['library_diff']:.3g}"
                            if "library_diff" in rec else ""))
                if label == "main" or (name == "flash_attention[f32]"
                                       and label == "qwen3_4b f32"):
                    recs[name] = dict(rec, flops=case.flops,
                                      bytes=case.bytes, dtype=case.dtype,
                                      flips=None, timed_at=f"{op} {dims}")
                    if op == "gru_sequence":
                        recs[name]["plan"] = gru_plan_text(dims)
                    if name == "flash_attention[f32]":
                        recs[name]["plan"] = f32_plan_text(dims)
            log(line)
            del case
            torch.cuda.empty_cache()
    for name, rec in recs.items():
        rec["max_abs_err"] = worst[name]
    return recs


@phase("layer path: kernels.ops at the configurations' widths")
def phase_layer_path(dev):
    """The ``kernels.ops`` entry points as a caller drives them (each
    op at ``benchmarks/kernel_bench.py``'s shape and at the main widths;
    GRU with ``h0=None``, RMSNorm with ``rmsnorm_init``'s g), counters
    zeroed before and read after; each output held against the port's
    ``nn`` function it is a drop-in for."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import ops
    from repro_torch.nn import attention, module, rnn
    g = torch.Generator(device=dev)
    g.manual_seed(900)
    bf = torch.bfloat16
    flash_in, gru_in, rms_in = [], [], []
    for B, T, H, KH, D, dt in ((2, 512, 8, 4, 64, torch.float32),
                               (1, 4096, 32, 8, 128, bf)):
        flash_in.append([torch.randn((B, T, h, D), generator=g,
                                     device=dev).to(dt)
                         for h in (H, KH, KH)])
    for B, T in ((8, 64), (1024, 128)):
        p = rnn.gru_init(g, 40, 64, device=dev)
        p["b"] = 0.1 * torch.randn(p["b"].shape, generator=g, device=dev)
        gru_in.append((p, torch.randn((B, T, 40), generator=g, device=dev)))
    for N, d in ((4096, 512), (4096, 2560), (4096 * 32, 128)):
        rms_in.append((module.rmsnorm_init(d, device=dev),
                       torch.randn((N, d), generator=g, device=dev).to(bf)))
    cuda.reset_launches()
    flash_out = []
    for q, k, v in flash_in:
        before = cuda.LAUNCHES["flash_attention[wgmma]"]
        flash_out.append(ops.flash_attention_mha(q, k, v, causal=True))
        tc = cuda.LAUNCHES["flash_attention[wgmma]"] - before
        # the bf16 qwen3_4b call must take the tensor-core route
        if tc != int(q.dtype == bf):
            raise AssertionError(f"flash {tuple(q.shape)} {q.dtype}: "
                                 f"{tc} tensor-core launches")
    gru_out = [ops.gru_sequence(p, xs) for p, xs in gru_in]
    rms_out = [ops.rmsnorm(x, p["g"]) for p, x in rms_in]
    torch.cuda.synchronize()
    counts = {k: cuda.LAUNCHES[k] for k in (
        "flash_attention", "flash_attention[wgmma]", "flash_attention[f32]",
        "gru_sequence", "rmsnorm")}
    want = {"flash_attention": len(flash_in), "flash_attention[wgmma]": 1,
            "flash_attention[f32]": len(flash_in) - 1,
            "gru_sequence": len(gru_in), "rmsnorm": len(rms_in)}
    if counts != want:
        raise AssertionError(f"kernels.ops launches {counts}, expected "
                             f"{want}")
    errs = {}
    for (q, k, v), o in zip(flash_in, flash_out):
        # p_bf16=False: the kernel keeps the probability tile in f32
        want_o = attention.flash_attention(q, k, v, causal=True,
                                           p_bf16=False)
        errs.setdefault("flash_attention", []).append(_near(
            o, want_o, LAYER_TOL["flash_attention"], "flash vs nn"))
    for (p, xs), (hs, hT) in zip(gru_in, gru_out):
        want_hs, want_hT = rnn.gru_sequence(p, xs)
        errs.setdefault("gru_sequence", []).append(max(
            _near(hs, want_hs, LAYER_TOL["gru_sequence"], "gru vs nn"),
            _near(hT, want_hT, LAYER_TOL["gru_sequence"], "gru h_T vs nn")))
    for (p, x), o in zip(rms_in, rms_out):
        errs.setdefault("rmsnorm", []).append(_near(
            o, module.rmsnorm(p, x), LAYER_TOL["rmsnorm"], "rmsnorm vs nn"))
    log(f"[counts] kernels.ops path: {counts}; max error against the nn "
        f"functions: {errs}")
    # the kernels line reads each flash kernel's own count
    return dict(counts, flash_attention=counts["flash_attention[wgmma]"])


# ---------------------------------------------------------------------------
# phase 8: LM serving
# ---------------------------------------------------------------------------

LM_SERVE_ARGV = ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "128",
                 "--gen", "32"]
LM_INVARIANT_TOL = 2e-3       # tests/test_models.py's, float32
LM_REDUCED_TOL = (1e-4, 1e-4)  # card vs CPU, float32 reduced: (atol, rtol)
# deepseek-moe-16b bf16, prefill + decode against forward: max |diff| of
# the logits over max |logit|. bf16 rounds at other points on the two
# routes (other GEMM shapes, decode attention against flash), and that
# noise flips near-tied routing (top 6 of 64): measured 0.126 with 98 of
# 2,160 token-layer decisions flipped (NVIDIA H100 80GB HBM3, 700.00 W);
# one flipped expert moves a token's MoE output by about a sixth. The
# bound is 2.4x that spread. The same run in float32 (depth cut to
# LM_MOE_F32_LAYERS) must meet LM_INVARIANT_TOL: the dispatch itself is
# exact.
LM_MOE_BF16_REL = 0.3
LM_MOE_F32_LAYERS = 8
LM_MOE = dict(batch=2, prompt=32, gen=8)


class _RouterLog:
    """Records every ``moe_apply`` call's top-k expert sets, (N, k)
    sorted, in call order (the port's own ``lax.top_k`` order)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.nn import moe
        self._moe, self._real = moe, moe.moe_apply

        def recording(p, x, *, top_k, **kw):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"], -1)
            idx = torch.sort(probs, dim=-1, descending=True,
                             stable=True).indices[:, :top_k]
            self.calls.append(torch.sort(idx, -1).values.cpu())
            return self._real(p, x, top_k=top_k, **kw)
        moe.moe_apply = recording
        return self

    def __exit__(self, *exc):
        self._moe.moe_apply = self._real


def _perturb_constants(tree, g):
    """Every all-zero or all-one leaf (biases, gates, norms) plus noise, so
    each path carries signal (a zero cross-attention gate hides the
    vision layers)."""
    import torch
    from repro_torch.tree import tree_map

    def go(x):
        flat = x.reshape(-1)
        if flat.numel() and bool((flat == flat[0]).all()) and \
                float(flat[0]) in (0.0, 1.0):
            return x + (0.2 * torch.randn(x.shape, generator=g)).to(x.dtype)
        return x
    return tree_map(go, tree)


def _lm_inputs(cfg, B, T, g, dev):
    import torch
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    extra = {}
    if cfg.family == "vlm":
        extra["vision"] = torch.randn((B, cfg.n_vision_tokens, cfg.d_model),
                                      generator=g).to(cfg.dtype())
    if cfg.family == "encdec":
        extra["frames"] = torch.randn((B, cfg.n_audio_frames, cfg.d_model),
                                      generator=g).to(cfg.dtype())
    return toks.to(dev), {k: v.to(dev) for k, v in extra.items()}


def _lm_serve_qwen(dev, card):
    """Part 1: ``launch/serve`` itself at qwen3-4b's full width, bf16."""
    import torch
    from repro_torch.launch import serve
    runs = []
    for run in ("first", "again"):   # the first call's lazy loads apart
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        gen, stats = serve.main(LM_SERVE_ARGV)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if tuple(gen.shape) != (4, 33) or int(gen.min()) < 0 or \
                int(gen.max()) >= 151936:
            raise AssertionError(
                f"serve qwen3-4b: generated {tuple(gen.shape)} ids in "
                f"[{int(gen.min())}, {int(gen.max())}]")
        log(f"[lm] serve {' '.join(LM_SERVE_ARGV)} (bf16, eager; {run} "
            f"call in this process): prefill_s {stats['prefill_s']} "
            f"[{card}]; decode_tokens_per_s {stats['decode_tokens_per_s']} "
            f"[{card}]; max_memory_allocated {peak} B [{card}]; wall "
            f"{wall:.2f} s (init included)")
        runs.append(gen)
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("serve qwen3-4b: two greedy runs of one seed "
                             "generated different tokens")


def _lm_invariant_qwen_f32(dev):
    """Part 2: qwen3-4b at full width in float32: prefill of T tokens and
    one decode step against forward over T + 1, at 2e-3 (the JAX test's
    bound, ``tests/test_models.py``)."""
    import torch
    from repro_torch import stream
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    cfg = get_config("qwen3-4b").with_overrides(param_dtype="float32")
    B, T = 2, 32
    with torch.inference_mode():
        params = lm.init_params(cfg, stream(dev, 1, 0))
        g = torch.Generator()
        g.manual_seed(11)
        toks, _ = _lm_inputs(cfg, B, T + 1, g, dev)
        lg0, cache = lm.prefill(params, cfg, {"tokens": toks[:, :T]}, T + 8)
        lg1, _ = lm.decode_step(params, cfg, cache, toks[:, T], T)
        h, _, _ = lm.forward(params, cfg, {"tokens": toks})
        ref0 = lm.logits(params, cfg, h[:, T - 1])
        ref1 = lm.logits(params, cfg, h[:, T])
        e0 = float((lg0 - ref0).abs().max())
        e1 = float((lg1 - ref1).abs().max())
        scale = float(ref1.abs().max())
    del params, cache
    torch.cuda.empty_cache()
    log(f"[lm] qwen3-4b float32 full width, B = {B}, T = {T}: prefill vs "
        f"forward max |diff| {e0:.3g}, decode vs forward {e1:.3g} (max "
        f"|logit| {scale:.3g}; bound {LM_INVARIANT_TOL})")
    if not (math.isfinite(e0) and math.isfinite(e1)) or \
            max(e0, e1) >= LM_INVARIANT_TOL:
        raise AssertionError(f"qwen3-4b f32: prefill+decode vs forward "
                             f"{e0:.3g} / {e1:.3g} >= {LM_INVARIANT_TOL}")


def _lm_moe(dev, card, dtype):
    """Part 3: deepseek-moe-16b at full width (64 experts, top 6),
    dropless: prefill, greedy decode, and forward over the prompt plus the
    fed tokens; the logits of every decoded position against forward's,
    and the routing of every token of every MoE layer compared. bf16 at
    full depth (served and timed); float32 with the depth cut to
    ``LM_MOE_F32_LAYERS`` (the weights of all 28 would take 65.5 GB)."""
    import torch
    from repro_torch import stream
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    cfg = get_config("deepseek-moe-16b")
    cfg = cfg.with_overrides(
        capacity_factor=cfg.n_routed_experts / cfg.moe_top_k,
        param_dtype=dtype)
    if dtype == "float32":
        cfg = cfg.with_overrides(n_layers=LM_MOE_F32_LAYERS)
    B, T, n = LM_MOE["batch"], LM_MOE["prompt"], LM_MOE["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = lm.init_params(cfg, stream(dev, 2, 0))
        torch.cuda.synchronize(dev)
        t_init = time.perf_counter() - t0
        g = torch.Generator()
        g.manual_seed(12)
        prompt, _ = _lm_inputs(cfg, B, T, g, dev)
        with _RouterLog() as serve_log:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            lg, cache = lm.prefill(params, cfg, {"tokens": prompt}, T + n)
            torch.cuda.synchronize(dev)
            t_prefill = time.perf_counter() - t0
            lgs, fed = [lg], []
            t0 = time.perf_counter()
            for i in range(n):
                tok = torch.argmax(lg, -1)
                fed.append(tok)
                lg, cache = lm.decode_step(params, cfg, cache, tok, T + i)
                lgs.append(lg)
            torch.cuda.synchronize(dev)
            t_decode = time.perf_counter() - t0
        toks = torch.cat([prompt, torch.stack(fed, 1)], 1)     # (B, T + n)
        with _RouterLog() as fwd_log:
            h, aux, _ = lm.forward(params, cfg, {"tokens": toks})
            ref = lm.logits(params, cfg, h[:, T - 1:T + n])    # (B, n+1, V)
        got = torch.stack(lgs, 1)
        peak = torch.cuda.max_memory_allocated(dev)
        finite = bool(torch.isfinite(got).all()) and \
            bool(torch.isfinite(ref).all())
        diff = (got.float() - ref.float()).abs()
        err, scale = float(diff.max()), float(ref.float().abs().max())
        per_pos = [round(float(x), 6) for x in diff.amax((0, 2))]
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        drop = float(aux["drop_frac"])
    del params, cache, h
    torch.cuda.empty_cache()
    # routing: forward's sets (B, T+n) per MoE layer against the prefill's
    # and each decode step's, token by token
    L = cfg.n_layers - cfg.first_k_dense
    fwd = [c.reshape(B, T + n, -1) for c in fwd_log.calls]
    srv = serve_log.calls
    flips = 0
    for layer in range(L):
        flips += int((srv[layer].reshape(B, T, -1)
                      != fwd[layer][:, :T]).any(-1).sum())
        for i in range(n):
            step = srv[L + i * L + layer].reshape(B, -1)
            flips += int((step != fwd[layer][:, T + i]).any(-1).sum())
    decisions = L * B * (T + n)
    bound = LM_MOE_BF16_REL * scale if dtype == "bfloat16" \
        else LM_INVARIANT_TOL
    log(f"[lm] deepseek-moe-16b {dtype} full width, {cfg.n_layers} layers, "
        f"dropless, B = {B}, prompt {T}, gen {n}: init {t_init:.2f} s, "
        f"prefill {t_prefill:.4f} s [{card}], decode "
        f"{B * n / t_decode:.1f} tokens/s [{card}], max_memory_allocated "
        f"{peak} B [{card}]; logits finite {finite}; prefill+decode vs "
        f"forward max |diff| {err:.4g} over max |logit| {scale:.4g} "
        f"(share {err / scale:.4g}; bound {bound:.4g}); per position "
        f"{per_pos}; argmax agreement {agree:.4f}; routing flips {flips} "
        f"of {decisions} token-layer decisions; forward drop_frac {drop}")
    if not finite:
        raise AssertionError(f"deepseek-moe-16b {dtype}: non-finite logits")
    if drop != 0.0:
        raise AssertionError(f"deepseek-moe-16b dropless: drop_frac {drop}")
    if not err < bound:
        raise AssertionError(f"deepseek-moe-16b {dtype}: prefill+decode vs "
                             f"forward {err:.4g} >= {bound:.4g}")


def _lm_reduced_all(dev):
    """Part 4: every arch at ``reduced()``, float32: forward, prefill and
    one decode step on the card against the port's CPU run of the same
    weights and inputs, every decoded cache leaf included."""
    import torch
    from repro_torch.configs.base import get_config, list_configs, reduced
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves_with_path, tree_map
    B, T = 2, 12
    worst = {}
    for i, arch in enumerate(list_configs()):
        cfg = reduced(get_config(arch))
        g = torch.Generator()
        g.manual_seed(100 + i)
        cpu = _perturb_constants(lm.init_params(cfg, g, device="cpu"), g)
        toks, extra = _lm_inputs(cfg, B, T + 1, g, "cpu")
        outs = {}
        for where in ("cpu", dev):
            p = tree_map(lambda x: x.to(where), cpu)
            tk = toks.to(where)
            ex = {k: v.to(where) for k, v in extra.items()}
            with torch.inference_mode():
                h, aux, _ = lm.forward(p, cfg, {"tokens": tk[:, :T], **ex})
                lg0, cache = lm.prefill(p, cfg, {"tokens": tk[:, :T], **ex},
                                        T + 4)
                lg1, cache = lm.decode_step(p, cfg, cache, tk[:, T], T)
            outs[str(where)] = dict(h=h, lg0=lg0, lg1=lg1, aux=aux,
                                    cache=cache)
        a, b = outs[str(dev)], outs["cpu"]
        errs = [_lm_near(a[k], b[k], k) for k in ("h", "lg0", "lg1")]
        errs += [_lm_near(a["aux"][k], b["aux"][k], k) for k in b["aux"]]
        ref = dict(tree_leaves_with_path(b["cache"]))
        for path, leaf in tree_leaves_with_path(a["cache"]):
            errs.append(_lm_near(leaf, ref[path], f"cache{path}"))
        worst[arch] = max(errs)
    log(f"[lm] reduced archs, card vs CPU (float32, bound atol + rtol x "
        f"|CPU value|, {LM_REDUCED_TOL}): worst share of the bound "
        f"{worst}")
    return worst


def _lm_near(a, b, what):
    """``a`` (the card's) finite, of ``b``'s shape and dtype, within
    ``LM_REDUCED_TOL`` of it -> the largest share of the bound used."""
    import torch
    af, bf = a.detach().float().cpu(), b.detach().float().cpu()
    if af.shape != bf.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(af.shape)} {a.dtype} vs "
                             f"{tuple(bf.shape)} {b.dtype}")
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{what}: non-finite on the card")
    atol, rtol = LM_REDUCED_TOL
    share = (af - bf).abs() / (atol + rtol * bf.abs())
    if bool((share > 1).any()):
        raise AssertionError(f"{what}: card vs CPU max |diff| "
                             f"{float((af - bf).abs().max()):.3g}")
    return float(share.max()) if share.numel() else 0.0


@phase("LM serving: launch/serve at full width")
def phase_lm(dev, card):
    """The LM serving path (``launch/serve``, ``models/lm.py``): qwen3-4b
    and deepseek-moe-16b at full width, the float32 invariant, every
    reduced arch against the CPU. The LM calls the ``nn`` functions, not
    the layer kernels (as the reference's LM calls its XLA path), so the
    kernel launch counters must not move."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    torch.empty(1, device=dev)   # the allocator's stats need a context
    before = dict(cuda.LAUNCHES)
    parts = {}
    for name, fn in (("serve qwen3-4b", lambda: _lm_serve_qwen(dev, card)),
                     ("qwen3-4b f32 invariant",
                      lambda: _lm_invariant_qwen_f32(dev)),
                     ("deepseek-moe-16b bf16",
                      lambda: _lm_moe(dev, card, "bfloat16")),
                     ("deepseek-moe-16b f32, 8 layers",
                      lambda: _lm_moe(dev, card, "float32")),
                     ("reduced archs", lambda: _lm_reduced_all(dev))):
        t0 = time.perf_counter()
        fn()
        parts[name] = round(time.perf_counter() - t0, 2)
    moved = {k: v - before[k] for k, v in cuda.LAUNCHES.items()
             if v != before[k]}
    log(f"[lm] part times (s): {parts}; kernel launches during the phase: "
        f"{moved or 'none'}")
    if moved:
        raise AssertionError(f"the LM path launched kernels: {moved}")


# ---------------------------------------------------------------------------
# phase 9: LM training
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "qwen3-4b", "--device", "cuda", "--steps", "6",
              "--batch", "8", "--seq", "512", "--microbatches", "2",
              "--warmup", "2", "--log-every", "1"]
TRAIN_REMAT_LAYERS = 4        # qwen3-4b at full width, one step a mode
TRAIN_REMAT_BATCH = (4, 512)
TRAIN_RESUME_LAYERS = 2       # ~6 GB of checkpoint (36 layers: ~40 GB)
TRAIN_RESUME_ARGV = ["--arch", "qwen3-4b", "--device", "cuda", "--layers",
                     str(TRAIN_RESUME_LAYERS), "--steps", "4", "--batch",
                     "8", "--seq", "512", "--microbatches", "2",
                     "--warmup", "2", "--log-every", "1"]
TRAIN_MOE_ARGV = ["--arch", "deepseek-moe-16b", "--device", "cuda",
                  "--layers", "4", "--steps", "3", "--batch", "8", "--seq",
                  "512", "--microbatches", "2", "--warmup", "2",
                  "--log-every", "1"]
# bf16 gradients of one step, each remat mode against "none": the modes
# recompute the same ops on the same values, so any difference is the
# card's choice of kernels for a recomputed op; bound: a share of the
# leaf's largest gradient (one bf16 ulp is 2^-8 of a value)
TRAIN_REMAT_GRAD_SHARE = 2.0 ** -7
# float32 reduced archs, one make_train_step (2 microbatches) on the card
# against the same step on the CPU, in two halves. The gradients the step
# hands its optimizer: |card - CPU| <= 1e-6 x the CPU's global gradient
# norm + 1e-4 x max|CPU leaf| + 1e-3 x |CPU| (tests/torch_lm_grad_common.py's
# GRAD_TOL with its absolute 1e-5 made a share of the norm: a gradient's
# error scales with the whole backward's, and the xLSTM's norm reaches
# ~790 at this batch, where its gradients differ by up to 5.09e-4 on an
# H100); the metrics at LM_REDUCED_TOL. Then the optimizer: the CPU's
# ``update_`` run on the card's own gradients, clipped by the card's own
# global norm (adamw's clip_norm 1.0; one ulp of the clip scale moves the
# state by thousands of ulps where an update cancels), gives the card's
# moments and parameters within TRAIN_REPLAY_ULPS float32 ulps, a
# parameter's in ulps of the update's operands (|p| + lr: p - lr u may
# cancel, and a rounding at the operands' scale is many ulps of a small
# result). On an H100 the moments agree bitwise and a few parameters a
# leaf by 1-2 ulps (u's division or square root rounds differently).
# The parameters are not held to the CPU's directly: AdamW's first step
# moves each by lr x g / (|g| + eps) whatever g's size, so a gradient
# near 0 that differs in its last bits moves it by up to 2 lr (jamba's
# w_gate by 1.13e-4 on an H100); the largest direct difference is logged.
TRAIN_GRAD_TOL = (1e-6, 1e-4, 1e-3)   # of the norm, of the leaf max, rel
TRAIN_REPLAY_ULPS = 4
TRAIN_REDUCED_SCHEDULE = (1e-3, 1, 4)    # peak, warmup, total
TRAIN_REDUCED_BATCH = (4, 16)


def train_model_flops(cfg, tokens: int) -> float:
    """The reference dry-run's model FLOPs of a train step
    (``repro/launch/dryrun.py``): 6 x active non-embedding parameters x
    tokens."""
    from repro_torch.models import lm
    counts = lm.count_params(cfg)
    return 6.0 * (counts["active"] - counts["embed"]) * tokens


def check_train_rows(history, steps, label):
    """``steps`` history rows, each with finite loss, ce and grad_norm
    -> the rows' step times (s)."""
    if [r["step"] for r in history] != list(range(steps)):
        raise AssertionError(f"{label}: rows of steps "
                             f"{[r['step'] for r in history]}")
    for r in history:
        if not all(math.isfinite(r[k]) for k in ("loss", "ce",
                                                  "grad_norm")):
            raise AssertionError(f"{label}: non-finite row {r}")
    return [r["step_time_s"] for r in history]


def steady_s(times):
    """The median step time without the first step (lazy loads, the
    allocator's first blocks)."""
    return statistics.median(times[1:] if len(times) > 1 else times)


def changed_share(before, after):
    """-> (share of all elements that changed, [paths of the matrices
    (``w`` / ``table`` leaves) that did not change at all])."""
    from repro_torch.tree import tree_leaves_with_path
    ref = dict(tree_leaves_with_path(before))
    n = changed = 0
    still = []
    for path, x in tree_leaves_with_path(after):
        d = int((x != ref[path]).sum())
        n += x.numel()
        changed += d
        if d == 0 and (path.endswith("['w']") or path.endswith("['table']")
                       or "experts" in path):
            still.append(path)
    return changed / max(n, 1), still


def grad_share(a, b):
    """max |a - b| over max |b| (0 for an all-zero ``b``)."""
    scale = float(b.float().abs().max())
    err = float((a.float() - b.float()).abs().max())
    return err / scale if scale > 0 else err


class _SigtermAfter:
    """A real SIGTERM to this process once the training guard's call at
    ``step`` returned: the driver trains the next step, flushes a
    checkpoint at the call after it and exits cleanly."""

    def __init__(self, step):
        self.step = step

    def __enter__(self):
        import os
        import signal
        from repro_torch.distributed import fault_tolerance as ft
        self._cls, self._real = ft.TrainingGuard, ft.TrainingGuard.maybe_save
        real, at = self._real, self.step

        def save_then_signal(guard, step, state, **kw):
            saved = real(guard, step, state, **kw)
            if step == at:
                os.kill(os.getpid(), signal.SIGTERM)
            return saved
        ft.TrainingGuard.maybe_save = save_then_signal
        return self

    def __exit__(self, *exc):
        self._cls.maybe_save = self._real


def _peak_reset(dev):
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def _train_qwen(dev, card):
    """Part (a): ``launch/train`` at qwen3-4b's full width and depth."""
    import torch
    from repro_torch import stream
    from repro_torch.distributed import op_analysis
    from repro_torch.launch import train
    from repro_torch.models import lm
    _peak_reset(dev)
    t0 = time.perf_counter()
    res = train.run(train.parse_args(TRAIN_ARGV))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, args = res["cfg"], train.parse_args(TRAIN_ARGV)
    times = check_train_rows(res["history"], args.steps, "train qwen3-4b")
    tokens = args.batch * args.seq
    flops = train_model_flops(cfg, tokens)
    peak_flops = op_analysis.peak_flops(torch.bfloat16)
    for r in res["history"]:
        log(f"[train] qwen3-4b step {r['step']}: loss {r['loss']:.5f} "
            f"grad_norm {r['grad_norm']:.4f} step_time_s "
            f"{r['step_time_s']} [{card}]; tokens/s "
            f"{tokens / r['step_time_s']:.1f}; model-FLOP share "
            f"{flops / r['step_time_s'] / peak_flops:.4f}")
    steady = steady_s(times)
    log(f"[train] {' '.join(TRAIN_ARGV)} (remat {cfg.remat}, "
        f"{cfg.n_layers} layers, {cfg.param_dtype}): steady step_time_s "
        f"{steady:.4f} [{card}]; tokens/s {tokens / steady:.1f}; model "
        f"FLOPs a step {flops:.4g} (6 x (active - embed) x {tokens} "
        f"tokens), bound {flops / peak_flops * 1e3:.2f} ms at "
        f"{peak_flops:.4g} FLOP/s; model-FLOP share "
        f"{flops / steady / peak_flops:.4f}; max_memory_allocated {peak} "
        f"B [{card}]; wall {wall:.2f} s (init included)")
    idle = _train_step_profile(res, args, dev, card, steady)
    params = res["state"]["params"]
    del res
    with torch.no_grad():
        init = lm.init_params(cfg, stream(dev, args.seed,
                                          train.TAG_PARAMS))
        share, still = changed_share(init, params)
    del init, params
    log(f"[train] qwen3-4b: {share:.4f} of the parameters' elements "
        f"changed over {args.steps} steps; matrices unchanged: "
        f"{still or 'none'}")
    if still or share <= 0.5:
        raise AssertionError(f"train qwen3-4b: parameters did not change "
                             f"({share:.4f}; unchanged {still})")
    return {"step_time_s": steady, "peak": peak, "idle": idle}


KERNEL_KINDS = (("gemm", ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                          "nvjet")),
                ("reduce", ("reduce", "softmax", "norm")),
                ("elementwise", ("elementwise", "vectorized", "unrolled")),
                ("copy", ("memcpy", "memset", "copy", "cat", "index")))


def kernel_kind(name):
    """A device event's name -> gemm | reduce | elementwise | copy |
    other (by substrings, in that order)."""
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def busy_us(events):
    """The union of the events' device intervals, in us."""
    total, end = 0.0, -math.inf
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _train_step_profile(res, args, dev, card, steady):
    """More train steps on the run's final state: one under
    ``torch.profiler`` (``profile_calls``): the device's busy time (the
    union of its events) over the unprofiled steady step -> the idle
    share, the device time by kind and the heaviest kernels; then one
    with CUDA events around the optimizer's in-place update."""
    import collections
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim.adamw import adamw, cosine_schedule
    cfg, state = res["cfg"], res["state"]
    step = steps_lib.make_train_step(
        cfg, adamw(cosine_schedule(args.lr, args.warmup, args.steps)),
        args.microbatches)
    b = TokenPipeline(DataConfig(args.seq, args.batch, cfg.vocab_size,
                                 seed=args.seed)).get_batch(args.steps)
    batch = {k: torch.from_numpy(v.copy()).to(dev, dtype=torch.long)
             for k, v in b.items()}

    def one():
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
    got = profile_calls(one, 1)
    # the optimizer's own device time: one more step with CUDA events
    # around its update
    box = {}
    step = steps_lib.make_train_step(
        cfg, _timed_update(adamw(cosine_schedule(
            args.lr, args.warmup, args.steps)), box), args.microbatches)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    opt_s = box["start"].elapsed_time(box["end"]) / 1e3
    log(f"[train] qwen3-4b AdamW update_ in place (4.02 B parameters, "
        f"float32 moments): {opt_s:.4f} s of a {wall:.4f} s step "
        f"(CUDA events) [{card}]")
    if got is None:
        log("[train] qwen3-4b step profile: not measured")
        return None
    events, wall = got
    busy = busy_us(events) / 1e6
    kinds = collections.Counter()
    names = collections.Counter()
    for e in events:
        us = e.time_range.elapsed_us()
        kinds[kernel_kind(e.name)] += us
        names[e.name[:60]] += us
    total = sum(kinds.values())
    idle = max(0.0, 1.0 - busy / steady)
    log(f"[train] qwen3-4b step profile (torch.profiler, one step): "
        f"{len(events)} device events, busy {busy:.4f} s (union) of the "
        f"steady {steady:.4f} s step: idle share {idle:.4f} [{card}]; "
        f"profiled step wall {wall:.4f} s; device time by kind "
        f"{ {k: round(v / total, 4) for k, v in kinds.most_common()} }; "
        f"heaviest {[(n, round(v / 1e3, 2)) for n, v in names.most_common(6)]}"
        f" (ms)")
    return idle


def _timed_update(opt, box):
    """``opt`` whose ``update_`` records CUDA events before and after it
    in ``box``."""
    import torch

    def update_(grads, state, params):
        box["start"] = torch.cuda.Event(enable_timing=True)
        box["end"] = torch.cuda.Event(enable_timing=True)
        box["start"].record()
        out = opt.update_(grads, state, params)
        box["end"].record()
        return out
    return opt._replace(update_=update_)


def _remat_modes(dev, card):
    """Part (b1): one step's loss and gradients of qwen3-4b at full width,
    ``TRAIN_REMAT_LAYERS`` layers, in each remat mode, and the peak bytes
    of each."""
    import torch
    from repro_torch import stream
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_unflatten
    base = get_config("qwen3-4b").with_overrides(
        n_layers=TRAIN_REMAT_LAYERS)
    B, T = TRAIN_REMAT_BATCH
    params = lm.init_params(base, stream(dev, 0, 0))
    g = torch.Generator()
    g.manual_seed(21)
    toks = torch.randint(0, base.vocab_size, (B, T + 1), generator=g).to(dev)
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:]}
    leaves = tree_leaves(params)
    peaks, shares = {}, {}
    ref = None
    for mode in ("none", "full", "dots", "names"):
        cfg = base.with_overrides(remat=mode)
        live = [x.detach().requires_grad_() for x in leaves]
        _peak_reset(dev)
        start = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        loss, _ = lm.loss_fn(tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        # above what was allocated before (the weights, none's gradients)
        peaks[mode] = torch.cuda.max_memory_allocated(dev) - start
        loss = loss.detach()
        if ref is None:
            ref = (loss, grads)
        if not torch.equal(loss, ref[0]):
            raise AssertionError(f"remat {mode}: loss {float(loss)!r} vs "
                                 f"none {float(ref[0])!r}")
        shares[mode] = max(grad_share(a, b) for a, b in zip(grads, ref[1]))
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, ref[1]))
        log(f"[train] remat {mode} (qwen3-4b full width, "
            f"{TRAIN_REMAT_LAYERS} layers, B = {B}, T = {T}, bf16): loss "
            f"{float(loss):.6f}, gradients vs none: bitwise {bitwise}, max "
            f"share of the leaf's largest {shares[mode]:.3g} (bound "
            f"{TRAIN_REMAT_GRAD_SHARE:.3g}); forward + backward {dt:.4f} s "
            f"[{card}]; peak bytes above the weights "
            f"(max_memory_allocated - memory_allocated before) "
            f"{peaks[mode]} B [{card}]")
        del live, loss, grads
    del ref, params, leaves
    if max(shares.values()) > TRAIN_REMAT_GRAD_SHARE:
        raise AssertionError(f"remat gradients differ from none: {shares}")
    if not peaks["full"] < peaks["none"]:
        raise AssertionError(f"remat full peaks at {peaks['full']} B, not "
                             f"below none's {peaks['none']} B")
    return peaks


def _train_resume(dev, card):
    """Part (b2): ``launch/train`` at qwen3-4b's width cut to
    ``TRAIN_RESUME_LAYERS`` layers: 4 steps uninterrupted; 2 steps, a
    SIGTERM, the flushed checkpoint, resumed for 2 more -> the state of
    both bitwise equal."""
    import tempfile
    import torch
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    full = train.run(train.parse_args(TRAIN_RESUME_ARGV))
    check_train_rows(full["history"], 4, "resume: uninterrupted")
    want = [x.cpu() for x in tree_leaves((full["state"]["params"],
                                          full["state"]["opt"]))]
    del full
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ck:
        argv = TRAIN_RESUME_ARGV + ["--ckpt-dir", ck, "--save-every", "100"]
        t0 = time.perf_counter()
        with _SigtermAfter(1):
            part = train.run(train.parse_args(argv))
        t_part = time.perf_counter() - t0
        if not part["preempted"] or len(part["history"]) != 2:
            raise AssertionError(f"resume: the SIGTERM'd run did not stop "
                                 f"after 2 steps ({len(part['history'])})")
        del part
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = train.run(train.parse_args(argv))
        t_res = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(ck).rglob("*")
                   if f.is_file())
    if res["start_step"] != 2 or [r["step"] for r in res["history"]] != \
            [2, 3]:
        raise AssertionError(f"resume: started at {res['start_step']}")
    got = tree_leaves((res["state"]["params"], res["state"]["opt"]))
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
    log(f"[train] resume (qwen3-4b full width, {TRAIN_RESUME_LAYERS} "
        f"layers): 2 steps + SIGTERM + flush in {t_part:.2f} s, resumed "
        f"2 steps in {t_res:.2f} s (restore included) [{card}]; "
        f"checkpoints on disk {size} B; {len(differ)} of {len(got)} "
        f"state leaves differ from the uninterrupted run")
    if differ:
        raise AssertionError(f"resume: {len(differ)} state leaves differ "
                             f"from the uninterrupted 4-step run")


def _train_moe(dev, card):
    """Part (c): ``launch/train`` at deepseek-moe-16b's full width (64
    experts, top 6, the config's capacity factor) cut to 4 layers, then
    the router's gradient at the trained state."""
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves_with_path, tree_unflatten
    _peak_reset(dev)
    args = train.parse_args(TRAIN_MOE_ARGV)
    res = train.run(args)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = res["cfg"]
    times = check_train_rows(res["history"], args.steps, "train moe")
    counts = lm.count_params(cfg)
    for step, m in enumerate(res["metrics"]):
        log(f"[train] deepseek-moe-16b step {step}: loss {m['loss']:.5f} "
            f"lb_loss {m['lb_loss']:.5f} z_loss {m['z_loss']:.4f} "
            f"drop_frac {m['drop_frac']:.5f} grad_norm "
            f"{m['grad_norm']:.4f} step_time_s {times[step]} [{card}]")
        if not (math.isfinite(m["loss"]) and m["lb_loss"] > 0):
            raise AssertionError(f"train moe step {step}: {m}")
    # the router's gradient at the trained state, on a microbatch of
    # step 0's batch
    params = res["state"]["params"]
    b = TokenPipeline(DataConfig(args.seq, args.batch, cfg.vocab_size,
                                 seed=args.seed)).get_batch(0)
    n = args.batch // args.microbatches
    mb = {k: torch.from_numpy(v[:n].copy()).to(dev, dtype=torch.long)
          for k, v in b.items()}
    with_paths = tree_leaves_with_path(params)
    live = [x.detach().requires_grad_() if p.endswith("['router']") else x
            for p, x in with_paths]
    routers = [x for x in live if x.requires_grad]
    loss, _ = lm.loss_fn(tree_unflatten(params, live), cfg, mb)
    norms = [float(layer.float().norm())      # a stacked router by layer
             for g in torch.autograd.grad(loss, routers)
             for layer in (g if g.dim() == 3 else g[None])]
    del res, params, live, routers, loss
    tokens = args.batch * args.seq
    log(f"[train] {' '.join(TRAIN_MOE_ARGV)} (reduced: depth 28 -> "
        f"{cfg.n_layers} layers, the dense first and "
        f"{cfg.n_layers - cfg.first_k_dense} MoE layers of "
        f"{cfg.n_routed_experts} experts, top {cfg.moe_top_k}, capacity "
        f"factor {cfg.capacity_factor}; {counts['total']:.0f} parameters, "
        f"{counts['active']:.0f} active): steady step_time_s "
        f"{steady_s(times):.4f} [{card}]; tokens/s "
        f"{tokens / steady_s(times):.1f}; max_memory_allocated {peak} B "
        f"[{card}]; router gradient norms per MoE layer {norms}")
    if len(norms) != cfg.n_layers - cfg.first_k_dense or \
            not all(math.isfinite(x) and x > 0 for x in norms):
        raise AssertionError(f"train moe: router gradients {norms}")
    return {"peak": peak, "step_time_s": steady_s(times)}


def _train_reduced_all(dev):
    """Part (d): every arch at ``reduced()``, float32: one
    ``make_train_step`` (2 microbatches, cosine AdamW) on the card and on
    the CPU from the same weights and batch: the gradients handed to the
    optimizer and the metrics against the CPU's, then the CPU's update
    on the card's gradients against the card's parameters and moments."""
    import torch
    from repro_torch.configs.base import get_config, list_configs, reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import modality_inputs
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw, cosine_schedule
    from repro_torch.tree import tree_leaves, tree_map
    B, T = TRAIN_REDUCED_BATCH
    worst = {}
    for i, arch in enumerate(list_configs()):
        cfg = reduced(get_config(arch))
        g = torch.Generator()
        g.manual_seed(200 + i)
        cpu = _perturb_constants(lm.init_params(cfg, g, device="cpu"), g)
        batch = TokenPipeline(DataConfig(T, B, cfg.vocab_size,
                                         seed=i)).get_batch(0)
        outs = {}
        for where in ("cpu", dev):
            opt = adamw(cosine_schedule(*TRAIN_REDUCED_SCHEDULE))
            seen = {}
            step = steps_lib.make_train_step(cfg, _handing(opt, seen), 2)
            p = tree_map(lambda x: x.to(where).clone(), cpu)
            b = {k: torch.from_numpy(v.copy()).to(where, dtype=torch.long)
                 for k, v in batch.items()}
            b.update(modality_inputs(cfg, B, where))
            p, st, m = step(p, opt.init(p), b)
            outs[str(where)] = dict(state=(p, st.mu, st.nu), m=m,
                                    grads=seen["grads"])
        card, host = outs[str(dev)], outs["cpu"]
        norm = float(host["m"]["grad_norm"])
        shares = {"grads": max(
            grad_tol_share(x, y, TRAIN_GRAD_TOL, norm, f"{arch} gradient")
            for x, y in zip(tree_leaves(card["grads"]),
                            tree_leaves(host["grads"])))}
        shares["metrics"] = max(
            _lm_near(card["m"][k], host["m"][k], f"{arch} {k}")
            for k in host["m"])
        # the optimizer: the CPU's update on the card's gradients, clipped
        # by the card's own global norm (its sum runs in another order
        # on the CPU, and one ulp of the clip scale moves the state by
        # up to 10^4 ulps where an update cancels)
        scale = torch.clamp(1.0 / torch.clamp(card["m"]["grad_norm"].cpu(),
                                              min=1e-9), max=1.0)
        clipped = tree_map(lambda x: x * scale, card["grads"])
        opt = adamw(cosine_schedule(*TRAIN_REDUCED_SCHEDULE),
                    clip_norm=math.inf)
        p0 = tree_map(lambda x: x.clone(), cpu)
        p, st, _ = opt.update_(clipped, opt.init(p0), p0)
        # a parameter in ulps of the update's operands, |p| + lr (>=
        # |lr u| at the first step: p - lr u may cancel, and a rounding
        # at the operands' scale is many ulps of a small result); the
        # moments in ulps of their own
        lr = float(host["m"]["lr"])
        shares["replay_ulps"] = max(
            ulps(x, y, f"{arch} state", scale=z)
            for x, y, z in zip(tree_leaves(card["state"]),
                               tree_leaves((p, st.mu, st.nu)),
                               tree_leaves((tree_map(lambda w: w.abs() + lr,
                                                     cpu), st.mu, st.nu))))
        if shares["replay_ulps"] > TRAIN_REPLAY_ULPS:
            raise AssertionError(f"{arch}: the card's AdamW update is "
                                 f"{shares['replay_ulps']} ulps off the "
                                 f"CPU's on the same gradients")
        shares["params_direct"] = max(
            float((x.cpu() - y).abs().max()) for x, y in
            zip(tree_leaves(card["state"][0]),
                tree_leaves(host["state"][0])))
        worst[arch] = {k: float(f"{v:.4g}") for k, v in shares.items()}
    log(f"[train] reduced archs, one train step card vs CPU (float32, 2 "
        f"microbatches; gradients within {TRAIN_GRAD_TOL} = (share of "
        f"the global norm, of the leaf max, rtol), metrics within "
        f"{LM_REDUCED_TOL}, the "
        f"card's parameters and moments within {TRAIN_REPLAY_ULPS} ulps "
        f"of the CPU's update on the card's gradients; params_direct: "
        f"max |card - CPU| of the parameters, not gated): worst share of "
        f"the bound {worst}")
    return worst


def _handing(opt, seen):
    """``opt`` whose ``update_`` first keeps a CPU copy of the gradients
    it is handed (it overwrites them) in ``seen["grads"]``."""
    from repro_torch.tree import tree_map

    def update_(grads, state, params):
        seen["grads"] = tree_map(lambda x: x.detach().cpu().clone(), grads)
        return opt.update_(grads, state, params)
    return opt._replace(update_=update_)


def grad_tol_share(a, b, tol, norm, what):
    """``a`` (the card's) within ``tol`` = (share of ``norm``, share of
    max|b|, rtol) of ``b`` -> the largest share of the bound used."""
    import torch
    af, bf = a.detach().float().cpu(), b.detach().float().cpu()
    if af.shape != bf.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(af.shape)} {a.dtype} vs "
                             f"{tuple(bf.shape)} {b.dtype}")
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{what}: non-finite on the card")
    if not af.numel():
        return 0.0
    top = float(bf.abs().max())
    bound = tol[0] * norm + tol[1] * top + tol[2] * bf.abs()
    share = (af - bf).abs() / bound
    if bool((share > 1).any()):
        k = int(share.reshape(-1).argmax())
        raise AssertionError(
            f"{what}: card vs CPU |diff| "
            f"{float((af - bf).abs().reshape(-1)[k]):.3g} at a CPU value "
            f"{float(bf.reshape(-1)[k]):.3g} (leaf max {top:.3g}, norm "
            f"{norm:.4g}) above {tol}")
    return float(share.max())


def ulps(a, b, what, scale=None):
    """The largest |a - b| in float32 ulps of max(|b|, |scale|) (``a``
    finite, of ``b``'s shape and dtype)."""
    import numpy as np
    import torch
    af, bf = a.detach().cpu(), b.detach().cpu()
    if af.shape != bf.shape or af.dtype != bf.dtype:
        raise AssertionError(f"{what}: {tuple(af.shape)} {af.dtype} vs "
                             f"{tuple(bf.shape)} {bf.dtype}")
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{what}: non-finite on the card")
    if not af.numel():
        return 0.0
    mag = bf.abs() if scale is None else torch.maximum(
        bf.abs(), scale.detach().cpu().abs())
    spacing = torch.from_numpy(np.spacing(mag.float().numpy()))
    return float(((af.double() - bf.double()).abs()
                  / spacing.double()).max())


@phase("LM training: launch/train at full width")
def phase_train(dev, card):
    """LM training (``launch/train``, ``launch/steps.py``,
    ``optim/adamw.py``'s in-place update, ``models/lm.py``'s remat): (a)
    qwen3-4b at full width and depth, (b) the remat modes and a resume at
    full width, cut in depth, (c) deepseek-moe-16b's 64-expert backward,
    (d) every reduced arch's train step against the CPU. The LM trains
    through the ``nn`` functions, as the reference's through its XLA
    path: no kernel launch counter may move."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    torch.empty(1, device=dev)
    before = dict(cuda.LAUNCHES)
    parts = {}
    for name, fn in (("(a) train qwen3-4b", lambda: _train_qwen(dev, card)),
                     ("(b) remat modes", lambda: _remat_modes(dev, card)),
                     ("(b) resume", lambda: _train_resume(dev, card)),
                     ("(c) train deepseek-moe-16b, 4 layers",
                      lambda: _train_moe(dev, card)),
                     ("(d) reduced archs", lambda: _train_reduced_all(dev))):
        t0 = time.perf_counter()
        fn()
        parts[name] = round(time.perf_counter() - t0, 2)
        torch.cuda.empty_cache()
    moved = {k: v - before[k] for k, v in cuda.LAUNCHES.items()
             if v != before[k]}
    log(f"[train] part times (s): {parts}; kernel launches during the "
        f"phase: {moved or 'none'}")
    if moved:
        raise AssertionError(f"the LM training path launched kernels: "
                             f"{moved}")


# phase 10: the LM's sharding. (a) dry-run cells, each counted in a
# process of its own (rank 0 of a fake process group, fake tensors, the
# CPU), all started together at the phase's start
LM_DRYRUN_CELLS = (("qwen3-4b", "train_4k", "pod1"),
                   ("deepseek-moe-16b", "train_4k", "pod1"),
                   ("qwen3-4b", "decode_32k", "pod2"),
                   ("whisper-base", "train_4k", "pod1"),
                   ("whisper-base", "decode_32k", "pod2"))
LM_DRYRUN_TIMEOUT_S = 600
# (b) the sharded train step at qwen3-4b's full width, cut to 2 layers,
# float32: (ranks, model axis, profile). Two of the four combinations: 2
# ranks on "tp" passed alone but would put the script past its limit
# (~190-250 s a run), and 4 ranks on "fsdp_only" do not fit the card
# (the rule replicates the 1.56 GB float32 embedding and its gradient on
# every rank: 78.7 GiB over the four)
LM_SHARD_ARGV = ["--arch", "qwen3-4b", "--layers", "2", "--batch", "8",
                 "--seq", "512", "--microbatches", "2", "--steps", "2",
                 "--what", "train"]
LM_SHARD_RUNS = ((2, 1, "fsdp_only"), (4, 2, "tp"))
# (c) one MoE layer of deepseek-moe-16b at full width (64 experts, top 6,
# 2 shared), dropless, on 4 ranks (data 2, model 2)
LM_EP_ARGV = ["--arch", "deepseek-moe-16b", "--batch", "8", "--seq", "512",
              "--what", "ep"]
LM_SHARD_TIMEOUT_S = 480
# (d) one layer of each recurrent mixer at full width on 4 ranks (data 2,
# model 2), float32, in one launch (reduced: the depth, 72 -> 1 Mamba
# layer, 48 -> 1 mLSTM and 1 sLSTM layer), B = 2 x 512: four Mamba scan
# chunks, two mLSTM chunks
LM_MIXER_ARCHS = ("jamba-1.5-large-398b", "xlstm-1.3b")
LM_MIXER_ARGV = ["--arch", ",".join(LM_MIXER_ARCHS), "--batch", "2",
                 "--seq", "512", "--what", "mixers", "--model", "2"]


def lm_dryrun_line(cell) -> str:
    """A counted LM cell's line; raises unless it is ``ok`` with
    collective bytes above 0 and its model-FLOP bound."""
    name = f"{cell['arch']} {cell['shape']} {cell['mesh']}"
    if cell.get("status") != "ok":
        raise AssertionError(f"dry-run {name}: {cell.get('status')}: "
                             f"{str(cell.get('stderr', ''))[-2000:]}")
    ops, r, mem = cell["ops"], cell["roofline"], cell["memory"]
    if not ops["collective_bytes_total"] > 0:
        raise AssertionError(f"dry-run {name}: no collective counted")
    if ops["custom_call_count"]:
        raise AssertionError(f"dry-run {name}: {ops['custom_call_count']} "
                             f"kernel launches counted")
    coll = ", ".join(f"{k} {v / 2**30:.3f}" for k, v in
                     sorted(ops["collective_bytes"].items()))
    trips = cell["trips"]
    points = sorted({tuple(p[k] for k in trips if k != "points")
                     for p in trips["points"]})
    loops = ", ".join(f"{k} {v}" for k, v in trips.items() if k != "points")
    return (f"[dryrun] {name} ({cell['n_chips']} chips, "
            f"{cell['parallelism']}): counted in {cell['count_s']:.1f} s, "
            f"{cell['counted_by']} (trips: {loops}; counted at "
            f"{points}); "
            f"per device: {ops['flops']:.4g} FLOPs, HBM "
            f"{ops['hbm_bytes'] / 2**30:.2f} GiB (unfused), collectives "
            f"GiB {{{coll}}}; argument bytes "
            f"{mem['argument_bytes_per_device']} (global over chips "
            f"{mem['argument_bytes_global_over_chips']:.0f}); model-FLOP "
            f"bound {r['model_flops_bound_s']:.4g} s, roofline "
            f"{r['step_time_lower_bound_s']:.4g} s ({r['bottleneck']}), "
            f"useful FLOPs {r['useful_flops_ratio']:.3f}")


def lm_shard_line(s, label) -> str:
    """A ``tools/torch_lm_shard_smoke.py`` summary's line; raises on a
    failed check, on a rank whose bytes are not the global bytes over its
    shards, or on a kernel launch."""
    if not s.get("ok") or s.get("failed"):
        raise AssertionError(f"LM shard smoke {label}: {s.get('failed')}")
    for r, pr in enumerate(s["per_rank"]):
        if pr["kernel_launches"]:
            raise AssertionError(f"LM shard smoke {label}: rank {r} "
                                 f"launched {pr['kernel_launches']} kernels")
        for k in ("param", "moment"):
            if pr[f"{k}_bytes"] is not None and \
                    pr[f"{k}_bytes"] != pr[f"{k}_bytes_expected"]:
                raise AssertionError(
                    f"LM shard smoke {label}: rank {r} holds "
                    f"{pr[f'{k}_bytes']} {k} bytes, not "
                    f"{pr[f'{k}_bytes_expected']}")
    worst = ", ".join(f"{k} {v:.3g}" for k, v in s["worst_share"].items())
    out = f"[lmshard] {label}: every check within its bound (worst share " \
          f"of the bound: {worst})"
    if "steady_step_s" in s:
        per = s["per_rank"]
        out += (f"; per rank: parameter bytes "
                f"{[p['param_bytes'] for p in per]}, moment bytes "
                f"{[p['moment_bytes'] for p in per]}, max_memory_allocated "
                f"{[p['max_memory_allocated'] for p in per]}; step s "
                f"{[round(t, 3) for t in s['step_s']]}, steady "
                f"{s['steady_step_s']:.3f} s beside one process "
                f"{s['one_process_step_s'][-1]:.3f} s; loss (sharded, one "
                f"process) {s['loss']}")
    for kind, r in s.get("mixers", {}).items():
        for rank, pr in enumerate(s["per_rank"]):
            got, want = pr["mixer_bytes"][kind]
            if got != want:
                raise AssertionError(
                    f"LM shard smoke {label}: rank {rank} holds {got} bytes "
                    f"of the {kind} layer's weights, not {want}")
        out += (f"; {kind}: forward + backward {r['fwd_bwd_s']:.3f} s (one "
                f"process {r['one_process_s']:.3f} s), the layer's weight "
                f"bytes per rank "
                f"{[p['mixer_bytes'][kind][0] for p in s['per_rank']]} "
                f"(global over shards "
                f"{s['per_rank'][0]['mixer_bytes'][kind][1]})")
    if "ep_fwd_err" in s:
        out += (f"; EP forward max |diff| {s['ep_fwd_err']:.3g}, gradients "
                f"{s['ep_grad_err']:.3g}, drop_frac {s['ep_drop_frac']}, "
                f"forward + backward {s['ep_fwd_bwd_s']:.3f} s")
    return out


def _lm_shard(world, argv, label, tmp):
    out = Path(tmp) / f"lmshard_{label.replace(' ', '_')}.json"
    _ranks(world, ["tools/torch_lm_shard_smoke.py", "--device", "cuda",
                   "--json", str(out), *argv],
           f"LM shard smoke {label}", timeout=LM_SHARD_TIMEOUT_S)
    line = lm_shard_line(json.loads(out.read_text()), label)
    log(line)
    return line


class LmDryrunCells:
    """Phase 10 (a)'s dry-run cells, each counted by ``launch/dryrun.py``
    in a process of its own on the CPU (no kernel, no card): started at
    the phase's start, so the counts overlap (b)-(d) (whose step
    times are then taken beside them; phases 8 and 9, which report
    host-bound times, run alone), and read at its end."""

    def __init__(self):
        import os
        import tempfile
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env["OMP_NUM_THREADS"] = "1"
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", sh, "--mesh", m, "--out", self.tmp], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True,
            # below the ranks of (b)-(d), which share the host's cores
            preexec_fn=lambda: os.nice(19))
            for a, sh, m in LM_DRYRUN_CELLS]

    def read(self) -> float:
        """Wait for every cell and log its line -> the seconds waited."""
        t0 = time.perf_counter()
        for (a, sh, m), proc in zip(LM_DRYRUN_CELLS, self.procs):
            text, _ = proc.communicate(timeout=LM_DRYRUN_TIMEOUT_S)
            fn = Path(self.tmp) / f"{a}__{sh}__{m}.json"
            if proc.returncode != 0 or not fn.exists():
                errors = [ln for ln in text.splitlines() if "Error" in ln]
                raise AssertionError(
                    f"dry-run {a} {sh} {m} exited {proc.returncode}:\n"
                    + "\n".join(errors[:20]) + f"\n{text[-4000:]}")
            log(lm_dryrun_line(json.loads(fn.read_text())))
        log(f"[dryrun] the five cells counted in "
            f"{time.perf_counter() - self.t0:.1f} s since their start")
        return time.perf_counter() - t0

    def close(self):
        import os
        import shutil
        for proc in self.procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        shutil.rmtree(self.tmp, ignore_errors=True)


@phase("LM sharding: dry-run cells, sharded steps on ranks, the EP route")
def phase_lm_sharding(dev, card):
    """The LM's sharding (``distributed/act_sharding.py``,
    ``distributed/sharding.py``'s LM half, ``nn/moe_ep.py``'s mesh route,
    ``launch/specs.py``, ``launch/dryrun.py``'s LM cells): (a) the
    dry-run's cells counted (on the CPU, beside (b) and (c)), (b)
    qwen3-4b's sharded train step on ranks against the one-process step,
    (c) the expert-parallel route at deepseek-moe-16b's width, (d) the
    recurrent mixers on "model" at jamba's and xlstm's widths; no kernel
    launches."""
    import tempfile
    import torch
    from repro_torch.kernels import aip_step as cuda
    before = dict(cuda.LAUNCHES)
    parts = {}
    t_phase = time.perf_counter()
    cells = LmDryrunCells()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
            t0 = time.perf_counter()
            for world, model, profile in LM_SHARD_RUNS:
                _lm_shard(world, LM_SHARD_ARGV + [
                    "--model", str(model), "--profile", profile],
                    f"(b) qwen3-4b 2 layers {profile} {world} ranks "
                    f"(data {world // model}, model {model})", tmp)
            parts["(b) sharded train steps"] = round(
                time.perf_counter() - t0, 2)
            t0 = time.perf_counter()
            _lm_shard(4, LM_EP_ARGV + ["--model", "2"],
                      "(c) deepseek-moe-16b MoE layer, EP on 4 ranks "
                      "(data 2, model 2)", tmp)
            parts["(c) EP route"] = round(time.perf_counter() - t0, 2)
            t0 = time.perf_counter()
            # (c) and (d) side by side do not fit the card's 80 GB
            _lm_shard(4, LM_MIXER_ARGV, "(d) one layer of each mixer of "
                      "jamba-1.5-large-398b and xlstm-1.3b on model, 4 ranks "
                      "(data 2, model 2)", tmp)
            parts["(d) mixers on model"] = round(time.perf_counter() - t0,
                                                 2)
        parts["(a) dry-run cells, waited for after (b)-(d)"] = round(
            cells.read(), 2)
    finally:
        cells.close()
    moved = {k: v - before[k] for k, v in cuda.LAUNCHES.items()
             if v != before[k]}
    log(f"[lmshard] {card}; part times (s): {parts}, phase "
        f"{time.perf_counter() - t_phase:.1f}; kernel launches during the "
        f"phase: {moved or 'none'}")
    if moved:
        raise AssertionError(f"the LM sharding path launched kernels: "
                             f"{moved}")
    torch.cuda.empty_cache()


def _near(a, b, tols, what):
    """``a`` finite, of ``b``'s shape and dtype, and within the dtype's
    tolerance of it (``tols`` = (f32, bf16); bf16 also one bf16 ulp of
    ``b``) -> the max abs difference."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    af, bf = a.float(), b.float()
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{what}: non-finite output")
    is_bf16 = a.dtype == torch.bfloat16
    tol, rtol = tols[is_bf16], (BF16_RTOL if is_bf16 else 0.0)
    diff = (af - bf).abs()
    if bool((diff > tol + rtol * bf.abs()).any()):
        raise AssertionError(f"{what}: max error {float(diff.max()):.3g} "
                             f"above {tol} (+ {rtol} x |reference|)")
    return float(diff.max())


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False; this check "
                           "needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_build()
    recs = phase_kernels(dev)
    launches, main_runs = phase_main_path()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_keep_") as keep:
        ckpt_at_1 = str(Path(keep) / "traffic_at_1")
        phase_grid(dev, main_runs, ckpt_at_1)
        phase_ranks(main_runs, ckpt_at_1)
    launches.update(phase_engine(dev))
    launches.update(phase_scalar(dev))
    phase_analysis(dev)
    recs.update(phase_serve_kernels(dev))
    launches.update(phase_serving_path(dev))
    recs.update(phase_layer_kernels(dev))
    launches.update(phase_layer_path(dev))
    phase_lm(dev, card)
    phase_train(dev, card)
    phase_lm_sharding(dev, card)
    kernels = []
    for name, rec in recs.items():
        b_ms, b_by = bound(rec["flops"], rec["bytes"],
                           rec.get("dtype", "float32"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": rec.get("library_ms"),
            "device_ms": rec["device_ms"],
            "library_device_ms": rec.get("library_device_ms"),
            "path": PATHS.get(name, "engine entry points"),
            "flips": rec["flips"], "plan": rec.get("plan")})
    log(f"[profile] {len(PROFILE_LOSSES)} profiles missed a launch and were "
        f"taken again: {PROFILE_LOSSES}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run():
    """``main()`` behind the script's one boundary: any failure prints
    its traceback and reason on stderr, the reason as a line on stdout,
    and exits 1 (never 0 without the ``ok`` line)."""
    try:
        return main()
    except Exception as e:   # the boundary: report every failure, exit 1
        traceback.print_exc()
        msg = f"chip_smoke: FAILED: {type(e).__name__}: {e}"
        print(msg, file=sys.stderr, flush=True)
        print(msg, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(run())
