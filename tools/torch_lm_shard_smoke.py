"""The LM's sharded steps on DTensor against the one-process port, one
process a rank:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tools/torch_lm_shard_smoke.py --device cpu --arch qwen3-4b \
        --reduced --model 2 --batch 8 --seq 32 --what train,prefill,decode
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tools/torch_lm_shard_smoke.py --device cuda --arch qwen3-4b \
        --layers 2 --model 2 --batch 8 --seq 512 --what train

Every rank builds the same float32 weights (the bounds below are
float32's) and batches from ``--seed``, lays the ranks out as
``launch/mesh.py::make_host_mesh(--model)`` (("data", "model"), of the
device's type, over gloo: on the card with ``launch/mesh.py::gloo_on_card``)
and makes the parameters, AdamW's state, the inputs and the decode cache
``DTensor``s on the rules of ``distributed/sharding.py``
(``--profile`` overrides the config's ``parallelism``). Under
``act_sharding.use_mesh`` it then runs (``--what``):

- ``train``: ``--steps`` steps of ``steps.make_train_step``
  (``--microbatches``).
  Each step is held against the one-process step from the same
  parameters (the sharded ones before the step, gathered): rank 0 runs
  it alone (``launch/mesh.py::rank0_alone``; its optimizer only reads
  the gradients and reports AdamW's metrics) and compares the loss and
  metrics (``LOSS_TOL``) and every gradient handed to AdamW
  (``GRAD_TOL``: of the global norm, of the leaf's largest value,
  relative). Each rank then
  replays the one-process ``update_`` on its blocks of the state before
  the step and of the sharded gradients (clipped by the sharded norm):
  the sharded parameters and moments must be within ``REPLAY_ULPS``
  float32 ulps (a parameter's of |p| + lr). Each rank's parameter and
  moment bytes must be the global bytes over the ranks that shard each
  leaf. The last step's time is the steady step time, beside rank 0's
  one-process step;
- ``prefill`` / ``decode``: ``make_prefill_step`` on sharded inputs, then
  one ``make_serve_step`` at the prompt's end on the one-process prefill's
  cache laid out by ``cache_specs``: logits and every cache leaf against
  the one-process steps within ``LOSS_TOL``;
- ``ep``: one MoE layer of the config (``nn/moe.py::moe_init``),
  dropless, through ``nn/moe_ep.py::moe_apply_ep`` on the mesh for
  ``--expert-axes``, against ``moe.moe_apply``: the output within
  ``EP_TOL[0]`` and the gradients of ``out.sum()`` within ``EP_TOL[1]``,
  absolute below a magnitude of 1 (the reference test's bounds), of the
  leaf's largest value above it (full width);
- ``mixers``: one layer of each recurrent mixer of each ``--arch`` (Mamba,
  mLSTM, sLSTM; ``lm._layer_init``'s weights) through
  ``act_sharding.mixer`` (on "model" under the "tp" profile) against the
  mixer in one process: the output (``LOSS_TOL``) and the gradients of
  ``(out * w).sum()``, w random (``GRAD_TOL``), the state a prefill
  leaves, and one decode step on the one-process state laid out by
  ``cache_specs`` (its output and new state, ``LOSS_TOL``); each rank's
  bytes of the layer's weights against the global bytes over its shards.

Each rank counts the port's kernel launches over the run (the LM calls
the ``nn`` functions: none).

MoE configs run dropless (capacity = E / top_k) and, with a "data" axis
above 1, without the load-balance term in the loss: the expert-parallel
route averages it over the data shards (the reference's ``pmean``), a
different number from the one-process batch's. A rank that finds no
card under ``--device cuda`` raises. Rank 0 prints each check, exits 1 on
a failure, and prints a JSON summary as its last line (``--json`` also
writes it). Without ``torch.distributed.run``, ``RANK`` / ``WORLD_SIZE``
/ ``LOCAL_RANK`` in the environment and ``--init-method file:///path``
start a rank.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.act_sharding import use_mesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (gloo_on_card, init_ranks,  # noqa
                                     make_host_mesh, rank0_alone)
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import moe as moe_lib  # noqa: E402
from repro_torch.nn.moe_ep import moe_apply_ep  # noqa: E402
from repro_torch.optim.adamw import (AdamWState, adamw,  # noqa: E402
                                     cosine_schedule, global_norm)
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,  # noqa
                              tree_map, tree_unflatten)

LOSS_TOL = (1e-4, 1e-4)          # abs, rel: the loss, metrics, logits
GRAD_TOL = (1e-6, 1e-4, 1e-3)    # of the global norm, of the leaf max, rel
REPLAY_ULPS = 4
EP_TOL = (1e-5, 1e-4)            # forward, gradients (tests/test_moe_ep.py)
SCHEDULE = (1e-3, 1, 4)          # peak lr, warmup, total
# the ranks of one card share it over gloo (NCCL refuses two ranks on one
# card: launch/mesh.py::mesh_rank_device)
BACKEND = "gloo"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen3-4b",
                    help="several, comma-separated, for --what mixers")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--profile", default=None, choices=["tp", "fsdp_only"])
    ap.add_argument("--expert-axes", default=None,
                    choices=["model", "data_model"])
    ap.add_argument("--moe-impl", default=None, choices=["ep", "gspmd"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--what", default="train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--raw-collectives", action="store_true",
                    help="route every functional collective on a gloo "
                         "group through the c10d one, as on the card "
                         "(launch/mesh.py::gloo_on_card)")
    ap.add_argument("--json", type=Path, default=None)
    return ap.parse_args(argv)


def build_cfg(args, arch=None):
    cfg = get_config(arch or args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    kw = {"param_dtype": "float32"}   # the checks' bounds are float32's
    if args.layers:
        kw["n_layers"] = args.layers
    if args.profile:
        kw["parallelism"] = args.profile
    if args.expert_axes:
        kw["moe_expert_axes"] = args.expert_axes
    if args.moe_impl:
        kw["moe_impl"] = args.moe_impl
    if cfg.n_routed_experts:
        kw["capacity_factor"] = cfg.n_routed_experts / cfg.moe_top_k
    return cfg.with_overrides(**kw)


def batch_for(cfg, B, T, seed, step, dev, labels=True):
    """Step ``step``'s batch, drawn on the CPU (every rank and device the
    same numbers)."""
    g = torch.Generator().manual_seed(seed * 1000 + step + 1)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                                   dtype=torch.int32)}
    if labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (B, T),
                                      generator=g, dtype=torch.int32)
    if cfg.family == "vlm":
        out["vision"] = torch.randn(B, cfg.n_vision_tokens, cfg.d_model,
                                    generator=g).to(cfg.dtype())
    if cfg.family == "encdec":
        out["frames"] = torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                    generator=g).to(cfg.dtype())
    return {k: v.to(dev) for k, v in out.items()}


def init_weights(cfg, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lm.init_params(cfg, g, device=dev)


class Checks:
    """Rank 0's record of every comparison: the worst share of its bound."""

    def __init__(self):
        self.worst = {}
        self.failed = []

    def note(self, what, share):
        self.worst[what] = max(self.worst.get(what, 0.0), float(share))
        if not share <= 1.0:
            self.failed.append(f"{what}: {share:.4g} of the bound")


def _pair(a, b):
    """``a`` and ``b`` as float64 on ``b``'s device (the comparisons run
    where the tensors are: a full-width leaf on one host thread takes
    tens of seconds)."""
    return a.detach().to(b.device, torch.float64), \
        b.detach().to(torch.float64)


def near_share(a, b, tol=LOSS_TOL) -> float:
    """max |a - b| / (abs + rel * |b|); inf on a shape or finiteness
    fault."""
    a, b = _pair(a, b)
    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
        return math.inf
    if not a.numel():
        return 0.0
    return float(((a - b).abs() / (tol[0] + tol[1] * b.abs())).max())


def grad_share(a, b, norm) -> float:
    a, b = _pair(a, b)
    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
        return math.inf
    if not a.numel():
        return 0.0
    top = float(b.abs().max())
    bound = GRAD_TOL[0] * norm + GRAD_TOL[1] * top + GRAD_TOL[2] * b.abs()
    return float(((a - b).abs() / bound).max())


def ulps(a, b, scale=None) -> float:
    """max |a - b| in float32 ulps of max(|b|, |scale|) (``np.spacing``:
    the step to the next float32 up)."""
    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
        return math.inf
    if not a.numel():
        return 0.0
    mag = b.detach().abs().float()
    if scale is not None:
        mag = torch.maximum(mag, scale.detach().abs().float())
    spacing = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
    diff = (a.detach().double() - b.detach().double()).abs()
    return float((diff / spacing.double()).max())


def gather(tree, keep: bool):
    """Every DTensor leaf's global tensor (a collective, leaf by leaf), a
    copy of its own (a replicated leaf's ``full_tensor`` is its local
    storage); kept on the rank that asks, dropped on the others."""
    def one(x):
        full = x.full_tensor()
        if not keep:
            return None
        # on the local block's device (a "cpu"-typed mesh may gather to
        # the host) and never the local block's own storage
        full = full.to(x.to_local().device)
        return full.clone() if full.data_ptr() == \
            x.to_local().data_ptr() else full
    return tree_map(one, tree)


def clone_tree(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.to_local().element_size()
               for x in tree_leaves(tree))


def expected_bytes(tree, mesh) -> int:
    """The global bytes of each leaf over the ranks that shard it."""
    total = 0
    for x in tree_leaves(tree):
        n = 1
        for i, p in enumerate(x.placements):
            if p.is_shard():
                n *= mesh.size(i)
        total += x.numel() * x.element_size() // n
    return total


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_train(args, cfg, mesh, dev, rank, checks, summary):
    B, T, n = args.batch, args.seq, args.microbatches
    data = mesh.size(mesh.mesh_dim_names.index("data"))
    lb_differs = bool(cfg.n_routed_experts and data > 1
                      and cfg.moe_impl == "ep")
    if lb_differs:
        cfg = cfg.with_overrides(lb_loss_weight=0.0)
    shd.set_moe_expert_axes(cfg.moe_expert_axes)
    seen = {}
    base = adamw(cosine_schedule(*SCHEDULE))

    def update_(grads, state, params):
        seen["grads"] = clone_tree(grads)
        return base.update_(grads, state, params)
    opt = base._replace(update_=update_)
    step = steps.make_train_step(cfg, opt, n)
    lr_fn = cosine_schedule(*SCHEDULE)

    def read_only(grads, state, params):
        """The one-process step's optimizer: it keeps the gradients and
        reports AdamW's metrics (``grad_norm``, ``lr``) without updating."""
        seen["ref_grads"] = grads
        return params, state, {"grad_norm": global_norm(grads),
                               "lr": lr_fn(torch.tensor(int(state.step) + 1,
                                                        dtype=torch.int32))}
    ref_step = steps.make_train_step(cfg, base._replace(update_=read_only),
                                     n)

    params = init_weights(cfg, args.seed, dev)
    pspecs = shd.param_specs(params, mesh, cfg.parallelism)
    state = base.init(params)
    ospecs = shd.opt_state_specs(state, mesh, pspecs)
    params_d = shd.distribute_tree(params, pspecs, mesh)
    # the step count stays a plain host tensor, as on one card
    state_d = shd.distribute_tree(state, ospecs, mesh)._replace(
        step=state.step)
    del params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    times, ref_times = [], []
    for k in range(args.steps):
        batch = batch_for(cfg, B, T, args.seed, k, dev)
        bspecs = {name: shd.batch_spec(mesh, B, v.dim() - 1,
                                       cfg.parallelism)
                  for name, v in batch.items()}
        batch_d = shd.distribute_tree(batch, bspecs, mesh)
        before = clone_tree((params_d, state_d.mu, state_d.nu))
        step_before = int(state_d.step)
        sync(dev)
        t0 = time.perf_counter()
        with use_mesh(mesh, cfg.parallelism):
            params_d, state_d, metrics = step(params_d, state_d, batch_d)
        sync(dev)
        times.append(time.perf_counter() - t0)
        grads = seen.pop("grads")
        if k == 0:
            summary["param_bytes"] = local_bytes(params_d)
            summary["param_bytes_expected"] = expected_bytes(params_d, mesh)
            summary["moment_bytes"] = local_bytes((state_d.mu, state_d.nu))
            summary["moment_bytes_expected"] = expected_bytes(
                (state_d.mu, state_d.nu), mesh)
            if dev.type == "cuda":
                summary["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated(dev)
        # the one-process step from the same parameters, on rank 0 (its
        # optimizer only reads the gradients: no moments are needed)
        full_params = gather(before[0], rank == 0)
        full_grads = gather(grads, rank == 0)
        sharded_metrics = {key: float(v.full_tensor() if hasattr(
            v, "full_tensor") else v) for key, v in metrics.items()}
        with rank0_alone(mesh):
            if rank == 0:
                ref_batch = batch_for(cfg, B, T, args.seed, k, dev)
                sync(dev)
                t0 = time.perf_counter()
                _, _, ref_m = ref_step(full_params, AdamWState(
                    step=torch.tensor(step_before, dtype=torch.int32),
                    mu=None, nu=None), ref_batch)
                sync(dev)
                ref_times.append(time.perf_counter() - t0)
                ref_grads = seen.pop("ref_grads")
                norm = float(ref_m["grad_norm"])
                for key in ref_m:
                    if key == "lb_loss" and lb_differs:
                        continue      # averaged over data shards (above)
                    checks.note(f"step {k} {key}", near_share(
                        torch.tensor(sharded_metrics[key]), ref_m[key]))
                for (path, a), b in zip(tree_leaves_with_path(full_grads),
                                        tree_leaves(ref_grads)):
                    checks.note(f"step {k} gradients", grad_share(a, b,
                                                                  norm))
                summary.setdefault("loss", []).append(
                    [sharded_metrics["loss"], float(ref_m["loss"])])
                del ref_grads, ref_m
            del full_params, full_grads
        # each rank: the one-process update on its blocks
        worst = replay(before, grads, params_d, state_d, metrics,
                       step_before, mesh)
        worst_t = torch.tensor([worst], dtype=torch.float64)
        dist.all_reduce(worst_t, op=dist.ReduceOp.MAX)
        if rank == 0:
            checks.note(f"step {k} update (ulps / {REPLAY_ULPS})",
                        float(worst_t) / REPLAY_ULPS)
        del before, grads
    summary["step_s"] = times
    summary["steady_step_s"] = times[-1]
    if rank == 0:
        summary["one_process_step_s"] = ref_times
    ok_bytes = (summary["param_bytes"] == summary["param_bytes_expected"]
                and summary["moment_bytes"]
                == summary["moment_bytes_expected"])
    return ok_bytes


def replay(before, grads, params_d, state_d, metrics, step_before, mesh):
    """The one-process ``update_`` on this rank's blocks of the state
    before the step and the sharded gradients (clipped by the sharded
    norm) -> the largest ulps by which the sharded state differs."""
    p0, mu0, nu0 = before
    gnorm = metrics["grad_norm"]
    gnorm = gnorm.full_tensor() if hasattr(gnorm, "full_tensor") else gnorm
    scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = float(metrics["lr"].full_tensor() if hasattr(
        metrics["lr"], "full_tensor") else metrics["lr"])
    worst = 0.0
    blocks = {"g": [], "p": [], "m": [], "v": [], "p1": [], "m1": [],
              "v1": []}
    for g, p, m, v, p1, m1, v1 in zip(*(tree_leaves(t) for t in (
            grads, p0, mu0, nu0, params_d, state_d.mu, state_d.nu))):
        pl = m.placements          # the moment's block: the update's
        blocks["g"].append(g.redistribute(mesh, pl).to_local() * scale)
        blocks["p"].append(p.redistribute(mesh, pl).to_local().clone())
        blocks["m"].append(m.to_local().clone())
        blocks["v"].append(v.to_local().clone())
        blocks["p1"].append(p1.redistribute(mesh, pl).to_local())
        blocks["m1"].append(m1.to_local())
        blocks["v1"].append(v1.to_local())
    opt = adamw(cosine_schedule(*SCHEDULE), clip_norm=math.inf)
    st = opt.init(blocks["p"])._replace(
        step=torch.tensor(step_before, dtype=torch.int32),
        mu=blocks["m"], nu=blocks["v"])
    scale_p = [x.abs() + lr for x in blocks["p"]]
    p, st, _ = opt.update_(blocks["g"], st, blocks["p"])
    for a, b, z in zip(blocks["p1"], p, scale_p):
        worst = max(worst, ulps(a, b, z))
    for a, b in zip(blocks["m1"] + blocks["v1"], st.mu + st.nu):
        worst = max(worst, ulps(a, b))
    return worst


def run_serve(args, cfg, mesh, dev, rank, checks, summary):
    """Prefill and one decode step, sharded, against the one-process
    steps (every rank runs both at these reduced sizes)."""
    from torch.distributed.tensor import DTensor
    B, T = args.batch, args.seq
    max_len = T + 4
    shd.set_moe_expert_axes(cfg.moe_expert_axes)
    params = init_weights(cfg, args.seed, dev)
    pspecs = shd.param_specs(params, mesh, cfg.parallelism)
    params_d = shd.distribute_tree(params, pspecs, mesh)
    inputs = batch_for(cfg, B, T, args.seed, 0, dev, labels=False)
    ispecs = {name: shd.batch_spec(mesh, B, v.dim() - 1, cfg.parallelism)
              for name, v in inputs.items()}
    prefill = steps.make_prefill_step(cfg, max_len)
    serve = steps.make_serve_step(cfg)
    ref_lg, ref_cache = prefill(params, inputs)
    if "prefill" in args.what:
        with use_mesh(mesh, cfg.parallelism):
            lg, cache = prefill(params_d,
                                shd.distribute_tree(inputs, ispecs, mesh))
        full = gather((lg, cache), True)
        checks.note("prefill logits", near_share(full[0], ref_lg))
        for a, b in zip(tree_leaves(full[1]), tree_leaves(ref_cache)):
            checks.note("prefill cache", near_share(a, b))
    if "decode" in args.what:
        token = torch.randint(0, cfg.vocab_size, (B,), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(7)
                              ).to(dev)
        cspecs = shd.cache_specs(ref_cache, mesh, B)
        cache_d = shd.distribute_tree(ref_cache, cspecs, mesh)
        summary["seq_sharded_cache_leaves"] = sum(
            any(p.is_shard(1) for p in x.placements)
            for x in tree_leaves(cache_d) if isinstance(x, DTensor))
        token_d = shd.distribute_tree(
            {"t": token}, {"t": shd.batch_spec(mesh, B, 0,
                                               cfg.parallelism)}, mesh)["t"]
        with use_mesh(mesh, cfg.parallelism):
            lg, cache_d = serve(params_d, cache_d, token_d, T)
        ref_lg2, ref_cache = serve(params, ref_cache, token, T)
        full = gather((lg, cache_d), True)
        checks.note("decode logits", near_share(full[0], ref_lg2))
        for a, b in zip(tree_leaves(full[1]), tree_leaves(ref_cache)):
            checks.note("decode cache", near_share(a, b))


def run_ep(args, cfg, mesh, dev, rank, checks, summary):
    """One MoE layer through the expert-parallel route against
    ``moe_apply``, dropless; the gradients of ``out.sum()``."""
    from torch.distributed.tensor import DTensor
    B, T = args.batch, args.seq
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    cf = E / k
    shd.set_moe_expert_axes(cfg.moe_expert_axes)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p = moe_lib.moe_init(g, cfg.d_model, cfg.d_expert, E,
                         cfg.n_shared_experts, dtype=cfg.dtype(), device=dev)
    x = torch.randn(B, T, cfg.d_model, generator=g, device=dev,
                    dtype=cfg.dtype())
    leaves = tree_leaves(p)
    live = [t.detach().requires_grad_() for t in leaves]
    ref, _ = moe_lib.moe_apply(tree_unflatten(p, live), x, top_k=k,
                               act=cfg.act, capacity_factor=cf)
    ref_grads = torch.autograd.grad(ref.sum(), live)
    pspecs = shd.param_specs(p, mesh, cfg.parallelism)
    p_d = shd.distribute_tree(p, pspecs, mesh)
    p_d = tree_map(lambda t: t.detach().requires_grad_(), p_d)
    x_d = shd.distribute_tree({"x": x}, {"x": shd.batch_spec(
        mesh, B, 2, cfg.parallelism)}, mesh)["x"]
    launches = _launches()
    sync(dev)
    t0 = time.perf_counter()
    with use_mesh(mesh, cfg.parallelism):
        out, aux = moe_apply_ep(p_d, x_d, top_k=k, act=cfg.act,
                                capacity_factor=cf,
                                expert_axes=cfg.moe_expert_axes, mesh=mesh)
        out.sum().backward()
    sync(dev)
    summary["ep_fwd_bwd_s"] = time.perf_counter() - t0
    summary["ep_kernel_launches"] = _launches() - launches
    assert isinstance(out, DTensor)
    ref = ref.detach()
    err = float((out.full_tensor() - ref).abs().max())
    gshares = [float((a.grad.full_tensor() - b).abs().max())
               / (EP_TOL[1] * max(1.0, float(b.abs().max())))
               for a, b in zip(tree_leaves(p_d), ref_grads)]
    summary["ep_fwd_err"] = err
    summary["ep_grad_err"] = max(
        float((a.grad.full_tensor() - b).abs().max())
        for a, b in zip(tree_leaves(p_d), ref_grads))
    summary["ep_drop_frac"] = float(aux["drop_frac"].full_tensor())
    # the bounds are absolute below a magnitude of 1 (the reference
    # test's), relative to the largest value above it (full width)
    checks.note("ep forward", err / (EP_TOL[0] * max(
        1.0, float(ref.abs().max()))))
    checks.note("ep gradients", max(gshares))


def run_mixers(args, cfg, mesh, dev, rank, checks, summary):
    """One layer of each recurrent mixer of ``cfg`` on the mesh against
    one process (the module docstring's ``mixers``); rank 0 runs the
    one-process layer alone."""
    from repro_torch.configs.base import LayerSpec
    from repro_torch.distributed.act_sharding import gather_weights, mixer
    from repro_torch.nn import ssm
    B, T, d = args.batch, args.seq, cfg.d_model
    prologue, pattern, _ = cfg.layer_plan()
    kinds = list(dict.fromkeys(sp.kind for sp in list(prologue) + pattern
                               if sp.kind in lm.MIXERS))
    g = torch.Generator(device=dev).manual_seed(args.seed)
    summary.setdefault("mixers", {})
    summary.setdefault("mixer_bytes", {})
    batch_pl = shd.batch_spec(mesh, B, 2, cfg.parallelism)

    def on_batch(t):
        spec = batch_pl[:1] + (None,) * (t.dim() - 1)
        return shd.distribute_tree({"t": t}, {"t": spec}, mesh)["t"]
    for kind in kinds:
        p = lm._layer_init(g, cfg, LayerSpec(kind, "none"), dev)["mix"]
        apply_fn, step_fn = lm.MIXERS[kind]
        kw = (dict(d_state=cfg.mamba_d_state) if kind == "mamba"
              else dict(n_heads=cfg.n_heads))
        chunk = dict(chunk=cfg.mamba_chunk if kind == "mamba"
                     else cfg.rnn_chunk)
        x, w = (torch.randn(B, T, d, generator=g, device=dev,
                            dtype=cfg.dtype()) for _ in range(2))
        xt = torch.randn(B, d, generator=g, device=dev, dtype=cfg.dtype())
        layout = functools.partial(ssm.tp_layout, kind, p, cfg.n_heads)
        with torch.no_grad():
            _, state = apply_fn(p, x, return_state=True, **kw, **chunk)
        rec = {}
        with rank0_alone(mesh):
            if rank == 0:
                live = tree_map(lambda t: t.detach().requires_grad_(), p)
                xr = x.detach().requires_grad_()
                sync(dev)
                t0 = time.perf_counter()
                ref = apply_fn(live, xr, **kw, **chunk)
                (ref * w).sum().backward()
                sync(dev)
                rec["one_process_s"] = time.perf_counter() - t0
                ref_grads = [xr.grad] + [t.grad for t in tree_leaves(live)]
                with torch.no_grad():
                    ref_t = step_fn(p, state, xt, **kw)
                del live, xr
        p_d = shd.distribute_tree({"mix": p}, shd.param_specs(
            {"mix": p}, mesh, cfg.parallelism), mesh)["mix"]
        p_d = tree_map(lambda t: t.detach().requires_grad_(), p_d)
        x_d = on_batch(x).requires_grad_()
        summary["mixer_bytes"][kind] = [local_bytes(p_d),
                                        expected_bytes(p_d, mesh)]
        sync(dev)
        t0 = time.perf_counter()
        with use_mesh(mesh, cfg.parallelism):
            out = mixer(apply_fn, layout, x_d, gather_weights(p_d), **kw,
                        **chunk)
            (out * on_batch(w)).sum().backward()
        sync(dev)
        rec["fwd_bwd_s"] = time.perf_counter() - t0
        with torch.no_grad(), use_mesh(mesh, cfg.parallelism):
            _, st = mixer(apply_fn, layout, x_d, gather_weights(p_d),
                          return_state=True, **kw, **chunk)
            state_d = shd.distribute_tree(state, shd.cache_specs(
                state, mesh, B), mesh)
            out_t, st_t = mixer(step_fn, layout, on_batch(xt),
                                gather_weights(p_d), state_d, **kw)
        full = gather((out, [x_d.grad] + [t.grad for t in tree_leaves(p_d)],
                       st, out_t, st_t), rank == 0)
        if rank == 0:
            f_out, f_grads, f_st, f_out_t, f_st_t = full
            norm = math.sqrt(sum(float(t.double().square().sum())
                                 for t in ref_grads))
            checks.note(f"{kind} forward", near_share(f_out, ref))
            for a, b in zip(f_grads, ref_grads):
                checks.note(f"{kind} gradients", grad_share(a, b, norm))
            for a, b in zip(tree_leaves(f_st), tree_leaves(state)):
                checks.note(f"{kind} prefill state", near_share(a, b))
            checks.note(f"{kind} decode", near_share(f_out_t, ref_t[0]))
            for a, b in zip(tree_leaves(f_st_t), tree_leaves(ref_t[1])):
                checks.note(f"{kind} decode state", near_share(a, b))
            summary["mixers"][kind] = rec
        del p_d, x_d, out, st, state_d, out_t, st_t, full
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _launches() -> int:
    from repro_torch.kernels import aip_step
    return sum(v for key, v in aip_step.LAUNCHES.items() if "[" not in key)


def main(argv=None):
    args = parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device on this rank")
    dev = init_ranks(BACKEND, args.device, init_method=args.init_method)
    rank = dist.get_rank()
    torch.set_num_threads(1)
    if dev.type == "cuda" or args.raw_collectives:
        gloo_on_card(force=args.raw_collectives)
    # the DTensors live on the mesh's device type: the card's, or the CPU
    mesh = make_host_mesh(args.model, device_type=dev.type)
    archs = args.arch.split(",")
    cfg = build_cfg(args, archs[0])
    checks = Checks()
    summary = {"arch": cfg.name, "ranks": dist.get_world_size(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "profile": cfg.parallelism, "what": args.what,
               "dtype": "float32", "device": str(dev)}
    if dev.type == "cuda":
        summary["card"] = torch.cuda.get_device_name(dev)
    ok = True
    launches = _launches()
    if "train" in args.what:
        ok = run_train(args, cfg, mesh, dev, rank, checks, summary)
    if "prefill" in args.what or "decode" in args.what:
        run_serve(args, cfg, mesh, dev, rank, checks, summary)
    if "ep" in args.what:
        run_ep(args, cfg, mesh, dev, rank, checks, summary)
    if "mixers" in args.what:
        for arch in archs:
            run_mixers(args, build_cfg(args, arch), mesh, dev, rank, checks,
                       summary)
        ok = ok and all(a == b for a, b in summary["mixer_bytes"].values())
    summary["kernel_launches"] = _launches() - launches
    per_rank = [None] * dist.get_world_size()
    mine = {k: summary.get(k) for k in (
        "param_bytes", "param_bytes_expected", "moment_bytes",
        "moment_bytes_expected", "max_memory_allocated", "step_s",
        "kernel_launches", "mixer_bytes")}
    dist.all_gather_object(per_rank, mine)
    oks = [None] * dist.get_world_size()
    dist.all_gather_object(oks, bool(ok))
    dist.destroy_process_group()
    if rank != 0:
        return 0
    summary["per_rank"] = per_rank
    summary["worst_share"] = {k: float(f"{v:.4g}")
                              for k, v in checks.worst.items()}
    summary["failed"] = checks.failed + (
        [] if all(oks) else ["a rank's bytes are not the global bytes "
                             "over the ranks that shard them"])
    summary["ok"] = not summary["failed"]
    for line in checks.failed:
        print(f"FAILED: {line}", flush=True)
    if args.json:
        args.json.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
