"""Where does xlstm's card-vs-CPU difference come from?

xlstm-1.3b at ``reduced()`` (one mLSTM and one sLSTM layer a group) is the
card's outlier against the CPU in ``chip_smoke.py`` phases 8 (forward)
and 9 (one train step's gradients). This check takes the same weights and
inputs as those phases (``chip_smoke._perturb_constants`` on
``lm.init_params`` seeded by the arch's index, ``_lm_inputs``; phase 9's
``TokenPipeline`` batch) and looks on the card and on the CPU:

1. layer by layer through the forward (B = 2, T = 12): each layer's
   output against the CPU's as the forward carries it ("carried"), and
   the layer run alone on the CPU's input ("own": the layer's own
   difference), as shares of phase 8's bound (1e-4 + 1e-4 x |CPU value|);
   then each layer's backward alone (the CPU's input, one fixed
   cotangent): its gradients as shares of phase 9's bound (1e-6 x the
   layer's gradient norm + 1e-4 x the leaf's max + 1e-3 x |CPU value|);
2. op by op inside the layer with the largest own difference: every aten
   op the CPU runs there, replayed on the card on the CPU's own inputs,
   its output against the CPU's in float32 ulps (an elementwise op beyond
   a few ulps computes something else; a product or a sum rounds in
   another order, so a product is also held to the rounding bound of a
   float32 sum of K terms, K x eps x (|A| @ |B|): within it at a share
   up to 1);
3. one train step (phase 9's: 2 microbatches, AdamW), every gradient
   leaf's share of phase 9's bound, by layer;
4. with ``--float64`` (default on): the same weights and inputs run in a
   float64 copy of ``src/repro_torch`` (every float32 cast a float64 one,
   ``tools/torch_lm_mixer_tp_check.py::as_float64``) on the card and on
   the CPU, in a process of its own: their shares, and the float32
   card's and CPU's distance from the float64 CPU result. Rounding closes
   by ~1e9 in float64 and leaves both float32 sides about as far from
   it, layer by layer; a fault does neither.

    python tools/torch_xlstm_card_check.py [--device cuda] [--no-float64]
        [--json PATH]

Prints a summary and, last, one JSON line; ``--device cpu`` compares the
CPU with itself (every share 0: a smoke of the tool).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "xlstm-1.3b"
FWD_B, FWD_T = 2, 12            # phase 8's
FWD_TOL = (1e-4, 1e-4)          # chip_smoke.LM_REDUCED_TOL
GRAD_TOL = (1e-6, 1e-4, 1e-3)   # chip_smoke.TRAIN_GRAD_TOL


def _paths():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if not os.environ.get("PYTHONPATH") and str(ROOT / "src") not in \
            sys.path:
        sys.path.insert(1, str(ROOT / "src"))


def fwd_share(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if not a.numel():
        return 0.0
    return float(((a - b).abs() / (FWD_TOL[0] + FWD_TOL[1] * b.abs())).max())


def grad_share(a, b, norm) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if not a.numel():
        return 0.0
    bound = GRAD_TOL[0] * norm + GRAD_TOL[1] * float(b.abs().max()) + \
        GRAD_TOL[2] * b.abs()
    return float(((a - b).abs() / bound).max())


def ulps32(a, b) -> float:
    """max |a - b| in float32 ulps of |b| (at least the smallest normal's
    ulp)."""
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    if not a.numel():
        return 0.0
    bf = b.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    ulp = (torch.nextafter(bf, torch.full_like(bf, float("inf"))) - bf)
    return float(((a.double() - b.double()).abs() / ulp.double()).max())


def make_state():
    """The weights and inputs of phases 8 and 9 for xlstm (CPU, float32)."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import get_config, list_configs, reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import lm
    cfg = reduced(get_config(ARCH))
    i = list_configs().index(ARCH)
    g = torch.Generator()
    g.manual_seed(100 + i)
    fwd_params = cs._perturb_constants(lm.init_params(cfg, g, device="cpu"),
                                       g)
    toks, _ = cs._lm_inputs(cfg, FWD_B, FWD_T + 1, g, "cpu")
    g = torch.Generator()
    g.manual_seed(200 + i)
    train_params = cs._perturb_constants(
        lm.init_params(cfg, g, device="cpu"), g)
    B, T = cs.TRAIN_REDUCED_BATCH
    batch = TokenPipeline(DataConfig(T, B, cfg.vocab_size,
                                     seed=i)).get_batch(0)
    batch = {k: torch.from_numpy(v.copy()).long() for k, v in batch.items()}
    g = torch.Generator()
    g.manual_seed(7)
    cot = torch.randn((FWD_B, FWD_T, cfg.d_model), generator=g)
    return {"fwd_params": fwd_params, "tokens": toks[:, :FWD_T],
            "train_params": train_params, "batch": batch, "cot": cot}


def _cast(tree, dtype):
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def _to(tree, dev):
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(dev).clone()
                    if isinstance(x, torch.Tensor) else x, tree)


class _Layers:
    """Records each ``lm._layer_apply`` call: (kind, params, input,
    output, ctx)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import lm
        self.real = lm._layer_apply

        def wrap(p, cfg, spec, h, ctx, **kw):
            out = self.real(p, cfg, spec, h, ctx, **kw)
            self.calls.append((spec.kind, p, h.detach(), out[0].detach(),
                               ctx, spec))
            return out
        lm._layer_apply = wrap
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm
        lm._layer_apply = self.real


def forward_layers(params, tokens, dev):
    """-> (final h, logits, the layer calls) of ``lm.forward`` on
    ``dev``."""
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import lm
    cfg = reduced(get_config(ARCH))
    cfg = cfg.with_overrides(param_dtype=str(
        next(iter(params["embed"].values())).dtype).replace("torch.", ""))
    with torch.no_grad(), _Layers() as rec:
        h, _, _ = lm.forward(_to(params, dev), cfg,
                             {"tokens": tokens.to(dev)})
        lg = lm.logits(_to(params, dev), cfg, h)
    return cfg, h, lg, rec.calls


def _ctx_to(ctx, dev):
    import torch
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in ctx.items()}


def layer_alone(layer_apply, call, cfg, dev, cot=None):
    """One recorded layer run alone on ``dev`` from the CPU's input ->
    output, or with ``cot`` (output, {leaf path: gradient})."""
    import torch
    from repro_torch.tree import tree_leaves_with_path, tree_unflatten, \
        tree_leaves
    kind, p, h_in, _, ctx, spec = call
    p = _to(p, dev)
    h = h_in.to(dev)
    if cot is None:
        with torch.no_grad():
            return layer_apply(p, cfg, spec, h, _ctx_to(ctx, dev))[0]
    paths = [k for k, _ in tree_leaves_with_path(p)]
    live = [x.detach().requires_grad_() for x in tree_leaves(p)]
    h = h.detach().requires_grad_()
    with torch.enable_grad():
        out = layer_apply(tree_unflatten(p, live), cfg, spec, h,
                          _ctx_to(ctx, dev))[0]
        grads = torch.autograd.grad(out, live + [h], cot.to(dev).to(
            out.dtype), allow_unused=True, materialize_grads=True)
    return out.detach(), dict(zip(paths + ["h_in"], grads))


class _OpRecorder:
    """Records every aten op run inside it: (name, op, inputs cloned
    before it runs, output)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                import torch
                from torch.utils._pytree import tree_map
                kwargs = kwargs or {}
                snap = tree_map(lambda x: x.detach().clone()
                                if isinstance(x, torch.Tensor) else x,
                                (args, kwargs))
                out = func(*args, **kwargs)
                rec.ops.append((func.overloadpacket.__name__, func, snap,
                                tree_map(lambda x: x.detach().clone()
                                         if isinstance(x, torch.Tensor)
                                         else x, out)))
                return out
        self.ops = []
        self.mode = Mode()


_DOTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}


def dot_share(name, args, got, want) -> float:
    """A product's |diff| over the rounding bound of a float32 sum of K
    terms, K x eps x (|A| @ |B|) (per element; 1 is that bound)."""
    import torch
    i, j = _DOTS[name]
    a, b = args[i].double().abs(), args[j].double().abs()
    k = a.shape[-1]
    bound = k * torch.finfo(torch.float32).eps * (a @ b)
    diff = (got.cpu().double() - want.double()).abs()
    return float((diff / bound.clamp(min=torch.finfo(torch.float32).tiny))
                 .max())


def replay_ops(ops, dev) -> dict:
    """Each recorded CPU op run on ``dev`` from the CPU's inputs ->
    {op name: {calls, worst float32 ulps, worst |diff|, for a product
    its worst share of the rounding bound (``dot_share``)}}."""
    import torch
    from torch.utils._pytree import tree_leaves, tree_map
    out = {}
    for name, func, (args, kwargs), want in ops:
        a, k = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                        else x, (args, kwargs))
        try:
            got = func(*a, **k)
        except Exception as e:              # an op the card refuses
            out.setdefault(name, {"calls": 0, "error": repr(e)[:200]})
            continue
        r = out.setdefault(name, {"calls": 0, "ulps": 0.0, "abs": 0.0})
        r["calls"] += 1
        for g_, w_ in zip(tree_leaves(got), tree_leaves(want)):
            if isinstance(w_, torch.Tensor) and (
                    not isinstance(g_, torch.Tensor) or g_.shape != w_.shape):
                r["shape_mismatch"] = r.get("shape_mismatch", 0) + 1
            elif isinstance(w_, torch.Tensor) and w_.is_floating_point() \
                    and w_.numel():
                r["ulps"] = max(r["ulps"], ulps32(g_.cpu().float(),
                                                  w_.float()))
                r["abs"] = max(r["abs"], float(
                    (g_.cpu().double() - w_.double()).abs().max()))
                if name in _DOTS:
                    r["dot_share"] = max(r.get("dot_share", 0.0), dot_share(
                        name, args, g_, w_))
    return out


def train_grads(params, batch, dev):
    """Phase 9's step on ``dev`` -> (the gradients handed to AdamW, by
    path, and the step's metrics)."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim.adamw import adamw, cosine_schedule
    from repro_torch.tree import tree_leaves_with_path
    cfg = reduced(get_config(ARCH))
    cfg = cfg.with_overrides(param_dtype=str(
        next(iter(params["embed"].values())).dtype).replace("torch.", ""))
    opt = adamw(cosine_schedule(*cs.TRAIN_REDUCED_SCHEDULE))
    seen = {}
    step = steps_lib.make_train_step(cfg, cs._handing(opt, seen), 2)
    p = _to(params, dev)
    _, _, m = step(p, opt.init(p), {k: v.to(dev) for k, v in batch.items()})
    return dict(tree_leaves_with_path(seen["grads"])), \
        {k: float(v) for k, v in m.items()}


def _norm(grads) -> float:
    return float(sum(float(g.double().pow(2).sum()) for g in grads.values())
                 ** 0.5)


def analyse(state, dev) -> dict:
    """Parts 1-3 on ``dev`` against the CPU, in the state's dtype."""
    import torch
    from repro_torch.models import lm
    real = lm._layer_apply
    cfg, h_c, lg_c, calls_c = forward_layers(state["fwd_params"],
                                             state["tokens"], "cpu")
    _, h_d, lg_d, calls_d = forward_layers(state["fwd_params"],
                                           state["tokens"], dev)
    layers = []
    for i, (cc, cd) in enumerate(zip(calls_c, calls_d)):
        own = layer_alone(real, cc, cfg, dev)
        out_c, g_c = layer_alone(real, cc, cfg, "cpu", state["cot"])
        out_d, g_d = layer_alone(real, cc, cfg, dev, state["cot"])
        norm = _norm(g_c)
        layers.append({
            "layer": i, "kind": cc[0],
            "carried": fwd_share(cd[3], cc[3]),
            "own": fwd_share(own, cc[3]),
            "own_max_abs": float((own.cpu().double()
                                  - cc[3].double()).abs().max()),
            "own_backward": {k: grad_share(g_d[k], g_c[k], norm)
                             for k in g_c}})
    worst = max(range(len(layers)), key=lambda i: layers[i]["own"])
    rec = _OpRecorder()
    with torch.no_grad(), rec.mode:
        layer_alone(real, calls_c[worst], cfg, "cpu")
    ops = replay_ops(rec.ops, dev)
    g_cpu, m_cpu = train_grads(state["train_params"], state["batch"], "cpu")
    g_dev, m_dev = train_grads(state["train_params"], state["batch"], dev)
    norm = m_cpu["grad_norm"]
    step = {k: grad_share(g_dev[k], g_cpu[k], norm) for k in g_cpu}
    return {
        "forward": {"h": fwd_share(h_d, h_c), "logits": fwd_share(lg_d,
                                                                  lg_c)},
        "layers": layers, "worst_layer": worst,
        "worst_layer_ops": ops,
        "step_grads": step, "step_grad_norm": [m_cpu["grad_norm"],
                                               m_dev["grad_norm"]],
        "_outputs": {"h": h_c, "logits": lg_c, "h_dev": h_d.cpu(),
                     "logits_dev": lg_d.cpu(), "grads": g_cpu,
                     "grads_dev": g_dev,
                     "layers": [c[3] for c in calls_c],
                     "layers_dev": [d[3].cpu() for d in calls_d]}}


def worker(tmp: Path, dev: str):
    """The float64 run (in the float64 copy): parts 1 and 3 in float64;
    writes the shares and the CPU's float64 outputs."""
    import torch
    state = _cast(torch.load(tmp / "state.pt"), torch.float64)
    res = analyse(state, dev)
    outs = res.pop("_outputs")
    torch.save({k: outs[k] for k in ("h", "logits", "grads", "layers")},
               tmp / "f64_outputs.pt")
    (tmp / "f64.json").write_text(json.dumps(res))


def _top(d: dict, n: int = 6) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])


def summary(res: dict) -> dict:
    """The per-kind worst shares of a result."""
    out = {"forward": res["forward"]}
    for kind in ("mlstm", "slstm"):
        ls = [x for x in res["layers"] if x["kind"] == kind]
        out[kind] = {
            "own": max(x["own"] for x in ls),
            "carried": max(x["carried"] for x in ls),
            "own_backward": max(max(x["own_backward"].values())
                                for x in ls),
            "step_grads": max([v for k, v in res["step_grads"].items()
                               if "blocks" in k and any(
                                   f"['blocks']['{i}']" in k
                                   for i in _slots(kind))] or [0.0])}
    out["step_grads_top"] = _top(res["step_grads"])
    return out


def _slots(kind: str) -> list:
    """The slots of ``kind``'s layers in reduced xlstm's group (the
    mLSTMs, then the sLSTM)."""
    from repro_torch.configs.base import get_config, reduced
    _, pattern, _ = reduced(get_config(ARCH)).layer_plan()
    return [i for i, s in enumerate(pattern) if s.kind == kind]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-float64", dest="float64", action="store_false")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _paths()
    if args.worker:
        worker(args.worker, args.device)
        return 0
    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: run with --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = make_state()
    res = analyse(state, args.device)
    outs = res.pop("_outputs")
    report = {"arch": ARCH, "device": args.device,
              "float32": summary(res), "float32_full": res}
    if torch.cuda.is_available() and args.device != "cpu":
        report["card"] = torch.cuda.get_device_name(0)
    if args.float64:
        sys.path.insert(0, str(ROOT / "tools"))
        from torch_lm_mixer_tp_check import as_float64
        with tempfile.TemporaryDirectory(prefix="xlstm_f64_") as tmp:
            tmp = Path(tmp)
            src = as_float64(tmp / "f64")
            torch.save(state, tmp / "state.pt")
            env = dict(os.environ, PYTHONPATH=str(src))
            r = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--device",
                 args.device, "--worker", str(tmp)], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=1800)
            if r.returncode:
                print(r.stdout[-3000:], r.stderr[-6000:], file=sys.stderr)
                raise SystemExit(f"the float64 run exited {r.returncode}")
            f64 = json.loads((tmp / "f64.json").read_text())
            truth = torch.load(tmp / "f64_outputs.pt")
        report["float64"] = summary(f64)
        report["float64_worst_layer_ops"] = _top(
            {k: v.get("ulps", 0.0) for k, v in
             f64["worst_layer_ops"].items()})
        # the float32 runs' distance from the float64 CPU result
        report["float32_vs_float64"] = {
            side: {"h": fwd_share(outs[f"h{sfx}"], truth["h"]),
                   "logits": fwd_share(outs[f"logits{sfx}"],
                                       truth["logits"]),
                   "step_grads": max(grad_share(
                       outs[f"grads{sfx}"][k], truth["grads"][k],
                       _norm(truth["grads"])) for k in truth["grads"])}
            for side, sfx in (("cpu", ""), ("card", "_dev"))}
        report["layers_vs_float64"] = [
            {"layer": i, "kind": x["kind"],
             "cpu": fwd_share(outs["layers"][i], truth["layers"][i]),
             "card": fwd_share(outs["layers_dev"][i], truth["layers"][i])}
            for i, x in enumerate(res["layers"])]
    ops = res["worst_layer_ops"]
    report["worst_layer"] = {
        "layer": res["worst_layer"],
        "kind": res["layers"][res["worst_layer"]]["kind"],
        "ops_by_ulps": _top({k: v.get("ulps", 0.0) for k, v in ops.items()},
                            10),
        "products_share_of_rounding_bound": {
            k: v["dot_share"] for k, v in ops.items() if "dot_share" in v},
        "errors": {k: v["error"] for k, v in ops.items() if "error" in v},
        "shape_mismatch": {k: v["shape_mismatch"] for k, v in ops.items()
                           if "shape_mismatch" in v}}
    for k, v in report.items():
        if k != "float32_full":
            print(f"[xlstm] {k}: {json.dumps(v)}", flush=True)
    if args.json:
        args.json.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items()
                      if k != "float32_full"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
