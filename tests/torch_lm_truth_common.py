"""The float64 truth of an LM train step, and how far one float32 ulp of
the weights moves it: the yardstick that holds a float32 run of the port
or of the reference against the function itself, not against the other
package's rounding.

Shared by ``tests/test_torch_lm_xlstm_truth.py``,
``tests/test_torch_lm_sharding_ref_mixers.py`` and
``tools/torch_lm_mixer_tp_check.py --truth``. A train case is a start
state (weights and AdamW moments) and a batch; ``truth`` runs each case
in a subprocess on the port's float64 copy
(``tools/torch_lm_mixer_tp_check.py::as_float64``: every float32 cast a
float64 one) and returns:

- **G64**: the gradients ``launch/steps.py::make_train_step`` (2
  microbatches, the cosine AdamW) hands AdamW, with the step's loss and
  grad norm, all in float64;
- **delta**: the largest share (``step_share``: the smoke's bounds) of
  G64 by which four seeded perturbations of the start's weights, each
  ``w * (1 + 2^-24 * N(0, 1))`` (``torch.Generator`` seeds 0-3), move
  the float64 step. No rounding enters these; they are the gradient's
  own response to one float32 ulp of its weights, which on xlstm's
  batches reaches several times the bound (``ROADMAP.md`` Queue 3). The
  largest of the four, not their median: the response is heavy-tailed.

A float32 run passes when its share against G64 is at most ``yardstick(
delta)`` = max(1, K x delta), K = 8.

The case file (``save_case`` / ``load_case``, one ``.npz``): each step's
start as leaves (``repro_torch.tree.tree_leaves`` order) and its batch,
the "grad" batch's optionally, and any runs' records
(``{"loss", "grad_norm", "grads"}``) under their names.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
K = 8
ULP = 2.0 ** -24
SEEDS = (0, 1, 2, 3)
MICRO = 2
SCHEDULE = (1e-3, 1, 4)          # peak lr, warmup, total
TIMEOUT_S = 300


def overrides(base) -> dict:
    """The parity runs' config: float32 weights; MoE dropless, with no
    load-balance term (the expert-parallel route averages it over the
    data shards)."""
    over = {"param_dtype": "float32"}
    if base.n_routed_experts:
        over.update(capacity_factor=base.n_routed_experts / base.moe_top_k,
                    lb_loss_weight=0.0)
    return over


def yardstick(delta: float) -> float:
    return max(1.0, K * delta)


def _smoke():
    if str(ROOT / "tools") not in sys.path:
        sys.path.append(str(ROOT / "tools"))
    import torch_lm_shard_smoke
    return torch_lm_shard_smoke


def step_share(x: dict, y: dict) -> float:
    """Run ``x`` against ``y`` (``y`` the reference or the truth): the
    worst share of the smoke's bounds over the loss and grad norm
    (``LOSS_TOL``) and every gradient (``GRAD_TOL``, of ``y``'s global
    norm)."""
    import torch
    smoke = _smoke()
    tg = [torch.from_numpy(np.asarray(t)) for t in y["grads"]]
    norm = float(sum(t.double().square().sum() for t in tg)) ** 0.5
    w = max(smoke.near_share(torch.tensor(x[k]), torch.tensor(y[k]))
            for k in ("loss", "grad_norm") if k in y)
    assert len(x["grads"]) == len(tg)
    return max([w] + [smoke.grad_share(torch.from_numpy(np.asarray(u)), v,
                                       norm)
                      for u, v in zip(x["grads"], tg)])


def score(x: dict, g64: dict) -> dict:
    """A float32 train step's record against its truth (``truth``'s step)
    -> its share, the step's delta, share / delta and the yardstick."""
    share = step_share(x, g64)
    return {"share": share, "delta": g64["delta"], "deltas": g64["deltas"],
            "over_delta": share / g64["delta"],
            "bound": yardstick(g64["delta"])}


def run_share(a: dict, b: dict) -> dict:
    """Run ``a`` against ``b``, each ``{"grad": record, "train": [record a
    step]}``: the "grad" batch's share, the train steps' worst and each
    step's, and the worst of the train losses alone."""
    smoke = _smoke()
    import torch
    by_step = [step_share(x, y) for x, y in zip(a["train"], b["train"])]
    return {"grad": step_share(a["grad"], b["grad"]), "train": max(by_step),
            "by step": by_step, "train loss": max(
                smoke.near_share(torch.tensor(x["loss"]),
                                 torch.tensor(y["loss"]))
                for x, y in zip(a["train"], b["train"]))}


def recording(opt):
    """``opt`` whose ``update_`` also keeps a copy of each gradient tree it
    is handed -> (that optimizer, the list of the copies)."""
    from repro_torch.tree import tree_map
    seen = []

    def update_(g, s, p):
        seen.append(tree_map(lambda t: t.detach().clone(), g))
        return opt.update_(g, s, p)
    return opt._replace(update_=update_), seen


def start_leaves(params, state) -> tuple:
    """A start state (port trees) -> (weights, mu, nu, step) as numpy."""
    from repro_torch.tree import tree_leaves
    npy = lambda t: [x.detach().numpy() for x in tree_leaves(t)]
    return npy(params), npy(state.mu), npy(state.nu), int(state.step)


def start_trees(params_like, opt, leaves) -> tuple:
    """``start_leaves``' output -> (weights, AdamW state) as trees of the
    shapes of ``params_like``, in the weights' dtype (the float64 copy's:
    float64)."""
    import torch
    from repro_torch.tree import tree_leaves, tree_unflatten
    pl, mu, nu, step = leaves
    dt = tree_leaves(params_like)[0].dtype

    def tree(arrs):
        like = tree_leaves(params_like)
        assert [a.shape for a in arrs] == [tuple(t.shape) for t in like]
        return tree_unflatten(params_like, [
            torch.from_numpy(np.array(a)).to(dt) for a in arrs])
    state = opt.init(params_like)
    return tree(pl), state._replace(
        step=torch.tensor(step, dtype=state.step.dtype), mu=tree(mu),
        nu=tree(nu))


def save_case(path, starts, batches, grad_batch=None, runs=None) -> None:
    """``starts`` (``start_leaves``' tuples) with ``batches`` (a dict of
    arrays each), optionally the "grad" batch (its weights: the first
    start's) and ``runs`` (name -> ``{"grad": record, "train": [record a
    step]}``) -> one ``.npz`` at ``path``."""
    out = {}
    for k, ((pl, mu, nu, step), b) in enumerate(zip(starts, batches)):
        for what, arrs in (("params", pl), ("mu", mu), ("nu", nu)):
            out.update({f"start{k}.{what}.{i}": a for i, a in enumerate(arrs)})
        out[f"start{k}.step"] = np.int64(step)
        out.update({f"batch{k}.{n}": v for n, v in b.items()})
    if grad_batch is not None:
        out.update({f"grad_batch.{n}": v for n, v in grad_batch.items()})
    for name, run in (runs or {}).items():
        for k, rec in enumerate([run["grad"]] + run["train"]):
            tag = f"run.{name}.{k}"
            out[f"{tag}.loss"] = np.float64(rec["loss"])
            if "grad_norm" in rec:
                out[f"{tag}.grad_norm"] = np.float64(rec["grad_norm"])
            out.update({f"{tag}.grads.{i}": g
                        for i, g in enumerate(rec["grads"])})
    np.savez(path, **out)


def load_case(path) -> tuple:
    """``save_case``'s file -> (starts, batches, grad batch or None, runs)."""
    z = np.load(path)
    keys = set(z.files)

    def listed(prefix):
        n = sum(1 for f in keys if f.startswith(prefix) and
                f[len(prefix):].isdigit())
        return [z[f"{prefix}{i}"] for i in range(n)]

    def batch(prefix):
        return {f.split(".")[-1]: z[f] for f in sorted(keys)
                if f.startswith(prefix + ".")}
    starts, batches = [], []
    while f"start{len(starts)}.step" in keys:
        k = len(starts)
        starts.append(tuple(listed(f"start{k}.{w}.")
                            for w in ("params", "mu", "nu")) +
                      (int(z[f"start{k}.step"]),))
        batches.append(batch(f"batch{k}"))
    runs = {}
    for name in sorted({f.split(".")[1] for f in keys
                        if f.startswith("run.")}):
        recs = []
        while f"run.{name}.{len(recs)}.loss" in keys:
            tag = f"run.{name}.{len(recs)}"
            rec = {"loss": float(z[f"{tag}.loss"]),
                   "grads": listed(f"{tag}.grads.")}
            if f"{tag}.grad_norm" in keys:
                rec["grad_norm"] = float(z[f"{tag}.grad_norm"])
            recs.append(rec)
        runs[name] = {"grad": recs[0], "train": recs[1:]}
    grad_batch = batch("grad_batch") if "grad_batch.tokens" in keys else None
    return starts, batches, grad_batch, runs


def float64_copy(dst: Path, reference: bool = False) -> Path:
    """``tools/torch_lm_mixer_tp_check.py::as_float64``: the port's float64
    copy under ``dst`` (and the reference's, with ``reference``) -> the
    copy's ``src``."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_lm_mixer_tp_check as chk
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return chk.as_float64(dst, reference)


def truth(arch: str, case_path, timeout_s: float = TIMEOUT_S) -> dict:
    """The truth of the case file's train steps (module docstring) ->
    ``{"train": [{"loss", "grad_norm", "grads", "delta", "deltas"} a
    step], "grad": the float64 port's record of the "grad" batch, if the
    file has one, else None}``."""
    with tempfile.TemporaryDirectory(prefix="lm_truth_") as tmp:
        tmp = Path(tmp)
        src = float64_copy(tmp / "f64")
        out = tmp / "truth.npz"
        env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), arch,
             str(case_path), str(out), str(src.parent / "tools")],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=timeout_s)
        assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
        _, _, _, runs = load_case(out)
        meta = json.loads(res.stdout.strip().splitlines()[-1])
    steps = runs["G64"]["train"]
    for rec, d in zip(steps, meta["deltas"]):
        rec.update(delta=max(d), deltas=d)
    return {"train": steps,
            "grad": runs["G64"]["grad"] if meta["grad"] else None}


def _main(arch, case_path, out_path, tools) -> None:
    """The subprocess of ``truth``, on the float64 copy (its ``src`` on
    ``PYTHONPATH``, its smoke under ``tools``)."""
    sys.path.insert(0, tools)
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    base = reduced(get_config(arch))
    cfg = base.with_overrides(**overrides(base))
    assert cfg.dtype() == torch.float64, "not the float64 copy"
    like = lm.init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw.adamw(adamw.cosine_schedule(*SCHEDULE))
    starts, batches, grad_batch, _ = load_case(case_path)
    clone = lambda t: tree_map(lambda x: x.detach().clone(), t)
    tensors = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}

    def at(params, state, batch):
        o, seen = recording(opt)
        _, _, met = steps.make_train_step(cfg, o, MICRO)(
            clone(params), clone(state), tensors(batch))
        return {"loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "grads": [t.numpy() for t in tree_leaves(seen[-1])]}

    def moved(params, seed):
        gen = torch.Generator().manual_seed(seed)
        leaves = [w * (1 + ULP * torch.randn(w.shape, generator=gen,
                                             dtype=w.dtype))
                  for w in tree_leaves(params)]
        return tree_unflatten(params, leaves)
    train, deltas = [], []
    for leaves, b in zip(starts, batches):
        p, s = start_trees(like, opt, leaves)
        g64 = at(p, s, b)
        train.append(g64)
        deltas.append([step_share(at(moved(p, seed), s, b), g64)
                       for seed in SEEDS])
    grad = {"loss": 0.0, "grads": []}
    if grad_batch is not None:
        p, _ = start_trees(like, opt, starts[0])
        live = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = lm.loss_fn(tree_unflatten(p, live), cfg,
                             tensors(grad_batch))
        grad = {"loss": float(loss), "grads": [
            g.numpy() for g in torch.autograd.grad(loss, live)]}
    save_case(out_path, [], [], runs={"G64": {"grad": grad,
                                               "train": train}})
    print(json.dumps({"deltas": deltas, "grad": grad_batch is not None}))


if __name__ == "__main__":
    _main(*sys.argv[1:5])
