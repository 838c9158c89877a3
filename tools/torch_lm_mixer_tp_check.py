"""Is the recurrent mixers' tensor-parallel drift rounding or a fault?

Under a mesh's "tp" profile the port runs the recurrent mixers (Mamba,
mLSTM, sLSTM) on "model" (``distributed/act_sharding.py::mixer``: each
rank's share of the channels, heads, value rows or hidden units, partial
sums all-reduced). This check runs ``tools/torch_lm_shard_smoke.py`` on 4
gloo ranks on the CPU that way, or with the mixers batch-local
(``--batch-local``: ``act_sharding.batch_local``, their weights gathered
whole and every "model" rank computing the same rows), in float32 and,
with ``--float64``, in float64 (a copy of ``src/repro_torch`` and the
smoke with every float32 cast made a float64 one). A difference from the
one-process step that is the order of sums shrinks by ~1e9 from float32
to float64; a fault does not.

    python tools/torch_lm_mixer_tp_check.py [--float64] [--batch-local] \\
        [--arch xlstm-1.3b] [--model 2] [--seq 32] [--what train] \\
        [--timeout 900]
    python tools/torch_lm_mixer_tp_check.py --ulp-noise [--arch ...]
    python tools/torch_lm_mixer_tp_check.py --count [--arch ...]
    python tools/torch_lm_mixer_tp_check.py --whole gates,moment,output,\
        ffn [--model 2]
    python tools/torch_lm_mixer_tp_check.py --parity xlstm-1.3b \
        [--whole output,gates] [--float64]
    python tools/torch_lm_mixer_tp_check.py --truth xlstm-1.3b

It runs ``--arch`` at ``reduced()``, two train steps of B = 8 rows in 2
microbatches (and ``--what``'s prefill and decode), on 4 ranks (data 4 /
``--model``, model ``--model``).

``--ulp-noise`` asks how far any order of sums can move the step, in one
process on the CPU: the loss's gradients at the smoke's first batch with
one float32 ulp of noise (each element moved to the next float32 up or
down, the side drawn from a seed) where the route on "model" sums across ranks (each
``nn/ssm.py::Collectives`` hook, and each mixer's output: its all-reduce)
against the same gradients without it, as the smoke's shares of its
bounds (``GRAD_TOL``; the global norm's under ``LOSS_TOL``), one line
a site.

``--whole SITE[,SITE...]`` bisects the sharded step's drift by site:
for one site at a time (``all``: every site at once) the route on
"model" gathers that product's operands whole on each rank of "model"
(``act_sharding._state_whole``: the ranks' shares in the layout's
order) and contracts them in one process's order, where it otherwise
sums the ranks' partial products. The sites: the mLSTM's ``gates``
(``nn/ssm.py::_mlstm_qkvif``; its q, k and v contract whole in both of
its layouts), its group norm's ``moment`` and its ``output``
(``down_proj``, summed by ``mixer``), and the sLSTM's ``ffn``
(``ff_up`` and ``ff_down``: its output). A site the layout already
contracts whole on each rank (the moment where "model" divides the
mLSTM's heads) is left as it is. A product every rank then
computes whole is kept on "model"'s rank 0 and zero on the others, so
``mixer``'s sum of the output, and the all-gathers' reduce-scattered
gradients, add only zeros to it. One line a site: the first step's
gradients and grad norm as shares of the smoke's bounds (``--steps 1``
of the smoke), beside the route unchanged (``none``).

``--parity ARCH`` with ``--whole`` runs the parity test's 4 ranks
(``tests/torch_lm_ref_mixers_common.py``'s ``LM``, as
``tests/test_torch_lm_sharding_ref_mixers.py`` does: the reference on one
device and sharded, the port in one process and sharded, a gradient and
two train steps from common states, on (data 2, model 2) and (data 1,
model 4)) once a site, the port's route patched as above (the script's
``REPRO_MIXER_WHOLE``), and prints its cases, each tagged with the site.
With ``--float64`` both packages run in float64 (the copies of
``as_float64``, the reference's under ``JAX_ENABLE_X64``; the script's
``REPRO_SMOKE_DIR`` names the copy's smoke): a pair that is the two
orders of one function's sums shrinks by ~1e8 there; a difference of
function does not.

``--truth ARCH`` runs the same 4 ranks once and holds each train step of
the four runs (R1, RS and PS at both meshes, P1) against its float64
truth G64, the port's float64 copy's step from the same start, and the
step's one-ulp response delta (``tests/torch_lm_truth_common.py``): one
row a run and step with its share of the smoke's bounds, delta, share /
delta and whether it is within max(1, 8 x delta).

``--count`` counts one full-width layer of each of ``--arch``'s mixers
(``distributed/op_analysis.py``), forward and the backward of
``out.sum()``, on rank 0 of a fake (data 16, model 16) process group
(pod1's layout) at ``train_4k``'s microbatch (32 rows of 4,096), on
"model" and batch-local: dot FLOPs, HBM bytes (unfused), collective
bytes, and the dot FLOPs every rank of "model" computes whole, (16 x
on-model - batch-local) / 15, one line a mixer.

Prints rank 0's summary's shares of the bounds above 0 (the smoke's
``worst_share``), its failed checks, whether each rank's bytes are the
global bytes over its shards, and the step times (the sharded steps',
rank 0's one-process steps') as one JSON line; exits 1 if a rank failed
to run or overran (a check above its bound is reported, not an exit).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SMOKE = "torch_lm_shard_smoke.py"
RANKS = 4


def as_float64(dst: Path, reference: bool = False) -> Path:
    """A copy of ``src/repro_torch`` and the smoke under ``dst`` with
    every float32 cast a float64 one (``np.float32`` too: ``convert``'s),
    and with ``reference`` a copy of ``src/repro`` whose ``jnp.float32``
    / ``np.float32`` are float64 ones (run with ``JAX_ENABLE_X64``) ->
    the copy's ``src``."""
    ignore = shutil.ignore_patterns("__pycache__", "*.so")
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=ignore)
    (dst / "tools").mkdir()
    shutil.copy(ROOT / "tools" / SMOKE, dst / "tools" / SMOKE)
    for f in list((dst / "src").rglob("*.py")) + [dst / "tools" / SMOKE]:
        text = f.read_text()
        text = text.replace("torch.float32", "torch.float64")
        f.write_text(re.sub(r"\.float\(\)", ".double()",
                            text.replace("np.float32", "np.float64")))
    if reference:
        shutil.copytree(ROOT / "src" / "repro", dst / "src" / "repro",
                        ignore=ignore)
        for f in (dst / "src" / "repro").rglob("*.py"):
            f.write_text(f.read_text().replace("np.float32", "np.float64"))
    return dst / "src"


def rank_main(argv):
    """One rank: the smoke, with the mixers batch-local if
    ``REPRO_MIXERS_BATCH_LOCAL`` is set."""
    tools = Path(os.environ["REPRO_SMOKE_DIR"])
    sys.path.insert(0, str(tools))
    if os.environ.get("REPRO_MIXERS_BATCH_LOCAL"):
        from repro_torch.distributed.act_sharding import batch_local
        from repro_torch.models import lm
        lm.mixer = lambda fn, layout, x, params, *state, **kw: \
            batch_local(fn, x, params, *state, **kw)
    if os.environ.get("REPRO_MIXER_WHOLE", "none") != "none":
        contract_whole(set(os.environ["REPRO_MIXER_WHOLE"].split("+")))
    import torch_lm_shard_smoke as smoke
    return smoke.main(argv)


WHOLE_SITES = ("gates", "moment", "output", "ffn")


def contract_whole(sites: set) -> None:
    """``--whole``: the route on "model" with each product of ``sites``
    contracted whole on every rank (module docstring), by patching
    ``lm.mixer`` and the ``nn/ssm.py`` functions it reaches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.models import lm
    from repro_torch.nn import ssm
    if "all" in sites:
        sites = set(WHOLE_SITES)
    on = {}                       # the running mixer's "model" group

    def whole(t, dim, parts, size=None):
        """The ranks' shares of ``t`` on ``dim`` (``parts`` parts of
        ``size``, default even shares) in the global order: an all-gather
        of the shares padded to the largest."""
        n = on["n"]
        size = size or t.shape[dim] * n
        ivs = [acts._intervals(size, parts, n, q) for q in range(n)]
        m = max(sum(b - a for a, b in iv) for iv in ivs)
        t = t.movedim(dim, -1)
        g = acts._AllGather.apply(F.pad(t, (0, m - t.shape[-1])),
                                  on["group"])
        pieces = {}
        for q, iv in enumerate(ivs):
            at = q * m
            for a, b in iv:
                pieces[a] = g[..., at:at + b - a]
                at += b - a
        return torch.cat([pieces[a] for a in sorted(pieces)],
                         -1).movedim(-1, dim)

    def owned(t):
        """``t`` on "model"'s rank 0, zero on the others."""
        return t if on["r"] == 0 else t * 0.0

    def chan(tp, n_heads):
        """The parts of a channel dim of the layout (each head's share,
        or one block of whole heads: ``tp.heads``)."""
        return 1 if tp.heads else n_heads

    base_qkvif, base_norm = ssm._mlstm_qkvif, ssm._groupnorm_heads
    base_out = ssm._slstm_out

    def qkvif(p, xi, xc, n_heads, tp=ssm.ONE):
        q, k, v, i_raw, f_raw = base_qkvif(p, xi, xc, n_heads, tp)
        if on and "gates" in sites:
            i_raw, f_raw = gates(p, xc, n_heads, tp)
        return q, k, v, i_raw, f_raw

    def gates(p, xc, n_heads, tp):
        """The gates from the whole ``xc`` and ``w_if``; the rank's
        heads of them."""
        c, mine = chan(tp, n_heads), tp.heads or n_heads
        g = whole(xc, -1, c).float() @ whole(p["w_if"]["w"], 0, c)
        g = g.unflatten(-1, (2, n_heads))
        if mine < n_heads:
            g = acts._state_share(g, (g.dim() - 1, 1), on["n"], on["r"])
        g = g + p["w_if"]["b"].unflatten(-1, (2, mine))
        return g[..., 0, :], g[..., 1, :]

    def norm(h, g, n_heads, tp=ssm.ONE):
        if not on or tp is ssm.ONE or "moment" not in sites:
            return base_norm(h, g, n_heads, tp)
        shp = h.shape
        hh = h.reshape(*shp[:-1], n_heads, shp[-1] // n_heads).float()
        hw = whole(h, -1, n_heads)
        hw = hw.reshape(*shp[:-1], n_heads, hw.shape[-1] // n_heads).float()
        var = (hw * hw).mean(dim=-1, keepdim=True)
        hh = hh * torch.rsqrt(var + 1e-6)
        return (hh.reshape(shp) * g).to(h.dtype)

    def slstm_out(p, h, n_heads):
        if not on or "ffn" not in sites:
            return base_out(p, h, n_heads)
        d_ff = int(4 / 3 * h.shape[-1])          # slstm_init's ff_factor
        h = ssm._groupnorm_heads(h, p["out_norm_g"], n_heads)
        u1, u2 = (h @ whole(p["ff_up"], 1, 2, 2 * d_ff)).chunk(2, dim=-1)
        return owned((ssm._gelu(u1) * u2) @ whole(p["ff_down"], 0, 1, d_ff))

    def with_output(fn):
        """The mLSTM with its output product whole (``--whole output``):
        ``fn`` runs with ``down_proj`` an identity, so it returns the
        product's left operand, gathered here."""
        def g(params, *a, n_heads, tp=ssm.ONE, **kw):
            w = params["down_proj"]
            eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
            res = fn(dict(params, down_proj=eye), *a, n_heads=n_heads,
                     tp=tp, **kw)
            hz, st = res if isinstance(res, tuple) else (res, None)
            c = chan(tp, n_heads)
            out = owned(whole(hz, -1, c) @ whole(w, 0, c))
            return out if st is None else (out, st)
        return g

    def mixer(fn, layout, x, params, *state, **kw):
        from torch.distributed.tensor import DTensor
        mesh = x.device_mesh if isinstance(x, DTensor) else None
        if mesh is not None and "model" in mesh.mesh_dim_names and \
                mesh.size(mesh.mesh_dim_names.index("model")) > 1:
            md = mesh.mesh_dim_names.index("model")
            on.update(group=mesh.get_group(md), n=mesh.size(md),
                      r=mesh.get_local_rank(md))
        if on and "output" in sites and fn in (ssm.mlstm_apply,
                                               ssm.mlstm_step):
            fn = with_output(fn)
        try:
            return base_mixer(fn, layout, x, params, *state, **kw)
        finally:
            on.clear()
    base_mixer = lm.mixer
    lm.mixer = mixer
    ssm._mlstm_qkvif, ssm._groupnorm_heads = qkvif, norm
    ssm._slstm_out = slstm_out


def ulp_noise(arch: str, seq: int) -> list:
    """``--ulp-noise``: one row a site (module docstring)."""
    import math
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_lm_shard_smoke as smoke
    from repro_torch.models import lm
    from repro_torch.nn import ssm
    from repro_torch.tree import tree_leaves, tree_map
    torch.set_num_threads(1)
    args = smoke.parse_args(["--device", "cpu", "--arch", arch, "--reduced"])
    cfg = smoke.build_cfg(args)
    params = smoke.init_weights(cfg, 0, torch.device("cpu"))
    batch = smoke.batch_for(cfg, 8, seq, 0, 0, torch.device("cpu"))
    site = {"at": None}

    def noisy(name):
        def f(t):
            if site["at"] != name:
                return t
            up = torch.randint(0, 2, t.shape, generator=site["gen"]) > 0
            return torch.where(up, torch.nextafter(t, t + math.inf),
                               torch.nextafter(t, t - math.inf))
        return f
    calls = ("sum", "mean", "scatter", "gather")
    collectives = ssm.Collectives(*(noisy(k) for k in calls))
    out_noise = noisy("output")

    def wrapped(fn):
        def g(*a, **kw):
            res = fn(*a, tp=collectives, **kw)
            if isinstance(res, tuple):
                return (out_noise(res[0]),) + tuple(res[1:])
            return out_noise(res)
        return g

    def grads():
        site["gen"] = torch.Generator().manual_seed(0)
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm.loss_fn(live, cfg, batch)
        loss = loss[0] if isinstance(loss, tuple) else loss
        return torch.autograd.grad(loss, tree_leaves(live))

    saved = dict(lm.MIXERS)
    for k, (apply_fn, step_fn) in saved.items():
        lm.MIXERS[k] = (wrapped(apply_fn), step_fn)
    try:
        base = grads()
        norm = math.sqrt(sum(float(t.double().square().sum())
                             for t in base))
        rows = []
        for name in calls + ("output",):
            site["at"] = name
            moved = grads()
            n2 = math.sqrt(sum(float(t.double().square().sum())
                               for t in moved))
            rows.append({
                "site": name, "arch": cfg.name, "seq": seq,
                "gradients": max(smoke.grad_share(a, b, norm)
                                 for a, b in zip(moved, base)),
                "grad_norm": smoke.near_share(torch.tensor(n2),
                                              torch.tensor(norm))})
    finally:
        lm.MIXERS.update(saved)
    return rows


def count_layer(p, kind: str, n_heads: int, kw: dict, x_shape, mesh_shape,
                route: str, dtype=None) -> dict:
    """One mixer layer (weights ``p``, global; ``kw`` its ``nn/ssm.py``
    arguments) on an input of ``x_shape``, forward and the backward of
    ``out.sum()``, on rank 0 of a fake (data, model) = ``mesh_shape``
    process group through ``act_sharding.mixer`` (``route`` "tp") or
    ``batch_local`` -> ``op_analysis``'s result (fake tensors: nothing
    is computed); the input of ``dtype`` (default: the default)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import op_analysis
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import (batch_local,
                                                      gather_weights,
                                                      mixer, use_mesh)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import lm
    from repro_torch.nn import ssm
    from repro_torch.tree import tree_map
    fn = lm.MIXERS[kind][0]
    x = torch.empty(x_shape, dtype=dtype, device="meta")
    with dryrun.fake_ranks(MeshLayout(("data", "model"),
                                      mesh_shape)) as mesh:
        with FakeTensorMode(allow_non_fake_inputs=True):
            specs = {"mix": shd.param_specs({"mix": p}, mesh, "tp")["mix"],
                     "x": shd.batch_spec(mesh, x_shape[0], 2, "tp")}
            d = dryrun._fake_dtensors({"mix": p, "x": x}, specs, mesh)
            pd = tree_map(lambda t: t.requires_grad_(), d["mix"])
            xd = d["x"].requires_grad_()
            with op_analysis.OpCounter() as c, use_mesh(mesh, "tp"):
                w = gather_weights(pd)
                if route == "tp":
                    out = mixer(fn, lambda n: ssm.tp_layout(kind, p, n_heads,
                                                            n), xd, w,
                                **kw)
                else:
                    out = batch_local(fn, xd, w, **kw)
                out.sum().backward()
    return c.result()


def full_width_counts(arch: str) -> list:
    """``--count``: one row a mixer (module docstring)."""
    import torch
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    B = shape.global_batch // shape.n_microbatches
    _, pattern, _ = cfg.layer_plan()
    blocks = lm.param_shapes(cfg)["blocks"]
    rows = []
    for kind in dict.fromkeys(sp.kind for sp in pattern):
        if kind not in ("mamba", "mlstm", "slstm"):
            continue
        i = [sp.kind for sp in pattern].index(kind)
        p = tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype,
                                           device="meta"),
                     blocks[str(i)]["mix"])
        kw = (dict(d_state=cfg.mamba_d_state, chunk=cfg.mamba_chunk)
              if kind == "mamba" else
              dict(n_heads=cfg.n_heads, chunk=cfg.rnn_chunk))
        got = {r: count_layer(p, kind, cfg.n_heads, kw,
                              (B, shape.seq_len, cfg.d_model), (16, 16), r,
                              cfg.dtype())
               for r in ("tp", "batch")}
        tp, bl = got["tp"], got["batch"]
        whole = (16 * tp["flops_dot"] - bl["flops_dot"]) / 15
        rows.append({
            "arch": arch, "mixer": kind, "rows": B, "seq": shape.seq_len,
            "dot_flops_on_model": tp["flops_dot"],
            "dot_flops_batch_local": bl["flops_dot"],
            "dot_ratio": bl["flops_dot"] / tp["flops_dot"],
            "dot_flops_whole": whole,
            "whole_share": whole / tp["flops_dot"],
            "hbm_ratio": bl["hbm_bytes"] / tp["hbm_bytes"],
            "collective_bytes_on_model": tp["collective_bytes"],
            "collective_bytes_batch_local": bl["collective_bytes"]})
    return rows


def _tests_helpers():
    """``tests/torch_lm_truth_common.py`` and
    ``tests/torch_lm_ref_mixers_common.py`` (the parity runs and their
    spawn)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_lm_ref_mixers_common as runs
    import torch_lm_truth_common as truth
    return runs, truth


def parity(arch: str, site: str, float64: bool, timeout: float) -> list:
    """``--parity``: the parity test's cases with ``site`` whole, in
    float64 with ``float64`` (module docstring)."""
    runs, _ = _tests_helpers()
    with tempfile.TemporaryDirectory(prefix="mixer_parity_") as tmp:
        env = {"REPRO_MIXER_WHOLE": site}
        if float64:
            src = as_float64(Path(tmp) / "f64", reference=True)
            env.update(PYTHONPATH=str(src), JAX_ENABLE_X64="1",
                       REPRO_SMOKE_DIR=str(src.parent / "tools"))
        report = runs.spawn(Path(tmp), runs.LM, [arch], timeout, env)
    return [dict(case, whole=site, float64=float64)
            for case in report["cases"]]


def truth_rows(arch: str, timeout: float) -> list:
    """``--truth``: each train step of R1, RS, P1 and PS against its
    float64 truth G64, one row a run and step (module docstring)."""
    runs, truth = _tests_helpers()
    with tempfile.TemporaryDirectory(prefix="mixer_truth_") as tmp:
        npz = Path(tmp) / "runs.npz"
        runs.spawn(Path(tmp), runs.LM, [arch, str(npz)], timeout)
        got = truth.load_case(npz)[3]
        t = truth.truth(arch, npz)
    names = ["R1", "P1"] + [f"{w}{d}{m}" for d, m in runs.MESHES
                            for w in ("RS", "PS")]
    return [{"arch": arch, "run": name, "step": k,
             **truth.score(got[name]["train"][k], g64)}
            for k, g64 in enumerate(t["train"]) for name in names]


def run_ranks(args, extra_env: dict, steps: int = 2):
    """The smoke on ``RANKS`` ranks -> rank 0's summary, or None (printed)
    if a rank failed or overran."""
    with tempfile.TemporaryDirectory(prefix="mixer_tp_") as tmp:
        tmp = Path(tmp)
        src = as_float64(tmp / "f64") if args.float64 else ROOT / "src"
        out = tmp / "summary.json"
        env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1",
                   WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS),
                   REPRO_SMOKE_DIR=str(src.parent / "tools"
                                       if args.float64 else ROOT / "tools"),
                   **extra_env)
        if args.batch_local:
            env["REPRO_MIXERS_BATCH_LOCAL"] = "1"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--rank",
               "--device", "cpu", "--reduced", "--arch", args.arch,
               "--model", str(args.model), "--batch", "8",
               "--seq", str(args.seq), "--what", args.what,
               "--steps", str(steps), "--seed", str(args.seed),
               "--init-method", f"file://{tmp / 'store'}",
               "--json", str(out)]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env=dict(
            env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
        try:
            outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
        except subprocess.TimeoutExpired:
            print(json.dumps({"ok": False, "overran_s": args.timeout}))
            return None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        # rank 0 exits 1 on a check above its bound, with its summary
        if any(p.returncode for p in procs[1:]) or not out.exists():
            print("\n".join(o[-3000:] for o in outs), file=sys.stderr)
            print(json.dumps({"ok": False, "rcs": [p.returncode
                                                   for p in procs]}))
            return None
        return json.loads(out.read_text())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--batch-local", action="store_true",
                    help="the mixers batch-local (act_sharding.batch_local)")
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--what", default="train")
    ap.add_argument("--seed", type=int, default=0,
                    help="the smoke's --seed: its weights and batches")
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--ulp-noise", action="store_true",
                    help="one process: one ulp of noise where the ranks "
                         "sum (module docstring)")
    ap.add_argument("--whole", default=None, metavar="SITE[,SITE...]",
                    help="bisect by site: " + ", ".join(WHOLE_SITES) +
                    ", all (module docstring)")
    ap.add_argument("--parity", default=None, metavar="ARCH",
                    help="the parity test's cases, with --whole's sites "
                         "(module docstring)")
    ap.add_argument("--truth", default=None, metavar="ARCH",
                    help="the parity runs' train steps against their "
                         "float64 truth, in units of one ulp's response "
                         "(module docstring)")
    ap.add_argument("--count", action="store_true",
                    help="count one full-width layer of each mixer on a "
                         "fake pod1 group (module docstring)")
    args = ap.parse_args(argv)
    if args.ulp_noise or args.count or args.truth:
        rows = (ulp_noise(args.arch, args.seq) if args.ulp_noise
                else truth_rows(args.truth, args.timeout) if args.truth
                else full_width_counts(args.arch))
        for row in rows:
            print(json.dumps(row))
        return 0
    sites = ["none"] + (args.whole.split(",") if args.whole else [])
    if args.parity:
        for site in sites:
            for case in parity(args.parity, site, args.float64,
                               args.timeout):
                print(json.dumps(case))
        return 0
    if args.whole:
        for site in sites:
            s = run_ranks(args, {"REPRO_MIXER_WHOLE": site}, steps=1)
            if s is None:
                return 1
            print(json.dumps({
                "whole": site, "arch": s["arch"], "mesh": s["mesh"],
                "seq": args.seq, "seed": args.seed,
                "gradients": s["worst_share"]["step 0 gradients"],
                "grad_norm": s["worst_share"]["step 0 grad_norm"],
                "loss": s["worst_share"]["step 0 loss"]}))
        return 0
    s = run_ranks(args, {})
    if s is None:
        return 1
    print(json.dumps({
        "ok": s["ok"], "arch": s["arch"], "mesh": s["mesh"],
        "float64": args.float64, "seq": args.seq, "what": args.what,
        "mixers": "batch-local" if args.batch_local else "on model",
        "failed": s["failed"],
        "worst_share": {k: v for k, v in s["worst_share"].items() if v},
        "bytes_ok": all(r["param_bytes"] == r["param_bytes_expected"]
                        for r in s["per_rank"]
                        if r["param_bytes"] is not None),
        "step_s": s.get("step_s"),
        "one_process_step_s": s.get("one_process_step_s")}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        raise SystemExit(rank_main(sys.argv[2:]))
    raise SystemExit(main())
