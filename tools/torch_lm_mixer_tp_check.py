"""Is the recurrent mixers' tensor-parallel drift rounding or a fault?

Under a mesh the port runs the recurrent mixers (Mamba, mLSTM, sLSTM) on
batch-local blocks with their weights gathered
(``distributed/act_sharding.py::batch_local``). This check runs
``tools/torch_lm_shard_smoke.py`` on gloo ranks on the CPU the other way
too: the mixers straight on the ``DTensor``s, their weights left on
"model" by the rules (the reference's tensor-parallel layout, DTensor
choosing the collectives), in float32 and, with ``--float64``, in
float64 (a copy of ``src/repro_torch`` and the smoke with every float32
cast made a float64 one). A difference from the one-process step that is
the order of sums shrinks by ~1e9 from float32 to float64; a fault does
not. ``F.logsigmoid`` is replaced by the same function with its backward
written out (DTensor has no sharding rule for ``log_sigmoid_backward``).

    python tools/torch_lm_mixer_tp_check.py [--float64] [--batch-local] \\
        [--seq 32] [--timeout 900]

It runs xlstm-1.3b at ``reduced()`` (mLSTM and sLSTM layers), two train
steps of B = 8 rows in 2 microbatches, on 4 ranks (data 2, model 2).

Prints rank 0's summary's shares of the bounds above 0 (the smoke's
``worst_share``) and the step times (the sharded steps', rank 0's
one-process steps') as one JSON line; exits 1 if a rank failed or
overran.
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


def as_float64(dst: Path) -> Path:
    """A copy of ``src/repro_torch`` and the smoke under ``dst`` with
    every float32 cast a float64 one -> the copy's ``src``."""
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    (dst / "tools").mkdir()
    shutil.copy(ROOT / "tools" / SMOKE, dst / "tools" / SMOKE)
    for f in list((dst / "src").rglob("*.py")) + [dst / "tools" / SMOKE]:
        text = f.read_text()
        f.write_text(re.sub(r"\.float\(\)", ".double()",
                            text.replace("torch.float32", "torch.float64")))
    return dst / "src"


def rank_main(argv):
    """One rank: the smoke, with the mixers on the DTensors unless
    ``REPRO_MIXERS_BATCH_LOCAL`` is set."""
    import torch
    import torch.nn.functional as F
    tools = Path(os.environ["REPRO_SMOKE_DIR"])
    sys.path.insert(0, str(tools))
    if not os.environ.get("REPRO_MIXERS_BATCH_LOCAL"):
        from repro_torch.models import lm
        logsigmoid = F.logsigmoid

        class LogSigmoid(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return logsigmoid(x)

            @staticmethod
            def backward(ctx, g):
                x, = ctx.saved_tensors
                z = torch.exp(-torch.abs(x))
                s = z / (1 + z)
                return g * torch.where(x < 0, 1 - s, s)
        F.logsigmoid = LogSigmoid.apply
        lm.batch_local = lambda fn, x, params, *state, **kw: \
            fn(params, *state, x, **kw)
    import torch_lm_shard_smoke as smoke
    return smoke.main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--batch-local", action="store_true",
                    help="the port's own route (batch-local mixers)")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=900)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="mixer_tp_") as tmp:
        tmp = Path(tmp)
        src = as_float64(tmp / "f64") if args.float64 else ROOT / "src"
        out = tmp / "summary.json"
        env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1",
                   WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS),
                   REPRO_SMOKE_DIR=str(src.parent / "tools"
                                       if args.float64 else ROOT / "tools"))
        if args.batch_local:
            env["REPRO_MIXERS_BATCH_LOCAL"] = "1"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--rank",
               "--device", "cpu", "--reduced", "--arch", "xlstm-1.3b",
               "--model", "2", "--batch", "8", "--seq", str(args.seq),
               "--what", "train",
               "--init-method", f"file://{tmp / 'store'}",
               "--json", str(out)]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env=dict(
            env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
        try:
            outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
        except subprocess.TimeoutExpired:
            print(json.dumps({"ok": False, "overran_s": args.timeout}))
            return 1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode for p in procs) or not out.exists():
            print("\n".join(o[-3000:] for o in outs), file=sys.stderr)
            print(json.dumps({"ok": False, "rcs": [p.returncode
                                                   for p in procs]}))
            return 1
        s = json.loads(out.read_text())
    print(json.dumps({
        "ok": s["ok"], "arch": s["arch"], "mesh": s["mesh"],
        "float64": args.float64,
        "mixers": "batch-local" if args.batch_local else "DTensor, on model",
        "failed": s["failed"],
        "worst_share": {k: v for k, v in s["worst_share"].items() if v},
        "step_s": s.get("step_s"),
        "one_process_step_s": s.get("one_process_step_s")}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        raise SystemExit(rank_main(sys.argv[2:]))
    raise SystemExit(main())
