"""The port stands alone: importing every ``repro_torch`` module leaves
``jax`` and ``repro`` out of ``sys.modules``; no module of
``src/repro_torch`` (the dry-run, ``launch/dryrun.py``, and its op
count, ``distributed/op_analysis.py``, included), not ``chip_smoke.py``
and not the five ablation tools, the profiler check, the fault smoke, the
shard smokes (the IALS and the LM one), the iteration profile and the
xlstm card check that run beside it on the card, not the port's
examples (the
quickstart, the two training sweeps, the LM serving demo, the LM
pretraining example) and not the chaos smoke and docs
check import them; and without CUDA the entry points
refuse the default device instead of carrying on on the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

import test_torch_common  # noqa: F401  (one torch thread)

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(("repro_torch",) + p.relative_to(PORT).with_suffix(
        "").parts).replace(".__init__", "") for p in PORT.rglob("*.py"))


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    mods = _modules()
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 15


def test_the_analysis_modules_are_checked():
    """The dry-run, the op count, the pods' layouts and the LM's serving
    and training modules are among the modules both tests above and below
    read."""
    mods = _modules()
    for m in ("repro_torch.launch.dryrun",
              "repro_torch.distributed.op_analysis",
              "repro_torch.launch.mesh", "repro_torch.models.lm",
              "repro_torch.launch.serve", "repro_torch.nn.ssm",
              "repro_torch.configs.archs", "repro_torch.launch.train",
              "repro_torch.launch.steps", "repro_torch.data.pipeline",
              "repro_torch.optim.grad_compress",
              "repro_torch.optim.adamw",
              "repro_torch.distributed.act_sharding",
              "repro_torch.distributed.sharding",
              "repro_torch.launch.specs", "repro_torch.launch.attribute",
              "repro_torch.nn.moe_ep"):
        assert m in mods, m


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tools/flash_tc_ablation.py",
       "tools/flash_f32_ablation.py", "tools/serve_ablation.py",
       "tools/rollout_ablation.py", "tools/gru_ablation.py",
       "tools/profile_count.py", "tools/torch_fault_smoke.py",
       "tools/iteration_profile.py", "tools/torch_serve_chaos.py",
       "tools/torch_docs_check.py", "tools/torch_shard_smoke.py",
       "tools/torch_lm_shard_smoke.py", "tools/torch_lm_mixer_tp_check.py",
       "tools/torch_xlstm_card_check.py",
       "examples/torch_quickstart.py",
       "examples/torch_train_traffic.py",
       "examples/torch_train_warehouse.py",
       "examples/torch_serve_lm.py", "examples/torch_lm_pretrain.py"]))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {n}"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.launch import rl_train, train
    for domain in ("traffic", "warehouse"):
        with pytest.raises(RuntimeError, match="cuda"):
            rl_train.run_training(rl_train.parse_args(
                ["--iterations", "1", "--domain", domain]))
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(train.parse_args(["--arch", "qwen3-4b", "--reduced"]))
