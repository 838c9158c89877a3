"""Docs drift gate of the PyTorch/CUDA port (the counterpart of
``tools/docs_check.py``, which covers the reference tree).

    python3 tools/torch_docs_check.py      # exit 1 and a line an error

Fails when the port's documentation and its tree disagree:
  1. ``docs/TORCH_ARCHITECTURE.md`` is missing;
  2. a module under ``src/repro_torch`` lacks a module docstring;
  3. a ``python -m <module>`` entry point quoted in the doc (or in the
     README) does not resolve to a module under ``src/`` or the root;
  4. a ``path/to/file.py::symbol`` reference in the doc names a file of
     the port that does not exist, or a symbol it does not define at top
     level;
  5. a script the doc quotes (``python examples/...py``, ``python3
     tools/...py``, ``chip_smoke.py``) does not exist;
  6. a required snippet (``REQUIRED_SNIPPETS``: the dispatch cells, the
     protocol adapters, the entry points) is no longer quoted.
Pure standard library; it imports nothing of the port, so it keeps
working when the port is broken. The helpers that do not depend on which
tree is checked (the quote scanner, the module lookup, the top-level name
scan) are ``tools/docs_check.py``'s own, loaded from its file.
"""
from __future__ import annotations

import ast
import importlib.util
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DOC = "docs/TORCH_ARCHITECTURE.md"
README = "README.md"
PORT = "src/repro_torch"
_SYMBOL_ROOTS = ("", "src", PORT)

REQUIRED_SNIPPETS = (
    # the dispatch layer and the single-agent horizon
    "kernels/ops.py::ials_rollout",
    "kernels/ref.py::ials_rollout_ref",
    "kernels/aip_step.py::aip_rollout",
    "kernels/ops.py::policy_rollout",
    "kernels/aip_step.py::LAUNCHES",
    # the randomness rule and the launch plans
    "repro_torch/__init__.py::stream",
    "kernels/aip_step.py::rollout_plan",
    "kernels/aip_step.py::serve_plan",
    "kernels/gru.py::gru_plan",
    "kernels/flash_attention.py::f32_plan",
    # the scalar protocol and its adapters
    "envs/api.py::Env",
    "envs/api.py::LocalEnv",
    "envs/api.py::batch_env",
    "envs/api.py::batch_local_env",
    "envs/api.py::unbatch_env",
    "envs/api.py::as_batched",
    "envs/api.py::env_rollout",
    "core/ials.py::make_ials",
    "core/ials.py::make_multi_ials",
    "core/engine.py::make_batched_ials",
    "rl/ppo.py::make_train_iteration",
    "rl/ppo.py::make_evaluator",
    # the guard's deliberate difference
    "distributed/fault_tolerance.py::TrainingGuard",
    # lane data parallelism
    "distributed/sharding.py::shard_ials_state",
    "distributed/sharding.py::gather_ials_state",
    "kernels/aip_step.py::shard_plan",
    "launch/mesh.py::make_host_mesh",
    "tools/torch_shard_smoke.py",
    # the roofline contract
    "distributed/op_analysis.py::analyze",
    "distributed/op_analysis.py::roofline",
    "distributed/sharding.py::LayoutRank",
    "launch/mesh.py::make_production_mesh",
    "launch/dryrun.py::_ials_model_flops",
    "python -m repro_torch.launch.dryrun",
    # LM serving
    "models/lm.py::decode_step",
    "nn/attention.py::decode_attention",
    "python -m repro_torch.launch.serve",
    # LM training
    "launch/steps.py::make_train_step",
    "optim/adamw.py::cosine_schedule",
    "data/pipeline.py::TokenPipeline",
    "models/lm.py::checkpoint_name",
    "python -m repro_torch.launch.train",
    "python examples/torch_lm_pretrain.py",
    # LM sharding
    "distributed/act_sharding.py::constrain",
    "distributed/sharding.py::param_specs",
    "distributed/sharding.py::to_placements",
    "launch/specs.py::train_input_specs",
    "launch/dryrun.py::run_cell",
    "launch/dryrun.py::trip_points",
    "nn/ssm.py::associative_scan",
    "tools/torch_xlstm_card_check.py",
    "nn/moe_ep.py::moe_apply_ep",
    "python -m repro_torch.launch.attribute",
    "tools/torch_lm_shard_smoke.py",
    "tools/torch_lm_mixer_tp_check.py",
    # entry points
    "python -m repro_torch.launch.rl_train",
    "python -m repro_torch.launch.policy_serve",
    "python examples/torch_quickstart.py",
    "python3 tools/torch_serve_chaos.py",
    "python3 chip_smoke.py",
)


def _load_reference_checker():
    spec = importlib.util.spec_from_file_location(
        "docs_check", Path(__file__).resolve().parent / "docs_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_dc = _load_reference_checker()
_code_snippets = _dc._code_snippets      # fenced blocks and inline spans
_module_exists = _dc._module_exists      # a module under src/ or the root
top_level_names = _dc._top_level_names   # defs, classes, assigns, imports


def _read(name: str) -> str | None:
    path = REPO / name
    return path.read_text() if path.is_file() else None


def missing_docs() -> list[str]:
    return [] if (REPO / DOC).is_file() else [f"missing doc: {DOC}"]


def missing_docstrings() -> list[str]:
    errors = []
    for path in sorted((REPO / PORT).rglob("*.py")):
        if not ast.get_docstring(ast.parse(path.read_text())):
            errors.append(f"module docstring missing: "
                          f"{path.relative_to(REPO)}")
    return errors


def stale_module_refs() -> list[str]:
    errors = []
    for name in (DOC, README):
        text = _read(name)
        if text is None:
            continue
        for ref in re.findall(r"-m\s+(repro_torch[\w.]*)",
                              _code_snippets(text)):
            if not _module_exists(ref):
                errors.append(f"{name} quotes `python -m {ref}` but no "
                              f"such module exists")
    return errors


def resolve(rel: str):
    for root in _SYMBOL_ROOTS:
        p = REPO / root / rel
        if p.is_file():
            return p
    return None


def stale_symbol_refs() -> list[str]:
    text = _read(DOC)
    if text is None:
        return []
    errors = []
    for rel, sym in re.findall(r"([\w][\w/.-]*\.py)::(\w+)",
                               _code_snippets(text)):
        target = resolve(rel)
        if target is None:
            errors.append(f"{DOC} references `{rel}::{sym}` but no such "
                          f"file exists")
        elif sym not in top_level_names(target):
            errors.append(f"{DOC} references `{rel}::{sym}` but {rel} "
                          f"defines no top-level `{sym}`")
    return errors


def stale_script_refs() -> list[str]:
    text = _read(DOC)
    if text is None:
        return []
    errors = []
    for rel in re.findall(r"python3?\s+((?:examples|tools)/[\w/]+\.py|"
                          r"chip_smoke\.py)", _code_snippets(text)):
        if not (REPO / rel).is_file():
            errors.append(f"{DOC} quotes the script `{rel}` but it does "
                          f"not exist")
    return errors


def missing_required_snippets() -> list[str]:
    text = _read(DOC)
    if text is None:
        return []
    quoted = _code_snippets(text)
    return [f"{DOC} no longer quotes the required snippet `{s}`"
            for s in REQUIRED_SNIPPETS if s not in quoted]


def run_checks() -> list[str]:
    return (missing_docs() + missing_docstrings() + stale_module_refs()
            + stale_symbol_refs() + stale_script_refs()
            + missing_required_snippets())


def main() -> int:
    errors = run_checks()
    for e in errors:
        print(f"torch-docs-check: {e}", file=sys.stderr)
    if not errors:
        print("torch-docs-check: ok")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
