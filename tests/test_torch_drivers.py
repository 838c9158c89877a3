"""The done slices' drivers on the port: ``examples/torch_train_traffic.py``
and ``examples/torch_train_warehouse.py`` pass the reference examples'
simulators and flags to ``repro_torch.launch.rl_train`` (extra flags pass
through), ``tools/torch_serve_chaos.py`` (the counterpart of
``tools/ci_serve_chaos.py``) passes on ``--device cpu``, and
``examples/torch_serve_lm.py`` serves on the CPU."""
import importlib.util
from pathlib import Path

import pytest

import test_torch_common  # noqa: F401  (one torch thread)

from repro_torch.launch import rl_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem,
                                                  ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("domain,sims", [
    ("traffic", ["ials", "untrained-ials", "gs"]),
    ("warehouse", ["ials", "untrained-ials", "f-ials", "gs"])])
def test_train_examples_wrap_rl_train(domain, sims, monkeypatch):
    calls = []
    monkeypatch.setattr(rl_train, "main", lambda argv: calls.append(argv))
    _load(f"examples/torch_train_{domain}.py").main(
        ["--iterations", "2", "--device", "cpu", "--n-envs", "4"])
    assert [c[c.index("--simulator") + 1] for c in calls] == sims
    for sim, argv in zip(sims, calls):
        args = rl_train.parse_args(argv)
        assert (args.domain, args.simulator, args.iterations, args.device,
                args.n_envs) == (domain, sim, 2, "cpu", 4)
        assert args.out == f"results/torch_{domain}_{sim}.json"


def test_train_example_defaults_are_the_references(monkeypatch):
    calls = []
    monkeypatch.setattr(rl_train, "main", lambda argv: calls.append(argv))
    _load("examples/torch_train_traffic.py").main([])
    args = rl_train.parse_args(calls[0])
    assert args.iterations == 30 and args.device == "cuda"


def test_serve_chaos_smoke_passes_on_the_cpu(capsys):
    mod = _load("tools/torch_serve_chaos.py")
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "serve-chaos: OK" in out and "corrupt reload rejected" in out


def test_serve_lm_example_runs_on_the_cpu(capsys):
    """``examples/torch_serve_lm.py`` (the counterpart of
    ``examples/serve_lm.py``): reduced deepseek-moe, 24-token prompts,
    16 greedy steps."""
    gen = _load("examples/torch_serve_lm.py").main(["--device", "cpu"])
    assert tuple(gen.shape) == (4, 17)
    assert 0 <= int(gen.min()) and int(gen.max()) < 256
    assert "generated (4, 17)" in capsys.readouterr().out
