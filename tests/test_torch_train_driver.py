"""The port's LM training driver (``repro_torch/launch/train.py``) on the
CPU at ``reduced()``: ``train.main`` prints and writes its history rows
(finite losses, the reference's row keys), gives the modality archs
their zero inputs, and refuses ``--device cuda`` without a card; a run
stopped by a real SIGTERM after 2 steps (the guard flushes a checkpoint
and the driver exits cleanly) and resumed for 2 more ends bitwise equal
to an uninterrupted 4-step run, parameters and optimizer state; a JAX
LM training state ``{"params", "opt"}`` is carried across by
``convert.to_torch`` (its ``AdamWState`` becomes the port's) and trained
on, and a checkpoint that the reference's ``launch/train.py`` wrote is
resumed by the port's driver, each against the reference's next step
within ``OPT_ATOL``; ``examples/torch_lm_pretrain.py`` runs and resumes."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_common import OPT_ATOL
from test_torch_lm import make_params

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.distributed import fault_tolerance  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--device", "cpu", "--arch", "qwen3-4b", "--reduced", "--batch",
        "4", "--seq", "16", "--microbatches", "2", "--warmup", "2",
        "--lr", "1e-3", "--log-every", "1"]


def _state_leaves(state):
    return tree_leaves((state["params"], state["opt"]))


def test_main_prints_and_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "rows.json"
    hist = train.main(ARGV + ["--steps", "3", "--metrics-out", str(out)])
    assert [r["step"] for r in hist] == [0, 1, 2]
    for r in hist:
        assert sorted(r) == ["ce", "grad_norm", "loss", "step",
                             "step_time_s"]
        assert np.isfinite([r["loss"], r["ce"], r["grad_norm"]]).all()
    assert json.loads(out.read_text()) == hist
    assert capsys.readouterr().out.count('"grad_norm"') == 3


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b",
                                  "deepseek-moe-16b", "xlstm-1.3b"])
def test_main_trains_every_family(arch):
    res = train.run(train.parse_args(
        ["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
         "--seq", "8", "--steps", "2", "--log-every", "1"]))
    assert len(res["history"]) == 2
    assert all(np.isfinite(r["loss"]) for r in res["history"])
    assert int(res["state"]["opt"].step) == 2


def test_layers_cuts_the_depth():
    args = train.parse_args(["--arch", "qwen3-4b", "--layers", "2"])
    cfg = train.config(args)
    assert cfg.n_layers == 2 and cfg.d_model == 2560


def _sigterm_after(monkeypatch, at_step):
    """A real SIGTERM to this process once the guard's call at
    ``at_step`` returned: the next step trains, and the call after it
    answers the signal."""
    orig = fault_tolerance.TrainingGuard.maybe_save

    def save_then_signal(self, step, state, **kw):
        saved = orig(self, step, state, **kw)
        if step == at_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return saved
    monkeypatch.setattr(fault_tolerance.TrainingGuard, "maybe_save",
                        save_then_signal)


def test_stopped_and_resumed_run_is_bitwise_the_uninterrupted_one(
        tmp_path, monkeypatch, capsys):
    full = train.run(train.parse_args(ARGV + ["--steps", "4"]))
    before = signal.getsignal(signal.SIGTERM)
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _sigterm_after(m, 1)
        part = train.run(train.parse_args(
            ARGV + ["--steps", "4", "--ckpt-dir", ck, "--save-every",
                    "100"]))
    assert part["preempted"] and len(part["history"]) == 2
    assert ckpt.all_steps(ck) == [2]
    assert signal.getsignal(signal.SIGTERM) == before
    assert "preempted: checkpoint flushed" in capsys.readouterr().out
    res = train.run(train.parse_args(
        ARGV + ["--steps", "4", "--ckpt-dir", ck, "--save-every", "100"]))
    assert res["start_step"] == 2 and not res["preempted"]
    assert [r["step"] for r in res["history"]] == [2, 3]
    assert [r["loss"] for r in res["history"]] == \
        [r["loss"] for r in full["history"][2:]]
    a, b = _state_leaves(full["state"]), _state_leaves(res["state"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert ckpt.all_steps(ck) == [2, 4]


def _ref_state(cfg_j, np_params, n_steps, data, opt):
    step = jax.jit(jsteps.make_train_step(cfg_j, opt, 2))
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    st = opt.init(p)
    out = []
    for s in range(n_steps):
        p, st, _ = step(p, st, {k: jnp.asarray(v)
                                for k, v in data.get_batch(s).items()})
        out.append({"params": p, "opt": st})
    return out


def _close_states(port, ref):
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(ref)}
    got = tree_leaves_with_path(port)
    assert [p for p, _ in got] == list(want)
    for path, x in got:
        np.testing.assert_allclose(x.numpy(), want[path], atol=OPT_ATOL,
                                   err_msg=path)


def test_a_jax_training_state_is_carried_across_and_trained_on():
    jcfg = jbase.reduced(jbase.get_config("qwen3-4b"))
    tcfg = tbase.reduced(tbase.get_config("qwen3-4b"))
    np_params, _ = make_params(tcfg)
    data = TokenPipeline(DataConfig(16, 4, tcfg.vocab_size, seed=0))
    ref = _ref_state(jcfg, np_params, 2,
                     data, jadamw.adamw(jadamw.cosine_schedule(1e-3, 2, 4)))
    state = convert.to_torch(jax.tree_util.tree_map(np.asarray, ref[0]),
                             device="cpu")
    assert isinstance(state["opt"], tadamw.AdamWState)
    assert state["opt"].step.dtype == torch.int32
    assert state["opt"].step.device.type == "cpu"
    assert int(state["opt"].step) == 1
    opt = tadamw.adamw(tadamw.cosine_schedule(1e-3, 2, 4))
    step = tsteps.make_train_step(tcfg, opt, 2)
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
         for k, v in data.get_batch(1).items()}
    params, ost, _ = step(state["params"], state["opt"], b)
    assert int(ost.step) == 2
    _close_states({"params": params, "opt": ost}, ref[1])


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's ``launch/train.py`` saves at steps 1 and 2; the
    port's driver resumes the step-1 checkpoint and trains step 2 to the
    reference's step-2 checkpoint."""
    argv = ["--arch", "qwen3-4b", "--reduced", "--batch", "4", "--seq",
            "16", "--microbatches", "2", "--warmup", "2", "--lr", "1e-3",
            "--steps", "2", "--save-every", "1"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    os.rename(tmp_path / "ref" / "step_000000001",
              port_dir / "step_000000001")
    res = train.run(train.parse_args(
        argv + ["--device", "cpu", "--ckpt-dir", str(port_dir)]))
    assert res["start_step"] == 1 and int(res["state"]["opt"].step) == 2
    jcfg = jbase.reduced(jbase.get_config("qwen3-4b"))
    opt = jadamw.adamw(0.0)
    target = {"params": jax.eval_shape(
        lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))}
    target["opt"] = jax.eval_shape(opt.init, target["params"])
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), target)
    want, step, _ = jckpt.restore(tmp_path / "ref", target, 2)
    assert step == 2
    _close_states(res["state"], want)


def test_cuda_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])


def test_the_pretrain_example_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    args = [sys.executable, str(ROOT / "examples/torch_lm_pretrain.py"),
            "--device", "cpu", "--steps", "3", "--ckpt-dir",
            str(tmp_path / "ck"), "--metrics-out",
            str(tmp_path / "m.json")]
    first = subprocess.run(args, capture_output=True, text=True,
                           timeout=300, env=env)
    assert first.returncode == 0, first.stderr[-3000:]
    rows = json.loads((tmp_path / "m.json").read_text())
    assert [r["step"] for r in rows] == [0, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    args[args.index("--steps") + 1] = "4"
    again = subprocess.run(args, capture_output=True, text=True,
                           timeout=300, env=env)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 3" in again.stdout
