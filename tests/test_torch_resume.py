"""Preemption-safe training in the port's ``rl_train`` (``--ckpt-dir``,
``--save-every``): a run stopped after k iterations and resumed from its
checkpoint finishes bitwise equal (``final_params_md5``) to the
uninterrupted same-seed run, on traffic (FNN, A = 1) and the warehouse
(GRU, A = 3); ``params_md5`` is the JAX entry point's digest; a
checkpoint the JAX ``rl_train`` wrote resumes in the port with every
leaf in the JAX package's order and bitwise equal; and
``tools/torch_fault_smoke.py`` sends a real SIGTERM to a real
subprocess and resumes it bitwise."""
import json
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one torch thread)

import torch  # noqa: E402

from repro.launch import rl_train as jrl  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import rl_train  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--eval-every", "1", "--collect-episodes", "4", "--aip-epochs", "1",
        "--n-envs", "4", "--rollout-len", "8", "--episode-len", "6",
        "--device", "cpu", "--seed", "2"]


def _run(argv):
    return rl_train.run_training(rl_train.parse_args(TINY + argv))


@pytest.mark.parametrize("domain,argv,k,n", [
    ("traffic", ["--aip", "fnn"], 1, 3),
    ("warehouse", ["--aip", "gru", "--n-agents", "3"], 1, 2),
    ("traffic", ["--simulator", "f-ials", "--aip", "gru"], 2, 3),
], ids=["traffic-fnn-1", "warehouse-gru-3", "traffic-f-ials"])
def test_resume_is_bitwise_equal_to_the_uninterrupted_run(domain, argv, k,
                                                          n, tmp_path):
    argv = argv + ["--domain", domain]
    full = _run(argv + ["--iterations", str(n)])
    ck = ["--ckpt-dir", str(tmp_path), "--save-every", "1"]
    part = _run(argv + ["--iterations", str(k)] + ck)
    assert ckpt.latest_step(tmp_path) == k and not part["preempted"]
    res = _run(argv + ["--iterations", str(n)] + ck)
    assert res["resumed_from"] == k and res["diag"]["resumed_from"] == k
    assert [r["iter"] for r in res["history"]] == list(range(k, n))
    assert res["final_params_md5"] == full["final_params_md5"]
    assert res["history"][-1]["gs_eval_reward"] == \
        full["history"][-1]["gs_eval_reward"]
    assert part["final_params_md5"] != full["final_params_md5"]


def test_sigterm_flushes_and_exits_cleanly(tmp_path, monkeypatch):
    """A real SIGTERM to this process after the first iteration: the
    guard flushes a checkpoint at the next boundary, the run prints the
    flush line and returns ``preempted``, and the handler is restored."""
    import os
    import signal
    from repro_torch.distributed import fault_tolerance
    orig = fault_tolerance.TrainingGuard.maybe_save
    before = signal.getsignal(signal.SIGTERM)

    def save_then_signal(self, step, state, **kw):
        saved = orig(self, step, state, **kw)
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return saved

    monkeypatch.setattr(fault_tolerance.TrainingGuard, "maybe_save",
                        save_then_signal)
    out = _run(["--iterations", "4", "--ckpt-dir", str(tmp_path),
                "--save-every", "100"])
    assert out["preempted"] and len(out["history"]) == 2
    assert ckpt.all_steps(tmp_path) == [2]
    assert signal.getsignal(signal.SIGTERM) == before


def test_a_signal_just_before_the_save_is_flushed_and_seen(tmp_path,
                                                         monkeypatch):
    """A SIGTERM that lands after an iteration's row and before the save
    reads the flag (``tools/torch_fault_smoke.py`` signals right after the
    row streams past): that save answers it, and the driver exits on it
    instead of training on with the signal cleared."""
    from repro_torch.distributed import fault_tolerance
    orig = fault_tolerance.TrainingGuard.maybe_save

    def signal_then_save(self, step, state, **kw):
        if step == 1:
            self.preempted = True      # what the handler does
        return orig(self, step, state, **kw)

    monkeypatch.setattr(fault_tolerance.TrainingGuard, "maybe_save",
                        signal_then_save)
    out = _run(["--iterations", "4", "--ckpt-dir", str(tmp_path),
                "--save-every", "100"])
    assert out["preempted"] and len(out["history"]) == 1
    assert ckpt.all_steps(tmp_path) == [1]


def test_params_md5_is_the_reference_digest():
    rng = np.random.default_rng(0)
    tree = {"l1": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                   "b": np.zeros(3, np.float32)},
            "it": np.int32(4), "mask": rng.random(6) < 0.5}
    port = {"l1": {k: torch.from_numpy(v) for k, v in tree["l1"].items()},
            "it": torch.tensor(4, dtype=torch.int32),
            "mask": torch.from_numpy(tree["mask"])}
    jtree = {"l1": {k: jnp.asarray(v) for k, v in tree["l1"].items()},
             "it": jnp.int32(4), "mask": jnp.asarray(tree["mask"])}
    assert rl_train.params_md5(port) == jrl.params_md5(jtree)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX ``rl_train`` writes ``{"policy", "opt", "rs", "sim", "it"}``
    after one iteration; the port's ``rl_train`` restores it (every leaf
    at the JAX path, bitwise) and trains on from iteration 1."""
    base = ["--domain", "traffic", "--simulator", "ials", "--eval-every",
            "100", "--n-envs", "8", "--rollout-len", "8", "--episode-len",
            "16", "--collect-episodes", "2", "--aip-epochs", "1", "--seed",
            "4", "--ckpt-dir", str(tmp_path), "--save-every", "1"]
    jout = jrl.main(base + ["--iterations", "1"])
    assert ckpt.latest_step(tmp_path) == 1 and not jout["preempted"]
    restored = []
    orig = ckpt.restore
    monkeypatch.setattr(ckpt, "restore", lambda *a, **kw: restored.append(
        orig(*a, **kw)) or restored[-1])
    out = rl_train.main(base + ["--iterations", "3", "--device", "cpu"])
    assert out["resumed_from"] == 1
    assert [r["iter"] for r in out["history"]] == [1, 2]
    for r in out["history"]:
        assert math.isfinite(r["loss"]) and math.isfinite(r["train_reward"])
    assert 0.0 <= out["history"][-1]["gs_eval_reward"] <= 1.0

    tree = restored[0][0]
    d = tmp_path / "step_000000001"
    meta = ckpt.read_metadata(tmp_path, 1)
    assert meta["mode"] == "integrated"
    from repro_torch.checkpoint import mpack
    raw_meta = mpack.unpackb((d / "meta.msgpack").read_bytes())
    leaves = tree_leaves_with_path(tree)
    assert [p for p, _ in leaves] == raw_meta["paths"]
    # the port's own checkpoint of the resumed run: the JAX layout
    own = mpack.unpackb((tmp_path / "step_000000003" /
                         "meta.msgpack").read_bytes())
    assert (own["paths"], own["dtypes"], own["shapes"]) == \
        (raw_meta["paths"], raw_meta["dtypes"], raw_meta["shapes"])
    with np.load(d / "arrays.npz") as data:
        for i, (path, leaf) in enumerate(leaves):
            want = data[f"leaf_{i:05d}"].view(raw_meta["dtypes"][i])
            got = (leaf.numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf, want.dtype))
            assert got.dtype == want.dtype, path
            np.testing.assert_array_equal(got.reshape(-1), want,
                                          err_msg=path)


def test_fault_smoke_tool_on_the_cpu(tmp_path):
    """``tools/torch_fault_smoke.py --device cpu``: the uninterrupted run,
    the SIGTERM'd run (clean exit after the flush line) and the resumed
    run, whose params and final GS eval equal the first's bitwise."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    res = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "torch_fault_smoke.py"),
                          "--device", "cpu"],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "BITWISE RESUME OK" in res.stdout
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["resumed_from"] >= 1
    assert summary["oracle_md5"] == summary["resumed_md5"]
