"""The port's ``launch/steps.py::make_train_step`` against the
reference's jitted ``repro/launch/steps.py::make_train_step`` on the CPU,
float32 at ``reduced()``: 2 steps at 2 microbatches (and one arch at 1)
under a cosine AdamW, on the reference's data pipeline's batches, from
the same weights -> the parameters, ``mu``, ``nu``, ``step`` and every
metric (``loss``, ``ce``, ``lb_loss``, ``z_loss``, ``drop_frac``,
``grad_norm``, ``lr``) after each step.

Tolerances: metrics at ``LM_TOL`` (``grad_norm`` 1e-5 relative, ``lr``
and ``step`` exact); parameters within ``OPT_ATOL`` (AdamW's first steps
move a parameter by ~lr whatever its gradient's size, so a gradient that
differs in its last bits moves it by a few 1e-5 at lr 1e-3); the moments
within ``MOMENT_TOL`` (1e-3 relative, plus 1e-6 on ``mu`` and 1e-7 on
``nu``, ~30x what was measured)."""
import numpy as np
import pytest

from test_torch_common import OPT_ATOL
from test_torch_lm import LM_TOL, make_params

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa

MOMENT_TOL = {"mu": (1e-6, 1e-3), "nu": (1e-7, 1e-3)}
SCHEDULE = (1e-3, 1, 4)           # peak, warmup, total
CASES = [("qwen3-4b", 2), ("deepseek-moe-16b", 2), ("qwen3-4b", 1)]
BATCH, SEQ = 4, 16


def _batch_t(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            for k, v in b.items()}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-mb{c[1]}")
def run(request):
    arch, n_mb = request.param
    jcfg = jbase.reduced(jbase.get_config(arch))
    tcfg = tbase.reduced(tbase.get_config(arch))
    np_params, tparams = make_params(tcfg)
    data = TokenPipeline(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                    vocab_size=tcfg.vocab_size, seed=0))
    jopt = jadamw.adamw(jadamw.cosine_schedule(*SCHEDULE))
    topt = tadamw.adamw(tadamw.cosine_schedule(*SCHEDULE))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, n_mb))
    tstep = tsteps.make_train_step(tcfg, topt, n_mb)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jopt.init(jp)
    ts = topt.init(tparams)
    leaves = tree_leaves((tparams, ts.mu, ts.nu))
    steps = []
    for step in range(2):
        b = data.get_batch(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        out = tstep(tparams, ts, _batch_t(b))
        tparams, ts, tm = out
        steps.append(dict(
            jp=jax.tree_util.tree_map(np.asarray, jp),
            jmu=jax.tree_util.tree_map(np.asarray, js.mu),
            jnu=jax.tree_util.tree_map(np.asarray, js.nu),
            jstep=int(js.step), jm={k: np.asarray(v) for k, v in jm.items()},
            tp={p: x.clone() for p, x in tree_leaves_with_path(tparams)},
            tmu={p: x.clone() for p, x in tree_leaves_with_path(ts.mu)},
            tnu={p: x.clone() for p, x in tree_leaves_with_path(ts.nu)},
            tstep=ts.step, tm=tm))
    return dict(arch=arch, steps=steps, leaves=leaves,
                final=tree_leaves((tparams, ts.mu, ts.nu)))


def _by_path(tree):
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("step", [0, 1])
def test_metrics_match(run, step):
    s = run["steps"][step]
    assert sorted(s["tm"]) == sorted(s["jm"])
    for k, want in s["jm"].items():
        got = s["tm"][k]
        assert isinstance(got, torch.Tensor) and got.dim() == 0, k
        if k == "lr":
            assert float(got) == float(want)
        elif k == "grad_norm":
            np.testing.assert_allclose(float(got), want, rtol=1e-5)
        else:
            np.testing.assert_allclose(float(got), want, atol=LM_TOL[0],
                                       rtol=LM_TOL[1], err_msg=k)
    if run["arch"] == "deepseek-moe-16b":
        assert float(s["tm"]["lb_loss"]) > 0 and float(s["tm"]["z_loss"]) > 0


@pytest.mark.parametrize("step", [0, 1])
def test_params_and_moments_match(run, step):
    s = run["steps"][step]
    assert s["tstep"].dtype == torch.int32 and int(s["tstep"]) == \
        s["jstep"] == step + 1
    for name, got, want, (atol, rtol) in (
            ("params", s["tp"], s["jp"], (OPT_ATOL, 0.0)),
            ("mu", s["tmu"], s["jmu"], MOMENT_TOL["mu"]),
            ("nu", s["tnu"], s["jnu"], MOMENT_TOL["nu"])):
        want = _by_path(want)
        assert list(got) == list(want), name
        for path, x in got.items():
            np.testing.assert_allclose(x.numpy(), want[path], atol=atol,
                                       rtol=rtol, err_msg=f"{name}{path}")


def test_the_step_updates_in_place(run):
    """The parameters and moments the step was given are the ones it
    returns, written in place (the reference donates them)."""
    assert all(a is b for a, b in zip(run["leaves"], run["final"]))


def test_a_batch_that_does_not_split_is_refused():
    cfg = tbase.reduced(tbase.get_config("qwen3-4b"))
    _, params = make_params(cfg)
    opt = tadamw.adamw(1e-3)
    step = tsteps.make_train_step(cfg, opt, 3)
    b = {"tokens": torch.zeros((4, 8), dtype=torch.long),
         "labels": torch.zeros((4, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="microbatches"):
        step(params, opt.init(params), b)
