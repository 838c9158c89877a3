"""The xLSTM's mixers (mLSTM, sLSTM) on "model"
(``distributed/act_sharding.py::mixer``) under the "tp" profile, xlstm
``reduced()`` (2 heads) through ``tools/torch_lm_shard_smoke.py``
against the one-process port, within the smoke's bounds, on (data 2,
model 2), where each rank holds whole heads, and (data 1, model 4), where
"model" exceeds the heads and each rank holds a share of every head's
value rows: prefill and decode in float32; the two train steps in
float32 on (data 2, model 2) at T = 32; the train steps (and prefill and
decode) in float64 (``test_torch_lm_sharded_steps.py`` says why), at
T = 32 and at T = 16. Each rank's bytes are the global bytes over its
shards: the mixers' weights stay on "model"."""
import pytest

from test_torch_lm_sharded_steps import STEPS, run_smoke

ARGV = ["--arch", "xlstm-1.3b", "--batch", "8"]


def _check(s, world, model, whats):
    assert s["mesh"] == {"data": world // model, "model": model}
    for what in whats:
        assert what in s["worst_share"], what
    for r in s["per_rank"]:
        assert r["param_bytes"] == r["param_bytes_expected"]


@pytest.mark.parametrize("world,model", [(4, 2), (4, 4)])
def test_xlstm_serving_on_model_in_float32(tmp_path, world, model):
    s = run_smoke(tmp_path, world, ARGV + ["--model", str(model), "--seq",
                                           "32", "--what", "prefill,decode"])
    _check(s, world, model, ("prefill logits", "prefill cache",
                             "decode logits", "decode cache"))


def test_xlstm_train_on_model_in_float32(tmp_path):
    """Each head's products on one rank (``nn/ssm.py::tp_layout``'s whole
    heads, as the reference's partitioner lays them out): the float32
    steps hold the smoke's bounds."""
    s = run_smoke(tmp_path, 4, ARGV + ["--model", "2", "--seq", "32",
                                       "--what", "train"])
    _check(s, 4, 2, [f"step {k} {c}" for k in (0, 1)
                     for c in ("loss", "gradients", "grad_norm",
                               "update (ulps / 4)")])
    assert len(s["loss"]) == 2


@pytest.mark.parametrize("world,model,seq,what", [
    (4, 4, 32, STEPS),
    (4, 2, 16, "train"),     # the length at which DTensor's mixers hung
])
def test_xlstm_steps_on_model_in_float64(tmp_path, world, model, seq, what):
    s = run_smoke(tmp_path, world, ARGV + ["--model", str(model), "--seq",
                                           str(seq), "--what", what],
                  float64=True)
    whats = [f"step {k} {c}" for k in (0, 1)
             for c in ("loss", "gradients", "update (ulps / 4)")]
    if "decode" in what:
        whats += ["prefill cache", "decode cache"]
    _check(s, world, model, whats)
    assert len(s["loss"]) == 2
