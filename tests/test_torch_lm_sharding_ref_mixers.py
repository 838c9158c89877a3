"""The port's recurrent mixers on "model" against the reference's sharded
mixers, and the expert-parallel route where it drops tokens.

Four gloo ranks on the CPU; ranks also run the reference, each on a
forced 4-device JAX mesh with Auto axes (``tests/test_torch_lm_sharding_
ref.py`` builds it the same way), its inputs placed by its own
``param_specs`` / ``batch_spec`` under its ``use_mesh``, the weights
carried across by ``convert``; the
reference's runs of a case go side by side on ranks 0-2 and to every
rank after:

- xlstm-1.3b (mLSTM and sLSTM) and jamba-1.5-large-398b (Mamba, an
  attention layer, MoE layers dropless as in ``tools/torch_lm_shard_
  smoke.py``, without the load-balance term: the expert-parallel route
  averages it over the data shards) at ``reduced()``, float32, B = 8,
  T = 32, on (data 2, model 2) and (data 1, model 4): the jitted
  ``value_and_grad`` of ``lm.loss_fn`` on one batch ("grad"), and two
  steps of ``make_train_step`` (2 microbatches, a cosine AdamW) on two
  more ("train"), each step from the same state in every run (the
  initial one, then the one-process port's after its first step), with
  the gradients it hands AdamW. Four runs of each: the reference on one
  device (R1) and sharded (RS), the port in one process (P1) and sharded
  (PS). Each pair is scored as a share of the smoke's bounds (the loss
  and grad norm within ``LOSS_TOL``, every gradient within ``GRAD_TOL``
  of the second run's; the worst of these, a train step's each): RS vs
  R1, PS vs RS, PS vs P1, P1 vs R1 and PS vs R1, one report line a case.
  Every case, and each train step: the port sharded drifts from the
  reference on one device no further than the reference's own sharding
  does, by half again, or the bound (PS vs R1 <= max(1, 1.5 x RS vs
  R1)), and on (data 2, model 2), where "model" divides the heads and
  both packages contract each head on one rank, PS vs P1 <= 1; every
  pair's train losses within ``LOSS_TOL``. xlstm's train steps miss
  that (``xfail(strict=True)`` with their readings; ``ROADMAP.md``
  Queue 3): on both train batches the one-process port and reference
  already differ by 5.4x and 6.8x the bound in float32, and by 3.6e-08
  and 1.1e-09 of it with both packages in float64, where every share
  of these cases is at most 6.0e-08 (``tools/torch_lm_mixer_tp_check.py
  --parity xlstm-1.3b --float64``): the gradients amplify the two
  packages' different orders of sums, which no route on "model"
  removes. So each train step of PS (the claim) and RS (the control),
  both archs, both meshes, is also held against its float64 truth G64
  within max(1, 8 x delta), delta the most one float32 ulp of the
  weights moves G64 (``torch_lm_truth_common``): rank 0 of the spawn
  writes the starts and runs to an ``.npz``, and the truth runs once an
  arch in a subprocess on the port's float64 copy. One ``TRUTH`` line a
  case, with P1 and R1 beside.
- one MoE layer (E = 8, top 2, capacity 1.25; a skewed load, every
  token's expert-0 logit raised by 1, so tokens drop on each data shard
  and on the whole batch) on (data 2, model 2) for both
  ``expert_axes``: the reference's ``moe_apply_ep`` (``shard_map``)
  against the port's; both drop the same share of the assignments
  (``drop_frac`` equal and above 0), no token routes to another expert
  set (``tests/test_torch_lm_layers.py``'s count of routing flips), the
  output within 1e-5 and the gradients of ``out.sum()`` within 1e-4
  (``tests/test_moe_ep.py``'s bounds)."""
import json

import pytest

import torch_lm_truth_common as truth
from torch_lm_ref_mixers_common import EP, LM, MESHES, spawn


@pytest.fixture(scope="module")
def lm_report(tmp_path_factory):
    """arch -> the LM script's report, spawned once an arch; its rank 0
    writes the starts, batches and runs to ``runs.npz`` beside it."""
    reports = {}

    def get(arch):
        if arch not in reports:
            tmp = tmp_path_factory.mktemp("lm")
            reports[arch] = dict(spawn(tmp, LM, [arch, str(tmp / "runs.npz")],
                                       600), npz=tmp / "runs.npz")
        return reports[arch]
    return get


def _case(report, dm, what):
    mesh = {"data": dm[0], "model": dm[1]}
    return next(c for c in report["cases"]
                if c["mesh"] == mesh and c["what"] == what)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_the_sharded_mixers_drift_no_further_than_the_references(
        lm_report, arch):
    """The gradient of one batch on both meshes: the port sharded drifts
    from the reference on one device no further than the reference's
    own sharding, by half again, or the bound (PS vs R1 <= max(1, 1.5 x
    RS vs R1)); on (data 2, model 2), where "model" divides the heads
    and both packages contract each head on one rank, PS vs P1 <= 1. The
    train steps' losses, every pair, within ``LOSS_TOL`` (their
    gradients: the next test)."""
    report = lm_report(arch)
    assert report["arch"] == arch
    assert [(c["mesh"]["model"], c["what"]) for c in report["cases"]] == \
        [(2, "grad"), (2, "train"), (4, "grad"), (4, "train")]
    for dm in MESHES:
        c = _case(report, dm, "grad")
        assert c["PS vs R1"] <= max(1.0, 1.5 * c["RS vs R1"]), c
        assert dm != (2, 2) or c["PS vs P1"] <= 1.0, c
        assert max(_case(report, dm, "train")["loss"].values()) <= 1.0


# xlstm's train steps miss the bound (module docstring), the readings;
# held instead within their one-ulp response against the float64 truth
# (test_the_sharded_train_steps_stand_within_one_ulps_response):
XLSTM_TRAIN_MISSES = {
    (2, 2): "PS vs R1 5.985 / 3.303 at steps 0 / 1 against max(1, 1.5 x "
            "RS vs R1 0.474 / 1.689); P1 vs R1 5.404 / 6.768; PS vs P1 "
            "0.584 / 4.045",
    (1, 4): "step 1: PS vs R1 5.319 against max(1, 1.5 x RS vs R1 2.848); "
            "P1 vs R1 6.768; PS vs P1 1.460 (step 0: PS vs R1 0.922)"}


@pytest.mark.parametrize("arch,dm", [
    pytest.param(arch, dm, id=f"{arch}-data{dm[0]}-model{dm[1]}",
                 marks=[pytest.mark.xfail(strict=True, reason=why)]
                 if why else [])
    for arch in ("xlstm-1.3b", "jamba-1.5-large-398b") for dm in MESHES
    for why in [arch == "xlstm-1.3b" and XLSTM_TRAIN_MISSES[dm]]])
def test_the_sharded_train_steps_drift_no_further_than_the_references(
        lm_report, arch, dm):
    """Each train step's gradients and grad norm: PS vs R1 <= max(1, 1.5
    x RS vs R1), and on (data 2, model 2) PS vs P1 <= 1."""
    st = _case(lm_report(arch), dm, "train")["by step"]
    for k, ps in enumerate(st["PS vs R1"]):
        assert ps <= max(1.0, 1.5 * st["RS vs R1"][k]), st
        assert dm != (2, 2) or st["PS vs P1"][k] <= 1.0, st


@pytest.fixture(scope="module")
def lm_truth(lm_report):
    """arch -> (the spawn's runs, the float64 truth of its train steps and
    their one-ulp response: ``torch_lm_truth_common.truth``), once an
    arch."""
    got = {}

    def get(arch):
        if arch not in got:
            npz = lm_report(arch)["npz"]
            got[arch] = truth.load_case(npz)[3], truth.truth(arch, npz)
        return got[arch]
    return get


@pytest.mark.parametrize("arch,dm", [
    pytest.param(arch, dm, id=f"{arch}-data{dm[0]}-model{dm[1]}")
    for arch in ("xlstm-1.3b", "jamba-1.5-large-398b") for dm in MESHES])
def test_the_sharded_train_steps_stand_within_one_ulps_response(
        lm_truth, arch, dm):
    """Each train step against its float64 truth G64: the port sharded
    (PS, the claim) and the reference sharded (RS, the control) within
    max(1, 8 x delta), delta the step's one-ulp response (module
    docstring); P1 and R1 reported beside them."""
    runs, t = lm_truth(arch)
    names = ("R1", f"RS{dm[0]}{dm[1]}", "P1", f"PS{dm[0]}{dm[1]}")
    rows = []
    for k, g64 in enumerate(t["train"]):
        rows.append({"arch": arch, "mesh": list(dm), "step": k, **{
            n: truth.score(runs[n]["train"][k], g64) for n in names}})
        print("TRUTH " + json.dumps(rows[-1]))
    assert len(rows) == 2
    for r in rows:
        for n in names[1::2]:                       # RS and PS
            assert r[n]["share"] <= r[n]["bound"], r


def test_the_ep_route_drops_the_references_tokens(tmp_path):
    report = spawn(tmp_path, EP, [], 240)
    assert set(report) == {"model", "data_model"}
