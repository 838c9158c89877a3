"""xlstm's float32 train steps against their float64 truth, in one
process, measured in units of one float32 ulp's response.

The case is ``tests/test_torch_lm_sharding_ref_mixers.py``'s
(``torch_lm_ref_mixers_common.setup``): xlstm-1.3b at ``reduced()``,
float32, the reference's weights from ``PRNGKey(0)``, three batches of
B = 8, T = 32 from ``RandomState(0)``; two steps of ``make_train_step``
(2 microbatches, the cosine AdamW), step 0 from the initial state and
step 1 from the one-process port's state after step 0. There the port
(P1) and the reference (R1), each in float32 in one process, differ by
5.4 and 6.8 times the smoke's bounds (``tools/torch_lm_shard_smoke.py``
``LOSS_TOL`` / ``GRAD_TOL``), and no float32 program can be held within
1 of another: one float32 ulp of the weights, with no rounding at all,
moves these gradients by 3.4 and 16.3 times the bounds at steps 0 and 1
(``torch_lm_truth_common``).

So each step is held against its truth G64 (the port's float64 copy's
gradients, loss and grad norm) within max(1, 8 x delta), delta the
step's one-ulp response (``torch_lm_truth_common.truth``):

- the claim: P1 within it at each step;
- the control: R1 within it at each step (a reference outside it would
  make the yardstick wrong, not the port);
- the truth itself: the reference's float64 copy (``as_float64(...,
  reference=True)``, ``JAX_ENABLE_X64``) against the port's on the
  "grad" batch and both steps, every share (loss and grad norm included)
  at most 1e-3 of the bounds.

One ``TRUTH`` line a case: the shares, delta and share / delta.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import torch_lm_truth_common as truth
from torch_lm_ref_mixers_common import ROOT, port_run, reference_run, setup

ARCH = "xlstm-1.3b"
PARITY64 = 1e-3            # of the smoke's bounds, float64 against float64

# the reference's float64 copy on the case file's starts and batches
REF64 = """
import sys
sys.path.insert(0, "tests")
from torch_lm_ref_mixers_common import reference_run, setup
from torch_lm_truth_common import load_case, save_case, start_trees

arch, npz, out = sys.argv[1:4]
case = setup(arch)
starts, batches, grad_batch, _ = load_case(npz)
case = case._replace(batches=[grad_batch] + batches)
run = reference_run(case, None, [start_trees(case.params, case.topt, s)
                                 for s in starts])
save_case(out, [], [], runs={"R64": run})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """P1 and R1 in float32, G64 with each step's delta, the port's and
    the reference's float64 runs."""
    tmp = tmp_path_factory.mktemp("truth")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # as each rank of the LM spawn
    try:
        case = setup(ARCH)
        init = (case.params, case.topt.init(case.params))
        P1, after = port_run(case, None, [init, None])
        starts = [init, after[0]]
        npz = tmp / "case.npz"
        truth.save_case(npz, [truth.start_leaves(*s) for s in starts],
                        case.batches[1:], grad_batch=case.batches[0])
        with tempfile.TemporaryDirectory(prefix="ref64_") as copy:
            src = truth.float64_copy(Path(copy) / "f64", reference=True)
            with open(tmp / "ref64.log", "w") as log:
                ref64 = subprocess.Popen(
                    [sys.executable, "-c", REF64, ARCH, str(npz),
                     str(tmp / "ref64.npz")], cwd=ROOT, stdout=log,
                    stderr=subprocess.STDOUT, env=dict(
                        os.environ, PYTHONPATH=str(src), JAX_ENABLE_X64="1",
                        OMP_NUM_THREADS="1"))
                try:
                    R1 = reference_run(case, None, starts)
                    t = truth.truth(ARCH, npz)
                    ref64.wait(timeout=truth.TIMEOUT_S)
                finally:
                    if ref64.poll() is None:
                        ref64.kill()
                        ref64.wait()
        assert ref64.returncode == 0, (tmp / "ref64.log").read_text()[-4000:]
    finally:
        torch.set_num_threads(threads)
    return {"P1": P1, "R1": R1, "truth": t,
            "R64": truth.load_case(tmp / "ref64.npz")[3]["R64"]}


def _within(runs, name, step):
    row = {"arch": ARCH, "run": name, "step": step, **truth.score(
        runs[name]["train"][step], runs["truth"]["train"][step])}
    print("TRUTH " + json.dumps(row))
    return row


@pytest.mark.parametrize("step", [0, 1])
def test_the_ports_float32_steps_stand_within_one_ulps_response(runs, step):
    row = _within(runs, "P1", step)
    assert row["share"] <= row["bound"], row


@pytest.mark.parametrize("step", [0, 1])
def test_the_references_float32_steps_stand_within_one_ulps_response(
        runs, step):
    """The control: if the reference misses, the yardstick is wrong."""
    row = _within(runs, "R1", step)
    assert row["share"] <= row["bound"], row


@pytest.mark.parametrize("what", ["grad", "step0", "step1"])
def test_the_float64_copies_agree(runs, what):
    """The port's float64 copy (the truth) against the reference's."""
    ref = runs["R64"]["grad"] if what == "grad" else \
        runs["R64"]["train"][int(what[-1])]
    port = runs["truth"]["grad"] if what == "grad" else \
        runs["truth"]["train"][int(what[-1])]
    share = truth.step_share(port, ref)
    print("TRUTH " + json.dumps({"arch": ARCH, "float64": what,
                                 "share": share}))
    assert share <= PARITY64, share
