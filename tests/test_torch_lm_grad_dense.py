"""The LM's backward for the dense archs (llama3-405b, nemotron-4-340b,
qwen1.5-4b, qwen3-4b) at ``reduced()``, float32, and qwen3-4b in
bfloat16: the port's loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``
(``tests/torch_lm_grad_common.py`` states the tolerances); each remat
mode bitwise equal to ``none`` on the CPU; and ``full`` keeping fewer
activations than ``none``."""
import pytest

from torch_lm_grad_common import LM_TOL, REMAT_MODES, check_grads, \
    check_loss, check_remat, make_case, port_grads, saved_bytes

import torch  # noqa: E402

ARCHS = ["llama3-405b", "nemotron-4-340b", "qwen1.5-4b", "qwen3-4b"]
BF16_TOL = (6e-2, 2e-2)      # tests/test_torch_lm.py's, bf16 losses


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return make_case(request.param)


def test_loss_and_every_gradient_leaf_match(case):
    loss, metrics, grads = port_grads(case["cfg"], case["params"],
                                      case["inputs"])
    check_loss(loss, metrics, case["ref"], LM_TOL)
    check_grads(grads, case["ref"])


@pytest.mark.parametrize("mode", REMAT_MODES)
def test_remat_is_bitwise_none(case, mode, monkeypatch):
    check_remat(case, mode, monkeypatch)


def test_full_remat_saves_less_than_none(case):
    """Outside the checkpointed group bodies autograd saves far less under
    ``full`` than under ``none`` (which saves every layer's activations)."""
    cfg = case["cfg"]
    none = saved_bytes(cfg.with_overrides(remat="none"), case["params"],
                       case["inputs"])
    full = saved_bytes(cfg.with_overrides(remat="full"), case["params"],
                       case["inputs"])
    assert full < none / 2, (full, none)


def test_bf16_qwen3_matches_the_reference():
    """qwen3-4b reduced in bfloat16: the loss within ``BF16_TOL`` and
    every gradient leaf, bfloat16 like its parameter, within
    ``BF16_GRAD_SHARE`` of the leaf's largest gradient."""
    c = make_case("qwen3-4b", dtype="bfloat16", seed=3)
    loss, metrics, grads = port_grads(c["cfg"], c["params"], c["inputs"])
    assert all(g.dtype == torch.bfloat16 for _, g in grads)
    check_loss(loss, metrics, c["ref"], BF16_TOL)
    check_grads(grads, c["ref"], bf16=True)
