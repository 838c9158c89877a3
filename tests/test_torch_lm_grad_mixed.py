"""The LM's backward for the recurrent, enc-dec and VLM archs
(xlstm-1.3b's mLSTM and sLSTM, whisper-base's encoder and cross
attention, llama-3.2-vision-11b's gated cross attention) at
``reduced()``, float32: the port's loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``
(``tests/torch_lm_grad_common.py`` states the tolerances), the encoder's
and the gates' gradients included; and each remat mode bitwise equal to
``none`` on the CPU."""
import pytest

from torch_lm_grad_common import REMAT_MODES, check_grads, check_loss, \
    check_remat, make_case, port_grads

ARCHS = ["xlstm-1.3b", "whisper-base", "llama-3.2-vision-11b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return make_case(request.param)


def test_loss_and_every_gradient_leaf_match(case):
    loss, metrics, grads = port_grads(case["cfg"], case["params"],
                                      case["inputs"])
    check_loss(loss, metrics, case["ref"])
    check_grads(grads, case["ref"])
    paths = [p for p, _ in grads]
    if case["arch"] == "whisper-base":
        assert any(p.startswith("['enc']") for p in paths)
    if case["arch"] == "llama-3.2-vision-11b":
        assert any("gate_attn" in p for p in paths)


@pytest.mark.parametrize("mode", REMAT_MODES)
def test_remat_is_bitwise_none(case, mode, monkeypatch):
    check_remat(case, mode, monkeypatch)
