"""The LM's backward for the MoE archs (deepseek-moe-16b, deepseek-v3
with MLA, the jamba hybrid of attention, Mamba and MoE) at ``reduced()``,
float32: the port's loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``
(``tests/torch_lm_grad_common.py`` states the tolerances), the router's
near-ties counted as ``tests/test_torch_lm.py`` counts them; and each
remat mode (``full``, ``dots``, ``names``) bitwise equal to ``none`` on
the CPU, with the group bodies really recomputed."""
import pytest

from torch_lm_grad_common import REMAT_MODES, _NearTies, check_grads, \
    check_loss, check_remat, make_case, port_grads

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return make_case(request.param)


def test_loss_and_every_gradient_leaf_match(case, monkeypatch):
    ties = _NearTies(monkeypatch)
    loss, metrics, grads = port_grads(case["cfg"], case["params"],
                                      case["inputs"])
    check_loss(loss, metrics, case["ref"])
    check_grads(grads, case["ref"])
    assert ties.calls > 0
    assert ties.count == 0, f"{ties.count} router near-ties"


@pytest.mark.parametrize("mode", REMAT_MODES)
def test_remat_is_bitwise_none(case, mode, monkeypatch):
    check_remat(case, mode, monkeypatch)
