"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at test size (both cells, A in {1, 3}, resets inside the horizon),
with the lane and flip rule of ``chip_smoke.py``; the serving kernels
at both domains' widths with the three bitwise contracts of the
serving tier (pad contents, lane position, multi vs single policy).
These tests need a CUDA card and ``nvcc``: they carry the ``gpu`` marker
and skip without a card.
They import no JAX, so on a machine without it they run without the
repo's conftest: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_kernels_gpu.py``."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A", [1, 3])
def test_rollout_kernel_matches_plain(kind, A, dev):
    import chip_smoke
    case = chip_smoke.Case(kind, A, 20, 16, seed=A, dev=dev)
    flips, err = chip_smoke.check_rollout(case, f"rollout {kind} A={A}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("kind", ["gru", "fnn"])
@pytest.mark.parametrize("A", [1, 3])
def test_policy_rollout_kernel_matches_plain(kind, A, dev):
    import chip_smoke
    case = chip_smoke.Case(kind, A, 20, 48, seed=10 + A, dev=dev)
    assert bool(case.done.any())
    flips, err = chip_smoke.check_policy(case, f"policy {kind} A={A}")
    assert err <= chip_smoke.ATOL


@pytest.mark.parametrize("A", [1, 3])
def test_aip_step_kernel_matches_plain(A, dev):
    import chip_smoke
    rec = chip_smoke.check_aip_step(A, 20, seed=20 + A, dev=dev)
    assert rec["max_abs_err"] <= chip_smoke.ATOL


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
@pytest.mark.parametrize("S", [1, 13, 48])
@pytest.mark.parametrize("N", [1, 3])
def test_serve_kernels_match_plain_and_hold_the_contracts(domain, S, N,
                                                          dev):
    import chip_smoke
    case = chip_smoke.ServeCase(domain, S, N, seed=30 + S + N, dev=dev)
    for multi in ((False, True) if N == 1 else (True,)):
        flips, err = chip_smoke.check_serve(
            case, multi, f"serve multi={multi} {domain} S={S} N={N}")
        assert err <= chip_smoke.ATOL and flips <= 1
