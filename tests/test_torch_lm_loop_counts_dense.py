"""The LM dry-run's loop-corrected count equals the count of every
iteration: three dense archs (qwen3-4b is in ``test_torch_lm_loop_counts_rules.py``)
(``tests/torch_loop_counts_common.py`` says how)."""
import pytest

import test_torch_common  # noqa: F401  (one torch thread)
from torch_loop_counts_common import check_arch


@pytest.mark.parametrize("arch", ['llama3-405b', 'nemotron-4-340b', 'qwen1.5-4b'])
def test_loop_corrected_count_is_every_iterations(arch):
    check_arch(arch)
