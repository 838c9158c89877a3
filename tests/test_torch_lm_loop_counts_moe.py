"""The LM dry-run's loop-corrected count equals the count of every
iteration: the MoE family (a dense prologue, EP)
(``tests/torch_loop_counts_common.py`` says how)."""
import pytest

import test_torch_common  # noqa: F401  (one torch thread)
from torch_loop_counts_common import check_arch


@pytest.mark.parametrize("arch", ['deepseek-moe-16b', 'deepseek-v3-671b'])
def test_loop_corrected_count_is_every_iterations(arch):
    check_arch(arch)
