"""The LM dry-run's loop-corrected count equals the count of every
iteration: the hybrid and vlm families
(``tests/torch_loop_counts_common.py`` says how)."""
import pytest

import test_torch_common  # noqa: F401  (one torch thread)
from torch_loop_counts_common import check_arch


@pytest.mark.parametrize("arch", ['jamba-1.5-large-398b', 'llama-3.2-vision-11b'])
def test_loop_corrected_count_is_every_iterations(arch):
    check_arch(arch)
