"""The LM dry-run's loop-corrected count equals the count of every
iteration: the ssm family (mLSTM and sLSTM)
(``tests/torch_loop_counts_common.py`` says how)."""
import pytest

import test_torch_common  # noqa: F401  (one torch thread)
from torch_loop_counts_common import check_arch


@pytest.mark.parametrize("arch", ['xlstm-1.3b'])
def test_loop_corrected_count_is_every_iterations(arch):
    check_arch(arch)
