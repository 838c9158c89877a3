"""Distributed IALS (Suau et al. 2022): compatibility names
(counterpart of ``repro/core/multi_ials.py``).

The agent axis is a batch dimension of the one unified engine
(``core.engine.make_unified_ials``); the scalar vmap-of-simulators
baseline lives with its single-agent sibling in ``core.ials``. This
module only re-exports the historical names.
"""
from __future__ import annotations

from repro_torch.core.engine import (IALSState,  # noqa: F401
                                     make_batched_multi_ials,
                                     make_unified_ials)
from repro_torch.core.ials import MultiIALSState, make_multi_ials  # noqa: F401
