"""PyTorch/CUDA port of the IALS reproduction (counterpart of ``repro``).

Same sub-package and module names as ``src/repro``: ``repro_torch/core/
engine.py`` is the counterpart of ``repro/core/engine.py``. The port
imports ``torch`` and numpy only, never ``jax`` or ``repro``; its tests
hold it against the JAX package on the CPU, and ``chip_smoke.py`` drives
it on an H100.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without CUDA they raise instead of carrying on on the CPU.
Randomness above the kernels comes from ``stream``: a fresh generator
seeded by (seed, stream tag, position), the counterpart of the JAX
package's ``fold_in(fold_in(root, tag), position)`` keys. Nothing of a
generator's state is ever carried or checkpointed, so a position alone
rewinds a stream.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` -> ``torch.device``; a CUDA device without CUDA raises
    (no quiet CPU fallback: the CPU is taken only when asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def stream(device, seed: int, tag: int, position: int = 0):
    """A generator on ``device`` seeded by (seed, tag, position)."""
    s = int(np.random.SeedSequence([seed, tag, position]).generate_state(
        1, dtype=np.uint64)[0] >> 1)
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g
