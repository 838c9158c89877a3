"""The CUDA route of the fused RMSNorm (counterpart of
``repro/kernels/rmsnorm.py``, whose Pallas TPU kernel ``rmsnorm`` this
replaces): ``layer_rmsnorm`` in ``csrc/layer_kernels.cu``, built and
loaded by ``aip_step.library()``.

What bounds it on the card: bytes (x read once, out written once, g).
So each row is read once with 16-byte loads and kept in registers from
the sum of squares to the scale, written with 16-byte stores, and g
stays in registers across the rows a warp (16 lanes a row for 16 vectors
or fewer, a warp up to 10 vectors a lane: d <= 2560 in bf16) or a block
(up to 8 vectors a thread) walks. Rows that are not a whole number of
16-byte vectors, tensors not 16-byte aligned, and wider rows take the
scalar kernels (a warp or a block a row, the row read twice); any N.
``x * (1 / sqrt(mean(x^2) + eps)) * g`` in float32 on every route,
rounded once to x's dtype, as ``ref.rmsnorm_ref``. The Pallas kernel's
row block ``br`` is a TPU tiling choice that halves until it divides N
and never refuses a shape, so it has no counterpart here. CUDA tensors only:
``ops.py`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aip_step as _build

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x, g, *, eps: float = 1e-6):
    """x (N, d) float32 or bfloat16, g (d,) float32 or bfloat16 (taken in
    float32) -> (N, d) in x's dtype, ONE launch."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"rmsnorm takes a non-empty (N, d) tensor, got "
                         f"{tuple(x.shape)}")
    N, d = x.shape
    x = _build.check(x, "x", DTYPES, (N, d))
    g = _build.check(g, "g", DTYPES, (d,)).float().contiguous()
    out = torch.empty_like(x)
    _build.launch("layer_rmsnorm", "rmsnorm", x.device, x.data_ptr(),
                  g.data_ptr(), out.data_ptr(), N, d, float(eps),
                  int(x.dtype == torch.bfloat16))
    return out
