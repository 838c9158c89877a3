"""The CUDA route of the fused GRU sequence (counterpart of
``repro/kernels/gru.py``, whose Pallas TPU kernel ``gru_sequence`` this
replaces): ``layer_gru_sequence`` in ``csrc/layer_kernels.cu``, built and
loaded by ``aip_step.library()``.

One launch runs the whole sequence: a block owns 8 batch rows, T is a
loop inside it, and h stays in shared memory in float32. Weights are
gate-major ``[r|z|n]`` as in ``repro_torch/nn/rnn.py``; ``ref.
gru_sequence_ref`` is the plain version. CUDA tensors only: ``ops.py``
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aip_step as _build

DTYPES = (torch.float32, torch.bfloat16)


def gru_sequence(x, wx, wh, b, h0):
    """x (B, T, D) float32 or bfloat16; wx (D, 3H), wh (H, 3H), b (3H,),
    h0 (B, H), each float32 or bfloat16 and taken in float32 -> (hs
    (B, T, H) in x's dtype, h_T = hs[:, -1]), ONE launch. For bfloat16 x,
    hs is rounded to bfloat16 while the state carries on in float32, so
    h_T is the rounded last row, not the float32 state."""
    B, T, D = x.shape
    H = wh.shape[0]
    if B < 1 or T < 1:
        raise ValueError(f"gru_sequence needs B, T >= 1, got x "
                         f"{tuple(x.shape)}")
    x = _build.check(x, "x", DTYPES, (B, T, D))
    ws = [_build.check(w, n, DTYPES, s).float().contiguous()
          for w, n, s in ((wx, "wx", (D, 3 * H)), (wh, "wh", (H, 3 * H)),
                          (b, "b", (3 * H,)), (h0, "h0", (B, H)))]
    hs = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    _build.launch("layer_gru_sequence", "gru_sequence", x.device,
                  x.data_ptr(), *(w.data_ptr() for w in ws), hs.data_ptr(),
                  B, T, D, H, int(x.dtype == torch.bfloat16))
    return hs, hs[:, -1]
