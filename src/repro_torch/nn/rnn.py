"""GRU cell with the rational gates (counterpart of ``repro/nn/rnn.py``).

Weights are gate-major ``[r|z|n]``: ``wx`` (D, 3H), ``wh`` (H, 3H),
``b`` (3H,), as in the JAX package. ``gru_sequence`` is the plain path;
``repro_torch.kernels.ops.gru_sequence`` is its drop-in backed by the
fused CUDA kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.nn.act import fast_sigmoid, fast_tanh
from repro_torch.nn.module import dense_init

Params = Dict[str, Any]


def gru_init(generator: torch.Generator, d_in: int, d_hidden: int, *,
             device=None) -> Params:
    dev = device if device is not None else generator.device
    return {
        "wx": dense_init(generator, d_in, 3 * d_hidden, device=dev)["w"],
        "wh": dense_init(generator, d_hidden, 3 * d_hidden,
                         device=dev)["w"],
        "b": torch.zeros((3 * d_hidden,), dtype=torch.float32, device=dev),
    }


def gru_cell(p: Params, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h: (..., H); x: (..., D) -> new h. Stacked (A, ...) weights with
    (A, B, ...) inputs contract per agent."""
    H = h.shape[-1]
    b = p["b"]
    if b.dim() == 2 and x.dim() == 3:
        b = b[:, None, :]
    gx = torch.matmul(x, p["wx"]) + b
    gh = torch.matmul(h, p["wh"])
    r = fast_sigmoid(gx[..., :H] + gh[..., :H])
    z = fast_sigmoid(gx[..., H:2 * H] + gh[..., H:2 * H])
    n = fast_tanh(gx[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru_sequence(p: Params, xs: torch.Tensor,
                 h0: torch.Tensor | None = None):
    """xs: (B, T, D) -> (hs (B, T, H), h_T): ``gru_cell`` over T, in xs's
    dtype; ``h0=None`` is zeros."""
    B, T, _ = xs.shape
    H = p["wh"].shape[0]
    h = xs.new_zeros((B, H)) if h0 is None else h0
    hs = []
    for t in range(T):
        h = gru_cell(p, h, xs[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), h
