"""Dense layers and RMSNorm as plain dicts of tensors (counterpart of
``repro/nn/module.py``'s ``dense_init`` / ``dense`` / ``rmsnorm_init`` /
``rmsnorm``).

Layout is the JAX package's: ``w`` is (d_in, d_out) and ``y = x @ w + b``,
so parameters carry across (``repro_torch/convert.py``) without a
transpose.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               device=None) -> Params:
    """Truncated-normal (+-2 sigma) fan-in init; zero bias."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    dev = device if device is not None else generator.device
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    p = {"w": w * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=dev)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) -> (..., d_out); stacked (A, d_in, d_out) weights
    contract batched over a leading agent axis of ``x``."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        b = p["b"]
        y = y + (b[:, None, :] if b.dim() == 2 and y.dim() == 3 else b)
    return y


def rmsnorm_init(d: int, *, dtype=torch.float32, device="cuda") -> Params:
    return {"g": torch.ones((d,), dtype=dtype,
                            device=resolve_device(device))}


def rmsnorm(p: Params, x: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """The XLA path's order: normalise in float32, round to x's dtype,
    THEN multiply by g in x's dtype (the kernel, ``kernels.ops.rmsnorm``,
    multiplies by g in float32 and rounds once; the two differ in
    bfloat16)."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["g"].to(dt)
