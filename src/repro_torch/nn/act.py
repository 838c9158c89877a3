"""Rational gate activations and the bits-to-uniform convention
(counterpart of ``repro/nn/act.py``).

The same degree-7/6 Lambert continued fraction for tanh, clamped where
the rational crosses 1, and sigmoid through the tanh half-angle identity:
training, the plain rollouts and the CUDA kernels all share these exact
definitions, so the simulator rolls out the model that was trained.

Random bits are carried as ``int32`` storage of the uint32 values (torch's
``uint32`` has no ``>>`` on the CPU). ``uniform_from_bits`` takes the top
24 bits: an arithmetic shift of the int32 view followed by the 24-bit mask
gives exactly the logical shift of the uint32 value.
"""
from __future__ import annotations

import torch

# the rational crosses 1 exactly here; clamping makes it saturate to +-1
_CLAMP = 4.97178686


def fast_tanh(x: torch.Tensor) -> torch.Tensor:
    """Degree-7/6 rational tanh (Lambert's continued fraction), clamped."""
    x = torch.clamp(x, -_CLAMP, _CLAMP)
    x2 = x * x
    num = x * (135135.0 + x2 * (17325.0 + x2 * (378.0 + x2)))
    den = 135135.0 + x2 * (62370.0 + x2 * (3150.0 + x2 * 28.0))
    return num / den


def fast_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid(x) = (tanh(x/2) + 1) / 2 on the rational tanh."""
    return 0.5 * (fast_tanh(0.5 * x) + 1.0)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32-stored uint32 random bits -> f32 uniforms on [0, 1)."""
    top = (bits.to(torch.int32) >> 8) & 0xFFFFFF
    return top.to(torch.float32) * (1.0 / (1 << 24))


def random_bits(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform uint32 bits drawn from ``generator`` (on its device), as
    int32 storage."""
    b = torch.randint(0, 1 << 32, tuple(shape), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return b.to(torch.int32)
