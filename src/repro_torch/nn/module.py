"""Minimal functional parameter substrate as plain dicts of tensors
(counterpart of ``repro/nn/module.py``).

Layout is the JAX package's: ``w`` is (d_in, d_out) and ``y = x @ w + b``,
so parameters carry across (``repro_torch/convert.py``) without a
transpose. Every layer is a pair ``<layer>_init(generator, ...)`` /
``<layer>(params, x)``. Where the reference splits a key, the port draws
from one ``torch.Generator`` in order; inits draw on ``device`` (default:
the generator's), and on ``device="meta"`` they allocate nothing, the
counterpart of ``jax.eval_shape``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.distributed.act_sharding import is_dtensor
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def init_device(generator, device):
    """Where an init draws: ``device``, else the generator's device."""
    return torch.device(device) if device is not None else generator.device


def normal(generator: torch.Generator, shape, *, scale: float = 1.0,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """A float32 standard-normal draw times ``scale``, cast to ``dtype``
    (the reference's ``(jax.random.normal(k, shape) * scale).astype``)."""
    w = torch.empty(shape, dtype=torch.float32,
                    device=init_device(generator, device))
    w.normal_(generator=generator)
    return (w * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               dtype=torch.float32, device=None) -> Params:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in float32 and cast
    to ``dtype``; zero bias."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    dev = init_device(generator, device)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    p = {"w": (w * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) -> (..., d_out); stacked (A, d_in, d_out) weights
    contract batched over a leading agent axis of ``x``."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        b = p["b"]
        y = y + (b[:, None, :] if b.dim() == 2 and y.dim() == 3 else b)
    return y


def embedding_init(generator: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32, device=None) -> Params:
    return {"table": normal(generator, (vocab, d), scale=0.02, dtype=dtype,
                            device=device)}


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the table; a ``DTensor`` table (the sharded LM)
    on each rank's local blocks
    (``distributed/act_sharding.py::embedding_lookup``)."""
    table = p["table"]
    if is_dtensor(table):
        from repro_torch.distributed.act_sharding import embedding_lookup
        return embedding_lookup(table, ids)
    return table[ids]


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


def layernorm_init(d: int, *, dtype=torch.float32, device="cuda") -> Params:
    dev = resolve_device(device)
    return {"g": torch.ones((d,), dtype=dtype, device=dev),
            "b": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(p: Params, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32 (biased variance), round, then scale and
    shift in x's dtype, as the reference does."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["g"].to(dt) + p["b"].to(dt)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(f"unknown norm kind {kind}")


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def relu2(x):
    """Squared ReLU (Nemotron-4)."""
    r = torch.relu(x)
    return r * r


ACTIVATIONS: Dict[str, Callable] = {
    "silu": F.silu,
    # the reference's jax.nn.gelu(approximate=True): the tanh form
    "gelu": partial(F.gelu, approximate="tanh"),
    "relu": torch.relu,
    "relu2": relu2,
    "tanh": torch.tanh,
}


# ---------------------------------------------------------------------------
# Pytree helpers
# ---------------------------------------------------------------------------

def tree_size(tree) -> int:
    """Total number of elements in a tree of tensors."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def stack_init(init_fn: Callable[[torch.Generator], Params],
               generator: torch.Generator, n: int) -> Params:
    """Call ``init_fn(generator)`` ``n`` times, one layer after another,
    and stack -> leading-dim-n params (the scan-over-layers layout).

    Each stacked leaf is allocated once and filled layer by layer, so the
    peak is the stack plus one layer's leaves (``torch.stack`` of n
    layers would hold every layer twice)."""
    layer = init_fn(generator)
    stacked = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), layer)
    for i in range(n):
        if layer is None:
            layer = init_fn(generator)
        tree_map(lambda s, x: s[i].copy_(x), stacked, layer)
        layer = None
    return stacked


def abstractify(tree):
    """A tree of tensors -> the same tree on the meta device (shapes and
    dtypes, no storage): the counterpart of ``ShapeDtypeStruct``s."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)
