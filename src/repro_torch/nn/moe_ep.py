"""Expert-parallel MoE (counterpart of ``repro/nn/moe_ep.py``): its route
without a mesh only.

The reference's ``moe_apply_ep`` reads the active mesh; without one (or
without a "model" axis) it is ``moe.moe_apply``, and that is the route
every single-card caller takes. Its expert-parallel route over a mesh
(local routing, a ``psum`` of the combined output over "model") belongs
to the LM sharding slice, with ``distributed/act_sharding.py``; given a
mesh with a "model" axis, this function raises instead of quietly running
the single-device route.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import moe as _moe

Params = Dict[str, Any]


def moe_apply_ep(p: Params, x: torch.Tensor, *, top_k: int,
                 act: str = "silu", capacity_factor: float = 1.25,
                 expert_axes: str = "model", mesh=None) -> tuple:
    """``moe.moe_apply`` when ``mesh`` is None or has no "model" axis;
    with one, ``NotImplementedError`` (``expert_axes`` is read only by
    that route)."""
    # a launch/mesh.py MeshLayout names its axes ``axis_names``, a
    # DeviceMesh ``mesh_dim_names``
    names = (getattr(mesh, "axis_names", None)
             or getattr(mesh, "mesh_dim_names", None) or ())
    if "model" in names:
        raise NotImplementedError(
            "moe_apply_ep's expert-parallel route over a mesh is not "
            "ported: it comes with the LM training and sharding slice "
            "(distributed/act_sharding.py, the LM half of "
            "distributed/sharding.py); call it without a mesh")
    return _moe.moe_apply(p, x, top_k=top_k, act=act,
                          capacity_factor=capacity_factor)
