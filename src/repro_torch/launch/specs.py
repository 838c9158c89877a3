"""Every input of an LM cell as a meta tensor with its spec (counterpart
of ``repro/launch/specs.py``).

The reference hands ``ShapeDtypeStruct``s with ``NamedSharding``s to the
dry-run's lowering. Here an input is a meta tensor of its global shape and
dtype (nothing is allocated) and its spec (``distributed/sharding.py``'s
form: one entry per dim), or ``None`` without a mesh; the dry-run turns
each into a ``DTensor`` on its spec. Modality frontends are stubs, as in
the reference: the VLM gets precomputed patch embeddings (``vision``),
whisper post-conv frame embeddings (``frames``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import batch_spec, cache_specs
from repro_torch.models import lm


class Inputs(NamedTuple):
    """``tensors``: a dict (a tree for the cache) of meta tensors;
    ``specs``: the same structure of specs, or ``None`` without a mesh."""
    tensors: Dict[str, Any]
    specs: Dict[str, Any] | None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeCell,
                      mesh=None) -> Inputs:
    B, T = shape.global_batch, shape.seq_len
    prof = cfg.parallelism
    tensors = {"tokens": _meta((B, T), torch.int32),
               "labels": _meta((B, T), torch.int32)}
    specs = None
    if mesh is not None:
        bs = batch_spec(mesh, B, profile=prof)
        specs = {"tokens": bs, "labels": bs}
    extra = {"vlm": ("vision", cfg.n_vision_tokens),
             "encdec": ("frames", cfg.n_audio_frames)}.get(cfg.family)
    if extra is not None:
        name, n = extra
        tensors[name] = _meta((B, n, cfg.d_model), cfg.dtype())
        if mesh is not None:
            specs[name] = batch_spec(mesh, B, 2, profile=prof)
    return Inputs(tensors, specs)


def prefill_input_specs(cfg: ArchConfig, shape: ShapeCell,
                        mesh=None) -> Inputs:
    tensors, specs = train_input_specs(cfg, shape, mesh)
    tensors.pop("labels")
    if specs is not None:
        specs.pop("labels")
    return Inputs(tensors, specs)


def decode_input_specs(cfg: ArchConfig, shape: ShapeCell,
                       mesh=None) -> Inputs:
    """-> {token, pos, cache} for one serve step; the cache from
    ``lm.init_cache`` on the meta device."""
    B, S = shape.global_batch, shape.seq_len
    cache = lm.init_cache(cfg, B, S, device="meta")
    tensors = {"token": _meta((B,), torch.int32),
               "pos": _meta((), torch.int32), "cache": cache}
    specs = None
    if mesh is not None:
        specs = {"token": batch_spec(mesh, B, 0, profile=cfg.parallelism),
                 "pos": (), "cache": cache_specs(cache, mesh, B)}
    return Inputs(tensors, specs)
