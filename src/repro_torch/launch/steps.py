"""Step functions of the LM (counterpart of ``repro/launch/steps.py``):
the loss, the prefill step and the serve (decode) step, the units the
serving driver calls. ``make_train_step`` (gradient accumulation and the
optimizer) comes with the LM training slice.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def make_loss_fn(cfg: ArchConfig) -> Callable:
    def loss(params, batch):
        return lm.loss_fn(params, cfg, batch)
    return loss


def make_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    def prefill_step(params, inputs):
        return lm.prefill(params, cfg, inputs, max_len)
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, token, pos):
        """One decode step: write KV at ``pos`` (in place), return logits
        and the cache."""
        return lm.decode_step(params, cfg, cache, token, pos)
    return serve_step
