"""Dispatch between the CUDA kernels and their plain versions
(counterpart of ``repro/kernels/ops.py``).

The rule is the tensor's device, and nothing else: a CUDA tensor
launches the hand-written kernel (``aip_step.py``), a CPU tensor takes the
plain PyTorch version (``ref.py``). There is no ``try`` and no other
route: a kernel that fails to build or launch raises.

The rollout entry points take both the domain's plain functions
(``tick_fn`` / ``dset_fn`` / ``obs_fn`` on kernel-encoded LS leaves, for
the CPU) and its ``KernelDomain`` (the device functor, for the card).
The layer ops (``flash_attention_mha``, ``gru_sequence``, ``rmsnorm``)
keep the JAX wrappers' signatures and layouts; their kernels live in
``flash_attention.py``, ``gru.py`` and ``rmsnorm.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aip_step as _cuda
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gru as _gru
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel route for device {t.device}")
    return False


def aip_step(d, h, wx, wh, b, hw, hb, bits):
    """One fused GRU AIP tick: (B, ...) inputs, 2-D weights."""
    if _on_card(d):
        return _cuda.aip_step(d, h, wx, wh, b, hw, hb, bits)
    return _ref.aip_step_ref(d, h, wx, wh, b, hw, hb, bits)


def aip_step_multi(d, h, wx, wh, b, hw, hb, bits):
    """A per-agent fused GRU AIP ticks: (B, A, ...) inputs, stacked
    weights; on the card the agent axis is in the launch grid."""
    if _on_card(d):
        return _cuda.aip_step_multi(d, h, wx, wh, b, hw, hb, bits)
    return _ref.aip_step_multi_ref(d, h, wx, wh, b, hw, hb, bits)


def ials_rollout_multi(ls, h0, wx, wh, b, hw, hb, actions, bits, noise, *,
                       n_agents, tick_fn, dset_fn, domain, plan_for=None):
    """Whole-horizon IALS rollout, GRU backbone (``aip_rollout_multi``).
    ``plan_for``: the global (A, B) whose K-parts a sharded block's
    launch takes (``aip_step.shard_plan``); the plain version has no
    plan."""
    if _on_card(h0):
        return _cuda.aip_rollout_multi(ls, h0, wx, wh, b, hw, hb, actions,
                                       bits, noise, n_agents=n_agents,
                                       domain=domain, plan_for=plan_for)
    return _ref.ials_rollout_multi_ref(ls, h0, wx, wh, b, hw, hb, actions,
                                       bits, noise, n_agents=n_agents,
                                       tick_fn=tick_fn, dset_fn=dset_fn)


def ials_rollout(ls, h0, wx, wh, b, hw, hb, actions, bits, noise, *,
                 tick_fn, dset_fn, domain):
    """Whole-horizon IALS rollout of one shared GRU AIP (``aip_rollout``):
    unstacked 2-D weights; ls (B, ...) leaves, h0 (B, H), actions (T, B),
    bits (T, B, M), noise (T, B, ...) leaves -> (final ls, h_T, rewards
    (T, B)). On the card it is ``aip_rollout_multi``'s kernel at A = 1."""
    if _on_card(h0):
        return _cuda.aip_rollout(ls, h0, wx, wh, b, hw, hb, actions, bits,
                                 noise, domain=domain)
    return _ref.ials_rollout_ref(ls, h0, wx, wh, b, hw, hb, actions, bits,
                                 noise, tick_fn=tick_fn, dset_fn=dset_fn)


def fnn_rollout(ls, buf0, w1, b1, w2, b2, hw, hb, actions, bits, noise, *,
                n_agents, tick_fn, dset_fn, domain, plan_for=None):
    """Whole-horizon IALS rollout, FNN backbone (``fnn_rollout``)."""
    if _on_card(buf0):
        return _cuda.fnn_rollout(ls, buf0, w1, b1, w2, b2, hw, hb, actions,
                                 bits, noise, n_agents=n_agents,
                                 domain=domain, plan_for=plan_for)
    return _ref.fnn_rollout_ref(ls, buf0, w1, b1, w2, b2, hw, hb, actions,
                                bits, noise, n_agents=n_agents,
                                tick_fn=tick_fn, dset_fn=dset_fn)


def policy_rollout(ls, s0, frames0, aip_w, pol_w, gumbel, bits, done,
                   noise, reset_ls, *, kind, n_agents, fast_gates, tick_fn,
                   dset_fn, obs_fn, domain, plan_for=None):
    """A whole PPO acting horizon (``policy_rollout``), either cell."""
    if _on_card(s0):
        return _cuda.policy_rollout(
            ls, s0, frames0, aip_w, pol_w, gumbel, bits, done, noise,
            reset_ls, kind=kind, n_agents=n_agents, fast_gates=fast_gates,
            domain=domain, plan_for=plan_for)
    return _ref.policy_rollout_ref(
        ls, s0, frames0, aip_w, pol_w, gumbel, bits, done, noise, reset_ls,
        kind=kind, n_agents=n_agents, fast_gates=fast_gates,
        tick_fn=tick_fn, dset_fn=dset_fn, obs_fn=obs_fn)


def serve_forward(frames, mask, pol_w, *, fast_gates):
    """Masked fixed-slot policy forward (``serve_forward``): frames (S, D),
    mask (S,) int32, the fused policy weights (``ref.fuse_head``) ->
    (logits (S, n_act), v (S,)), pad lanes exactly zero."""
    if _on_card(frames):
        return _cuda.serve_forward(frames, mask, pol_w, fast_gates=fast_gates)
    return _ref.serve_forward_ref(pol_w, frames, mask, fast_gates=fast_gates)


def serve_forward_multi(frames, mask, pidx, pol_ws, *, fast_gates):
    """Cross-policy masked slot forward (``serve_forward_multi``): weights
    stacked over N policies, pidx (S,) int32 per lane; pad and unroutable
    lanes exactly zero."""
    if _on_card(frames):
        return _cuda.serve_forward_multi(frames, mask, pidx, pol_ws,
                                         fast_gates=fast_gates)
    return _ref.serve_forward_multi_ref(pol_ws, frames, mask, pidx,
                                        fast_gates=fast_gates)


def flash_attention_mha(q, k, v, *, causal=True, scale=None, bq=128,
                        bk=128):
    """q: (B, T, H, D); k, v: (B, S, KH, D[v]) with GQA support -> (B, T,
    H, Dv). On the card one launch reads the KV heads in place. ``bq``/
    ``bk`` are the Pallas blocks, checked for divisibility on both
    routes."""
    if _on_card(q):
        return _fa.flash_attention_mha(q, k, v, causal=causal, scale=scale,
                                       bq=bq, bk=bk)
    _fa.check_blocks(q.shape[1], k.shape[1], bq, bk)
    return _ref.flash_attention_mha_ref(q, k, v, causal=causal, scale=scale)


def gru_sequence(params, xs, h0=None):
    """Drop-in for ``nn.rnn.gru_sequence`` backed by the fused kernel:
    xs (B, T, D) -> (hs (B, T, H), h_T); ``h0=None`` is zeros of xs's
    dtype."""
    B = xs.shape[0]
    H = params["wh"].shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=xs.dtype, device=xs.device)
    if _on_card(xs):
        return _gru.gru_sequence(xs, params["wx"], params["wh"],
                                 params["b"], h0)
    return _ref.gru_sequence_ref(xs, params["wx"], params["wh"],
                                 params["b"], h0)


def rmsnorm(x, g, *, eps: float = 1e-6):
    """x (..., d), g (d,) -> RMSNorm over the last axis in x's dtype."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    if _on_card(x):
        out = _rms.rmsnorm(x2, g, eps=eps)
    else:
        out = _ref.rmsnorm_ref(x2, g, eps=eps)
    return out.reshape(shp)
