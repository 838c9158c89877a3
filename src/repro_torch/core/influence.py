"""Approximate Influence Predictor (AIP) — paper §4, Appendix F
(counterpart of ``repro/core/influence.py``).

``I_theta(u_t | d_t)``: a sequence model over d-set features with M
independent Bernoulli heads. Two backbones: "gru" (recurrent) and "fnn"
(feedforward over the last ``stack`` d-sets, the finite-memory predictor
of Theorem 1). Parameters are nested dicts of tensors in the JAX layout;
per-agent AIPs stack every leaf along a leading (A,) axis.

Training minimises the summed binary cross-entropy over heads (Eq. 3)
with the repo's own AdamW. ``train_aip_batched`` is the counterpart of a
``vmap`` of the whole fit: the agents' fits run as one stacked program,
each with its own minibatch permutations, Adam moments and gradient clip
(``adamw(per_agent=True)`` clips each agent by its own norm). Both fits
take their per-epoch permutations as an optional argument, so a test can
feed the ones the JAX package drew.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.act import fast_sigmoid, uniform_from_bits
from repro_torch.nn.module import dense, dense_init
from repro_torch.nn.rnn import gru_cell, gru_init
from repro_torch.optim.adamw import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, Any]


@dataclass(frozen=True)
class AIPConfig:
    kind: str           # "gru" | "fnn"
    d_in: int           # d-set feature size
    n_out: int          # M influence sources
    hidden: int = 64
    stack: int = 1      # fnn memory length (ignored for gru)


def init_aip(cfg: AIPConfig, generator: torch.Generator,
             device=None) -> Params:
    dev = device if device is not None else generator.device
    if cfg.kind == "gru":
        return {"gru": gru_init(generator, cfg.d_in, cfg.hidden, device=dev),
                "head": dense_init(generator, cfg.hidden, cfg.n_out,
                                   bias=True, device=dev)}
    if cfg.kind == "fnn":
        return {"l1": dense_init(generator, cfg.d_in * cfg.stack,
                                 cfg.hidden, bias=True, device=dev),
                "l2": dense_init(generator, cfg.hidden, cfg.hidden,
                                 bias=True, device=dev),
                "head": dense_init(generator, cfg.hidden, cfg.n_out,
                                   bias=True, device=dev)}
    raise ValueError(cfg.kind)


def init_aip_stacked(cfg: AIPConfig, generator: torch.Generator,
                     n_agents: int, device=None) -> Params:
    """A independent inits, every leaf stacked on a leading (A,) axis."""
    inits = [init_aip(cfg, generator, device) for _ in range(n_agents)]
    return tree_map(lambda *ls: torch.stack(ls), inits[0], *inits[1:])


def init_state(cfg: AIPConfig, batch_shape: tuple = (),
               device="cuda") -> torch.Tensor:
    shape = ((cfg.hidden,) if cfg.kind == "gru"
             else (cfg.stack, cfg.d_in))
    return torch.zeros(tuple(batch_shape) + shape, dtype=torch.float32,
                       device=device)


# --- single-step API --------------------------------------------------------

def step(params: Params, cfg: AIPConfig, state, d_t):
    """d_t: (..., d_in) -> (logits (..., M), new state). Stacked (A, ...)
    params take agent-first (A, B, ...) state and d_t."""
    if cfg.kind == "gru":
        h = gru_cell(params["gru"], state, d_t)
        return dense(params["head"], h), h
    buf = torch.cat([state[..., 1:, :], d_t[..., None, :]], dim=-2)
    x = buf.reshape(*buf.shape[:-2], -1)
    h = torch.relu(dense(params["l1"], x))
    h = torch.relu(dense(params["l2"], h))
    return dense(params["head"], h), buf


def _sample(logits, bits):
    return (uniform_from_bits(bits) < fast_sigmoid(logits)).to(torch.float32)


def step_sample(params: Params, cfg: AIPConfig, state, d_t, bits):
    """One AIP tick with its Bernoulli draw: d_t (B, d_in), bits (B, M)
    int32-stored uint32 -> (logits, new state, u). The GRU backbone goes
    through ``kernels.ops.aip_step`` (the CUDA kernel on a CUDA tensor)."""
    if cfg.kind == "gru":
        from repro_torch.kernels import ops
        h2, logits, u = ops.aip_step(
            d_t, state, params["gru"]["wx"], params["gru"]["wh"],
            params["gru"]["b"], params["head"]["w"], params["head"]["b"],
            bits)
        return logits, h2, u
    logits, new_state = step(params, cfg, state, d_t)
    return logits, new_state, _sample(logits, bits)


def step_multi(params: Params, cfg: AIPConfig, state, d_t):
    """A per-agent AIPs: params leaves (A, ...), state / d_t leading
    (B, A) -> (logits (B, A, M), new state)."""
    logits, st = step(params, cfg, state.transpose(0, 1),
                      d_t.transpose(0, 1))
    return logits.transpose(0, 1), st.transpose(0, 1)


def step_sample_multi(params: Params, cfg: AIPConfig, state, d_t, bits):
    """``step_sample`` for A per-agent AIPs: bits (B, A, M) -> (logits,
    new state, u), all leading (B, A). GRU goes through
    ``kernels.ops.aip_step_multi`` (the agent axis in the launch grid)."""
    if cfg.kind == "gru":
        from repro_torch.kernels import ops
        h2, logits, u = ops.aip_step_multi(
            d_t, state, params["gru"]["wx"], params["gru"]["wh"],
            params["gru"]["b"], params["head"]["w"], params["head"]["b"],
            bits)
        return logits, h2, u
    logits, new_state = step_multi(params, cfg, state, d_t)
    return logits, new_state, _sample(logits, bits)


def apply_sequence(params: Params, cfg: AIPConfig, dsets):
    """dsets: ([A,] B, T, d_in) -> logits ([A,] B, T, M); a loop of
    ``step`` from the zero state."""
    st = init_state(cfg, dsets.shape[:-2], device=dsets.device)
    out = []
    for t in range(dsets.shape[-2]):
        lg, st = step(params, cfg, st, dsets[..., t, :])
        out.append(lg)
    return torch.stack(out, dim=-2)


# --- loss / training --------------------------------------------------------

def _xent(params, cfg, dsets, us, dims):
    logits = apply_sequence(params, cfg, dsets)
    ll = us * F.logsigmoid(logits) + (1.0 - us) * F.logsigmoid(-logits)
    return -ll.sum(-1).mean(dim=dims)


def xent_loss(params: Params, cfg: AIPConfig, dsets, us) -> torch.Tensor:
    """Eq. 3: mean summed binary cross-entropy over the M heads."""
    return _xent(params, cfg, dsets, us, dims=(0, 1))


def xent_loss_per_agent(params: Params, cfg: AIPConfig, dsets,
                        us) -> torch.Tensor:
    """``xent_loss`` of A stacked AIPs, each on its own agent's data:
    (A, N, T, ...) -> (A,) (the JAX package's ``vmap`` of it)."""
    return _xent(params, cfg, dsets, us, dims=(1, 2))


def accuracy(params: Params, cfg: AIPConfig, dsets, us) -> torch.Tensor:
    """Share of the M heads' predictions (logit > 0) that equal u."""
    pred = (apply_sequence(params, cfg, dsets) > 0).to(torch.float32)
    return (pred == us).to(torch.float32).mean()


def _train_core(cfg: AIPConfig, dsets, us, params, perms, generator, *,
                epochs: int, batch_size: int, lr: float, window: int):
    """Stacked fit of A AIPs: dsets (A, N, T, d_in), us (A, N, T, M),
    params (A, ...) leaves -> (params, losses (A, epochs))."""
    A, N, T = dsets.shape[:3]
    if window and window < T:
        n_win = T // window
        dsets = dsets[:, :, :n_win * window].reshape(
            A, N * n_win, window, -1)
        us = us[:, :, :n_win * window].reshape(A, N * n_win, window, -1)
        N, T = dsets.shape[1:3]
    opt = adamw(lr, weight_decay=0.0, clip_norm=1.0, per_agent=True)
    ost = opt.init(params)
    batch_size = min(batch_size, N)
    n_batches = max(1, N // batch_size)
    rows = torch.arange(A, device=dsets.device)[:, None]
    epoch_losses = []
    for e in range(epochs):
        if perms is not None:
            perm = torch.as_tensor(perms[e], device=dsets.device).long()
        else:
            perm = torch.stack([
                torch.randperm(N, generator=generator,
                               device=generator.device)
                for _ in range(A)]).to(dsets.device)
        perm = perm.reshape(A, N)[:, :n_batches * batch_size]
        perm = perm.reshape(A, n_batches, batch_size)
        batch_losses = []
        for bi in range(n_batches):
            idx = perm[:, bi]                                # (A, bs)
            leaves = [l.detach().requires_grad_(True)
                      for l in tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            loss = _xent(p, cfg, dsets[rows, idx], us[rows, idx],
                         dims=(1, 2))                        # (A,)
            grads = torch.autograd.grad(loss.sum(), leaves)
            params, ost, _ = opt.update(tree_unflatten(params, grads), ost,
                                        tree_unflatten(params, [
                                            l.detach() for l in leaves]))
            batch_losses.append(loss.detach())
        epoch_losses.append(torch.stack(batch_losses).mean(0))
    losses = (torch.stack(epoch_losses, 1) if epoch_losses
              else torch.zeros((A, 0), device=dsets.device))
    return params, losses


def train_aip(cfg: AIPConfig, dsets, us, generator: torch.Generator, *,
              epochs: int = 10, batch_size: int = 32, lr: float = 3e-3,
              window: int = 0, params: Optional[Params] = None,
              perms=None) -> Tuple[Params, Dict]:
    """Fit one AIP on (N, T, d_in) / (N, T, M) sequences. ``params``
    (default: ``init_aip`` from ``generator``) and ``perms`` ((epochs, N)
    permutations; default: drawn from ``generator``) let a test replay the
    JAX package's fit."""
    if params is None:
        params = init_aip(cfg, generator, dsets.device)
    stacked = tree_map(lambda l: l[None], params)
    if perms is not None:
        perms = [torch.as_tensor(p)[None] for p in perms]
    out, losses = _train_core(cfg, dsets[None], us[None], stacked, perms,
                              generator, epochs=epochs,
                              batch_size=batch_size, lr=lr, window=window)
    history = [float(l) for l in losses[0]]
    return tree_map(lambda l: l[0], out), {
        "loss_history": history,
        "final_loss": history[-1] if history else float("nan")}


def train_aip_batched(cfg: AIPConfig, dsets, us,
                      generator: torch.Generator, *, epochs: int = 10,
                      batch_size: int = 32, lr: float = 3e-3,
                      window: int = 0, params: Optional[Params] = None,
                      perms=None) -> Tuple[Params, Dict]:
    """Fit A independent AIPs in one stacked pass: dsets (A, N, T, d_in),
    us (A, N, T, M) -> params with (A, ...) leaves. ``perms``, when given,
    is (epochs, A, N)."""
    A = dsets.shape[0]
    if params is None:
        params = init_aip_stacked(cfg, generator, A, dsets.device)
    out, losses = _train_core(cfg, dsets, us, params, perms, generator,
                              epochs=epochs, batch_size=batch_size, lr=lr,
                              window=window)
    final = losses[:, -1] if losses.shape[-1] else losses.sum(-1)
    return out, {"final_loss_per_agent": [float(l) for l in final],
                 "final_loss": float(final.mean())}
