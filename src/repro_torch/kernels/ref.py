"""Plain PyTorch versions of the CUDA kernels (counterpart of
``repro/kernels/ref.py``): the ground truth the kernels are held against
on the card, and the route ``ops.py`` takes for CPU tensors.

The layer ops (``flash_attention_ref``, ``gru_sequence_ref``,
``rmsnorm_ref``) are the reference's oracles as they are: the naive
softmax with -1e30 as the mask value, a loop of the GRU cell in the
inputs' dtype, and RMSNorm in float32 rounded once.

Layouts are the kernels': lanes agent-major (lane ``a*B + b``), stacked
(A, ...) AIP weights, (T, L, ...) streams, LS leaves already
kernel-encoded (int32). ``tick_fn`` / ``dset_fn`` / ``obs_fn`` are the
domain's functions on those encoded leaves — the plain counterpart of the
device functor the CUDA kernels carry. Random bits are int32-stored
uint32 values.
"""
from __future__ import annotations

import torch

from repro_torch.nn.act import fast_sigmoid, fast_tanh, uniform_from_bits

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q (BH, T, D); k, v (BH, S, D[v]) -> (BH, T, Dv) in q's dtype. Naive
    softmax in float32 over the whole (T, S) score matrix."""
    D = q.shape[-1]
    scale = (D ** -0.5) if scale is None else scale
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        T, S = q.shape[1], k.shape[1]
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def flash_attention_mha_ref(q, k, v, *, causal: bool = True, scale=None):
    """q (B, T, H, D); k, v (B, S, KH, D[v]) -> (B, T, H, Dv): (B, H)
    flattened into the batch and each KV head repeated over its
    query-head group, as the JAX wrapper ``ops.flash_attention_mha``
    does, then ``flash_attention_ref``."""
    B, T, H, D = q.shape
    S, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    qf = q.transpose(1, 2).reshape(B * H, T, D)
    kf = k.transpose(1, 2)[:, :, None].expand(B, KH, G, S, D).reshape(
        B * H, S, D)
    vf = v.transpose(1, 2)[:, :, None].expand(B, KH, G, S, Dv).reshape(
        B * H, S, Dv)
    o = flash_attention_ref(qf, kf, vf, causal=causal, scale=scale)
    return o.reshape(B, H, T, Dv).transpose(1, 2)


def gru_sequence_ref(x, wx, wh, b, h0):
    """x (B, T, D); wx (D, 3H); wh (H, 3H); b (3H,); h0 (B, H) -> (hs
    (B, T, H), h_T): the GRU cell applied T times, in the inputs' dtype."""
    h, hs = h0, []
    for t in range(x.shape[1]):
        h = _gru_cell_ref(wx, wh, b, h, x[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rmsnorm_ref(x, g, *, eps: float = 1e-6):
    """x (..., d), g (d,) -> x * rsqrt(mean(x^2) + eps) * g in float32,
    rounded once to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * g.float()).to(x.dtype)


def _sample(logits, bits, trace=None):
    uni, p = uniform_from_bits(bits), fast_sigmoid(logits)
    if trace is not None:      # the draw's distance from its threshold
        trace.setdefault("aip", []).append(
            (uni - p).abs().amin(-1).reshape(-1))
    return (uni < p).to(torch.float32)


def _gru_cell_ref(wx, wh, b, h, x):
    """Stacked (A, ...) weights on (A, B, ...) inputs, or 2-D weights."""
    H = h.shape[-1]
    if b.dim() == 2:
        b = b[:, None, :]
    gx = torch.matmul(x, wx) + b
    gh = torch.matmul(h, wh)
    r = fast_sigmoid(gx[..., :H] + gh[..., :H])
    z = fast_sigmoid(gx[..., H:2 * H] + gh[..., H:2 * H])
    n = fast_tanh(gx[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def _bias(b):
    return b[:, None, :] if b.dim() == 2 else b


def _gru_tick(w, h, d, bits, trace=None):
    """GRU AIP tick on agent-first (A, B, ...) tiles -> (h2, logits, u)."""
    wx, wh, b, hw, hb = w
    h2 = _gru_cell_ref(wx, wh, b, h, d)
    logits = torch.matmul(h2, hw) + _bias(hb)
    return h2, logits, _sample(logits, bits, trace)


def _fnn_tick(w, buf, d, bits, trace=None):
    """FNN AIP tick on (A, B, ...) tiles; ``buf`` is the flat (stack*d_in)
    frame buffer, newest frame last -> (buf2, logits, u)."""
    w1, b1, w2, b2, hw, hb = w
    buf2 = torch.cat([buf[..., d.shape[-1]:], d], dim=-1)
    h = torch.relu(torch.matmul(buf2, w1) + _bias(b1))
    h = torch.relu(torch.matmul(h, w2) + _bias(b2))
    logits = torch.matmul(h, hw) + _bias(hb)
    return buf2, logits, _sample(logits, bits, trace)


def aip_step_ref(d, h, wx, wh, b, hw, hb, bits):
    """One fused GRU AIP tick: d (B, D), h (B, H), 2-D weights, bits
    (B, M) -> (h_new (B, H), logits (B, M), u (B, M) f32 in {0, 1})."""
    return _gru_tick((wx, wh, b, hw, hb), h.float(), d.float(), bits)


def aip_step_multi_ref(d, h, wx, wh, b, hw, hb, bits):
    """A per-agent fused ticks: d (B, A, D), h (B, A, H), stacked (A, ...)
    weights, bits (B, A, M) -> (h_new, logits, u), all leading (B, A)."""
    out = _gru_tick((wx, wh, b, hw, hb), h.float().transpose(0, 1),
                    d.float().transpose(0, 1), bits.transpose(0, 1))
    return tuple(o.transpose(0, 1) for o in out)


def _rollout(cell, ls, s0, weights, actions, bits, noise, *, n_agents,
             tick_fn, dset_fn, trace):
    A = n_agents
    L = s0.shape[0]
    B = L // A
    s = s0.float().reshape(A, B, -1)
    ls = tuple(ls)
    rews = []
    for t in range(actions.shape[0]):
        a = actions[t]
        d = dset_fn(ls, a).float().reshape(A, B, -1)
        s, _, u = cell(weights, s, d, bits[t].reshape(A, B, -1), trace)
        ls, r = tick_fn(ls, a, u.reshape(L, -1),
                        tuple(n[t] for n in noise))
        ls = tuple(ls)
        rews.append(r.float())
    return ls, s.reshape(L, -1), torch.stack(rews)


def ials_rollout_ref(ls, h0, wx, wh, b, hw, hb, actions, bits, noise, *,
                     tick_fn, dset_fn, trace=None):
    """Whole-horizon IALS rollout of one shared GRU AIP: ls tuple of
    (B, ...) leaves, h0 (B, H), 2-D weights, actions (T, B), bits (T, B,
    M), noise tuple of (T, B, ...) leaves -> (final ls, h_T (B, H),
    rewards (T, B) f32): a loop of ``aip_step_ref``'s tick and the LS
    tick. The ``aip_rollout`` kernel's ground truth; it equals
    ``ials_rollout_multi_ref`` at ``n_agents = 1``. ``trace`` as there."""
    ls, h = tuple(ls), h0.float()
    w = (wx, wh, b, hw, hb)
    rews = []
    for t in range(actions.shape[0]):
        a = actions[t]
        h, _, u = _gru_tick(w, h, dset_fn(ls, a).float(), bits[t], trace)
        ls, r = tick_fn(ls, a, u, tuple(n[t] for n in noise))
        ls = tuple(ls)
        rews.append(r.float())
    return ls, h, torch.stack(rews)


def ials_rollout_multi_ref(ls, h0, wx, wh, b, hw, hb, actions, bits, noise,
                           *, n_agents: int, tick_fn, dset_fn, trace=None):
    """Whole-horizon IALS rollout, GRU backbone: ls tuple of (L, ...)
    leaves, h0 (L, H), stacked weights, actions (T, L), bits (T, L, M),
    noise tuple of (T, L, ...) leaves -> (final ls, h_T (L, H), rewards
    (T, L) f32). The ``aip_rollout_multi`` kernel's ground truth.

    ``trace``, when a dict, collects per tick the (L,) distance of each
    lane's closest Bernoulli draw from its threshold (``trace["aip"]``):
    how the checks tell a decision flip from a fault."""
    return _rollout(_gru_tick, ls, h0, (wx, wh, b, hw, hb), actions, bits,
                    noise, n_agents=n_agents, tick_fn=tick_fn,
                    dset_fn=dset_fn, trace=trace)


def fnn_rollout_ref(ls, buf0, w1, b1, w2, b2, hw, hb, actions, bits, noise,
                    *, n_agents: int, tick_fn, dset_fn, trace=None):
    """As ``ials_rollout_multi_ref`` with the FNN backbone: buf0 (L,
    stack*d_in) flat frame buffers -> (final ls, buf_T, rewards). The
    ``fnn_rollout`` kernel's ground truth."""
    return _rollout(_fnn_tick, ls, buf0, (w1, b1, w2, b2, hw, hb), actions,
                    bits, noise, n_agents=n_agents, tick_fn=tick_fn,
                    dset_fn=dset_fn, trace=trace)


def fuse_head(pol_w):
    """The flat (w1, b1, w2, b2, piw, pib, vw, vb) policy tuple, single or
    stacked over a leading policy axis -> (w1, b1, w2, b2, hw, hb) with the
    [pi|v] head as one (Hp, n_act + 1) matrix: the weight ABI of
    ``policy_fwd_ref`` and the serving kernels."""
    w1, b1, w2, b2, piw, pib, vw, vb = pol_w
    return (w1, b1, w2, b2, torch.cat([piw, vw], dim=-1),
            torch.cat([pib, vb], dim=-1))


def policy_fwd_ref(fused_w, x, fast_gates: bool):
    """The PPO actor-critic forward on the ``fuse_head`` tuple, both heads
    as ONE GEMM (the kernels' order)."""
    w1, b1, w2, b2, hw, hb = fused_w
    act = fast_tanh if fast_gates else torch.tanh
    h = act(x @ w1 + b1)
    h = act(h @ w2 + b2)
    out = h @ hw + hb
    return out[..., :-1], out[..., -1]


def serve_forward_ref(fused_w, frames, mask, *, fast_gates: bool):
    """Masked fixed-slot policy forward, the ``serve_forward`` kernel's
    ground truth: frames (S, D) f32, mask (S,) int32/bool, the
    ``fuse_head`` weights -> (logits (S, n_act), v (S,)), pad lanes
    exactly zero. Every lane runs the same fused forward, so at one slot
    shape a real lane's outputs do not depend on the pad lanes or on
    where the lane sits."""
    logits, v = policy_fwd_ref(fused_w, frames, fast_gates)
    m = mask != 0
    return (torch.where(m[:, None], logits, torch.zeros_like(logits)),
            torch.where(m, v, torch.zeros_like(v)))


def serve_forward_multi_ref(fused_ws, frames, mask, pidx, *,
                            fast_gates: bool):
    """Cross-policy masked slot forward, the ``serve_forward_multi``
    kernel's ground truth: ``fused_ws`` the ``fuse_head`` weights stacked
    over N policies (of ``ppo.stack_policy_weights``), pidx (S,) int32 ->
    (logits, v) with pad lanes and lanes whose pidx is outside [0, N)
    exactly zero. Each policy's forward runs over the full slot at the
    single-policy shape and lanes select their own row, so a lane is
    bitwise the single-policy forward of its checkpoint."""
    S = frames.shape[0]
    logits = frames.new_zeros((S, fused_ws[4].shape[-1] - 1))
    v = frames.new_zeros((S,))
    for n in range(fused_ws[0].shape[0]):
        lg_n, v_n = policy_fwd_ref(tuple(w[n] for w in fused_ws), frames,
                                   fast_gates)
        sel = pidx == n
        logits = torch.where(sel[:, None], lg_n, logits)
        v = torch.where(sel, v_n, v)
    m = mask != 0
    return (torch.where(m[:, None], logits, torch.zeros_like(logits)),
            torch.where(m, v, torch.zeros_like(v)))


def policy_rollout_ref(ls, s0, frames0, aip_w, pol_w, gumbel, bits, done,
                       noise, reset_ls, *, kind: str, n_agents: int,
                       fast_gates: bool, tick_fn, dset_fn, obs_fn,
                       trace=None):
    """Whole-horizon actor-in-the-loop rollout, the ``policy_rollout``
    kernel's ground truth. Per tick: policy forward on the frame stack,
    Gumbel-argmax action, AIP cell (``kind`` "gru" or "fnn") and draw, LS
    tick and reward, obs refills the frame stack, and the streamed
    ``done`` (T, L) merges in the streamed ``reset_ls`` (AIP state back to
    zeros, frames re-seeded from the reset observation).
    -> (final ls, s_T (L, K), frames_T (L, S), x (T, L, S), a (T, L)
    int32, logits (T, L, n_actions), v (T, L), r (T, L)). ``trace`` as
    in ``ials_rollout_multi_ref``, plus ``trace["policy"]``: the per-tick
    gap between the top two ``logits + gumbel``."""
    A = n_agents
    L = s0.shape[0]
    B = L // A
    cell = _gru_tick if kind == "gru" else _fnn_tick
    fused_w = fuse_head(pol_w)
    ls = tuple(ls)
    s = s0.float().reshape(A, B, -1)
    frames = frames0.float()
    xs, acts, lgs, vs, rs = [], [], [], [], []
    for t in range(gumbel.shape[0]):
        x = frames
        logits, value = policy_fwd_ref(fused_w, x, fast_gates)
        score = logits + gumbel[t]
        a = torch.argmax(score, dim=-1).to(torch.int32)
        if trace is not None:
            top2 = torch.topk(score, 2, dim=-1).values
            trace.setdefault("policy", []).append(top2[:, 0] - top2[:, 1])
        d = dset_fn(ls, a).float().reshape(A, B, -1)
        s2, _, u = cell(aip_w, s, d, bits[t].reshape(A, B, -1), trace)
        ls2, r = tick_fn(ls, a, u.reshape(L, -1),
                         tuple(n[t] for n in noise))
        obs = obs_fn(ls2).float()
        d_obs = obs.shape[-1]
        frames2 = torch.cat([x[:, d_obs:], obs], dim=-1)
        dn = done[t] != 0
        ls = tuple(torch.where(dn.reshape((-1,) + (1,) * (n.dim() - 1)),
                               rl[t], n) for n, rl in zip(ls2, reset_ls))
        s = torch.where(dn.reshape(A, B, 1), torch.zeros_like(s2), s2)
        obs0 = obs_fn(ls).float()
        frames_reset = torch.cat([torch.zeros_like(x[:, d_obs:]), obs0],
                                 dim=-1)
        frames = torch.where(dn[:, None], frames_reset, frames2)
        xs.append(x)
        acts.append(a)
        lgs.append(logits)
        vs.append(value)
        rs.append(r.float())
    return (ls, s.reshape(L, -1), frames, torch.stack(xs),
            torch.stack(acts), torch.stack(lgs), torch.stack(vs),
            torch.stack(rs))
