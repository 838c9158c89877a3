"""State-space / recurrent blocks: Mamba (S6), xLSTM's mLSTM and sLSTM
(counterpart of ``repro/nn/ssm.py``).

- Mamba: a chunked associative scan, as the reference's: sequential over
  the chunks (carrying the (B, dI, dS) state), ``associative_scan`` of
  ``(decay, u)`` inside a chunk (``jax.lax.associative_scan``'s pairing
  and order, log2(chunk) levels), so live memory is (B, chunk, dI, dS).
- mLSTM: the chunkwise-parallel form (intra-chunk gate-weighted scores,
  one rank-L update of the matrix memory per chunk), with the xLSTM
  max-stabiliser; ``chunkwise=False`` runs the recurrent cell step by
  step (the reference's fallback); ``mlstm_step`` is that cell.
- sLSTM: the recurrent cell over time, with fused recurrent weights.
- All recurrent state is float32 whatever the activation dtype.

Each mixer takes ``tp``, the collectives of its tensor-parallel route
(``Collectives``; ``distributed/act_sharding.py::mixer`` runs a mixer
on each rank's share of its channels, heads, heads' value rows or hidden
units, laid out by ``tp_layout``): they sit where a product contracts
over a dim that is split across ranks, and are the identity in one
process.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from .module import init_device, dense_init, normal

Params = Dict[str, Any]


def _chunk(n: int, want: int) -> int:
    """Largest divisor of n that is <= want."""
    if n <= want:
        return n
    k = -(-n // want)
    while n % k:
        k += 1
    return n // k


def _gelu(x):
    """The reference's ``jax.nn.gelu``: its default is the tanh form."""
    return F.gelu(x, approximate="tanh")


def _conv_window(xi: torch.Tensor, K: int) -> torch.Tensor:
    """The last K pre-conv inputs, zero-padded in front: (B, K, C)."""
    T = xi.shape[1]
    return F.pad(xi, (0, 0, max(K - T, 0), 0))[:, -K:]


class Collectives(NamedTuple):
    """Where a mixer's product contracts over a dim split across the
    ranks of its tensor-parallel route: ``sum`` the ranks' partial sums
    (an all-reduce), ``mean`` them, ``scatter`` the partial sums' last
    dim (each rank keeps its block of it, summed: a reduce-scatter),
    ``gather`` the ranks' blocks of the last dim (an all-gather).
    ``heads``: the mLSTM heads the rank holds whole (``Layout.heads``:
    their own products need no collective), 0 where it holds a share of
    every head."""
    sum: Callable
    mean: Callable
    scatter: Callable
    gather: Callable
    heads: int = 0


def _same(t):
    return t


ONE = Collectives(_same, _same, _same, _same)   # one process


class Layout(NamedTuple):
    """A mixer's tensor-parallel layout (``tp_layout``)."""
    weights: dict
    state: tuple
    even: tuple
    heads: int = 0


def tp_layout(kind: str, p: Params, n_heads: int = 0,
              ranks: int = 1) -> Layout:
    """The tensor-parallel layout of a mixer's weights ``p`` on ``ranks``
    ranks -> ``Layout``: for each weight (by its dotted path) ``(dim,
    parts)``, the dim it splits into ``parts`` equal parts of which each
    rank takes its share (rank r of n: elements [r P // n, (r + 1) P //
    n) of each part of P), or None (whole on every rank); the same for
    the decode state's fields; the sizes that n must divide (the shares
    of those are gathered or scattered evenly); the mLSTM heads each
    rank holds whole, 0 where it holds a share of every head.

    - Mamba: its dI channels (``in_proj``'s [xi | z] both);
    - mLSTM, where ``ranks`` divides the heads: whole heads (each head's
      channels of ``xi``, ``xc`` and ``z``, its ``wq`` / ``wk`` / ``wv``
      block, its C, n and m; its gates' bias), as the reference's
      partitioner lays the head out: each head's products contract on
      one rank, only the gates and ``down_proj`` (over all dI channels)
      sum across ranks. Else each head's value rows (``v``, the rows of
      C, ``h``), so the channels of ``xi``, ``xc`` and ``z`` are each
      head's share of its DH, and ``wq`` / ``wk`` / ``wv`` the same share
      of their output columns: q, k and v contract whole over the
      gathered channels, as the reference's do; q, k, n, m and the
      gates stay whole;
    - sLSTM: ``w_in``'s 4 d columns (gathered whole for the recurrence,
      which runs whole) and the FFN's hidden units."""
    if kind == "mamba":
        dI = p["conv_w"].shape[0]
        ch = (0, 1)
        return Layout({"in_proj": (1, 2), "conv_w": ch, "conv_b": ch,
                       "x_proj": ch, "dt_w": (1, 1), "dt_b": ch,
                       "A_log": ch, "D": ch, "out_proj": ch},
                      MambaState(conv=(2, 1), h=(1, 1)), (dI,))
    if kind == "mlstm" and n_heads % ranks == 0:
        heads = (0, 1)
        return Layout({"up_proj": (1, 2), "conv_w": heads,
                       "conv_b": heads, "wq": heads, "wk": heads,
                       "wv": heads, "w_if.w": heads, "w_if.b": (0, 2),
                       "out_norm_g": heads, "down_proj": heads},
                      MLSTMState(conv=(2, 1), C=(1, 1), n=(1, 1),
                                 m=(1, 1)),
                      (n_heads,), n_heads // ranks)
    if kind == "mlstm":
        dI = p["conv_w"].shape[0]
        rows = (0, n_heads)
        return Layout({"up_proj": (1, 2 * n_heads), "conv_w": rows,
                       "conv_b": rows, "wq": (2, 1), "wk": (2, 1),
                       "wv": (2, 1), "w_if.w": rows, "w_if.b": None,
                       "out_norm_g": rows, "down_proj": rows},
                      MLSTMState(conv=(2, n_heads), C=(2, 1), n=None,
                                 m=None),
                      (dI // n_heads,))
    if kind == "slstm":
        d = p["w_in"]["w"].shape[0]
        return Layout({"w_in.w": (1, 1), "w_in.b": (0, 1), "r_z": None,
                       "r_i": None, "r_f": None, "r_o": None,
                       "out_norm_g": None, "ff_up": (1, 2),
                       "ff_down": (0, 1)},
                      SLSTMState(None, None, None, None), (4 * d,))
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (shared by mamba / mLSTM)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (C, K); b: (C,). Causal depthwise convolution,
    tap by tap in the reference's order."""
    K = w.shape[-1]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + T, :] * w[:, k]
    return out + b


def conv_step(x_window: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """x_window: (B, K, C) most-recent-last -> (B, C)."""
    return torch.einsum("bkc,ck->bc", x_window, w) + b


# ---------------------------------------------------------------------------
# Mamba (S6)
# ---------------------------------------------------------------------------

def mamba_init(generator, d_model: int, *, expand: int = 2,
               d_state: int = 16, d_conv: int = 4,
               dt_rank: int | None = None, dtype=torch.float32,
               device=None) -> Params:
    dI = expand * d_model
    dt_rank = dt_rank or max(1, math.ceil(d_model / 16))
    dev = init_device(generator, device)
    in_proj = dense_init(generator, d_model, 2 * dI, dtype=dtype,
                         device=dev)["w"]
    conv_w = normal(generator, (dI, d_conv), scale=d_conv ** -0.5,
                    dtype=dtype, device=dev)
    x_proj = dense_init(generator, dI, dt_rank + 2 * d_state, dtype=dtype,
                        device=dev)["w"]
    dt_w = dense_init(generator, dt_rank, dI, dtype=dtype, device=dev)["w"]
    u = torch.empty((dI,), dtype=torch.float32, device=dev)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((dI,), dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_w": dt_w,
        "dt_b": torch.log(torch.expm1(torch.exp(u))),
        "A_log": torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=dev
        ).expand(dI, d_state).contiguous()),
        "D": torch.ones((dI,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, dI, d_model, dtype=dtype,
                               device=dev)["w"],
    }


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, K, dI) rolling window of pre-conv inputs
    h: torch.Tensor     # (B, dI, dS)


def mamba_init_state(batch: int, dI: int, d_conv: int, d_state: int,
                     dtype=torch.float32, device="cpu") -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, d_conv, dI), dtype=dtype, device=device),
        h=torch.zeros((batch, dI, d_state), dtype=torch.float32,
                      device=device))


def _mamba_inputs(p: Params, xc: torch.Tensor, d_state: int,
                  tp: Collectives = ONE):
    """-> dt, B, C (float32) from the post-conv activations."""
    dt_rank = p["dt_w"].shape[0]
    dbc = tp.sum(xc @ p["x_proj"])
    dt_in = dbc[..., :dt_rank]
    B_ = dbc[..., dt_rank:dt_rank + d_state].float()
    C_ = dbc[..., dt_rank + d_state:].float()
    dt = F.softplus(dt_in @ p["dt_w"] + p["dt_b"]).float()
    return dt, B_, C_


def _ssm_combine(a, b):
    (a1, u1), (a2, u2) = a, b
    return a1 * a2, a2 * u1 + u2


def _slice(x: torch.Tensor, dim: int, start, stop=None, step=None):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (``a`` as long as ``b``
    or one longer)."""
    n = b.shape[dim]
    out = torch.stack([_slice(a, dim, 0, n), b], dim + 1).flatten(dim,
                                                                   dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, _slice(a, dim, n)], dim)
    return out


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` with the
    associative ``fn`` in ``jax.lax.associative_scan``'s order: combine
    adjacent pairs, scan the pairs (recursively: the odd positions),
    combine each with the next even element (the even positions), the
    first element as it is."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                 tuple(_slice(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    rest = tuple(_slice(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = fn(tuple(_slice(o, dim, 0, -1) for o in odd), rest)
    else:
        even = fn(odd, rest)
    even = tuple(torch.cat([_slice(e, dim, 0, 1), r], dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def mamba_apply(p: Params, x: torch.Tensor, *, d_state: int = 16,
                chunk: int = 128, return_state: bool = False,
                tp: Collectives = ONE):
    """x: (B, T, d_model) -> (B, T, d_model). Full-sequence (prefill):
    chunk by chunk, each chunk's states from an associative scan of
    ``(decay, u)`` and the carried state (module docstring)."""
    B, T, _ = x.shape
    dI = p["conv_w"].shape[0]
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(xi, p["conv_w"], p["conv_b"]))
    dt, B_, C_ = _mamba_inputs(p, xc, d_state, tp)
    A = -torch.exp(p["A_log"])                         # (dI, dS)
    xc32 = xc.float()

    ck = _chunk(T, chunk)
    h = torch.zeros((B, dI, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, T, ck):
        sl = slice(c0, c0 + ck)
        decay = torch.exp(dt[:, sl, :, None] * A)                 # (B,ck,dI,dS)
        u = (dt[:, sl] * xc32[:, sl])[..., None] * B_[:, sl, None, :]
        a_cum, u_cum = associative_scan(_ssm_combine, (decay, u), 1)
        hs = a_cum * h[:, None] + u_cum                         # (B,ck,dI,dS)
        ys.append(torch.einsum("btds,bts->btd", hs, C_[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + p["D"] * xc32
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if return_state:
        return out, MambaState(conv=_conv_window(xi, p["conv_w"].shape[-1]),
                               h=h)
    return out


def mamba_step(p: Params, state: MambaState, x: torch.Tensor, *,
               d_state: int = 16, tp: Collectives = ONE) -> tuple:
    """Single decode step. x: (B, d_model) -> (out (B, d_model), state)."""
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    conv = torch.cat([state.conv[:, 1:], xi[:, None]], dim=1)
    xc = F.silu(conv_step(conv, p["conv_w"], p["conv_b"]))
    dt, B_, C_ = _mamba_inputs(p, xc, d_state, tp)
    A = -torch.exp(p["A_log"])
    xc32 = xc.float()
    decay = torch.exp(dt[..., None] * A)                        # (B,dI,dS)
    u = (dt * xc32)[..., None] * B_[:, None, :]
    h = decay * state.h + u
    y = torch.einsum("bds,bs->bd", h, C_) + p["D"] * xc32
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, MambaState(conv=conv, h=h)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ---------------------------------------------------------------------------

def mlstm_init(generator, d_model: int, n_heads: int, *,
               proj_factor: float = 2.0, d_conv: int = 4,
               dtype=torch.float32, device=None) -> Params:
    dI = int(proj_factor * d_model)
    if dI % n_heads:
        raise ValueError(f"inner width {dI} not divisible by {n_heads} "
                         "heads")
    DH = dI // n_heads
    dev = init_device(generator, device)

    def bd():  # block-diagonal per-head projection
        return normal(generator, (n_heads, DH, DH), scale=DH ** -0.5,
                      dtype=dtype, device=dev)

    up_proj = dense_init(generator, d_model, 2 * dI, dtype=dtype,
                         device=dev)["w"]
    conv_w = normal(generator, (dI, d_conv), scale=d_conv ** -0.5,
                    dtype=dtype, device=dev)
    wq, wk, wv = bd(), bd(), bd()
    return {
        "up_proj": up_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((dI,), dtype=dtype, device=dev),
        "wq": wq, "wk": wk, "wv": wv,
        "w_if": dense_init(generator, dI, 2 * n_heads, dtype=torch.float32,
                           bias=True, device=dev),
        "out_norm_g": torch.ones((dI,), dtype=dtype, device=dev),
        "down_proj": dense_init(generator, dI, d_model, dtype=dtype,
                                device=dev)["w"],
    }


def _bd_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., dI); w: (NH, DH, E) block-diagonal -> (..., NH, E)."""
    nh, dh = w.shape[0], w.shape[1]
    xr = x.reshape(*x.shape[:-1], nh, dh)
    return torch.einsum("...hd,hde->...he", xr, w)


class MLSTMState(NamedTuple):
    conv: torch.Tensor  # (B, K, dI)
    C: torch.Tensor     # (B, NH, DH, DH)
    n: torch.Tensor     # (B, NH, DH)
    m: torch.Tensor     # (B, NH)


def mlstm_init_state(batch: int, dI: int, n_heads: int, d_conv: int,
                     dtype=torch.float32, device="cpu",
                     rows: int = 0) -> MLSTMState:
    """The empty state; ``rows``: C's value rows a head (0: all DH of
    them; a tensor-parallel rank holds its share)."""
    DH = dI // n_heads
    f32 = torch.float32
    return MLSTMState(
        conv=torch.zeros((batch, d_conv, dI), dtype=dtype, device=device),
        C=torch.zeros((batch, n_heads, rows or DH, DH), dtype=f32,
                      device=device),
        n=torch.zeros((batch, n_heads, DH), dtype=f32, device=device),
        m=torch.full((batch, n_heads), -1e30, dtype=f32, device=device))


def _mlstm_cell(qkvif, state: MLSTMState):
    """One recurrent step. q,k,v: (B,NH,DH); i_raw,f_raw: (B,NH)."""
    q, k, v, i_raw, f_raw = qkvif
    DH = q.shape[-1]
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + state.m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(logf + state.m - m_new)
    k_s = k / math.sqrt(DH)
    C = f_g[..., None, None] * state.C + i_g[..., None, None] * (
        v[..., :, None] * k_s[..., None, :])
    n = f_g[..., None] * state.n + i_g[..., None] * k_s
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, q)),
                      min=1.0)
    h = num / den[..., None]
    return h, MLSTMState(conv=state.conv, C=C, n=n, m=m_new)


def _mlstm_chunk_parallel(q, k, v, i_raw, f_raw, state: MLSTMState):
    """Chunkwise-parallel mLSTM over ONE chunk: q,k,v (L, B, NH, DH);
    i_raw,f_raw (L, B, NH). Intra-chunk: (L, L) gate-weighted scores;
    inter-chunk: one rank-L update C' = decay*C + (gated k)^T v, with the
    max-stabiliser exact (the recurrence unrolled L steps)."""
    L, B, NH, DH = q.shape
    logf = F.logsigmoid(f_raw)                              # (L, B, NH)
    b = torch.cumsum(logf, dim=0)                           # b_t = sum logf
    b_total = b[-1]                                         # (B, NH)

    # log-weights: intra w(t,tau) = b_t - b_tau + i_tau (tau <= t)
    #              inter w(t)     = b_t + m_prev
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=q.device))[:, :, None, None]
    # masked to -inf BEFORE any subtraction of another -inf (NaN)
    log_intra = (b[:, None] - b[None, :] + i_raw[None, :]).masked_fill(
        ~tril, float("-inf"))                               # (t, tau, B, NH)
    m_intra = log_intra.amax(dim=1)                         # (t, B, NH)
    log_inter = b + state.m[None]                           # (t, B, NH)
    m_t = torch.maximum(m_intra, log_inter)                 # running max

    k_s = k / math.sqrt(DH)
    s_qk = torch.einsum("tbhd,ubhd->tubh", q, k_s)          # (t, tau, B, NH)
    w_intra = torch.where(tril, torch.exp(log_intra - m_t[:, None]), 0.0)
    h_intra = torch.einsum("tubh,ubhd->tbhd", w_intra * s_qk, v)
    n_intra = torch.einsum("tubh,ubhd->tbhd", w_intra, k_s)

    w_inter = torch.exp(log_inter - m_t)                    # (t, B, NH)
    h_inter = torch.einsum("tbhj,bhij->tbhi", q, state.C) * w_inter[..., None]
    n_inter = state.n[None] * w_inter[..., None]
    qn = torch.einsum("tbhd,tbhd->tbh", q, n_intra + n_inter)
    den = torch.clamp(torch.abs(qn), min=1.0)
    h = (h_intra + h_inter) / den[..., None]                # (t, B, NH, DH)

    # chunk-end state
    m_state = torch.maximum(b_total + state.m,
                            (b_total[None] - b + i_raw).amax(dim=0))
    w_c = torch.exp(b_total[None] - b + i_raw - m_state[None])  # (tau,B,NH)
    decay = torch.exp(b_total + state.m - m_state)
    C_new = decay[..., None, None] * state.C + \
        torch.einsum("tbh,tbhi,tbhj->bhij", w_c, v, k_s)
    n_new = decay[..., None] * state.n + \
        torch.einsum("tbh,tbhd->bhd", w_c, k_s)
    return h, MLSTMState(conv=state.conv, C=C_new, n=n_new, m=m_state)


def _heads(n_heads: int, tp: Collectives):
    """-> the mLSTM heads this rank holds, and the collectives of a
    head's own products: none where the rank holds whole heads
    (``tp.heads``), ``tp`` where it holds a share of each."""
    return (tp.heads, ONE) if tp.heads else (n_heads, tp)


def _mlstm_qkvif(p: Params, xi, xc, n_heads: int, tp: Collectives = ONE):
    """-> q, k, v (float32, (..., nh, DH); v's last dim the rank's value
    rows) and i_raw, f_raw (..., nh), for the rank's nh heads
    (``_heads``). Where the rank holds a share of each head (its value
    rows), q, k and v contract whole over each head's channels, gathered
    (``tp.gather``), for the rank's output columns, and q and k's
    columns are gathered. The gates contract over all dI channels:
    partial sums of every head's gates, each rank's heads kept (all of
    them where each rank holds a share of each head)."""
    nh, th = _heads(n_heads, tp)
    xcw, xiw = xc, xi
    if th is not ONE:      # (a view in one process reorders xc's gradient)
        xcw, xiw = (th.gather(t.unflatten(-1, (nh, -1))).flatten(-2)
                    for t in (xc, xi))
    q = th.gather(_bd_proj(xcw, p["wq"]).float())
    k = th.gather(_bd_proj(xcw, p["wk"]).float())
    v = _bd_proj(xiw, p["wv"]).float()
    if_raw = (xc.float() @ p["w_if"]["w"]).unflatten(-1, (2, n_heads))
    if_raw = (tp.sum(if_raw) if nh == n_heads else tp.scatter(if_raw)) + \
        p["w_if"]["b"].unflatten(-1, (2, nh))
    return q, k, v, if_raw[..., 0, :], if_raw[..., 1, :]


def mlstm_apply(p: Params, x: torch.Tensor, n_heads: int, *,
                chunk: int = 64, return_state: bool = False,
                chunkwise: bool = True, tp: Collectives = ONE):
    """x: (B, T, d_model), chunkwise-parallel over chunks of ``chunk``;
    ``chunkwise=False`` runs the recurrent cell step by step (the chunks
    then change nothing)."""
    B, T, _ = x.shape
    dI = p["conv_w"].shape[0]
    xi, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(xi, p["conv_w"], p["conv_b"]))
    q, k, v, i_raw, f_raw = _mlstm_qkvif(p, xi, xc, n_heads, tp)
    nh, th = _heads(n_heads, tp)

    st = mlstm_init_state(B, nh * q.shape[-1], nh, 0, dtype=x.dtype,
                          device=x.device, rows=v.shape[-1])
    hs = []
    if chunkwise:
        ck = _chunk(T, chunk)
        for c0 in range(0, T, ck):
            sl = lambda a: a[:, c0:c0 + ck].transpose(0, 1)
            h_c, st = _mlstm_chunk_parallel(sl(q), sl(k), sl(v), sl(i_raw),
                                            sl(f_raw), st)
            hs.append(h_c)                              # (ck, B, NH, DH)
    else:
        for t in range(T):
            h_t, st = _mlstm_cell((q[:, t], k[:, t], v[:, t], i_raw[:, t],
                                   f_raw[:, t]), st)
            hs.append(h_t[None])                        # (1, B, NH, DH)
    h = torch.cat(hs, dim=0).reshape(T, B, dI).transpose(0, 1).to(x.dtype)
    h = _groupnorm_heads(h, p["out_norm_g"], nh, th)
    out = (h * F.silu(z)) @ p["down_proj"]
    if return_state:
        win = _conv_window(xi, p["conv_w"].shape[-1])
        return out, MLSTMState(conv=win, C=st.C, n=st.n, m=st.m)
    return out


def _groupnorm_heads(h: torch.Tensor, g: torch.Tensor, n_heads: int,
                     tp: Collectives = ONE) -> torch.Tensor:
    """Per-head RMS norm over the head dim (xLSTM uses GroupNorm); the
    moment averaged over the ranks that share a head (``tp``)."""
    shp = h.shape
    hh = h.reshape(*shp[:-1], n_heads, shp[-1] // n_heads).float()
    var = tp.mean((hh * hh).mean(dim=-1, keepdim=True))
    hh = hh * torch.rsqrt(var + 1e-6)
    return (hh.reshape(shp) * g).to(h.dtype)


def mlstm_step(p: Params, state: MLSTMState, x: torch.Tensor,
               n_heads: int, tp: Collectives = ONE) -> tuple:
    """Single decode step. x: (B, d_model)."""
    B = x.shape[0]
    dI = p["conv_w"].shape[0]
    xi, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    conv = torch.cat([state.conv[:, 1:], xi[:, None]], dim=1)
    xc = F.silu(conv_step(conv, p["conv_w"], p["conv_b"]))
    q, k, v, i_raw, f_raw = _mlstm_qkvif(p, xi, xc, n_heads, tp)
    h, st = _mlstm_cell((q, k, v, i_raw, f_raw),
                        MLSTMState(conv=conv, C=state.C, n=state.n,
                                   m=state.m))
    nh, th = _heads(n_heads, tp)
    hf = _groupnorm_heads(h.reshape(B, dI).to(x.dtype), p["out_norm_g"],
                          nh, th)
    return (hf * F.silu(z)) @ p["down_proj"], st


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell with recurrent head-block-diagonal weights)
# ---------------------------------------------------------------------------

def slstm_init(generator, d_model: int, n_heads: int, *,
               ff_factor: float = 4 / 3, dtype=torch.float32,
               device=None) -> Params:
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by {n_heads} "
                         "heads")
    DH = d_model // n_heads
    d_ff = int(ff_factor * d_model)
    dev = init_device(generator, device)

    def rmat():
        return normal(generator, (n_heads, DH, DH), scale=DH ** -0.5,
                      device=dev)

    w_in = dense_init(generator, d_model, 4 * d_model, dtype=dtype,
                      bias=True, device=dev)
    r_z, r_i, r_f, r_o = rmat(), rmat(), rmat(), rmat()
    return {
        "w_in": w_in,
        "r_z": r_z, "r_i": r_i, "r_f": r_f, "r_o": r_o,
        "out_norm_g": torch.ones((d_model,), dtype=dtype, device=dev),
        "ff_up": dense_init(generator, d_model, 2 * d_ff, dtype=dtype,
                            device=dev)["w"],
        "ff_down": dense_init(generator, d_ff, d_model, dtype=dtype,
                              device=dev)["w"],
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, NH, DH)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor  # (B, NH, DH)


def slstm_init_state(batch: int, n_heads: int, DH: int,
                     device="cpu") -> SLSTMState:
    z = torch.zeros((batch, n_heads, DH), dtype=torch.float32,
                    device=device)
    # distinct tensors: decode writes each leaf in place
    return SLSTMState(c=z, n=z.clone(), h=z.clone(),
                      m=torch.full_like(z, -1e30))


def _fused_r(p: Params) -> torch.Tensor:
    """Fused recurrent weights (NH, 4*DH, DH), built once per call."""
    return torch.cat([p["r_z"], p["r_i"], p["r_f"], p["r_o"]], dim=1)


def _slstm_cell(r_all: torch.Tensor, state: SLSTMState,
                wx: torch.Tensor) -> tuple:
    """wx: (B, 4, NH, DH) input projections [z, i, f, o]. The reference's
    ``einsum("bhj,hij->bhi")`` as one batched product over the heads,
    and its ``logf + m`` once: the same sums, in fewer ops a step (the
    dry-run counts every step)."""
    rg = torch.bmm(state.h.transpose(0, 1), r_all.transpose(1, 2)) \
        .transpose(0, 1)
    rz, ri, rf, ro = rg.chunk(4, dim=-1)
    wz, wi, wf, wo = wx.unbind(1)
    z_t = torch.tanh(wz + rz)
    i_raw = wi + ri
    f_raw = wf + rf
    o_t = torch.sigmoid(wo + ro)
    logf = F.logsigmoid(f_raw)
    lm = logf + state.m
    m_new = torch.maximum(lm, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(lm - m_new)
    c = f_g * state.c + i_g * z_t
    n = f_g * state.n + i_g
    h = o_t * c / torch.clamp(n, min=1e-6)
    return h, SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_out(p: Params, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    h = _groupnorm_heads(h, p["out_norm_g"], n_heads)
    u1, u2 = (h @ p["ff_up"]).chunk(2, dim=-1)
    return (_gelu(u1) * u2) @ p["ff_down"]


def slstm_apply(p: Params, x: torch.Tensor, n_heads: int, *,
                chunk: int = 64, return_state: bool = False,
                tp: Collectives = ONE):
    """x: (B, T, d_model). The recurrence runs step by step; ``chunk``
    (the reference's recompute granularity for the backward) does not
    change the result."""
    B, T, d = x.shape
    DH = d // n_heads
    wx = tp.gather((x @ p["w_in"]["w"] + p["w_in"]["b"]).float())
    wx = wx.reshape(B, T, 4, n_heads, DH)
    r_all = _fused_r(p)
    st = slstm_init_state(B, n_heads, DH, device=x.device)
    hs = []
    for t in range(T):
        h, st = _slstm_cell(r_all, st, wx[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    out = _slstm_out(p, h, n_heads)
    if return_state:
        return out, st
    return out


def slstm_step(p: Params, state: SLSTMState, x: torch.Tensor,
               n_heads: int, tp: Collectives = ONE) -> tuple:
    B, d = x.shape
    DH = d // n_heads
    wx = tp.gather((x @ p["w_in"]["w"] + p["w_in"]["b"]).float())
    h, st = _slstm_cell(_fused_r(p), state, wx.reshape(B, 4, n_heads, DH))
    return _slstm_out(p, h.reshape(B, d).to(x.dtype), n_heads), st
